"""The LM substrate's model stack, the counterpart of ``repro.models``.

config.py      -- ModelConfig (a copy of the reference's)
layers.py      -- norms, parameter makers with spec tuples, RoPE, losses
attention.py   -- GQA attention: chunked full-sequence + KV-cache decode
moe.py         -- top-k router with capacity + sort-based dispatch
xlstm.py       -- mLSTM (chunkwise-parallel) and sLSTM (recurrent) blocks
mamba2.py      -- Mamba2 SSD (chunked scan) block
transformer.py -- per-family block assembly, the stacked layer loop
lm.py          -- LMModel: init / encode / prefill / decode
convert.py     -- weights from JAX's tree and back; seeded numpy weights
"""
from repro_torch.models.lm import LMModel

__all__ = ["LMModel"]
