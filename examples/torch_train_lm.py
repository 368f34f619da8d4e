"""End-to-end driver on the PyTorch port: train an LM for a few hundred
steps.

The counterpart of ``train_lm.py``. Uses the port's full stack -- config
registry, LMModel, AdamW with an fp32 master, the deterministic token
pipeline with the paper's self-join dedup operator (the fused-join kernel
on the card), async checkpointing, straggler monitor -- via
``repro_torch.launch.train``.

Default sizing is the reduced smoke-lm; pass --full100m for the real 124M
model (12L x d768, GPT-2-small class) and more steps. Runs on CUDA unless
``--device cpu``; checkpoints go to a temporary directory unless
``--ckpt-dir`` names one.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""
import argparse
import sys
import tempfile

import repro_torch.configs as cfgs
from repro_torch.launch.train import main as train_main
from repro_torch.models.config import ModelConfig

# a real ~124M config, selectable below
GPT_100M = ModelConfig(
    name="gpt-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab=32000, attn_chunk=256,
)

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full100m", action="store_true",
                    help="train the real 124M model (slow on the CPU)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    args, rest = ap.parse_known_args()

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = args.ckpt_dir or tmp
        if args.full100m:
            # register the 100M config under a temporary name
            class _Mod:
                CONFIG = GPT_100M
                REDUCED = GPT_100M

            sys.modules["repro_torch.configs.gpt_100m"] = _Mod
            cfgs.ALIASES["gpt-100m"] = "gpt_100m"
            steps = args.steps or 300
            argv = ["--arch", "gpt-100m", "--steps", str(steps),
                    "--batch", "8", "--seq", "512", "--dedup",
                    "--ckpt-dir", ckpt, "--ckpt-every", "100"]
        else:
            steps = args.steps or 200
            argv = ["--arch", "smoke-lm", "--reduced", "--steps", str(steps),
                    "--batch", "8", "--seq", "128", "--dedup",
                    "--ckpt-dir", ckpt, "--ckpt-every", "100",
                    "--log-every", "20"]
        train_main(argv + rest)
