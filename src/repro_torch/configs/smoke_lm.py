"""smoke-lm: a small dense transformer config for LM-substrate smoke tests.

It keeps the LM substrate (``models/``, ``launch/serve.py --arch smoke-lm``)
drivable. ``FAMILY_SMOKES`` adds one small config of each other family the
model code carries (moe with a dense residual, ssm with sLSTM layers,
hybrid with the shared attention block); the registry has no arch of those
families, and the tests and the chip smoke hold the family code to them.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smoke-lm", family="dense",
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=8,
    d_ff=1024, vocab=8192, qkv_bias=True,
)

REDUCED = ModelConfig(
    name="smoke-lm-reduced", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, qkv_bias=True, attn_chunk=32, remat=False,
)

FAMILY_SMOKES = {
    "moe": ModelConfig(
        name="smoke-moe", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, n_experts=4, top_k=2, moe_dense_residual=True,
        attn_chunk=8, remat=False),
    "ssm": ModelConfig(
        name="smoke-ssm", family="ssm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, slstm_every=2, ssm_chunk=8, remat=False),
    "hybrid": ModelConfig(
        name="smoke-hybrid", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, ssm_state=16, ssm_head_dim=16,
        shared_attn_every=2, ssm_chunk=8, attn_chunk=8, remat=False),
}
