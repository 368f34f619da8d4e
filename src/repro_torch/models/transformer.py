"""Per-family block assembly and the layer stack.

The counterpart of ``repro.models.transformer``. The parameters keep JAX's
stacked layout: every block leaf has a leading L dimension, and its spec a
leading ``None``. The forward pass is a Python loop over the layers where
JAX scans; the per-layer block kind is static (``cfg.layer_kinds()``), so
the loop picks each layer's branch where JAX's ``lax.cond`` does. The
hybrid family's shared attention block lives outside the stack (one
parameter set) and runs before each group of ``shared_attn_every`` Mamba2
layers, with one KV cache an invocation. Rematerialization has no meaning
without a backward pass and comes with training (ROADMAP A17 (ii)).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamInit, ShardCtx, dense_param,
                                       norm_param, rms_norm, swiglu,
                                       torch_dtype, tree_map)

ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------

def _init_ffn(init: ParamInit, cfg, ctx):
    d, ff = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    p, s = {}, {}
    p["w_gate"], s["w_gate"] = dense_param(init, d, ff, ctx, dt)
    p["w_up"], s["w_up"] = dense_param(init, d, ff, ctx, dt)
    p["w_down"], s["w_down"] = dense_param(init, ff, d, ctx, dt, tp_dim="in")
    return p, s


def _init_layer(init: ParamInit, cfg: ModelConfig, ctx: ShardCtx):
    """One layer's params for the union of block kinds this family needs."""
    dt = torch_dtype(cfg.dtype)
    p, s = {}, {}
    p["ln1"], s["ln1"] = norm_param(init, cfg.d_model, dt)
    kinds = set(cfg.layer_kinds())
    if "attn" in kinds:
        p["attn"], s["attn"] = attn_lib.init_attention(init, cfg, ctx)
        p["ln2"], s["ln2"] = norm_param(init, cfg.d_model, dt)
        if cfg.n_experts:
            p["moe"], s["moe"] = moe_lib.init_moe(init, cfg, ctx)
            if cfg.moe_dense_residual:
                p["ffn"], s["ffn"] = _init_ffn(init, cfg, ctx)
        else:
            p["ffn"], s["ffn"] = _init_ffn(init, cfg, ctx)
    if "mlstm" in kinds:
        p["mlstm"], s["mlstm"] = xlstm_lib.init_mlstm(init, cfg, ctx)
    if "slstm" in kinds:
        p["slstm"], s["slstm"] = xlstm_lib.init_slstm(init, cfg, ctx)
    if "mamba2" in kinds:
        p["mamba"], s["mamba"] = mamba_lib.init_mamba2(init, cfg, ctx)
    return p, s


def _lead_none(specs):
    if isinstance(specs, dict):
        return {k: _lead_none(v) for k, v in specs.items()}
    return (None,) + tuple(specs)


def init_stack(init: ParamInit, cfg: ModelConfig, ctx: ShardCtx):
    """All layers at once: every leaf has leading dim L, every spec a
    leading None."""
    stacked, specs = _init_layer(init.stacked(cfg.n_layers), cfg, ctx)
    return stacked, _lead_none(specs)


def init_shared_attn(init: ParamInit, cfg, ctx):
    """The hybrid family's shared attention+FFN block (one param set)."""
    if cfg.shared_attn_every <= 0:
        return None, None
    dt = torch_dtype(cfg.dtype)
    p, s = {}, {}
    p["ln1"], s["ln1"] = norm_param(init, cfg.d_model, dt)
    p["ln2"], s["ln2"] = norm_param(init, cfg.d_model, dt)
    p["attn"], s["attn"] = attn_lib.init_attention(init, cfg, ctx)
    p["ffn"], s["ffn"] = _init_ffn(init, cfg, ctx)
    return p, s


# ---------------------------------------------------------------------------
# per-layer apply
# ---------------------------------------------------------------------------

def _ffn(fp, h):
    return swiglu(h, fp["w_gate"], fp["w_up"], fp["w_down"])


def _apply_attn_layer(bp, x, cfg, *, mode, cache=None):
    h = rms_norm(x, bp["ln1"])
    new_cache = None
    if mode == "decode":
        a, new_cache = attn_lib.attention_decode(bp["attn"], h, cache, cfg)
    elif mode == "prefill":
        a, new_cache = attn_lib.prefill_cache(bp["attn"], h, cfg, cache=cache)
    else:
        a = attn_lib.attention_forward(bp["attn"], h, cfg,
                                       causal=not cfg.encoder_only)
    x = x + a
    h = rms_norm(x, bp["ln2"])
    aux = {}
    if cfg.n_experts:
        m, aux = moe_lib.moe_ffn(bp["moe"], h, cfg)
        if cfg.moe_dense_residual:
            m = m + _ffn(bp["ffn"], h)
        x = x + m
    else:
        x = x + _ffn(bp["ffn"], h)
    return x, new_cache, aux


def _apply_shared(sp, x, cfg, mode, cache):
    h = rms_norm(x, sp["ln1"])
    nc = None
    if mode == "decode":
        a, nc = attn_lib.attention_decode(sp["attn"], h, cache, cfg)
    elif mode == "prefill":
        a, nc = attn_lib.prefill_cache(sp["attn"], h, cfg, cache=cache)
    else:
        a = attn_lib.attention_forward(sp["attn"], h, cfg, causal=True)
    x = x + a
    h2 = rms_norm(x, sp["ln2"])
    return x + _ffn(sp["ffn"], h2), nc


# ---------------------------------------------------------------------------
# stack forward (train / prefill / decode)
# ---------------------------------------------------------------------------

class StackCaches(NamedTuple):
    """Union cache tree; unused slots are () for a given family."""
    kv: Any = ()          # attn: KVCache with (L, ...) leaves, length (L,)
    mlstm: Any = ()       # (L, B, H, dh, dh)
    slstm: Any = ()       # ((L,B,d), (L,B,d))
    mamba: Any = ()       # Mamba2State with (L, ...) leaves
    shared_kv: Any = ()   # hybrid: KVCache with (n_inv, ...) leaves, 0-d length


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _apply_layer(bp, x, cfg, kind: str, mode: str, cache):
    """One layer of any family. Returns (x, new layer cache, dropped)."""
    if cfg.family in ATTN_FAMILIES:
        x, kv, aux = _apply_attn_layer(bp, x, cfg, mode=mode, cache=cache)
        return x, kv, aux.get("dropped_frac")
    h = rms_norm(x, bp["ln1"])
    if cfg.family == "ssm":
        if mode == "train":
            fwd = (xlstm_lib.slstm_forward if kind == "slstm"
                   else xlstm_lib.mlstm_forward)
            o = fwd(bp[kind], h, cfg)[0]
            return x + o, None, None
        ml_state, sl_state = cache
        use = mode == "decode"
        if kind == "slstm":
            o, st = xlstm_lib.slstm_forward(bp["slstm"], h, cfg,
                                            state=sl_state if use else None)
            new = (ml_state, st)
        else:
            o, st = xlstm_lib.mlstm_forward(bp["mlstm"], h, cfg,
                                            state=ml_state if use else None)
            new = (st, sl_state)
        return x + o, new, None
    if cfg.family == "hybrid":
        o, st = mamba_lib.mamba2_forward(
            bp["mamba"], h, cfg, state=cache if mode == "decode" else None)
        return x + o, (st if mode != "train" else None), None
    raise ValueError(cfg.family)


def _layer_cache(caches: Optional[StackCaches], cfg, i: int):
    if caches is None:
        return None
    if cfg.family == "ssm":
        ml, (c, h) = caches.mlstm, caches.slstm
        return ml[i], (c[i], h[i])
    if cfg.family == "hybrid":
        return _layer(caches.mamba, i)
    kv = caches.kv
    return KVCache(k=kv.k[i], v=kv.v[i], length=int(kv.length[i]))


def _pack_caches(layer_caches: list, shared_cache, cfg) -> StackCaches:
    """The recurrent families' per-layer states stacked back along L."""
    if cfg.family == "ssm":
        ml = torch.stack([c[0] for c in layer_caches])
        sl = (torch.stack([c[1][0] for c in layer_caches]),
              torch.stack([c[1][1] for c in layer_caches]))
        return StackCaches(mlstm=ml, slstm=sl)
    if cfg.family == "hybrid":
        mamba = mamba_lib.Mamba2State(
            conv=torch.stack([c.conv for c in layer_caches]),
            ssm=torch.stack([c.ssm for c in layer_caches]))
        return StackCaches(mamba=mamba, shared_kv=shared_cache)
    raise ValueError(cfg.family)


def stack_forward(stacked, shared_attn, x, cfg: ModelConfig, *, mode: str,
                  caches: Optional[StackCaches] = None):
    """Run all layers. mode: 'train' | 'prefill' | 'decode'.

    Returns (x, new_caches, aux); 'train' produces no caches (None). The
    shared block's cache length is left as it came: ``LMModel`` sets it
    after a prefill and advances it after a decode, as the reference does.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    kinds = cfg.layer_kinds()
    L = cfg.n_layers
    layer_caches, dropped = [], []
    shared_cache = caches.shared_kv if caches is not None else ()
    has_shared = cfg.shared_attn_every > 0 and shared_attn is not None
    every = cfg.shared_attn_every if (cfg.family == "hybrid"
                                      and has_shared) else 0
    for i in range(L):
        if every and i % every == 0:
            # the shared attention block before each group (layers 0, k, 2k..)
            g = i // every
            this = None
            if mode != "train":
                this = KVCache(k=shared_cache.k[g], v=shared_cache.v[g],
                               length=int(shared_cache.length))
            x, _ = _apply_shared(shared_attn, x, cfg, mode, this)
        x, new, drop = _apply_layer(_layer(stacked, i), x, cfg, kinds[i],
                                    mode, _layer_cache(caches, cfg, i))
        layer_caches.append(new)
        dropped.append(torch.zeros((), dtype=torch.float32, device=x.device)
                       if drop is None else drop.float())
    aux = {"dropped_frac": torch.stack(dropped).mean()}
    if mode == "train":
        return x, None, aux
    if cfg.family in ATTN_FAMILIES:
        # the layers wrote their K/V in place into the stacked tensors
        kv = caches.kv
        lengths = torch.tensor([c.length for c in layer_caches],
                               dtype=torch.int32)
        return x, StackCaches(kv=KVCache(k=kv.k, v=kv.v, length=lengths)), aux
    return x, _pack_caches(layer_caches, shared_cache, cfg), aux


def shared_invocations(cfg):
    if cfg.shared_attn_every <= 0:
        return 0
    return -(-cfg.n_layers // cfg.shared_attn_every)
