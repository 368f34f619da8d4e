"""Per-family block assembly and the layer stack.

The counterpart of ``repro.models.transformer``. The parameters keep JAX's
stacked layout: every block leaf has a leading L dimension, and its spec a
leading ``None``. The forward pass is a Python loop over the layers where
JAX scans; the per-layer block kind is static (``cfg.layer_kinds()``), so
the loop picks each layer's branch where JAX's ``lax.cond`` does. The
hybrid family's shared attention block lives outside the stack (one
parameter set) and runs before each group of ``shared_attn_every`` Mamba2
layers, with one KV cache an invocation. Where ``cfg.remat`` is set, a
training forward that builds a graph runs each layer (and each shared
block) under ``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` on the
scan body: its activations are recomputed in the backward, to the same
bits.

On a mesh (``layers.mesh_context``), each layer's parameter slice passes
``constrain_tree`` with the layer's specs (``block_specs`` without the
leading L), JAX's ``_constrain_tree`` inside the scan body: the blocks are
gathered before the layer runs, and its gradients summed into this rank's
blocks in the backward. The shared block's parameters pass it once. The
layout (``head_tp``, ``seq_axes``, ``dp_spec``) is threaded to the
attention as JAX threads it. Where 'model' is live, the compute views
that split over it stay split (``_tp_keep``): the attention's when
``head_tp`` is set, the FFN's ``w_gate`` / ``w_up`` (column-split) and
``w_down`` (row-split, then one sum over 'model') and the moe experts'
``d_ff`` when ``d_ff`` divides 'model'. The recurrent layers (mLSTM,
sLSTM, Mamba2) take no sharding constraint in JAX: their weights are
gathered whole and every 'model' rank repeats their compute.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamInit, ShardCtx, constrain_tree,
                                       current_mesh, dense_param, norm_param,
                                       rms_norm, swiglu, torch_dtype,
                                       tp_copy, tp_sum, tree_map)

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

def _ffn(fp, h, ffn_tp=None):
    """SwiGLU; with ``ffn_tp`` (the live 'model' axis) ``w_gate`` /
    ``w_up`` are this rank's columns and ``w_down`` its rows, and the
    partial outputs are summed over 'model'."""
    if ffn_tp is None:
        return swiglu(h, fp["w_gate"], fp["w_up"], fp["w_down"])
    return tp_sum(swiglu(tp_copy(h), fp["w_gate"], fp["w_up"],
                         fp["w_down"]))


class _Lay(NamedTuple):
    """The layout threaded to a layer: JAX's ``head_tp``, ``seq_axes`` and
    ``dp_spec``, and ``ffn_tp``, the live 'model' axis where ``d_ff``
    splits over it (or None)."""
    head_tp: Any = None
    seq_axes: Any = None
    dp_spec: Any = None
    ffn_tp: Any = None


def _attn(ap, h, cfg, mode, cache, lay: _Lay, causal: bool):
    if mode == "decode":
        return attn_lib.attention_decode(ap, h, cache, cfg,
                                         head_tp=lay.head_tp,
                                         seq_axes=lay.seq_axes)
    if mode == "prefill":
        return attn_lib.prefill_cache(ap, h, cfg, cache=cache,
                                      head_tp=lay.head_tp,
                                      seq_axes=lay.seq_axes,
                                      dp_spec=lay.dp_spec)
    return attn_lib.attention_forward(ap, h, cfg, causal=causal,
                                      head_tp=lay.head_tp), None


def _apply_attn_layer(bp, x, cfg, *, mode, cache=None, ep_axis=None,
                      lay: _Lay = _Lay()):
    h = rms_norm(x, bp["ln1"])
    a, new_cache = _attn(bp["attn"], h, cfg, mode, cache, lay,
                         causal=not cfg.encoder_only)
    x = x + a
    h = rms_norm(x, bp["ln2"])
    aux = {}
    if cfg.n_experts:
        m, aux = moe_lib.moe_ffn(bp["moe"], h, cfg, ep_axis=ep_axis,
                                 ffn_tp=lay.ffn_tp)
        if cfg.moe_dense_residual:
            m = m + _ffn(bp["ffn"], h, lay.ffn_tp)
        x = x + m
    else:
        x = x + _ffn(bp["ffn"], h, lay.ffn_tp)
    return x, new_cache, aux


def _apply_shared(sp, x, cfg, mode, cache, lay: _Lay = _Lay()):
    h = rms_norm(x, sp["ln1"])
    a, nc = _attn(sp["attn"], h, cfg, mode, cache, lay, causal=True)
    x = x + a
    h2 = rms_norm(x, sp["ln2"])
    return x + _ffn(sp["ffn"], h2, lay.ffn_tp), nc


# ---------------------------------------------------------------------------
# stack forward (train / prefill / decode)
# ---------------------------------------------------------------------------

class StackCaches(NamedTuple):
    """Union cache tree; unused slots are () for a given family. A KV
    cache's length and its 0-d ``max_len`` are int32 on the host."""
    kv: Any = ()          # attn: KVCache with (L, ...) leaves, length (L,)
    mlstm: Any = ()       # (L, B, H, dh, dh)
    slstm: Any = ()       # ((L,B,d), (L,B,d))
    mamba: Any = ()       # Mamba2State with (L, ...) leaves
    shared_kv: Any = ()   # hybrid: KVCache with (n_inv, ...) leaves, 0-d length


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _apply_layer(bp, x, cfg, kind: str, mode: str, cache, ep_axis=None,
                 lay: _Lay = _Lay()):
    """One layer of any family. Returns (x, new layer cache, dropped)."""
    if cfg.family in ATTN_FAMILIES:
        x, kv, aux = _apply_attn_layer(bp, x, cfg, mode=mode, cache=cache,
                                       ep_axis=ep_axis, lay=lay)
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
    return KVCache(k=kv.k[i], v=kv.v[i], length=int(kv.length[i]),
                   max_len=int(kv.max_len))


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


def _strip_layer_dim(specs):
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: _strip_layer_dim(v) for k, v in specs.items()}
    return tuple(specs)[1:]


def _tp_keep(cfg, ep_axis, lay: _Lay):
    """The compute views that stay split: the moe experts over
    ``ep_axis``, and over 'model' the attention's (``head_tp``: q's
    columns, k's and v's where ``n_kv_heads == n_heads``, wo's rows) and
    the FFN's and the experts' ``d_ff`` (``ffn_tp``)."""
    keep = {}
    tp = lay.ffn_tp
    if ep_axis or tp:
        keep["moe"] = {"w_gate": (ep_axis, None, tp),
                       "w_up": (ep_axis, None, tp),
                       "w_down": (ep_axis, tp, None)}
    if tp:
        keep["ffn"] = {"w_gate": (None, tp), "w_up": (None, tp),
                       "w_down": (tp, None)}
    h = lay.head_tp
    if h:
        names = ["q"] + (["k", "v"] if cfg.n_kv_heads == cfg.n_heads
                         else [])
        attn = {"wo": (h, None)}
        for n in names:
            attn[f"w{n}"] = (None, h)
            if cfg.qkv_bias:
                attn[f"b{n}"] = (h,)
        keep["attn"] = attn
    return keep or None


def stack_forward(stacked, shared_attn, x, cfg: ModelConfig,
                  ctx: Optional[ShardCtx] = None, *, mode: str,
                  caches: Optional[StackCaches] = None, block_specs=None,
                  shared_specs=None, head_tp=None, seq_axes=None,
                  dp_spec=None):
    """Run all layers. mode: 'train' | 'prefill' | 'decode'.

    Returns (x, new_caches, aux); 'train' produces no caches (None). The
    shared block's cache length is left as it came: ``LMModel`` sets it
    after a prefill and advances it after a decode, as the reference does.
    ``ctx`` (the expert and 'model' axes), ``block_specs``,
    ``shared_specs`` and the layout (``head_tp``, ``seq_axes``,
    ``dp_spec``) are JAX's: they matter on a mesh.
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
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    # expert parallelism where the experts split over a batch axis of the
    # mesh the model runs on: the all-to-all needs the rows split over it
    mc = current_mesh()
    ep_axis = (ctx.axis("fsdp", cfg.n_experts)
               if ctx is not None and cfg.n_experts else None)
    if mc is None or ep_axis not in mc.batch_axes:
        ep_axis = None
    # tensor parallelism over the live 'model' axis, where JAX's layout
    # splits: the heads (head_tp), d_ff where it divides the axis
    tp = mc.tp_axis if mc is not None else None
    lay = _Lay(head_tp=head_tp if tp and head_tp == tp else None,
               seq_axes=seq_axes, dp_spec=dp_spec,
               ffn_tp=(tp if tp and ctx is not None
                       and ctx.axis("tp", cfg.d_ff) == tp else None))
    per_layer_specs = _strip_layer_dim(block_specs)
    keep = _tp_keep(cfg, ep_axis, lay)
    if has_shared:
        shared_attn = constrain_tree(shared_attn, shared_specs,
                                     _tp_keep(cfg, None, lay))
    for i in range(L):
        if every and i % every == 0:
            # the shared attention block before each group (layers 0, k, 2k..)
            g = i // every
            if mode == "train":
                shared = lambda h: _apply_shared(shared_attn, h, cfg, mode,
                                                 None, lay)[0]
                x = (checkpoint(shared, x, use_reentrant=False) if remat
                     else shared(x))
            else:
                this = KVCache(k=shared_cache.k[g], v=shared_cache.v[g],
                               length=int(shared_cache.length),
                               max_len=int(shared_cache.max_len))
                x, _ = _apply_shared(shared_attn, x, cfg, mode, this, lay)
        bp = constrain_tree(_layer(stacked, i), per_layer_specs, keep)
        if remat:
            x, new, drop = checkpoint(
                lambda h, bp=bp, i=i: _apply_layer(bp, h, cfg, kinds[i],
                                                   mode, None, ep_axis, lay),
                x, use_reentrant=False)
        else:
            x, new, drop = _apply_layer(bp, x, cfg, kinds[i], mode,
                                        _layer_cache(caches, cfg, i),
                                        ep_axis, lay)
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
        return x, StackCaches(kv=kv._replace(length=lengths)), aux
    return x, _pack_caches(layer_caches, shared_cache, cfg), aux


def shared_invocations(cfg):
    if cfg.shared_attn_every <= 0:
        return 0
    return -(-cfg.n_layers // cfg.shared_attn_every)
