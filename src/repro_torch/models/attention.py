"""GQA attention: chunked train/prefill path + KV-cache decode path.

The counterpart of ``repro.models.attention``, in plain torch and in JAX's
order of operations: scores in float32 over ``sqrt(hd)``, masked with
-1e30 (not -inf), a float32 softmax, the output cast to the query's dtype.
``scaled_dot_product_attention`` is not used: its numerics differ from the
reference's. Full-sequence attention runs over query chunks of
``attn_chunk`` (a Python loop where JAX scans), so the (B, chunk, H, S)
score block is the only attention intermediate alive.

The KV cache is written in place: ``prefill_cache`` fills the cache it is
given and ``attention_decode`` writes one position of it. A cache's
``length`` lives on the host (a Python int for one layer; the stacked
caches of ``lm.py`` keep an int32 CPU tensor), so a decode reads its
position with no device sync. A decode past the cache's ``max_len``, and a
prompt longer than it, raise ``ValueError``: JAX's
``dynamic_update_slice`` clamps the position and overwrites the last slot
(ROADMAP C7). The cache's whole ``max_len`` lives on the host beside its
length, since a rank's block of a meshed cache does not tell it; every
rank takes that decision from the same host numbers, before any
collective.

On a mesh (``layers.mesh_context``) the layout is JAX's (``head_tp``,
``seq_axes``, and ``dp_spec`` where the prefill moves the cache, from
``lm.choose_layout``). With ``head_tp``
set, ``wq`` / ``bq`` are column-split over 'model' and each rank computes
its ``H / tp`` heads; ``wk`` / ``wv`` / ``bk`` / ``bv`` split only when
``n_kv_heads == n_heads`` (under GQA k and v are whole on every rank, and
a rank reads the kv heads its query heads share); ``wo`` is row-split and
followed by one sum over 'model'. With ``head_tp`` None the block is whole
on every rank. A rank holds the cache block of its batch rows and of its
sequence block over ``seq_axes`` (the layout's ``cache_seq``), all heads:
the prefill moves 'model' from the heads to the sequence (``shard``'s
all-to-all). A decode gathers the step's split heads, writes the new K/V
on the rank whose block holds the position, computes each rank's partial
softmax over its block and combines the partials over ``seq_axes``: a
max, then the sums of the exponentials and of the weighted V (the
"cache" kind), JAX's partial-softmax all-reduces.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import (ParamInit, apply_rope, bias_param,
                                       current_mesh, dense_param, shard,
                                       tp_copy, tp_index, tp_sum,
                                       torch_dtype)


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, KV, hd)
    v: torch.Tensor       # (B, S_max, KV, hd)
    length: object        # tokens already in the cache (host int)
    max_len: object       # positions of the whole cache (host int)


def init_attention(init: ParamInit, cfg, ctx):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = torch_dtype(cfg.dtype)
    p, s = {}, {}
    p["wq"], s["wq"] = dense_param(init, d, H * hd, ctx, dt)
    p["wk"], s["wk"] = dense_param(init, d, KV * hd, ctx, dt)
    p["wv"], s["wv"] = dense_param(init, d, KV * hd, ctx, dt)
    p["wo"], s["wo"] = dense_param(init, H * hd, d, ctx, dt, tp_dim="in")
    if cfg.qkv_bias:
        p["bq"], s["bq"] = bias_param(init, H * hd, ctx, dt, tp=True)
        p["bk"], s["bk"] = bias_param(init, KV * hd, ctx, dt, tp=True)
        p["bv"], s["bv"] = bias_param(init, KV * hd, ctx, dt, tp=True)
    return p, s


def _split(cfg, head_tp):
    """(q heads split, k/v heads split) over the live 'model' axis."""
    mc = current_mesh()
    split = mc is not None and head_tp is not None and head_tp == mc.tp_axis
    return split, split and cfg.n_kv_heads == cfg.n_heads


def _qkv(p, x, cfg, head_tp=None):
    """q, k, v: (B, S, heads, hd); this rank's heads where they split."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    split, kv_split = _split(cfg, head_tp)
    if split and not kv_split:
        # GQA: k and v whole on every rank, q of this rank's heads
        k, v = x @ p["wk"], x @ p["wv"]
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
        x, k, v = tp_copy(x, k, v)
        q = x @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
    else:
        if split:
            x = tp_copy(x)
        q = x @ p["wq"]
        k = x @ p["wk"]
        v = x @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        q.reshape(B, S, -1, hd),
        k.reshape(B, S, -1, hd),
        v.reshape(B, S, -1, hd),
    )


def _local_kv(k, v, q_heads: int, cfg, head_tp):
    """Under GQA with the query heads split: the kv heads that this rank's
    ``q_heads`` query heads read (head h reads kv head h // G)."""
    split, kv_split = _split(cfg, head_tp)
    if not split or kv_split:
        return k, v
    G = cfg.n_heads // cfg.n_kv_heads
    h0 = tp_index(head_tp)[0] * q_heads
    if q_heads % G == 0:
        return (k[:, :, h0 // G:(h0 + q_heads) // G],
                v[:, :, h0 // G:(h0 + q_heads) // G])
    idx = torch.arange(h0, h0 + q_heads, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]


def _out_proj(p, out, head_tp, cfg):
    """(B, S, heads, hd) @ wo: the row-split product and its sum over
    'model' where the heads split."""
    B, S = out.shape[:2]
    out = out.reshape(B, S, -1) @ p["wo"]
    return tp_sum(out) if _split(cfg, head_tp)[0] else out


def _scores(qc, k, mask):
    """The float32 scores (B, c, KV, G, S) of qc: (B, c, H, hd) over k:
    (B, S, KV, hd), over ``sqrt(hd)``, -1e30 where ``mask`` (c, S) is
    False. Query head h reads kv head h // G, G = H // KV."""
    B, c, H, hd = qc.shape
    KV = k.shape[2]
    qg = qc.reshape(B, c, KV, H // KV, hd)
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32, device=qc.device)
    scores = torch.einsum("bckgh,bskh->bckgs", qg.float(), k.float()) / scale
    if mask is not None:
        scores = scores.masked_fill(~mask[None, :, None, None, :], -1e30)
    return scores


def _sdpa_block(qc, k, v, mask, cfg):
    """qc: (B, c, H, hd) vs full k/v: (B, S, KV, hd); mask (c, S) or None."""
    w = torch.softmax(_scores(qc, k, mask), dim=-1)
    out = torch.einsum("bckgs,bskh->bckgh", w, v.float())
    return out.reshape(qc.shape).to(qc.dtype)


def _attend(p, q, k, v, cfg, *, causal: bool, head_tp=None):
    """Attention of roped q over roped k and v, over query chunks."""
    B, S = q.shape[:2]
    k, v = _local_kv(k, v, q.shape[2], cfg, head_tp)
    chunk = min(cfg.attn_chunk, S)
    if S % chunk:
        chunk = S  # fall back to unchunked for odd smoke-test lengths
    pos_k = torch.arange(S, device=q.device)
    outs = []
    for lo in range(0, S, chunk):
        mask = None
        if causal:
            pos_q = lo + torch.arange(chunk, device=q.device)
            mask = pos_k[None, :] <= pos_q[:, None]
        outs.append(_sdpa_block(q[:, lo:lo + chunk], k, v, mask, cfg))
    return _out_proj(p, torch.cat(outs, dim=1), head_tp, cfg)


def attention_forward(p, x, cfg, *, causal: bool, head_tp=None,
                      positions=None):
    """Full-sequence attention (train / prefill). x: (B, S, d)."""
    S = x.shape[1]
    q, k, v = _qkv(p, x, cfg, head_tp)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return _attend(p, q, k, v, cfg, causal=causal, head_tp=head_tp)


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device) -> KVCache:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
        length=0,
        max_len=max_len,
    )


def _seq_block(seq_axes) -> tuple:
    """(this rank's block index, block count, live axes) of a cache
    sequence split over ``seq_axes`` (the entry's first axis major)."""
    mc = current_mesh()
    if mc is None:
        return 0, 1, ()
    live = mc.mesh.entry_live(seq_axes)
    return (*mc.mesh._index(live, mc.mesh.coords), live)


def _gather_heads(cfg, head_tp, *ts):
    """q, k, v with every head: the split ones gathered over 'model' (one
    all-gather). Inference only."""
    split, kv_split = _split(cfg, head_tp)
    if not split:
        return ts
    mc = current_mesh()
    todo = [i for i, t in enumerate(ts) if i == 0 or kv_split]
    spec = (None, None, head_tp, None)
    whole = mc.mesh.gather_many([ts[i] for i in todo], [spec] * len(todo),
                                kind="tp")
    out = list(ts)
    for i, w in zip(todo, whole):
        out[i] = w
    return tuple(out)


def _sdpa_partial(q, k, v, valid, cfg, seq_axes: tuple):
    """``_sdpa_block`` of one query position over this rank's block of the
    sequence, the partial softmaxes combined over the live ``seq_axes``
    (a tuple): the max of
    the scores, then the sums of the exponentials and of the weighted V
    (two all-reduces, the "cache" kind). q: (B, 1, H, hd)."""
    mesh = current_mesh().mesh
    scores = _scores(q, k, valid)
    top = mesh.all_reduce(scores.amax(-1, keepdim=True), seq_axes, "max",
                          kind="cache")
    e = torch.exp(scores - top)
    den, num = mesh.all_reduce_many(
        [e.sum(-1, keepdim=True), torch.einsum("bckgs,bskh->bckgh", e,
                                               v.float())],
        seq_axes, kind="cache")
    return (num / den).reshape(q.shape).to(q.dtype)


def attention_decode(p, x, cache: KVCache, cfg, *, head_tp=None,
                     seq_axes=None):
    """One-token decode. x: (B, 1, d). Returns (out (B,1,d), cache), the
    cache (this rank's block on a mesh) written in place at position
    ``cache.length``."""
    B = x.shape[0]
    blk = cache.k.shape[1]
    idx, n_seq, live = _seq_block(seq_axes)
    s0 = idx * blk
    pos, S = int(cache.length), int(cache.max_len)
    if pos >= S:        # every rank: the same host numbers
        raise ValueError(
            f"decode at position {pos} past the KV cache's max_len {S}: "
            f"allocate the cache for the prompt and every decoded token")
    q, k, v = _qkv(p, x, cfg, head_tp)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    heads = q.shape[2]
    q, k, v = _gather_heads(cfg, head_tp, q, k, v)
    if s0 <= pos < s0 + blk:
        cache.k[:, pos - s0] = k[:, 0].to(cache.k.dtype)
        cache.v[:, pos - s0] = v[:, 0].to(cache.v.dtype)
    valid = (s0 + torch.arange(blk, device=x.device))[None, :] <= pos
    if n_seq > 1:
        out = _sdpa_partial(q, cache.k, cache.v, valid, cfg, live)
    else:
        out = _sdpa_block(q, cache.k, cache.v, valid, cfg)
    if _split(cfg, head_tp)[0]:
        h0 = tp_index(head_tp)[0] * heads
        out = out[:, :, h0:h0 + heads]
    return (_out_proj(p, out, head_tp, cfg),
            cache._replace(length=pos + 1))


def _cache_block(t, max_len: int, cfg, head_tp, seq_axes, dp_spec):
    """This rank's cache block of a prompt's roped k (or v), (B, S, heads,
    hd) with this rank's rows: zero past the prompt to ``max_len``, the
    sequence split over ``seq_axes`` (its axes before 'model' by a local
    slice, 'model' by moving it from the heads where they split), every
    head (gathered over 'model' where the heads split and the sequence
    does not)."""
    mesh = current_mesh().mesh
    tp = current_mesh().tp_axis
    B, S = t.shape[:2]
    full = t.new_zeros((B, max_len) + tuple(t.shape[2:]))
    full[:, :S] = t
    live = mesh.entry_live(seq_axes)
    pre = live[:live.index(tp)] if tp in live else live
    if pre:
        i, n = mesh._index(pre, mesh.coords)
        step = max_len // n
        full = full[:, i * step:(i + 1) * step]
    split = _split(cfg, head_tp)[1]
    if tp in live and split:
        return shard(full, dp_spec, tp, None, None,
                     src=(dp_spec, None, tp, None))
    if tp in live:
        i, n = tp_index(tp)
        step = full.shape[1] // n
        return full[:, i * step:(i + 1) * step]
    if split:       # the sequence whole: every head on every rank
        return mesh.gather_many([full], [(None, None, tp)], kind="tp")[0]
    return full


def prefill_cache(p, x, cfg, *, cache: Optional[KVCache] = None,
                  head_tp=None, seq_axes=None, dp_spec=None):
    """Prefill: full forward that also fills the cache (the roped k and the
    raw v, in the projection's dtype; positions past the prompt zeroed).
    Without a cache, one of the prompt's length is made (off a mesh)."""
    B, S, _ = x.shape
    mc = current_mesh()
    if mc is not None and cache is None:
        raise ValueError("a meshed prefill writes into the caches of "
                         "LMModel.init_caches: pass them")
    max_len = None if cache is None else int(cache.max_len)
    if max_len is not None and S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a KV cache "
                         f"of max_len {max_len}")
    q, k, v = _qkv(p, x, cfg, head_tp)
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k_r = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(p, q, k_r, v, cfg, causal=not cfg.encoder_only,
                  head_tp=head_tp)
    if mc is not None:
        cache.k.copy_(_cache_block(k_r, max_len, cfg, head_tp, seq_axes,
                                   dp_spec))
        cache.v.copy_(_cache_block(v, max_len, cfg, head_tp, seq_axes,
                                   dp_spec))
        return out, cache._replace(length=S)
    if cache is None:
        cache = init_kv_cache(cfg, B, S, k.dtype, x.device)
    cache.k[:, :S] = k_r.to(cache.k.dtype)
    cache.v[:, :S] = v.to(cache.v.dtype)
    cache.k[:, S:] = 0
    cache.v[:, S:] = 0
    return out, cache._replace(length=S)
