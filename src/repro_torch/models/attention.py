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
(ROADMAP C7).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import (ParamInit, apply_rope, bias_param,
                                       dense_param, torch_dtype)


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, KV, hd)
    v: torch.Tensor       # (B, S_max, KV, hd)
    length: object        # tokens already in the cache (host int)


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


def _qkv(p, x, cfg):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        q.reshape(B, S, H, hd),
        k.reshape(B, S, KV, hd),
        v.reshape(B, S, KV, hd),
    )


def _sdpa_block(qc, k, v, mask, cfg):
    """qc: (B, c, H, hd) vs full k/v: (B, S, KV, hd); mask (c, S) or None.
    Query head h reads kv head h // G, G = H // KV."""
    B, c, H, hd = qc.shape
    KV = k.shape[2]
    G = H // KV
    qg = qc.reshape(B, c, KV, G, hd)
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32, device=qc.device)
    scores = torch.einsum("bckgh,bskh->bckgs", qg.float(), k.float()) / scale
    if mask is not None:
        scores = scores.masked_fill(~mask[None, :, None, None, :], -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bckgs,bskh->bckgh", w, v.float())
    return out.reshape(B, c, H, hd).to(qc.dtype)


def _attend(p, q, k, v, cfg, *, causal: bool):
    """Attention of roped q over roped k and v, over query chunks."""
    B, S = q.shape[:2]
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
    out = torch.cat(outs, dim=1).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"]


def attention_forward(p, x, cfg, *, causal: bool, positions=None):
    """Full-sequence attention (train / prefill). x: (B, S, d)."""
    S = x.shape[1]
    q, k, v = _qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return _attend(p, q, k, v, cfg, causal=causal)


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device) -> KVCache:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
        length=0,
    )


def attention_decode(p, x, cache: KVCache, cfg):
    """One-token decode. x: (B, 1, d). Returns (out (B,1,d), cache), the
    cache written in place at position ``cache.length``."""
    B = x.shape[0]
    S = cache.k.shape[1]
    pos = int(cache.length)
    if pos >= S:
        raise ValueError(
            f"decode at position {pos} past the KV cache's max_len {S}: "
            f"allocate the cache for the prompt and every decoded token")
    q, k, v = _qkv(p, x, cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
    valid = torch.arange(S, device=x.device)[None, :] <= pos      # (1, S)
    out = _sdpa_block(q, cache.k, cache.v, valid, cfg)            # (B, 1, H, hd)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out, KVCache(k=cache.k, v=cache.v, length=pos + 1)


def prefill_cache(p, x, cfg, *, cache: Optional[KVCache] = None):
    """Prefill: full forward that also fills the cache (the roped k and the
    raw v, in the projection's dtype; positions past the prompt zeroed).
    Without a cache, one of the prompt's length is made."""
    B, S, _ = x.shape
    if cache is not None and S > cache.k.shape[1]:
        raise ValueError(f"a prompt of {S} tokens does not fit a KV cache "
                         f"of max_len {cache.k.shape[1]}")
    q, k, v = _qkv(p, x, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k_r = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(p, q, k_r, v, cfg, causal=not cfg.encoder_only)
    if cache is None:
        cache = init_kv_cache(cfg, B, S, k.dtype, x.device)
    cache.k[:, :S] = k_r.to(cache.k.dtype)
    cache.v[:, :S] = v.to(cache.v.dtype)
    cache.k[:, S:] = 0
    cache.v[:, S:] = 0
    return out, KVCache(k=cache.k, v=cache.v, length=S)
