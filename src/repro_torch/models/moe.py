"""Mixture-of-Experts FFN: top-k router, capacity, sort-based dispatch.

The counterpart of ``repro.models.moe``. Dispatch is scatter-based (a
stable sort by expert id and per-expert slots), not a one-hot einsum.
Tokens over an expert's capacity are dropped, and the drop fraction is
returned. Routing is row-local (capacity a batch row) for prefill and
training, and batch-global at decode (S = 1), where the batch folds into
one routing row.

The reference's ``jnp.argsort`` is stable, so the sort here is too:
otherwise the order of tokens inside an expert, and so which tokens pass
its capacity, would differ. Its ``.at[slot].set(..., mode="drop")`` drops
writes to slot ``E*cap``; here that slot is one spare row, cut off after
the scatter. On tied router probabilities ``lax.top_k`` takes the lower
expert first, and ``torch.topk`` promises no order; no test has met a tie.

On a mesh with expert parallelism (``ep_axis``: the experts split over
the FSDP axis 'data', which they divide), JAX's cut points move the
dispatched tokens from rows over 'data' to experts over 'data' (the
all-to-all), each rank runs its own experts on every row of its pod, and
the outputs move back. Otherwise the experts' weights are whole over
'data' (``constrain_tree`` gathered them) and each rank runs every expert
on its own rows. With ``ffn_tp`` (the live 'model' axis, where ``d_ff``
divides it) each rank holds its block of every expert's ``d_ff``: its
``w_gate`` / ``w_up`` columns and ``w_down`` rows, and the partial outputs
are summed over 'model'.

At decode on a mesh, the rows of every rank are gathered over the batch
axes before the fold, so that one routing row holds the whole decode
batch, as JAX's does; with expert parallelism each rank then runs its own
experts on it and the outputs are gathered over ``ep_axis``; each rank
keeps its own rows of the result.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (ParamInit, current_mesh, dense_param,
                                       shard, torch_dtype, tp_copy, tp_sum)


def init_moe(init: ParamInit, cfg, ctx):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = torch_dtype(cfg.dtype)
    p, s = {}, {}
    p["router"], _ = dense_param(init, d, E, ctx, torch.float32, scale=0.02)
    s["router"] = (None, None)  # tiny; keep replicated
    ep_axis = ctx.axis("fsdp", E)
    p["w_gate"] = init.normal((E, d, ff), 1.0 / math.sqrt(d), dt)
    p["w_up"] = init.normal((E, d, ff), 1.0 / math.sqrt(d), dt)
    p["w_down"] = init.normal((E, ff, d), 1.0 / math.sqrt(ff), dt)
    if ep_axis:
        s["w_gate"] = s["w_up"] = (ep_axis, None, ctx.axis("tp", ff))
        s["w_down"] = (ep_axis, ctx.axis("tp", ff), None)
    else:
        s["w_gate"] = s["w_up"] = (None, ctx.axis("fsdp", d),
                                   ctx.axis("tp", ff))
        s["w_down"] = (None, ctx.axis("tp", ff), ctx.axis("fsdp", d))
    return p, s


def capacity(S: int, cfg) -> int:
    """Slots an expert a routing row: ceil8(S*k/E*capacity_factor), >= 8."""
    raw = int(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(-(-raw // 8) * 8, 8)


def _route_rows(tokens, tope, topw, E, k, cap):
    """Dispatch every batch row on its own: (B,S,d),(B,S,k),(B,S,k) ->
    dispatched (B, E*cap, d), and slot/src/wgt/keep (B, S*k) for the
    combine."""
    B, S, d = tokens.shape
    dev = tokens.device
    eid = tope.reshape(B, S * k)
    src = torch.arange(S, device=dev).repeat_interleave(k)
    wgt = topw.reshape(B, S * k)
    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = torch.gather(eid, 1, order)
    src_s = src[order]
    wgt_s = torch.gather(wgt, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, eid, torch.ones_like(eid))
    offsets = torch.cumsum(counts, dim=1) - counts              # exclusive
    pos_in_e = (torch.arange(S * k, device=dev)
                - torch.gather(offsets, 1, eid_s))
    keep = pos_in_e < cap
    drop = E * cap
    slot = torch.where(keep, eid_s * cap + pos_in_e, drop)
    rows = torch.gather(tokens, 1, src_s[..., None].expand(B, S * k, d))
    dispatched = torch.zeros((B, drop + 1, d), dtype=tokens.dtype, device=dev)
    dispatched.scatter_(1, slot[..., None].expand(B, S * k, d), rows)
    return dispatched[:, :drop], slot, src_s, wgt_s, keep


def _fold_meshed(p, x, cfg, ep_axis, ffn_tp):
    """The decode fold on a mesh: every rank's rows gathered over the
    batch axes (the "expert" kind), routed as one row, this rank's rows
    kept."""
    mc = current_mesh()
    mesh, rows = mc.mesh, (mc.batch_axes or None,)
    B, S, d = x.shape
    whole = mesh.gather_many([x], [rows], kind="expert")[0]
    out, aux = moe_ffn(p, whole.reshape(1, -1, d), cfg, ep_axis=ep_axis,
                       ffn_tp=ffn_tp, _folded=True)
    out = out.reshape(-1, S, d)
    return out[mesh.block(rows, out.shape)], aux


def _experts(p, dispatched, ffn_tp):
    """(B, E, cap, d) through each expert's SwiGLU; the partial outputs
    summed over 'model' where ``d_ff`` splits."""
    if ffn_tp is not None:
        dispatched = tp_copy(dispatched)
    h = F.silu(torch.einsum("becd,edf->becf", dispatched, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", dispatched, p["w_up"])
    eo = torch.einsum("becf,efd->becd", h, p["w_down"])
    return tp_sum(eo) if ffn_tp is not None else eo


def moe_ffn(p, x, cfg, *, ep_axis=None, ffn_tp=None, _folded=False):
    """x: (B, S, d) -> (B, S, d). Returns (out, aux) with load stats.
    ``ep_axis``: the mesh axis the experts split over, or None;
    ``ffn_tp``: the 'model' axis ``d_ff`` splits over, or None."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    mc = current_mesh()
    if S == 1 and not _folded:
        n_rows = B
        if mc is not None:
            n_rows *= math.prod(mc.mesh.shape[a] for a in mc.batch_axes)
        if mc is not None and n_rows > 1:
            return _fold_meshed(p, x, cfg, ep_axis, ffn_tp)
        if B > 1:
            # decode: fold the batch into one routing row, so capacity is
            # shared across the decode batch
            out, aux = moe_ffn(p, x.reshape(1, B, d), cfg)
            return out.reshape(B, S, d), aux

    # router: operands in the activations' dtype, float32 accumulation
    logits = x.float() @ p["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    topw, tope = torch.topk(probs, k, dim=-1)                # (B, S, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    cap = capacity(S, cfg)
    dispatched, slot, src_s, wgt_s, keep = _route_rows(x, tope, topw, E, k,
                                                       cap)
    dispatched = dispatched.reshape(B, E, cap, d)
    if ep_axis is not None and _folded:
        # the folded row is whole on every rank: run this rank's experts
        # and gather their outputs over ep_axis
        blk = mc.mesh.block((None, ep_axis), dispatched.shape)
        eo = _experts(p, dispatched[blk], ffn_tp)
        eo = mc.mesh.gather_many([eo], [(None, ep_axis)], kind="expert")[0]
    elif ep_axis is not None:
        # the all-to-all: rows over ep_axis -> experts over ep_axis
        dispatched = shard(dispatched, None, ep_axis, None, None)
        eo = _experts(p, dispatched, ffn_tp)
        # the reverse all-to-all
        eo = shard(eo, src=(None, ep_axis, None, None))
    else:
        eo = _experts(p, dispatched, ffn_tp)
    eo = eo.reshape(B, E * cap, d)
    eo = torch.cat([eo, torch.zeros((B, 1, d), dtype=eo.dtype,
                                    device=eo.device)], dim=1)
    gathered = (torch.gather(eo, 1, slot[..., None].expand(B, S * k, d))
                * wgt_s[..., None].to(eo.dtype))
    rows = (src_s + S * torch.arange(B, device=x.device)[:, None]).reshape(-1)
    out = torch.zeros((B * S, d), dtype=eo.dtype, device=x.device)
    out.index_add_(0, rows, gathered.reshape(B * S * k, d))
    aux = {
        "dropped_frac": 1.0 - keep.float().mean(),
        "router_entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean(),
    }
    return out.reshape(B, S, d).to(x.dtype), aux
