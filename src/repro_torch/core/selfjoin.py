"""The epsilon self-join (paper Alg. 1 with UNICOMP), in PyTorch.

The paper's GPU kernel is thread-per-point: each thread walks the adjacent
cells of its point and appends pairs through a global atomic. This port keeps
the JAX package's formulation, an offset sweep with a single-pass count and
fill:

  1. build the epsilon-grid (``grid.build_grid``);
  2. plan: stencil offset tables, capacity buckets (``grid.occupancy_plan``)
     and per-launch window descriptors (one batched searchsorted);
  3. one fused gather-refine launch per bucket (``kernels.fused_join``): the
     hit plane, per-row counts and per-tile slot bases;
  4. emit the pairs from the hit plane, with no second distance pass.

Only ``distance_impl="fused"`` with the L2 metric and the ``"dense"`` count
route is ported so far; the other options of the JAX package raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import metric as metric_lib
from repro_torch.core.grid import (GridIndex, build_grid, global_window_cap,
                                   host_dims, occupancy_plan,
                                   point_last_coords, range_window_descriptors,
                                   range_window_descriptors_at, resolve_device,
                                   round_up, row_major_strides,
                                   window_descriptors, window_descriptors_at)
from repro_torch.core.stencil import merged_stencil_offsets, stencil_offsets
from repro_torch.kernels import ops
from repro_torch.kernels.fused_join import (TQ_DEFAULT, pad_points,
                                            resolve_merge_last_dim)

_ROUTES = ("dense", "compact", "sparse", "jnp", "dense-flat", "sparse-flat",
           "dense-run")


@dataclasses.dataclass(frozen=True)
class JoinStats:
    """Work counters (paper Table II analogue: cells and distances checked)."""

    total_pairs: int          # ordered pairs with dist <= eps (excl. self)
    cells_visited: int        # non-empty adjacent cells evaluated
    candidates_checked: int   # candidate slots with a real point
    offsets: int              # stencil offsets swept
    route: str = "dense"      # the count route that ran
    dma_windows_issued: int = 0  # windows read: n_off * rows over launches


def _offset_tables(index: GridIndex, unicomp: bool):
    """Per-cell stencil -> (deltas (n_off,) int64, is_zero (n_off,) int32)."""
    offs = stencil_offsets(index.n_dims, unicomp)
    deltas = offs @ row_major_strides(host_dims(index))
    is_zero = np.all(offs == 0, axis=1).astype(np.int32)
    return (torch.as_tensor(deltas).to(index.device),
            torch.as_tensor(is_zero).to(index.device))


def _merged_offset_tables(index: GridIndex, unicomp: bool):
    """Merged-range stencil -> (dtab (3, n_off) int64, is_zero (n_off,)):
    row 0 the linearized reduced offsets, rows 1/2 their last-dimension
    lo/hi spans."""
    reduced, lo, hi = merged_stencil_offsets(index.n_dims, unicomp)
    deltas = reduced @ row_major_strides(host_dims(index))
    dtab = np.stack([deltas, lo, hi])
    is_zero = np.all(reduced == 0, axis=1).astype(np.int32)
    return (torch.as_tensor(dtab).to(index.device),
            torch.as_tensor(is_zero).to(index.device))


def _resolve_merge(index: GridIndex, merge_last_dim: Optional[bool]) -> bool:
    return resolve_merge_last_dim(index.n_dims, merge_last_dim)


def _resolve_index(points, eps, index: Optional[GridIndex],
                   device: torch.device) -> GridIndex:
    if index is None:
        return build_grid(points, float(eps), device=device)
    if index.device != device:
        raise ValueError(f"index lies on {index.device}, the join was asked "
                         f"to run on {device}")
    return index


# ---------------------------------------------------------------------------
# Launch preparation. A launch is (sel | None, q_start, q_size, qp, c, tile):
# a contiguous batch of sorted rows when ``sel`` is None, else an occupancy
# bucket's ascending selection of sorted positions.
# ---------------------------------------------------------------------------

def _fused_prep(index: GridIndex, points_pad, deltas, q_start: int, *,
                qp: int, q_limit: int, merged: bool):
    """Window descriptors and the query slice of a contiguous batch. Rows
    at or past ``q_limit`` are tile padding and get count-0 windows."""
    if merged:
        ws, wc, wcells = range_window_descriptors(
            index, deltas[0], deltas[1], deltas[2], q_start, qp)
    else:
        ws, wc = window_descriptors(index, deltas, q_start, qp)
        wcells = (wc > 0).to(torch.int32)
    if q_limit < qp:
        ok = torch.arange(qp, device=index.device) < q_limit
        wc = torch.where(ok, wc, 0)
        wcells = torch.where(ok, wcells, 0)
    q_batch = points_pad[q_start:q_start + qp]
    if q_batch.shape[0] != qp:
        raise ValueError(f"points_pad has no room for rows [{q_start}, "
                         f"{q_start + qp}): its tail is too short")
    q_pos = q_start + torch.arange(qp, dtype=torch.int32, device=index.device)
    return ws, wc, wcells, q_batch, q_pos


def _fused_bucket_prep(index: GridIndex, points_pad, deltas, sel, nsel: int,
                       *, qp: int, merged: bool):
    """Window descriptors and gathered query rows of one occupancy bucket;
    ``sel`` is its (qp,) selection, rows >= ``nsel`` are padding."""
    q_ok = torch.arange(qp, device=index.device) < nsel
    q_pos = torch.clamp(sel, max=index.num_points - 1).to(torch.int32)
    if merged:
        ws, wc, wcells = range_window_descriptors_at(
            index, deltas[0], deltas[1], deltas[2], q_pos, q_ok)
    else:
        ws, wc = window_descriptors_at(index, deltas, q_pos, q_ok)
        wcells = (wc > 0).to(torch.int32)
    return ws, wc, wcells, points_pad[q_pos.long()], q_pos


def _fused_pad(index: GridIndex, *, q_size: int, c: int,
               q_start_max: int = 0, tq: int = TQ_DEFAULT,
               merged: bool = False):
    """One padded copy of the points for every launch of a sweep. The tail
    covers the c-slot window reads and the last batch's rounded-up query
    slice; merged sweeps carry the last-dimension cell coordinate."""
    qp = round_up(max(q_size, 1), tq)
    tail = max(c, q_start_max + qp - index.num_points)
    lc = point_last_coords(index) if merged else None
    return pad_points(index.points_sorted, tail, last_coord=lc), qp


def _launch_prep(index: GridIndex, points_pad, deltas, launch, *,
                 merged: bool):
    """Descriptors and query rows of one launch (either kind)."""
    sel, q_start, q_size, qp, _, _ = launch
    if sel is None:
        return _fused_prep(index, points_pad, deltas, q_start, qp=qp,
                           q_limit=max(q_size, 1), merged=merged)
    sel_pad = np.zeros(qp, np.int32)
    sel_pad[:sel.shape[0]] = sel
    return _fused_bucket_prep(index, points_pad, deltas,
                              torch.as_tensor(sel_pad).to(index.device),
                              sel.shape[0], qp=qp, merged=merged)


def _fused_launch(index: GridIndex, points_pad, deltas, is_zero, launch, *,
                  unicomp: bool, keep_hits: bool, merged: bool):
    """One launch through the fused kernel at its capacity (the JAX
    package's ``_fused_batch_run`` and ``_fused_bucket_launch``)."""
    _, _, _, _, c, tile = launch
    with record_function("self_join.plan"):
        ws, wc, wcells, q_batch, q_pos = _launch_prep(
            index, points_pad, deltas, launch, merged=merged)
    with record_function("self_join.kernel"):
        hits, counts, base = ops.fused_join_hits(
            points_pad, q_batch, ws, wc, is_zero, q_pos, index.eps, c=c,
            n_real=index.n_dims, unicomp=unicomp, merged=merged, tq=tile,
            keep_hits=keep_hits)
    return ws, wc, wcells, hits, counts, base, q_pos


def _fused_launches(index: GridIndex, *, bucketed: Optional[bool],
                    merged: bool = False):
    """The launch schedule of one fused sweep: one launch per occupancy
    bucket, or one contiguous launch when the plan has a single class.
    Returns (launches, points_pad, c_global)."""
    npts = index.num_points
    c_glob = global_window_cap(index, merged)
    if bucketed is None:
        bucketed = True
    plan = occupancy_plan(index, merged=merged) if bucketed else None
    if plan is None or plan.sel[0] is None:
        cap = c_glob if plan is None else plan.caps[0]
        points_pad, qp = _fused_pad(index, q_size=npts, c=c_glob,
                                    tq=TQ_DEFAULT, merged=merged)
        return [(None, 0, npts, qp, cap, TQ_DEFAULT)], points_pad, c_glob
    points_pad, _ = _fused_pad(index, q_size=1, c=c_glob, merged=merged)
    launches = [(sel, 0, sel.shape[0], round_up(sel.shape[0], TQ_DEFAULT),
                 cap, TQ_DEFAULT) for cap, sel in zip(plan.caps, plan.sel)]
    return launches, points_pad, c_glob


# ---------------------------------------------------------------------------
# Emit: pairs from the count pass's hit plane, no distances.
# ---------------------------------------------------------------------------

def _emit_from_hits(index: GridIndex, ids, hits, counts, slot_base,
                    win_start, q_pos, *, c: int, tq: int, unicomp: bool,
                    capacity: int):
    """Device fill: scatter pairs to the slots the kernel's per-tile scan
    (``slot_base``) assigned, offset by the scan of the tile totals. Rows
    are query-major (per query: offsets in sweep order, slots in window
    order). Returns (keys, vals) with ``capacity`` slots each."""
    n_off, qp, _ = hits.shape
    npts = index.num_points
    dev = hits.device
    slots = torch.arange(c, dtype=torch.int32, device=dev)
    cand_pos = win_start[:, :, None] + slots[None, None, :]
    h = hits.to(torch.bool).permute(1, 0, 2).reshape(qp, n_off * c)
    cp = torch.clamp(cand_pos.permute(1, 0, 2).reshape(qp, n_off * c),
                     max=npts - 1)
    rank = torch.cumsum(h, dim=1) - 1            # hit rank within its query
    tile_tot = counts.reshape(-1, tq).sum(dim=1, dtype=torch.int64)
    tile_base = torch.cumsum(tile_tot, 0) - tile_tot
    qbase = torch.repeat_interleave(tile_base, tq) + slot_base.long()
    pos = qbase[:, None] + rank
    q_pos_c = torch.clamp(q_pos, max=npts - 1).long()
    qid = ids[q_pos_c][:, None].expand(h.shape)
    cid = ids[cp.long()]
    # non-hits write the spare slot ``capacity``, which is cut off
    keys = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    vals = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)

    def put(idx, k, v):
        keys.scatter_(0, idx.reshape(-1), k.reshape(-1))
        vals.scatter_(0, idx.reshape(-1), v.reshape(-1))

    if unicomp:
        # every hit is an unordered pair -> two ordered result rows
        put(torch.where(h, 2 * pos, capacity), qid, cid)
        put(torch.where(h, 2 * pos + 1, capacity), cid, qid)
    else:
        put(torch.where(h, pos, capacity), qid, cid)
    return keys[:capacity], vals[:capacity]


def sort_pairs(pairs: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Pairs in lexicographic (first, second) order; ids lie in [0, n_ids)."""
    key = pairs[:, 0].long() * n_ids + pairs[:, 1].long()
    return pairs[torch.argsort(key)]


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def _self_join_fused(index: GridIndex, *, unicomp: bool, sort_result: bool,
                     bucketed: Optional[bool] = None,
                     merged: bool = True) -> torch.Tensor:
    """Single-pass count -> fill driver for ``distance_impl="fused"``.

    Each launch's kernel returns its hit plane and counts; the result size
    follows from the counts and the fill only compacts the same plane, on
    the index's device. Every bucketing and sweep choice gives the same
    pair set. The stages run inside ``torch.profiler.record_function``
    spans (``self_join.plan``, ``.kernel``, ``.emit``) that a profiler
    groups its time by.
    """
    with record_function("self_join.plan"):
        if merged:
            deltas, is_zero = _merged_offset_tables(index, unicomp)
        else:
            deltas, is_zero = _offset_tables(index, unicomp)
        launches, points_pad, _ = _fused_launches(index, bucketed=bucketed,
                                                  merged=merged)
    mult = 2 if unicomp else 1

    def finish(run):
        """Drain one launch; the next launch is already queued."""
        ws, hits, counts, base, q_pos, cap, tile = run
        with record_function("self_join.emit"):
            ordered = mult * int(counts.sum(dtype=torch.int64))
            keys, vals = _emit_from_hits(
                index, index.order, hits, counts, base, ws, q_pos, c=cap,
                tq=tile, unicomp=unicomp, capacity=max(ordered, 1))
            return torch.stack([keys[:ordered], vals[:ordered]], dim=1)

    chunks = []
    prev = None
    for launch in launches:
        ws, _, _, hits, counts, base, q_pos = _fused_launch(
            index, points_pad, deltas, is_zero, launch, unicomp=unicomp,
            keep_hits=True, merged=merged)
        if prev is not None:
            chunks.append(finish(prev))
        prev = (ws, hits, counts, base, q_pos, launch[4], launch[5])
    chunks.append(finish(prev))
    with record_function("self_join.emit"):
        out = torch.cat(chunks, dim=0)
        if sort_result:
            out = sort_pairs(out, index.num_points)
    return out


def _self_join_count_fused(index: GridIndex, *, unicomp: bool,
                           query_batch: Optional[int] = None,
                           bucketed: Optional[bool] = None,
                           merged: bool = True) -> JoinStats:
    """Count-only fused sweep (no hit plane). Occupancy-bucketed by
    default; an explicit ``query_batch`` runs contiguous batches at the
    global capacity (the paper's SV-A memory bound). Merged and per-cell
    sweeps report the same totals, cells and candidates."""
    if merged:
        deltas, is_zero = _merged_offset_tables(index, unicomp)
    else:
        deltas, is_zero = _offset_tables(index, unicomp)
    n_off = int(is_zero.shape[0])
    npts = index.num_points
    mult = 2 if unicomp else 1
    if query_batch:
        c = global_window_cap(index, merged)
        q_size = int(query_batch)
        points_pad, qp = _fused_pad(
            index, q_size=q_size, c=c, tq=TQ_DEFAULT,
            q_start_max=((npts - 1) // q_size) * q_size, merged=merged)
        launches = [(None, q_start, min(q_size, npts - q_start), qp, c,
                     TQ_DEFAULT) for q_start in range(0, npts, q_size)]
    else:
        launches, points_pad, _ = _fused_launches(index, bucketed=bucketed,
                                                  merged=merged)
    total = cells = cands = dma_windows = 0
    for launch in launches:
        _, wc, wcells, _, counts, _, _ = _fused_launch(
            index, points_pad, deltas, is_zero, launch, unicomp=unicomp,
            keep_hits=False, merged=merged)
        dma_windows += n_off * launch[3]
        total += mult * int(counts.sum(dtype=torch.int64))
        cells += int(wcells.sum(dtype=torch.int64))
        cands += int(wc.sum(dtype=torch.int64))
    return JoinStats(total_pairs=total, cells_visited=cells,
                     candidates_checked=cands, offsets=n_off, route="dense",
                     dma_windows_issued=dma_windows)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _check_impl(distance_impl: str, metric: str) -> None:
    metric_lib.check_metric(metric)
    if distance_impl != "fused":
        raise NotImplementedError(
            f"distance_impl={distance_impl!r} is not ported yet (ROADMAP "
            f"A12); the PyTorch port has 'fused' only")


def self_join(points, eps, *, unicomp: bool = True,
              index: Optional[GridIndex] = None,
              distance_impl: str = "fused", sort_result: bool = True,
              bucketed: Optional[bool] = None,
              merge_last_dim: Optional[bool] = None, metric: str = "l2",
              device=None) -> torch.Tensor:
    """Epsilon self-join: every ordered pair (i, j), i != j, with
    ||p_i - p_j|| <= eps, as a (K, 2) int32 tensor of point ids.

    ``distance_impl`` defaults to ``"fused"``, the only implementation the
    port has (the JAX package defaults to "jnp"). The sweep is
    occupancy-bucketed (``bucketed=False`` forces one launch) over the
    merged-range stencil (``merge_last_dim=False`` sweeps per cell); every
    choice gives the same pair set. ``sort_result`` orders the pairs
    lexicographically, as the paper sorts its result.

    ``device`` is where the join runs: CUDA by default, which raises
    ``RuntimeError`` when no CUDA device is present; ``device="cpu"`` runs
    the plain PyTorch version of the kernel. The pairs come back on that
    device.
    """
    _check_impl(distance_impl, metric)
    dev = resolve_device(device)
    with record_function("self_join.grid"):
        index = _resolve_index(points, eps, index, dev)
    return _self_join_fused(index, unicomp=unicomp, sort_result=sort_result,
                            bucketed=bucketed,
                            merged=_resolve_merge(index, merge_last_dim))


def self_join_count(points, eps, *, unicomp: bool = True,
                    index: Optional[GridIndex] = None,
                    distance_impl: str = "fused",
                    query_batch: Optional[int] = None,
                    route: Optional[str] = None,
                    bucketed: Optional[bool] = None,
                    merge_last_dim: Optional[bool] = None,
                    metric: str = "l2", device=None) -> JoinStats:
    """Total ordered-pair count and work counters, without the pairs.

    Runs the ``"dense"`` route: the occupancy-bucketed fused sweep, with
    no hit plane. ``route=None`` means ``"dense"``; the JAX package's other
    routes are not ported yet (ROADMAP A11, and A6 for "dense-run").
    ``distance_impl`` defaults to ``"fused"``, the only implementation the
    port has. ``device`` as in ``self_join``.
    """
    if route is not None and route not in _ROUTES:
        raise ValueError(f"unknown route {route!r}; expected one of {_ROUTES}")
    if route not in (None, "dense"):
        item = "A6" if route == "dense-run" else "A11"
        raise NotImplementedError(
            f"route {route!r} is not ported yet (ROADMAP {item}); the "
            f"PyTorch port has 'dense' only")
    _check_impl(distance_impl, metric)
    dev = resolve_device(device)
    index = _resolve_index(points, eps, index, dev)
    return _self_join_count_fused(index, unicomp=unicomp,
                                  query_batch=query_batch, bucketed=bucketed,
                                  merged=_resolve_merge(index, merge_last_dim))


def self_join_batched(*args, **kwargs):
    """The batched, overlapped self-join of the JAX package (paper SV-A) is
    not ported yet."""
    raise NotImplementedError("self_join_batched is not ported yet "
                              "(ROADMAP A4, batched driver)")
