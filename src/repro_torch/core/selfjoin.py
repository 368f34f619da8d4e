"""The epsilon self-join (paper Alg. 1 with UNICOMP), in PyTorch.

The paper's GPU kernel is thread-per-point: each thread walks the adjacent
cells of its point and appends pairs through a global atomic. This port keeps
the JAX package's formulation, an offset sweep. ``distance_impl="fused"``
(the port's default) is a single-pass count and fill:

  1. build the epsilon-grid (``grid.build_grid``);
  2. plan: stencil offset tables, capacity buckets (``grid.occupancy_plan``)
     and per-launch window descriptors (one batched searchsorted);
  3. one fused gather-refine launch per bucket (``kernels.fused_join``): the
     hit plane, per-row counts and per-tile slot bases;
  4. emit the pairs from the hit plane, with no second distance pass
     (``kernels.emit_pairs`` on the card, one launch a fused launch).

On data with two or more points a cell the launches take the cell-run loop
(``_join_run_loop``): descriptors are gathered from per-cell tables and the
kernel reads each window once per run of rows that share a cell.
``self_join_batched`` is the paper's batching scheme (SV-A): launches are cut
to a third of the rows (by default) and each batch's pairs go to the host
while the next batch runs.

``metric="cosine"`` joins raw embeddings by minimum cosine similarity and
``metric="jaccard"`` token sets by minimum Jaccard similarity
(``core.metric``): cosine runs this L2 machinery unchanged on the unit rows,
jaccard the per-cell sweep over a 1-D size grid with the packed token words
in feature lanes and the kernel's popcount refine.

``distance_impl="jnp" | "pallas"`` is the unfused sweep, the paper's
two-phase count -> fill (``_self_join_unfused``): per stencil offset of the
per-cell stencil the (B, C, n) candidate tensor is gathered and refined, in
plain torch ("jnp") or by kernel B4 (``kernels.cell_join``, "pallas"), once
to count and once more to fill a result sized exactly. The same gather
serves the compact count route (``self_join_count_compact``) and
``per_point_neighbor_counts``.

``self_join_count`` runs every count route of the JAX package: the fused
sweeps ``"dense"``, ``"dense-run"`` and, per cell, ``"dense-flat"``; the
probe-compacted ``"sparse"`` / ``"sparse-flat"`` (``_self_join_count_sparse``);
``"compact"``; and the plain ``"jnp"``. Without a route it takes the measured
table's choice (``kernels.autotune``) or its heuristic (``_auto_route``), and
the join's sweep follows that table's "dense-flat" verdict
(``_join_sweep_merged``). B1's query tile comes from the same table.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.core import metric as metric_lib
from repro_torch.core.grid import (_NUMPY_DTYPES, CAP_ALIGN, JOIN_EVENTS,
                                   BucketPlan, GridIndex, RunPlan, _keys64,
                                   _pad_probe, _rank_to_point, build_grid,
                                   capacity_classes, cell_run_plan,
                                   cell_window_tables, check_merged_lane,
                                   filter_plan_rows, global_window_cap,
                                   host_dims, host_sync, host_to_device,
                                   index_cached, neighbor_rank,
                                   occupancy_plan, pad_key_for,
                                   point_last_coords,
                                   range_window_descriptors,
                                   range_window_descriptors_at, resolve_device,
                                   round_up, row_major_strides, trace_span,
                                   window_descriptors, window_descriptors_at)
from repro_torch.core.stencil import merged_stencil_offsets, stencil_offsets
from repro_torch.kernels import autotune, emit_pairs, ops
from repro_torch.kernels.fused_join import (TQ_DEFAULT, emit_steps,
                                            fused_window_hits, pack_words,
                                            pad_points,
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
    # Window reads of the sweep, named as in the JAX package, where each was
    # a DMA: n_off * runs over all launches with the run loop, n_off * rows
    # without; and the bytes the run loop did not read again (n_off * (rows -
    # runs) windows of c rows of the padded points). On the card they count
    # window reads from device memory, not DMAs.
    dma_windows_issued: int = 0
    dma_bytes_saved: int = 0


def _offset_tables(index: GridIndex, unicomp: bool):
    """Per-cell stencil -> (deltas (n_off,) int64, is_zero (n_off,) int32)."""
    offs = stencil_offsets(index.n_dims, unicomp)
    deltas = offs @ row_major_strides(host_dims(index))
    is_zero = np.all(offs == 0, axis=1).astype(np.int32)
    return (host_to_device(deltas, index.device),
            host_to_device(is_zero, index.device))


def _merged_offset_tables(index: GridIndex, unicomp: bool):
    """Merged-range stencil -> (dtab (3, n_off) int64, is_zero (n_off,)):
    row 0 the linearized reduced offsets, rows 1/2 their last-dimension
    lo/hi spans."""
    reduced, lo, hi = merged_stencil_offsets(index.n_dims, unicomp)
    deltas = reduced @ row_major_strides(host_dims(index))
    dtab = np.stack([deltas, lo, hi])
    is_zero = np.all(reduced == 0, axis=1).astype(np.int32)
    return (host_to_device(dtab, index.device),
            host_to_device(is_zero, index.device))


def _resolve_merge(index: GridIndex, merge_last_dim: Optional[bool]) -> bool:
    return resolve_merge_last_dim(index.n_dims, merge_last_dim)


def _resolve_index(points, eps, index: Optional[GridIndex],
                   device: torch.device) -> GridIndex:
    if index is None:
        return build_grid(points, float(eps), device=device)
    # "cuda" names the current card, and an index lies on "cuda:<n>"
    if index.device.type != device.type or device.index not in (
            None, index.device.index):
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
    q_batch = _query_slice(points_pad, q_start, qp)
    q_pos = q_start + torch.arange(qp, dtype=torch.int32, device=index.device)
    return ws, wc, wcells, q_batch, q_pos


def _query_slice(points_pad, q_start: int, qp: int):
    q_batch = points_pad[q_start:q_start + qp]
    if q_batch.shape[0] != qp:
        raise ValueError(f"points_pad has no room for rows [{q_start}, "
                         f"{q_start + qp}): its tail is too short")
    return q_batch


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


def _table_gather(index: GridIndex, tables, q_pos, ok):
    """(ws, wc, wcells) of each row, gathered from the per-cell tables at
    the row's cell rank; rows that are not ``ok`` get count-0 windows."""
    tab_ws, tab_wc, tab_wcells = tables
    npts = index.num_points
    rank = index.point_cell_rank[torch.clamp(q_pos, max=npts - 1).long()]
    rank = rank.long()
    ws = tab_ws[:, rank]
    wc = torch.where(ok[None, :], tab_wc[:, rank], 0)
    wcells = torch.where(ok[None, :], tab_wcells[:, rank], 0)
    return ws, wc, wcells


def _fused_table_prep(index: GridIndex, points_pad, tables, q_start: int, *,
                      qp: int, q_limit: int):
    """Run-mode prep of a contiguous batch: descriptors gathered from the
    per-cell tables (``grid.cell_window_tables``) instead of one
    searchsorted per row and offset. Live rows get ``_fused_prep``'s
    descriptors; dead rows keep a window start no consumer reads."""
    npts = index.num_points
    q_pos = q_start + torch.arange(qp, dtype=torch.int32, device=index.device)
    ok = (q_pos < npts) & (torch.arange(qp, device=index.device) < q_limit)
    ws, wc, wcells = _table_gather(index, tables, q_pos, ok)
    return ws, wc, wcells, _query_slice(points_pad, q_start, qp), q_pos


def _fused_table_bucket_prep(index: GridIndex, points_pad, tables, sel,
                             nsel: int, *, qp: int):
    """Run-mode prep of an occupancy bucket (see ``_fused_table_prep``);
    mirrors ``_fused_bucket_prep`` row for row."""
    q_ok = torch.arange(qp, device=index.device) < nsel
    q_pos = torch.clamp(sel, max=index.num_points - 1).to(torch.int32)
    ws, wc, wcells = _table_gather(index, tables, q_pos, q_ok)
    return ws, wc, wcells, points_pad[q_pos.long()], q_pos


def _launch_run_plan(index: GridIndex, q_pos, *, tile: int) -> RunPlan:
    """Cell-run plan of one launch, from the cell ranks of its rows'
    (clamped) sorted positions ``q_pos``, on the index's device. Padding
    rows group with whatever cell their clamped position lands in; their
    windows are count 0, so any grouping of them is inert."""
    npts = index.num_points
    rank = index.point_cell_rank[torch.clamp(q_pos, max=npts - 1).long()]
    return cell_run_plan(rank, tile)


def _fused_tile(index: GridIndex, c: int) -> int:
    """B1's query tile for launches of window capacity ``c`` on this index:
    the measured table's row for the index's device (``kernels.autotune``),
    ``TQ_DEFAULT`` without one."""
    return autotune.fused_tile(index.n_dims, c, backend=index.device.type)


def _fused_pad(index: GridIndex, *, q_size: int, c: int,
               q_start_max: int = 0, tq: int = TQ_DEFAULT,
               merged: bool = False, gid=None, feats=None):
    """One padded copy of the points for every launch of a sweep. The tail
    covers the c-slot window reads and the last batch's rounded-up query
    slice; ``feats`` (a metric's feature payload in sorted point order)
    rides right after the coordinates, merged sweeps carry the
    last-dimension cell coordinate after that, and ``gid`` (the slab join's
    global ids in sorted point order) the lane after those."""
    qp = round_up(max(q_size, 1), tq)
    tail = max(c, q_start_max + qp - index.num_points)
    if merged:
        check_merged_lane(index)
    lc = point_last_coords(index) if merged else None
    return pad_points(index.points_sorted, tail, last_coord=lc, gid=gid,
                      feats=feats), qp


def _launch_positions(index: GridIndex, launch) -> torch.Tensor:
    """(qp,) int32 sorted positions of a launch's rows on the index's
    device: ``q_start + arange`` for a contiguous batch, the bucket's
    selection padded with zeros otherwise."""
    sel, q_start, _, qp, _, _ = launch
    if sel is None:
        return q_start + torch.arange(qp, dtype=torch.int32,
                                      device=index.device)
    sel_pad = np.zeros(qp, np.int32)
    sel_pad[:sel.shape[0]] = sel
    return host_to_device(sel_pad, index.device)


def _launch_prep(index: GridIndex, points_pad, deltas, launch, *,
                 merged: bool, tables=None):
    """Descriptors and query rows of one launch (either kind); ``tables``
    (``grid.cell_window_tables``) gathers the descriptors per cell."""
    sel, q_start, q_size, qp, _, _ = launch
    if sel is None:
        if tables is not None:
            return _fused_table_prep(index, points_pad, tables, q_start,
                                     qp=qp, q_limit=max(q_size, 1))
        return _fused_prep(index, points_pad, deltas, q_start, qp=qp,
                           q_limit=max(q_size, 1), merged=merged)
    sel_dev = _launch_positions(index, launch)
    if tables is not None:
        return _fused_table_bucket_prep(index, points_pad, tables, sel_dev,
                                        sel.shape[0], qp=qp)
    return _fused_bucket_prep(index, points_pad, deltas, sel_dev,
                              sel.shape[0], qp=qp, merged=merged)


def _fused_launch(index: GridIndex, points_pad, deltas, is_zero, launch, *,
                  unicomp: bool, keep_hits: bool, merged: bool,
                  run_loop: bool = False, metric: str = "l2",
                  n_feat: int = 0, refine_eps=None, gid_pairs: bool = False,
                  words=None):
    """One launch through the fused kernel at its capacity (the JAX
    package's ``_fused_batch_run`` and ``_fused_bucket_launch``). With
    ``run_loop`` the descriptors come from the per-cell tables and the
    kernel reads one window per cell run; the run plan is returned too
    (None without). ``metric`` / ``n_feat`` pick the refine predicate;
    ``refine_eps`` is the scalar it compares against when the index's cell
    width is not it (jaccard prunes on set sizes at ``eps_geom`` and refines
    against the threshold t; ``words``, jaccard's ``_sweep_words``, is the
    kernel's packed copy of the candidates' words). ``gid_pairs``: the
    masks compare the global ids of ``points_pad``'s id lane (B1 (d))."""
    _, _, _, _, c, tile = launch
    plan = None
    with trace_span("self_join.plan"):
        with trace_span("self_join.plan.launch"):
            tables = (cell_window_tables(index, deltas, merged=merged,
                                         tag=unicomp) if run_loop else None)
            ws, wc, wcells, q_batch, q_pos = _launch_prep(
                index, points_pad, deltas, launch, merged=merged,
                tables=tables)
        if run_loop:
            with trace_span("self_join.plan.run_plan"):
                plan = _launch_run_plan(index, q_pos, tile=tile)
    with trace_span("self_join.kernel"):
        hits, counts, base = ops.fused_join_hits(
            points_pad, q_batch, ws, wc, is_zero, q_pos,
            index.eps if refine_eps is None else refine_eps, c=c,
            n_real=index.n_dims, unicomp=unicomp, merged=merged,
            gid_pairs=gid_pairs, tq=tile, keep_hits=keep_hits,
            run_ord=None if plan is None else plan.run_ord,
            run_loop=run_loop, metric=metric, n_feat=n_feat, words=words)
    return ws, wc, wcells, hits, counts, base, q_pos, plan


def _sweep_words(points_pad, index: GridIndex, metric: str, n_feat: int):
    """Jaccard's 32-bit packed words of ``points_pad`` (B1 (e) reads its
    candidates' words there), made once a sweep; None for other metrics."""
    if metric != "jaccard":
        return None
    return pack_words(points_pad, index.n_dims, n_feat)


def _fused_launches(index: GridIndex, *, n_batches: int = 1,
                    bucketed: Optional[bool] = None, merged: bool = False,
                    row_ok: Optional[np.ndarray] = None, gid=None,
                    feats=None):
    """The launch schedule of one fused sweep: one launch per occupancy
    bucket, or contiguous batches when the plan has a single class; either
    is cut to ``ceil(npts / n_batches)`` rows a launch (``n_batches``
    clamped to [1, npts]). Returns (launches, points_pad, c_global), each
    launch (sel | None, q_start, q_size, qp, c, tile); ``gid`` and
    ``feats`` ride the padded points (``_fused_pad``). ``row_ok`` (the
    slab join: the rows its slab owns, a host bool mask over sorted
    positions) keeps only those rows as queries, every launch then an
    explicit selection (``grid.filter_plan_rows``)."""
    npts = index.num_points
    c_glob = global_window_cap(index, merged)
    n_batches = max(min(int(n_batches), max(npts, 1)), 1)
    batch_rows = -(-max(npts, 1) // n_batches)  # ceil
    if bucketed is None:
        bucketed = True
    plan = occupancy_plan(index, merged=merged) if bucketed else None
    if row_ok is not None:
        if plan is None:
            plan = BucketPlan(caps=(c_glob,), sel=(None,), cap_global=c_glob,
                              hist={c_glob: npts})
        plan = filter_plan_rows(plan, row_ok)
    if plan is None or plan.sel[0] is None:
        cap = c_glob if plan is None else plan.caps[0]
        tile = _fused_tile(index, cap)
        points_pad, qp = _fused_pad(
            index, q_size=batch_rows, c=c_glob, tq=tile,
            q_start_max=(n_batches - 1) * batch_rows, merged=merged,
            gid=gid, feats=feats)
        launches = [(None, b * batch_rows,
                     min(batch_rows, npts - b * batch_rows), qp, cap, tile)
                    for b in range(n_batches)]
        return launches, points_pad, c_glob
    points_pad, _ = _fused_pad(index, q_size=1, c=c_glob, merged=merged,
                               gid=gid, feats=feats)
    launches = []
    for cap, sel in zip(plan.caps, plan.sel):
        tile = _fused_tile(index, cap)
        for i in range(0, sel.shape[0], batch_rows):
            piece = sel[i:i + batch_rows]
            launches.append((piece, 0, piece.shape[0],
                             round_up(piece.shape[0], tile), cap, tile))
    return launches, points_pad, c_glob


def _join_run_loop(index: GridIndex) -> bool:
    """The run loop pays when cells hold two or more points on average;
    below that runs are single rows and the run bookkeeping is overhead.
    The pair set is the row loop's either way."""
    with host_sync():
        ncells = int(index.num_cells)
    return index.num_points >= 2 * max(ncells, 1)


# ---------------------------------------------------------------------------
# Emit: pairs from the count pass's hit plane, no distances.
# ---------------------------------------------------------------------------

def _emit_from_hits(index: GridIndex, ids, hits, counts, slot_base,
                    win_start, q_pos, *, c: int, tq: int, unicomp: bool,
                    capacity: int):
    """The emit's plain version: scatter pairs to the slots the kernel's
    per-tile scan (``slot_base``) assigned, offset by the scan of the tile
    totals, in the steps of ``fused_join.emit_steps``. Rows are query-major
    (per query: offsets in sweep order, slots in window order). Returns
    (keys, vals) with ``capacity`` slots each. ``_emit_chunk`` runs it for
    CPU tensors; on the card ``kernels.emit_pairs`` is held to it."""
    npts = index.num_points
    dev = hits.device
    q_pos_c = torch.clamp(q_pos, max=npts - 1).long()
    # non-hits write the spare slot ``capacity``, which is cut off
    keys = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    vals = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)

    def put(idx, k, v):
        keys.scatter_(0, idx.reshape(-1), k.reshape(-1))
        vals.scatter_(0, idx.reshape(-1), v.reshape(-1))

    for a, b, h, cand, pos in emit_steps(hits, counts, slot_base, win_start,
                                         c=c, tq=tq, npts=npts):
        qid = ids[q_pos_c[a:b]][:, None].expand(h.shape)
        cid = ids[cand]
        if unicomp:
            # every hit is an unordered pair -> two ordered result rows
            put(torch.where(h, 2 * pos, capacity), qid, cid)
            put(torch.where(h, 2 * pos + 1, capacity), cid, qid)
        else:
            put(torch.where(h, pos, capacity), qid, cid)
    return keys[:capacity], vals[:capacity]


def _emit_chunk(index: GridIndex, ids, hits, counts, slot_base, win_start,
                q_pos, *, c: int, tq: int, unicomp: bool,
                found: int) -> torch.Tensor:
    """One launch's ((2 if unicomp else 1) * found, 2) int32 pairs, in
    ``_emit_from_hits``' order: the kernel ``emit_pairs`` on CUDA tensors,
    the plain version stacked on CPU tensors."""
    if hits.is_cuda:
        return emit_pairs.emit_pairs(hits, counts, slot_base, win_start,
                                     q_pos, ids, tq=tq,
                                     npts=index.num_points, n_hits=found,
                                     unicomp=unicomp)
    ordered = (2 if unicomp else 1) * found
    keys, vals = _emit_from_hits(index, ids, hits, counts, slot_base,
                                 win_start, q_pos, c=c, tq=tq,
                                 unicomp=unicomp, capacity=max(ordered, 1))
    return torch.stack([keys[:ordered], vals[:ordered]], dim=1)


def sort_pairs(pairs: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Pairs in lexicographic (first, second) order; ids lie in [0, n_ids)."""
    key = pairs[:, 0].long() * n_ids + pairs[:, 1].long()
    return pairs[torch.argsort(key)]


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

class _HostCopies:
    """Device-to-host copies of each batch's pairs on a side stream, so a
    copy overlaps the launches queued after it (the paper's SV-A overlap).
    On the CPU the chunks are kept as they are."""

    def __init__(self, device: torch.device):
        self.chunks = []
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def put(self, chunk: torch.Tensor) -> None:
        if self.stream is None:
            self.chunks.append(chunk)
            return
        host = torch.empty(chunk.shape, dtype=chunk.dtype, pin_memory=True)
        self.stream.wait_stream(torch.cuda.current_stream(chunk.device))
        with torch.cuda.stream(self.stream):
            host.copy_(chunk, non_blocking=True)
        # the allocator must not hand the chunk's memory to the main stream
        # before the copy has read it
        chunk.record_stream(self.stream)
        self.chunks.append(host)

    def result(self) -> torch.Tensor:
        if self.stream is not None:
            self.stream.synchronize()
        if not self.chunks:
            return torch.empty((0, 2), dtype=torch.int32)
        return torch.cat(self.chunks, dim=0)


def _self_join_fused(index: GridIndex, *, unicomp: bool, sort_result: bool,
                     n_batches: int = 1, bucketed: Optional[bool] = None,
                     merged: bool = True, run_loop: Optional[bool] = None,
                     to_host: bool = False, metric: str = "l2",
                     n_feat: int = 0, feats=None, refine_eps=None,
                     row_ok: Optional[np.ndarray] = None, ids=None,
                     gid_pairs: bool = False) -> torch.Tensor:
    """Single-pass count -> fill driver for ``distance_impl="fused"``.

    Each launch's kernel returns its hit plane and counts; the result size
    follows from the counts and the fill only compacts the same plane, on
    the index's device (``_emit_chunk``). Every bucketing, batching, sweep
    and loop choice gives the same pair set. ``run_loop=None`` takes the
    cell-run loop when ``_join_run_loop`` says so. ``n_batches`` cuts every
    launch to that share of the rows; ``to_host`` copies each launch's
    pairs to the host while the next launch runs and returns a CPU tensor,
    so the device holds one batch's result at a time.

    ``metric`` / ``n_feat`` / ``feats`` / ``refine_eps``: the refine
    predicate, its feature payload in sorted point order, and the kernel
    scalar where it is not the index's cell width (``_fused_launch``). The
    emit reads only hits and descriptors, whatever the metric.

    The slab join (``core.distributed``) runs this driver per slab with
    ``row_ok`` (the sorted rows the slab owns, the only queries), ``ids``
    (sorted position -> global point id, on the index's device, emitted in
    place of ``index.order``) and ``gid_pairs`` (the ids ride a pad lane
    and the kernel's masks compare them, B1 (d)); it owns a row of every
    slab it joins, and sorts all slabs' pairs itself (``sort_result``
    False). The one-process join is ``row_ok=None, ids=None,
    gid_pairs=False``.

    The stages run inside ``torch.profiler.record_function`` spans
    (``self_join.plan``, ``.kernel``, ``.emit``; ``grid.trace_span`` opens
    them while a profiler records) that a profiler groups its time by;
    inside them ``self_join.plan.tables`` (the sweep's tables,
    launches and padded points), each launch's ``self_join.plan.launch``
    (its descriptors) and ``self_join.plan.run_plan``, and
    ``self_join.emit.sort``; ``host_sync`` spans mark where the host waits
    for the device. The emit counts its slots and hits in
    ``grid.JOIN_EVENTS``.
    """
    if run_loop is None:
        run_loop = _join_run_loop(index)
    with trace_span("self_join.plan"), \
            trace_span("self_join.plan.tables"):
        if merged:
            deltas, is_zero = _merged_offset_tables(index, unicomp)
        else:
            deltas, is_zero = _offset_tables(index, unicomp)
        ids_dev = index.order if ids is None else ids
        launches, points_pad, _ = _fused_launches(
            index, n_batches=n_batches, bucketed=bucketed, merged=merged,
            row_ok=row_ok, gid=ids_dev if gid_pairs else None, feats=feats)
        words = _sweep_words(points_pad, index, metric, n_feat)
    host = _HostCopies(index.device) if to_host else None

    def finish(run):
        """Drain one launch; the next launch is already queued."""
        ws, hits, counts, base, q_pos, cap, tile = run
        with trace_span("self_join.emit"):
            with host_sync():
                found = int(counts.sum(dtype=torch.int64))
            JOIN_EVENTS["emit_hits"] += found
            JOIN_EVENTS["emit_slots"] += hits.numel()
            chunk = _emit_chunk(index, ids_dev, hits, counts, base, ws,
                                q_pos, c=cap, tq=tile, unicomp=unicomp,
                                found=found)
            if host is None:
                chunks.append(chunk)
            else:
                host.put(chunk)

    chunks = []
    prev = None
    for launch in launches:
        ws, _, _, hits, counts, base, q_pos, _ = _fused_launch(
            index, points_pad, deltas, is_zero, launch, unicomp=unicomp,
            keep_hits=True, merged=merged, run_loop=run_loop, metric=metric,
            n_feat=n_feat, refine_eps=refine_eps, gid_pairs=gid_pairs,
            words=words)
        if prev is not None:
            finish(prev)
        prev = (ws, hits, counts, base, q_pos, launch[4], launch[5])
    finish(prev)
    sanitize.raise_pending()   # REPRO_TORCH_SANITIZE: launches drained
    with trace_span("self_join.emit"):
        out = host.result() if host is not None else torch.cat(chunks, dim=0)
        if sort_result:
            with trace_span("self_join.emit.sort"):
                out = sort_pairs(out, index.num_points)
    return out


def _self_join_count_fused(index: GridIndex, *, unicomp: bool,
                           query_batch: Optional[int] = None,
                           bucketed: Optional[bool] = None,
                           merged: bool = True,
                           run_loop: bool = False, metric: str = "l2",
                           n_feat: int = 0, feats=None, refine_eps=None,
                           row_ok: Optional[np.ndarray] = None, ids=None,
                           gid_pairs: bool = False) -> JoinStats:
    """Count-only fused sweep (no hit plane). Occupancy-bucketed by
    default; an explicit ``query_batch`` runs contiguous batches at the
    global capacity (the paper's SV-A memory bound). Merged and per-cell
    sweeps report the same totals, cells and candidates. ``run_loop`` (the
    ``"dense-run"`` route) reads windows once per cell run: the same totals
    and counters, with the window reads it issued and saved. The metric
    and slab arguments (``row_ok``, ``ids``, ``gid_pairs``) are
    ``_self_join_fused``'s; ``row_ok`` applies to the bucketed schedule,
    not to an explicit ``query_batch``."""
    if merged:
        deltas, is_zero = _merged_offset_tables(index, unicomp)
    else:
        deltas, is_zero = _offset_tables(index, unicomp)
    n_off = int(is_zero.shape[0])
    npts = index.num_points
    mult = 2 if unicomp else 1
    gid = ids if gid_pairs else None
    if query_batch:
        c = global_window_cap(index, merged)
        tile = _fused_tile(index, c)
        q_size = int(query_batch)
        points_pad, qp = _fused_pad(
            index, q_size=q_size, c=c, tq=tile,
            q_start_max=((npts - 1) // q_size) * q_size, merged=merged,
            gid=gid, feats=feats)
        launches = [(None, q_start, min(q_size, npts - q_start), qp, c, tile)
                    for q_start in range(0, npts, q_size)]
    else:
        launches, points_pad, _ = _fused_launches(
            index, bucketed=bucketed, merged=merged, row_ok=row_ok, gid=gid,
            feats=feats)
    words = _sweep_words(points_pad, index, metric, n_feat)
    row_bytes = points_pad.shape[1] * points_pad.element_size()
    total = cells = cands = dma_windows = dma_saved = 0
    for launch in launches:
        _, wc, wcells, _, counts, _, _, plan = _fused_launch(
            index, points_pad, deltas, is_zero, launch, unicomp=unicomp,
            keep_hits=False, merged=merged, run_loop=run_loop, metric=metric,
            n_feat=n_feat, refine_eps=refine_eps, gid_pairs=gid_pairs,
            words=words)
        qp, cap = launch[3], launch[4]
        if plan is None:
            dma_windows += n_off * qp
        else:
            runs = plan.n_runs
            dma_windows += n_off * runs
            dma_saved += n_off * (qp - runs) * cap * row_bytes
        total += mult * int(counts.sum(dtype=torch.int64))
        cells += int(wcells.sum(dtype=torch.int64))
        cands += int(wc.sum(dtype=torch.int64))
    sanitize.raise_pending()   # REPRO_TORCH_SANITIZE: counts drained
    return JoinStats(total_pairs=total, cells_visited=cells,
                     candidates_checked=cands, offsets=n_off,
                     route="dense-run" if run_loop else "dense",
                     dma_windows_issued=dma_windows, dma_bytes_saved=dma_saved)


def dma_window_stats(index: GridIndex, *, unicomp: bool = True,
                     merged: bool = True,
                     bucketed: Optional[bool] = None) -> dict:
    """Window-read accounting of one fused sweep's schedule, without running
    a kernel: the windows a row loop reads (``n_off * rows``), those the
    run loop reads (``n_off * runs``), the bytes the run loop saves, the
    run-length histogram and the mean cell occupancy the reduction should
    track. The keys are the JAX package's (``dma_*``); on the card they
    count window reads from device memory."""
    if merged:
        deltas, _ = _merged_offset_tables(index, unicomp)
    else:
        deltas, _ = _offset_tables(index, unicomp)
    n_off = int(deltas.shape[-1])
    launches, points_pad, _ = _fused_launches(index, bucketed=bucketed,
                                              merged=merged)
    row_bytes = points_pad.shape[1] * points_pad.element_size()
    rows = runs = saved = 0
    hist: dict = {}
    for launch in launches:
        _, _, _, qp, cap, tile = launch
        plan = _launch_run_plan(index, _launch_positions(index, launch),
                                tile=tile)
        n_runs = plan.n_runs
        rows += n_off * qp
        runs += n_off * n_runs
        saved += n_off * (qp - n_runs) * cap * row_bytes
        lens, cnts = torch.unique(plan.run_lengths, return_counts=True)
        for ln, cnt in zip(lens.tolist(), cnts.tolist()):
            hist[ln] = hist.get(ln, 0) + cnt
    return {
        "offsets": n_off,
        "dma_windows_row": int(rows),
        "dma_windows_run": int(runs),
        "dma_bytes_saved": int(saved),
        "reduction_factor": rows / max(runs, 1),
        "mean_cell_occupancy": (index.num_points
                                / max(int(index.num_cells), 1)),
        "run_length_hist": {str(k): v for k, v in sorted(hist.items())},
    }


# ---------------------------------------------------------------------------
# Unfused sweep (distance_impl "jnp" / "pallas"), the paper's two-phase
# count -> fill: per stencil offset (a Python loop, JAX's lax.scan), gather
# the (B, C, n) candidate tensor of the per-cell sweep and refine it. The fill
# evaluates every distance a second time.
# ---------------------------------------------------------------------------

def _unfused_cap(index: GridIndex) -> int:
    """Window slots a row of the unfused sweep: max_per_cell rounded to 8."""
    return round_up(max(int(index.max_per_cell), 1), 8)


def _neighbor_ranks_for_delta(index: GridIndex, delta) -> torch.Tensor:
    """Rank in B of (cell + delta) for every slot of B; -1 where absent.
    Padding slots probe the miss sentinel and resolve to padding slots,
    whose cell_count is 0."""
    valid = torch.arange(index.num_points, device=index.device) \
        < index.num_cells
    base = torch.where(valid, _keys64(index), 0)
    qk = _pad_probe(base + delta, valid, _NUMPY_DTYPES[index.cell_keys.dtype])
    return neighbor_rank(index, qk)


def _distance_hits_jnp(q, cand, valid, eps):
    """Plain candidate refine: (B, n) x (B, C, n) -> (B, C) bool hits, d^2
    summed lane by lane in lane order as the JAX package's ``jnp.sum``
    sums it (``metric.lane_d2_sum``), as kernel B4 sums it, so "jnp" and
    "pallas" give the same pairs bit for bit."""
    d2 = metric_lib.lane_d2_sum(q, lambda k: cand[:, :, k], q.shape[1])
    return metric_lib.l2_sq_hits(d2, eps) & valid


def _get_distance_impl(name: str):
    if name == "jnp":
        return _distance_hits_jnp
    if name == "pallas":
        return ops.cell_join_hits
    raise ValueError(f"unknown distance_impl {name!r}")


def _gather_rows(points: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``points[pos]`` with a trailing lane axis, gathered lane by lane:
    torch's row gather of such narrow rows (16 bytes at n = 2 in f64) ran
    about 10x slower than one gather per lane on an H100."""
    idx = pos.long()
    return torch.stack([points[:, k][idx] for k in range(points.shape[1])],
                       dim=-1)


def _gather_batch(index: GridIndex, nbr_rank_cells, q_start: int,
                  q_size: int, max_per_cell: int):
    """Candidate window of each query row of a batch under one offset.

    Returns (q (q_size, n), cand (q_size, C, n), cand_pos (q_size, C) int32,
    valid (q_size, C) bool, q_pos (q_size,) int32, visited (q_size,) bool):
    sorted positions clamped to the points, and whether a real row's
    neighbour cell exists."""
    npts = index.num_points
    dev = index.device
    q_pos = q_start + torch.arange(q_size, dtype=torch.int32, device=dev)
    q_ok = q_pos < npts
    q_pos_c = torch.clamp(q_pos, max=npts - 1)
    q = _gather_rows(index.points_sorted, q_pos_c)
    nbr = nbr_rank_cells[index.point_cell_rank[q_pos_c.long()].long()]
    nbr_c = torch.clamp(nbr, min=0).long()
    start = index.cell_start[nbr_c]
    count = torch.where(nbr >= 0, index.cell_count[nbr_c], 0)
    slots = torch.arange(max_per_cell, dtype=torch.int32, device=dev)
    valid = (slots[None, :] < count[:, None]) & q_ok[:, None]
    cand_pos = torch.clamp(start[:, None] + slots[None, :], max=npts - 1)
    cand = _gather_rows(index.points_sorted, cand_pos)
    return q, cand, cand_pos, valid, q_pos_c, (nbr >= 0) & q_ok


def _sweep_hits(index: GridIndex, delta, zero, q_start: int, *, q_size: int,
                max_per_cell: int, unicomp: bool, hits_fn):
    """One offset of the unfused sweep: masked hits (UNICOMP triangle on
    the zero offset, else the self pair), with the gather's outputs."""
    with trace_span("self_join.plan"):
        nbr_cells = _neighbor_ranks_for_delta(index, delta)
        q, cand, cand_pos, valid, q_pos, visited = _gather_batch(
            index, nbr_cells, q_start, q_size, max_per_cell)
    with trace_span("self_join.kernel"):
        hits = hits_fn(q, cand, valid, index.eps)
        if unicomp:
            hits = hits & ((cand_pos > q_pos[:, None]) | (zero == 0))
        else:
            hits = hits & (cand_pos != q_pos[:, None])
    return hits, cand_pos, valid, q_pos, visited


def _count_batch(index: GridIndex, deltas, is_zero, q_start: int, *,
                 q_size: int, max_per_cell: int, unicomp: bool, hits_fn):
    """Count phase of one query batch: (ordered pairs, cells visited,
    candidate slots) as int64 tensors on the index's device."""
    total, cells, cands = (torch.zeros((), dtype=torch.int64,
                                       device=index.device)
                           for _ in range(3))
    for o in range(deltas.shape[0]):
        hits, _, valid, _, visited = _sweep_hits(
            index, deltas[o], is_zero[o], q_start, q_size=q_size,
            max_per_cell=max_per_cell, unicomp=unicomp, hits_fn=hits_fn)
        # UNICOMP: every hit is an unordered pair, two ordered ones
        total += (2 if unicomp else 1) * hits.sum(dtype=torch.int64)
        cells += visited.sum(dtype=torch.int64)
        cands += valid.sum(dtype=torch.int64)
    return total, cells, cands


def _fill_batch(index: GridIndex, deltas, is_zero, q_start: int, *,
                q_size: int, max_per_cell: int, unicomp: bool,
                capacity: int, hits_fn):
    """Fill phase of one query batch: ordered pairs of original point ids,
    offset-major, then row-major over (query row, slot); under UNICOMP each
    hit writes (q, c) at 2 * rank and (c, q) at 2 * rank + 1. Each hit's
    slot is a cursor plus its rank (a global int64 cumsum), and misses and
    overflow write the spare slot ``capacity``, which is cut off (JAX's
    ``mode="drop"``). Returns (keys, vals, count) with ``capacity`` slots."""
    dev = index.device
    keys = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    vals = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    cursor = torch.zeros((), dtype=torch.int64, device=dev)
    mult = 2 if unicomp else 1

    def put(pos, flat, k, v):
        idx = torch.clamp(torch.where(flat, pos, capacity), max=capacity)
        keys.scatter_(0, idx, k)
        vals.scatter_(0, idx, v)

    for o in range(deltas.shape[0]):
        hits, cand_pos, _, q_pos, _ = _sweep_hits(
            index, deltas[o], is_zero[o], q_start, q_size=q_size,
            max_per_cell=max_per_cell, unicomp=unicomp, hits_fn=hits_fn)
        with trace_span("self_join.emit"):
            flat = hits.reshape(-1)
            rel = torch.cumsum(flat, 0, dtype=torch.int64) - 1
            qid = index.order[q_pos.long()][:, None].expand(hits.shape)
            qid = qid.reshape(-1)
            cid = index.order[cand_pos.long()].reshape(-1)
            pos = cursor + mult * rel
            put(pos, flat, qid, cid)
            if unicomp:
                put(pos + 1, flat, cid, qid)
            cursor = cursor + mult * flat.sum(dtype=torch.int64)
    return keys[:capacity], vals[:capacity], cursor


def _self_join_unfused(index: GridIndex, *, unicomp: bool, sort_result: bool,
                       distance_impl: str, n_batches: int = 1,
                       to_host: bool = False) -> torch.Tensor:
    """Two-phase driver of the unfused sweep (``distance_impl`` "jnp" or
    "pallas"): exact counts of every query batch, then each batch's fill
    into exactly that many slots, then a check that fill and count agree.
    ``n_batches`` (clamped to [1, npts]) cuts the rows into batches of
    ``ceil(npts / n_batches)``; ``to_host`` copies each batch's pairs to
    the host while the next batch runs (``_HostCopies``) and returns a CPU
    tensor."""
    hits_fn = _get_distance_impl(distance_impl)
    npts = index.num_points
    n_batches = max(min(int(n_batches), max(npts, 1)), 1)
    q_size = -(-max(npts, 1) // n_batches)
    with trace_span("self_join.plan"):
        deltas, is_zero = _offset_tables(index, unicomp)
    kw = dict(q_size=q_size, max_per_cell=_unfused_cap(index),
              unicomp=unicomp, hits_fn=hits_fn)
    counts = [_count_batch(index, deltas, is_zero, b * q_size, **kw)[0]
              for b in range(n_batches)]
    counts = torch.stack(counts).tolist()       # one host sync
    host = _HostCopies(index.device) if to_host else None
    chunks, filled = [], []
    for b, want in enumerate(counts):
        keys, vals, got = _fill_batch(index, deltas, is_zero, b * q_size,
                                      capacity=max(want, 1), **kw)
        filled.append(got)
        with trace_span("self_join.emit"):
            chunk = torch.stack([keys[:want], vals[:want]], dim=1)
            if host is None:
                chunks.append(chunk)
            else:
                host.put(chunk)
    filled = torch.stack(filled).tolist()
    if filled != counts:
        raise RuntimeError(f"the unfused fill wrote {filled} pairs a batch, "
                           f"the count found {counts}")
    with trace_span("self_join.emit"):
        out = host.result() if host is not None else torch.cat(chunks, dim=0)
        if sort_result:     # the paper sorts the key/value result
            with trace_span("self_join.emit.sort"):
                out = sort_pairs(out, max(npts, 1))
    return out


def _self_join_count_unfused(index: GridIndex, *, unicomp: bool,
                             distance_impl: str,
                             query_batch: Optional[int] = None,
                             route: str = "dense") -> JoinStats:
    """Count-only unfused sweep over contiguous batches of ``query_batch``
    rows (all rows by default), labelled ``route``."""
    hits_fn = _get_distance_impl(distance_impl)
    npts = index.num_points
    deltas, is_zero = _offset_tables(index, unicomp)
    q_size = int(query_batch) if query_batch else npts
    sums = torch.zeros(3, dtype=torch.int64, device=index.device)
    for q_start in range(0, npts, q_size):
        sums += torch.stack(_count_batch(
            index, deltas, is_zero, q_start, q_size=q_size,
            max_per_cell=_unfused_cap(index), unicomp=unicomp,
            hits_fn=hits_fn))
    total, cells, cands = sums.tolist()
    return JoinStats(total_pairs=total, cells_visited=cells,
                     candidates_checked=cands, offsets=int(deltas.shape[0]),
                     route=route)


# ---------------------------------------------------------------------------
# Compact count route: per non-zero offset, the rows whose neighbour cell
# exists are packed into ``cap_q`` rows before the gather, so the gather's
# traffic follows the live candidates; the zero offset runs dense.
# ---------------------------------------------------------------------------

def compact_cap(index: GridIndex, unicomp: bool) -> int:
    """Exact max live-query count over the non-zero offsets (host numpy)."""
    ncells = int(index.num_cells)
    keys = index.cell_keys[:ncells].cpu().numpy().astype(np.int64)
    counts = index.cell_count[:ncells].cpu().numpy().astype(np.int64)
    deltas = _offset_tables(index, unicomp)[0][1:].cpu().numpy()  # o != 0
    cap = 1
    for delta in deltas:
        pos = np.minimum(np.searchsorted(keys, keys + delta), ncells - 1)
        live = keys[pos] == keys + delta
        cap = max(cap, int(counts[live].sum()))
    return cap


def _count_compact(index: GridIndex, deltas, *, cap_q: int,
                   max_per_cell: int, unicomp: bool, distance_impl: str):
    """Compacted sweep over the non-zero offsets ``deltas``: per offset the
    live rows first (a stable sort of ~live), cut to ``cap_q`` rows, each
    against its neighbour cell's window. Returns (ordered pairs, candidate
    slots) as int64 tensors. ``"fused"`` refines by column gathers
    (``fused_window_hits``), without the (B, C, n) candidate tensor."""
    fused = distance_impl == "fused"
    hits_fn = None if fused else _get_distance_impl(distance_impl)
    npts = index.num_points
    dev = index.device
    rank = index.point_cell_rank.long()
    sl = torch.arange(max_per_cell, dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.zeros((), dtype=torch.int64, device=dev)
    for o in range(deltas.shape[0]):
        nbr_all = _neighbor_ranks_for_delta(index, deltas[o])[rank]
        live = nbr_all >= 0
        packed = torch.argsort((~live).to(torch.uint8), stable=True)[:cap_q]
        nbr = nbr_all[packed]
        nbr_c = torch.clamp(nbr, min=0).long()
        count = torch.where(live[packed], index.cell_count[nbr_c], 0)
        cand_pos = torch.clamp(index.cell_start[nbr_c][:, None] + sl[None, :],
                               max=npts - 1)
        valid = sl[None, :] < count[:, None]
        q = _gather_rows(index.points_sorted, packed)
        if fused:
            hits = fused_window_hits(index.points_sorted, q, cand_pos, valid,
                                     index.eps)
        else:
            hits = hits_fn(q, _gather_rows(index.points_sorted, cand_pos),
                           valid, index.eps)
        if unicomp:
            total += 2 * hits.sum(dtype=torch.int64)
        else:
            hits = hits & (cand_pos != packed[:, None])
            total += hits.sum(dtype=torch.int64)
        slots += valid.sum(dtype=torch.int64)
    return total, slots


def self_join_count_compact(points, eps, *, unicomp: bool = True,
                            index: Optional[GridIndex] = None,
                            distance_impl: str = "fused",
                            device=None) -> JoinStats:
    """``self_join_count`` with empty-neighbour compaction (the JAX
    package's ``route="compact"``): the zero offset counts dense, through
    kernel B1 for ``"fused"`` (per-cell sweep, one launch at the rounded
    max_per_cell, no hit plane) or the unfused sweep otherwise; every other
    offset packs its live rows first (``_count_compact``). Same total as
    the dense routes; ``cells_visited`` is 0 and ``candidates_checked``
    counts the slots the compacted sweep read. ``device`` as in
    ``self_join``."""
    _check_impl(distance_impl)
    index = _resolve_index(points, eps, index, resolve_device(device))
    npts = index.num_points
    cap = _unfused_cap(index)
    deltas, is_zero = _offset_tables(index, unicomp)
    cap_q = round_up(compact_cap(index, unicomp), 128)
    if distance_impl == "fused":
        tile = _fused_tile(index, cap)
        points_pad, qp = _fused_pad(index, q_size=npts, c=cap, tq=tile)
        _, wc0, _, _, counts0, _, _, _ = _fused_launch(
            index, points_pad, deltas[:1], is_zero[:1],
            (None, 0, npts, qp, cap, tile), unicomp=unicomp,
            keep_hits=False, merged=False)
        t0 = (2 if unicomp else 1) * counts0.sum(dtype=torch.int64)
        k0 = wc0.sum(dtype=torch.int64)
    else:
        t0, _, k0 = _count_batch(
            index, deltas[:1], is_zero[:1], 0, q_size=npts, max_per_cell=cap,
            unicomp=unicomp, hits_fn=_get_distance_impl(distance_impl))
    tn, slots = _count_compact(index, deltas[1:], cap_q=min(cap_q, npts),
                               max_per_cell=cap, unicomp=unicomp,
                               distance_impl=distance_impl)
    # REPRO_TORCH_SANITIZE: the zero offset's launch is drained; the JAX
    # package leaves its code queued (ROADMAP §C, C6)
    sanitize.raise_pending()
    return JoinStats(total_pairs=int(t0 + tn), cells_visited=0,
                     candidates_checked=int(k0 + slots),
                     offsets=int(deltas.shape[0]), route="compact")


# ---------------------------------------------------------------------------
# Sparse count routes ("sparse", "sparse-flat"): the probe-compacted counter
# for the empty-neighbour regime. The (offset, query) probe plane is reduced
# to a bare rank plane (a gather from a dense key -> rank table when the key
# space is small, else one batched searchsorted), its live probes are
# compacted once (``torch.nonzero``, one host sync), and distances run only
# over the packed live probes, so the refine follows the candidate volume.
# The work counters are the dense sweep's (same probe plane). Plain torch on
# the index's device: the JAX package's counter is jnp, with no kernel.
# ---------------------------------------------------------------------------

# Dense-lookup budget: prod(dims) at or below this many cells (4 bytes each)
# takes the table; beyond it, binary search.
_LOOKUP_MAX_CELLS = 1 << 23
# Packed probes a refine step: bounds the (P, C) temporaries.
_PROBE_CHUNK = 1 << 17


def _plane_rows(rank_arr, qp: int):
    """(q_pos (qp,), clamped cell rank of each row) over ``qp`` rows; rows
    at or past the points are padding."""
    npts = rank_arr.shape[0]
    q_pos = torch.arange(qp, device=rank_arr.device)
    return q_pos, rank_arr[torch.clamp(q_pos, max=npts - 1)].long()


def _rank_plane_search(keys, rank_arr, deltas, *, qp: int):
    """(n_off, qp) int32 rank in B of every (offset, query) probe, -1 for a
    miss, by one batched searchsorted over ``keys`` (B in the probes'
    dtype)."""
    npts = keys.shape[0]
    q_pos, rank = _plane_rows(rank_arr, qp)
    qk = keys[rank][None, :] + deltas[:, None]
    pos = torch.clamp(torch.searchsorted(keys, qk), max=npts - 1)
    hit = (keys[pos] == qk) & (q_pos < npts)[None, :]
    return torch.where(hit, pos.to(torch.int32), -1)


def _rank_plane_table(table, cell_keys, rank_arr, deltas32, *, qp: int):
    """The rank plane by a gather from the dense key -> rank ``table``
    (int32; padding rows probe far below the key space)."""
    vol = table.shape[0]
    q_pos, rank = _plane_rows(rank_arr, qp)
    own = cell_keys[rank].to(torch.int32)
    own = torch.where(q_pos < rank_arr.shape[0], own, -(1 << 30))
    qk = own[None, :] + deltas32[:, None]
    ok = (qk >= 0) & (qk < vol)
    return torch.where(ok, table[torch.clamp(qk, 0, vol - 1).long()], -1)


def _range_plane_search(keys, rank_arr, deltas, lo_off, hi_off,
                        dim_last: int, *, qp: int):
    """(lo_rank, hi_rank), each (n_off, qp) int32: the merged-range rank
    span of every probe by one searchsorted pair; a probe is live iff
    hi_rank > lo_rank. The last-dimension span clamps at the grid row as
    ``grid.range_window_descriptors_at`` clamps it."""
    npts = keys.shape[0]
    q_pos, rank = _plane_rows(rank_arr, qp)
    own = keys[rank]
    q_last = own % dim_last
    base = own[None, :] + deltas[:, None]
    lo = torch.maximum(lo_off[:, None], -q_last[None, :])
    hi = torch.minimum(hi_off[:, None], dim_last - 1 - q_last[None, :])
    lo_rank = torch.searchsorted(keys, base + lo).to(torch.int32)
    hi_rank = torch.searchsorted(keys, base + hi, right=True).to(torch.int32)
    hi_rank = torch.where((q_pos < npts)[None, :], hi_rank, lo_rank)
    return lo_rank, hi_rank


def _range_plane_table(table, cell_keys, rank_arr, deltas32, lo_off, hi_off,
                       dim_last: int, *, qp: int):
    """Merged-range rank spans by three table gathers, one a last-dimension
    slot: a span's keys are base + {-1, 0, +1}, so its rank range is [min,
    max + 1] of the ranks present."""
    vol = table.shape[0]
    q_pos, rank = _plane_rows(rank_arr, qp)
    own = cell_keys[rank].to(torch.int32)
    q_last = own % dim_last
    own = torch.where(q_pos < rank_arr.shape[0], own, -(1 << 30))
    base = own[None, :] + deltas32[:, None]
    lo_rank = torch.full(base.shape, 1 << 30, dtype=torch.int32,
                         device=base.device)
    hi_rank = torch.full(base.shape, -1, dtype=torch.int32,
                         device=base.device)
    for d in (-1, 0, 1):
        qk = base + d
        in_span = ((d >= lo_off[:, None]) & (d <= hi_off[:, None])
                   & (q_last[None, :] + d >= 0)
                   & (q_last[None, :] + d < dim_last))
        ok = in_span & (qk >= 0) & (qk < vol)
        r = torch.where(ok, table[torch.clamp(qk, 0, vol - 1).long()], -1)
        present = r >= 0
        lo_rank = torch.where(present, torch.minimum(lo_rank, r), lo_rank)
        hi_rank = torch.where(present, torch.maximum(hi_rank, r), hi_rank)
    live = hi_rank >= 0
    return torch.where(live, lo_rank, 0), torch.where(live, hi_rank + 1, 0)


def _sparse_lookup(index: GridIndex):
    """Cached per index: ("table", dense int32 key -> rank table) when
    prod(dims) is within ``_LOOKUP_MAX_CELLS``, else ("keys", B): int32 when
    every probe key fits (prod(dims) < 2^30; an int64 B's padding sentinel
    becomes int32's, which keeps the order and matches no probe), else B as
    it is."""

    def build():
        volume = float(np.prod(host_dims(index).astype(np.float64)))
        ncells = int(index.num_cells)
        if volume <= _LOOKUP_MAX_CELLS:
            keys = index.cell_keys[:ncells].long()
            table = torch.full((int(volume),), -1, dtype=torch.int32,
                               device=index.device)
            # a padded build's sentinel cell (key prod(dims), the table's
            # length) and out-of-geometry keys stay out: probes to them
            # miss, and padding points are never candidates
            ok = (keys >= 0) & (keys < int(volume))
            table[keys[ok]] = torch.arange(
                ncells, dtype=torch.int32, device=index.device)[ok]
            return ("table", table)
        keys = index.cell_keys
        if volume < float(1 << 30) and keys.dtype != torch.int32:
            pad32 = pad_key_for(np.dtype(np.int32))
            keys = torch.where(keys == pad_key_for(np.dtype(np.int64)),
                               pad32, keys).to(torch.int32)
        return ("keys", keys)

    return index_cached(index, "sparse_lookup", build)


def _count_probes_span(points_sorted, eps, p_start, p_count, p_qpos, p_zero,
                       *, c: int, unicomp: bool):
    """Ordered-pair hits (int64, on the device) of packed probes, each a
    point span (``p_start``, ``p_count`` <= c) against its query row
    ``p_qpos``, refined in lane order one op at a time (rule P, as
    ``fused_window_hits``); ``p_zero`` marks the zero offset's triangle."""
    npts = points_sorted.shape[0]
    slots = torch.arange(c, dtype=torch.int32, device=points_sorted.device)
    cand_pos = torch.clamp(p_start[:, None] + slots[None, :], max=npts - 1)
    valid = slots[None, :] < p_count[:, None]
    q = points_sorted[torch.clamp(p_qpos, max=npts - 1).long()]
    hit = fused_window_hits(points_sorted, q, cand_pos, valid, eps)
    if unicomp:
        hit = hit & ((cand_pos > p_qpos[:, None]) | (p_zero[:, None] == 0))
    else:
        hit = hit & (cand_pos != p_qpos[:, None])
    return hit.sum(dtype=torch.int64)


def _count_packed(index: GridIndex, groups, *, unicomp: bool):
    """Sum of ``_count_probes_span`` over probe groups (p_start, p_count,
    p_qpos, p_zero, c), each cut into ``_PROBE_CHUNK`` probes."""
    total = torch.zeros((), dtype=torch.int64, device=index.device)
    for p_start, p_count, p_qpos, p_zero, c in groups:
        for i in range(0, p_start.shape[0], _PROBE_CHUNK):
            cut = slice(i, i + _PROBE_CHUNK)
            total += _count_probes_span(
                index.points_sorted, index.eps, p_start[cut], p_count[cut],
                p_qpos[cut], p_zero[cut], c=c, unicomp=unicomp)
    return total


def _self_join_count_sparse(index: GridIndex, *, unicomp: bool,
                            merged: bool = True) -> JoinStats:
    """The probe-compacted counter (route "sparse"; "sparse-flat" with
    ``merged=False``). Totals and work counters are the dense sweep's.

    Merged (the default): the 3^(n-1) plane of rank spans, each live probe
    one contiguous point span of up to three cells. Spans vary from one to
    three cells, so the packed probes go by power-of-two window class
    (``grid.capacity_classes``, the occupancy buckets' ladder) rather than
    one global capacity. Per cell: the 3^n plane of single cells, all at
    the rounded ``max_per_cell``. Probes keep the order of the plane,
    offset-major, as the JAX package's ``np.nonzero`` gives them."""
    npts = index.num_points
    mult = 2 if unicomp else 1
    qp = round_up(max(npts, 1), 128)
    kind, lookup = _sparse_lookup(index)
    rank_arr = index.point_cell_rank
    if merged:
        dtab, is_zero = _merged_offset_tables(index, unicomp)
        n_off = int(dtab.shape[1])
        dim_last = int(host_dims(index)[-1])
        if kind == "table":
            lo_rank, hi_rank = _range_plane_table(
                lookup, index.cell_keys, rank_arr,
                *(dtab[i].to(torch.int32) for i in range(3)), dim_last,
                qp=qp)
        else:
            lo_rank, hi_rank = _range_plane_search(
                lookup, rank_arr, *(dtab[i].to(lookup.dtype)
                                    for i in range(3)), dim_last, qp=qp)
        off, q = torch.nonzero(hi_rank > lo_rank, as_tuple=True)
        lo_l, hi_l = lo_rank[off, q], hi_rank[off, q]
        w_start = _rank_to_point(index, lo_l)
        w_count = _rank_to_point(index, hi_l) - w_start
        cells = (hi_l - lo_l).sum(dtype=torch.int64)
        ladder = capacity_classes(global_window_cap(index, merged=True),
                                  CAP_ALIGN)
        cls = torch.searchsorted(
            torch.tensor(ladder, dtype=torch.int32, device=index.device),
            torch.clamp(round_up(w_count, CAP_ALIGN), max=ladder[-1]))
        by_class = torch.argsort(cls, stable=True)
        sizes = torch.bincount(cls, minlength=len(ladder)).tolist()
        groups, a = [], 0
        for ccap, size in zip(ladder, sizes):
            sel = by_class[a:a + size]
            a += size
            groups.append((w_start[sel], w_count[sel], q[sel].to(torch.int32),
                           is_zero[off[sel]], ccap))
    else:
        deltas, is_zero = _offset_tables(index, unicomp)
        n_off = int(deltas.shape[0])
        if kind == "table":
            nbr = _rank_plane_table(lookup, index.cell_keys, rank_arr,
                                    deltas.to(torch.int32), qp=qp)
        else:
            nbr = _rank_plane_search(lookup, rank_arr,
                                     deltas.to(lookup.dtype), qp=qp)
        off, q = torch.nonzero(nbr >= 0, as_tuple=True)
        live_nbr = nbr[off, q].long()
        w_count = index.cell_count[live_nbr]
        cells = torch.tensor(off.shape[0], dtype=torch.int64,
                             device=index.device)
        groups = [(index.cell_start[live_nbr], w_count,
                   q.to(torch.int32), is_zero[off], _unfused_cap(index))]
    total = _count_packed(index, groups, unicomp=unicomp)
    total, cells, cands = torch.stack(
        [total, cells, w_count.sum(dtype=torch.int64)]).tolist()
    return JoinStats(total_pairs=mult * total, cells_visited=cells,
                     candidates_checked=cands, offsets=n_off, route="sparse")


# ---------------------------------------------------------------------------
# The route choice: the measured table (``kernels.autotune``) or, without a
# row, its occupancy heuristic, on host-side workload features.
# ---------------------------------------------------------------------------

def _route_features(index: GridIndex, deltas) -> dict:
    """Workload features for the route table: ``occupancy``, the live-cell
    share of the grid's volume (the TPU rule's proxy); ``live_frac``, the
    live share of the (offset, query) probes of up to 1,024 query rows
    sampled at an even stride over sorted key order, under the per-cell
    stencil ``deltas``; ``c``, max_per_cell."""
    with host_sync():
        live_cells = int(index.num_cells)
    ncells = max(live_cells, 1)
    # a float product: a fine 6-D grid overflows int64, and only a ratio is
    # needed
    volume = max(float(np.prod(host_dims(index).astype(np.float64))), 1.0)
    with host_sync():
        c = max(int(index.max_per_cell), 1)
    npts = index.num_points
    live_frac = 0.0
    if npts and live_cells:
        keys = _keys64(index)[:ncells]
        sample = index.point_cell_rank[::-(-npts // 1024)][:1024].long()
        probe = keys[sample][None, :] + deltas.long()[:, None]
        pos = torch.clamp(torch.searchsorted(keys, probe), max=ncells - 1)
        with host_sync():
            live_frac = float((keys[pos] == probe).double().mean())
    return {"occupancy": ncells / volume, "live_frac": live_frac, "c": c}


def _fused_count_route(index: GridIndex, n_off: int,
                       backend: Optional[str] = None, *,
                       unicomp: bool = True) -> str:
    """The heuristic route of the fused counter, no table consulted
    (``autotune.route_heuristic``); ``backend`` defaults to the index's
    device type."""
    deltas, _ = _offset_tables(index, unicomp)
    feats = _route_features(index, deltas)
    return autotune.route_heuristic(
        backend or index.device.type, index.n_dims, n_off, feats["c"],
        feats["occupancy"], feats["live_frac"])


def _auto_route(index: GridIndex, *, unicomp: bool,
                bucketed: Optional[bool] = None,
                merged: bool = False) -> str:
    """The count route for this index and sweep: the table's row, a
    measurement of the candidates when measuring is on, else the heuristic.
    A pure function of the index and the sweep, so cached per index."""
    return index_cached(
        index, f"route/{unicomp}/{bucketed}/{merged}",
        lambda: _auto_route_uncached(index, unicomp=unicomp,
                                     bucketed=bucketed, merged=merged))


def _auto_route_uncached(index: GridIndex, *, unicomp: bool,
                         bucketed: Optional[bool] = None,
                         merged: bool = False) -> str:
    # the features describe the data's neighbour regime under the per-cell
    # stencil whatever the sweep; the merged sweep's n_off keys its own row
    deltas, _ = _offset_tables(index, unicomp)
    feats = _route_features(index, deltas)
    n_off = (int(_merged_offset_tables(index, unicomp)[1].shape[0])
             if merged else int(deltas.shape[0]))
    candidates = None
    if autotune.measure_enabled():
        candidates = {
            "dense": lambda: _self_join_count_fused(
                index, unicomp=unicomp, bucketed=bucketed, merged=merged),
            "sparse": lambda: _self_join_count_sparse(
                index, unicomp=unicomp, merged=merged),
            "jnp": lambda: _self_join_count_unfused(
                index, unicomp=unicomp, distance_impl="jnp"),
        }
        if merged:
            # the sweep is a raced axis too: the per-cell sweeps and the
            # cell-run loop give the same totals, so each is a pure choice
            # of speed
            candidates["dense-flat"] = lambda: _self_join_count_fused(
                index, unicomp=unicomp, bucketed=bucketed, merged=False)
            candidates["sparse-flat"] = lambda: _self_join_count_sparse(
                index, unicomp=unicomp, merged=False)
            candidates["dense-run"] = lambda: _self_join_count_fused(
                index, unicomp=unicomp, bucketed=bucketed, merged=True,
                run_loop=True)
    route, _ = autotune.count_route(
        n_dims=index.n_dims, n_off=n_off, c=feats["c"],
        occupancy=feats["occupancy"], live_frac=feats["live_frac"],
        backend=index.device.type, merged=merged, candidates=candidates)
    return route


def _join_sweep_merged(index: GridIndex, *, unicomp: bool,
                       bucketed: Optional[bool], merged: bool) -> bool:
    """The pair-emitting join's sweep: merged unless the count route's
    choice for the merged sweep is "dense-flat", the one verdict about the
    join's own dense bucketed sweep ("sparse-flat" judges the counter only;
    the heuristic never gives "-flat"). The pairs are the same either
    way."""
    if not merged:
        return False
    return _auto_route(index, unicomp=unicomp, bucketed=bucketed,
                       merged=True) != "dense-flat"


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

_IMPLS = ("fused", "jnp", "pallas")


def _check_impl(distance_impl: str) -> None:
    if distance_impl not in _IMPLS:
        raise ValueError(f"unknown distance_impl {distance_impl!r}; "
                         f"expected one of {_IMPLS}")


def _metric_canonical(points, eps, metric: str,
                      vocab=None) -> metric_lib.Canonical:
    """Resolve (points, eps, metric) to a ``metric.Canonical``: a ready one
    passes through (``eps`` must then be None or its threshold),
    ``metric.canonicalize`` makes one otherwise."""
    if isinstance(points, metric_lib.Canonical):
        canon = points
        if metric not in ("l2", canon.metric):
            raise ValueError(
                f"metric={metric!r} conflicts with the canonical dataset's "
                f"metric {canon.metric!r}")
        if eps is not None and float(eps) != canon.eps:
            raise ValueError(
                f"eps={eps} conflicts with the canonical dataset's "
                f"threshold {canon.eps}; canonicalize at the new threshold")
        return canon
    return metric_lib.canonicalize(points, eps, metric=metric, vocab=vocab)


def _metric_feats_sorted(canon: metric_lib.Canonical, index: GridIndex):
    """The feature payload in the index's sorted point order
    (``points_sorted[i] == points[order[i]]``) on its device, or None."""
    if canon.feats is None:
        return None
    order = index.order.cpu().numpy()
    return torch.as_tensor(np.asarray(canon.feats)[order]).to(index.device)


def _metric_grid(canon: metric_lib.Canonical, device) -> GridIndex:
    """The grid over the canonical geometry at the derived prune radius:
    unit rows for cosine (an exact L2 grid), the 1-D set size for
    jaccard."""
    return build_grid(np.asarray(canon.geom), float(canon.eps_geom),
                      device=device)


def _metric_self_join(canon: metric_lib.Canonical, *, unicomp: bool,
                      sort_result: bool, bucketed: Optional[bool],
                      device) -> torch.Tensor:
    """The pair-emitting join of a canonicalized cosine or jaccard dataset.
    Cosine runs the L2 machinery (merged sweep, occupancy buckets, run
    loop) on the unit rows. Jaccard takes the per-cell sweep of the 1-D
    size grid, with the words in feature lanes and the kernel refining
    against t itself."""
    with trace_span("self_join.grid"):
        index = _metric_grid(canon, device)
    if canon.metric == "jaccard":
        return _self_join_fused(
            index, unicomp=unicomp, sort_result=sort_result,
            bucketed=bucketed, merged=False, metric="jaccard",
            n_feat=canon.n_feat, feats=_metric_feats_sorted(canon, index),
            refine_eps=canon.eps)
    return _self_join_fused(index, unicomp=unicomp, sort_result=sort_result,
                            bucketed=bucketed,
                            merged=_join_sweep_merged(
                                index, unicomp=unicomp, bucketed=bucketed,
                                merged=_resolve_merge(index, None)),
                            metric=canon.metric)


def _entry(join):
    """``join`` as a public entry point: each call counts one
    ``JOIN_EVENTS["calls"]`` and runs inside the root span ``self_join``,
    the parent of its stage spans."""
    @functools.wraps(join)
    def entry(*args, **kwargs):
        JOIN_EVENTS["calls"] += 1
        with trace_span("self_join"):
            return join(*args, **kwargs)
    return entry


@_entry
def self_join(points, eps, *, unicomp: bool = True,
              index: Optional[GridIndex] = None,
              distance_impl: str = "fused", sort_result: bool = True,
              bucketed: Optional[bool] = None,
              merge_last_dim: Optional[bool] = None, metric: str = "l2",
              vocab: Optional[int] = None, device=None) -> torch.Tensor:
    """Epsilon self-join: every ordered pair (i, j), i != j, with
    ||p_i - p_j|| <= eps, as a (K, 2) int32 tensor of point ids.

    ``distance_impl`` "fused" (the port's default; the JAX package defaults
    to "jnp") is the single-pass count -> fill through kernel B1: the sweep
    is occupancy-bucketed (``bucketed=False`` forces one launch) over the
    merged-range stencil (``merge_last_dim=False`` sweeps per cell); every
    choice gives the same pair set. "jnp" and "pallas" run the unfused
    per-cell sweep, two-phase (an exact count, then a fill sized to it):
    per offset a (B, C, n) candidate tensor, refined in plain torch or by
    kernel B4 (bit-equal pairs); ``bucketed`` and ``merge_last_dim`` do not
    apply to them. ``sort_result`` orders the pairs lexicographically, as
    the paper sorts its result; unsorted, "fused" pairs come query-major
    and unfused ones offset-major, as in the JAX package.

    ``metric``: "l2" (``eps`` is the radius), "cosine" (``points`` are raw
    embeddings, ``eps`` the minimum cosine similarity in [-1, 1)) or
    "jaccard" (``points`` are token-id iterables or an (N, V) binary
    matrix, ``eps`` the minimum Jaccard similarity in (0, 1]; ``vocab``
    fixes the packed vocabulary). ``points`` may also be a ready
    ``metric.Canonical`` (with ``eps=None``). Cosine and jaccard build
    their own grid over the canonical geometry and always run the fused
    path; ``index``, ``distance_impl`` and ``merge_last_dim`` apply to l2.

    ``device`` is where the join runs: CUDA by default, which raises
    ``RuntimeError`` when no CUDA device is present; ``device="cpu"`` runs
    the plain PyTorch version of the kernel. The pairs come back on that
    device.
    """
    metric_lib.check_metric(metric)
    dev = resolve_device(device)
    if metric != "l2" or isinstance(points, metric_lib.Canonical):
        canon = _metric_canonical(points, eps, metric, vocab)
        if canon.metric != "l2":
            return _metric_self_join(canon, unicomp=unicomp,
                                     sort_result=sort_result,
                                     bucketed=bucketed, device=dev)
        points, eps = canon.geom, canon.eps
    _check_impl(distance_impl)
    with trace_span("self_join.grid"):
        index = _resolve_index(points, eps, index, dev)
    if distance_impl != "fused":
        return _self_join_unfused(index, unicomp=unicomp,
                                  sort_result=sort_result,
                                  distance_impl=distance_impl)
    return _self_join_fused(index, unicomp=unicomp, sort_result=sort_result,
                            bucketed=bucketed,
                            merged=_join_sweep_merged(
                                index, unicomp=unicomp, bucketed=bucketed,
                                merged=_resolve_merge(index, merge_last_dim)))


def self_join_count(points, eps, *, unicomp: bool = True,
                    index: Optional[GridIndex] = None,
                    distance_impl: str = "fused",
                    query_batch: Optional[int] = None,
                    route: Optional[str] = None,
                    bucketed: Optional[bool] = None,
                    merge_last_dim: Optional[bool] = None,
                    metric: str = "l2", vocab: Optional[int] = None,
                    device=None) -> JoinStats:
    """Total ordered-pair count and work counters, without the pairs.

    With ``distance_impl="fused"`` (the default) ``route`` picks the sweep:
    ``"dense"``, the occupancy-bucketed fused sweep with no hit plane;
    ``"dense-run"``, the same sweep through the cell-run loop, with the same
    totals and counters and its window-read accounting; ``"dense-flat"``,
    the dense sweep per cell; ``"sparse"`` / ``"sparse-flat"``, the
    probe-compacted counter over the merged / per-cell plane; ``"compact"``
    (``self_join_count_compact``); ``"jnp"``, the unfused plain sweep.
    ``route=None`` takes the measured table's row for the workload's class
    (``kernels.autotune``), a measurement when ``REPRO_TORCH_AUTOTUNE=1``,
    else its heuristic; an explicit ``query_batch`` means "dense". The
    route that ran is ``JoinStats.route``. "dense", "sparse" and "jnp"
    report the same counters; "compact" reports ``cells_visited`` 0.
    With "jnp" or "pallas" ``route`` is ignored: the unfused sweep runs,
    labelled "dense", over batches of ``query_batch`` rows.

    ``metric`` / ``vocab`` as in ``self_join``: cosine counts over the unit
    rows with the L2 routes; jaccard runs the dense per-cell sweep of the
    size grid, and its only routes are "dense" and "dense-run" (any other
    raises ``ValueError``, as in the JAX package). ``device`` as in
    ``self_join``.
    """
    if route is not None and route not in _ROUTES:
        raise ValueError(f"unknown route {route!r}; expected one of {_ROUTES}")
    metric_lib.check_metric(metric)
    dev = resolve_device(device)
    if metric != "l2" or isinstance(points, metric_lib.Canonical):
        canon = _metric_canonical(points, eps, metric, vocab)
        if canon.metric == "jaccard":
            if route not in (None, "dense", "dense-run"):
                raise ValueError(
                    f"route {route!r} does not support metric='jaccard'; "
                    f"only the fused dense sweep carries the bitmap refine")
            idx = _metric_grid(canon, dev)
            return _self_join_count_fused(
                idx, unicomp=unicomp, query_batch=query_batch,
                bucketed=bucketed, merged=False,
                run_loop=route == "dense-run", metric="jaccard",
                n_feat=canon.n_feat, feats=_metric_feats_sorted(canon, idx),
                refine_eps=canon.eps)
        if canon.metric == "cosine":
            index = _metric_grid(canon, dev)
        points, eps = canon.geom, canon.eps_geom
    _check_impl(distance_impl)
    index = _resolve_index(points, eps, index, dev)
    if distance_impl != "fused":
        return _self_join_count_unfused(
            index, unicomp=unicomp, query_batch=query_batch,
            distance_impl=distance_impl)
    merged = _resolve_merge(index, merge_last_dim)
    if route is None:
        route = ("dense" if query_batch is not None else
                 _auto_route(index, unicomp=unicomp, bucketed=bucketed,
                             merged=merged))
    if route == "compact":
        return self_join_count_compact(points, eps, unicomp=unicomp,
                                       index=index, device=dev)
    if route in ("sparse", "sparse-flat"):
        return dataclasses.replace(
            _self_join_count_sparse(index, unicomp=unicomp,
                                    merged=merged and route == "sparse"),
            route=route)
    if route in ("dense", "dense-flat", "dense-run"):
        return dataclasses.replace(
            _self_join_count_fused(
                index, unicomp=unicomp, query_batch=query_batch,
                bucketed=bucketed, merged=merged and route != "dense-flat",
                run_loop=route == "dense-run"),
            route=route)
    # "jnp": the table found the fused sweeps slower than the plain one
    return _self_join_count_unfused(
        index, unicomp=unicomp, query_batch=query_batch,
        distance_impl="jnp", route="jnp")


@_entry
def self_join_batched(points, eps, *, unicomp: bool = True,
                      n_batches: int = 3, index: Optional[GridIndex] = None,
                      distance_impl: str = "fused", sort_result: bool = True,
                      bucketed: Optional[bool] = None,
                      merge_last_dim: Optional[bool] = None,
                      device=None) -> torch.Tensor:
    """The paper's batching scheme (SV-A): every launch is cut to
    ``ceil(N / n_batches)`` query rows, and each batch's pairs are copied
    to the host while the next batch runs. Device memory then holds one
    batch's planes and result, not the whole result, so result sets larger
    than the card complete.

    Returns the (K, 2) int32 pairs as a CPU tensor (the JAX package returns
    numpy), the pair set of ``self_join``; ``sort_result`` sorts them on
    the host. With ``distance_impl`` "jnp" or "pallas" every batch is
    counted first, then filled, as in the JAX package. ``device`` as in
    ``self_join``.
    """
    _check_impl(distance_impl)
    dev = resolve_device(device)
    with trace_span("self_join.grid"):
        index = _resolve_index(points, eps, index, dev)
    if distance_impl != "fused":
        return _self_join_unfused(index, unicomp=unicomp,
                                  sort_result=sort_result,
                                  distance_impl=distance_impl,
                                  n_batches=n_batches, to_host=True)
    return _self_join_fused(index, unicomp=unicomp, sort_result=sort_result,
                            n_batches=n_batches, bucketed=bucketed,
                            merged=_join_sweep_merged(
                                index, unicomp=unicomp, bucketed=bucketed,
                                merged=_resolve_merge(index, merge_last_dim)),
                            to_host=True)


def range_query(queries, points, eps, *, index: Optional[GridIndex] = None,
                return_pairs: bool = False,
                merge_last_dim: Optional[bool] = None, device=None):
    """Epsilon-range counts for external query points against an indexed
    set: a thin wrapper over ``core.query_join.epsilon_join``, as in the
    JAX package. Returns (Q,) int32 numpy counts, or ``(counts, pairs)``
    with ``return_pairs``. ``device`` as in ``self_join``; services holding
    an index should use ``query_join.prepare`` or ``launch.serve``."""
    from repro_torch.core.query_join import epsilon_join

    index = _resolve_index(points, eps, index, resolve_device(device))
    res = epsilon_join(queries, None, index=index, return_pairs=return_pairs,
                       merge_last_dim=merge_last_dim)
    if return_pairs:
        return res.counts, res.pairs
    return res.counts


def per_point_neighbor_counts(points, eps, *,
                              index: Optional[GridIndex] = None,
                              merge_last_dim: Optional[bool] = None,
                              device=None) -> np.ndarray:
    """|epsilon-neighbourhood| of each point, excluding itself, as (N,) int32
    numpy in the original point order: the range-query building block the
    paper cites for DBSCAN. Sweeps the merged 3^(n-1) range stencil by
    default, and the per-cell 3^n stencil with ``merge_last_dim=False``;
    per offset a (N, C, n) candidate tensor refined in plain torch
    (``_distance_hits_jnp``, as in the JAX package) and a scatter-add on the
    query's id. ``device`` as in ``self_join``."""
    index = _resolve_index(points, eps, index, resolve_device(device))
    npts = index.num_points
    dev = index.device
    deg = torch.zeros(npts, dtype=torch.int32, device=dev)
    if _resolve_merge(index, merge_last_dim):
        dtab, _ = _merged_offset_tables(index, unicomp=False)
        q_pos = torch.arange(npts, dtype=torch.int32, device=dev)
        ws, wc, _ = range_window_descriptors_at(index, dtab[0], dtab[1],
                                                dtab[2], q_pos)
        slots = torch.arange(global_window_cap(index, merged=True),
                             dtype=torch.int32, device=dev)
        for o in range(ws.shape[0]):
            cand_pos = torch.clamp(ws[o][:, None] + slots[None, :],
                                   max=npts - 1)
            valid = slots[None, :] < wc[o][:, None]
            hits = _distance_hits_jnp(
                index.points_sorted,
                _gather_rows(index.points_sorted, cand_pos), valid,
                index.eps)
            hits = hits & (cand_pos != q_pos[:, None])
            deg.index_add_(0, index.order.long(),
                           hits.sum(dim=1, dtype=torch.int32))
    else:
        deltas, _ = _offset_tables(index, unicomp=False)
        cap = _unfused_cap(index)
        for o in range(deltas.shape[0]):
            q, cand, cand_pos, valid, q_pos, _ = _gather_batch(
                index, _neighbor_ranks_for_delta(index, deltas[o]), 0, npts,
                cap)
            hits = _distance_hits_jnp(q, cand, valid, index.eps)
            hits = hits & (cand_pos != q_pos[:, None])
            deg.index_add_(0, index.order[q_pos.long()].long(),
                           hits.sum(dim=1, dtype=torch.int32))
    return deg.cpu().numpy()
