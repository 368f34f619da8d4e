"""External-query epsilon joins against a prebuilt grid index, in PyTorch.

The counterpart of ``repro.core.query_join``: the index-once / query-many
epsilon join a similarity service runs. The indexed set D is built once
(paper SIV); request batches of external query points (not members of D,
possibly outside its volume, possibly duplicated) are answered against it
through the fused gather-refine kernel with the external mask (no self
pair, no triangle):

  * each query's windows come from its own cell coordinates under D's grid
    geometry: the merged-range 3^(n-1) stencil by default
    (``grid.external_range_descriptors``), the per-cell 3^n sweep
    (``grid.external_window_descriptors``) behind ``merge_last_dim=False``;
  * one launch per request (one per populated capacity class on a skewed
    index) returns counts and the hit plane, and the device emit turns the
    plane into (query row, point id) pairs with no second distance pass.

Cell-run batching: each request batch is stably sorted by the query's
clipped cell-coordinate tuple before launch, so queries of one cell form a
run and the kernel's run loop reads their windows once; the inverse
permutation restores request row numbering on counts and pair query ids.
The sort key, the merged lane the kernel masks with, and the descriptors'
cell coordinates all divide by eps as an array in the points' dtype (true
division, never a reciprocal multiply), so the three agree on every
boundary.

A precompiled kernel library has nothing to trace, so the JAX package's
no-retrace contract becomes: a steady-state request builds and loads no
kernel library and redoes no prepare-time build (the padded points, the
offset tables, ``grid.external_range_cap``, the class set).
``executable_cache_stats`` reports those counters; ``launch.serve``
asserts they stay still. ``TRACE_EVENTS`` carries the serving metrics
(``metric:`` keys) only.

Metric-aware serving: ``prepare(index, canon=)`` with the
``metric.Canonical`` the index was built from takes requests in raw metric
form (embeddings for cosine, token sets or a binary matrix for jaccard) and
canonicalizes each against the index's form; jaccard serves the per-cell
sweep with the packed words in feature lanes.

Each capacity class launches at its query tile from the measured table
(``kernels.autotune``), clamped to ``TQ_DEFAULT``, the request padding
unit, so every launch divides a request's padded rows. The port keeps the
device emit only, as for the self-join (A4).

Typical use:

    index = build_grid(points, eps)          # once
    pj = prepare(index)                      # once: pads, offset tables
    res = pj.join(queries)                   # per request: counts + pairs
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.analysis import sanitize
from repro_torch.core import grid as grid_lib
from repro_torch.core import metric as metric_lib
from repro_torch.core.grid import (CAP_ALIGN, GridIndex, build_grid,
                                   capacity_classes, cell_run_plan,
                                   external_range_cap, round_up)
from repro_torch.core import selfjoin as selfjoin_lib
from repro_torch.core.stencil import merged_stencil_offsets, stencil_offsets
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.fused_join import (TQ_DEFAULT, emit_steps,
                                            pack_words, pad_points,
                                            resolve_merge_last_dim)

# Serving metrics (``metric:`` keys): the batching service publishes its
# queue-depth and coalescing counters here. They move on every request, so
# every no-rebuild comparison drops them (``metric_free``).
TRACE_EVENTS: collections.Counter = collections.Counter()

METRIC_PREFIX = "metric:"

# Prepare-time builds: the padded points, the offset tables and the class
# set, one each per ``PreparedJoin``. A steady-state request never adds one.
PREPARE_EVENTS: collections.Counter = collections.Counter()

# clip of query cell coordinates: any query whose coordinate leaves this
# range has no live window, so the clip never changes a mask
_COORD_CLIP = 1 << 24


def note_metric(name: str, inc: int = 1) -> None:
    """Accumulate a serving metric (``metric:``-prefixed TRACE_EVENTS key)."""
    TRACE_EVENTS[METRIC_PREFIX + name] += int(inc)


def note_metric_peak(name: str, value: int) -> None:
    """Record the running peak of a serving metric (e.g. queue depth)."""
    key = METRIC_PREFIX + name
    TRACE_EVENTS[key] = max(TRACE_EVENTS[key], int(value))


def metric_free(trace_events: dict) -> dict:
    """Drop ``metric:`` keys: they move per request by design."""
    return {k: v for k, v in trace_events.items()
            if not k.startswith(METRIC_PREFIX)}


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def bucket_rows(n_queries: int, tile: int = TQ_DEFAULT) -> int:
    """Padded row count of a request of ``n_queries`` queries: tile
    multiples growing by powers of two (128, 256, 512, ...), the JAX
    package's request shapes."""
    n = max(int(n_queries), 1)
    return tile * _next_pow2(-(-n // tile))


def _to_device(arr, device: torch.device) -> torch.Tensor:
    """A host array or CPU tensor on ``device``; to a card through pinned
    memory, so the copy is queued on the stream and the host does not wait
    for it."""
    t = (arr.contiguous() if isinstance(arr, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(arr)))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory, queued on the current stream (pinned,
    so the host reads it only after the request's event)."""
    if not t.is_cuda:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _external_windows(index: GridIndex, offsets: torch.Tensor,
                      queries_pad: torch.Tensor, q_limit: int):
    """Per-cell descriptors of a padded request batch."""
    n = index.n_dims
    return grid_lib.external_window_descriptors(
        index, offsets, queries_pad[:, :n], q_limit)


def _external_range_windows(index: GridIndex, offsets: torch.Tensor,
                            lo_off: torch.Tensor, hi_off: torch.Tensor,
                            queries_pad: torch.Tensor, q_limit: int):
    """Merged-range descriptors of a padded request batch: (win_start,
    win_count); the external join reports no per-cell work counters."""
    n = index.n_dims
    ws, wc, _ = grid_lib.external_range_descriptors(
        index, offsets, lo_off, hi_off, queries_pad[:, :n], q_limit)
    return ws, wc


def _window_caps(wc: torch.Tensor) -> torch.Tensor:
    """Per-query candidate capacity: the longest window over all offsets."""
    return wc.max(dim=0).values


def _bucket_select(ws: torch.Tensor, wc: torch.Tensor, q_pad: torch.Tensor,
                   sel: torch.Tensor, nsel: int):
    """One capacity class's rows out of the request batch. ``sel`` is the
    class's (qp_b,) row selection padded with 0; rows at or past ``nsel``
    get count-0 windows."""
    ok = torch.arange(sel.shape[0], device=sel.device) < nsel
    ws_b = ws[:, sel]
    wc_b = torch.where(ok[None, :], wc[:, sel], 0)
    return ws_b, wc_b, q_pad[sel]


def _emit_pairs_device(order, hits, counts, slot_base, win_start, *,
                       c: int, tq: int, capacity: int):
    """Device fill: scatter (query row, point id) pairs from the count
    pass's hit plane, with no distances, in the steps of
    ``fused_join.emit_steps``. Rows are query-major (per query: offsets in
    sweep order, slots in window order). Returns (keys, vals) with
    ``capacity`` slots each, -1 past the pairs."""
    dev = hits.device
    keys = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    vals = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    for a, b, h, cand, pos in emit_steps(hits, counts, slot_base, win_start,
                                         c=c, tq=tq, npts=order.shape[0]):
        qid = torch.arange(a, b, dtype=torch.int32, device=dev)[:, None]
        # JAX drops writes out of range; here they go to one spare slot past
        # the end, which is cut off
        idx = torch.where(h & (pos < capacity), pos, capacity).reshape(-1)
        keys.scatter_(0, idx, qid.expand(h.shape).reshape(-1))
        vals.scatter_(0, idx, order[cand].reshape(-1))
    return keys[:capacity], vals[:capacity]


@dataclasses.dataclass(frozen=True)
class QueryJoinResult:
    """One request's answer: per-query neighbour counts and (optionally)
    the neighbour pairs as (query row, original point id) int32 rows, both
    host numpy arrays (a service hands them to its caller)."""

    counts: np.ndarray                 # (Q,) int32
    pairs: Optional[np.ndarray]        # (K, 2) int32, or None
    n_offsets: int                     # stencil cells probed per query
    bucket_rows: int                   # padded batch rows used
    emit: Optional[str]                # 'device', or None (counts only)
    candidates_checked: Optional[int]  # total live window slots (with_stats)

    @property
    def total(self) -> int:
        return int(self.counts.sum())


def coalesce_requests(batches) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate request query batches into one joint batch.

    Returns (queries (sum Q_i, n), a tensor if the first batch is one,
    else numpy; bounds (k+1,) int64) with request i
    owning joint rows [bounds[i], bounds[i+1]); empty requests are legal.
    """
    if not batches:
        raise ValueError("coalesce_requests needs at least one request")
    # tensors stay tensors: bfloat16 queries have no numpy form
    arrs = [b if isinstance(b, torch.Tensor) else np.asarray(b)
            for b in batches]
    n = arrs[0].shape[1] if arrs[0].ndim == 2 else -1
    for a in arrs:
        if a.ndim != 2 or a.shape[1] != n:
            raise ValueError(
                f"coalesced requests must share (Q_i, n) shape; got "
                f"{[tuple(x.shape) for x in arrs]}")
    sizes = np.asarray([a.shape[0] for a in arrs], np.int64)
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    if isinstance(arrs[0], torch.Tensor):
        return torch.cat([torch.as_tensor(a) for a in arrs]), bounds
    return np.concatenate(arrs, axis=0), bounds


def slice_result(res: QueryJoinResult, lo: int, hi: int) -> QueryJoinResult:
    """One request's view of a coalesced result: rows [lo, hi). Pairs must
    be sorted by query row (``sort_pairs=True``), so each request's pairs
    are one span, found by binary search, with query ids rebased."""
    lo, hi = int(lo), int(hi)
    pairs = None
    if res.pairs is not None:
        if res.pairs.shape[0] and np.any(np.diff(res.pairs[:, 0]) < 0):
            raise ValueError(
                "slice_result needs the coalesced pairs sorted by query "
                "row (join with sort_pairs=True)")
        a = np.searchsorted(res.pairs[:, 0], lo, side="left")
        b = np.searchsorted(res.pairs[:, 0], hi, side="left")
        pairs = res.pairs[a:b].copy()
        pairs[:, 0] -= lo
    return QueryJoinResult(
        counts=res.counts[lo:hi], pairs=pairs, n_offsets=res.n_offsets,
        bucket_rows=res.bucket_rows, emit=res.emit, candidates_checked=None)


@dataclasses.dataclass
class _FusedLaunch:
    """One queued fused sweep: the request rows it serves (None for a
    whole-batch launch), its device outputs, the host copy of its counts,
    and what its pair emit needs."""

    rows: Optional[np.ndarray]
    n_rows: int
    hits: Optional[torch.Tensor]
    counts: torch.Tensor
    base: torch.Tensor
    ws: torch.Tensor
    c: int
    tile: int
    counts_host: torch.Tensor


class PendingJoin:
    """An in-flight request: every launch is queued on the device and the
    counts' copies to the host are queued behind them; nothing has been
    read on the host. ``result()`` waits, emits the pairs and assembles the
    ``QueryJoinResult``.

    This is the double-buffering seam of the batching service: the host
    can assemble and queue batch k+1 between ``join_async(batch_k)`` and
    ``pending_k.result()``."""

    def __init__(self, prepared: "PreparedJoin", launches: list, *,
                 wc, qp: int, n_queries: int, return_pairs: bool,
                 sort_pairs: bool, with_stats: bool,
                 perm: Optional[np.ndarray] = None):
        self._pj = prepared
        self._launches = launches
        self._wc = wc
        self._qp = qp
        self._n_queries = n_queries
        # cell-sort permutation: launch row i served request row perm[i];
        # None when the batch ran unsorted
        self._perm = perm
        self._return_pairs = return_pairs
        self._sort_pairs = sort_pairs
        self._with_stats = with_stats
        self._result: Optional[QueryJoinResult] = None
        self._event = None
        if prepared.device.type == "cuda":
            # after the request's last launch and its counts' copies
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(prepared.device))

    def ready(self) -> bool:
        """True once the launches and counts' copies have finished, so
        ``result()`` will not wait on them. Does not block."""
        if self._result is not None or self._event is None:
            return True
        return self._event.query()

    def result(self) -> QueryJoinResult:
        """Wait for the device work and assemble the answer (idempotent)."""
        if self._result is not None:
            return self._result
        with record_function("query_join.wait"):
            if self._event is not None:
                self._event.synchronize()
            sanitize.raise_pending()   # REPRO_TORCH_SANITIZE
        with record_function("query_join.emit"):
            self._result = self._assemble()
        self._launches = self._wc = None   # release device references
        return self._result

    def _assemble(self) -> QueryJoinResult:
        pj, n_queries, perm = self._pj, self._n_queries, self._perm
        counts_np = np.zeros(n_queries, np.int32)
        chunks, totals = [], []
        for ln in self._launches:
            counts_b = ln.counts_host.numpy()[:ln.n_rows]
            rows = np.arange(ln.n_rows) if ln.rows is None else ln.rows
            counts_np[rows if perm is None else perm[rows]] = counts_b
            if self._return_pairs:
                total = int(counts_b.sum(dtype=np.int64))
                keys, vals = _emit_pairs_device(
                    pj.order, ln.hits, ln.counts, ln.base, ln.ws, c=ln.c,
                    tq=ln.tile, capacity=max(total, 1))
                chunks.append(torch.stack([keys[:total], vals[:total]], 1))
                totals.append(total)
        pairs = None
        if self._return_pairs:
            pairs = (torch.cat(chunks).cpu().numpy() if chunks
                     else np.empty((0, 2), np.int32))
            row0 = 0
            for ln, total in zip(self._launches, totals):
                p = pairs[row0:row0 + total]
                if ln.rows is not None:
                    p[:, 0] = ln.rows[p[:, 0]]   # launch row -> batch row
                if perm is not None:
                    p[:, 0] = perm[p[:, 0]]      # batch row -> request row
                row0 += total
            if pairs.shape[0] != int(counts_np.sum(dtype=np.int64)):
                raise RuntimeError(f"emitted {pairs.shape[0]} pairs for "
                                   f"{int(counts_np.sum())} counted hits")
            if self._sort_pairs:
                # (query row, point id) is unique, so one argsort of the
                # combined key gives np.lexsort's order, several times
                # faster
                key = (pairs[:, 0].astype(np.int64) * pj.index.num_points
                       + pairs[:, 1])
                pairs = pairs[np.argsort(key)]
        cands = (int(self._wc.sum(dtype=torch.int64))
                 if self._with_stats else None)
        return QueryJoinResult(
            counts=counts_np, pairs=pairs, n_offsets=pj.n_offsets,
            bucket_rows=self._qp,
            emit="device" if self._return_pairs else None,
            candidates_checked=cands)


class PreparedJoin:
    """A grid index prepared for serving: the offset tables, the padded
    points copy and the capacity classes are built once, on the index's
    device; every request only pads its queries, computes descriptors and
    queues launches.

    When the index is skewed (window capacity above the smallest class),
    each request batch is partitioned by per-query candidate capacity (the
    longest window over the stencil), and every populated class launches at
    its own capacity; rows with no candidate are dropped before any launch.
    Deciding the launch shapes reads the per-query capacities on the host,
    the one synchronisation of ``join_async``, as in the JAX package.

    ``canon`` makes the index metric-aware: it is the ``metric.Canonical``
    the index was built from (the grid over ``canon.geom`` at
    ``canon.eps_geom``). Requests then arrive in raw metric form and are
    canonicalized against the index's normalization or vocabulary; a
    request's threshold is in metric units.
    """

    def __init__(self, index: GridIndex,
                 merge_last_dim: Optional[bool] = None,
                 run_loop: bool = True,
                 canon: Optional[metric_lib.Canonical] = None):
        self.index = index
        self.device = index.device
        self.n_dims = index.n_dims
        self.eps = float(index.eps)
        self.canon = canon
        self.metric = "l2" if canon is None else canon.metric
        self.n_feat = 0 if canon is None else int(canon.n_feat)
        # the build threshold in metric units (cosine similarity, jaccard
        # t); ``eps`` above stays the radius the stencil covers
        self.metric_eps = self.eps if canon is None else float(canon.eps)
        # the default kernel scalar, unsquared (``Canonical.refine``)
        self.refine = self.eps if canon is None else float(canon.refine)
        feats = None
        if canon is not None:
            metric_lib.check_metric(canon.metric)
            # index.eps went through the geometry's dtype (float32 set
            # sizes for jaccard), so compare at float32 resolution, or
            # exactly at the index's dtype: float16 unit rows carry the
            # chord rounded to float16, which the JAX package refuses here
            # (ROADMAP §C)
            if (abs(self.eps - float(canon.eps_geom))
                    > 1e-5 * max(1.0, self.eps)
                    and self.eps != float(metric_lib.scalar_as(
                        canon.eps_geom, index.eps.dtype))):
                raise ValueError(
                    f"index eps {self.eps} does not match the canonical "
                    f"geometry radius {canon.eps_geom}; build the grid "
                    f"over canon.geom at canon.eps_geom")
            feats = selfjoin_lib._metric_feats_sorted(canon, index)
        # the jaccard geometry is the 1-D set size: nothing to merge
        if self.metric == "jaccard":
            merge_last_dim = False
        # merged-range sweep: 3^(n-1) reduced offsets, full stencil
        # (external queries have no UNICOMP)
        self.merged = resolve_merge_last_dim(self.n_dims, merge_last_dim)
        if self.merged:
            self.c = external_range_cap(index, CAP_ALIGN)
            reduced, lo, hi = merged_stencil_offsets(self.n_dims,
                                                     unicomp=False)
            offs = reduced
            self.lo_off = torch.as_tensor(lo).to(self.device)
            self.hi_off = torch.as_tensor(hi).to(self.device)
            grid_lib.check_merged_lane(index)
            last = grid_lib.point_last_coords(index)
        else:
            self.c = round_up(max(int(index.max_per_cell), 1), CAP_ALIGN)
            offs = stencil_offsets(self.n_dims, unicomp=False)
            self.lo_off = self.hi_off = None
            last = None
        PREPARE_EVENTS["offset_tables"] += 1
        self.n_offsets = offs.shape[0]
        self.offsets = torch.as_tensor(offs).to(self.device)    # (n_off, n)
        self.is_zero = torch.zeros(self.n_offsets, dtype=torch.int32,
                                   device=self.device)          # unread
        PREPARE_EVENTS["points_pad"] += 1
        self.points_pad = pad_points(index.points_sorted, self.c,
                                     last_coord=last, feats=feats)
        # jaccard: the kernel's packed copy of the candidates' words
        self.words = (pack_words(self.points_pad, self.n_dims, self.n_feat)
                      if self.metric == "jaccard" else None)
        self.order = index.order
        self.dtype = index.points_sorted.dtype
        self.gmin_host = index.grid_min.cpu()
        # eps as a tensor of the points' dtype: host cell coordinates then
        # round as the descriptors' device division does
        self.eps_host = index.eps.cpu()
        PREPARE_EVENTS["class_set"] += 1
        self.classes = capacity_classes(self.c, CAP_ALIGN)
        # per-class tiles clamped to the padding unit: bucket_rows stays
        # the request shapes' contract (multiples of TQ_DEFAULT)
        self.tiles = {cb: min(autotune.fused_tile(
            self.n_dims, cb, backend=self.device.type, metric=self.metric),
            TQ_DEFAULT) for cb in self.classes}
        self.bucketed = len(self.classes) > 1
        self.run_loop = bool(run_loop)
        self.q_pos0: dict = {}   # zeros (qp,) per launch shape

    def _cell_coords(self, q: torch.Tensor) -> np.ndarray:
        """Clipped int64 cell coordinates of host query rows: the same true
        division by eps in the points' dtype as ``grid.cell_coords``."""
        qc = torch.floor((q - self.gmin_host[None, :]) / self.eps_host)
        # clipped in float64: the bound is not a float16 value
        return np.clip(qc.double().numpy(), -_COORD_CLIP,
                       _COORD_CLIP).astype(np.int64)

    def _pad_queries(self, q: torch.Tensor, qc: np.ndarray,
                     feats: Optional[np.ndarray] = None
                     ) -> tuple[torch.Tensor, int]:
        """(Q, n) host queries -> (qp, L) rows on the device, laid out as
        ``points_pad`` rows: the feature rows ``feats`` (jaccard's words)
        in lanes [n, n + n_feat), and for merged sweeps the last-dimension
        cell coordinate (of ``qc``, the rows' ``_cell_coords``) after
        them."""
        qp = bucket_rows(q.shape[0])
        q_pad = torch.zeros((qp, int(self.points_pad.shape[1])),
                            dtype=self.dtype)
        q_pad[: q.shape[0], : self.n_dims] = q
        if feats is not None:
            q_pad[: q.shape[0], self.n_dims:self.n_dims + self.n_feat] = \
                torch.from_numpy(np.asarray(feats)).to(self.dtype)
        if self.merged:
            q_pad[: q.shape[0], self.n_dims + self.n_feat] = \
                torch.from_numpy(qc[:, -1]).to(self.dtype)
        return _to_device(q_pad, self.device), qp

    def _q_pos(self, qp: int) -> torch.Tensor:
        """External queries have no sorted position: cached zeros per
        launch shape."""
        z = self.q_pos0.get(qp)
        if z is None:
            z = torch.zeros(qp, dtype=torch.int32, device=self.device)
            self.q_pos0[qp] = z
        return z

    def _launch_run_ord(self, gid: Optional[np.ndarray], qp_b: int,
                        tile: int) -> torch.Tensor:
        """The run plan of one launch: the rows' cell group ids padded to
        the launch shape with the last id (padding rows join the last run;
        their windows are count 0). ``gid`` is None for an empty batch."""
        if gid is None or not gid.size:
            return self._q_pos(qp_b)   # zeros: one run per tile
        ids = np.full(qp_b, gid[-1], np.int64)
        ids[: gid.size] = gid
        plan = cell_run_plan(torch.from_numpy(ids), tile)
        return _to_device(plan.run_ord.numpy(), self.device)

    def _check_queries(self, queries
                       ) -> tuple[torch.Tensor, Optional[np.ndarray]]:
        """(geometry rows, feature rows or None) of a request: l2 rows as
        they are; a (geometry, features) pair as it is (the batching
        service canonicalizes once, at admission); raw metric input
        canonicalized against the index's form (unit rows for cosine,
        sizes and words packed against the index's vocabulary for
        jaccard)."""
        qf = None
        if self.metric == "l2":
            q = grid_lib.host_points(queries, self.dtype)
        elif isinstance(queries, tuple) and len(queries) == 2:
            qg, qf = queries
            q = grid_lib.host_points(qg, self.dtype)
            qf = None if qf is None else np.asarray(qf)
        else:
            qg, qf = metric_lib.canonicalize_queries(self.canon, queries)
            q = grid_lib.host_points(qg, self.dtype)
        if q.ndim != 2 or q.shape[1] != self.n_dims:
            raise ValueError(f"queries must be (Q, {self.n_dims}), "
                             f"got {tuple(q.shape)}")
        return q, qf

    def launch_inputs(self, queries, *, eps: Optional[float] = None,
                      keep_hits: bool = True):
        """Plan one request without launching: the cell sort, the padded
        queries, the descriptors and the class partition. Returns
        (plan, launches): ``plan`` holds (perm, wc, qp, n_queries, eps) and
        each launch (rows, n_rows, args, kw) with ``args``/``kw`` ready for
        ``ops.fused_join_hits(*args, **kw)`` (jaccard's kernel also takes
        ``words=self.words``, which the request path passes). ``eps`` is in
        metric units (``metric.request_scalar`` maps it onto the kernel
        scalar)."""
        q, qf = self._check_queries(queries)
        if eps is None:
            eps = self.refine
        else:
            eps = metric_lib.request_scalar(
                self.metric, float(eps), index_eps=self.metric_eps,
                index_eps_geom=self.eps)
        n_queries = q.shape[0]
        # one set of cell coordinates feeds the sort and the merged lane
        qc = self._cell_coords(q)
        perm = gid = None
        if self.run_loop and n_queries:
            # stable sort by the clipped cell-coordinate tuple: exact cell
            # identity (a linearized key could alias out-of-grid cells)
            perm = np.lexsort(qc.T)
            q, qc = q[torch.from_numpy(perm)], qc[perm]
            if qf is not None:
                qf = qf[perm]
            head = np.ones(n_queries, bool)
            head[1:] = np.any(qc[1:] != qc[:-1], axis=1)
            gid = np.cumsum(head) - 1      # per-row cell group id
        q_dev, qp = self._pad_queries(q, qc, qf)
        if self.merged:
            ws, wc = _external_range_windows(self.index, self.offsets,
                                             self.lo_off, self.hi_off,
                                             q_dev, n_queries)
        else:
            ws, wc = _external_windows(self.index, self.offsets, q_dev,
                                       n_queries)
        common = dict(n_real=self.n_dims, unicomp=False, external=True,
                      merged=self.merged, keep_hits=keep_hits,
                      run_loop=self.run_loop, metric=self.metric,
                      n_feat=self.n_feat)
        launches = []
        if not self.bucketed:
            tile = self.tiles[self.c]
            ro = (self._launch_run_ord(gid, qp, tile)
                  if self.run_loop else None)
            args = (self.points_pad, q_dev, ws, wc, self.is_zero,
                    self._q_pos(qp), eps)
            launches.append((None, n_queries, args,
                             dict(common, c=self.c, tq=tile, run_ord=ro)))
        else:
            caps = _window_caps(wc)[:n_queries].cpu().numpy()
            caps_aligned = np.minimum(round_up(caps, CAP_ALIGN), self.c)
            cls = np.searchsorted(np.asarray(self.classes), caps_aligned)
            for k, cb in enumerate(self.classes):
                rows = np.flatnonzero((cls == k) & (caps > 0))
                if not rows.size:
                    continue   # empty class (or all-miss rows: counts stay 0)
                tile = self.tiles[cb]
                qp_b = bucket_rows(rows.size, tile)
                sel = np.zeros(qp_b, np.int64)
                sel[: rows.size] = rows
                ws_b, wc_b, q_b = _bucket_select(
                    ws, wc, q_dev, _to_device(sel, self.device), rows.size)
                # rows ascend batch order, so a cell's rows stay contiguous
                ro = (self._launch_run_ord(gid[rows], qp_b, tile)
                      if self.run_loop else None)
                args = (self.points_pad, q_b, ws_b, wc_b, self.is_zero,
                        self._q_pos(qp_b), eps)
                launches.append((rows, rows.size, args,
                                 dict(common, c=cb, tq=tile, run_ord=ro)))
        return (perm, wc, qp, n_queries, eps), launches

    def join_async(self, queries, *, eps: Optional[float] = None,
                   return_pairs: bool = True, sort_pairs: bool = True,
                   emit: Optional[str] = None,
                   with_stats: bool = False) -> PendingJoin:
        """Queue an epsilon join and return without reading anything back:
        query padding, descriptors, every launch, and the counts' copies to
        the host. ``PendingJoin.result()`` waits, emits and assembles.

        The stages run inside ``torch.profiler.record_function`` spans:
        ``query_join.plan`` and ``.kernel`` here, ``.wait`` and ``.emit``
        (the pair emit, the copy to the host and the host assembly) in
        ``result()``."""
        if emit not in (None, "device"):
            raise ValueError(f"emit={emit!r}: the port keeps the device "
                             f"emit only (ROADMAP A4)")
        with record_function("query_join.plan"):
            (perm, wc, qp, n_queries, _), planned = self.launch_inputs(
                queries, eps=eps, keep_hits=return_pairs)
        launches = []
        with record_function("query_join.kernel"):
            for rows, n_rows, args, kw in planned:
                hits, counts, base = ops.fused_join_hits(*args, **kw,
                                                         words=self.words)
                launches.append(_FusedLaunch(
                    rows=rows, n_rows=n_rows,
                    hits=hits if return_pairs else None, counts=counts,
                    base=base, ws=args[2], c=kw["c"], tile=kw["tq"],
                    counts_host=_to_host(counts)))
        return PendingJoin(
            self, launches, wc=wc, qp=qp, n_queries=n_queries,
            return_pairs=return_pairs, sort_pairs=sort_pairs,
            with_stats=with_stats, perm=perm)

    def join(self, queries, *, eps: Optional[float] = None,
             return_pairs: bool = True, sort_pairs: bool = True,
             emit: Optional[str] = None,
             with_stats: bool = False) -> QueryJoinResult:
        """Epsilon join of a query batch against the prepared index.

        ``eps`` is in metric units and defaults to the index's build
        threshold; a request may ask for any threshold the built stencil
        covers (smaller radii for l2, higher similarity floors for cosine
        and jaccard; ``metric.request_scalar`` validates). Counts
        include an indexed point that coincides with a query (external
        queries have no self). On a skewed index the batch is served one
        capacity class at a time; the sorted pair set equals the
        single-capacity launch's. ``join_async`` is the non-blocking half.
        """
        return self.join_async(
            queries, eps=eps, return_pairs=return_pairs,
            sort_pairs=sort_pairs, emit=emit,
            with_stats=with_stats).result()

    def counts(self, queries, *, eps: Optional[float] = None) -> np.ndarray:
        """Counts-only path (no hit plane)."""
        return self.join(queries, eps=eps, return_pairs=False).counts

    def _warm_queries(self, n: int):
        """``n`` raw queries valid for the metric: warm joins go through a
        request's canonicalization, which refuses zero vectors under cosine
        and expects token sets under jaccard."""
        if self.metric == "cosine":
            raw = torch.zeros((n, self.n_dims), dtype=self.dtype)
            raw[:, 0] = 1.0
            return raw
        if self.metric == "jaccard":
            return [() for _ in range(n)]   # empty token sets (size 0)
        return torch.zeros((n, self.n_dims), dtype=self.dtype)

    def warm(self, batch_size: int, *, return_pairs: Optional[bool] = None
             ) -> int:
        """Do off the request path what a first request would otherwise do:
        load the kernel library, fill the index's lazily cached tables, and
        launch every capacity class once (a count-0 launch each), for the
        pair-serving and counts-only sweeps (``return_pairs=None``) or the
        one asked for. There is nothing to compile per request shape.
        Returns the request bucket's padded row count."""
        n = max(int(batch_size), 1)
        variants = ((True, False) if return_pairs is None
                    else (bool(return_pairs),))
        for keep in variants:
            self.join(self._warm_queries(n), return_pairs=keep)
        if self.bucketed:
            for cb in self.classes:
                tile = self.tiles[cb]
                ws = torch.zeros((self.n_offsets, tile), dtype=torch.int32,
                                 device=self.device)
                q_b = torch.zeros((tile, int(self.points_pad.shape[1])),
                                  dtype=self.points_pad.dtype,
                                  device=self.device)
                for keep in variants:
                    ops.fused_join_hits(
                        self.points_pad, q_b, ws, ws, self.is_zero,
                        self._q_pos(tile), self.refine, c=cb,
                        n_real=self.n_dims, unicomp=False, external=True,
                        merged=self.merged, tq=tile, keep_hits=keep,
                        run_ord=self._q_pos(tile) if self.run_loop else None,
                        run_loop=self.run_loop, metric=self.metric,
                        n_feat=self.n_feat, words=self.words)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # REPRO_TORCH_SANITIZE: the class launches are drained here; the
        # JAX package leaves their codes queued (ROADMAP §C, C6)
        sanitize.raise_pending()
        return bucket_rows(n)


def prepare(index: GridIndex, merge_last_dim: Optional[bool] = None,
            run_loop: bool = True,
            canon: Optional[metric_lib.Canonical] = None) -> PreparedJoin:
    """Prepare a grid index for repeated external-query joins.

    ``merge_last_dim`` (default on) serves requests through the 3^(n-1)
    merged-range stencil; ``False`` keeps the per-cell 3^n sweep.
    ``run_loop`` (default on) cell-sorts request batches and runs the
    kernel's run loop; ``False`` keeps the unsorted row loop. ``canon``
    attaches the metric the index was canonicalized for; requests then
    arrive in raw metric form."""
    return PreparedJoin(index, merge_last_dim=merge_last_dim,
                        run_loop=run_loop, canon=canon)


def epsilon_join(queries, points, eps: Optional[float] = None, *,
                 index: Optional[GridIndex] = None,
                 return_pairs: bool = True, sort_pairs: bool = True,
                 emit: Optional[str] = None, with_stats: bool = False,
                 merge_last_dim: Optional[bool] = None,
                 metric: str = "l2", vocab: Optional[int] = None,
                 device=None) -> QueryJoinResult:
    """One-shot external-query epsilon join: the counts and pairs of all
    indexed points within ``eps`` of each query.

    Builds the grid over ``points`` on ``device`` (CUDA by default;
    ``device="cpu"`` runs the plain version) unless ``index`` is given, in
    which case the join runs on the index's device. Services answering
    many requests hold a ``prepare(index)`` object instead.

    ``metric`` "cosine" or "jaccard": ``eps`` is the threshold in metric
    units, ``points`` the raw dataset (or a ready ``metric.Canonical``),
    ``queries`` raw metric input and ``vocab`` the jaccard packing
    vocabulary; the grid is built here over the canonical geometry, so
    ``index`` must be None.
    """
    metric_lib.check_metric(metric)
    if metric != "l2" or isinstance(points, metric_lib.Canonical):
        if index is not None:
            raise ValueError(
                "epsilon_join: pass raw points (or a Canonical), not a "
                "prebuilt index, for non-L2 metrics -- the grid must be "
                "built over the canonical geometry")
        canon = (points if isinstance(points, metric_lib.Canonical)
                 else metric_lib.canonicalize(points, eps, metric=metric,
                                              vocab=vocab))
        idx = build_grid(np.asarray(canon.geom), float(canon.eps_geom),
                         device=device)
        return prepare(idx, merge_last_dim=merge_last_dim, canon=canon).join(
            queries, eps=None, return_pairs=return_pairs,
            sort_pairs=sort_pairs, emit=emit, with_stats=with_stats)
    if index is None:
        index = build_grid(points, float(eps), device=device)
    elif device is not None and (
            grid_lib.resolve_device(device).type != index.device.type):
        raise ValueError(f"index lies on {index.device}, the join was asked "
                         f"to run on {device}")
    return prepare(index, merge_last_dim=merge_last_dim).join(
        queries, eps=eps, return_pairs=return_pairs, sort_pairs=sort_pairs,
        emit=emit, with_stats=with_stats)


def executable_cache_stats() -> dict:
    """What a steady-state request must never redo, as counters: kernel
    libraries built and loaded (``kernels/build.py``), and the prepare-time
    builds (padded points, offset tables, ``external_range_cap`` sweeps,
    class sets). A healthy service shows them constant across requests
    (``launch.serve``'s ``assert_no_retrace``). ``trace_events`` holds the
    serving metrics, which every comparison drops."""
    from repro_torch.kernels import build

    return {
        "kernel_builds": build.EVENTS["builds"],
        "kernel_loads": build.EVENTS["loads"],
        "points_pad": PREPARE_EVENTS["points_pad"],
        "offset_tables": PREPARE_EVENTS["offset_tables"],
        "class_set": PREPARE_EVENTS["class_set"],
        "external_range_cap": grid_lib.BUILD_EVENTS["external_range_cap"],
        "trace_events": dict(TRACE_EVENTS),
    }
