"""Serving driver: a persistent external-query epsilon-join service over a
grid-indexed set, on the card.

    python -m repro_torch.launch.serve --arch selfjoin --points 20000 \\
        --dims 4 --eps 2.0 --requests 8 --request-batch 256

The counterpart of ``repro.launch.serve``'s join services. ``JoinService``
builds the grid index once (paper SIV) and prepares the external-query join
(``core.query_join``): the offset tables and the padded points copy are
made at start-up and every request only pads its queries, computes window
descriptors and launches the fused kernel. The driver warms the service,
reports p50/p99 latency and requests/s over the steady-state window, and
exits non-zero if a steady-state request built or loaded a kernel library
or redid a prepare-time build (``assert_no_retrace``).

``BatchingJoinService`` coalesces queued requests of one epsilon into
single launches of up to ``max_batch`` queries, with up to two batches in
flight. Everything runs on the current stream of the index's device, so no
tensor crosses streams.

``ShardedJoinService`` (and ``BatchingJoinService(n_slabs > 1)``,
``--slabs`` on the command line) cuts the indexed set into the slab join's
equal-count slabs, each with its own index on the service's device; a
request goes to every slab and the answers merge into the single index's.
Like the JAX package's, these services run in one process on one device.

The services take ``metric="cosine" | "jaccard"`` (``--metric`` on the
command line): the index is built over the canonical geometry and requests
arrive as raw embeddings or token sets, with thresholds in metric units.

Not ported yet, raising and naming its ROADMAP item: ``--arch`` other than
``selfjoin`` (the LM decode service, A17).
"""
from __future__ import annotations

import argparse
import collections
import threading
import time
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import metric as metric_lib
from repro_torch.core.distributed import partition_points_host
from repro_torch.core.grid import build_grid, host_points, resolve_device
from repro_torch.core.query_join import (QueryJoinResult, bucket_rows,
                                         coalesce_requests,
                                         executable_cache_stats, metric_free,
                                         note_metric, note_metric_peak,
                                         prepare, slice_result)


def _counters(stats: dict) -> dict:
    """The counters ``assert_no_retrace`` holds still: every entry of
    ``executable_cache_stats`` but the serving metrics."""
    out = {k: v for k, v in stats.items() if k != "trace_events"}
    out.update(metric_free(stats["trace_events"]))
    return out


class _JoinServiceBase:
    """Serving-side bookkeeping shared by the services: steady-state latency
    percentiles, and a watchdog (``assert_no_retrace``) over the work a
    steady-state request must never redo.

    Latency samples taken before ``mark_steady`` land in
    ``warmup_latencies_ms`` and are excluded from ``percentiles`` /
    ``requests_per_sec``; every ``warmup()`` marks steady (with a warning)
    if the caller has not.
    """

    def __init__(self, return_pairs: bool = False):
        self.return_pairs = return_pairs
        self.latencies_ms: list[float] = []        # steady-state window
        self.warmup_latencies_ms: list[float] = []  # pre-steady samples
        self.total_neighbors = 0
        self.requests = 0
        self._steady = False
        self._warm_buckets: set[int] = set()
        self._cache_mark: Optional[dict] = None
        # counters moved off the request path since the mark (reindex)
        self._offpath: collections.Counter = collections.Counter()

    def _answer(self, queries: np.ndarray, eps: Optional[float]):
        raise NotImplementedError

    def mark_steady(self) -> None:
        """Snapshot the counters; later requests must not move them, and
        later latency samples enter the steady-state window."""
        self._steady = True
        self._cache_mark = _counters(executable_cache_stats())
        self._offpath.clear()

    def _auto_steady(self) -> None:
        """Called by ``warmup()``: enter steady state if the caller has not
        done so (with a warning, so warm-up latencies never mix in)."""
        if not self._steady:
            warnings.warn(
                "mark_steady() was never called; auto-marking steady "
                "after warmup() so reported stats exclude the warmup "
                "window", stacklevel=3)
            self.mark_steady()

    def query(self, queries: np.ndarray, *, eps: Optional[float] = None):
        """Answer one request; records its latency in the steady or warm-up
        window depending on ``mark_steady``."""
        t0 = time.perf_counter()
        res = self._answer(queries, eps)
        dt_ms = 1000 * (time.perf_counter() - t0)
        (self.latencies_ms if self._steady
         else self.warmup_latencies_ms).append(dt_ms)
        self.requests += 1
        self.total_neighbors += res.total
        return res

    def _steady_window(self) -> list[float]:
        if self.latencies_ms:
            return self.latencies_ms
        if self.warmup_latencies_ms:
            warnings.warn(
                "no steady-state samples recorded (mark_steady/warmup "
                "never ran before queries); falling back to the warmup "
                "window -- stats include start-up work", stacklevel=3)
            return self.warmup_latencies_ms
        return []

    def percentiles(self) -> tuple[float, float]:
        lat = np.asarray(self._steady_window())
        return (float(np.percentile(lat, 50)), float(np.percentile(lat, 99)))

    def requests_per_sec(self) -> float:
        win = self._steady_window()
        total_s = sum(win) / 1000
        return len(win) / total_s if total_s > 0 else float("inf")

    def assert_no_retrace(self) -> None:
        """Raise if any request since ``mark_steady`` built or loaded a
        kernel library or redid a prepare-time build. The serving metrics
        are exempt (they move per request), and so is what this service's
        ``reindex`` built off the request path. The counters are
        process-wide, as the JAX package's executable caches are: a service
        prepared after another marked steady moves them too."""
        if self._cache_mark is None:
            return
        now = _counters(executable_cache_stats())
        want = {k: v + self._offpath[k] for k, v in self._cache_mark.items()}
        if now != want:
            raise RuntimeError(
                "serve path redid start-up work during steady state: "
                f"{want} -> {now}")


class JoinService(_JoinServiceBase):
    """Persistent epsilon-join service: index once, answer many requests.

    The serving state is one snapshot tuple ``(index, prepared)``:
    ``reindex`` rebuilds both in a background thread and swaps them with a
    single reference assignment, so every request sees the old snapshot or
    the new one, never a mix.

    ``metric`` "cosine" or "jaccard" canonicalizes ``points`` (raw
    embeddings, or token sets / a binary matrix with ``vocab``) and builds
    the index over the canonical geometry; ``eps`` and request thresholds
    are then in metric units, and ``index`` must be None.
    """

    def __init__(self, points: np.ndarray, eps: float, *, index=None,
                 return_pairs: bool = False,
                 merge_last_dim: Optional[bool] = None,
                 metric: str = "l2", vocab: Optional[int] = None,
                 device=None):
        super().__init__(return_pairs)
        metric_lib.check_metric(metric)
        self.metric = metric
        self.vocab = vocab
        self.eps = float(eps)          # in metric units throughout
        self.merge_last_dim = merge_last_dim
        t0 = time.perf_counter()
        canon = None
        if metric != "l2":
            if index is not None:
                raise ValueError(
                    "JoinService: non-L2 metrics build their own index "
                    "over the canonical geometry; pass raw points")
            canon = metric_lib.canonicalize(points, eps, metric=metric,
                                            vocab=vocab)
            index = build_grid(np.asarray(canon.geom), float(canon.eps_geom),
                               device=resolve_device(device))
        elif index is None:
            index = build_grid(points, self.eps,
                               device=resolve_device(device))
        self.device = index.device
        prepared = prepare(index, merge_last_dim=merge_last_dim, canon=canon)
        self._snapshot = (index, prepared)
        self.build_s = time.perf_counter() - t0
        self.swaps = 0
        self.reindex_timings: Optional[dict] = None
        self._reindex_thread: Optional[threading.Thread] = None
        self._reindex_error: Optional[BaseException] = None

    @property
    def index(self):
        return self._snapshot[0]

    @property
    def prepared(self):
        return self._snapshot[1]

    def warmup(self, batch_size: int) -> int:
        """Do the start-up work of ``batch_size``-query requests off the
        request path (``PreparedJoin.warm``). Returns the request bucket's
        padded row count."""
        qp = bucket_rows(batch_size)
        if qp not in self._warm_buckets:
            self.prepared.warm(batch_size, return_pairs=self.return_pairs)
            self._warm_buckets.add(qp)
        self._auto_steady()
        return qp

    def reindex(self, points: np.ndarray, *, wait: bool = True) -> None:
        """Rebuild the index over ``points`` and swap the serving snapshot.

        Build, prepare and warm-up run in a background thread on the
        device's current stream; requests keep being answered from the old
        snapshot until the device has finished the build and the single
        ``_snapshot`` assignment swaps it. ``wait=False`` returns at once;
        ``join_reindex`` (or the next ``reindex``) surfaces errors.
        """
        if self._reindex_thread is not None and self._reindex_thread.is_alive():
            raise RuntimeError("reindex already in progress")
        self.join_reindex()          # surface a previous failure, if any
        # non-L2 input may be ragged (token sets); canonicalized in the thread
        pts = (np.asarray(points) if self.metric == "l2"
               and not isinstance(points, torch.Tensor) else points)

        def work():
            try:
                before = _counters(executable_cache_stats())
                t0 = time.perf_counter()
                canon = None
                if self.metric != "l2":
                    canon = metric_lib.canonicalize(
                        pts, self.eps, metric=self.metric, vocab=self.vocab)
                    geom, eps_geom = np.asarray(canon.geom), canon.eps_geom
                else:
                    geom, eps_geom = pts, self.eps
                index = build_grid(geom, float(eps_geom), device=self.device)
                self._sync()
                t1 = time.perf_counter()
                prepared = prepare(index, merge_last_dim=self.merge_last_dim,
                                   canon=canon)
                t2 = time.perf_counter()
                for qp in sorted(self._warm_buckets):
                    prepared.warm(qp, return_pairs=self.return_pairs)
                self._sync()         # the new snapshot is complete
                t3 = time.perf_counter()
                after = _counters(executable_cache_stats())
                self._snapshot = (index, prepared)   # the swap
                self._offpath.update({k: after[k] - before.get(k, 0)
                                      for k in after})
                self.swaps += 1
                self.reindex_timings = {
                    "build_s": t1 - t0, "plan_s": t2 - t1,
                    "warm_s": t3 - t2,
                    "swap_s": time.perf_counter() - t3}
            except BaseException as e:   # noqa: BLE001 -- surfaced in caller
                self._reindex_error = e

        th = threading.Thread(target=work, name="join-reindex", daemon=True)
        self._reindex_thread = th
        th.start()
        if wait:
            self.join_reindex()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def join_reindex(self) -> None:
        """Block until any in-flight reindex has swapped; re-raise its
        error in the caller's thread if it failed."""
        th = self._reindex_thread
        if th is not None:
            th.join()
        if self._reindex_error is not None:
            err, self._reindex_error = self._reindex_error, None
            raise RuntimeError("background reindex failed") from err

    def _answer(self, queries: np.ndarray, eps: Optional[float] = None):
        return self.prepared.join(queries, eps=eps,
                                  return_pairs=self.return_pairs)


def _prepare_slabs(points, eps: float, n_slabs: int, canon, merge_last_dim,
                   device):
    """(slab gids, indexes, prepared joins) of the slab-sharded services:
    the slab join's equal-count partition along dimension 0
    (``partition_points_host``), and one grid and ``PreparedJoin`` on
    ``device`` for each non-empty slab. A metric's slabs cut its canonical
    form (``canon``, made once over the whole set); l2 points keep their
    dtype (bfloat16 sorts as its exact float32 copy)."""
    if canon is not None:
        pts = key = np.asarray(canon.geom)
    else:
        pts = (points.detach().cpu() if isinstance(points, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(np.asarray(points))))
        key = (pts.float() if pts.dtype == torch.bfloat16 else pts).numpy()
    _, slabs, _ = partition_points_host(key, n_slabs)
    eps_geom = float(eps if canon is None else canon.eps_geom)
    gids, indexes, prepared = [], [], []
    for sg in slabs:
        sg = sg[sg >= 0]
        if not sg.size:
            continue                      # an empty slab: nothing to index
        slab_canon = None
        if canon is None:
            slab_pts = pts[torch.from_numpy(sg).long()]
        else:
            slab_pts = pts[sg]
            slab_canon = metric_lib.Canonical(
                canon.metric, slab_pts,
                None if canon.feats is None else canon.feats[sg],
                canon.n_feat, canon.eps, canon.eps_geom, canon.vocab)
        index = build_grid(slab_pts, eps_geom, device=device)
        gids.append(sg)
        indexes.append(index)
        prepared.append(prepare(index, merge_last_dim=merge_last_dim,
                                canon=slab_canon))
    return gids, indexes, prepared


class ShardedJoinService(_JoinServiceBase):
    """Slab-sharded epsilon-join service.

    The indexed set is cut into the slab join's equal-count slabs along
    dimension 0 (``core.distributed.partition_points_host``); each
    non-empty slab holds its own grid index and ``PreparedJoin`` on the
    service's device, built once. A request goes to every slab (a query
    near a boundary has neighbours on both sides): every slab's launches
    are queued (``join_async``) before any result is read, counts sum and
    pair point ids map through each slab's global-id table, so the answer
    equals the single-index service's. Every indexed point lives in one
    slab, so no pair is found twice. ``warmup`` does every slab's start-up
    work; the watchdog (``assert_no_retrace``) is the base class's.

    ``metric`` / ``vocab`` as in ``JoinService``: the set is canonicalized
    once, the slabs cut its canonical geometry, and a request is
    canonicalized once for all slabs.
    """

    def __init__(self, points, eps: float, n_slabs: int, *,
                 return_pairs: bool = False,
                 merge_last_dim: Optional[bool] = None,
                 metric: str = "l2", vocab: Optional[int] = None,
                 device=None):
        super().__init__(return_pairs)
        metric_lib.check_metric(metric)
        self.metric = metric
        self.eps = float(eps)          # in metric units
        self._query_canon = None
        if metric != "l2":
            self._query_canon = metric_lib.canonicalize(
                points, eps, metric=metric, vocab=vocab)
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        self.slab_gids, self.indexes, self.prepared = _prepare_slabs(
            points, self.eps, n_slabs, self._query_canon, merge_last_dim,
            self.device)
        self.n_slabs = n_slabs
        self.build_s = time.perf_counter() - t0

    def warmup(self, batch_size: int) -> int:
        """``JoinService.warmup`` for every slab."""
        qp = bucket_rows(batch_size)
        if qp not in self._warm_buckets:
            for pj in self.prepared:
                pj.warm(batch_size, return_pairs=self.return_pairs)
            self._warm_buckets.add(qp)
        self._auto_steady()
        return qp

    def _answer(self, queries, eps: Optional[float] = None):
        # a raw metric request is canonicalized once, not once a slab
        if self._query_canon is not None:
            queries = metric_lib.canonicalize_queries(self._query_canon,
                                                      queries)
        pendings = [pj.join_async(queries, eps=eps,
                                  return_pairs=self.return_pairs,
                                  sort_pairs=False)
                    for pj in self.prepared]
        return _merge_slab_results([p.result() for p in pendings],
                                   self.slab_gids, self.return_pairs)


def _merge_slab_results(results, slab_gids, return_pairs: bool):
    """The single index's answer from the slabs' answers: counts sum, pair
    point ids map through each slab's global-id table, and the merged
    pairs sort by (query row, point id)."""
    counts = None
    chunks = []
    bucket = n_off = 0
    emit = None
    for res, sg in zip(results, slab_gids):
        counts = res.counts if counts is None else counts + res.counts
        bucket, n_off, emit = res.bucket_rows, res.n_offsets, res.emit
        if return_pairs and res.pairs.shape[0]:
            p = res.pairs.copy()
            p[:, 1] = sg[p[:, 1]]             # slab point id -> global id
            chunks.append(p)
    pairs = None
    if return_pairs:
        pairs = (np.concatenate(chunks, axis=0) if chunks
                 else np.empty((0, 2), np.int32))
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    return QueryJoinResult(
        counts=counts, pairs=pairs, n_offsets=n_off, bucket_rows=bucket,
        emit=emit, candidates_checked=None)


class BatchTicket:
    """Handle for one submitted request: completes when every part of the
    request (a request wider than ``max_batch`` is split) has been sliced
    out of its coalesced launch."""

    def __init__(self, n_parts: int, n_queries: int):
        self.n_parts = n_parts
        self.n_queries = n_queries
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None
        self._parts: dict = {}

    def done(self) -> bool:
        return len(self._parts) == self.n_parts

    def _add_part(self, part: int, res) -> None:
        self._parts[part] = res
        if self.done() and self.t_done is None:
            self.t_done = time.perf_counter()

    def result(self):
        """The request's QueryJoinResult, identical to serving it alone
        (parts concatenate back in submission order; pair query rows of
        part k rebase by the rows of parts before it)."""
        if not self.done():
            raise RuntimeError(
                f"ticket incomplete: {len(self._parts)}/{self.n_parts} "
                f"parts resolved (call service.drain() first)")
        parts = [self._parts[i] for i in range(self.n_parts)]
        if len(parts) == 1:
            return parts[0]
        counts = np.concatenate([p.counts for p in parts])
        pairs = None
        if parts[0].pairs is not None:
            chunks = []
            row0 = 0
            for p in parts:
                q = p.pairs.copy()
                q[:, 0] += row0
                chunks.append(q)
                row0 += p.counts.shape[0]
            pairs = np.concatenate(chunks, axis=0)
        return QueryJoinResult(
            counts=counts, pairs=pairs, n_offsets=parts[0].n_offsets,
            bucket_rows=parts[0].bucket_rows, emit=parts[0].emit,
            candidates_checked=None)

    def latency_ms(self) -> float:
        if self.t_done is None:
            raise RuntimeError("ticket not complete")
        return 1000 * (self.t_done - self.t_submit)


class _Sub:
    """One admission-queue entry: a request part awaiting coalescing."""

    __slots__ = ("queries", "eps_key", "ticket", "part", "t_arrival")

    def __init__(self, queries, eps_key, ticket, part):
        self.queries = queries
        self.eps_key = eps_key
        self.ticket = ticket
        self.part = part
        self.t_arrival = time.perf_counter()


class _Inflight:
    """A launched coalesced batch whose device results are outstanding:
    one pending join a slab."""

    __slots__ = ("pendings", "subs", "bounds")

    def __init__(self, pendings, subs, bounds):
        self.pendings = pendings
        self.subs = subs
        self.bounds = bounds


class BatchingJoinService(_JoinServiceBase):
    """Continuous-batching epsilon-join service.

    Requests from independent callers enter an admission queue (``submit``)
    and are coalesced, first in first out and of one epsilon, into single
    launches of up to ``max_batch`` queries, so the per-launch overhead that
    dominates small requests is shared across callers. A flushed batch is
    queued through ``join_async`` and resolved later: up to two batches stay
    in flight, so the host assembles batch k+1 while the card runs batch k.
    Each request's answer is sliced back out of the coalesced result by its
    query rows (``slice_result``) and equals serving it alone. A request
    wider than ``max_batch`` splits into parts; an empty request completes
    at once. ``n_slabs > 1`` serves from ``ShardedJoinService``'s slabs:
    each launch goes to every slab, and the slabs' answers merge before
    the requests are sliced out (``index`` is then not used).

    ``metric`` / ``vocab`` as in ``JoinService``; a request is
    canonicalized once, at admission, and its geometry and feature rows
    coalesce as one 2-D array.
    """

    def __init__(self, points: np.ndarray, eps: float, *, index=None,
                 n_slabs: int = 1, return_pairs: bool = False,
                 merge_last_dim: Optional[bool] = None,
                 max_batch: int = 1024, max_wait_ms: float = 2.0,
                 metric: str = "l2", vocab: Optional[int] = None,
                 device=None):
        super().__init__(return_pairs)
        metric_lib.check_metric(metric)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.metric = metric
        self.eps = float(eps)          # in metric units
        # the canonical form requests are canonicalized against
        self._query_canon = None
        if metric != "l2":
            if index is not None:
                raise ValueError(
                    "BatchingJoinService: non-L2 metrics build their own "
                    "index over the canonical geometry; pass raw points")
            self._query_canon = metric_lib.canonicalize(
                points, eps, metric=metric, vocab=vocab)
        t0 = time.perf_counter()
        qc = self._query_canon
        if n_slabs > 1:
            self.slab_gids, self.indexes, self.prepared = _prepare_slabs(
                points, self.eps, n_slabs, qc, merge_last_dim,
                resolve_device(device))
        else:
            if qc is not None:
                index = build_grid(np.asarray(qc.geom), float(qc.eps_geom),
                                   device=resolve_device(device))
            elif index is None:
                index = build_grid(points, self.eps,
                                   device=resolve_device(device))
            self.slab_gids = None
            self.indexes = [index]
            self.prepared = [prepare(index, merge_last_dim=merge_last_dim,
                                     canon=qc)]
        self.n_slabs = len(self.prepared)
        self.build_s = time.perf_counter() - t0
        self._queue: deque[_Sub] = deque()
        self._queued_rows = 0
        self._inflight: deque[_Inflight] = deque()
        self.n_launches = 0
        self.n_coalesced = 0
        self.rows_launched = 0

    # -- admission ---------------------------------------------------------

    def submit(self, queries: np.ndarray, *,
               eps: Optional[float] = None) -> BatchTicket:
        """Enqueue one request; returns a ticket that completes once every
        part has been served from a coalesced launch (``pump``/``drain``
        advance the pipeline). Does not block."""
        pj = self.prepared[0]
        if self.metric != "l2":
            # canonicalized once per request, at admission: geometry and
            # feature rows coalesce as one 2-D array and split at launch
            qg, qf = metric_lib.canonicalize_queries(self._query_canon,
                                                     queries)
            q = host_points(qg, pj.dtype)
            if qf is not None:
                q = torch.cat([q, host_points(qf, pj.dtype)], dim=1)
        else:
            q = host_points(queries, pj.dtype)
            if q.ndim != 2 or q.shape[1] != pj.n_dims:
                raise ValueError(f"queries must be (Q, {pj.n_dims}), "
                                 f"got {tuple(q.shape)}")
        eps_key = float(self.eps if eps is None else eps)
        n = q.shape[0]
        if n == 0:
            t = BatchTicket(1, 0)
            t._add_part(0, QueryJoinResult(
                counts=np.zeros(0, np.int32),
                pairs=(np.empty((0, 2), np.int32) if self.return_pairs
                       else None),
                n_offsets=pj.n_offsets, bucket_rows=0, emit=None,
                candidates_checked=None))
            return t
        parts = [q[i:i + self.max_batch]
                 for i in range(0, n, self.max_batch)]
        ticket = BatchTicket(len(parts), n)
        for i, p in enumerate(parts):
            self._queue.append(_Sub(p, eps_key, ticket, i))
            self._queued_rows += p.shape[0]
        note_metric_peak("batch.queue_depth_peak", len(self._queue))
        return ticket

    # -- pipeline ----------------------------------------------------------

    def _flush_due(self, now: float) -> bool:
        if not self._queue:
            return False
        if self._queued_rows >= self.max_batch:
            return True
        return 1000 * (now - self._queue[0].t_arrival) >= self.max_wait_ms

    def _form_group(self) -> list[_Sub]:
        """Pop the next coalesced batch off the queue: from the head, of
        the head's epsilon (one threshold per launch), up to ``max_batch``
        rows. Skipped entries keep their queue position."""
        head_eps = self._queue[0].eps_key
        group: list[_Sub] = []
        rows = 0
        keep: list[_Sub] = []
        while self._queue:
            sub = self._queue.popleft()
            if (sub.eps_key == head_eps
                    and rows + sub.queries.shape[0] <= self.max_batch):
                group.append(sub)
                rows += sub.queries.shape[0]
            else:
                keep.append(sub)
        self._queue.extendleft(reversed(keep))
        self._queued_rows -= rows
        return group

    def _launch(self, group: list[_Sub]) -> None:
        qcat, bounds = coalesce_requests([s.queries for s in group])
        pj = self.prepared[0]
        qsend = qcat
        if self.metric != "l2":
            # the (geometry, features) pair join_async takes as it is
            qsend = (qcat[:, :pj.n_dims],
                     qcat[:, pj.n_dims:] if pj.n_feat else None)
        # every slab's launches are queued before any result is read; a
        # single index sorts its pairs, slabs sort once merged
        pendings = [p.join_async(qsend, eps=group[0].eps_key,
                                 return_pairs=self.return_pairs,
                                 sort_pairs=self.slab_gids is None)
                    for p in self.prepared]
        self._inflight.append(_Inflight(pendings, group, bounds))
        self.n_launches += 1
        self.n_coalesced += len(group)
        self.rows_launched += qcat.shape[0]
        note_metric("batch.launches")
        note_metric("batch.coalesced_requests", len(group))
        note_metric("batch.rows", qcat.shape[0])

    def _resolve_oldest(self) -> None:
        infl = self._inflight.popleft()
        if self.slab_gids is None:
            res = infl.pendings[0].result()
        else:
            res = _merge_slab_results([p.result() for p in infl.pendings],
                                      self.slab_gids, self.return_pairs)
        for k, sub in enumerate(infl.subs):
            part = slice_result(res, int(infl.bounds[k]),
                                int(infl.bounds[k + 1]))
            sub.ticket._add_part(sub.part, part)
            self.total_neighbors += part.total

    def pump(self) -> None:
        """Advance the pipeline without blocking on admission: launch every
        due batch (oldest waiter past ``max_wait_ms``, or ``max_batch`` rows
        queued), then resolve in-flight batches while their device work is
        already done, and forcibly beyond a depth of two."""
        now = time.perf_counter()
        while self._flush_due(now):
            self._launch(self._form_group())
        while self._inflight and (len(self._inflight) > 2
                                  or all(p.ready() for p
                                         in self._inflight[0].pendings)):
            self._resolve_oldest()

    def drain(self) -> None:
        """Flush and resolve everything: every ticket issued before the
        call is complete afterwards."""
        while self._queue:
            self._launch(self._form_group())
        while self._inflight:
            self._resolve_oldest()

    # -- service interface -------------------------------------------------

    @property
    def coalesce_factor(self) -> float:
        """Mean requests per launch (1.0 = batching is a no-op)."""
        return self.n_coalesced / self.n_launches if self.n_launches else 0.0

    def warmup(self, batch_size: Optional[int] = None) -> int:
        """Do the start-up work of every batch size the coalescer can form,
        up to ``max_batch`` rows, off the request path. ``batch_size`` is
        accepted for interface parity and ignored: the coalescer may fill a
        group to ``max_batch`` rows whatever the request sizes. Returns the
        top bucket's padded row count."""
        top = bucket_rows(self.max_batch)
        s = bucket_rows(1)
        while s <= top:
            if s not in self._warm_buckets:
                for pj in self.prepared:
                    pj.warm(s, return_pairs=self.return_pairs)
                self._warm_buckets.add(s)
            s *= 2
        self._auto_steady()
        return top

    def _answer(self, queries: np.ndarray, eps: Optional[float] = None):
        # synchronous convenience path: admit, drain, slice
        ticket = self.submit(queries, eps=eps)
        self.drain()
        return ticket.result()


def _metric_workload(args, rng):
    """(points, eps, make_queries) for the service smoke, per metric: the
    uniform box for l2; random embeddings at a similarity floor for cosine;
    random binary token matrices over 64 tokens at a Jaccard floor for
    jaccard ((Q, V) matrices, 2-D, as the batching coalescer takes)."""
    metric_lib.check_metric(args.metric)
    if args.metric == "cosine":
        eps = args.eps if -1.0 <= args.eps < 1.0 else 0.9
        if eps != args.eps:
            print(f"[serve] --eps {args.eps} is not a cosine similarity; "
                  f"using {eps}")
        pts = rng.normal(size=(args.points, args.dims))
        return pts, eps, lambda n: rng.normal(size=(n, args.dims))
    if args.metric == "jaccard":
        eps = args.eps if 0.0 < args.eps <= 1.0 else 0.5
        if eps != args.eps:
            print(f"[serve] --eps {args.eps} is not a jaccard threshold; "
                  f"using {eps}")
        vocab = 64
        pts = (rng.random((args.points, vocab)) < 0.1).astype(np.float32)
        return pts, eps, lambda n: (
            rng.random((n, vocab)) < 0.1).astype(np.float32)
    pts = rng.uniform(0, 100, size=(args.points, args.dims))
    return pts, args.eps, lambda n: rng.uniform(0, 100, size=(n, args.dims))


def serve_selfjoin(args):
    rng = np.random.default_rng(args.seed)
    pts, eps, make_queries = _metric_workload(args, rng)
    device = resolve_device(args.device)
    if args.batching:
        svc = BatchingJoinService(
            pts, eps, n_slabs=args.slabs, return_pairs=args.return_pairs,
            merge_last_dim=not args.no_merge, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, metric=args.metric, device=device)
        print(f"[serve] batching service on {device}: {args.points} pts, "
              f"{svc.n_slabs} slab(s), max_batch={svc.max_batch}, "
              f"max_wait={svc.max_wait_ms}ms "
              f"(indexed in {svc.build_s:.3f}s)")
    elif args.slabs > 1:
        svc = ShardedJoinService(pts, eps, args.slabs,
                                 return_pairs=args.return_pairs,
                                 merge_last_dim=not args.no_merge,
                                 metric=args.metric, device=device)
        sweep = "merged-range" if svc.prepared[0].merged else "per-cell"
        cells = sum(int(i.num_cells) for i in svc.indexes)
        print(f"[serve] indexed {args.points} pts on {device} across "
              f"{len(svc.prepared)} slabs in {svc.build_s:.3f}s "
              f"(metric={args.metric}, |G|={cells} non-empty cells in all, "
              f"{sweep} sweep)")
    else:
        svc = JoinService(pts, eps, return_pairs=args.return_pairs,
                          merge_last_dim=not args.no_merge,
                          metric=args.metric, device=device)
        sweep = "merged-range" if svc.prepared.merged else "per-cell"
        print(f"[serve] indexed {args.points} pts on {device} in "
              f"{svc.build_s:.3f}s (metric={args.metric}, "
              f"|G|={int(svc.index.num_cells)} "
              f"non-empty cells, C={svc.prepared.c}, "
              f"{svc.prepared.n_offsets} {sweep} stencil offsets)")
    t0 = time.perf_counter()
    qp = svc.warmup(args.request_batch)   # auto-marks steady (warns)
    print(f"[serve] warmed bucket {qp} rows in "
          f"{time.perf_counter() - t0:.3f}s (off the request path)")
    if args.batching:
        tickets = [svc.submit(make_queries(args.request_batch))
                   for _ in range(args.requests)]
        t0 = time.perf_counter()
        svc.pump()
        svc.drain()
        wall = time.perf_counter() - t0
        svc.latencies_ms = [t.latency_ms() for t in tickets]
        svc.requests = len(tickets)
        p50, p99 = svc.percentiles()
        print(f"[serve] {args.requests} requests x {args.request_batch} "
              f"queries coalesced into {svc.n_launches} launches "
              f"(coalesce factor {svc.coalesce_factor:.1f}): "
              f"p50 {p50:.1f}ms p99 {p99:.1f}ms "
              f"{len(tickets) / wall:.1f} req/s")
    else:
        for r in range(args.requests):
            if args.reindex and r == args.requests // 2:
                # mid-load re-index of the same points, permuted: a
                # background build and one snapshot swap, off the request
                # path, so the watchdog below must stay green
                svc.reindex(rng.permutation(pts), wait=True)
                t = svc.reindex_timings
                print(f"[serve] reindexed {args.points} pts mid-load: "
                      f"build {t['build_s'] * 1000:.1f}ms "
                      f"plan {t['plan_s'] * 1000:.1f}ms "
                      f"warm {t['warm_s'] * 1000:.1f}ms "
                      f"swap {t['swap_s'] * 1e6:.0f}us "
                      f"(snapshot swaps: {svc.swaps})")
            svc.query(make_queries(args.request_batch))
        p50, p99 = svc.percentiles()
        print(f"[serve] {args.requests} requests x {args.request_batch} "
              f"queries{' (+pairs)' if args.return_pairs else ''}: "
              f"p50 {p50:.1f}ms p99 {p99:.1f}ms "
              f"{svc.requests_per_sec():.1f} req/s "
              f"({svc.total_neighbors} neighbors found)")
    svc.assert_no_retrace()   # regression gate: steady state redoes nothing
    print("[serve] no-rebuild check passed: steady-state requests built, "
          "loaded and prepared nothing")
    return p50


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="selfjoin")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the service runs: CUDA by default; 'cpu' "
                         "runs the kernels' plain versions")
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--dims", type=int, default=4)
    ap.add_argument("--eps", type=float, default=2.0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--request-batch", type=int, default=256)
    ap.add_argument("--return-pairs", action="store_true",
                    help="materialize neighbor pairs per request, not "
                         "just counts")
    ap.add_argument("--metric", default="l2",
                    choices=("l2", "cosine", "jaccard"),
                    help="similarity metric: --eps is then a minimum "
                         "cosine or Jaccard similarity")
    ap.add_argument("--no-merge", action="store_true",
                    help="serve through the per-cell 3^n stencil instead "
                         "of the merged-range 3^(n-1) sweep")
    ap.add_argument("--slabs", type=int, default=1,
                    help="slab-sharded serving: the indexed set cut into "
                         "this many equal-count slabs along dimension 0")
    ap.add_argument("--reindex", action="store_true",
                    help="re-index a permutation of the point set halfway "
                         "through the request loop (background build and "
                         "snapshot swap; the watchdog must stay green)")
    ap.add_argument("--batching", action="store_true",
                    help="serve through the continuous-batching admission "
                         "queue (BatchingJoinService)")
    ap.add_argument("--max-batch", type=int, default=1024,
                    help="coalesced launch budget in query rows")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="admission-queue flush deadline for the oldest "
                         "waiting request")
    args = ap.parse_args(argv)
    if args.arch != "selfjoin":
        raise NotImplementedError(f"--arch {args.arch}: the LM services are "
                                  f"not ported yet (ROADMAP A17)")
    if args.reindex and (args.batching or args.slabs > 1):
        raise SystemExit("--reindex needs the single-index service (no "
                         "--slabs/--batching)")
    return serve_selfjoin(args)


if __name__ == "__main__":
    main()
