"""GPU brute-force baseline (paper SVI-B): the O(|D|^2) nested-loop join.

The paper runs |D| threads, each comparing its point against all others, to
show that the grid join's gains are not the GPU's raw throughput alone. As
in the JAX package, the sweep goes by tiles of query rows: each step
evaluates a (tile x |D|) block of distances.

``distance_impl`` keeps the JAX package's names so that callers move across
unchanged: ``"jnp"`` is the plain direct-difference PyTorch block,
``sum((q - p)^2) <= eps^2``; ``"pallas"`` is the hand-written tile kernel
(``kernels.ops.distance_tile_hits``, kernel B2 on CUDA tensors, its plain
version on CPU tensors), which computes the expanded form
``(|q|^2 + |p|^2) - 2 q.p`` and so may differ from "jnp" on pairs whose d^2
lies within a few ulps of eps^2.
"""
from __future__ import annotations

import torch

from repro_torch.core import metric as metric_lib
from repro_torch.core.grid import resolve_device
from repro_torch.core.selfjoin import sort_pairs


def _block_hits_jnp(q, pts, eps):
    """(T, n) x (N, n) -> (T, N) bool: ``sum((q - p)^2) <= eps^2``, summed
    lane by lane as the JAX package's ``jnp.sum`` sums it
    (``metric.lane_d2_sum``: in float32 at the half dtypes)."""
    d2 = metric_lib.lane_d2_sum(q, lambda k: pts[None, :, k], q.shape[1])
    return metric_lib.l2_sq_hits(d2, eps)


def _get_impl(name: str):
    if name == "jnp":
        return _block_hits_jnp
    if name == "pallas":
        from repro_torch.kernels.ops import distance_tile_hits

        return distance_tile_hits
    raise ValueError(f"unknown distance_impl {name!r}")


def _points_and_eps(points, eps, device):
    dev = resolve_device(device)
    pts = torch.as_tensor(points).to(dev)
    if pts.ndim != 2:
        raise ValueError(f"points must be (N, n), got {tuple(pts.shape)}")
    return pts, metric_lib.scalar_as(eps, pts.dtype, dev)


def _tile_hits(pts, eps, t: int, tile: int, hits_fn):
    """Masked (tile, N) hits of query rows [t * tile, (t + 1) * tile): rows
    past the end (zero padding in the JAX package) and self pairs are off."""
    npts = pts.shape[0]
    rows = t * tile + torch.arange(tile, device=pts.device)
    q = pts[t * tile:(t + 1) * tile]
    hits = hits_fn(q, pts, eps)
    cols = torch.arange(npts, device=pts.device)
    hits = hits & (rows[:q.shape[0], None] != cols[None, :])
    return hits, rows[:q.shape[0]]


def brute_force_count(points, eps, *, tile: int = 256,
                      distance_impl: str = "jnp", device=None) -> int:
    """Ordered-pair count (excluding self) by exhaustive comparison.
    ``device`` is CUDA by default (``device="cpu"`` runs the plain
    versions), as for every entry point of the port."""
    pts, eps_t = _points_and_eps(points, eps, device)
    hits_fn = _get_impl(distance_impl)
    total = torch.zeros((), dtype=torch.int64, device=pts.device)
    for t in range(-(-pts.shape[0] // tile)):
        hits, _ = _tile_hits(pts, eps_t, t, tile, hits_fn)
        total += hits.sum(dtype=torch.int64)
    return int(total)


def brute_force_join(points, eps, *, tile: int = 256,
                     distance_impl: str = "jnp", device=None) -> torch.Tensor:
    """All ordered pairs (K, 2) int32 by exhaustive comparison, sorted, on
    ``device``. The fill is the JAX package's: per tile, a cursor plus the
    running rank of each hit gives its slot, and a scatter writes it."""
    pts, eps_t = _points_and_eps(points, eps, device)
    hits_fn = _get_impl(distance_impl)
    npts = pts.shape[0]
    n_tiles = -(-npts // tile)
    capacity = brute_force_count(points, eps, tile=tile,
                                 distance_impl=distance_impl,
                                 device=pts.device)
    # misses write the spare slot ``capacity``, which is cut off
    keys = torch.full((capacity + 1,), -1, dtype=torch.int32,
                      device=pts.device)
    vals = torch.full((capacity + 1,), -1, dtype=torch.int32,
                      device=pts.device)
    cols = torch.arange(npts, dtype=torch.int32, device=pts.device)
    cursor = torch.zeros((), dtype=torch.int64, device=pts.device)
    for t in range(n_tiles):
        hits, rows = _tile_hits(pts, eps_t, t, tile, hits_fn)
        flat = hits.reshape(-1)
        rel = torch.cumsum(flat, 0) - 1
        idx = torch.where(flat, cursor + rel, capacity)
        keys.scatter_(0, idx, rows.to(torch.int32)[:, None].expand(hits.shape)
                      .reshape(-1))
        vals.scatter_(0, idx, cols[None, :].expand(hits.shape).reshape(-1))
        cursor = cursor + flat.sum(dtype=torch.int64)
    if int(cursor) != capacity:
        raise RuntimeError(f"brute-force fill wrote {int(cursor)} pairs, "
                           f"the count found {capacity}")
    pairs = torch.stack([keys[:capacity], vals[:capacity]], dim=1)
    return sort_pairs(pairs, max(npts, 1))
