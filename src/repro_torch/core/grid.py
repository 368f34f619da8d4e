"""The epsilon-grid index of paper SIV, in PyTorch.

The index has four parts (paper Fig. 2a):
    A   point ids grouped by grid cell           (``order``)
    G   per non-empty cell, its range into A     (``cell_start``/``cell_count``)
    B   sorted linear ids of the non-empty cells (``cell_keys``)
    and the geometry: ``grid_min``, ``eps``, ``dims``.

Geometry is fixed on the host with exact numpy arithmetic
(``host_grid_geometry``); keys, the stable sort and the segment scan run on
the index's device. Every field equals the JAX package's
``repro.core.grid.build_grid_host`` on the same input, value and dtype.

Torch differs from JAX in ways that change answers without an error, and
this module guards each one:

  * ``jnp.searchsorted`` promotes int32 keys and int64 probes to int64;
    ``torch.searchsorted`` wants one dtype, so both sides are int64 here.
  * ``.at[idx].set(..., mode="drop")`` has no torch counterpart: dropped
    writes are sent to one spare slot past the end, which is then cut off.
  * On CUDA, dividing a tensor by a Python float multiplies by its
    reciprocal. Cell coordinates divide by a tensor instead, so they round
    as numpy's true division does.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.metric import FLOAT_DTYPES, scalar_as
from repro_torch.core.stencil import merged_stencil_offsets, stencil_offsets

_TORCH_DTYPES = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
}
_NUMPY_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch version on the CPU")
    return dev


def key_dtype_for(dims) -> np.dtype:
    """Narrowest safe cell-key dtype: int32 when ``prod(dims) < 2^31``,
    else int64. Exact Python-int arithmetic, so a 6-D volume cannot wrap."""
    volume = 1
    for d in np.asarray(dims).ravel():
        volume *= int(d)
    return np.dtype(np.int32) if volume < 2**31 else np.dtype(np.int64)


def pad_key_for(dtype) -> int:
    """Padding and miss sentinel of a key array of ``dtype``: its max."""
    return int(np.iinfo(np.dtype(dtype)).max)


def sentinel_margin(dims, key_dtype=None) -> int:
    """``pad_key_for`` sentinel minus the largest possible real key, in
    exact Python ints. Positive means the sentinel never aliases a cell."""
    if key_dtype is None:
        key_dtype = key_dtype_for(dims)
    volume = 1
    for d in np.asarray(dims).ravel():
        volume *= int(d)
    return pad_key_for(key_dtype) - (volume - 1)


def device_key_dtype(dims, padded: bool = False) -> np.dtype:
    """``key_dtype_for`` widened to int64 when a padded build's out-of-set
    sentinel cell (key == prod(dims)) would not stay two keys below the
    int32 padding sentinel."""
    kd = key_dtype_for(dims)
    if padded and kd == np.int32 and sentinel_margin(dims, kd) < 2:
        kd = np.dtype(np.int64)
    return kd


def _pad_probe(arr: torch.Tensor, mask: torch.Tensor,
               key_dtype) -> torch.Tensor:
    """``arr`` cast to ``key_dtype`` with ``~mask`` lanes set to the dtype's
    miss sentinel."""
    kd = _TORCH_DTYPES[np.dtype(key_dtype)]
    pad = torch.full_like(arr, pad_key_for(key_dtype), dtype=kd)
    return torch.where(mask, arr.to(kd), pad)


@dataclasses.dataclass(frozen=True)
class GridIndex:
    """The paper's index (A/G/B + geometry) as tensors on one device.

    ``cell_keys``/``cell_start``/``cell_count`` have length ``num_points``
    with ``num_cells`` valid entries; padding keys are the key dtype's max.
    Dtypes follow the JAX package: coordinates in the points' float dtype,
    ``dims`` int64, keys int32 or int64, everything else int32.
    """

    grid_min: torch.Tensor         # (n,) min x_j - eps
    eps: torch.Tensor              # () in the points' dtype
    dims: torch.Tensor             # (n,) int64 cells per dimension
    order: torch.Tensor            # (N,) int32 == A
    points_sorted: torch.Tensor    # (N, n) D[A]
    cell_keys: torch.Tensor        # (N,) int32|int64 == B, padded
    cell_start: torch.Tensor       # (N,) int32 == G.min
    cell_count: torch.Tensor       # (N,) int32
    point_cell_rank: torch.Tensor  # (N,) int32 rank in B of each point's cell
    num_cells: torch.Tensor        # () int32 |B|
    max_per_cell: torch.Tensor     # () int32

    @property
    def n_dims(self) -> int:
        return self.points_sorted.shape[1]

    @property
    def num_points(self) -> int:
        return self.points_sorted.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points_sorted.device


FIELDS = tuple(f.name for f in dataclasses.fields(GridIndex))


def index_from_arrays(fields: Mapping[str, np.ndarray], *,
                      device) -> GridIndex:
    """A ``GridIndex`` from numpy arrays of its fields (for example a JAX
    index's fields), copied onto ``device`` with their dtypes."""
    return GridIndex(**{f: torch.as_tensor(np.array(fields[f])).to(device)
                        for f in FIELDS})


def index_to_numpy(index: GridIndex) -> dict:
    """The inverse of ``index_from_arrays``: every field as a numpy array
    (bfloat16 fields as exact float32 copies: numpy has no bfloat16)."""
    out = {}
    for f in FIELDS:
        t = getattr(index, f).cpu()
        out[f] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def cell_coords(points: torch.Tensor, grid_min: torch.Tensor,
                eps: torch.Tensor) -> torch.Tensor:
    """int64 cell coordinates ``floor((p - gmin) / eps)``. ``eps`` is a
    tensor on the points' device and dtype (see the module note on CUDA
    division by a Python scalar)."""
    return torch.floor((points - grid_min) / eps).to(torch.int64)


def linearize(coords: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """Row-major int64 linear cell id (paper Fig. 2b)."""
    coords = coords.to(torch.int64)
    dims = dims.to(torch.int64)
    key = coords[..., 0]
    for j in range(1, coords.shape[-1]):
        key = key * dims[j] + coords[..., j]
    return key


def row_major_strides(dims) -> np.ndarray:
    """s_j = prod_{k>j} dims_k, so key(c + o) = key(c) + o @ s (host int64)."""
    dims = np.asarray(dims, dtype=np.int64)
    rev = np.cumprod(dims[::-1])
    return np.concatenate([rev[-2::-1], np.ones((1,), np.int64)])


def host_grid_geometry(points: np.ndarray,
                       eps) -> tuple[np.ndarray, np.ndarray]:
    """Exact numpy grid geometry (paper SIV-B), the same IEEE operations
    as the JAX package's ``host_grid_geometry``. float16 points compute in
    numpy's float16, as the reference's do; there ``(gmax - gmin) / eps``
    can pass float16's largest value (65,504) on a wide extent with a small
    eps, and the build refuses what the reference would turn into a
    garbage cell count.

    The build also refuses an eps that is not finite and positive, and
    (over finite points) a cell count that is not finite or reaches 2^63:
    the int64 cast of such a count gives -2^63 in both packages, and the
    port's join then emitted (i, i) pairs and doubled pairs (ROADMAP §C,
    C4)."""
    points = np.asarray(points)
    if not (np.isfinite(eps) and eps > 0):
        raise ValueError(_degenerate_geometry(
            f"eps {eps} is not finite and positive"))
    gmin = points.min(axis=0) - eps
    gmax = points.max(axis=0) + eps
    cells = np.ceil((gmax - gmin) / eps)
    finite_points = np.isfinite(points).all()
    if (points.dtype == np.float16 and finite_points
            and not np.isfinite(cells).all()):
        raise ValueError(
            f"float16 grid geometry overflows: (max - min + 2 eps) / eps "
            f"passes 65,504 cells at eps {eps} over extents "
            f"{(points.max(axis=0) - points.min(axis=0)).tolist()} "
            f"(ROADMAP §C, C1); join these points at float32")
    if finite_points and not (np.isfinite(cells).all()
                              and (cells.astype(np.float64) < 2.0 ** 63)
                              .all()):
        raise ValueError(_degenerate_geometry(
            f"(max - min + 2 eps) / eps gives {cells.tolist()} cells at "
            f"eps {eps}, past int64's 2^63"))
    dims = cells.astype(np.int64) + 1
    return gmin, dims


def _degenerate_geometry(what: str) -> str:
    """The message of a grid build refused under ROADMAP §C, C4."""
    return (f"degenerate grid geometry: {what} (ROADMAP §C, C4). The JAX "
            f"package casts such a cell count to -2^63; its join still "
            f"answers eps inf, and eps 0 on distinct points, rightly, but "
            f"the port refuses them, as it refuses integer points (C2) and "
            f"half-precision ids past their exact range (C3)")


def host_points(x, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (an array, a sequence or a tensor) as a CPU tensor of
    ``dtype``, cast as numpy casts it: float64 to float16 in one rounding
    (``metric.scalar_as``), every other cast as torch makes it."""
    t = (x.detach().cpu() if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(np.asarray(x))))
    if dtype == torch.float16 and t.dtype == torch.float64:
        return torch.from_numpy(t.numpy().astype(np.float16))
    return t.to(dtype)


def geometry_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a grid's geometry (``grid_min`` and the cell division)
    over points of ``dtype``: bfloat16 geometry is float32, as ml_dtypes
    promotes bfloat16 against the JAX package's Python-float eps; every
    other float computes in its own dtype."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


# The largest cell coordinate the merged sweep's lane holds exactly, by
# points' dtype. float16 cell coordinates are floors of float16 quotients,
# so always float16 integers; bfloat16 ones come from float32 geometry and
# are exact only up to 256.
MERGED_LANE_LIMIT = {torch.bfloat16: 256}


def check_merged_lane(index: "GridIndex") -> None:
    """Refuse a merged sweep whose last-dimension cell coordinates the
    points' dtype cannot hold exactly. The JAX package rounds them into its
    bfloat16 merged lane and its boundary mask then drops true pairs
    (``tests/test_torch_half.py``'s 400-cell-deep set: 170,804 pairs
    merged against 198,032 per cell); the port refuses instead (ROADMAP
    §C, C1)."""
    limit = MERGED_LANE_LIMIT.get(index.points_sorted.dtype)
    if limit is not None and int(host_dims(index)[-1]) - 1 > limit:
        raise ValueError(
            f"the merged sweep's lane holds {index.points_sorted.dtype} "
            f"cell coordinates exactly only up to {limit}, and this grid's "
            f"last dimension has {int(host_dims(index)[-1])} cells "
            f"(ROADMAP §C, C1); pass merge_last_dim=False for the per-cell "
            f"sweep")


def host_dims(index: GridIndex) -> np.ndarray:
    """Host copy of ``index.dims``, cached per index."""
    return index_cached(index, "dims_np", lambda: index.dims.cpu().numpy())


def build_grid(points, eps: float, *, device=None) -> GridIndex:
    """Epsilon-grid build: host geometry, construction on ``device``
    (CUDA by default; ``device="cpu"`` runs it on the CPU).

    ``points`` is an (N, n) float64, float32 or float16 numpy array or
    tensor, or a bfloat16 tensor. The geometry needs only the per-dimension
    min and max, which are exact on any device; they are brought to the
    host and the numpy arithmetic of ``host_grid_geometry`` fixes
    ``grid_min``, ``dims`` and the key dtype, in ``geometry_dtype``.
    Integer points raise ``TypeError``: the JAX package casts eps to their
    dtype and joins at a truncated radius (ROADMAP §C, C2).
    """
    if not isinstance(points, torch.Tensor):
        points = torch.from_numpy(np.ascontiguousarray(points))
    pts = points.to(resolve_device(device))
    check_float_points(pts)
    if pts.ndim != 2 or pts.shape[0] == 0:
        raise ValueError(f"points must be a non-empty (N, n) array, got "
                         f"shape {tuple(pts.shape)}")
    gmin, dims = points_geometry(pts, eps)
    return build_grid_with_geometry(pts, float(eps), gmin, dims,
                                    key_dtype=key_dtype_for(dims))


def check_float_points(pts: torch.Tensor) -> None:
    """Refuse points of a dtype the joins do not take."""
    if pts.dtype not in FLOAT_DTYPES:
        raise TypeError(
            f"points must be float64, float32, float16 or bfloat16, got "
            f"{pts.dtype}; the JAX package casts eps to integer points' "
            f"dtype and joins at a truncated radius, so the port refuses "
            f"them (ROADMAP §C, C2): cast to a float dtype first")


def points_geometry(pts: torch.Tensor, eps) -> tuple[np.ndarray, np.ndarray]:
    """``host_grid_geometry`` of a tensor of points: only the per-dimension
    min and max come to the host, in ``geometry_dtype``."""
    extremes = torch.stack([pts.min(dim=0).values, pts.max(dim=0).values])
    extremes = extremes.cpu().to(geometry_dtype(pts.dtype))
    return host_grid_geometry(extremes.numpy(), float(eps))


def build_grid_with_geometry(points: torch.Tensor, eps: float,
                             gmin: np.ndarray, dims: np.ndarray,
                             valid: Optional[torch.Tensor] = None, *,
                             key_dtype) -> GridIndex:
    """Grid build against given geometry: keys, stable sort, segments.

    ``valid`` (the slab join's padded candidate sets) marks real points;
    the others take the out-of-set sentinel cell, key ``prod(dims)``, which
    sorts after every real cell and no stencil probe of a real point
    reaches, and ``max_per_cell`` leaves that cell out. A padded build takes
    ``device_key_dtype(dims, padded=True)``."""
    dev = points.device
    npts = points.shape[0]
    kd = _TORCH_DTYPES[np.dtype(key_dtype)]
    gmin_t = torch.as_tensor(gmin).to(dev)
    dims_t = torch.as_tensor(dims).to(dev)
    eps_t = scalar_as(eps, points.dtype, dev)
    # the cells divide by eps in the geometry's dtype, as the reference's
    # weakly typed Python eps does (float32 for bfloat16 points)
    eps_g = scalar_as(eps, gmin_t.dtype, dev)
    keys = linearize(cell_coords(points, gmin_t, eps_g), dims_t).to(kd)
    sentinel = int(np.prod(np.asarray(dims, dtype=object)))
    if valid is not None:
        keys = torch.where(valid.to(dev), keys,
                           torch.tensor(sentinel, dtype=kd, device=dev))

    order = torch.argsort(keys, stable=True)
    keys_sorted = keys[order]
    is_start = torch.ones(npts, dtype=torch.bool, device=dev)
    is_start[1:] = keys_sorted[1:] != keys_sorted[:-1]
    ncells = is_start.sum(dtype=torch.int32)
    rank = torch.cumsum(is_start, 0, dtype=torch.int32) - 1

    # scatter segment starts into [0, ncells); non-start rows write the
    # spare slot npts, which is cut off (JAX's mode="drop")
    seg_idx = torch.where(is_start, rank.long(), npts)
    positions = torch.arange(npts, dtype=torch.int32, device=dev)
    cell_start = torch.zeros(npts + 1, dtype=torch.int32, device=dev)
    cell_start.scatter_(0, seg_idx, positions)
    cell_start = cell_start[:npts]
    cell_keys = torch.full((npts + 1,), pad_key_for(key_dtype), dtype=kd,
                           device=dev)
    cell_keys.scatter_(0, seg_idx, keys_sorted)
    cell_keys = cell_keys[:npts]

    # count[h] = start[h+1] - start[h]; the last valid cell ends at npts
    idx = torch.arange(npts, dtype=torch.int32, device=dev)
    nxt = torch.cat([cell_start[1:], cell_start.new_zeros(1)])
    nxt = torch.where(idx == ncells - 1, npts, nxt)
    cell_count = torch.where(idx < ncells, nxt - cell_start, 0).to(torch.int32)
    real_count = (cell_count if valid is None else
                  torch.where(cell_keys < sentinel, cell_count, 0))
    return GridIndex(
        grid_min=gmin_t,
        eps=eps_t,
        dims=dims_t,
        order=order.to(torch.int32),
        points_sorted=points[order],
        cell_keys=cell_keys,
        cell_start=cell_start,
        cell_count=cell_count,
        point_cell_rank=rank,
        num_cells=ncells,
        max_per_cell=real_count.max().to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Window descriptors: pure index arithmetic, one batched searchsorted over B.
# ---------------------------------------------------------------------------

def _keys64(index: GridIndex) -> torch.Tensor:
    """``cell_keys`` as int64, the common dtype of keys and probes."""
    return index_cached(index, "keys64", lambda: index.cell_keys.long())


def neighbor_rank(index: GridIndex, query_keys: torch.Tensor) -> torch.Tensor:
    """Rank in B of each (int64) key, or -1 where it is absent."""
    keys = _keys64(index)
    pos = torch.searchsorted(keys, query_keys.long())
    pos = torch.clamp(pos, max=index.num_points - 1)
    return torch.where(keys[pos] == query_keys, pos, -1).to(torch.int32)


def _own_keys(index: GridIndex, q_pos: torch.Tensor) -> torch.Tensor:
    q_pos_c = torch.clamp(q_pos, max=index.num_points - 1).long()
    rank = index.point_cell_rank[q_pos_c].long()
    return _keys64(index)[rank]


def window_descriptors_at(
    index: GridIndex,
    deltas: torch.Tensor,
    q_pos: torch.Tensor,
    q_ok: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cell candidate windows for explicit sorted positions ``q_pos``.

    ``deltas`` are the (n_off,) int64 linearized offsets. Returns
    (win_start, win_count), each (n_off, Q) int32; count 0 where the
    adjacent cell is absent or ``q_ok`` is False.
    """
    q_pos = q_pos.to(torch.int32)
    if q_ok is None:
        q_ok = q_pos < index.num_points
    qk = _own_keys(index, q_pos)[None, :] + deltas.long()[:, None]
    nbr = neighbor_rank(index, qk)
    live = (nbr >= 0) & q_ok[None, :]
    nbr_c = torch.clamp(nbr, min=0).long()
    win_start = torch.where(live, index.cell_start[nbr_c], 0)
    win_count = torch.where(live, index.cell_count[nbr_c], 0)
    return win_start.to(torch.int32), win_count.to(torch.int32)


def window_descriptors(index: GridIndex, deltas: torch.Tensor,
                       q_start: int = 0, q_size: Optional[int] = None):
    """``window_descriptors_at`` for the contiguous rows
    [q_start, q_start + q_size)."""
    npts = index.num_points
    if q_size is None:
        q_size = npts
    q_pos = q_start + torch.arange(q_size, dtype=torch.int32,
                                   device=index.device)
    return window_descriptors_at(index, deltas, q_pos, q_pos < npts)


def _rank_to_point(index: GridIndex, rank: torch.Tensor) -> torch.Tensor:
    """Sorted position of a cell rank's window start; ranks >= num_cells
    map to ``num_points``. Ranks [lo, hi) own exactly the point span
    [_rank_to_point(lo), _rank_to_point(hi))."""
    npts = index.num_points
    rank_c = torch.clamp(rank, max=npts - 1).long()
    return torch.where(rank < index.num_cells, index.cell_start[rank_c],
                       npts).to(torch.int32)


def range_window_descriptors_at(
    index: GridIndex,
    deltas: torch.Tensor,
    lo_off: torch.Tensor,
    hi_off: torch.Tensor,
    q_pos: torch.Tensor,
    q_ok: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merged last-dimension range windows for explicit sorted positions.

    Per (reduced offset, query) the key span [base + lo_off, base + hi_off],
    clamped to the query's grid row, resolves with one left and one right
    searchsorted. Returns (win_start, win_count, win_cells), each (n_off, Q)
    int32; ``win_cells`` counts the non-empty cells inside each window.
    """
    q_pos = q_pos.to(torch.int32)
    if q_ok is None:
        q_ok = q_pos < index.num_points
    own_key = _own_keys(index, q_pos)
    dim_last = index.dims[-1].long()
    q_last = own_key % dim_last
    base = own_key[None, :] + deltas.long()[:, None]
    lo = torch.maximum(lo_off.long()[:, None], -q_last[None, :])
    hi = torch.minimum(hi_off.long()[:, None], dim_last - 1 - q_last[None, :])
    keys = _keys64(index)
    lo_rank = torch.searchsorted(keys, base + lo).to(torch.int32)
    hi_rank = torch.searchsorted(keys, base + hi, right=True).to(torch.int32)
    live = (hi_rank > lo_rank) & q_ok[None, :]
    start = _rank_to_point(index, lo_rank)
    end = _rank_to_point(index, hi_rank)
    win_start = torch.where(live, start, 0).to(torch.int32)
    win_count = torch.where(live, end - start, 0).to(torch.int32)
    win_cells = torch.where(live, hi_rank - lo_rank, 0).to(torch.int32)
    return win_start, win_count, win_cells


def range_window_descriptors(index: GridIndex, deltas, lo_off, hi_off,
                             q_start: int = 0, q_size: Optional[int] = None):
    """``range_window_descriptors_at`` for a contiguous query batch."""
    npts = index.num_points
    if q_size is None:
        q_size = npts
    q_pos = q_start + torch.arange(q_size, dtype=torch.int32,
                                   device=index.device)
    return range_window_descriptors_at(index, deltas, lo_off, hi_off, q_pos,
                                       q_pos < npts)


def external_window_descriptors(index: GridIndex, offsets: torch.Tensor,
                                queries: torch.Tensor,
                                q_limit: Optional[int] = None):
    """Per-cell candidate windows for external query points.

    Each query's cell comes from its own coordinates under the index's
    geometry (``cell_coords``), so queries may lie anywhere: inside the
    volume, outside it, or duplicated. Adjacency is resolved in coordinate
    space: ``target = cell_coords(q) + o`` for every (n_off, n) int64 offset
    vector, masked where any dimension leaves [0, dims); masked probes take
    the key dtype's miss sentinel (``_pad_probe``). Returns (win_start,
    win_count), each (n_off, Q) int32, count 0 for masked probes, absent
    cells and rows at or past ``q_limit``.
    """
    qcoords = cell_coords(queries, index.grid_min, index.eps)   # (Q, n)
    dims = index.dims.long()
    target = qcoords[None, :, :] + offsets.long()[:, None, :]   # (n_off, Q, n)
    in_grid = torch.all((target >= 0) & (target < dims), dim=-1)
    keys = _pad_probe(linearize(target, index.dims), in_grid,
                      _NUMPY_DTYPES[index.cell_keys.dtype])
    nbr = neighbor_rank(index, keys)
    live = nbr >= 0
    if q_limit is not None:
        live = live & _rows_below(queries.shape[0], q_limit, index.device)
    nbr_c = torch.clamp(nbr, min=0).long()
    win_start = torch.where(live, index.cell_start[nbr_c], 0)
    win_count = torch.where(live, index.cell_count[nbr_c], 0)
    return win_start.to(torch.int32), win_count.to(torch.int32)


def external_range_descriptors(index: GridIndex, offsets: torch.Tensor,
                               lo_off: torch.Tensor, hi_off: torch.Tensor,
                               queries: torch.Tensor,
                               q_limit: Optional[int] = None):
    """Merged last-dimension range windows for external query points.

    The first n-1 coordinates are resolved in coordinate space with exact
    bounds masking; the last dimension becomes the key span
    [q_last + lo_off, q_last + hi_off] clamped to [0, dims - 1], which also
    serves queries one cell outside the volume there (farther out the span
    inverts and the probe is dead). Dead probes get an inverted sentinel
    span in the index's key dtype. Returns (win_start, win_count,
    win_cells), each (n_off, Q) int32.
    """
    qcoords = cell_coords(queries, index.grid_min, index.eps)   # (Q, n)
    dims = index.dims.long()
    n = qcoords.shape[1]
    row = qcoords[None, :, :-1] + offsets.long()[:, None, :-1]
    if n > 1:
        row_ok = torch.all((row >= 0) & (row < dims[:-1]), dim=-1)
    else:
        row_ok = torch.ones(row.shape[:2], dtype=torch.bool,
                            device=row.device)
    q_last = qcoords[:, -1]
    lo_last = torch.clamp(q_last[None, :] + lo_off.long()[:, None], min=0)
    hi_last = torch.minimum(q_last[None, :] + hi_off.long()[:, None],
                            dims[-1] - 1)
    live = row_ok & (lo_last <= hi_last)
    row_c = torch.minimum(torch.clamp(row, min=0), dims[:-1] - 1)
    # an explicit zero last coordinate: row_c is empty for 1-D data
    zero_last = row_c.new_zeros(row_c.shape[:-1] + (1,))
    base = linearize(torch.cat([row_c, zero_last], dim=-1), index.dims)
    kd = _NUMPY_DTYPES[index.cell_keys.dtype]
    lo_key = _pad_probe(base + lo_last, live, kd)
    hi_key = torch.where(live, (base + hi_last).to(index.cell_keys.dtype),
                         pad_key_for(kd) - 1)
    keys = _keys64(index)
    lo_rank = torch.searchsorted(keys, lo_key.long()).to(torch.int32)
    hi_rank = torch.searchsorted(keys, hi_key.long(),
                                 right=True).to(torch.int32)
    if q_limit is not None:
        live = live & _rows_below(queries.shape[0], q_limit, index.device)
    live = live & (hi_rank > lo_rank)
    start = _rank_to_point(index, lo_rank)
    end = _rank_to_point(index, hi_rank)
    win_start = torch.where(live, start, 0).to(torch.int32)
    win_count = torch.where(live, end - start, 0).to(torch.int32)
    win_cells = torch.where(live, hi_rank - lo_rank, 0).to(torch.int32)
    return win_start, win_count, win_cells


def _rows_below(n_rows: int, q_limit: int, device) -> torch.Tensor:
    """(1, n_rows) mask of the rows before ``q_limit`` (the rest pad a
    tile)."""
    return (torch.arange(n_rows, device=device) < q_limit)[None, :]


def point_last_coords(index: GridIndex) -> torch.Tensor:
    """Last-dimension cell coordinate of every sorted point, int32, derived
    exactly from the keys (never from float positions)."""
    keys = _keys64(index)[index.point_cell_rank.long()]
    return (keys % index.dims[-1].long()).to(torch.int32)


# ---------------------------------------------------------------------------
# Cell runs: query rows that share a grid cell have the same window
# descriptors for every stencil offset (both descriptor families derive
# them from the row's cell rank alone), so a kernel can read each window
# once per run of such rows and descriptors can be computed once per cell:
# the paper's duplicate-search removal (SIV-C).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunPlan:
    """Cell-run partition of one fused launch's query rows.

    ``run_ord[i]`` is row i's run ordinal within its tq-row tile: 0 at every
    tile's first row, +1 exactly where the row's cell changes. ``head``
    marks each run's first row. ``n_runs`` and ``run_lengths`` (the JAX
    package's fields) are derived from ``head`` on demand, so a plan costs
    the join no host synchronisation.
    """

    run_ord: torch.Tensor   # (qp,) int32 per-tile run ordinals
    head: torch.Tensor      # (qp,) bool, True at each run's first row

    @property
    def n_runs(self) -> int:
        """Runs over all tiles."""
        return int(self.head.sum())

    @property
    def run_lengths(self) -> torch.Tensor:
        """(n_runs,) int32 rows per run, in row order."""
        starts = torch.nonzero(self.head).flatten()
        ends = torch.cat([starts[1:], starts.new_tensor([self.head.shape[0]])])
        return (ends - starts).to(torch.int32)


def cell_run_plan(cell_of_row: torch.Tensor, tq: int) -> RunPlan:
    """Partition a launch's rows into maximal same-cell runs, per tile.

    ``cell_of_row`` is any per-row cell identity in launch order (the
    self-join uses ``point_cell_rank`` at each row's sorted position). Runs
    also split at tq-row tile boundaries, where a kernel block starts. The
    plan is computed on the identities' device.
    """
    ids = torch.as_tensor(cell_of_row)
    qp = ids.shape[0]
    if tq <= 0 or qp % tq:
        raise ValueError(f"run plan rows {qp} must be a positive multiple "
                         f"of tq={tq}")
    head = torch.ones(qp, dtype=torch.bool, device=ids.device)
    head[1:] = ids[1:] != ids[:-1]
    head[::tq] = True
    run_ord = torch.cumsum(head.reshape(-1, tq), dim=1, dtype=torch.int32) - 1
    return RunPlan(run_ord=run_ord.reshape(-1), head=head)


def _cell_window_table_device(index: GridIndex, deltas,
                              *, merged: bool):
    """Per-cell window descriptor tables, each (n_off, num_points) int32.

    Column r holds (win_start, win_count, win_cells) of cell rank r: the
    arithmetic of ``window_descriptors_at`` / ``range_window_descriptors_at``
    done once per cell instead of once per query row. Columns from
    ``num_cells`` on are dead (all zero), as in the JAX package; they are
    not computed, only filled.
    """
    npts = index.num_points
    ncells = int(index.num_cells)
    keys = _keys64(index)
    own_key = keys[:ncells]
    if merged:
        dtab, lo_off, hi_off = (deltas[k].long() for k in range(3))
        dim_last = index.dims[-1].long()
        q_last = own_key % dim_last
        base = own_key[None, :] + dtab[:, None]
        lo = torch.maximum(lo_off[:, None], -q_last[None, :])
        hi = torch.minimum(hi_off[:, None], dim_last - 1 - q_last[None, :])
        lo_rank = torch.searchsorted(keys, base + lo).to(torch.int32)
        hi_rank = torch.searchsorted(keys, base + hi, right=True).to(torch.int32)
        live = hi_rank > lo_rank
        start = _rank_to_point(index, lo_rank)
        end = _rank_to_point(index, hi_rank)
        cols = (torch.where(live, start, 0), torch.where(live, end - start, 0),
                torch.where(live, hi_rank - lo_rank, 0))
    else:
        nbr = neighbor_rank(index, own_key[None, :] + deltas.long()[:, None])
        live = nbr >= 0
        nbr_c = torch.clamp(nbr, min=0).long()
        wc = torch.where(live, index.cell_count[nbr_c], 0)
        cols = (torch.where(live, index.cell_start[nbr_c], 0), wc,
                (wc > 0).to(torch.int32))
    out = []
    for col in cols:
        tab = col.new_zeros((col.shape[0], npts), dtype=torch.int32)
        tab[:, :ncells] = col
        out.append(tab)
    return tuple(out)


def cell_window_tables(index: GridIndex, deltas, *, merged: bool, tag):
    """Per-cell descriptor tables (``_cell_window_table_device``), cached
    per index under ``wintab/{merged}/{tag}``. ``deltas`` is the linearized
    offset table, or the (3, n_off) merged table; ``tag`` tells apart
    offset tables that share ``merged`` (the drivers pass ``unicomp``)."""
    return index_cached(
        index, f"wintab/{bool(merged)}/{tag}",
        lambda: _cell_window_table_device(index, deltas, merged=merged))


# ---------------------------------------------------------------------------
# Occupancy bucketing: query rows partition into capacity classes so each
# launch pads its windows to its class's capacity, not the global maximum.
# ---------------------------------------------------------------------------

CAP_ALIGN = 8  # alignment of window capacities


def round_up(x, m: int):
    """Round up to a multiple of m (Python ints and numpy arrays alike)."""
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Partition of sorted query rows into capacity classes.

    ``caps[k]`` is bucket k's window capacity (ascending, the last equals
    the global capacity); ``sel[k]`` its sorted positions in ascending order
    (``None`` for the single-bucket plan: all rows, contiguous); ``hist``
    maps each capacity to its row count.
    """

    caps: tuple
    sel: tuple
    cap_global: int
    hist: dict


def capacity_classes(cap_global: int, align: int = CAP_ALIGN) -> tuple:
    """Power-of-two ladder (align, 2*align, ...) capped at ``cap_global``."""
    cap_global = max(int(cap_global), align)
    out = []
    v = align
    while v < cap_global:
        out.append(v)
        v *= 2
    out.append(cap_global)
    return tuple(out)


def starts_ext(index: GridIndex) -> np.ndarray:
    """Host ``cell_start`` of each valid rank with ``num_points`` appended,
    so the point span of ranks [lo, hi) is ``starts_ext[lo]:starts_ext[hi]``."""
    ncells = int(index.num_cells)
    return np.concatenate(
        [index.cell_start[:ncells].cpu().numpy(),
         np.asarray([index.num_points])]).astype(np.int64)


def _cell_window_caps_device(index: GridIndex, deltas: torch.Tensor,
                             merged: bool) -> torch.Tensor:
    """Largest window any point of each cell sees, over all ``deltas``:
    one searchsorted over the (offset x cell) plane per probe side. Lanes
    at rank >= num_cells probe the padding sentinel and are dead. Probes
    are int64, so no key + delta can wrap."""
    keys = _keys64(index)
    pad = pad_key_for(_NUMPY_DTYPES[index.cell_keys.dtype])
    n = keys.shape[0]
    dev = keys.device
    is_cell = torch.arange(n, device=dev) < index.num_cells
    counts = torch.where(is_cell, index.cell_count, 0).long()
    deltas = deltas.long()[:, None]
    if not merged:
        probe = torch.where(is_cell[None, :], keys[None, :] + deltas, pad)
        pos = torch.clamp(torch.searchsorted(keys, probe), max=n - 1)
        hit = torch.where(keys[pos] == probe, counts[pos], 0)
        return hit.max(dim=0).values
    dim_last = index.dims[-1].long()
    last = keys % dim_last
    lo = keys + torch.clamp(-last, min=-1)
    hi = keys + torch.clamp(dim_last - 1 - last, max=1)
    # dead lanes get an inverted span (lo = pad, hi = pad - 1)
    lo_key = torch.where(is_cell[None, :], lo[None, :] + deltas, pad)
    hi_key = torch.where(is_cell[None, :], hi[None, :] + deltas, pad - 1)
    lo_rank = torch.searchsorted(keys, lo_key).to(torch.int32)
    hi_rank = torch.searchsorted(keys, hi_key, right=True).to(torch.int32)
    span = (_rank_to_point(index, hi_rank)
            - _rank_to_point(index, lo_rank)).long()
    hit = torch.where(hi_rank > lo_rank, span, 0)
    return hit.max(dim=0).values


def cell_window_caps(index: GridIndex, merged: bool = False) -> np.ndarray:
    """Per non-empty cell, the largest candidate window any of its points
    can see: over the full 3^n stencil of single cells (``merged=False``)
    or the 3^(n-1) merged range windows (``merged=True``). An upper bound
    for the UNICOMP half too, so one plan serves both. Host int32 array."""
    strides = row_major_strides(host_dims(index))
    if merged:
        reduced, _, _ = merged_stencil_offsets(index.n_dims, unicomp=False)
        deltas = reduced @ strides
    else:
        deltas = stencil_offsets(index.n_dims, unicomp=False) @ strides
    caps = _cell_window_caps_device(
        index, torch.as_tensor(deltas).to(index.device), merged)
    ncells = int(index.num_cells)
    return caps[:ncells].cpu().numpy().astype(np.int32)


# Plans are pure functions of the immutable index, cached per live index
# object (bounded LRU; a weakref finalizer drops an index's entries when it
# is collected). Entries are recomputable values only.
_INDEX_CACHE_MAX = 64
_INDEX_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_MISSING = object()


def _finalize_index_entry(key) -> None:
    _INDEX_CACHE.pop(key, None)


def index_cached(index: GridIndex, tag: str, build):
    """Memoize ``build()`` on the index object under ``tag`` (bounded LRU)."""
    key = (id(index), tag)
    value = _INDEX_CACHE.get(key, _MISSING)
    if value is not _MISSING:
        _INDEX_CACHE.move_to_end(key)
        return value
    value = build()
    _INDEX_CACHE[key] = value
    weakref.finalize(index, _finalize_index_entry, key)
    while len(_INDEX_CACHE) > _INDEX_CACHE_MAX:
        _INDEX_CACHE.popitem(last=False)
    return value


def cell_window_caps_cached(index: GridIndex,
                            merged: bool = False) -> np.ndarray:
    """``cell_window_caps`` memoized per index object."""
    return index_cached(index, f"cellcaps/{merged}",
                        lambda: cell_window_caps(index, merged=merged))


def global_window_cap(index: GridIndex, merged: bool = False,
                      align: int = CAP_ALIGN) -> int:
    """Aligned window capacity of an unbucketed launch: ``max_per_cell``
    per cell, the largest merged range window when merged."""
    if not merged:
        return round_up(max(int(index.max_per_cell), 1), align)

    def build():
        caps = cell_window_caps_cached(index, merged=True)
        top = int(caps.max()) if caps.size else 0
        return round_up(max(top, 1), align)

    return index_cached(index, f"capglobal/{align}/{merged}", build)


# Sweeps of ``external_range_cap`` (cache misses), which a serving request
# must never redo: the serving path's no-rebuild watchdog reads this.
BUILD_EVENTS: collections.Counter = collections.Counter()


def _external_span_device(index: GridIndex) -> torch.Tensor:
    """Point span of the keys [k, k + 2] for every present key k, one
    right-side searchsorted; padding lanes probe the sentinel minus one and
    span zero."""
    keys = _keys64(index)
    n = keys.shape[0]
    lanes = torch.arange(n, dtype=torch.int32, device=keys.device)
    is_cell = lanes < index.num_cells
    pad = pad_key_for(_NUMPY_DTYPES[index.cell_keys.dtype])
    hi_key = torch.where(is_cell, keys + 2, pad - 1)
    hi_rank = torch.searchsorted(keys, hi_key, right=True).to(torch.int32)
    span = (_rank_to_point(index, hi_rank)
            - _rank_to_point(index, lanes)).long()
    return torch.where(is_cell, span, 0)


def external_range_cap(index: GridIndex, align: int = CAP_ALIGN) -> int:
    """Upper bound on any merged range window an external query can see.

    A query's window spans keys [base - 1, base + 1]; its least present key
    k bounds the span by [k, k + 2], so the largest point span of [k, k + 2]
    over present keys bounds every window, including windows whose centre
    cell is absent (which per-cell caps cannot see). Cached per index. The
    probes reach two keys above the largest real key, so the key dtype's
    padding sentinel must lie more than two keys above it
    (``sentinel_margin``)."""
    margin = sentinel_margin(host_dims(index),
                             _NUMPY_DTYPES[index.cell_keys.dtype])
    if margin <= 2:
        raise ValueError(
            f"sentinel margin {margin} <= 2: a probe two keys above the "
            f"largest real key would rank into the padding of B")

    def build():
        BUILD_EVENTS["external_range_cap"] += 1
        span = _external_span_device(index)
        top = int(span.max()) if span.numel() else 0
        return round_up(max(top, 1), align)

    return index_cached(index, f"extcap/{align}", build)


def occupancy_plan(index: GridIndex, align: int = CAP_ALIGN,
                   merged: bool = False) -> BucketPlan:
    """Window-length histogram -> capacity classes -> row partition. Rows
    keep ascending order inside every bucket and each row is in exactly one
    bucket, so per-bucket counts and slot bases concatenate."""
    return index_cached(index, f"plan/{align}/{merged}",
                        lambda: _build_occupancy_plan(index, align, merged))


def filter_plan_rows(plan: BucketPlan, row_ok: np.ndarray) -> BucketPlan:
    """``plan`` restricted to the sorted rows where ``row_ok`` is True (the
    slab join launches only the rows its slab owns). Selections stay
    ascending, the single contiguous class becomes an explicit selection,
    emptied classes drop out, and ``hist`` counts the rows kept; with no row
    left, one empty class at the global capacity remains."""
    row_ok = np.asarray(row_ok, bool)
    caps, sels, hist = [], [], {}
    for cap, sel in zip(plan.caps, plan.sel):
        rows = (np.flatnonzero(row_ok).astype(np.int32) if sel is None
                else sel[row_ok[sel]])
        if rows.size:
            caps.append(cap)
            sels.append(rows)
            hist[int(cap)] = int(rows.size)
    if not caps:
        return BucketPlan(caps=(plan.cap_global,),
                          sel=(np.zeros(0, np.int32),),
                          cap_global=plan.cap_global,
                          hist={plan.cap_global: 0})
    return BucketPlan(caps=tuple(caps), sel=tuple(sels),
                      cap_global=plan.cap_global, hist=hist)


def _build_occupancy_plan(index: GridIndex, align: int,
                          merged: bool = False) -> BucketPlan:
    npts = index.num_points
    cap_global = global_window_cap(index, merged, align)
    if cap_global <= align or npts == 0:
        return BucketPlan(caps=(cap_global,), sel=(None,),
                          cap_global=cap_global, hist={cap_global: npts})
    classes = capacity_classes(cap_global, align)
    caps = cell_window_caps_cached(index, merged=merged)
    caps_aligned = np.minimum(
        round_up(np.maximum(caps, 1), align), cap_global)
    cls_of_cell = np.searchsorted(np.asarray(classes), caps_aligned)
    cls_of_row = cls_of_cell[index.point_cell_rank.cpu().numpy()]
    hist, sels, kept = {}, [], []
    for k, cap in enumerate(classes):
        rows = np.flatnonzero(cls_of_row == k).astype(np.int32)
        if rows.size:
            hist[int(cap)] = int(rows.size)
            sels.append(rows)
            kept.append(int(cap))
    if len(kept) == 1:
        return BucketPlan(caps=(kept[0],), sel=(None,),
                          cap_global=cap_global, hist=hist)
    return BucketPlan(caps=tuple(kept), sel=tuple(sels),
                      cap_global=cap_global, hist=hist)
