"""CPU baselines the paper compares against (SVI-B), in numpy.

The counterpart of ``repro.core.baselines``: a copy, since this package
imports nothing of ``repro``. Both baselines stay on the host and take numpy
points and no device, as the paper's references do.

* ``rtree_join``  -- CPU-RTREE: the sequential search-and-refine reference.
  An STR bulk-loaded R-tree (Kamel & Faloutsos style packing; the paper sorts
  data into unit bins before insertion for the same locality effect), then a
  per-point range search + refine. Pure numpy, single-threaded by design (the
  paper's reference is 1 thread).

* ``ego_join``    -- Super-EGO-style epsilon-grid-order join (Kalashnikov
  2013): EGO-sort the points by their eps-grid cell coordinate, then a
  recursive block join in which a pair of blocks is pruned when their cell
  bounding ranges are farther than one cell apart in some dimension. This
  reproduces the algorithmic structure (EGO-sort + EGO-join + pruning); the
  original's dimension-reordering heuristic is noted in benchmarks where the
  paper's claim depends on it (uniform data defeats reordering, paper SVI-C).

Both return ordered-pair counts and (optionally) pair lists consistent with
``core.selfjoin.self_join``; consistency is asserted in tests the same way
the paper validated implementations "by comparing the total number of
neighbors within eps".
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import metric as metric_lib

# ---------------------------------------------------------------------------
# CPU-RTREE (search-and-refine reference)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _RTree:
    # level arrays, root last. boxes[l]: (n_nodes_l, 2, n); children[l]:
    # (n_nodes_l, 2) int ranges into level l-1 nodes (or into points for l=0).
    boxes: list
    children: list
    point_order: np.ndarray
    points: np.ndarray
    leaf_size: int


def build_rtree(points: np.ndarray, leaf_size: int = 32, fanout: int = 8) -> _RTree:
    """Sort-Tile-Recursive bulk load.

    Points are recursively sorted and partitioned one dimension at a time into
    ~equal slices (the STR packing); leaves hold ``leaf_size`` points. This
    mirrors the paper's 'sort into unit bins so internal nodes do not span
    empty space' preparation for its R-tree reference.
    """
    pts = np.asarray(points)
    npts, ndim = pts.shape

    def str_pack(idx: np.ndarray, dim: int) -> np.ndarray:
        """Recursive STR: sort by dim, split into ~equal slabs, recurse."""
        if idx.shape[0] <= leaf_size:
            return idx
        srt = idx[np.argsort(pts[idx, dim], kind="stable")]
        n_slabs = min(fanout, -(-srt.shape[0] // leaf_size))
        return np.concatenate(
            [str_pack(s, (dim + 1) % ndim) for s in np.array_split(srt, n_slabs)]
        )

    order = str_pack(np.arange(npts), 0)

    pts_sorted = pts[order]
    # leaves
    leaf_ranges = [
        (i, min(i + leaf_size, npts)) for i in range(0, npts, leaf_size)
    ]
    boxes = []
    children = []
    lvl_boxes = np.empty((len(leaf_ranges), 2, ndim))
    lvl_child = np.empty((len(leaf_ranges), 2), dtype=np.int64)
    for k, (a, b) in enumerate(leaf_ranges):
        lvl_boxes[k, 0] = pts_sorted[a:b].min(axis=0)
        lvl_boxes[k, 1] = pts_sorted[a:b].max(axis=0)
        lvl_child[k] = (a, b)
    boxes.append(lvl_boxes)
    children.append(lvl_child)
    while boxes[-1].shape[0] > 1:
        prev = boxes[-1]
        m = prev.shape[0]
        groups = [(i, min(i + fanout, m)) for i in range(0, m, fanout)]
        nb = np.empty((len(groups), 2, ndim))
        nc = np.empty((len(groups), 2), dtype=np.int64)
        for k, (a, b) in enumerate(groups):
            nb[k, 0] = prev[a:b, 0].min(axis=0)
            nb[k, 1] = prev[a:b, 1].max(axis=0)
            nc[k] = (a, b)
        boxes.append(nb)
        children.append(nc)
    return _RTree(boxes, children, order, pts_sorted, leaf_size)


def _rtree_query(tree: _RTree, q: np.ndarray, eps: float) -> np.ndarray:
    """Ids (original numbering) of points within eps of q (search-and-refine)."""
    lo, hi = q - eps, q + eps
    top = len(tree.boxes) - 1
    nodes = np.array([0], dtype=np.int64)
    for level in range(top, 0, -1):  # descend to leaf level
        bx = tree.boxes[level][nodes]
        ok = np.all(bx[:, 0] <= hi, axis=1) & np.all(bx[:, 1] >= lo, axis=1)
        rng = tree.children[level][nodes[ok]]
        if rng.shape[0] == 0:
            return np.empty(0, dtype=np.int64)
        nodes = np.concatenate([np.arange(a, b) for a, b in rng])
    bx = tree.boxes[0][nodes]
    ok = np.all(bx[:, 0] <= hi, axis=1) & np.all(bx[:, 1] >= lo, axis=1)
    rng = tree.children[0][nodes[ok]]
    if rng.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    cand = np.concatenate([np.arange(a, b) for a, b in rng])
    # refine
    d2 = ((tree.points[cand] - q) ** 2).sum(axis=1)
    return tree.point_order[cand[metric_lib.l2_sq_hits(d2, eps)]]


def rtree_join(points: np.ndarray, eps: float, *, return_pairs: bool = False,
               leaf_size: int = 32):
    """Sequential search-and-refine self-join (ordered pairs, excl. self)."""
    pts = np.asarray(points)
    tree = build_rtree(pts, leaf_size=leaf_size)
    total = 0
    pairs = [] if return_pairs else None
    for i in range(pts.shape[0]):
        nbrs = _rtree_query(tree, pts[i], eps)
        nbrs = nbrs[nbrs != i]
        total += nbrs.shape[0]
        if return_pairs:
            pairs.append(np.stack([np.full_like(nbrs, i), nbrs], axis=1))
    if return_pairs:
        out = (np.concatenate(pairs) if pairs else np.empty((0, 2), np.int64))
        out = out[np.lexsort((out[:, 1], out[:, 0]))]
        return total, out
    return total


# ---------------------------------------------------------------------------
# Super-EGO-style epsilon grid order join
# ---------------------------------------------------------------------------


def _ego_sort(points: np.ndarray, eps: float):
    gmin = points.min(axis=0)
    cells = np.floor((points - gmin) / eps).astype(np.int64)
    order = np.lexsort(tuple(cells[:, j] for j in range(cells.shape[1] - 1, -1, -1)))
    return points[order], cells[order], order


def ego_join(points: np.ndarray, eps: float, *, block: int = 64,
             return_pairs: bool = False):
    """EGO-sort + recursive block join with cell-distance pruning.

    Prune rule (epsilon grid order, Boehm et al. 2001): two EGO-sorted blocks
    cannot contain a qualifying pair if, in the first dimension where their
    cell ranges are disjoint, the gap exceeds one cell. Counts ordered pairs.
    """
    pts = np.asarray(points)
    npts = pts.shape[0]
    if npts == 0:
        return (0, np.empty((0, 2), np.int64)) if return_pairs else 0
    P, C, order = _ego_sort(pts, eps)
    eps2 = metric_lib.eps_squared(eps)
    blocks = [(i, min(i + block, npts)) for i in range(0, npts, block)]
    blo = np.array([C[a:b].min(axis=0) for a, b in blocks])
    bhi = np.array([C[a:b].max(axis=0) for a, b in blocks])
    nb = len(blocks)
    total = 0
    pairs = [] if return_pairs else None
    for bi in range(nb):
        a0, a1 = blocks[bi]
        for bj in range(bi, nb):
            # prune on cell ranges: gap > 1 cell in any dim -> no pairs.
            gap_lo = blo[bj] - bhi[bi]
            gap_hi = blo[bi] - bhi[bj]
            if np.any(np.maximum(gap_lo, gap_hi) > 1):
                # EGO order is lexicographic: once dim-0 gap exceeds 1 for bj,
                # it does for all later bj too.
                if gap_lo[0] > 1:
                    break
                continue
            b0, b1 = blocks[bj]
            d2 = ((P[a0:a1, None, :] - P[None, b0:b1, :]) ** 2).sum(axis=2)
            hit = metric_lib.l2_sq_hits_presquared(d2, eps2)
            if bi == bj:
                np.fill_diagonal(hit, False)
                total += int(hit.sum())
            else:
                total += 2 * int(hit.sum())
            if return_pairs:
                ii, jj = np.nonzero(hit)
                gi, gj = order[a0 + ii], order[b0 + jj]
                pairs.append(np.stack([gi, gj], axis=1))
                if bi != bj:
                    pairs.append(np.stack([gj, gi], axis=1))
    if return_pairs:
        out = (np.concatenate(pairs) if pairs else np.empty((0, 2), np.int64))
        out = out[np.lexsort((out[:, 1], out[:, 0]))]
        return total, out
    return total
