"""The plain reference of the exact L2 epsilon self-join, in plain PyTorch.

Every ordered pair (i, j), i != j, with ||p_i - p_j|| <= eps, where the
squared distance is summed dimension by dimension in the points' dtype
(``d2 = d2 + t * t``, one rounding a step, no fused multiply-add) and
compared with ``eps * eps`` in that dtype. The pairs come back as sorted
int64 keys ``i * n + j``.

A uniform grid of cells a little wider than eps prunes the candidates: a
point's neighbours lie in the 3^d cells around its own. With the last
dimension varying fastest in the cell key, the three cells along it are one
contiguous key range, so each of the 3^(d-1) offsets over the other
dimensions is one range of the key-sorted points. Candidates are expanded in
chunks of at most ``chunk`` pairs, so the reference fits beside a join's
result on the card.

It imports nothing of the program and takes nothing the program made: it is
handed the points and builds all it needs itself.
"""
import itertools

import torch

# the cells are wider than eps by this share, so that no rounding of the
# cell coordinates moves a neighbour two cells away
_WIDEN = 1e-4


def _cells(points: torch.Tensor, eps: float):
    p = points.to(torch.float64)
    low = p.min(dim=0).values
    coords = torch.floor((p - low) / (eps * (1 + _WIDEN))).to(torch.int64)
    dims = coords.max(dim=0).values + 1
    return coords, dims


def _linear(coords: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    key = torch.zeros(coords.shape[0], dtype=torch.int64,
                      device=coords.device)
    for k in range(coords.shape[1]):
        key = key * dims[k] + coords[:, k]
    return key


def pair_keys(points: torch.Tensor, eps: float,
              chunk: int = 1 << 25) -> torch.Tensor:
    """Sorted int64 keys ``i * n + j`` of every ordered pair within eps."""
    n, d = points.shape
    dev = points.device
    coords, dims = _cells(points, eps)
    dims_list = [int(x) for x in dims]
    volume = 1
    for x in dims_list:
        volume *= x
    if volume >= 2**62 or n * n >= 2**63:
        raise ValueError(f"{n} points on a grid of {dims_list} cells do "
                         f"not fit int64 keys")
    key = _linear(coords, dims)
    order = torch.argsort(key)
    key_sorted = key[order]
    coords_sorted = coords[order]
    cols = points[order].T.contiguous()          # (d, n) in sorted order
    e = torch.tensor(eps, dtype=points.dtype, device=dev)
    e2 = e * e
    last = coords_sorted[:, d - 1]
    lo_last = torch.clamp(last - 1, min=0)
    hi_last = torch.clamp(last + 1, max=dims_list[d - 1] - 1)
    found = []
    for offset in itertools.product((-1, 0, 1), repeat=d - 1):
        head = coords_sorted[:, :d - 1] + torch.tensor(
            offset, dtype=torch.int64, device=dev)
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        base = torch.zeros(n, dtype=torch.int64, device=dev)
        for k in range(d - 1):
            ok &= (head[:, k] >= 0) & (head[:, k] < dims_list[k])
            base = base * dims_list[k] + head[:, k]
        base = base * dims_list[d - 1]
        first = torch.searchsorted(key_sorted, base + lo_last)
        stop = torch.searchsorted(key_sorted, base + hi_last, right=True)
        length = torch.where(ok, stop - first, 0)
        found.extend(order[q] * n + order[c]
                     for q, c in _refine(cols, first, length, e2, chunk))
    if not found:
        return torch.empty(0, dtype=torch.int64, device=dev)
    keys = torch.cat(found)
    del found
    return torch.sort(keys).values


def _refine(cols, first, length, e2, chunk: int):
    """Yields the hits (query, candidate) among each query's candidate
    range, a chunk of queries whose ranges sum to about ``chunk``
    candidates at a time."""
    n = length.shape[0]
    dev = length.device
    ends = torch.cumsum(length, 0)
    total = int(ends[-1]) if n else 0
    if total == 0:
        return
    cuts = []
    if total > chunk:
        marks = torch.arange(chunk, total, chunk, device=dev)
        cuts = torch.searchsorted(ends, marks, right=True).tolist()
    bounds = sorted({0, n, *cuts})
    for s, t in zip(bounds[:-1], bounds[1:]):
        lens = length[s:t]
        size = int(lens.sum())
        if size == 0:
            continue
        rel = torch.repeat_interleave(
            torch.arange(t - s, device=dev), lens, output_size=size)
        starts = torch.cumsum(lens, 0) - lens
        q = rel + s
        c = first[q] + (torch.arange(size, device=dev) - starts[rel])
        d2 = torch.zeros(size, dtype=cols.dtype, device=dev)
        for k in range(cols.shape[0]):
            t_k = cols[k][q] - cols[k][c]
            d2 = d2 + t_k * t_k
        hit = (d2 <= e2) & (q != c)
        yield q[hit], c[hit]
