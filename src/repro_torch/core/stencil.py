"""Adjacent-cell stencils and the UNICOMP half-stencil (paper SV-B).

A point in cell c finds its neighbours among the 3^n adjacent cells c + o,
o in {-1, 0, +1}^n. UNICOMP evaluates every unordered pair of adjacent cells
once: it keeps o = 0 and the offsets whose first nonzero coordinate is +1,
and applies an intra-cell upper-triangle mask on o = 0.

Plain numpy, identical to ``repro.core.stencil`` (the JAX package), of which
this is a copy: the port imports nothing from that package.
"""
from __future__ import annotations

import itertools

import numpy as np


def _half_stencil(offs: np.ndarray) -> np.ndarray:
    keep = []
    for o in offs:
        nz = np.nonzero(o)[0]
        if nz.size == 0 or o[nz[0]] > 0:
            keep.append(o)
    return np.stack(keep)


def _zero_first(offs: np.ndarray) -> np.ndarray:
    zkey = np.all(offs == 0, axis=1)
    return np.concatenate([offs[zkey], offs[~zkey]], axis=0)


def stencil_offsets(n: int, unicomp: bool) -> np.ndarray:
    """All 3^n adjacent-cell offsets, or the UNICOMP half-stencil.

    Returns (n_offsets, n) int64. The zero offset is always first.
    """
    offs = np.array(list(itertools.product((-1, 0, 1), repeat=n)),
                    dtype=np.int64)
    if unicomp:
        offs = _half_stencil(offs)
    return _zero_first(offs)


def merged_stencil_offsets(
    n: int, unicomp: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 3^(n-1) merged-range stencil.

    Under row-major keys the three cells that differ only in the last
    coordinate have adjacent key ranks, so their points are one contiguous
    span of ``points_sorted`` and one range probe replaces three cell
    probes. Returns

        reduced (n_off, n) int64 -- offsets with last coordinate 0, zero first;
        lo / hi (n_off,) int64   -- the last-dimension span of each, as key
            deltas relative to the reduced target.

    With UNICOMP the zero reduced offset spans [0, +1] only, and the
    triangle rule ``cand_pos > q_pos`` over that whole window is exact: the
    key+1 cell's points all sit after every own-cell query in sorted order.
    """
    offs = np.array(list(itertools.product((-1, 0, 1), repeat=n - 1)),
                    dtype=np.int64)
    if unicomp:
        offs = _half_stencil(offs)
    offs = _zero_first(offs)
    reduced = np.concatenate(
        [offs, np.zeros((offs.shape[0], 1), np.int64)], axis=1)
    lo = np.full(offs.shape[0], -1, np.int64)
    hi = np.full(offs.shape[0], 1, np.int64)
    if unicomp:
        lo[0] = 0  # zero reduced offset: own cell + the key+1 cell only
    return reduced, lo, hi
