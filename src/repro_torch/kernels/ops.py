"""Dispatch layer between the drivers and the kernels.

The counterpart of ``repro.kernels.ops``. The JAX package computes f64 input
in f32 on a TPU, which has no f64; the H100 has native FP64, so the port
keeps the input dtype end to end and passes every call straight through.
The sanitized mode of the JAX package waits for ROADMAP item A13.
"""
from __future__ import annotations

from repro_torch.kernels import cell_join as _cell_join
from repro_torch.kernels import distance_tile as _distance_tile
from repro_torch.kernels import fused_join as _fused_join


def distance_tile_hits(q, pts, eps):
    """Brute-force tile: (nq, n) x (N, n) -> (nq, N) bool epsilon hits; see
    ``kernels.distance_tile.distance_tile_hits``."""
    return _distance_tile.distance_tile_hits(q, pts, eps)


def distance_tile_counts(pts, eps, *, tq: int = 256, tc: int = 256):
    """Brute-force per-point neighbour counts (excluding self); see
    ``kernels.distance_tile.distance_tile_counts``."""
    return _distance_tile.distance_tile_counts(pts, eps, tq=tq, tc=tc)


def cell_join_hits(q, cand, valid, eps):
    """Grid-cell refine of the unfused sweep: (B, n) x (B, C, n) x (B, C)
    -> (B, C) bool; see ``kernels.cell_join.cell_join_hits``."""
    return _cell_join.cell_join_hits(q, cand, valid, eps)


def fused_join_hits(points_pad, q_batch, win_start, win_count, is_zero,
                    q_pos, eps, *, c, n_real, unicomp, external=False,
                    merged=False, gid_pairs=False, tq=_fused_join.TQ_DEFAULT,
                    keep_hits=True, run_ord=None, run_loop=False, metric="l2",
                    n_feat=0, words=None):
    """Fused gather-refine sweep (all offsets, one launch) -> hits, counts,
    slot_base; see ``kernels.fused_join.fused_join_hits``."""
    return _fused_join.fused_join_hits(
        points_pad, q_batch, win_start, win_count, is_zero, q_pos, eps,
        c=c, n_real=n_real, unicomp=unicomp, external=external,
        merged=merged, gid_pairs=gid_pairs, tq=tq, keep_hits=keep_hits,
        run_ord=run_ord, run_loop=run_loop, metric=metric, n_feat=n_feat,
        words=words)
