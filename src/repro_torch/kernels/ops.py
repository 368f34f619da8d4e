"""Dispatch layer between the self-join drivers and the kernels.

The counterpart of ``repro.kernels.ops``. The JAX package computes f64 input
in f32 on a TPU, which has no f64; the H100 has native FP64, so the port
keeps the input dtype end to end and passes every call straight through.
The sanitized mode of the JAX package waits for ROADMAP item A13.
"""
from __future__ import annotations

from repro_torch.kernels import fused_join as _fused_join


def fused_join_hits(points_pad, q_batch, win_start, win_count, is_zero,
                    q_pos, eps, *, c, n_real, unicomp, merged=False,
                    tq=_fused_join.TQ_DEFAULT, keep_hits=True):
    """Fused gather-refine sweep (all offsets, one launch) -> hits, counts,
    slot_base; see ``kernels.fused_join.fused_join_hits``."""
    return _fused_join.fused_join_hits(
        points_pad, q_batch, win_start, win_count, is_zero, q_pos, eps,
        c=c, n_real=n_real, unicomp=unicomp, merged=merged, tq=tq,
        keep_hits=keep_hits)
