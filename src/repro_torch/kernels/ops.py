"""Dispatch layer between the drivers and the kernels.

The counterpart of ``repro.kernels.ops``. The JAX package computes f64 input
in f32 on a TPU, which has no f64; the H100 has native FP64, so the port
keeps the input dtype end to end and passes every call straight through.

Sanitized mode (``analysis.sanitize``, ``REPRO_TORCH_SANITIZE=1``): every
``fused_join_hits`` launch queues the device error code of
``fused_join.sanitize_errcodes`` under a label naming the launch, and the
drivers raise it at their sync points. Unlike a TPU interpreter, which
clamps a corrupted gather, a CUDA kernel would read past ``points_pad`` and
the plain version would raise ``IndexError``; so a sanitized launch hands
the kernel count 0 and start 0 on every live window that would leave the
buffer (no host sync), keeps the descriptors it was given for the check,
and the run raises ``SanitizerError`` (``oob-gather``) at the drain.
Outside sanitized mode the launch is exactly the unsanitized one.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import sanitize as _sanitize
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
    slot_base; see ``kernels.fused_join.fused_join_hits``. In sanitized
    mode the launch's error code is queued (module note)."""
    sanitized = _sanitize.enabled()
    ws, wc = win_start, win_count
    if sanitized:
        oob = _fused_join.oob_windows(win_start, win_count, c,
                                      points_pad.shape[0])
        ws = torch.where(oob, 0, win_start)
        wc = torch.where(oob, 0, win_count)
    out = _fused_join.fused_join_hits(
        points_pad, q_batch, ws, wc, is_zero, q_pos, eps,
        c=c, n_real=n_real, unicomp=unicomp, external=external,
        merged=merged, gid_pairs=gid_pairs, tq=tq, keep_hits=keep_hits,
        run_ord=run_ord, run_loop=run_loop, metric=metric, n_feat=n_feat,
        words=words)
    if sanitized:
        hits, counts, base = out
        code = _fused_join.sanitize_errcodes(
            points_pad, q_batch, win_start, win_count, counts, base, hits,
            c=c, tq=tq, check_hits=keep_hits, metric=metric, n_real=n_real)
        _sanitize.record(
            f"fused_join[c={c},tq={tq},merged={merged},ext={external},"
            f"metric={metric}]", code)
    return out
