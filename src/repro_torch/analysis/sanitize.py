"""Opt-in sanitized kernel mode (``REPRO_TORCH_SANITIZE=1``).

The counterpart of ``repro.analysis.sanitize``, with the same bits, names
and record-then-raise protocol. When enabled, every launch of kernel B1
through ``kernels.ops.fused_join_hits`` is followed by a device-side
error-code reduction (``kernels.fused_join.sanitize_errcodes``) over the
descriptors and outputs of the launch. The reduction stays on the device:
each launch's code, a 0-dim int32 tensor, is queued here and read to the
host only by ``raise_pending``, which the drivers call at the sync points
they already have (the fused self-join and count after their launches,
``PendingJoin.result``, ``PreparedJoin.warm``). Sanitized mode adds
device work and no host round trip in the middle of a pipeline.

Checked invariants (bitmask):

  E_OOB_GATHER     a live window would read outside the padded points
                   buffer (corrupted window start or count). The wrapper
                   hands such windows to the kernel with count and start 0,
                   so the launch reads nothing out of bounds, and the code
                   raises at the drain.
  E_CAP_OVERFLOW   a window count exceeds the launch's capacity c
                   (undersized ``cell_window_caps``).
  E_SCAN_MISMATCH  the slot bases are not the per-tile exclusive scan of
                   the counts, or (with the hit plane kept) the counts
                   disagree with the plane: the emit's writes would collide.
  E_NONFINITE      NaN/Inf in the points or query rows (for jaccard the
                   geometry lanes only: its feature lanes are token words).
  E_COUNT_RANGE    a negative window count, or a row count outside
                   [0, n_off * c].
  E_UNNORMALIZED   (cosine) a nonzero row whose squared norm is off unity
                   by more than ``core.metric.NORM_TOL`` (at half
                   precision, twice the dtype's epsilon where that is
                   larger): raw embeddings bypassed ``metric.canonicalize``.

Trust boundary: the checker recomputes with plain torch ops, never the
CUDA kernel, so the kernel and its checker cannot share a miscompile.

The queue is per thread: a service's reindex thread drains what it
launched, and a request thread what it launched.
"""
from __future__ import annotations

import os
import threading
from typing import List, Tuple

E_OOB_GATHER = 1
E_CAP_OVERFLOW = 2
E_SCAN_MISMATCH = 4
E_NONFINITE = 8
E_COUNT_RANGE = 16
E_UNNORMALIZED = 32

_NAMES = {
    E_OOB_GATHER: "oob-gather",
    E_CAP_OVERFLOW: "cap-overflow",
    E_SCAN_MISMATCH: "scan-mismatch",
    E_NONFINITE: "nonfinite",
    E_COUNT_RANGE: "count-range",
    E_UNNORMALIZED: "unnormalized-cosine",
}

ENV = "REPRO_TORCH_SANITIZE"
_FORCED = None              # set_enabled(True/False); None reads ENV
_LOCAL = threading.local()


class SanitizerError(RuntimeError):
    """A sanitized launch reported a violated kernel invariant."""


def enabled() -> bool:
    if _FORCED is not None:
        return _FORCED
    return os.environ.get(ENV, "0") not in ("", "0")


def set_enabled(value) -> None:
    """Force sanitized mode on or off; ``None`` reads the environment."""
    global _FORCED
    _FORCED = value


def decode(code: int) -> list:
    """Bit names set in an error code, e.g. ``['oob-gather']``."""
    return [name for bit, name in sorted(_NAMES.items()) if code & bit]


def _queue() -> List[Tuple[str, object]]:
    q = getattr(_LOCAL, "pending", None)
    if q is None:
        q = _LOCAL.pending = []
    return q


def record(label: str, code) -> None:
    """Queue a launch's error code (a 0-dim device tensor) for the drain."""
    _queue().append((label, code))


def pending() -> int:
    return len(_queue())


def clear() -> None:
    del _queue()[:]


def raise_pending() -> None:
    """Read every queued code to the host; raise on the first nonzero one.

    Called at the drivers' sync points, where the host waits for the device
    anyway. The codes of one device are stacked and read in one copy."""
    q = _queue()
    if not q:
        return
    queued, q[:] = q[:], []
    import torch

    by_dev: dict = {}
    for i, (_, code) in enumerate(queued):
        by_dev.setdefault(code.device, []).append(i)
    vals = [0] * len(queued)
    for idx in by_dev.values():
        host = torch.stack([queued[i][1] for i in idx]).cpu().tolist()
        for i, v in zip(idx, host):
            vals[i] = int(v)
    for (label, _), val in zip(queued, vals):
        if val:
            raise SanitizerError(
                f"sanitizer: {label}: kernel invariant violated "
                f"({'+'.join(decode(val))}, code {val})")
