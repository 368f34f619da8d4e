"""The L2 refine predicate of the self-join, in PyTorch.

The port of ``repro.core.metric`` covers the L2 metric only; cosine and
Jaccard wait for their own slice. This module is the one place that squares
epsilon, and its plain refine is an unfused IEEE sequence: one eager torch
op per add, subtract and multiply, so no multiply-add is ever contracted and
the CUDA kernel can reproduce it bit for bit.
"""
from __future__ import annotations

import torch

METRICS = ("l2",)


def check_metric(metric: str) -> str:
    if metric not in METRICS:
        raise NotImplementedError(
            f"metric {metric!r} is not ported yet (ROADMAP A8); the "
            f"PyTorch port supports {METRICS}")
    return metric


def eps_squared(eps):
    """The squared-threshold derivation (Python floats and tensors alike)."""
    return eps * eps


def l2_sq_hits(d2, eps):
    """``d2 <= eps^2`` against an unsquared threshold (the oracle form)."""
    return d2 <= eps_squared(eps)


def l2_sq_hits_presquared(d2, eps2):
    """``d2 <= eps2`` against an already-squared threshold."""
    return d2 <= eps2


def device_refine_scalar(metric: str, eps, dtype,
                         device=None) -> torch.Tensor:
    """The (1, 1) threshold the refine compares against: epsilon cast to
    the points' dtype, then squared in that dtype."""
    check_metric(metric)
    # straight to ``dtype``: a Python float through torch's default float32
    # dtype would round twice
    s = torch.as_tensor(eps, dtype=dtype, device=device)
    return torch.reshape(eps_squared(s), (1, 1))


def request_scalar(metric: str, eps: float, *, index_eps: float,
                   index_eps_geom: float) -> float:
    """Map a per-request threshold onto the kernel scalar, validating that
    the index's stencil still covers it: for l2, radii up to the build
    radius. ``index_eps_geom`` is the build radius in geometry units, which
    the cosine branch (ROADMAP A8) will need; for l2 it equals
    ``index_eps``."""
    check_metric(metric)
    if eps > index_eps * (1 + 1e-12):
        raise ValueError(
            f"query eps {eps} exceeds index build eps {index_eps}; the "
            f"adjacent-cell stencil only covers the build radius")
    return float(eps)


def plane_refine_hits(metric: str, points_pad: torch.Tensor,
                      q_batch: torch.Tensor, cand_pos: torch.Tensor,
                      scalar: torch.Tensor, *, n_real: int) -> torch.Tensor:
    """Plain refine of (Q, C) candidate positions into ``points_pad`` rows
    against the (Q, L) query rows: ``d2 = d2 + t * t`` with
    ``t = q[k] - p[k]``, lane by lane over the ``n_real`` coordinate lanes.
    Returns (Q, C) bool."""
    check_metric(metric)
    idx = cand_pos.long()
    d2 = torch.zeros(cand_pos.shape, dtype=points_pad.dtype,
                     device=points_pad.device)
    for dim in range(n_real):
        t = q_batch[:, dim][:, None] - points_pad[:, dim][idx]
        d2 = d2 + t * t
    return l2_sq_hits_presquared(d2, scalar)
