"""The metric trait of the search-and-refine pipeline, in PyTorch.

The counterpart of ``repro.core.metric``. The grid PRUNES in a geometry
space and the refine predicate DECIDES in metric space; this module is the
one place that knows both halves for every metric, and everything else
threads an opaque ``metric=`` string through to it.

  * ``l2``: the points are the geometry, no feature lanes.
  * ``cosine``: rows are unit-normalized (zero-norm or non-finite input is
    an error). On the unit sphere ``cos(a, b) >= t`` is exactly
    ``||a - b||^2 <= 2 - 2t``, so the cosine join is the L2 join at the
    chord ``sqrt(2 - 2t)`` and runs the L2 machinery and kernel unchanged.
  * ``jaccard``: token sets become packed 16-bit bitmap words riding
    feature lanes as exact float32 values, and the geometry is the 1-D set
    size: ``J(a, b) >= t`` with ``|b| >= |a|`` implies ``|b| - |a| <=
    (1 - t) S_max``, so a size grid at that width is a sound prune. The
    refine counts the intersection by popcount and keeps a pair iff
    ``union > 0`` and ``inter >= t * union``.

The canonicalization and the oracles are numpy code, copied from the JAX
package. The plain refine is an unfused IEEE sequence: one eager torch op
per add, subtract and multiply, so no multiply-add is ever contracted and
the CUDA kernel can reproduce it bit for bit. This module is the one place
that squares epsilon.

Half-precision points (float16, bfloat16; ROADMAP §C, C1). The JAX package
computes them at the half dtype, and by three rules, one per path. The port
applies the reference's rule on each path:

  path (port module)                      rule
  grid geometry, cell coordinates         f16: numpy float16 ops; bf16: the
    (core/grid.py)                          float32 promotion (grid_min f32)
  fused join, fused counts, the compact   P: one rounding to half per
    route's "fused" refine, batched,        subtract, square and add, in
    external queries (B1 (a) (b) (c))       lane order (``lane_d2``)
  unfused "jnp" / "pallas" (B4), route    S: differences rounded to half,
    "jnp", the compact route's "jnp" /      squares rounded to f16 (bf16
    "pallas", per-point counts,             squares stay exact in float32),
    brute force "jnp"                       summed in float32 in lane
                                            order, rounded to half once
                                            (``lane_d2_sum``): jnp.sum
  brute force "pallas", distance_tile     U: rows upcast to float32, the
    (B2, B3)                                expanded form in float32, eps
                                            squared at half, then upcast
  cosine (canonicalize, _unit_rows)       f16 unit rows stay f16; bf16 is
                                            not a numpy floating type, so
                                            its rows become float64
  jaccard                                 unchanged: float32 words

Every rule compares against eps rounded to the half dtype and squared
there. A Python float becomes float16 in one rounding (numpy's and XLA's
conversion; torch's own goes through float32) and bfloat16 through float32,
as ml_dtypes does (``scalar_as``). Rules S, U and rule P at bfloat16 are
what XLA computes on the CPU, slot for slot. Rule P at float16 is what
eager JAX computes; jitted, XLA departs from it on a few slots in 10^5, at
positions no rule of values reproduces, so the tests hold the port's
float16 rule-P paths to a band: every pair that differs has d^2 within one
float16 ulp of eps^2.
The JAX Pallas kernel B1 refines by rule S, not by its own lowering's rule
P, so at bfloat16 the two disagree (ROADMAP §C): the port follows the
lowering, which is what ``self_join`` computes off the TPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

METRICS = ("l2", "cosine", "jaccard")

# Jaccard bitmap packing: tokens per feature lane. Lanes hold the points'
# float dtype, so a packed word must be exact in float32: 16-bit words
# (at most 65535 < 2^24) are, 32-bit words are not.
TOKEN_BITS = 16

# |1 - ||x||^2| tolerance of "canonical cosine input": the sanitizer's
# unnormalized-cosine bit (``kernels.fused_join.sanitize_errcodes``,
# ``analysis/sanitize.py``).
NORM_TOL = 1e-3

_POPCOUNT16: Optional[np.ndarray] = None


def check_metric(metric: str) -> str:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{METRICS}")
    return metric


def metric_feat_lanes(metric: str, n_feat: int) -> int:
    """Feature lanes a metric rides in the padded points (jaccard's bitmap
    words; 0 for the others)."""
    return int(n_feat) if metric == "jaccard" else 0


# ---------------------------------------------------------------------------
# The refine predicate
# ---------------------------------------------------------------------------

def eps_squared(eps):
    """The squared-threshold derivation (Python floats and tensors alike)."""
    return eps * eps


def l2_sq_hits(d2, eps):
    """``d2 <= eps^2`` against an unsquared threshold (the oracle form)."""
    return d2 <= eps_squared(eps)


def l2_sq_hits_presquared(d2, eps2):
    """``d2 <= eps2`` against an already-squared threshold."""
    return d2 <= eps2


HALF_DTYPES = (torch.float16, torch.bfloat16)
FLOAT_DTYPES = (torch.float64, torch.float32) + HALF_DTYPES


def _on_device(x: torch.Tensor, device) -> bool:
    """``x`` lies on ``device`` (None: anywhere; "cuda": any card)."""
    if device is None:
        return True
    device = torch.device(device)
    return x.device.type == device.type and device.index in (None,
                                                            x.device.index)


def scalar_as(x, dtype, device=None) -> torch.Tensor:
    """A 0-d tensor of the scalar ``x`` in ``dtype``, rounded as numpy and
    XLA round a Python float: float16 in one rounding from float64 (torch's
    own cast goes through float32 and can round twice), everything else as
    torch casts it (bfloat16 through float32, as ml_dtypes does).

    No call waits for the device when ``x`` is a number, or a tensor that
    already has ``dtype`` on ``device``: such a tensor is returned as it is,
    and a number is rounded on the host and written on the device by a fill
    of the rounded (exact) value. A copy from host memory would synchronise
    the stream on every kernel launch that builds its scalar here."""
    if isinstance(x, torch.Tensor):
        if x.dtype == dtype and _on_device(x, device):
            return x
        if dtype == torch.float16:
            x = float(np.float16(float(x)))
        return torch.as_tensor(x, dtype=dtype, device=device)
    if dtype == torch.float16:
        x = float(np.float16(float(x)))     # exact in float16 from here
    host = torch.as_tensor(x, dtype=dtype)
    if device is None:
        return host
    return torch.full((), host.item(), dtype=dtype, device=device)


def lane_d2(q: torch.Tensor, cand_lane, n: int) -> torch.Tensor:
    """Squared L2 distance of each query row of ``q`` (B, >= n) to its
    candidates, ``cand_lane(k)`` giving the candidates' lane k as (B, C):
    ``d2 = 0``, then ``d2 = d2 + t * t`` with ``t = q[:, k] - c_k`` for
    k = 0 .. n-1 in lane order, one eager op per subtract, multiply and
    add. The one summation order of the port's plain L2 refines; kernels
    B1 and B4 sum in it too, so they agree with them bit for bit."""
    d2 = torch.zeros((), dtype=q.dtype, device=q.device)
    for k in range(n):
        t = q[:, k, None] - cand_lane(k)
        d2 = d2 + t * t
    return d2


def lane_d2_sum(q: torch.Tensor, cand_lane, n: int) -> torch.Tensor:
    """``lane_d2`` as the JAX package's ``jnp.sum(d * d, axis=-1)`` computes
    it on the CPU (rule S of the module note): each difference rounds to
    the half dtype, the squares are summed in float32 in lane order and the
    sum rounds to the half dtype once. A float16 square rounds to float16
    first; a bfloat16 square stays float32 (exact), as XLA keeps the
    product it promotes to float32 there. At float32 and float64 it is
    ``lane_d2``. Kernel B4 sums in this order too."""
    if q.dtype not in HALF_DTYPES:
        return lane_d2(q, cand_lane, n)
    d2 = torch.zeros((), dtype=torch.float32, device=q.device)
    for k in range(n):
        t = q[:, k, None] - cand_lane(k)
        sq = t * t if q.dtype == torch.float16 else t.float() * t.float()
        d2 = d2 + sq.float()
    return d2.to(q.dtype)


def device_refine_scalar(metric: str, eps, dtype,
                         device=None) -> torch.Tensor:
    """The (1, 1) scalar the refine compares against, in the points' dtype:
    epsilon squared for l2 and cosine (the geometry radius), the similarity
    threshold t itself for jaccard."""
    check_metric(metric)
    # straight to ``dtype``: a Python float through torch's default float32
    # dtype would round twice
    s = scalar_as(eps, dtype, device)
    if metric != "jaccard":
        s = eps_squared(s)
    return torch.reshape(s, (1, 1))


def popcount16(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 element of ``x`` in [0, 65535], exactly
    (shifts and masks; torch has no popcount)."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def plane_refine_hits(metric: str, points_pad: torch.Tensor,
                      q_batch: torch.Tensor, cand_pos: torch.Tensor,
                      scalar: torch.Tensor, *, n_real: int,
                      n_feat: int = 0) -> torch.Tensor:
    """Plain refine of (Q, C) candidate positions into ``points_pad`` rows
    against the (Q, L) query rows, by column gathers lane by lane.
    Returns (Q, C) bool.

    l2 and cosine: ``d2 = d2 + t * t`` with ``t = q[k] - p[k]`` over the
    ``n_real`` coordinate lanes, then ``d2 <= scalar``. jaccard: the
    intersection is the popcount of the AND of the words in lanes
    ``[n_real, n_real + n_feat)``, summed as int32 and cast to the points'
    dtype; the sizes come from lane 0, not from a popcount (a query packed
    against the index's vocabulary keeps its true size); then
    ``union = (sq + sc) - inter`` and the hit is ``union > 0 and
    inter >= scalar * union``."""
    check_metric(metric)
    idx = cand_pos.long()
    if metric == "jaccard":
        sq = q_batch[:, 0][:, None]
        sc = points_pad[:, 0][idx]
        inter = torch.zeros(cand_pos.shape, dtype=torch.int32,
                            device=points_pad.device)
        for k in range(n_feat):
            qw = q_batch[:, n_real + k].to(torch.int32)[:, None]
            cw = points_pad[:, n_real + k][idx].to(torch.int32)
            inter = inter + popcount16(qw & cw)
        inter = inter.to(points_pad.dtype)
        union = (sq + sc) - inter
        return (union > 0) & (inter >= scalar * union)
    d2 = lane_d2(q_batch, lambda k: points_pad[:, k][idx], n_real)
    return l2_sq_hits_presquared(d2, scalar)


# ---------------------------------------------------------------------------
# Canonicalization (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Canonical:
    """A dataset canonicalized for one metric.

    ``geom`` is what the grid indexes (the points for l2, unit rows for
    cosine, (N, 1) set sizes for jaccard); ``feats`` the non-geometric
    payload riding the feature lanes (packed token words for jaccard, None
    otherwise). ``eps`` is the threshold in metric units as given;
    ``eps_geom`` the grid cell width / L2 prune radius derived from it.
    """

    metric: str
    geom: np.ndarray                  # (N, n_geom)
    feats: Optional[np.ndarray]       # (N, n_feat) packed words, or None
    n_feat: int
    eps: float                        # metric-units threshold
    eps_geom: float                   # grid cell width (geometry space)
    vocab: int = 0                    # jaccard: packed vocabulary size

    @property
    def refine(self) -> float:
        """The kernel scalar, unsquared: the geometry radius for l2 and
        cosine (squared once by ``device_refine_scalar``), the threshold t
        for jaccard."""
        return self.eps if self.metric == "jaccard" else self.eps_geom


def cosine_eps_geom(eps: float) -> float:
    """The cosine -> L2 threshold on the unit sphere:
    ``cos(a,b) >= eps  <=>  ||a-b||^2 = 2 - 2cos(a,b) <= 2 - 2eps``."""
    return float(np.sqrt(max(2.0 - 2.0 * float(eps), 0.0)))


def host_rows(points) -> np.ndarray:
    """``points`` as a host numpy array. A bfloat16 tensor becomes float64,
    exactly: numpy has no bfloat16, and the JAX package casts bfloat16
    input, which numpy does not count as floating, to float64 where it
    canonicalizes."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu()
        if points.dtype == torch.bfloat16:
            points = points.double()
        return points.numpy()
    return np.asarray(points)


def _unit_rows(points, *, what: str) -> np.ndarray:
    pts = host_rows(points)
    if pts.ndim != 2:
        raise ValueError(f"{what} must be 2-D (N, d), got shape {pts.shape}")
    if not np.issubdtype(pts.dtype, np.floating):
        pts = pts.astype(np.float64)
    if not np.isfinite(pts).all():
        bad = np.flatnonzero(~np.isfinite(pts).all(axis=1))
        raise ValueError(
            f"cosine metric: {what} rows {bad[:8].tolist()} contain "
            f"non-finite values; clean the embeddings before joining")
    norms = np.linalg.norm(pts, axis=1)
    zero = np.flatnonzero(norms == 0)
    if zero.size:
        raise ValueError(
            f"cosine metric: {what} rows {zero[:8].tolist()} have zero "
            f"norm; direction is undefined for the zero vector")
    return pts / norms[:, None]


def pack_tokens(sets, *, vocab: Optional[int] = None
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack token sets into (sizes, words, vocab).

    ``sets`` is a sequence of token-id iterables or an (N, V) binary
    membership matrix. Returns float32 ``sizes`` (N,), the true set sizes
    counting every distinct token, and float32 ``words``
    (N, ceil(vocab / TOKEN_BITS)) holding exact 16-bit packed words. With
    an explicit ``vocab`` (queries packed against an index's vocabulary),
    out-of-vocabulary tokens count toward the size but set no bit: they
    cannot meet an indexed set, so the intersection stays exact and the
    union uses the true size.
    """
    if isinstance(sets, np.ndarray) and sets.ndim == 2:
        mask = np.asarray(sets) != 0
        ind = [np.flatnonzero(row) for row in mask]
    else:
        ind = []
        for s in sets:
            toks = np.unique(np.asarray(list(s), dtype=np.int64))
            if toks.size and toks[0] < 0:
                raise ValueError("jaccard metric: token ids must be >= 0")
            ind.append(toks)
    sizes = np.asarray([t.size for t in ind], np.float32)
    max_tok = max((int(t[-1]) for t in ind if t.size), default=-1)
    if vocab is None:
        vocab = max_tok + 1
        clip = False
    else:
        vocab = int(vocab)
        clip = True
    n_words = max(-(-max(vocab, 1) // TOKEN_BITS), 1)
    words = np.zeros((len(ind), n_words), np.uint16)
    for i, toks in enumerate(ind):
        if clip:
            toks = toks[toks < vocab]
        if toks.size:
            np.bitwise_or.at(
                words[i], toks // TOKEN_BITS,
                (np.uint16(1) << (toks % TOKEN_BITS).astype(np.uint16)))
    return sizes, words.astype(np.float32), int(vocab)


def canonicalize(points, eps, *, metric: str = "l2",
                 vocab: Optional[int] = None) -> Canonical:
    """Canonicalize a dataset for one metric (the index-build side)."""
    check_metric(metric)
    if metric == "l2":
        # a tensor stays one: bfloat16 points have no numpy form
        geom = (points if isinstance(points, torch.Tensor)
                else np.asarray(points))
        if geom.ndim != 2:
            raise ValueError(f"points must be 2-D, got shape {geom.shape}")
        e = float(eps)
        return Canonical("l2", geom, None, 0, e, e)
    if metric == "cosine":
        e = float(eps)
        if not (-1.0 <= e < 1.0):
            raise ValueError(
                f"cosine threshold must lie in [-1, 1), got {e}; it is a "
                f"minimum cosine SIMILARITY, not a distance")
        geom = _unit_rows(points, what="points")
        return Canonical("cosine", geom, None, 0, e, cosine_eps_geom(e))
    t = float(eps)
    if not (0.0 < t <= 1.0):
        raise ValueError(
            f"jaccard threshold must lie in (0, 1], got {t}; it is a "
            f"minimum Jaccard similarity")
    sizes, words, vocab = pack_tokens(points, vocab=vocab)
    s_max = float(sizes.max()) if sizes.size else 0.0
    # |b| >= |a| and J >= t  =>  |b| - |a| <= (1-t)|b| <= (1-t)S_max; the
    # floor of 1 keeps a positive cell width at t = 1 (exact duplicates)
    eps_geom = max((1.0 - t) * s_max, 1.0)
    geom = sizes[:, None]
    return Canonical("jaccard", geom, words, words.shape[1], t, eps_geom,
                     vocab)


def canonicalize_queries(canon: Canonical, queries
                         ) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Canonicalize an external query batch against an indexed dataset's
    canonical form: (geometry rows, feature rows or None)."""
    if canon.metric == "l2":
        return np.asarray(queries), None
    if canon.metric == "cosine":
        return _unit_rows(queries, what="queries"), None
    sizes, words, _ = pack_tokens(queries, vocab=canon.vocab)
    return sizes[:, None].astype(canon.geom.dtype), words


def request_scalar(metric: str, eps: float, *, index_eps: float,
                   index_eps_geom: float) -> float:
    """Map a per-request threshold (metric units) onto the kernel scalar,
    checking that the index's stencil still covers it.

    l2: radii up to the build radius. cosine: similarities at or above the
    build threshold (a lower floor is a larger radius than the grid was
    built for); the scalar is the chord, at most the build chord. jaccard:
    thresholds at or above the build threshold, and the scalar is t itself
    (a stricter t shrinks the size prune, so the built windows still hold
    every candidate).
    """
    check_metric(metric)
    if metric == "l2":
        if eps > index_eps * (1 + 1e-12):
            raise ValueError(
                f"query eps {eps} exceeds index build eps {index_eps}; the "
                f"adjacent-cell stencil only covers the build radius")
        return float(eps)
    if metric == "cosine":
        if eps < index_eps - 1e-12:
            raise ValueError(
                f"query cosine threshold {eps} is below the index build "
                f"threshold {index_eps}; a lower similarity floor needs a "
                f"rebuilt grid")
        geom = cosine_eps_geom(eps)
        return float(min(geom, index_eps_geom))
    if eps < index_eps - 1e-12:
        raise ValueError(
            f"query jaccard threshold {eps} is below the index build "
            f"threshold {index_eps}; a looser threshold needs a rebuilt "
            f"grid")
    return float(eps)


# ---------------------------------------------------------------------------
# Brute-force oracles
# ---------------------------------------------------------------------------

def _popcount16_table() -> np.ndarray:
    global _POPCOUNT16
    if _POPCOUNT16 is None:
        bits = np.unpackbits(
            np.arange(65536, dtype=np.uint16).view(np.uint8).reshape(-1, 2),
            axis=1)
        _POPCOUNT16 = bits.sum(axis=1).astype(np.uint8)
    return _POPCOUNT16


def _jaccard_brute_hits(canon: Canonical, block: int = 512) -> np.ndarray:
    """(K, 2) ordered hit pairs (both directions, self excluded) by exact
    bitmap intersection, with the kernel's float comparison."""
    words = canon.feats.astype(np.uint16)
    sizes = canon.geom[:, 0].astype(canon.geom.dtype)
    t = canon.geom.dtype.type(canon.eps)
    table = _popcount16_table()
    n = words.shape[0]
    out = []
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        inter = table[words[lo:hi, None, :] & words[None, :, :]] \
            .sum(axis=-1, dtype=np.int64)
        inter_f = inter.astype(canon.geom.dtype)
        union = sizes[lo:hi, None] + sizes[None, :] - inter_f
        hit = (union > 0) & (inter_f >= t * union)
        hit[np.arange(lo, hi) - lo, np.arange(lo, hi)] = False
        a, b = np.nonzero(hit)
        out.append(np.stack([a + lo, b], axis=1).astype(np.int32))
    if not out:
        return np.empty((0, 2), np.int32)
    return np.concatenate(out, axis=0)


def brute_force_join_metric(canon: Canonical, *, tile: int = 256,
                            device=None) -> np.ndarray:
    """Metric-generic brute-force oracle: lexsorted (K, 2) ordered pairs,
    as numpy. l2 and cosine go to the blocked L2 oracle
    (``core.brute.brute_force_join``, on ``device``: CUDA by default) on
    the canonical geometry at the derived radius; jaccard runs the exact
    bitmap intersection on the host."""
    if canon.metric in ("l2", "cosine"):
        from repro_torch.core import brute
        return brute.brute_force_join(canon.geom, canon.eps_geom, tile=tile,
                                      device=device).cpu().numpy()
    pairs = _jaccard_brute_hits(canon)
    if pairs.shape[0]:
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    return pairs


def brute_force_count_metric(canon: Canonical, *, tile: int = 256,
                             device=None) -> int:
    """Ordered-pair count under the metric's brute-force oracle."""
    if canon.metric in ("l2", "cosine"):
        from repro_torch.core import brute
        return brute.brute_force_count(canon.geom, canon.eps_geom, tile=tile,
                                       device=device)
    return int(_jaccard_brute_hits(canon).shape[0])


def jaccard_similarity(a, b) -> float:
    """Exact Jaccard similarity of two token iterables (a test helper)."""
    sa, sb = set(a), set(b)
    if not sa and not sb:
        return 0.0
    return len(sa & sb) / len(sa | sb)
