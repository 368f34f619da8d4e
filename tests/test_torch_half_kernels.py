"""The plain versions of the ported kernels at float16 and bfloat16, held to
the JAX package's kernels on the CPU.

  * B2 / B3 (``distance_tile_hits`` / ``_counts``, kernel B2-bf16): rule U
    of ``repro_torch/core/metric.py``'s note, rows upcast to float32, the
    expanded form in float32, eps squared at the half dtype. Held to JAX's
    Pallas kernels in interpret mode, exactly, and through brute force
    "pallas" and "jnp" (rule S) to JAX's brute force, exactly.
  * B4 (``cell_join_hits``): rule S, the ``jnp.sum`` of squares. Held to
    JAX's Pallas kernel in interpret mode and its ``ref`` oracle, exactly.
  * B1 (``fused_join_hits``, plain): rule P, one rounding per operation.
    Held to JAX's reference lowering on whole launches: exactly at
    bfloat16; at float16 the hits may differ from XLA's jitted float16 code
    only on slots whose d^2 lies within one float16 ulp of eps^2, at most
    ``BAND_SLOTS`` of them (the counts and slot bases follow the hits).

Inputs are made with numpy from a seed; JAX gets numpy float16 or ml_dtypes
bfloat16 arrays, the port the same values as torch tensors. The kernels
themselves are held to these plain versions on the card
(``tests/test_torch_kernel_cuda.py``).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.grid as jgrid
import repro.core.selfjoin as jsj
import repro_torch
from repro.core import brute as jbrute
from repro.kernels import cell_join as jcj
from repro.kernels import distance_tile as jdt
from repro.kernels import fused_join as jfj
from repro.kernels import ref as jref
from repro_torch.kernels import cell_join as tcj
from repro_torch.kernels import distance_tile as tdt
from repro_torch.kernels import fused_join as tfj
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

BF16 = ml_dtypes.bfloat16
HALVES = {"f16": (np.float16, torch.float16), "bf16": (BF16, torch.bfloat16)}
BAND_SLOTS = 8
TQ = tfj.TQ_DEFAULT


def as_jax(x, half):
    return np.asarray(x).astype(HALVES[half][0])


def as_torch(x, half):
    return torch.from_numpy(as_jax(x, half).astype(np.float32)).to(
        HALVES[half][1])


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("n", [2, 3, 6])
@pytest.mark.parametrize("nq,npts", [(1, 1), (7, 500), (300, 1000)])
def test_distance_tiles_match_jax(half, n, nq, npts):
    """B2 and B3's plain versions against the Pallas tiles in interpret
    mode, at an eps that rounds in both half dtypes (1.3) and at one where
    about half the pairs hit."""
    rng = np.random.default_rng(n * 100 + npts)
    q = rng.uniform(0, 10, (nq, n))
    p = rng.uniform(0, 10, (npts, n))
    for eps in (1.3, 2.05 * np.sqrt(n)):
        want = np.asarray(jdt.distance_tile_hits(
            jnp.asarray(as_jax(q, half)), jnp.asarray(as_jax(p, half)), eps,
            interpret=True))
        got = tdt.distance_tile_hits(as_torch(q, half), as_torch(p, half),
                                     eps)
        assert got.dtype == torch.bool and tuple(got.shape) == (nq, npts)
        assert np.array_equal(got.numpy(), want)
        want = np.asarray(jdt.distance_tile_counts(
            jnp.asarray(as_jax(p, half)), eps, interpret=True))
        got = tdt.distance_tile_counts(as_torch(p, half), eps)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    assert want.sum() > 0 or npts == 1


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_brute_force_matches_jax(half, impl):
    """brute_force_count / _join: "pallas" through B2's plain version
    (rule U), "jnp" through the plain block (rule S)."""
    pts = np.random.default_rng(2).uniform(0, 30, (1200, 2))
    want = jbrute.brute_force_count(as_jax(pts, half), 1.3,
                                    distance_impl=impl)
    got = repro_torch.brute_force_count(as_torch(pts, half), 1.3,
                                        distance_impl=impl, device="cpu")
    assert got == want > 0
    want = jbrute.brute_force_join(as_jax(pts, half), 1.3,
                                   distance_impl=impl)
    got = repro_torch.brute_force_join(as_torch(pts, half), 1.3,
                                       distance_impl=impl, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("b,c", [(1, 8), (57, 24), (600, 40)])
def test_cell_join_plain_matches_jax(half, n, b, c):
    """B4's plain version against the Pallas kernel in interpret mode,
    exactly (rule S), and against the ``ref`` oracle at float16. At
    bfloat16 JAX's oracle rounds each square to bfloat16 and its kernel
    does not (ROADMAP §C): the port follows the kernel, which is what
    ``distance_impl="pallas"`` and "jnp" compute."""
    rng = np.random.default_rng(b * 7 + c + n)
    q = rng.uniform(0, 10, (b, n))
    cand = rng.uniform(0, 10, (b, c, n))
    valid = rng.random((b, c)) < 0.7
    for eps in (1.3, 4.1 * np.sqrt(n)):
        jargs = (jnp.asarray(as_jax(q, half)),
                 jnp.asarray(as_jax(cand, half)), jnp.asarray(valid))
        kernel = np.asarray(jcj.cell_join_hits(*jargs, eps, interpret=True))
        oracle = np.asarray(jref.cell_join_hits_ref(*jargs, eps))
        got = tcj.cell_join_hits(as_torch(q, half), as_torch(cand, half),
                                 torch.as_tensor(valid), eps)
        assert np.array_equal(got.numpy(), kernel)
        if half == "f16":
            assert np.array_equal(got.numpy(), oracle)


def _launch(pts, eps, merged, unicomp):
    """One contiguous launch at the global window capacity, prepared by the
    JAX package, as numpy arrays."""
    jidx = jgrid.build_grid(pts, eps)
    c = jgrid.global_window_cap(jidx, merged)
    pp, qp = jsj._fused_pad(jidx, q_size=jidx.num_points, c=c, tq=TQ,
                            merged=merged)
    tables = jsj._merged_offset_tables if merged else jsj._offset_tables
    deltas, is_zero = tables(jidx, unicomp)
    ws, wc, _, qb, qpos = jsj._fused_prep(
        jidx, pp, deltas, jnp.asarray(0, jnp.int32), qp=qp,
        q_limit=jidx.num_points, merged=merged)
    return jidx, [pp, qb, ws, wc, is_zero.astype(jnp.int32), qpos], c


def _to_torch(a, half):
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("unicomp", [True, False])
def test_fused_plain_matches_jax_reference(half, merged, unicomp):
    """B1's plain version on a whole launch against the JAX reference
    lowering (what ``self_join`` runs off the TPU): hits, counts and slot
    bases; at float16 within the band of the module note."""
    raw = np.random.default_rng(6).uniform(0, 20, (1500, 2))
    pts = as_jax(raw, half)
    jidx, arrays, c = _launch(pts, 1.3, merged, unicomp)
    kw = dict(c=c, n_real=2, unicomp=unicomp, merged=merged, tq=TQ)
    want = jfj.fused_join_hits(*[jnp.asarray(a) for a in arrays], jidx.eps,
                               method="reference", **kw)
    got = tfj.fused_join_hits(*[_to_torch(a, half) for a in arrays],
                              _to_torch(jidx.eps, half), method="reference",
                              **kw)
    hits, counts, base = (g.numpy() for g in got)
    whits, wcounts, wbase = (np.asarray(w) for w in want)
    if half == "bf16":
        assert np.array_equal(hits, whits)
    else:
        off, row, slot = np.nonzero(hits != whits)
        print(f"float16 rule-P band: {off.size} slots differ from JAX")
        assert off.size <= BAND_SLOTS
        pp = np.asarray(arrays[0]).astype(np.float64)
        qb = np.asarray(arrays[1]).astype(np.float64)
        cand = np.asarray(arrays[2])[off, row] + slot
        r = lambda x: x.astype(np.float16).astype(np.float64)  # noqa: E731
        d2 = np.zeros(off.size)
        for k in range(2):
            t = r(qb[row, k] - pp[cand, k])
            d2 = r(d2 + r(t * t))
        e2 = float(np.float16(float(np.float16(1.3)) ** 2))
        assert np.all(np.abs(d2 - e2) <= float(np.spacing(np.float16(e2))))
        # the counts and slot bases are those of the port's own hits
        wcounts = hits.astype(np.int32).sum(axis=(0, 2))
        ct = wcounts.reshape(-1, TQ)
        wbase = (np.cumsum(ct, axis=1) - ct).reshape(-1)
    assert np.array_equal(counts, wcounts)
    assert np.array_equal(base, wbase)
    assert hits.sum() > 0
