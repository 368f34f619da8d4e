"""The port's brute-force baseline and distance tiles, held to the JAX package.

The tiles' plain versions compute d2 in the expanded form the TPU kernels
compute, (|q|^2 + |p|^2) - 2 q.p. On seeded random data they must equal the
JAX package's ``distance_tile_hits`` / ``distance_tile_counts`` (Pallas, in
interpret mode) exactly, as JAX's own tests hold those to the direct-form
oracle. On lattice data with many d2 near eps^2 the two forms may differ, but
only inside the rounding band stated in ``_band``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro_torch
from repro.core import brute as jbrute
from repro.kernels import distance_tile as jdt
from repro_torch.core import brute as tbrute
from repro_torch.kernels import distance_tile as tdt
from torch_workloads import SMOKE
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

DIMS = [2, 3, 4, 5, 6]
DTYPES = [np.float32, np.float64]


@pytest.mark.parametrize("n", DIMS)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nq,npts", [(1, 1), (7, 500), (256, 256), (300, 1000)])
def test_distance_tile_hits_matches_jax(n, dt, nq, npts):
    rng = np.random.default_rng(n * 100 + npts)
    q = rng.uniform(0, 10, (nq, n)).astype(dt)
    p = rng.uniform(0, 10, (npts, n)).astype(dt)
    want = np.asarray(jdt.distance_tile_hits(jnp.asarray(q), jnp.asarray(p),
                                             1.3, interpret=True))
    got = tdt.distance_tile_hits(torch.as_tensor(q), torch.as_tensor(p), 1.3)
    assert got.dtype == torch.bool and got.shape == (nq, npts)
    assert np.array_equal(got.numpy(), want)
    oracle = tdt.distance_tile_hits_ref(torch.as_tensor(q),
                                        torch.as_tensor(p), 1.3)
    assert torch.equal(got, oracle)


@pytest.mark.parametrize("n", [2, 4, 6])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("npts", [3, 129, 700])
def test_distance_tile_counts_matches_jax(n, dt, npts):
    p = np.random.default_rng(n + npts).uniform(0, 5, (npts, n)).astype(dt)
    want = np.asarray(jdt.distance_tile_counts(jnp.asarray(p), 0.9,
                                               interpret=True))
    got = tdt.distance_tile_counts(torch.as_tensor(p), 0.9)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, tdt.distance_tile_counts_ref(torch.as_tensor(p),
                                                         0.9))


def _lattice(n, dtype):
    """Points on a 0.1-spaced lattice, shifted to 10: many pairs lie at
    exactly eps = 0.2 in real arithmetic, and none in floating point."""
    g = 10.0 + 0.1 * np.arange(8)
    pts = np.stack(np.meshgrid(*([g] * n), indexing="ij"), -1).reshape(-1, n)
    return pts.astype(dtype)


def _band(pts, dtype):
    """|d2 - eps^2| at or under which the two forms may round to different
    sides of eps^2. The expanded form subtracts 2 q.p from qn + pn; each of
    the three is a sum of n rounded products no larger than qn + pn, so the
    difference carries an absolute error of at most (2n + 2) u (qn + pn),
    u = 2^-53 (f64) or 2^-24 (f32): under 8 u (qn + pn), that is
    2^-50 (qn + pn) or 2^-21 (qn + pn), for n <= 3. The direct form's error
    is relative to d2 itself and far smaller. d2 and the norms here are
    exact sums in float64 of the dtype's values."""
    x = pts.astype(np.float64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    sq = (x ** 2).sum(-1)
    scale = 2.0 ** -50 if dtype == np.float64 else 2.0 ** -21
    return d2, (sq[:, None] + sq[None, :]) * scale


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lattice_expanded_form_differs_only_in_band(n, dtype):
    pts = _lattice(n, dtype)
    eps = 0.2
    d2, band = _band(pts, dtype)
    eps2 = float(np.asarray(eps, dtype)) ** 2
    sure = np.abs(d2 - eps2) > band
    assert (~sure).sum() > 100          # many pairs sit on the boundary
    t = torch.as_tensor(pts)
    got = tdt.distance_tile_hits(t, t, eps).numpy()
    direct = tdt.distance_tile_hits_ref(t, t, eps).numpy()
    jax_hits = np.asarray(jdt.distance_tile_hits(jnp.asarray(pts),
                                                 jnp.asarray(pts), eps,
                                                 interpret=True))
    assert np.array_equal(got[sure], direct[sure])
    assert np.array_equal(got[sure], jax_hits[sure])
    assert (got != direct).any()        # the forms do round differently
    counts = tdt.distance_tile_counts(t, eps).numpy()
    want = tdt.distance_tile_counts_ref(t, eps).numpy()
    np.fill_diagonal(sure, True)
    differs = counts != want
    assert sure[differs].all(axis=1).sum() == 0   # no difference outside


def test_distance_tile_rejects_bf16_and_cpu_kernel():
    """bfloat16 rows were refused until kernel B2-bf16 was ported; they now
    compute, and equal the JAX package's tiles in interpret mode exactly.
    The kernel on CPU tensors is still refused."""
    import ml_dtypes

    rng = np.random.default_rng(11)
    x = rng.uniform(0, 10, (300, 2)).astype(ml_dtypes.bfloat16)
    q = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    want = np.asarray(jdt.distance_tile_hits(jnp.asarray(x[:40]),
                                             jnp.asarray(x), 1.3,
                                             interpret=True))
    assert np.array_equal(tdt.distance_tile_hits(q[:40], q, 1.3).numpy(),
                          want)
    want = np.asarray(jdt.distance_tile_counts(jnp.asarray(x), 1.3,
                                               interpret=True))
    assert np.array_equal(tdt.distance_tile_counts(q, 1.3).numpy(), want)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdt.distance_tile_counts(q.double(), 1.0, method="kernel")


@pytest.fixture(scope="module")
def jax_brute():
    cache = {}

    def get(workload):
        if workload not in cache:
            pts, eps = SMOKE[workload]
            cache[workload] = (jbrute.brute_force_count(pts, eps),
                               jbrute.brute_force_join(pts, eps))
        return cache[workload]

    return get


@pytest.mark.parametrize("workload", list(SMOKE))
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_brute_force_matches_jax_and_self_join(jax_brute, workload, impl):
    pts, eps = SMOKE[workload]
    want_count, want_pairs = jax_brute(workload)
    count = repro_torch.brute_force_count(pts, eps, distance_impl=impl,
                                          device="cpu")
    pairs = repro_torch.brute_force_join(pts, eps, distance_impl=impl,
                                         device="cpu")
    assert count == want_count == want_pairs.shape[0] > 0
    assert pairs.dtype == torch.int32
    assert np.array_equal(pairs.numpy(), want_pairs)
    assert torch.equal(pairs, repro_torch.self_join(pts, eps, device="cpu"))


def test_brute_force_pallas_matches_jax_pallas():
    pts, eps = SMOKE["expo-3d"]
    want = jbrute.brute_force_count(pts, eps, distance_impl="pallas")
    assert repro_torch.brute_force_count(pts, eps, distance_impl="pallas",
                                         tile=256, device="cpu") == want


def test_brute_force_entry_points_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, eps = SMOKE["uniform-2d"]
    for fn in (tbrute.brute_force_count, tbrute.brute_force_join):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(pts[:100], eps)
    with pytest.raises(ValueError, match="distance_impl"):
        tbrute.brute_force_count(pts[:100], eps, distance_impl="nope",
                                 device="cpu")
