"""Kernel B4's plain version (the unfused sweep's candidate refine), held to
the JAX package's ``cell_join_hits``.

The inputs are those of ``tests/test_kernels.py``'s B4 sweep, made with numpy
from a seed and handed to both packages; JAX runs its Pallas kernel in
interpret mode and its ``ref`` oracle, and the port's plain version must
equal both exactly. Boundary semantics are checked on integer data, where
every d^2 is exact and many land on eps^2, against an integer brute force.
The kernel itself is held to the plain version on the card
(``tests/test_torch_kernel_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import cell_join as jcj
from repro.kernels import ref as jref
from repro_torch.kernels import cell_join as tcj
from repro_torch.kernels import ops as tops
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

DIMS = [2, 3, 4, 5, 6]
DTYPES = [np.float32, np.float64]


def _inputs(n, dt, b, c):
    rng = np.random.default_rng(b * 7 + c)
    q = rng.uniform(0, 10, (b, n)).astype(dt)
    cand = rng.uniform(0, 10, (b, c, n)).astype(dt)
    valid = rng.random((b, c)) < 0.7
    return q, cand, valid


@pytest.mark.parametrize("n", DIMS)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,c", [(1, 8), (57, 24), (512, 8), (600, 40)])
def test_plain_version_matches_jax(n, dt, b, c):
    """At the JAX test's eps 1.1 (few hits) and at ~4.1 sqrt(n), where
    about half the slots of these uniform rows hit."""
    q, cand, valid = _inputs(n, dt, b, c)
    jargs = (jnp.asarray(q), jnp.asarray(cand), jnp.asarray(valid))
    targs = (torch.as_tensor(q), torch.as_tensor(cand),
             torch.as_tensor(valid))
    before = tcj.KERNEL_LAUNCHES
    for eps in (1.1, 4.1 * np.sqrt(n)):
        kernel = np.asarray(jcj.cell_join_hits(*jargs, eps, interpret=True))
        oracle = np.asarray(jref.cell_join_hits_ref(*jargs, eps))
        got = tcj.cell_join_hits(*targs, eps)
        assert got.dtype == torch.bool and tuple(got.shape) == (b, c)
        assert np.array_equal(got.numpy(), kernel)
        assert np.array_equal(got.numpy(), oracle)
    assert oracle.any() and not oracle.all() or b * c < 64
    # a CPU tensor never reaches the kernel
    assert tcj.KERNEL_LAUNCHES == before


def test_all_invalid():
    q = torch.zeros((16, 3), dtype=torch.float64)
    cand = torch.zeros((16, 8, 3), dtype=torch.float64)
    valid = torch.zeros((16, 8), dtype=torch.bool)
    assert not tcj.cell_join_hits(q, cand, valid, 1.0).any()
    assert tcj.cell_join_hits(q, cand, ~valid, 1.0).all()
    want = jcj.cell_join_hits(jnp.zeros((16, 3)), jnp.zeros((16, 8, 3)),
                              jnp.zeros((16, 8), bool), 1.0, interpret=True)
    assert not np.asarray(want).any()


@pytest.mark.parametrize("dt", DTYPES)
def test_lattice_boundary_hits_exact(dt):
    """Integer coordinates at eps = 2: d^2 is exact and lands on eps^2 = 4
    for many slots. Held to an integer brute force and to JAX."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 5, (300, 3))
    cand = rng.integers(0, 5, (300, 16, 3))
    valid = rng.random((300, 16)) < 0.8
    d2 = ((q[:, None, :] - cand) ** 2).sum(-1)
    want = (d2 <= 4) & valid
    assert (d2 == 4).sum() > 100
    got = tcj.cell_join_hits(torch.as_tensor(q.astype(dt)),
                             torch.as_tensor(cand.astype(dt)),
                             torch.as_tensor(valid), 2.0)
    assert np.array_equal(got.numpy(), want)
    jgot = jcj.cell_join_hits(jnp.asarray(q.astype(dt)),
                              jnp.asarray(cand.astype(dt)),
                              jnp.asarray(valid), 2.0, interpret=True)
    assert np.array_equal(np.asarray(jgot), want)


def test_cand_cast_to_query_dtype_and_ops_passes_through():
    q, cand, valid = _inputs(3, np.float64, 57, 24)
    want = tcj.cell_join_hits(torch.as_tensor(q),
                              torch.as_tensor(cand.astype(np.float32)
                                              .astype(np.float64)),
                              torch.as_tensor(valid), 1.1)
    got = tops.cell_join_hits(torch.as_tensor(q),
                              torch.as_tensor(cand.astype(np.float32)),
                              torch.as_tensor(valid.astype(np.int8)), 1.1)
    assert torch.equal(got, want)


def test_refuses_what_it_cannot_run():
    q, cand, valid = (torch.as_tensor(a) for a in _inputs(2, np.float64, 4,
                                                          8))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tcj.cell_join_hits(q, cand, valid, 1.0, method="kernel")
    with pytest.raises(ValueError, match="unknown cell_join method"):
        tcj.cell_join_hits(q, cand, valid, 1.0, method="nope")
    with pytest.raises(ValueError, match="expected q"):
        tcj.cell_join_hits(q, cand[:, :, :1], valid, 1.0)
    with pytest.raises(ValueError, match="expected q"):
        tcj.cell_join_hits(q, cand, valid[:, :4], 1.0)
    with pytest.raises(TypeError, match="float32/float64"):
        tcj.cell_join_hits(q.to(torch.int64), cand, valid, 1.0)
    # the plain version on request, on the CPU
    assert torch.equal(tcj.cell_join_hits(q, cand, valid, 1.0,
                                          method="reference"),
                       tcj.cell_join_hits(q, cand, valid, 1.0))
