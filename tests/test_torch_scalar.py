"""The refine scalar, built without waiting for the device, on the CPU.

``metric.scalar_as`` and ``metric.device_refine_scalar`` build the scalar
every kernel wrapper (B1, B2, B3, B4) hands its kernel. They round a number
on the host and fill the rounded value in on the device, and pass a tensor
that already has the dtype and device through as it is, so that no call
synchronises the stream. The bits must be those of the formula they had
when they copied the number from host memory:

    float16:  torch.as_tensor(float(np.float16(float(x))), dtype=float16)
    others:   torch.as_tensor(x, dtype=dtype)

and the JAX package's ``device_refine_scalar``. On the card,
``tests/test_torch_kernel_cuda.py`` runs each kernel's wrapper under
``torch.cuda.set_sync_debug_mode("error")``.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import metric as jmetric
from repro_torch.core import metric as tmetric

DTYPES = {"f64": torch.float64, "f32": torch.float32, "f16": torch.float16,
          "bf16": torch.bfloat16}
JAX_DTYPES = {"f64": jnp.float64, "f32": jnp.float32, "f16": jnp.float16,
              "bf16": ml_dtypes.bfloat16}
INT_VIEW = {8: torch.int64, 4: torch.int32, 2: torch.int16}
# values around every dtype's range: a float16 overflow of 65519.99
# (rounds to 65504), a float16 subnormal, an eps^2 of +inf in every dtype
FIXED = [0.1, 0.2, 1.3, 1e-8, 2049.3, 65519.99, 1e160, 0.0]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(INT_VIEW[t.element_size()])


def formula_before(x, dtype) -> torch.Tensor:
    """The scalar as ``scalar_as`` made it before: a copy of the rounded
    number (float16 rounded once, from float64, by numpy)."""
    if dtype == torch.float16:
        return torch.as_tensor(float(np.float16(float(x))), dtype=dtype)
    return torch.as_tensor(x, dtype=dtype)


def refine_before(metric: str, x, dtype) -> torch.Tensor:
    s = formula_before(x, dtype)
    if metric != "jaccard":
        s = s * s
    return s.reshape(1, 1)


def seeded_values(seed: int, count: int = 200) -> list:
    """Log-uniform values over 1e-12 .. 1e6, and values a hair off a
    float16 rounding tie (where rounding through float32 first would
    round twice)."""
    rng = np.random.default_rng(seed)
    wide = 10.0 ** rng.uniform(-12, 6, count // 2)
    mant = rng.integers(1024, 2048, count - count // 2) + 0.5
    off = rng.choice([-1.0, 1.0], mant.size) * 2.0 ** -30
    ties = (mant + off) * 2.0 ** rng.integers(-20, 5, mant.size)
    return [float(v) for v in np.concatenate([wide, ties])]


def check_number(x, dtype, dname: str) -> None:
    cpu = torch.device("cpu")
    want = formula_before(x, dtype)
    for device in (None, cpu, "cpu"):
        got = tmetric.scalar_as(x, dtype, device)
        assert got.dtype == dtype and got.shape == () and got.device == cpu
        assert torch.equal(bits(got), bits(want)), (x, device)
    for metric in ("l2", "cosine", "jaccard"):
        got = tmetric.device_refine_scalar(metric, x, dtype, cpu)
        assert got.shape == (1, 1) and got.dtype == dtype
        assert torch.equal(bits(got), bits(refine_before(metric, x, dtype)))
        jax = np.asarray(jmetric.device_refine_scalar(metric, x,
                                                      JAX_DTYPES[dname]))
        assert np.array_equal(
            got.double().numpy(), jax.astype(np.float64), equal_nan=True), \
            (metric, x)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("x", FIXED)
def test_number_rounds_as_before(dname, x):
    """A Python float and a numpy float64 give the bits of the formula the
    scalar had, and of the JAX package's scalar, for each metric."""
    check_number(x, DTYPES[dname], dname)
    check_number(np.float64(x), DTYPES[dname], dname)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("seed", range(4))
def test_seeded_numbers_round_as_before(dname, seed):
    for x in seeded_values(seed):
        check_number(x, DTYPES[dname], dname)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("x", FIXED + [2049.25])
def test_tensor_of_the_dtype_passes_through(dname, x):
    """A tensor of the dtype on the device comes back as the same tensor,
    its storage unchanged, and the refine scalar built from it has the bits
    the formula gave it before."""
    dtype = DTYPES[dname]
    t = formula_before(x, dtype)
    before = bits(t).clone()
    for device in (None, t.device, "cpu"):
        assert tmetric.scalar_as(t, dtype, device) is t
    for metric in ("l2", "jaccard"):
        got = tmetric.device_refine_scalar(metric, t, dtype, t.device)
        assert torch.equal(bits(got), bits(refine_before(metric, t, dtype)))
    assert torch.equal(bits(t), before)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_tensor_of_another_dtype_rounds_as_before(dname):
    """A float64 tensor cast to another dtype rounds as a number does."""
    dtype = DTYPES[dname]
    for x in seeded_values(9, 40) + FIXED:
        got = tmetric.scalar_as(torch.tensor(x, dtype=torch.float64), dtype,
                                "cpu")
        assert got.dtype == dtype
        assert torch.equal(bits(got), bits(formula_before(x, dtype))), x
