"""The CUDA fused-join kernel against its plain PyTorch version, on a card.

The kernel has no CPU mode, so these tests skip without a CUDA device. They
import neither JAX nor the JAX package, so they run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py

(``--noconftest`` because ``tests/conftest.py`` clears JAX's caches.)
"""
import numpy as np
import pytest
import torch

from repro_torch.core import grid as tgrid
from repro_torch.core import selfjoin as tsj
from repro_torch.kernels import fused_join as tfj


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("unicomp", [True, False])
def test_kernel_matches_plain_version(cuda_device, dtype, merged, unicomp):
    """Every launch of an expo-3d sweep, hits plane on and off: hits,
    counts and slot_base equal bit for bit."""
    pts = np.random.default_rng(5).exponential(10.0, (3000, 3))
    index = tgrid.build_grid(torch.as_tensor(pts).to(dtype), 1.2,
                             device=cuda_device)
    tables = tsj._merged_offset_tables if merged else tsj._offset_tables
    deltas, is_zero = tables(index, unicomp)
    launches, points_pad, _ = tsj._fused_launches(index, bucketed=None,
                                                  merged=merged)
    for launch in launches:
        ws, wc, _, qb, qpos = tsj._launch_prep(index, points_pad, deltas,
                                               launch, merged=merged)
        for keep_hits in (True, False):
            kw = dict(c=launch[4], n_real=3, unicomp=unicomp, merged=merged,
                      tq=launch[5], keep_hits=keep_hits)
            a = tfj.fused_join_hits(points_pad, qb, ws, wc, is_zero, qpos,
                                    index.eps, method="kernel", **kw)
            b = tfj.fused_join_hits(points_pad, qb, ws, wc, is_zero, qpos,
                                    index.eps, method="reference", **kw)
            for x, y in zip(a, b):
                assert torch.equal(x, y)


def test_self_join_on_card_matches_cpu(cuda_device):
    """The whole join on the card (kernel and device emit) gives the pair
    set of the plain version on the CPU."""
    pts = np.random.default_rng(0).uniform(0, 100, (20000, 2))
    before = tfj.KERNEL_LAUNCHES
    gpu = tsj.self_join(pts, 0.4, device=cuda_device)
    assert tfj.KERNEL_LAUNCHES > before
    cpu = tsj.self_join(pts, 0.4, device="cpu")
    assert torch.equal(gpu.cpu(), cpu)
