"""The CUDA kernels against their plain PyTorch versions, on a card.

The fused join (B1, row loop and cell-run loop) and the brute-force tiles (B2
hits, B3 counts) must equal their plain versions bit for bit, and the entry
points on the card the same entry points on the CPU.

The kernels have no CPU mode, so these tests skip without a CUDA device. They
import neither JAX nor the JAX package, so they run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py

(``--noconftest`` because ``tests/conftest.py`` clears JAX's caches.)
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import grid as tgrid
from repro_torch.core import selfjoin as tsj
from repro_torch.kernels import distance_tile as tdt
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


def test_profiler_ties_b1_to_its_span(cuda_device):
    """B1 launches inside the torch op ``repro_torch::fused_join``, so the
    profiler counts its device time in the ``self_join.kernel`` span."""
    from torch.profiler import ProfilerActivity, profile
    pts = np.random.default_rng(0).uniform(0, 100, (20000, 2))
    tsj.self_join(pts, 0.4, device=cuda_device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tsj.self_join(pts, 0.4, device=cuda_device)
        torch.cuda.synchronize()
    events = prof.key_averages()
    b1 = sum(e.self_device_time_total for e in events
             if "fused_join_kernel" in e.key)
    span = [e.device_time_total for e in events
            if e.key == "self_join.kernel"
            and e.device_type == torch.autograd.DeviceType.CPU]
    assert b1 > 0 and span and span[0] >= b1


def _run_loop_launches(index, merged, unicomp):
    """Every launch of a run-loop sweep with its table-prep inputs and plan."""
    tables = tsj._merged_offset_tables if merged else tsj._offset_tables
    deltas, is_zero = tables(index, unicomp)
    tabs = tgrid.cell_window_tables(index, deltas, merged=merged, tag=unicomp)
    launches, points_pad, _ = tsj._fused_launches(index, merged=merged)
    for launch in launches:
        ws, wc, _, qb, qpos = tsj._launch_prep(index, points_pad, deltas,
                                               launch, merged=merged,
                                               tables=tabs)
        plan = tsj._launch_run_plan(index, qpos, tile=launch[5])
        yield launch, (points_pad, qb, ws, wc, is_zero, qpos), plan


# dense uniform data (~4 points a cell), and one crowded cell whose window
# is wider than the run loop's shared-memory stage (segmented staging)
RUN_DATA = {
    "uniform": (np.random.default_rng(1).uniform(0, 100, (20000, 2)), 1.0),
    "crowded": (np.concatenate([
        np.random.default_rng(2).uniform(0, 0.5, (3000, 2)),
        np.random.default_rng(3).uniform(0, 100, (2000, 2))]), 0.6),
}


@pytest.mark.parametrize("data", list(RUN_DATA))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("unicomp", [True, False])
def test_run_loop_kernel_matches_plain_version(cuda_device, data, dtype,
                                               merged, unicomp):
    pts, eps = RUN_DATA[data]
    index = tgrid.build_grid(torch.as_tensor(pts).to(dtype), eps,
                             device=cuda_device)
    for launch, args, plan in _run_loop_launches(index, merged, unicomp):
        for keep_hits in (True, False):
            kw = dict(c=launch[4], n_real=2, unicomp=unicomp, merged=merged,
                      tq=launch[5], keep_hits=keep_hits)
            a = tfj.fused_join_hits(*args, index.eps, method="kernel",
                                    run_ord=plan.run_ord, run_loop=True, **kw)
            b = tfj.fused_join_hits(*args, index.eps, method="reference", **kw)
            for x, y in zip(a, b):
                assert torch.equal(x, y)


def test_run_loop_kernel_ignores_a_broken_plan(cuda_device):
    """A plan whose runs span several cells still gives the plain result:
    rows whose window is not their head's read device memory."""
    pts, eps = RUN_DATA["uniform"]
    index = tgrid.build_grid(pts, eps, device=cuda_device)
    for launch, args, plan in _run_loop_launches(index, True, True):
        kw = dict(c=launch[4], n_real=2, unicomp=True, merged=True,
                  tq=launch[5])
        broken = torch.zeros_like(plan.run_ord)
        a = tfj.fused_join_hits(*args, index.eps, method="kernel",
                                run_ord=broken, run_loop=True, **kw)
        b = tfj.fused_join_hits(*args, index.eps, method="reference", **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 3, 6, 8])
def test_distance_tile_kernels_match_plain_version(cuda_device, dtype, n):
    """B2 and B3 against their plain versions, on random data and on a
    lattice with many d2 near eps^2."""
    rng = np.random.default_rng(n)
    lattice = 10.0 + 0.1 * np.stack(np.meshgrid(
        *([np.arange(6)] * min(n, 4)), indexing="ij"), -1).reshape(-1, min(n, 4))
    lattice = np.concatenate(
        [lattice, np.full((lattice.shape[0], n - lattice.shape[1]), 10.0)], 1)
    for pts, eps in ((rng.uniform(0, 10, (3000, n)), 1.5), (lattice, 0.2)):
        p = torch.as_tensor(pts).to(cuda_device, dtype)
        q = p[:700]
        for tq, tc in ((256, 256), (64, 128)):
            a = tdt.distance_tile_hits(q, p, eps, tq=tq, tc=tc,
                                       method="kernel")
            b = tdt.distance_tile_hits(q, p, eps, method="reference")
            assert torch.equal(a, b)
            a = tdt.distance_tile_counts(p, eps, tq=tq, tc=tc,
                                         method="kernel")
            b = tdt.distance_tile_counts(p, eps, method="reference")
            assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_brute_force_on_card_matches_cpu(cuda_device, impl):
    pts = np.random.default_rng(4).uniform(0, 100, (5000, 3))
    before = tdt.HITS_LAUNCHES
    gpu = repro_torch.brute_force_join(pts, 4.0, distance_impl=impl,
                                       device=cuda_device)
    assert (tdt.HITS_LAUNCHES > before) == (impl == "pallas")
    cpu = repro_torch.brute_force_join(pts, 4.0, distance_impl=impl,
                                       device="cpu")
    assert torch.equal(gpu.cpu(), cpu)
    assert repro_torch.brute_force_count(
        pts, 4.0, distance_impl=impl, device=cuda_device) == cpu.shape[0]


def test_self_join_batched_on_card_matches_self_join(cuda_device):
    """Batches copied to the host while the next runs: the pair set of the
    one-shot join, through the run loop (about 4 points a cell)."""
    pts, eps = RUN_DATA["uniform"]
    index = tgrid.build_grid(pts, eps, device=cuda_device)
    assert tsj._join_run_loop(index)
    want = tsj.self_join(pts, eps, index=index, device=cuda_device)
    for n_batches in (1, 3, 7):
        got = tsj.self_join_batched(pts, eps, index=index,
                                    n_batches=n_batches, device=cuda_device)
        assert got.device.type == "cpu"
        assert torch.equal(got, want.cpu())
