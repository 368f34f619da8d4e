"""The CUDA kernels against their plain PyTorch versions, on a card.

The fused join (B1: the row loop, the cell-run loop, and the external-query
mask in both; the Jaccard popcount refine, B1 (e), in all of them; the
global-id masks of the slab join, B1 (d), in both loops), the
brute-force tiles (B2 hits, B3 counts) and the unfused sweep's refine (B4),
at float64, float32, float16 and bfloat16 (B2-bf16 and the half instances),
must equal their plain versions bit for bit, and the entry points on the
card (the joins, fused and unfused, the counts, the external-query join and
the services, for every metric) the same entry points on the CPU.

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
from repro_torch.core import distributed as tdist
from repro_torch.core import grid as tgrid
from repro_torch.core import metric as tmetric
from repro_torch.core import query_join as tqj
from repro_torch.core import selfjoin as tsj
from repro_torch.kernels import cell_join as tcj
from repro_torch.kernels import distance_tile as tdt
from repro_torch.kernels import fused_join as tfj


# every row dtype the kernels take; the half ones follow the JAX package's
# rules for them (repro_torch/core/metric.py's module note)
DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
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
@pytest.mark.parametrize("dtype", DTYPES)
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


@pytest.mark.parametrize("dtype", DTYPES)
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


def count_rows(kind, npts, n, dtype, seed):
    """Seeded rows for B3 at the row dtype: "dups" uniform in [0, 10) with a
    tenth of the rows copies of earlier ones, "lattice" small integers (d2
    exactly on eps^2 = 1 for many pairs), "extreme" rows at the largest
    magnitude whose norms stay finite, 1 or an underflowing one, random
    signs, and "overflow" those at 1e5 times (norms of +inf; float16 rows,
    which widen to float32, stay at their extremes)."""
    big, tiny = {torch.float64: (1e150, 1e-160), torch.float32: (1e18, 1e-22),
                 torch.float16: (65504.0, 6e-8),
                 torch.bfloat16: (1e18, 1e-22)}[dtype]
    rng = np.random.default_rng(seed)
    if kind == "lattice":
        x = rng.integers(0, 4, (npts, n)).astype(np.float64)
    else:
        x = rng.uniform(0, 10, (npts, n))
    if kind == "dups" and npts > 1:
        dup = rng.choice(np.arange(1, npts), max(npts // 10, 1))
        x[dup] = x[rng.integers(0, dup)]
    if kind in ("extreme", "overflow"):
        scale = rng.choice([big, 1.0, tiny], (npts, 1))
        if kind == "overflow" and dtype != torch.float16:
            scale = scale * 1e5
        x = (rng.choice([-1.0, 1.0], x.shape) * rng.uniform(0.5, 1.0, x.shape)
             * scale)
    return torch.as_tensor(x).to(dtype)


# point counts around B3's 1,024-row tile and its 64- and 256-row tests of
# old; the data, each at an eps (a huge one makes eps^2 +inf in the row
# dtype, where the kernel leaves the fused d2)
B3_SIZES = [1, 2, 255, 256, 257, 1000, 1023, 1024, 1025, 2049, 3000]
B3_DATA = [("dups", 1.5), ("lattice", 1.0), ("extreme", 1.5),
           ("overflow", 1.0), ("overflow", 1e160)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", range(1, 9))
def test_distance_tile_counts_triangle_matches_plain(cuda_device, dtype, n):
    """B3, which evaluates each unordered pair once over the upper triangle,
    against its plain version's full N^2 evaluation: N below, on and past
    the kernel's tile, duplicates, a lattice with d2 on eps^2, extreme rows
    and rows whose norms overflow, at each (tq, tc) the tests use."""
    for npts in B3_SIZES:
        for kind, eps in B3_DATA:
            p = count_rows(kind, npts, n, dtype, seed=npts + 10 * n).to(
                cuda_device)
            want = tdt.distance_tile_counts(p, eps, method="reference")
            for tq, tc in ((256, 256), (64, 128)):
                before = tdt.COUNTS_LAUNCHES
                got = tdt.distance_tile_counts(p, eps, tq=tq, tc=tc,
                                               method="kernel")
                assert tdt.COUNTS_LAUNCHES == before + 1
                assert torch.equal(got, want), (npts, kind, eps, tq, tc)


# plane widths of every residue mod 16 (so every store width of B2), and
# around its 16-byte stores; query counts around its 32-row blocks
B2_SIZES = [3000 + k for k in range(16)] + [1, 15, 16, 17, 255, 257, 3001]
B2_QUERIES = [1, 7, 256, 700]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", range(1, 9))
def test_distance_tile_hits_matches_plain(cuda_device, dtype, n):
    """B2 against its plain version, bit for bit: the plane's width at
    every store width, query rows from a slice that starts at an odd row
    (or rows of their own when the points are too few), duplicates, a
    lattice with d2 exactly on eps^2, extreme rows and rows whose norms
    overflow, eps^2 of +inf; one launch a call."""
    for npts in B2_SIZES:
        for kind, eps in B3_DATA:
            seed = npts + 10 * n
            p = count_rows(kind, npts, n, dtype, seed=seed).to(cuda_device)
            for nq in B2_QUERIES:
                r0 = 2 * (seed % 50) + 1
                q = (p[r0:r0 + nq] if r0 + nq <= npts else count_rows(
                    kind, nq, n, dtype, seed=seed + 1).to(cuda_device))
                want = tdt.distance_tile_hits(q, p, eps, method="reference")
                before = tdt.HITS_LAUNCHES
                got = tdt.distance_tile_hits(q, p, eps, method="kernel")
                assert tdt.HITS_LAUNCHES == before + 1
                assert torch.equal(got, want), (npts, nq, kind, eps)


def _one_call_of_each_kernel(dtype, device):
    """Inputs of one call of B1, B2, B3 and B4, made before the calls (the
    grid build and the launch planning synchronise; the calls must not)."""
    pts = torch.as_tensor(
        np.random.default_rng(4).uniform(0, 30, (3000, 2))).to(device, dtype)
    index = tgrid.build_grid(pts, 1.0, device=device)
    deltas, is_zero = tsj._merged_offset_tables(index, True)
    launches, points_pad, _ = tsj._fused_launches(index, merged=True)
    ws, wc, _, qb, qpos = tsj._launch_prep(index, points_pad, deltas,
                                           launches[0], merged=True)
    b1 = ((points_pad, qb, ws, wc, is_zero, qpos),
          dict(c=launches[0][4], tq=launches[0][5], n_real=2, unicomp=True,
               merged=True))
    # each query row against itself and the next row
    cand = pts[torch.arange(300, device=device)[:, None]
               + torch.arange(2, device=device)]
    valid = torch.ones((300, 2), dtype=torch.bool, device=device)
    return pts, b1, cand, valid


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("eps_on", ["host", "device"])
def test_kernel_wrappers_do_not_synchronise(cuda_device, dtype, eps_on):
    """One call of each of B1, B2, B3 and B4 under
    ``torch.cuda.set_sync_debug_mode("error")``, with eps a Python float and
    with eps a tensor of the points' dtype on the card: none waits for the
    device (the refine scalar is filled in on the card, not copied from
    host memory), and each equals its plain version."""
    pts, (b1_args, b1_kw), cand, valid = _one_call_of_each_kernel(
        dtype, cuda_device)
    eps = 1.0 if eps_on == "host" else tmetric.scalar_as(1.0, dtype,
                                                         cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b1 = tfj.fused_join_hits(*b1_args, eps, method="kernel", **b1_kw)
        b2 = tdt.distance_tile_hits(pts[:256], pts, eps)
        b3 = tdt.distance_tile_counts(pts, eps)
        b4 = tcj.cell_join_hits(pts[:300], cand, valid, eps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for x, y in zip(b1, tfj.fused_join_hits(*b1_args, 1.0,
                                            method="reference", **b1_kw)):
        assert torch.equal(x, y)
    assert torch.equal(b2, tdt.distance_tile_hits(pts[:256], pts, 1.0,
                                                  method="reference"))
    assert torch.equal(b3, tdt.distance_tile_counts(pts, 1.0,
                                                    method="reference"))
    assert torch.equal(b4, tcj.cell_join_hits(pts[:300], cand, valid, 1.0,
                                              method="reference"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_redesigned_wrappers_do_not_synchronise(cuda_device, dtype):
    """One call of B1 (b) (on a new stream, so its arrival counters are
    made inside the call) and one of B4 (with a valid view off its W-byte
    boundary, which the wrapper copies) under
    ``torch.cuda.set_sync_debug_mode("error")``; each equals its plain
    version."""
    args, run_ord = _external_inputs(dtype, 1024, 33, 3, True, cuda_device,
                                     seed=2)
    kw = dict(c=33, n_real=2, unicomp=False, external=True, merged=True,
              run_ord=run_ord, run_loop=True)
    pts, _, cand, _ = _one_call_of_each_kernel(dtype, cuda_device)
    flat = torch.ones(300 * 2 + 1, dtype=torch.bool, device=cuda_device)
    valid = flat[1:].view(300, 2)
    eps = tmetric.scalar_as(3.0, dtype, cuda_device)
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(st):
            b1b = tfj.fused_join_hits(*args, eps, method="kernel", **kw)
            b4 = tcj.cell_join_hits(pts[:300], cand, valid, eps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    plain = {k: v for k, v in kw.items() if k not in ("run_ord", "run_loop")}
    for x, y in zip(b1b, tfj.fused_join_hits(*args, 3.0, method="reference",
                                             **plain)):
        assert torch.equal(x, y)
    assert torch.equal(b4, tcj.cell_join_hits(pts[:300], cand, valid, 3.0,
                                              method="reference"))

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("b,c", [(1, 8), (57, 24), (600, 40), (70000, 32)])
def test_cell_join_kernel_matches_plain_version(cuda_device, dtype, n, b, c):
    """B4 against its plain version, at eps where about half the slots
    hit, with a random valid mask."""
    rng = np.random.default_rng(b + c + n)
    q = torch.as_tensor(rng.uniform(0, 10, (b, n))).to(cuda_device, dtype)
    cand = torch.as_tensor(rng.uniform(0, 10, (b, c, n))).to(cuda_device,
                                                             dtype)
    valid = torch.as_tensor(rng.random((b, c)) < 0.7).to(cuda_device)
    eps = 4.1 * np.sqrt(n)
    before = tcj.KERNEL_LAUNCHES
    got = tcj.cell_join_hits(q, cand, valid, eps)
    assert tcj.KERNEL_LAUNCHES == before + 1
    want = tcj.cell_join_hits(q, cand, valid, eps, method="reference")
    assert torch.equal(got, want)
    assert tcj.KERNEL_LAUNCHES == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_cell_join_kernel_on_a_lattice(cuda_device, dtype):
    """Integer data at eps = 2: many d^2 exactly on eps^2 = 4. The kernel
    equals its plain version and an integer brute force; an empty batch
    launches nothing."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 5, (3000, 3))
    cand = rng.integers(0, 5, (3000, 16, 3))
    valid = rng.random((3000, 16)) < 0.8
    want = (((q[:, None, :] - cand) ** 2).sum(-1) <= 4) & valid
    args = [torch.as_tensor(a).to(cuda_device) for a in (q, cand, valid)]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    got = tcj.cell_join_hits(*args, 2.0)
    assert np.array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, tcj.cell_join_hits(*args, 2.0,
                                               method="reference"))
    before = tcj.KERNEL_LAUNCHES
    empty = tcj.cell_join_hits(args[0][:0], args[1][:0], args[2][:0], 2.0)
    assert empty.shape == (0, 16) and tcj.KERNEL_LAUNCHES == before


# per row dtype: lattice values whose differences are subnormal, whose
# squares overflow (to inf at float16) and whose d^2 sit exactly on the
# integer eps^2 of eps 2
HALF_EXTREMES = {
    torch.float16: [0.0, 2.0 ** -24, 3 * 2.0 ** -24, 2.0 ** -14,
                    2.0 ** -14 + 2.0 ** -24, 1.0, 2.0, 3.0, 255.0, 256.0,
                    300.0, 65504.0, -65504.0, -2.0],
    torch.bfloat16: [0.0, 2.0 ** -133, 3 * 2.0 ** -133, 2.0 ** -126, 1.0,
                     2.0, 3.0, 1e19, 1e38, -1e38, -2.0],
    torch.float32: [0.0, 2.0 ** -149, 3 * 2.0 ** -149, 2.0 ** -126, 1.0,
                    2.0, 3.0, 1e19, 1e38, -1e38, -2.0],
    torch.float64: [0.0, 2.0 ** -1074, 3 * 2.0 ** -1074, 2.0 ** -1022, 1.0,
                    2.0, 3.0, 1e154, 1e308, -1e308, -2.0],
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", range(1, 9))
def test_cell_join_kernel_on_extremes(cuda_device, dtype, n):
    """B4 against its plain version for c of every residue mod 8 (a thread
    owns 1, 2, 4 or 8 slots), on lattices of the dtype's extremes: the
    native half subtract and multiply must round as the plain version's
    float32-then-half steps do, at subnormal differences, overflowing
    squares and d^2 on eps^2; a valid view off its W-byte boundary too."""
    rng = np.random.default_rng(n)
    vals = np.array(HALF_EXTREMES[dtype])
    for c in range(8, 17):
        b = 37
        q = torch.as_tensor(rng.choice(vals, (b, n))).to(cuda_device, dtype)
        cand = torch.as_tensor(rng.choice(vals, (b, c, n))).to(cuda_device,
                                                               dtype)
        near = q[:, None, :] + torch.as_tensor(
            rng.choice([-2.0, 0.0, 1.0, 2.0], (b, c, n))).to(cuda_device,
                                                             dtype)
        cand = torch.where(torch.as_tensor(rng.random((b, c, 1)) < 0.3,
                                           device=cuda_device), near, cand)
        # one byte into a fresh buffer: off every W-byte boundary
        valid = torch.as_tensor(rng.random(b * c + 1) < 0.8).to(
            cuda_device)[1:].view(b, c)
        for eps in (2.0, 300.0, 1e-3):
            got = tcj.cell_join_hits(q, cand, valid, eps)
            want = tcj.cell_join_hits(q, cand, valid, eps, method="reference")
            assert torch.equal(got, want), (c, eps)

@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_unfused_paths_on_card_match_cpu(cuda_device, impl):
    """The unfused join, batched join, counts (routes "jnp" and "compact"
    too) and per-point counts on the card equal the CPU's; "pallas"
    launches B4 once per offset and phase, "jnp" never."""
    pts = np.random.default_rng(0).uniform(0, 100, (20000, 2))
    eps = 0.4
    n_off = 5                              # 2-D UNICOMP stencil
    before = tcj.KERNEL_LAUNCHES
    gpu = tsj.self_join(pts, eps, distance_impl=impl, sort_result=False,
                        device=cuda_device)
    assert tcj.KERNEL_LAUNCHES - before == (2 * n_off if impl == "pallas"
                                            else 0)
    cpu = tsj.self_join(pts, eps, distance_impl=impl, sort_result=False,
                        device="cpu")
    assert torch.equal(gpu.cpu(), cpu)
    fused = tsj.self_join(pts, eps, device=cuda_device)
    assert torch.equal(tsj.sort_pairs(gpu, len(pts)), fused)
    got = tsj.self_join_batched(pts, eps, n_batches=3, distance_impl=impl,
                                sort_result=False, device=cuda_device)
    assert torch.equal(got, tsj.self_join_batched(
        pts, eps, n_batches=3, distance_impl=impl, sort_result=False,
        device="cpu"))
    for kw in ({"distance_impl": impl}, {"route": "jnp"},
               {"route": "compact"}):
        assert (tsj.self_join_count(pts, eps, device=cuda_device, **kw)
                == tsj.self_join_count(pts, eps, device="cpu", **kw))
    assert (tsj.self_join_count_compact(pts, eps, distance_impl=impl,
                                        device=cuda_device)
            == tsj.self_join_count_compact(pts, eps, distance_impl=impl,
                                           device="cpu"))
    for merged in (True, False):
        counts = tsj.per_point_neighbor_counts(pts, eps, merge_last_dim=merged,
                                               device=cuda_device)
        assert np.array_equal(counts, np.bincount(fused[:, 0].cpu().numpy(),
                                                  minlength=len(pts)))


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


def external_queries(pts, eps, n=2048, seed=11):
    """Seeded queries over the volume widened by 2 eps on every side, a
    tenth of them repeating earlier rows."""
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(axis=0) - 2 * eps, pts.max(axis=0) + 2 * eps
    q = rng.uniform(lo, hi, (n, pts.shape[1]))
    dup = rng.choice(n, n // 10, replace=False)
    q[dup] = q[rng.integers(0, n // 2, dup.size)]
    return q


EXTERNAL_DATA = {
    "uniform": (np.random.default_rng(1).uniform(0, 100, (20000, 2)), 1.0),
    "expo": (np.random.default_rng(5).exponential(10.0, (3000, 3)), 1.2),
}


@pytest.mark.parametrize("data", list(EXTERNAL_DATA))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("run_loop", [True, False])
def test_external_kernel_matches_plain_version(cuda_device, data, dtype,
                                               merged, run_loop):
    """B1 (b): every launch of a request against the plain version, hits
    plane on and off, row loop and run loop, merged and per-cell."""
    pts, eps = EXTERNAL_DATA[data]
    index = tgrid.build_grid(torch.as_tensor(pts).to(dtype), eps,
                             device=cuda_device)
    pj = tqj.prepare(index, merge_last_dim=merged, run_loop=run_loop)
    q = external_queries(pts, eps)
    before = tfj.EXTERNAL_LAUNCHES
    for keep_hits in (True, False):
        _, launches = pj.launch_inputs(q, keep_hits=keep_hits)
        for _, _, args, kw in launches:
            a = tfj.fused_join_hits(*args, method="kernel", **kw)
            plain = {k: v for k, v in kw.items()
                     if k not in ("run_ord", "run_loop")}
            b = tfj.fused_join_hits(*args, method="reference", **plain)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    assert tfj.EXTERNAL_LAUNCHES > before



def _external_inputs(dtype, qp, c, n_off, merged, device, seed):
    """B1 (b)'s inputs, made directly at a request shape: 5,000 index rows
    in [0, 10]^2 padded by c rows, qp query rows, random windows (a tenth
    of the rows empty, the rest 0..c slots long) shared by runs of three
    rows inside each 128-row tile (so ``run_ord`` keeps the run plan's
    contract), and on merged sweeps small integer cell coordinates in lane
    2 of both."""
    rng = np.random.default_rng(seed)
    npts, lanes = 5000, tfj.pad_width(3)
    pts = np.zeros((npts + c, lanes))
    pts[:npts, :2] = rng.uniform(0, 10, (npts, 2))
    q = np.zeros((qp, lanes))
    q[:, :2] = rng.uniform(0, 10, (qp, 2))
    if merged:
        pts[:npts, 2] = rng.integers(0, 4, npts)
        q[:, 2] = rng.integers(0, 4, qp)
    local = np.arange(qp) % tfj.TQ_DEFAULT
    head = np.arange(qp) - local % 3
    wc = rng.integers(0, c + 1, (n_off, qp))
    wc[:, rng.random(qp) < 0.1] = 0
    ws = rng.integers(0, npts, (n_off, qp))[:, head]
    wc = wc[:, head]
    run_ord = local // 3
    args = [torch.as_tensor(a).to(device) for a in (pts, q)]
    args = [a.to(dtype) for a in args] + [
        torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32).to(device)
        for a in (ws, wc, np.zeros(n_off), np.zeros(qp))]
    return args, torch.as_tensor(run_ord, dtype=torch.int32).to(device)


EXTERNAL_SHAPES = [(128, 7, 3), (384, 64, 40), (1024, 33, 3),
                   (4096, 100, 9)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("qp,c,n_off", EXTERNAL_SHAPES)
def test_external_kernel_at_request_shapes(cuda_device, dtype, merged, qp,
                                           c, n_off):
    """B1 (b) against its plain version at qp 128 to 4,096 rows, c not a
    multiple of 32, up to 40 offsets (two rounds of descriptors), hits
    plane on and off, with and without a run plan."""
    args, run_ord = _external_inputs(dtype, qp, c, n_off, merged,
                                     cuda_device, seed=qp + c)
    kw = dict(c=c, n_real=2, unicomp=False, external=True, merged=merged)
    for keep_hits in (True, False):
        want = tfj.fused_join_hits(*args, 3.0, method="reference",
                                   keep_hits=keep_hits, **kw)
        assert int(want[1].sum()) > 0
        for loop in ({}, dict(run_ord=run_ord, run_loop=True)):
            before = tfj.EXTERNAL_LAUNCHES
            got = tfj.fused_join_hits(*args, 3.0, method="kernel",
                                      keep_hits=keep_hits, **loop, **kw)
            assert tfj.EXTERNAL_LAUNCHES == before + 1
            for x, y in zip(got, want):
                assert torch.equal(x, y)


def test_external_kernel_back_to_back_and_on_two_streams(cuda_device):
    """The per-tile arrival counters: the same launch twice back to back on
    one stream, then on two streams at once, each equal to the plain
    version; each stream has its own counters, zero again afterwards."""
    args, _ = _external_inputs(torch.float64, 4096, 33, 3, True,
                               cuda_device, seed=5)
    kw = dict(c=33, n_real=2, unicomp=False, external=True, merged=True)
    want = tfj.fused_join_hits(*args, 3.0, method="reference", **kw)
    torch.cuda.synchronize()
    outs = [tfj.fused_join_hits(*args, 3.0, **kw) for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs += [tfj.fused_join_hits(*args, 3.0, **kw)
                     for _ in range(2)]
    torch.cuda.synchronize()
    for got in outs:
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    keys = {(cuda_device.index or torch.cuda.current_device(),
             st.cuda_stream) for st in streams}
    assert keys <= set(tfj._ARRIVALS)
    assert len({tfj._ARRIVALS[k].data_ptr() for k in keys}) == 2
    for buf in tfj._ARRIVALS.values():
        assert not buf.any()

def _lattice_data():
    """Points and queries on a 0.1-spaced lattice, eps 0.3: many queries sit
    on cell boundaries, where a reciprocal multiply in place of the true
    division by eps would put the merged lane one cell off the windows."""
    g = np.arange(60) * 0.1
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    q = np.concatenate([pts[::3], pts[::7] + 0.05, pts[:50] - 0.3])
    return pts, q, 0.3


@pytest.mark.parametrize("data", ["uniform", "expo", "lattice"])
@pytest.mark.parametrize("merged", [True, False])
def test_epsilon_join_on_card_matches_cpu(cuda_device, data, merged):
    if data == "lattice":
        pts, q, eps = _lattice_data()
    else:
        pts, eps = EXTERNAL_DATA[data]
        q = external_queries(pts, eps, n=700)
    before = tfj.EXTERNAL_LAUNCHES
    gpu = tqj.epsilon_join(q, pts, eps, device=cuda_device,
                           merge_last_dim=merged)
    assert tfj.EXTERNAL_LAUNCHES > before
    cpu = tqj.epsilon_join(q, pts, eps, device="cpu", merge_last_dim=merged)
    assert np.array_equal(gpu.counts, cpu.counts)
    assert np.array_equal(gpu.pairs, cpu.pairs)
    assert gpu.total > 0


def test_services_on_card(cuda_device):
    """A pair-serving service, a counts-only one and the batching service
    on the card: the CPU's answers, a ready() that does not block, and no
    counter moved in steady state."""
    pts, eps = EXTERNAL_DATA["uniform"]
    rng = np.random.default_rng(3)
    stream = [external_queries(pts, eps, n=n, seed=k)
              for k, n in enumerate((1024, 77, 300, 1))]
    cpu = repro_torch.JoinService(pts, eps, return_pairs=True, device="cpu")
    want = [cpu.query(q) for q in stream]
    svc = repro_torch.JoinService(pts, eps, return_pairs=True,
                                  device=cuda_device)
    counts_only = repro_torch.JoinService(pts, eps, index=svc.index)
    bat = repro_torch.BatchingJoinService(pts, eps, index=svc.index,
                                          return_pairs=True, max_batch=512)
    svc.prepared.warm(1024)
    counts_only.prepared.warm(1024)
    bat.warmup()
    svc.mark_steady()
    counts_only.mark_steady()
    pending = svc.prepared.join_async(stream[0])
    assert pending.ready() in (True, False)
    assert np.array_equal(pending.result().pairs, want[0].pairs)
    assert pending.ready()
    tickets = [bat.submit(q) for q in stream]
    bat.pump()
    bat.drain()
    for q, w, t in zip(stream, want, tickets):
        got = svc.query(q)
        assert np.array_equal(got.counts, w.counts)
        assert np.array_equal(got.pairs, w.pairs)
        assert np.array_equal(counts_only.query(q).counts, w.counts)
        assert np.array_equal(t.result().pairs, w.pairs)
    for s in (svc, counts_only, bat):
        s.assert_no_retrace()
    # the counters are process-wide: a reindex moves them for the others
    svc.reindex(pts[rng.permutation(pts.shape[0])])
    assert np.array_equal(svc.query(stream[0]).counts, want[0].counts)
    svc.assert_no_retrace()


def token_sets(n, vocab, seed, lo=0, hi=24):
    """Seeded token sets of lo..hi tokens over ``vocab``, a twentieth of
    them copies of an earlier set with one token swapped, so every
    threshold finds pairs."""
    rng = np.random.default_rng(seed)
    out = [tuple(rng.choice(vocab, int(rng.integers(lo, hi + 1)),
                            replace=False)) for _ in range(n)]
    for i in rng.choice(np.arange(1, n), n // 20, replace=False):
        src = list(out[int(rng.integers(0, i))])
        if src:
            src[0] = int(rng.integers(0, vocab))
        out[i] = tuple(src)
    return out


def jaccard_launches(canon, device, unicomp, run_loop):
    """Every launch of a Jaccard self-join sweep (per cell, over the size
    grid) with its inputs and, for the run loop, its plan."""
    index = tgrid.build_grid(canon.geom, canon.eps_geom, device=device)
    feats = tsj._metric_feats_sorted(canon, index)
    deltas, is_zero = tsj._offset_tables(index, unicomp)
    tabs = (tgrid.cell_window_tables(index, deltas, merged=False,
                                     tag=unicomp) if run_loop else None)
    launches, points_pad, _ = tsj._fused_launches(index, merged=False,
                                                  feats=feats)
    for launch in launches:
        ws, wc, _, qb, qpos = tsj._launch_prep(index, points_pad, deltas,
                                               launch, merged=False,
                                               tables=tabs)
        plan = (tsj._launch_run_plan(index, qpos, tile=launch[5])
                if run_loop else None)
        yield launch, (points_pad, qb, ws, wc, is_zero, qpos), plan


# (vocabulary, most tokens a set): 1 and 3 words (n_feat odd) of 16 and 40
# tokens; 128 words of 2,048 tokens make the run loop's block need more
# than 48 KiB of shared memory, and 256 of 4,096 the query tile alone (64
# packed words a row), so both loops opt in past the default
JACCARD_DATA = {"v16": (16, 8), "v40": (40, 16), "v60": (60, 24),
                "v1024": (1024, 200), "v2048": (2048, 300),
                "v4096": (4096, 400)}


@pytest.mark.parametrize("data", list(JACCARD_DATA))
@pytest.mark.parametrize("unicomp", [True, False])
@pytest.mark.parametrize("run_loop", [True, False])
def test_jaccard_kernel_matches_plain_version(cuda_device, data, unicomp,
                                              run_loop):
    """B1 (e): every launch of a Jaccard sweep against the plain version,
    hits plane on and off, UNICOMP and self masks, row and run loop."""
    vocab, hi = JACCARD_DATA[data]
    canon = tmetric.canonicalize(token_sets(3000, vocab, 1, hi=hi), 0.6,
                                 metric="jaccard", vocab=vocab)
    tile = 128 * tfj.jaccard_record_bytes(tfj.packed_width(canon.n_feat))
    assert (tile > 48 * 1024) == (data == "v4096")
    before = tfj.JACCARD_LAUNCHES
    hits = 0
    for launch, args, plan in jaccard_launches(canon, cuda_device, unicomp,
                                               run_loop):
        for keep_hits in (True, False):
            kw = dict(c=launch[4], n_real=1, unicomp=unicomp, merged=False,
                      tq=launch[5], keep_hits=keep_hits, metric="jaccard",
                      n_feat=canon.n_feat)
            loop = (dict(run_ord=plan.run_ord, run_loop=True) if run_loop
                    else {})
            a = tfj.fused_join_hits(*args, canon.eps, method="kernel",
                                    **loop, **kw)
            b = tfj.fused_join_hits(*args, canon.eps, method="reference",
                                    **kw)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
            hits += int(b[1].sum())
    assert tfj.JACCARD_LAUNCHES > before and hits > 0


@pytest.mark.parametrize("data", list(JACCARD_DATA))
@pytest.mark.parametrize("run_loop", [True, False])
def test_jaccard_external_kernel_matches_plain_version(cuda_device, data,
                                                       run_loop):
    """B1 (e) with the external mask: a request of token sets, some of them
    out of the index's vocabulary, against the plain version."""
    vocab, hi = JACCARD_DATA[data]
    sets = token_sets(3000, vocab, 2, hi=hi)
    canon = tmetric.canonicalize(sets, 0.6, metric="jaccard", vocab=vocab)
    index = tgrid.build_grid(canon.geom, canon.eps_geom, device=cuda_device)
    pj = tqj.prepare(index, run_loop=run_loop, canon=canon)
    q = sets[:700] + token_sets(300, vocab + 40, 3, hi=hi)
    for keep_hits in (True, False):
        _, launches = pj.launch_inputs(q, keep_hits=keep_hits)
        assert launches
        for _, _, args, kw in launches:
            a = tfj.fused_join_hits(*args, method="kernel", **kw)
            plain = {k: v for k, v in kw.items()
                     if k not in ("run_ord", "run_loop")}
            b = tfj.fused_join_hits(*args, method="reference", **plain)
            for x, y in zip(a, b):
                assert torch.equal(x, y)


def test_jaccard_kernel_refuses_what_it_cannot_run(cuda_device):
    """float64 rows raise TypeError; a vocabulary whose query tile exceeds
    the device's shared-memory opt-in limit raises, naming the limit; and
    feature lanes on an l2 launch raise (only the Jaccard variant reads
    them)."""
    canon = tmetric.canonicalize(token_sets(500, 60, 4), 0.5,
                                 metric="jaccard")
    launch, args, _ = next(jaccard_launches(canon, cuda_device, True, False))
    kw = dict(c=launch[4], n_real=1, unicomp=True, tq=launch[5],
              metric="jaccard", n_feat=canon.n_feat, method="kernel")
    with pytest.raises(TypeError, match="float32"):
        tfj.fused_join_hits(args[0].double(), args[1].double(), *args[2:],
                            0.5, **kw)
    limit = tfj.smem_limit(args[0].device)
    assert limit >= 48 * 1024
    # the query tile holds 128 records of the packed words (two 16-bit
    # words to an int32): this many feature lanes pass the limit
    n_feat = 16 * (limit // (16 * 128))
    lanes = tfj.pad_width(1 + n_feat)
    wide = torch.zeros((args[0].shape[0], lanes), device=cuda_device)
    qwide = torch.zeros((args[1].shape[0], lanes), device=cuda_device)
    with pytest.raises(ValueError, match=str(limit)):
        tfj.fused_join_hits(wide, qwide, *args[2:], 0.5,
                            **dict(kw, n_feat=n_feat))
    with pytest.raises(ValueError, match="Jaccard kernel only"):
        tfj.fused_join_hits(*args, 0.5, **dict(kw, metric="l2"))


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
def test_metric_joins_on_card_match_cpu(cuda_device, metric):
    """self_join, self_join_count (both routes) and epsilon_join on the
    card equal the CPU for each metric, through their kernels."""
    if metric == "cosine":
        rng = np.random.default_rng(6)
        data = rng.normal(size=(20000, 4))
        data[:400] = 2.5 * data[10000:10400]
        eps, q = 0.99, rng.normal(size=(700, 4))
    else:
        data, eps = token_sets(4000, 200, 7, hi=40), 0.5
        q = data[:500] + token_sets(200, 240, 8, hi=40)
    before = tfj.JACCARD_LAUNCHES
    gpu = tsj.self_join(data, eps, metric=metric, device=cuda_device)
    assert (tfj.JACCARD_LAUNCHES > before) == (metric == "jaccard")
    cpu = tsj.self_join(data, eps, metric=metric, device="cpu")
    assert torch.equal(gpu.cpu(), cpu) and cpu.shape[0] > 0
    for route in ("dense", "dense-run"):
        assert tsj.self_join_count(data, eps, metric=metric, route=route,
                                   device=cuda_device) == \
            tsj.self_join_count(data, eps, metric=metric, route=route,
                                device="cpu")
    a = tqj.epsilon_join(q, data, eps, metric=metric, device=cuda_device)
    b = tqj.epsilon_join(q, data, eps, metric=metric, device="cpu")
    assert np.array_equal(a.counts, b.counts)
    assert np.array_equal(a.pairs, b.pairs)


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
def test_metric_services_on_card(cuda_device, metric):
    """JoinService and BatchingJoinService per metric on the card: the
    CPU service's answers, a stricter per-request threshold included, and
    no counter moved in steady state."""
    if metric == "cosine":
        rng = np.random.default_rng(9)
        data, eps = rng.normal(size=(5000, 4)), 0.95
        stream = [rng.normal(size=(n, 4)) for n in (300, 17, 64)]
    else:
        data, eps = token_sets(3000, 200, 9, hi=40), 0.5
        stream = [token_sets(n, 220, 10 + n, hi=40) for n in (300, 17, 64)]
    cpu = repro_torch.JoinService(data, eps, return_pairs=True,
                                  metric=metric, device="cpu")
    svc = repro_torch.JoinService(data, eps, return_pairs=True,
                                  metric=metric, device=cuda_device)
    bat = repro_torch.BatchingJoinService(data, eps, return_pairs=True,
                                          metric=metric, max_batch=256,
                                          device=cuda_device)
    svc.prepared.warm(300)
    bat.warmup()
    svc.mark_steady()
    tickets = [bat.submit(q) for q in stream]
    bat.drain()
    for q, t in zip(stream, tickets):
        want = cpu.query(q)
        got = svc.query(q)
        assert np.array_equal(got.counts, want.counts)
        assert np.array_equal(got.pairs, want.pairs)
        assert np.array_equal(t.result().pairs, want.pairs)
        tight = 0.99 if metric == "cosine" else 0.7
        assert np.array_equal(svc.query(q, eps=tight).pairs,
                              cpu.query(q, eps=tight).pairs)
    svc.assert_no_retrace()
    bat.assert_no_retrace()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_paths_on_card_match_cpu(cuda_device, dtype):
    """Half points through the fused join, the unfused "pallas" sweep, the
    counts, per-point counts, brute force "pallas" and the external-query
    join on the card equal the same entry points on the CPU."""
    pts = torch.as_tensor(np.random.default_rng(8).uniform(0, 60, (20000, 2)))
    pts = pts.to(dtype)
    eps = 0.5
    for kw in (dict(), dict(merge_last_dim=False), dict(unicomp=False),
               dict(distance_impl="pallas")):
        gpu = tsj.self_join(pts, eps, device=cuda_device, **kw)
        assert torch.equal(gpu.cpu(), tsj.self_join(pts, eps, device="cpu",
                                                    **kw))
    for route in ("dense", "dense-run", "compact", "jnp"):
        a = tsj.self_join_count(pts, eps, route=route, device=cuda_device)
        b = tsj.self_join_count(pts, eps, route=route, device="cpu")
        assert a == b
    assert np.array_equal(
        tsj.per_point_neighbor_counts(pts, eps, device=cuda_device),
        tsj.per_point_neighbor_counts(pts, eps, device="cpu"))
    small = pts[:3000]
    assert repro_torch.brute_force_count(
        small, eps, distance_impl="pallas", device=cuda_device) == \
        repro_torch.brute_force_count(small, eps, distance_impl="pallas",
                                      device="cpu")
    q = pts[::7] + 0.01
    a = tqj.epsilon_join(q, pts, eps, device=cuda_device)
    b = tqj.epsilon_join(q, pts, eps, device="cpu")
    assert np.array_equal(a.pairs, b.pairs)
    assert np.array_equal(a.counts, b.counts)


# The slab join's launches (B1 (d)): skewed 3-D points at 3 slabs, the half
# dtypes at their largest point counts with exact ids
GID_POINTS = {torch.float64: 20000, torch.float32: 20000,
              torch.float16: 2049, torch.bfloat16: 257}


def _gid_launches(slab, merged, unicomp, run_loop):
    """Every launch of one slab's join with its inputs and run plan."""
    index = slab.index
    tables = tsj._merged_offset_tables if merged else tsj._offset_tables
    deltas, is_zero = tables(index, unicomp)
    tabs = (tgrid.cell_window_tables(index, deltas, merged=merged,
                                     tag=unicomp) if run_loop else None)
    launches, points_pad, _ = tsj._fused_launches(
        index, merged=merged, row_ok=slab.row_ok, gid=slab.ids)
    for launch in launches:
        ws, wc, _, qb, qpos = tsj._launch_prep(index, points_pad, deltas,
                                               launch, merged=merged,
                                               tables=tabs)
        plan = (tsj._launch_run_plan(index, qpos, tile=launch[5])
                if run_loop else None)
        yield launch, (points_pad, qb, ws, wc, is_zero, qpos), plan


def _gid_points(dtype):
    pts = np.random.default_rng(9).exponential(2.0, (GID_POINTS[dtype], 3))
    return torch.as_tensor(pts).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("unicomp", [True, False])
@pytest.mark.parametrize("run_loop", [True, False])
def test_gid_kernel_matches_plain_version(cuda_device, dtype, merged,
                                          unicomp, run_loop):
    """Every launch of every slab's join, hits plane on and off: B1 (d)'s
    hits, counts and slot_base equal its plain version's bit for bit."""
    compared = 0
    for slab in tdist.slab_indexes(_gid_points(dtype), 1.0, 3,
                                   device=cuda_device):
        for launch, args, plan in _gid_launches(slab, merged, unicomp,
                                                run_loop):
            loop = ({} if plan is None else
                    dict(run_ord=plan.run_ord, run_loop=True))
            for keep_hits in (True, False):
                kw = dict(c=launch[4], n_real=3, unicomp=unicomp,
                          merged=merged, gid_pairs=True, tq=launch[5],
                          keep_hits=keep_hits)
                a = tfj.fused_join_hits(*args, slab.index.eps,
                                        method="kernel", **loop, **kw)
                b = tfj.fused_join_hits(*args, slab.index.eps,
                                        method="reference", **kw)
                for x, y in zip(a, b):
                    assert torch.equal(x, y)
                compared += 1
    assert compared > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_slab_join_on_card_matches_cpu(cuda_device, dtype):
    """The slab join on the card (exchange, slab grids, B1 (d), emit) gives
    the pairs and totals of the plain versions on the CPU, and the pairs of
    the one-process join on the card."""
    pts = _gid_points(dtype)
    before = tfj.GID_LAUNCHES
    for n_slabs in (2, 4):
        gpu = tdist.distributed_self_join(pts, 1.0, n_slabs,
                                          device=cuda_device)
        assert torch.equal(gpu.cpu(), tdist.distributed_self_join(
            pts, 1.0, n_slabs, device="cpu"))
        assert torch.equal(gpu, tsj.self_join(pts, 1.0, device=cuda_device))
        assert tdist.distributed_self_join(
            pts, 1.0, n_slabs, return_pairs=False,
            device=cuda_device) == gpu.shape[0]
        assert tdist.distributed_self_join_count(
            pts, 1.0, n_slabs, device=cuda_device) == \
            tdist.distributed_self_join_count(pts, 1.0, n_slabs, device="cpu")
    assert tfj.GID_LAUNCHES > before


def test_gid_kernel_refuses_what_it_cannot_run(cuda_device):
    """The wrapper refuses ids with external queries or Jaccard, and lanes
    that cannot hold the id lane; the library refuses a global-id launch
    with the external mask by itself too."""
    slab = next(tdist.slab_indexes(_gid_points(torch.float32), 1.0, 3,
                                   device=cuda_device))
    launch, args, _ = next(_gid_launches(slab, True, True, False))
    kw = dict(c=launch[4], n_real=3, unicomp=True, merged=True,
              gid_pairs=True, tq=launch[5], method="kernel")
    with pytest.raises(ValueError, match="gid_pairs"):
        tfj.fused_join_hits(*args, 1.0, external=True, **kw)
    with pytest.raises(ValueError, match="global-id lane"):
        tfj.fused_join_hits(*args, 1.0, **dict(kw, n_real=7))
    pp, qb, ws, wc, is_zero, qpos = args
    scal = tmetric.device_refine_scalar("l2", 1.0, pp.dtype, pp.device)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfj._fused_join_hits_cuda(
            pp, qb, ws, wc, is_zero.to(torch.int32), qpos, None, scal,
            c=launch[4], tq=launch[5], n_real=3, unicomp=False,
            external=True, merged=True, keep_hits=True, metric="l2",
            n_feat=0, gid_pairs=True)


# --- B1's self-join kernel (the l2 refine with the SELF and UNICOMP masks:
# B1 (a), (c), (d) and their half instances), in both of its layouts: one
# block a tile on a launch of SPREAD_TILES tiles or more, and the spread of
# a launch of fewer tiles over blocks

# query rows a launch in each layout, at tq = 128
SELF_ROWS = {"tile": tfj.SPREAD_TILES * tfj.TQ_DEFAULT, "spread": 1024}
SELF_LAYOUTS = list(SELF_ROWS)


def _tiles_for(layout: str, qp: int, tq: int) -> int:
    """The tile height a launch of ``qp`` rows takes in ``layout``: its own
    ``tq`` to spread (asserting it has fewer than SPREAD_TILES tiles), or,
    for the tile layout, the largest power of two up to ``tq`` that gives
    SPREAD_TILES tiles or more (``tq`` itself on a launch that has them)."""
    if layout == "spread":
        assert qp // tq < tfj.SPREAD_TILES
        return tq
    t = tq
    while t > 1 and (qp % t or qp // t < tfj.SPREAD_TILES):
        t //= 2
    assert qp // t >= tfj.SPREAD_TILES
    return t


def _lattice(side: int, dtype) -> torch.Tensor:
    """A 3-D integer lattice: at eps 2 many d^2 sit exactly on eps^2 = 4,
    and the cells of width 2 hold 8 points (the run loop)."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    return torch.as_tensor(g.reshape(-1, 3).astype(np.float64)).to(dtype)


@pytest.mark.parametrize("layout", SELF_LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("unicomp", [True, False])
@pytest.mark.parametrize("gid", [False, True])
def test_self_kernel_on_a_lattice(cuda_device, layout, dtype, merged,
                                  unicomp, gid):
    """Every launch of a lattice join (with ``gid``: of each slab's join at
    2 slabs, the half dtypes at point counts with exact ids), hits plane on
    and off, row and run loop: hits, counts and slot_base equal the plain
    version's bit for bit. The spread layout takes the drivers' 128-row
    tiles; the tile layout tiles of the height that gives each launch
    SPREAD_TILES tiles (128 rows where it has them). Per-cell windows of 8
    slots take the narrow steps."""
    side = {torch.float16: 12, torch.bfloat16: 6}.get(dtype, 14) if gid \
        else 14
    pts = _lattice(side, dtype)
    if gid:
        work = [(s_.index, _gid_launches(s_, merged, unicomp, True))
                for s_ in tdist.slab_indexes(pts, 2.0, 2, device=cuda_device)]
    else:
        index = tgrid.build_grid(pts, 2.0, device=cuda_device)
        work = [(index, _run_loop_launches(index, merged, unicomp))]
    hits = 0
    for index, launches in work:
        for launch, args, plan in launches:
            for keep_hits in (True, False):
                tq = _tiles_for(layout, args[1].shape[0], launch[5])
                kw = dict(c=launch[4], n_real=3, unicomp=unicomp,
                          merged=merged, gid_pairs=gid, tq=tq,
                          keep_hits=keep_hits)
                want = tfj.fused_join_hits(*args, index.eps,
                                           method="reference", **kw)
                for loop in ({}, dict(run_ord=plan.run_ord, run_loop=True)):
                    got = tfj.fused_join_hits(*args, index.eps,
                                              method="kernel", **loop, **kw)
                    for x, y in zip(got, want):
                        assert torch.equal(x, y)
                hits += int(want[1].sum())
    assert hits > 0


def _self_inputs(dtype, n, c, merged, gid, device, seed, qp=1024,
                 n_off=3, npts=2000):
    """The self-join kernel's inputs made directly: ``npts`` rows of the
    dtype's extremes (HALF_EXTREMES, and neighbours 0-2 away) in ``n``
    lanes, the merged lane's small integer cell coordinates, the id lane
    (row ids, -1 in the tail); ``qp`` query rows that are rows of the
    points (q_pos); windows of 0..c slots shared by runs of three rows,
    the zero offset's around each row's own position."""
    rng = np.random.default_rng(seed)
    vals = np.array(HALF_EXTREMES[dtype])
    lanes = tfj.pad_width(n + merged + gid)
    pts = np.zeros((npts + c, lanes))
    pts[:npts, :n] = rng.choice(vals, (npts, n))
    near = rng.random(npts) < 0.5
    pts[1:npts][near[1:], :n] = (pts[:npts - 1][near[1:], :n]
                                 + rng.choice([-2.0, 0.0, 1.0, 2.0],
                                              (int(near[1:].sum()), n)))
    if merged:
        pts[:npts, n] = rng.integers(0, 4, npts)
    if gid:
        pts[:, n + merged] = np.concatenate([np.arange(npts),
                                             -np.ones(c)])
    q_pos = rng.integers(0, npts, qp)
    head = np.arange(qp) - np.arange(qp) % 3
    ws = rng.integers(0, npts, (n_off, qp))[:, head]
    ws[0] = np.maximum(q_pos[head] - rng.integers(0, c, qp), 0)
    wc = rng.integers(0, c + 1, (n_off, qp))[:, head]
    wc[:, rng.random(qp) < 0.1] = 0
    points = torch.as_tensor(pts).to(device, dtype)
    qpos = torch.as_tensor(q_pos, dtype=torch.int32).to(device)
    ints = [torch.as_tensor(np.ascontiguousarray(a),
                            dtype=torch.int32).to(device)
            for a in (ws, wc, np.arange(n_off) == 0)]
    args = [points, points[qpos.long()].contiguous()] + ints + [qpos]
    run_ord = torch.as_tensor((np.arange(qp) % tfj.TQ_DEFAULT) // 3,
                              dtype=torch.int32).to(device)
    return args, run_ord


@pytest.mark.parametrize("layout", SELF_LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3, 6, 9])
def test_self_kernel_on_extremes(cuda_device, layout, dtype, n):
    """The native half arithmetic (``__hsub_rn``, ``__hmul_rn``,
    ``__hadd_rn``, compares in the half type) against the plain version's
    rule P, bit for bit, on rows of each dtype's extremes: subnormal
    differences, squares that overflow, d^2 on eps^2; at c 1-100 (narrow
    steps of 1, 8 and 16 slots, a window past one warp step), merged and
    per-cell, UNICOMP and self, with and without ids, hits plane on and
    off, row and run loop, on launches of SPREAD_TILES tiles (one block a
    tile) and of 8 (spread); n = 9 reads the coordinates past HELD_LANES
    from memory."""
    for i, (c, merged, gid) in enumerate([(7, True, False), (32, False, True),
                                          (33, True, True),
                                          (100, False, False),
                                          (1, False, False),
                                          (16, True, False)]):
        if n + merged + gid > 8 and merged:
            continue
        args, run_ord = _self_inputs(dtype, n, c, merged, gid, cuda_device,
                                     seed=10 * n + i, qp=SELF_ROWS[layout])
        for eps in (2.0, 300.0, 1e-3):
            for unicomp in (True, False):
                for keep_hits in (True, False):
                    kw = dict(c=c, n_real=n, unicomp=unicomp, merged=merged,
                              gid_pairs=gid, keep_hits=keep_hits)
                    want = tfj.fused_join_hits(*args, eps,
                                               method="reference", **kw)
                    for loop in ({}, dict(run_ord=run_ord, run_loop=True)):
                        got = tfj.fused_join_hits(*args, eps,
                                                  method="kernel", **loop,
                                                  **kw)
                        for x, y in zip(got, want):
                            assert torch.equal(x, y), (c, eps, unicomp)


def test_self_kernel_back_to_back_and_on_two_streams(cuda_device):
    """The spread layout's arrival counters (a launch of 32 tiles): a
    launch twice back to back on one stream, then on two streams at once,
    each equal to the plain version; each stream's counters are zero again
    afterwards."""
    args, _ = _self_inputs(torch.float64, 2, 300, True, False, cuda_device,
                           seed=5, qp=4096)
    kw = dict(c=300, n_real=2, unicomp=True, merged=True)
    want = tfj.fused_join_hits(*args, 3.0, method="reference", **kw)
    torch.cuda.synchronize()
    outs = [tfj.fused_join_hits(*args, 3.0, **kw) for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs += [tfj.fused_join_hits(*args, 3.0, **kw)
                     for _ in range(2)]
    torch.cuda.synchronize()
    for got in outs:
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    for buf in tfj._ARRIVALS.values():
        assert not buf.any()


@pytest.mark.parametrize("layout", SELF_LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_self_kernel_does_not_synchronise(cuda_device, layout, dtype):
    """One call of the self-join kernel in each layout, on
    a new stream (the spread layout's counters are made inside the call),
    under ``torch.cuda.set_sync_debug_mode("error")``; equal to its plain
    version."""
    args, run_ord = _self_inputs(dtype, 2, 33, True, True, cuda_device,
                                 seed=2, qp=SELF_ROWS[layout])
    kw = dict(c=33, n_real=2, unicomp=True, merged=True, gid_pairs=True)
    eps = tmetric.scalar_as(3.0, dtype, cuda_device)
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(st):
            got = tfj.fused_join_hits(*args, eps, method="kernel",
                                      run_ord=run_ord, run_loop=True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for x, y in zip(got, tfj.fused_join_hits(*args, 3.0, method="reference",
                                             **kw)):
        assert torch.equal(x, y)
