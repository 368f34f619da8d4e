#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: the fused L2 self-join on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The first run builds the CUDA kernel from ``src/repro_torch/kernels/csrc``
into ``build/repro_torch/``. Phases, each printing one JSON line:

  env             torch / CUDA versions, the card's name and power limit
  build           nvcc build of the kernel library, timed
  kernel_vs_plain the kernel against its plain PyTorch version, exactly, on
                  every launch the drivers schedule for three bench
                  workloads, across merged x unicomp x keep_hits x dtype
  bench_totals    self_join_count and len(self_join) of the port equal the
                  recorded pair totals of the seven bench workloads
  main_path       self_join on 2,000,000 uniform 2-D f64 points at eps 0.2:
                  the launch counter, pair-set checks against a direct
                  on-card evaluation, kernel-vs-plain on every launch, and
                  the join's and the kernel's times (median of 3 after one
                  warm-up)
  profile         one main-path join under torch.profiler: host and device
                  time per stage span of the driver, device time by kernel
                  name and the device's busy share
  kernels         one line per kernel: launches, agreement and times

The last lines are the card's ``nvidia-smi`` name and power limit, then
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
DEVICE = torch.device("cuda")

# Exact ordered-pair totals of the bench workloads (seeded generators below);
# they depend on the data only, not on the machine.
BENCH_TOTALS = {
    "uniform-2d": 501722, "clustered-2d": 834874, "expo-3d": 721926,
    "uniform-4d": 23948, "clustered-4d": 1056370, "uniform-6d": 3168,
    "clustered-6d": 531810,
}
MAIN_POINTS, MAIN_DIMS, MAIN_EPS = 2_000_000, 2, 0.2
SAMPLED_QUERIES = 1024
# H100 SXM data sheet peaks: HBM3 bytes/s, and non-tensor-core FP64 / FP32.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# --- the bench workloads' generators (numpy, seeded) ------------------------

def syn(n, d, seed=0):
    return np.random.default_rng(seed).uniform(0, 100, (n, d))


def clustered(n, d, seed=3):
    rng = np.random.default_rng(seed)
    k = max(n // 200, 4)
    centers = rng.uniform(0, 100, (k, d))
    pts = centers[rng.integers(0, k, n)]
    return pts + rng.normal(0, 1.5, pts.shape)


def expo(n, d, seed=5, scale=10.0):
    return np.random.default_rng(seed).exponential(scale, (n, d))


def bench_workloads():
    return {
        "uniform-2d": (syn(100_000, 2), 0.4),
        "clustered-2d": (clustered(100_000, 2), 0.4),
        "expo-3d": (expo(30_000, 3), 1.2),
        "uniform-4d": (syn(20_000, 4), 6.0),
        "clustered-4d": (clustered(20_000, 4), 3.0),
        "uniform-6d": (syn(10_000, 6), 14.0),
        "clustered-6d": (clustered(10_000, 6), 4.0),
    }


# --- helpers ----------------------------------------------------------------

def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def sync():
    torch.cuda.synchronize()


def prepared_launches(index, *, merged, unicomp):
    """The drivers' launch schedule for ``index`` with each launch's inputs."""
    from repro_torch.core import selfjoin as sj
    tables = sj._merged_offset_tables if merged else sj._offset_tables
    deltas, is_zero = tables(index, unicomp)
    launches, points_pad, _ = sj._fused_launches(index, bucketed=None,
                                                 merged=merged)
    out = []
    for launch in launches:
        ws, wc, _, qb, qpos = sj._launch_prep(index, points_pad, deltas,
                                              launch, merged=merged)
        out.append(dict(launch=launch, args=(points_pad, qb, ws, wc, is_zero,
                                             qpos, index.eps),
                        kw=dict(c=launch[4], tq=launch[5],
                                n_real=index.n_dims, unicomp=unicomp,
                                merged=merged)))
    return out


def compare_kernel_and_plain(prepared, keep_hits: bool) -> int:
    """Max |kernel - plain| over hits, counts and slot_base of each launch."""
    from repro_torch.kernels import fused_join as fj
    worst = 0
    for p in prepared:
        a = fj.fused_join_hits(*p["args"], method="kernel",
                               keep_hits=keep_hits, **p["kw"])
        b = fj.fused_join_hits(*p["args"], method="reference",
                               keep_hits=keep_hits, **p["kw"])
        sync()
        for x, y in zip(a, b):
            check(x.shape == y.shape and x.dtype == y.dtype,
                  f"kernel output {tuple(x.shape)} {x.dtype} vs plain "
                  f"{tuple(y.shape)} {y.dtype}")
            worst = max(worst, int((x.to(torch.int64) - y.to(torch.int64))
                                   .abs().max()))
    return worst


def timed_launches(prepared, method: str, keep_hits: bool = True) -> float:
    """Device ms of all launches, by CUDA events around each."""
    from repro_torch.kernels import fused_join as fj
    total = 0.0
    for p in prepared:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fj.fused_join_hits(*p["args"], method=method, keep_hits=keep_hits,
                           **p["kw"])
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total


def kernel_bound(prepared):
    """Least time the card could take for the launches' work: the larger of
    bytes over HBM bandwidth and floating-point operations over the peak.
    Bytes: each input read once (descriptors, query rows, q_pos, the
    distinct window rows' coordinate lanes) and each output written once
    (the int8 hit plane, counts, slot_base). Operations: 3 * n_real per live
    slot (subtract, multiply, add), the slots this data needs (sum of
    win_count)."""
    total_bytes = 0
    flops = 0
    dtype = None
    for p in prepared:
        points_pad, qb, ws, wc, is_zero, qpos, _ = p["args"]
        n_off, qp = ws.shape
        c, n_real, merged = p["kw"]["c"], p["kw"]["n_real"], p["kw"]["merged"]
        item = points_pad.element_size()
        dtype = str(points_pad.dtype).replace("torch.", "")
        used_lanes = n_real + (1 if merged else 0)
        # distinct candidate rows over all windows of the launch
        rows = points_pad.shape[0]
        edge = torch.zeros(rows + 1, dtype=torch.int32, device=ws.device)
        live = wc > 0
        edge.index_add_(0, ws[live].long(), torch.ones_like(ws[live]))
        edge.index_add_(0, (ws + wc)[live].long(), -torch.ones_like(ws[live]))
        distinct = int((torch.cumsum(edge, 0)[:rows] > 0).sum())
        total_bytes += (distinct * used_lanes * item          # window rows
                        + qp * used_lanes * item              # query rows
                        + n_off * qp * 4 * 2 + qp * 4 + n_off * 4  # descr.
                        + n_off * qp * c                      # hits, int8
                        + qp * 4 * 2)                         # counts, base
        flops += 3 * n_real * int(wc.sum(dtype=torch.int64))
    t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            total_bytes, flops)


# --- phases -----------------------------------------------------------------

def phase_env():
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         nvidia_smi=nvidia_smi_line())


def phase_build():
    from repro_torch.kernels import build, fused_join as fj
    t0 = time.perf_counter()
    path, log = build.build("fused_join")
    fj._kernel_library()
    seconds = time.perf_counter() - t0
    ptxas = sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln})
    emit("build", library=str(path.relative_to(ROOT)), seconds=seconds,
         built=bool(log), ptxas=ptxas)


def phase_kernel_vs_plain(workloads):
    import repro_torch
    worst = 0
    for name in ("uniform-2d", "expo-3d", "clustered-4d"):
        pts, eps = workloads[name]
        compared = 0
        for dtype in (np.float64, np.float32):
            index = repro_torch.build_grid(pts.astype(dtype), eps,
                                           device=DEVICE)
            for merged in (True, False):
                for unicomp in (True, False):
                    prepared = prepared_launches(index, merged=merged,
                                                 unicomp=unicomp)
                    for keep_hits in (True, False):
                        err = compare_kernel_and_plain(prepared, keep_hits)
                        check(err == 0, f"{name} {np.dtype(dtype).name} "
                              f"merged={merged} unicomp={unicomp} "
                              f"keep_hits={keep_hits}: kernel differs from "
                              f"the plain version by {err}")
                        worst = max(worst, err)
                        compared += len(prepared)
        emit("kernel_vs_plain", workload=name, points=len(pts), eps=eps,
             variants=16, launches_compared=compared, max_abs_err=worst,
             exact=True)
    return worst


def phase_bench_totals(workloads):
    import repro_torch
    for name, (pts, eps) in workloads.items():
        t0 = time.perf_counter()
        stats = repro_torch.self_join_count(pts, eps, route="dense",
                                            device=DEVICE)
        sync()
        t1 = time.perf_counter()
        pairs = repro_torch.self_join(pts, eps, device=DEVICE)
        sync()
        t2 = time.perf_counter()
        want = BENCH_TOTALS[name]
        check(stats.total_pairs == want, f"{name}: count "
              f"{stats.total_pairs} != recorded {want}")
        check(pairs.shape[0] == want, f"{name}: join emitted "
              f"{pairs.shape[0]} pairs, recorded {want}")
        emit("bench_totals", workload=name, points=len(pts), eps=eps,
             total_pairs=want, count_s=t1 - t0, join_s=t2 - t1,
             offsets=stats.offsets, cells_visited=stats.cells_visited,
             candidates_checked=stats.candidates_checked)


def check_pairs(pairs, pts_gpu, eps: float, n: int):
    """Symmetric, no self pairs, and exact neighbour lists for sampled ids
    against a direct evaluation in the kernel's lane order."""
    check(pairs.shape[0] > 0 and pairs.dtype == torch.int32, "no pairs")
    check(bool((pairs[:, 0] != pairs[:, 1]).all()), "self pair emitted")
    from repro_torch.core.selfjoin import sort_pairs
    check(torch.equal(sort_pairs(pairs.flip(1), n), pairs),
          "pair set is not symmetric")
    eps2 = torch.tensor(eps, dtype=pts_gpu.dtype, device=pts_gpu.device)
    eps2 = eps2 * eps2
    gen = torch.Generator(device="cpu").manual_seed(0)
    sample = torch.randperm(n, generator=gen)[:SAMPLED_QUERIES].to(
        pts_gpu.device)
    first = pairs[:, 0].contiguous()
    lo = torch.searchsorted(first, sample.to(torch.int32))
    hi = torch.searchsorted(first, sample.to(torch.int32), right=True)
    ids = torch.arange(n, device=pts_gpu.device)
    for chunk in range(0, SAMPLED_QUERIES, 64):
        q = sample[chunk:chunk + 64]
        d2 = torch.zeros((q.shape[0], n), dtype=pts_gpu.dtype,
                         device=pts_gpu.device)
        for k in range(pts_gpu.shape[1]):
            t = pts_gpu[q, k][:, None] - pts_gpu[:, k][None, :]
            d2 = d2 + t * t
        hit = (d2 <= eps2) & (ids[None, :] != q[:, None])
        for r in range(q.shape[0]):
            want = torch.nonzero(hit[r]).flatten().to(torch.int32)
            got = pairs[lo[chunk + r]:hi[chunk + r], 1]
            check(torch.equal(got, want),
                  f"neighbours of point {int(q[r])} differ from the direct "
                  f"evaluation ({got.numel()} vs {want.numel()})")


def phase_main_path():
    import repro_torch
    from repro_torch.core import selfjoin as sj
    from repro_torch.kernels import fused_join as fj
    pts = syn(MAIN_POINTS, MAIN_DIMS)
    eps = MAIN_EPS

    index = repro_torch.build_grid(pts, eps, device=DEVICE)
    expected = len(sj._fused_launches(
        index, bucketed=None, merged=sj._resolve_merge(index, None))[0])
    del index
    repro_torch.self_join(pts, eps, device=DEVICE)       # warm-up
    sync()
    e2e, launches = [], []
    for rep in range(3):
        torch.cuda.reset_peak_memory_stats()
        fj.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        pairs = repro_torch.self_join(pts, eps, device=DEVICE)
        sync()
        e2e.append(time.perf_counter() - t0)
        launches.append(fj.KERNEL_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    check(all(n == expected for n in launches) and expected > 0,
          f"main path launched the kernel {launches} times, scheduled "
          f"{expected} per run")

    stats = repro_torch.self_join_count(pts, eps, device=DEVICE)
    check(stats.total_pairs == pairs.shape[0],
          f"count {stats.total_pairs} != emitted {pairs.shape[0]}")
    pts_gpu = torch.as_tensor(pts).to(DEVICE)
    check_pairs(pairs, pts_gpu, eps, MAIN_POINTS)
    del pts_gpu

    index = repro_torch.build_grid(pts, eps, device=DEVICE)
    prepared = prepared_launches(index, merged=sj._resolve_merge(index, None),
                                 unicomp=True)
    worst = compare_kernel_and_plain(prepared, keep_hits=True)
    check(worst == 0, f"main path: kernel differs from plain by {worst}")
    timed = {}
    for method in ("kernel", "reference"):
        timed_launches(prepared, method)                 # warm-up
        timed[method] = statistics.median(timed_launches(prepared, method)
                                          for _ in range(3))
    bound_ms, bound_by, nbytes, flops = kernel_bound(prepared)
    caps = [p["kw"]["c"] for p in prepared]
    rows = [p["args"][1].shape[0] for p in prepared]
    emit("main_path", points=MAIN_POINTS, dims=MAIN_DIMS, eps=eps,
         dtype="float64", total_pairs=int(pairs.shape[0]),
         launches=launches[-1], launch_caps=caps, launch_rows=rows,
         offsets=stats.offsets, candidates_checked=stats.candidates_checked,
         sampled_queries_checked=SAMPLED_QUERIES,
         e2e_s=statistics.median(e2e), e2e_runs_s=e2e,
         kernel_ms=timed["kernel"], plain_ms=timed["reference"],
         bound_ms=bound_ms, bound_by=bound_by,
         bound_bytes=nbytes, bound_flops=flops, peak_mem_bytes=peak,
         kernel_equals_plain=True)
    return dict(launches=launches[-1], ms=timed["kernel"],
                plain_ms=timed["reference"], bound_ms=bound_ms,
                bound_by=bound_by)


def phase_profile():
    """One main-path join under ``torch.profiler``: per stage span of the
    driver (``self_join.grid`` / ``.plan`` / ``.kernel`` / ``.emit``) its host
    time and the device time of the kernels it launched, device time by
    kernel name, and the device's busy share of the wall time. Reports null
    device figures when the profiler records no device activity."""
    import repro_torch
    from torch.profiler import ProfilerActivity, profile
    pts = syn(MAIN_POINTS, MAIN_DIMS)
    repro_torch.self_join(pts, MAIN_EPS, device=DEVICE)     # warm-up
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        repro_torch.self_join(pts, MAIN_EPS, device=DEVICE)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    averages = prof.key_averages()
    # the CPU side of each span: host time inside it, and the device time
    # of every kernel launched inside it (children included)
    stages = {e.key: dict(calls=e.count, host_ms=e.cpu_time_total / 1e3,
                          device_ms=(getattr(e, "device_time_total", 0)
                                     or 0) / 1e3)
              for e in averages
              if e.key.startswith("self_join.")
              and e.device_type == torch.autograd.DeviceType.CPU}
    check(set(stages) == {"self_join.grid", "self_join.plan",
                          "self_join.kernel", "self_join.emit"},
          f"profiled join entered the stage spans {sorted(stages)}")
    # device-side entries only (kernels, copies, fills): the CPU ops that
    # launched them carry the same device time, the spans' device-side
    # copies cover other entries, and the profiler's own activity buffers
    # are not the join's work
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and device_us(e) > 0
              and not e.key.startswith(("Activity Buffer", "self_join."))]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:12]
    emit("profile", points=MAIN_POINTS, wall_ms=wall_ms, stages=stages,
         device_busy_ms=busy_ms if events else None,
         device_busy_share=busy_ms / wall_ms if events else None,
         top_device_ms={e.key[:80]: device_us(e) / 1e3 for e in top},
         note="wall and host times include the profiler's own cost")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_env()
    phase_build()
    workloads = bench_workloads()
    worst = phase_kernel_vs_plain(workloads)
    phase_bench_totals(workloads)
    main = phase_main_path()
    phase_profile()
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the smoke imported JAX or the JAX package")
    kernels = [{
        "name": "fused_join",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_join.cu",
        "replaces": "src/repro/kernels/fused_join.py:215",
        "launches": main["launches"],
        "max_abs_err": worst,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "matched_plain": True,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
