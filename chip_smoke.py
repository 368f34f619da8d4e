#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: the self-joins and their kernels on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The first run builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
(one nvcc per source, started together) into ``build/repro_torch/``. Phases,
each printing one JSON line:

  env             torch / CUDA versions, the card's name and power limit
  build           nvcc builds of the kernel libraries, timed
  kernel_vs_plain the fused-join kernel (B1) against its plain PyTorch
                  version, exactly, on every launch the drivers schedule for
                  three bench workloads, across merged x unicomp x keep_hits x
                  dtype x run loop on/off; and B1 (b), the external-query
                  mask, on every launch of a 2,048-query request against
                  each of the seven bench workloads' indexes, across merged
                  x keep_hits x dtype x run loop on/off
  bench_totals    self_join_count and len(self_join) of the port equal the
                  recorded pair totals of the seven bench workloads
  main_path       self_join on 2,000,000 uniform 2-D f64 points at eps 0.2,
                  through the cell-run loop: the launch counter, kernel-vs-
                  plain on every launch, B1's run-loop and row-loop times on
                  the same launches, sampled neighbour lists against a direct
                  on-card evaluation, and the full-scale oracle: B3's
                  per-point counts over all points against the join's,
                  and against B3's plain version on sampled rows
  unfused         the unfused sweep on the main path's points: self_join
                  through distance_impl "pallas" (kernel B4) and "jnp",
                  each timed beside the fused join with its peak memory and
                  equal to its pairs; B4 against its plain version on every
                  launch of that join at f64 and f32, its time, plain time
                  and bound; self_join_count through both impls, route
                  "jnp" and route "compact" (every impl), the batched
                  pallas join, per-point neighbour counts (merged and per
                  cell) against the join's; the seven bench totals through
                  "pallas"; a lattice with d^2 exactly on eps^2 against an
                  integer count; one profiled pallas join
  batched         self_join_batched(n_batches=3) at the main path against
                  self_join, time and peak memory side by side; then the
                  paper's 10,000,000-point scale, its total against
                  self_join_count
  brute           the brute-force tiles B2 and B3 against their plain
                  versions, bit for bit, on three bench workloads;
                  brute_force_count(distance_impl="pallas") against the
                  recorded totals; each kernel's time and bound
  profile         one main-path join under torch.profiler: host and device
                  time per stage span and sub-stage span (the run plans its
                  l2 run-loop launches are given and do not read, in
                  ``self_join.plan.run_plan``), B1's device time by name,
                  device time by kernel name and the device's busy share
  serve           the join services on the card: index A (the main path's
                  2 M points) serves 64 requests of 1,024 external queries
                  with pairs (counts against B2 row sums, sampled neighbour
                  lists against a direct evaluation, a counts-only service
                  alike), B1 (b) timed beside its bound, a profiled window of
                  requests by stage span; index B (1 M skewed 3-D points)
                  through the capacity classes, B1 (b) on one request's
                  launches against its plain version and timed by name; the batching service over
                  256 requests against the solo answers and one closed loop
                  of the load generator; a reindex halfway through 16
                  requests; boundary queries on a lattice
  metrics         the cosine and Jaccard joins (``metric=``): the bench's
                  two metric workloads' totals against the JAX package's
                  recorded ones; B1 (e), the Jaccard popcount refine,
                  against its plain version on every launch of the
                  jaccard-v64 join (row and run loop, hits on and off, the
                  self, UNICOMP and external masks); cosine at 1,000,000
                  raw 4-D embeddings (B3's counts on the unit rows, every
                  planted scaled duplicate found, the plain L2 join on the
                  same rows beside it); Jaccard at 100,000 token sets over
                  1,024 tokens (sampled neighbour lists against a direct
                  evaluation, B1 (e) timed beside its plain version and its
                  bound); both services per metric against direct
                  evaluations, and one batching stream per metric against
                  the solo answers; one profiled join per metric
  slab            the slab join in one process (distributed_self_join,
                  kernel B1 (d), the global-id masks): the main path's
                  points at 1, 2 and 4 slabs, each equal to self_join's
                  pairs (timed in the same phase), its count-only total and
                  the plain count sweep's equal to MAIN_TOTAL, time and peak
                  memory of each; B1 (d) against its plain version on every
                  launch of one slab's join (merged and per-cell, UNICOMP
                  and self, row and run loop, hits on and off) in
                  PLAIN_ROWS slices, and timed beside B1 (c) / (a) on the
                  same launches without the id masks, with its byte bound;
                  the serve phase's 1 M skewed points at eps 0.3 on 48
                  slabs (a 2-hop halo) and cosine at the 1 M embeddings,
                  each equal to self_join's pairs; a float16 refusal and a
                  forced halo overflow
  routes          every count route of self_join_count (dense, dense-run,
                  dense-flat, sparse, sparse-flat, compact, jnp) on the main
                  path against MAIN_TOTAL, timed by events, with the
                  counters each route's contract gives; dense, sparse,
                  sparse-flat and dense-flat on the bench workloads against
                  BENCH_TOTALS; sparse and dense on index B's 1 M skewed
                  points; route=None's label (and the join's sweep) with an
                  empty measured table; the measured route race and B1's
                  measured tiles for the main path's classes, into a table
                  in a temporary directory; B1 at tq 64 and 256 against its
                  plain version on the main path's launches and one request
  collective      the slab join over torch.distributed (launch.mesh.spawn,
                  a SlabMesh): the main path's points on 2 and 4 gloo ranks
                  sharing the card (NCCL needs a card a rank; the line
                  "nccl: not run (N card)" says when there are fewer), each
                  rank's candidate block against the one-process exchange's,
                  rank 0's gathered pairs against the one-process slab join's,
                  count-only and the plain count sweep against MAIN_TOTAL,
                  B1 (d)'s launches summed over the ranks against the
                  one-process join's; then the count-only join and the
                  offset-parallel count on a (2, 2) (slab, model) grid; each
                  rank's seconds and peak memory per step
  sharded         ShardedJoinService on index A at 4 slabs: the serve
                  phase's 64 requests with pairs, then counts only, each
                  equal to the single-index service's, p50 / p99 /
                  requests a second, B1 (b) launches counted; the batching
                  service over the 4 slabs on the same requests; the serve
                  CLI and the load generator with --slabs 4
  dedup           dedup_embeddings on 1,000,000 raw 6-D embeddings with
                  20,000 planted copies (scaled, and with small noise), a
                  zero and a NaN row: the guard flags exactly the two bad
                  rows and keeps them, every copy is dropped, the keep mask
                  equals scipy's connected-component roots over the join's
                  pairs, and the kept rows join to no pair; the three torch
                  examples, started together
  analysis        ROADMAP A13 (``repro_torch.analysis``): the main path in
                  sanitized mode (``REPRO_TORCH_SANITIZE``) against
                  MAIN_TOTAL with one code a B1 launch and none left
                  pending, timed in turns with the unsanitized path (CUDA
                  events); the sanitized wrapper under the sync debug mode;
                  index A's 64 requests sanitized against unsanitized; the
                  cosine and Jaccard joins at the metrics phase's sizes;
                  injected faults (a descriptor past the buffer, a count
                  above c, an off-unit cosine row, a corrupted slot_base)
                  each raising its bit with the context intact, the main
                  path giving MAIN_TOTAL after the first; the contract
                  prover and linter on indexes built on the card (the
                  canned ones, the 2 M main path's, 4 slabs) with no
                  finding beyond the baseline, and C6's shared-memory
                  limit against the card's opt-in limit
  lm              ROADMAP A17 (i) and A16, no kernel on its path: the
                  smoke-lm decode service (``serve --arch smoke-lm``) at
                  its full CONFIG in bfloat16 and the CLI's defaults
                  (prefill ms, per-token p50 / p99, peak memory, every id
                  in range, every logit finite); prefill + decode against
                  the teacher-forced forward (smoke-lm at bf16 and f32,
                  the moe, ssm and hybrid smokes at f32); the card
                  against the CPU on one set of seeded weights (prefill
                  and 8 decode steps, f32, TF32 off); the argmax against
                  JAX's recorded one (LM_ARGMAX) where its margin is over
                  1e-3; ego_join and rtree_join on the host against the
                  card's self_join_count and A16_TOTAL
  train           ROADMAP A17 (ii a): ``launch.train`` at smoke-lm's full
                  CONFIG (bf16, remat on) for 40 steps of 8 x 256 tokens
                  with ``--dedup`` and a checkpoint every 20 steps: every
                  loss finite, the last 5 below the first, B1 launched by
                  the pipeline's dedup at least once a step; step ms p50 /
                  p99 after the first, tokens a second, peak memory; the
                  dedup on the card against its plain version on planted
                  duplicates; 3 f32 steps against JAX's recorded losses
                  and gradient norms (LM_TRAIN_PIN, TF32 off); one f32 step
                  on the card against the CPU, for smoke-lm and the moe,
                  ssm and hybrid smokes; a 6-step run resumed to 8 against
                  an uninterrupted one; 3 steps under torch.profiler
  train_mesh      ROADMAP A17 (ii b), gloo ranks sharing the card:
                  ``launch.train --mesh smoke --dedup`` at the full CONFIG
                  for 10 steps of 8 x 256 on 2 ranks (1, 2) and 4 ranks
                  (2, 2), every rank's losses finite and equal, B1 once a
                  batch on every rank; the same meshes at f32 against the
                  card's unmeshed f32 steps; the pod-compressed step on
                  (2, 1, 2) against JAX's LM_TRAIN_POD_PIN; 4 steps on one
                  rank resumed on 4 ranks against an uninterrupted 4-rank
                  run; step p50 / p99, tokens a second, each rank's peak
                  memory, the collectives' seconds a step by kind; one
                  step on each mesh recorded for the dryrun phase
  infer_mesh      ROADMAP A17 (iv), no kernel on its path, gloo ranks
                  sharing the card: smoke-lm's full CONFIG serving 256
                  prompts of 32 tokens, 16 decoded (teacher forced), on
                  (1, 2) and (2, 2) with tensor parallelism over 'model'
                  and the KV cache's sequence split: every rank's logits
                  equal, f32 against the card's unmeshed model within
                  1e-4 (TF32 off), bf16 argmax agreement >= 0.95, each
                  rank's KV cache the unmeshed bytes over its batch and
                  cache_seq ranks; bf16 prefill ms, per-token p50 / p99,
                  each rank's peak memory, collective seconds a token by
                  kind; the last decode step of each rank recorded for
                  the dryrun phase
  dryrun          ROADMAP A17 (iii), no kernel on its path: the dry run
                  (``launch.dryrun``) for smoke-lm train_4k on both
                  production meshes and selfjoin syn6d2m, in this process,
                  each exiting 0 with the card's allocated memory unmoved,
                  its per-cell terms printed; the plan of the train_mesh
                  phase's step on (1, 2) and (2, 2) and of the pod step on
                  (2, 1, 2) against the ranks' real steps, every kind's
                  calls and bytes; the roofline's constants against the
                  card (a bf16 matmul of 8192^3 and a 2 GiB copy timed by
                  events, each rate at most 1.05 x its constant); the
                  roofline's bound of the train phase's cell against that
                  phase's step p50; the planned argument bytes on (1, 2)
                  against the real rank's, and the planned peak against
                  max_memory_allocated; the plan of the infer_mesh
                  phase's decode step against every rank's
  kernels         one line: every kernel with launches, agreement and times

``python3 chip_smoke.py --kernel-times [SRC]`` times B3, B1 (e), B2,
B1 (b), B4, B1's self-join launches and the emit kernel alone
(``kernel_times``), ``--emit-times [SRC]`` the emit only
(``emit_cell_times``: the kernel and its plain version at both benchmark
cells' launch shapes and on the Jaccard join, with the byte bound),
``--b1-times [SRC]`` the self-join launches only (``b1_times``: B1 (c)
and (a) on the main path, B1 at f16, B1 (d) on a slab, a skewed
workload's widest class, every bench workload's launches), and
``--e2e-times [SRC]`` the paths around them (``e2e_times``: B1 (c), (a)
and (d) by events, the main path's "pallas" and fused joins, serving p50
and p99), from the package in SRC (another checkout's ``src``, the parent
commit's say) or this checkout's, so that two versions can be compared in
one chip call, in turns. ``--train-mesh``, ``--infer-mesh`` and
``--dryrun`` run those phases alone (``--dryrun`` with the phases it
reads: build, train, train_mesh, infer_mesh).

Launch counters are set to 0 just before each path (main_path for B1 and B3,
unfused for B4, brute for B2, serve for B1 (b), metrics for the cosine
join's B1 and the Jaccard join's B1 (e), slab for B1 (d), collective for
B1 (d) in each rank's process, sharded for B1 (b) on the slabs, dedup for
its cosine join's B1, analysis for the sanitized main path's B1, train
for the token pipeline's dedup B1, train_mesh for the same in each rank's
process; the infer_mesh and dryrun phases launch no kernel) and read
just after;
comparisons with
the plain versions run outside those windows. The last lines are the
card's ``nvidia-smi`` name and power limit, then
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types
import warnings
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
# its ordered-pair total (the seeded data's, on any machine)
MAIN_TOTAL = 50_184_534
# the unfused phase's lattice: integer sites of a LATTICE_SIDE^3 cube, each
# twice, at eps 2 (many d^2 exactly on eps^2 = 4)
LATTICE_SIDE, LATTICE_EPS = 40, 2
# the paper's synthetic scale: ~10 points a cell, ~314 M ordered pairs
PAPER_POINTS, PAPER_EPS = 10_000_000, 0.1
SAMPLED_QUERIES = 1024
BRUTE_WORKLOADS = ("uniform-2d", "expo-3d", "clustered-4d")
# H100 SXM data sheet peaks: HBM3 bytes/s, and non-tensor-core FP64 / FP32;
# INT32 (the Jaccard refine's AND and popcount): 64 INT32 lanes an SM, the
# FP64 lanes' count, at one operation a clock (the FP64 figure counts an
# FMA as two), so half of 34e12.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "int32": 17e12}
# Issue floors: instructions a second at one a lane a clock (132 SMs at
# 1.98 GHz): FP64 on 64 lanes an SM (17e12, the FP64 peak with an FMA as
# one), FP32 on 128, and POPC at a quarter of the INT32 rate (16 an SM).
ISSUE_RATE = {"float64": 17e12, "float32": 33.5e12, "popc": 4.2e12}
# the unit a row dtype's operations are counted on: the half ones at the
# FP32 rate (B1 (b) computes them in float32, each rounded to the half
# dtype; the other kernels natively, which is no slower), outside the
# tensor cores
OPS_DTYPE = {"float64": "float64", "float32": "float32",
             "float16": "float32", "bfloat16": "float32"}
# the f64 band of the expanded form (tests/test_torch_brute.py::_band)
BAND_SCALE = 2.0 ** -50
# the serve phase: index A is the main path's dataset; index B the expo
# generator's skew at 1 M 3-D points and the bench's expo-3d eps
SERVE_REQUESTS, SERVE_BATCH, REINDEX_REQUESTS = 64, 1024, 16
SKEW_POINTS, SKEW_EPS, SKEW_REQUESTS = 1_000_000, 1.2, 16
EXTERNAL_QUERIES = 2048
# The bench's metric workloads (benchmarks/bench_selfjoin.py::
# metric_workloads at its defaults: 20,000 points, 4 dimensions, seed 0) and
# their ordered-pair totals, computed with the JAX package on the CPU, where
# self_join_count(metric=...) and brute_force_count_metric agree.
METRIC_TOTALS = {"cosine-4d": 7477644, "jaccard-v64": 66642}
# cosine at the scale of an embedding-dedup pass; Jaccard near-duplicate
# detection over token sets (sizes 16-256 of 1,024 tokens)
COSINE_POINTS, COSINE_DIMS, COSINE_T = 1_000_000, 4, 0.999
JACCARD_POINTS, JACCARD_VOCAB, JACCARD_T = 100_000, 1024, 0.8
METRIC_REQUESTS = 4
# rows of one plain-version call when a launch is held to it in slices
PLAIN_ROWS = 2048
# Half-precision points (ROADMAP C1): the main path's points cast to float16
# (not bfloat16: eps 0.2 is below bfloat16's spacing above 32, 0.25, so the
# points collapse onto lattice sites), the bench workloads at both half
# dtypes through the fused join and through "pallas", cosine from half
# embeddings, and brute force on uniform-2d at both. The totals are the
# port's plain versions on the CPU (``python3 chip_smoke.py
# --record-half-totals``). The JAX package on the CPU
# (tests/torch_workloads.py::jax_half_totals) gives the same totals, except
# the fused float16 ones, where XLA's jitted float16 code departs from
# per-operation rounding (the band of repro_torch/core/metric.py's note):
# there the port's total minus JAX's is +4, +2, -20, +8, +136, 0 and +138
# on the seven workloads in order, +40 on the main path and +3,684 for
# cosine.
HALF_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}
HALF_MAIN_TOTAL = 51_836_204
HALF_TOTALS = {
    "float16": {
        "fused": {"uniform-2d": 500888, "clustered-2d": 834220,
                  "expo-3d": 722598, "uniform-4d": 23932,
                  "clustered-4d": 1057160, "uniform-6d": 3176,
                  "clustered-6d": 532540},
        "pallas": {"uniform-2d": 500888, "clustered-2d": 834220,
                   "expo-3d": 722638, "uniform-4d": 23926,
                   "clustered-4d": 1056892, "uniform-6d": 3178,
                   "clustered-6d": 532390}},
    "bfloat16": {
        "fused": {"uniform-2d": 438664, "clustered-2d": 730828,
                  "expo-3d": 728540, "uniform-4d": 24138,
                  "clustered-4d": 1054956, "uniform-6d": 3204,
                  "clustered-6d": 533704},
        "pallas": {"uniform-2d": 438662, "clustered-2d": 730826,
                   "expo-3d": 728454, "uniform-4d": 24092,
                   "clustered-4d": 1054044, "uniform-6d": 3186,
                   "clustered-6d": 532002}},
}
HALF_COSINE_TOTALS = {"float16": 19_021_066, "bfloat16": 19_018_304}
HALF_BRUTE_WORKLOAD = "uniform-2d"
# unit roundoff of the half dtypes: rule P's d^2 lies within (n + 3) u d^2
# of the exact one, the band where it and B3's float32 form may disagree
HALF_UNIT = {torch.float16: 2.0 ** -11, torch.bfloat16: 2.0 ** -8}
# The slab join in one process (ROADMAP A14 (i), kernel B1 (d)): the main
# path's points at these slab counts; the timed and compared launches are
# those of slab SLAB_HELD[1] of the SLAB_HELD[0]-slab join (halos on both
# sides). The skewed case is the serve phase's index B points (1 M expo-3d)
# at eps 0.3 (at 1.2 its join would emit ~8e8 pairs): at 48 equal-count
# slabs the slabs near 0 are narrower than eps, so the halo takes 2 hops.
SLAB_COUNTS = (1, 2, 4)
SLAB_HELD = (4, 1)
SLAB_SKEW_EPS, SLAB_SKEW_SLABS = 0.3, 48
SLAB_COSINE_SLABS = 2
# of the 16 compared variants, the join's own (merged, UNICOMP, run loop,
# hits) is held on every row; the others on every SLAB_ROW_STRIDE-th slice
SLAB_ROW_STRIDE = 8


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


def _host_s(fn) -> float:
    """Seconds of ``fn()`` by the host clock, ending in a synchronize."""
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def event_ms(fn, repeats: int = 1) -> float:
    """Device ms of ``fn()`` by CUDA events, averaged over ``repeats``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def prepared_launches(index, *, merged, unicomp, run_loop=False, slab=None):
    """The drivers' launch schedule for ``index`` with each launch's inputs;
    with ``run_loop``, the table-prep inputs and the launch's run plan.
    With ``slab`` (a ``core.distributed.SlabIndex``; ``index`` is its grid)
    the slab join's schedule: the owned rows only, ids in the pad lane, and
    ``gid_pairs`` in each launch's ``kw`` (B1 (d))."""
    from repro_torch.core import grid, selfjoin as sj
    tables = sj._merged_offset_tables if merged else sj._offset_tables
    deltas, is_zero = tables(index, unicomp)
    tabs = (grid.cell_window_tables(index, deltas, merged=merged,
                                    tag=unicomp) if run_loop else None)
    ids = {} if slab is None else dict(row_ok=slab.row_ok, gid=slab.ids)
    launches, points_pad, _ = sj._fused_launches(index, merged=merged, **ids)
    out = []
    for launch in launches:
        ws, wc, _, qb, qpos = sj._launch_prep(index, points_pad, deltas,
                                              launch, merged=merged,
                                              tables=tabs)
        plan = (sj._launch_run_plan(index, qpos, tile=launch[5])
                if run_loop else None)
        out.append(dict(launch=launch, plan=plan,
                        args=(points_pad, qb, ws, wc, is_zero, qpos,
                              index.eps),
                        kw=dict(c=launch[4], tq=launch[5],
                                n_real=index.n_dims, unicomp=unicomp,
                                merged=merged, gid_pairs=slab is not None)))
    return out


def _loop_kw(p, run_loop: bool) -> dict:
    if run_loop:
        return dict(run_ord=p["plan"].run_ord, run_loop=True)
    return {}


def max_abs_diff(kernel_out, plain_out) -> int:
    """Max |kernel - plain| over one launch's hits, counts and slot_base."""
    sync()
    worst = 0
    for x, y in zip(kernel_out, plain_out):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"kernel output {tuple(x.shape)} {x.dtype} vs plain "
              f"{tuple(y.shape)} {y.dtype}")
        worst = max(worst, int((x.to(torch.int64) - y.to(torch.int64))
                               .abs().max()))
    return worst


def compare_kernel_and_plain(prepared, keep_hits: bool,
                             run_loop: bool = False) -> int:
    """Max |kernel - plain| over hits, counts and slot_base of each launch."""
    from repro_torch.kernels import fused_join as fj
    return max((max_abs_diff(
        fj.fused_join_hits(*p["args"], method="kernel", keep_hits=keep_hits,
                           **_loop_kw(p, run_loop), **p["kw"]),
        fj.fused_join_hits(*p["args"], method="reference",
                           keep_hits=keep_hits, **p["kw"]))
        for p in prepared), default=0)


def external_queries(pts, eps: float, n: int = EXTERNAL_QUERIES,
                     seed: int = 11):
    """Seeded external queries over the volume widened by 2 eps on every
    side, a tenth of them repeating earlier rows."""
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(axis=0) - 2 * eps, pts.max(axis=0) + 2 * eps
    q = rng.uniform(lo, hi, (n, pts.shape[1]))
    dup = rng.choice(n, n // 10, replace=False)
    q[dup] = q[rng.integers(0, n // 2, dup.size)]
    return q.astype(pts.dtype)


def external_launches(prepared_join, q, keep_hits: bool = True):
    """B1 (b)'s launches of one request through ``prepared_join``, in the
    form of ``prepared_launches`` (each ``kw`` carries the whole launch)."""
    _, launches = prepared_join.launch_inputs(q, keep_hits=keep_hits)
    return [dict(args=args, kw=kw, plan=None) for _, _, args, kw in launches]


def compare_external(launches) -> int:
    """Max |kernel - plain| over hits, counts and slot_base of B1 (b)'s
    launches (the plain version ignores the run plan)."""
    from repro_torch.kernels import fused_join as fj
    return max((max_abs_diff(
        fj.fused_join_hits(*p["args"], method="kernel", **p["kw"]),
        fj.fused_join_hits(*p["args"], method="reference", **p["kw"]))
        for p in launches), default=0)


def timed_launches(prepared, method: str, run_loop: bool = False,
                   reps: int = 5) -> float:
    """Device ms of one pass over all launches: CUDA events around ``reps``
    passes queued back to back behind an untimed pass, so the host's work
    per launch overlaps the kernels instead of adding idle device time
    (events around each launch alone would count that idle time)."""
    from repro_torch.kernels import fused_join as fj

    def one_pass():
        for p in prepared:
            fj.fused_join_hits(*p["args"], method=method,
                               **_loop_kw(p, run_loop), **p["kw"])

    one_pass()
    return event_ms(one_pass, reps)


def profiled_device_ms(fn, reps: int = 5, kernel: str = "") -> float:
    """Device ms of ``fn()`` by torch.profiler: the device time of every
    kernel, copy and fill it queued (only the kernels whose name holds
    ``kernel``, when given), over ``reps`` calls, per call. For launches
    too small to keep the card busy while the host queues the next, where
    CUDA events around a pass also count the idle gaps."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    total = sum(getattr(e, "self_device_time_total", 0) or 0
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("Activity Buffer")
                and kernel in e.key)
    return total / 1e3 / reps


def kernel_bound(prepared):
    """Least time the card could take for B1's launches: the larger of
    bytes over HBM bandwidth and operations over the peak. Bytes: each
    input read once (descriptors, query rows, q_pos, the distinct window
    rows' used lanes) and each output written once (the int8 hit plane when
    kept, counts, slot_base). Operations, on the slots this data needs (sum
    of win_count): 3 * n_real floating-point ones (subtract, multiply, add)
    for l2 and cosine; for jaccard 2 * ceil(n_feat / 2) INT32 ones (AND,
    popcount) on the words packed two to a 32-bit word.
    The run loop does the same work, so it has the same bound. B1 (d)
    reads the id lane too: one more used lane a row."""
    total_bytes = 0
    flops = 0
    dtype = None
    for p in prepared:
        points_pad, qb, ws, wc, is_zero, qpos, _ = p["args"]
        n_off, qp = ws.shape
        c, n_real, merged = p["kw"]["c"], p["kw"]["n_real"], p["kw"]["merged"]
        n_feat = p["kw"].get("n_feat", 0)
        jaccard = p["kw"].get("metric", "l2") == "jaccard"
        item = points_pad.element_size()
        dtype = ("int32" if jaccard
                 else OPS_DTYPE[str(points_pad.dtype).replace("torch.", "")])
        used_lanes = (n_real + n_feat + (1 if merged else 0)
                      + (1 if p["kw"].get("gid_pairs") else 0))
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
                        + n_off * qp * c * p["kw"].get("keep_hits", True)
                        + qp * 4 * 2)                         # counts, base
        slots = int(wc.sum(dtype=torch.int64))
        flops += (2 * -(-n_feat // 2) if jaccard else 3 * n_real) * slots
    return bound(total_bytes, flops, dtype) + (total_bytes, flops)


def bound(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def hits_tile_work(nq: int, npts: int, n: int, item: int):
    """B2's work for one (nq, N) call: bytes = the query and candidate rows
    read once, the int8 plane written once; operations = (2n + 2) per pair
    (n multiplies and n - 1 adds of the dot product, then add, multiply by
    2, subtract) plus each row's norm once ((2n - 1) each)."""
    nbytes = (nq + npts) * n * item + nq * npts
    flops = nq * npts * (2 * n + 2) + (nq + npts) * (2 * n - 1)
    return nbytes, flops


def hits_issue_ms(pairs: int, n: int, unit: str) -> float:
    """B2's issue floor: the (2n + 2) instructions a pair (n multiplies,
    n - 1 adds, the norms' add, the fused multiply-subtract, the compare)
    at ``ISSUE_RATE[unit]``."""
    return pairs * (2 * n + 2) / ISSUE_RATE[unit] * 1e3


B2_KERNEL = "distance_tile_hits_kernel"
B1_KERNEL = "fused_join_kernel_self"
BRUTE_TILE = 256   # query rows of one B2 launch on the brute path


def b2_sweep(p, eps, method=None):
    """The brute path's B2 launches over ``p``: BRUTE_TILE query rows a
    call against all of ``p``, the planes dropped."""
    from repro_torch.kernels import distance_tile as dt
    for r0 in range(0, p.shape[0], BRUTE_TILE):
        dt.distance_tile_hits(p[r0:r0 + BRUTE_TILE], p, eps, method=method)


def b2_times(p, eps, library: bool = True) -> dict:
    """B2 over the brute sweep of ``p`` (eps built once, a tensor on the
    card): its device time by name under the profiler, the sweep's time by
    CUDA events (median of 3, after a warm-up), its bytes and operations
    bound and issue floor, and the yardstick the port never calls,
    ``torch.cdist(compute_mode="use_mm_for_euclid_dist")`` over the same
    tiles: the same expanded form through a library product, then a clamp
    and a square root, so not bit-equal (None where the card's torch
    refuses the dtype)."""
    npts, n = p.shape
    item = p.element_size()
    unit = OPS_DTYPE[str(p.dtype).replace("torch.", "")]
    nbytes = flops = 0
    for r0 in range(0, npts, BRUTE_TILE):
        nb, nf = hits_tile_work(min(BRUTE_TILE, npts - r0), npts, n, item)
        nbytes += nb
        flops += nf
    b = bound(nbytes, flops, unit)
    b2_sweep(p, eps)
    events = statistics.median(event_ms(lambda: b2_sweep(p, eps))
                               for _ in range(3))

    def cdist():
        for r0 in range(0, npts, BRUTE_TILE):
            torch.cdist(p[r0:r0 + BRUTE_TILE], p,
                        compute_mode="use_mm_for_euclid_dist")

    cdist_ms = cdist_note = None
    if library:
        try:
            cdist()
            cdist_ms = statistics.median(event_ms(cdist) for _ in range(3))
            cdist_note = ("torch.cdist(compute_mode='use_mm_for_euclid_"
                          "dist') over the same tiles: distances, not hits, "
                          "and not bit-equal (library product, clamp, "
                          "square root)")
        except RuntimeError as err:
            cdist_note = f"torch.cdist refused: {err}"[:200]
    return dict(device_ms=profiled_device_ms(lambda: b2_sweep(p, eps),
                                             reps=3, kernel=B2_KERNEL),
                events_ms=events, launches=-(-npts // BRUTE_TILE),
                bound_ms=b[0], bound_by=b[1], bound_bytes=nbytes,
                bound_flops=flops,
                issue_floor_ms=hits_issue_ms(npts * npts, n, unit),
                cdist_ms=cdist_ms, cdist_note=cdist_note)


def b2_checksum(p, eps) -> tuple[int, int]:
    """The brute sweep's hit total and a checksum of the hit positions: the
    sum of ``row * npts + col`` over the hits, mod 2^61."""
    from repro_torch.kernels import distance_tile as dt
    npts = p.shape[0]
    total = pos = 0
    for r0 in range(0, npts, BRUTE_TILE):
        hit = torch.nonzero(dt.distance_tile_hits(p[r0:r0 + BRUTE_TILE], p,
                                                  eps))
        total += hit.shape[0]
        pos += int(((hit[:, 0] + r0) * npts + hit[:, 1]).sum())
    return total, pos % 2 ** 61


def counts_tile_work(npts: int, n: int, item: int):
    """B3's work for one (N,) call: bytes = the rows read once and the
    counts written once; operations = (2n + 2) per unordered pair over the
    N(N - 1)/2 pairs the triangle evaluates (n multiplies and n - 1 adds of
    the dot product, then add, multiply by 2, subtract), plus each row's
    norm once ((2n - 1) each)."""
    nbytes = npts * n * item + npts * 4
    flops = npts * (npts - 1) // 2 * (2 * n + 2) + npts * (2 * n - 1)
    return nbytes, flops


def counts_issue_ms(npts: int, n: int, unit: str) -> float:
    """B3's issue floor: the (2n + 2) instructions a pair (n multiplies,
    n - 1 adds, the norms' add, the fused multiply-subtract, the compare)
    over N(N - 1)/2 pairs, at ``ISSUE_RATE[unit]``."""
    return npts * (npts - 1) / 2 * (2 * n + 2) / ISSUE_RATE[unit] * 1e3


def jaccard_issue_ms(prepared) -> float:
    """B1 (e)'s issue floor: ceil(n_feat / 2) POPC a live slot (one a
    packed 32-bit word) over the launches' slots, at ``ISSUE_RATE["popc"]``."""
    popc = sum(int(p["args"][3].sum(dtype=torch.int64))
               * -(-p["kw"]["n_feat"] // 2) for p in prepared)
    return popc / ISSUE_RATE["popc"] * 1e3


def band_points(pts_gpu, ids, eps: float) -> int:
    """How many of the points ``ids`` have a neighbour whose direct f64 d2
    lies within the expanded form's band of eps^2, |d2 - eps^2| <=
    (qn + pn) * 2^-50 (the only pairs where the direct and expanded forms
    may disagree)."""
    eps2 = float(eps) ** 2
    sq = (pts_gpu * pts_gpu).sum(dim=1)
    found = 0
    for chunk in range(0, ids.shape[0], 64):
        q = ids[chunk:chunk + 64]
        d2 = torch.zeros((q.shape[0], pts_gpu.shape[0]), dtype=torch.float64,
                         device=pts_gpu.device)
        for k in range(pts_gpu.shape[1]):
            t = pts_gpu[q, k][:, None] - pts_gpu[:, k][None, :]
            d2 = d2 + t * t
        band = (sq[q][:, None] + sq[None, :]) * BAND_SCALE
        near = (d2 - eps2).abs() <= band
        near[torch.arange(q.shape[0], device=q.device), q] = False
        found += int(near.any(dim=1).sum())
    return found


def counts_rows_vs_plain(pts_gpu, counts, eps: float, rows) -> int:
    """B3's counts of the points ``rows`` against its plain version's
    arithmetic for those rows (all points as candidates, self excluded):
    the largest absolute difference. The plain version over every point of
    the main path would take minutes, so it is held there on a sample."""
    from repro_torch.core import metric
    from repro_torch.kernels import distance_tile as dt
    scal = metric.device_refine_scalar("l2", eps, pts_gpu.dtype,
                                       pts_gpu.device)
    worst = 0
    for chunk in range(0, rows.shape[0], 64):
        q = rows[chunk:chunk + 64]
        hit = dt._distance_tile_hits_reference(pts_gpu[q], pts_gpu, scal)
        hit[torch.arange(q.shape[0], device=q.device), q] = False
        plain = hit.sum(dim=1, dtype=torch.int32)
        worst = max(worst, int((plain - counts[q]).abs().max()))
    return worst


def oracle_counts(pts_gpu, pairs_first, eps: float, where: str):
    """B3's per-point counts against a join's (a bincount of the pairs'
    first column): the points where they differ, all of which must have a
    neighbour in the band. Returns (differing points, B3 counts)."""
    from repro_torch.kernels import distance_tile as dt
    npts = pts_gpu.shape[0]
    counts = dt.distance_tile_counts(pts_gpu, eps)
    joined = torch.bincount(pairs_first.long(), minlength=npts)
    differ = torch.nonzero(counts.long() != joined).flatten()
    if differ.numel():
        explained = band_points(pts_gpu, differ, eps)
        check(explained == differ.numel(),
              f"{where}: {differ.numel() - explained} points differ between "
              f"B3's counts and the join's with no neighbour in the band")
    return int(differ.numel()), counts


# --- phases -----------------------------------------------------------------

_MANGLED_TYPES = {"d": "f64", "f": "f32", "6__half": "f16",
                  "13__nv_bfloat16": "bf16"}


def ptxas_by_kernel(log: str, kernel: str) -> dict:
    """Registers and spilled bytes (stores plus loads) of each instance of
    ``kernel`` in nvcc's ``-Xptxas -v`` output, keyed by its template
    arguments (B2's: row type, n, store width, as "f64_n2_w16"; B1's l2
    kernel: row type, merged, global ids, n_real (0: at run time), narrow
    steps, as "f64_merged1_gid0_nr2_narrow0"; the emit's: vector bytes and
    UNICOMP, as "v16_unicomp1")."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)", ln)
        if m:
            name = m.group(1)
            continue
        if not name or kernel not in name:
            continue
        rest = name.split(kernel, 1)[1]
        emit_ = re.match(r"ILi(\d+)ELb(\d)EE", rest)
        t = re.match(r"I(\w+?)Li(\d+)ELi(\d+)E", rest)
        b1 = re.match(r"I(\w+?)Lb(\d)ELb(\d)ELi(\d)ELb(\d)E", rest)
        key = (f"v{emit_[1]}_unicomp{emit_[2]}" if emit_
               else f"{_MANGLED_TYPES.get(b1[1], b1[1])}_merged{b1[2]}_"
               f"gid{b1[3]}_nr{b1[4]}_narrow{b1[5]}" if b1
               else f"{_MANGLED_TYPES.get(t[1], t[1])}_n{t[2]}_w{t[3]}" if t
               else rest)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(key, {})["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(key, {})["registers"] = int(m[1])
    return out


def sync_check() -> dict:
    """Which kernel wrappers wait for the device: one call each of B1 (one
    pass of ``timed_launches`` over the launches of a 20,000-point join;
    "b1_tile" the same over a 200,000-point join, whose widest class of
    ``fused_join.SPREAD_TILES`` tiles or more takes a block a tile),
    B1 (b) (the launches of a 1,024-query request on that index, planned
    beforehand: planning syncs once, by design), B2, B3 and B4 (one offset
    of the unfused join) under ``torch.cuda.set_sync_debug_mode("error")``,
    at each row dtype, with eps a Python float ("python_eps") and with eps
    as the phases pass it ("as_passed": B1 and B4 the index's eps tensor,
    B1 (b) the request's scalar, B2 and B3 a Python float). True where the
    call synchronised."""
    from repro_torch.core import grid, query_join as qj
    from repro_torch.kernels import cell_join as cj, distance_tile as dt
    from repro_torch.kernels import fused_join as fj
    out = {}
    for dname, dtype in (("float64", torch.float64),
                         ("float32", torch.float32),
                         ("float16", torch.float16),
                         ("bfloat16", torch.bfloat16)):
        raw = syn(20000, 2)
        pts = torch.as_tensor(raw).to(DEVICE, dtype)
        index = grid.build_grid(pts, 1.0, device=DEVICE)
        prepared = prepared_launches(index, merged=True, unicomp=True)
        big = grid.build_grid(torch.as_tensor(syn(200000, 2)).to(
            DEVICE, dtype), 1.0, device=DEVICE)
        tiled = prepared_launches(big, merged=True, unicomp=True)
        # (a package from before the threshold, timed in turns, has none)
        check(max(p["args"][1].shape[0] // p["kw"]["tq"] for p in tiled)
              >= getattr(fj, "SPREAD_TILES", 0),
              "sync_check: no launch a block a tile")
        ext = external_launches(qj.prepare(index),
                                external_queries(raw, 1.0, 1024))
        (q, cand, valid), = unfused_launches(index)[:1]
        calls = {
            "b1": lambda e: [fj.fused_join_hits(*p["args"][:-1], e,
                                                method="kernel", **p["kw"])
                             for p in prepared],
            "b1_tile": lambda e: [
                fj.fused_join_hits(*p["args"][:-1], e, method="kernel",
                                   **p["kw"]) for p in tiled],
            "b1b": lambda e: [fj.fused_join_hits(*p["args"][:-1], e,
                                                 method="kernel", **p["kw"])
                              for p in ext],
            "b2": lambda e: dt.distance_tile_hits(pts[:256], pts, e,
                                                  method="kernel"),
            "b3": lambda e: dt.distance_tile_counts(pts, e, method="kernel"),
            "b4": lambda e: cj.cell_join_hits(q, cand, valid, e,
                                              method="kernel"),
        }
        passed = {"b1": index.eps, "b1_tile": big.eps,
                  "b1b": ext[0]["args"][-1], "b2": 1.0,
                  "b3": 1.0, "b4": index.eps}
        out[dname] = {}
        for name, fn in calls.items():
            for key, e in (("python_eps", 1.0), ("as_passed", passed[name])):
                fn(e)                      # loads the library, untimed
                sync()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn(e)
                    synced = False
                except RuntimeError as err:
                    if "synchroniz" not in str(err):
                        raise
                    synced = True
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                out[dname][f"{name}_{key}"] = synced
        sync()
    return out


def phase_syncs():
    """No kernel wrapper waits for the device (``sync_check``)."""
    syncs = sync_check()
    emit("syncs", **syncs)
    check(not any(v for d in syncs.values() for v in d.values()),
          f"a kernel wrapper synchronised: {syncs}")


def phase_env():
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         nvidia_smi=nvidia_smi_line())


def phase_build():
    from repro_torch.kernels import build, cell_join as cj
    from repro_torch.kernels import distance_tile as dt, fused_join as fj
    t0 = time.perf_counter()
    built = build.build_all()
    fj._kernel_library()
    dt._kernel_library()
    cj._kernel_library()
    seconds = time.perf_counter() - t0
    b2 = ptxas_by_kernel(built["distance_tile"][1], B2_KERNEL)
    b1 = ptxas_by_kernel(built["fused_join"][1], B1_KERNEL)
    emit("build", seconds=seconds, b1_ptxas=dict(
        instances=len(b1),
        max_registers=max((v["registers"] for v in b1.values()), default=None),
        spilled={k: v["spill_bytes"] for k, v in b1.items()
                 if v.get("spill_bytes")},
        main_path=b1.get("f64_merged1_gid0_nr2_narrow0")), b2_ptxas=dict(
        instances=len(b2),
        max_registers=max((v["registers"] for v in b2.values()), default=None),
        spilled={k: v["spill_bytes"] for k, v in b2.items()
                 if v.get("spill_bytes")},
        timed={k: b2.get(k) for k in ("f64_n2_w16", "f16_n2_w16",
                                      "bf16_n2_w16")}), libraries={
        name: dict(path=str(path.relative_to(ROOT)), built=bool(log),
                   ptxas=sorted({ln.split(":", 1)[-1].strip()
                                 for ln in log.splitlines()
                                 if "registers" in ln or "spill" in ln}))
        for name, (path, log) in built.items()})


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
                    for run_loop in (False, True):
                        prepared = prepared_launches(
                            index, merged=merged, unicomp=unicomp,
                            run_loop=run_loop)
                        for keep_hits in (True, False):
                            err = compare_kernel_and_plain(
                                prepared, keep_hits, run_loop)
                            check(err == 0, f"{name} {np.dtype(dtype).name} "
                                  f"merged={merged} unicomp={unicomp} "
                                  f"run_loop={run_loop} keep_hits="
                                  f"{keep_hits}: kernel differs from the "
                                  f"plain version by {err}")
                            worst = max(worst, err)
                            compared += len(prepared)
        emit("kernel_vs_plain", workload=name, points=len(pts), eps=eps,
             variants=32, launches_compared=compared, max_abs_err=worst,
             exact=True)
    return max(worst, external_vs_plain(workloads))


def external_vs_plain(workloads) -> int:
    """B1 (b) against its plain version on every launch of a request of
    EXTERNAL_QUERIES queries against each bench workload's index, across
    dtype x merged x run loop x keep_hits. A quarter as many queries again
    lie within about eps of indexed points, so that the sparse high-
    dimensional volumes, where uniform queries find no window, launch."""
    import repro_torch
    from repro_torch.core import query_join as qj
    worst = 0
    for name, (pts, eps) in workloads.items():
        compared = 0
        rng = np.random.default_rng(12)
        n_near = EXTERNAL_QUERIES // 4
        near = (pts[rng.integers(0, len(pts), n_near)]
                + rng.normal(0, eps / 2, (n_near, pts.shape[1])))
        for dtype in (np.float64, np.float32):
            index = repro_torch.build_grid(pts.astype(dtype), eps,
                                           device=DEVICE)
            q = np.concatenate([external_queries(pts.astype(dtype), eps),
                                near.astype(dtype)])
            for merged in (True, False):
                for run_loop in (False, True):
                    pj = qj.prepare(index, merge_last_dim=merged,
                                    run_loop=run_loop)
                    for keep_hits in (True, False):
                        launches = external_launches(pj, q, keep_hits)
                        err = compare_external(launches)
                        check(err == 0, f"{name} {np.dtype(dtype).name} "
                              f"external merged={merged} run_loop="
                              f"{run_loop} keep_hits={keep_hits}: kernel "
                              f"differs from the plain version by {err}")
                        worst = max(worst, err)
                        compared += len(launches)
        check(compared > 0, f"{name}: no external launch to compare")
        emit("kernel_vs_plain", workload=name, points=len(pts), eps=eps,
             variant="external", variants=16,
             queries=EXTERNAL_QUERIES + n_near, launches_compared=compared,
             max_abs_err=worst, exact=True)
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
        run = repro_torch.self_join_count(pts, eps, route="dense-run",
                                          device=DEVICE)
        want = BENCH_TOTALS[name]
        check(stats.total_pairs == want == run.total_pairs, f"{name}: count "
              f"{stats.total_pairs} / dense-run {run.total_pairs} != "
              f"recorded {want}")
        check(pairs.shape[0] == want, f"{name}: join emitted "
              f"{pairs.shape[0]} pairs, recorded {want}")
        emit("bench_totals", workload=name, points=len(pts), eps=eps,
             total_pairs=want, count_s=t1 - t0, join_s=t2 - t1,
             offsets=stats.offsets, cells_visited=stats.cells_visited,
             candidates_checked=stats.candidates_checked,
             windows_row=stats.dma_windows_issued,
             windows_run=run.dma_windows_issued)


def check_pairs(pairs, pts_gpu, eps: float, n: int):
    """Symmetric, no self pairs, and exact neighbour lists for sampled ids
    against a direct evaluation in the kernel's lane order."""
    check(pairs.shape[0] > 0 and pairs.dtype == torch.int32, "no pairs")
    check(bool((pairs[:, 0] != pairs[:, 1]).all()), "self pair emitted")
    from repro_torch.core.selfjoin import sort_pairs
    check(torch.equal(sort_pairs(pairs.flip(1), n), pairs),
          "pair set is not symmetric")
    from repro_torch.core import metric
    eps2 = metric.scalar_as(eps, pts_gpu.dtype, pts_gpu.device)
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
    from repro_torch.kernels import distance_tile as dt
    from repro_torch.kernels import emit_pairs as ep
    from repro_torch.kernels import fused_join as fj
    pts = syn(MAIN_POINTS, MAIN_DIMS)
    eps = MAIN_EPS

    index = repro_torch.build_grid(pts, eps, device=DEVICE)
    merged = sj._resolve_merge(index, None)
    check(sj._join_run_loop(index), "the main path does not take the run "
          "loop (fewer than 2 points a cell)")
    expected = len(sj._fused_launches(index, merged=merged)[0])
    del index
    repro_torch.self_join(pts, eps, device=DEVICE)       # warm-up
    sync()
    pts_gpu = torch.as_tensor(pts).to(DEVICE)
    e2e, launches = [], []
    for rep in range(3):
        torch.cuda.reset_peak_memory_stats()
        fj.KERNEL_LAUNCHES = fj.RUN_LOOP_LAUNCHES = 0
        dt.COUNTS_LAUNCHES = ep.KERNEL_LAUNCHES = 0
        with recorded_tiles() as tiles:
            t0 = time.perf_counter()
            pairs = repro_torch.self_join(pts, eps, device=DEVICE)
            sync()
            e2e.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if rep == 2:
            # the path's full-scale oracle: B3 over all points
            t0 = time.perf_counter()
            n_differ, b3_counts = oracle_counts(pts_gpu, pairs[:, 0], eps,
                                                "main path")
            sync()
            oracle_s = time.perf_counter() - t0
        launches.append((fj.KERNEL_LAUNCHES, fj.RUN_LOOP_LAUNCHES,
                         dt.COUNTS_LAUNCHES, ep.KERNEL_LAUNCHES))
    check(all(k == r == e == expected for k, r, _, e in launches)
          and expected > 0,
          f"main path launched B1 (total, run loop) and the emit "
          f"{launches} times, scheduled {expected} run-loop launches per "
          f"run")
    check(launches[-1][2] == 1, "the oracle did not launch B3 once")
    tiles = sorted(tiles)
    check(tiles == [fj.TQ_DEFAULT], f"the main path launched B1 at tiles "
          f"{tiles}, not the empty table's {fj.TQ_DEFAULT}")

    stats = repro_torch.self_join_count(pts, eps, device=DEVICE)
    check(stats.total_pairs == pairs.shape[0],
          f"count {stats.total_pairs} != emitted {pairs.shape[0]}")
    check(int(b3_counts.sum(dtype=torch.int64)) == pairs.shape[0]
          or n_differ > 0, "B3's total differs with no differing point")
    check_pairs(pairs, pts_gpu, eps, MAIN_POINTS)
    gen = torch.Generator(device="cpu").manual_seed(1)
    b3_rows = torch.randperm(MAIN_POINTS, generator=gen)[:SAMPLED_QUERIES]
    b3_err = counts_rows_vs_plain(pts_gpu, b3_counts, eps, b3_rows.to(DEVICE))
    check(b3_err == 0, f"main path: B3 differs from its plain version by "
          f"{b3_err} on sampled rows")
    b3_runs = [event_ms(lambda: dt.distance_tile_counts(pts_gpu, eps))
               for _ in range(3)]
    b3_ms = statistics.median(b3_runs)
    b3_bound = bound(*counts_tile_work(MAIN_POINTS, MAIN_DIMS, 8), "float64")
    b3_issue = counts_issue_ms(MAIN_POINTS, MAIN_DIMS, "float64")

    index = repro_torch.build_grid(pts, eps, device=DEVICE)
    prepared = prepared_launches(index, merged=merged, unicomp=True,
                                 run_loop=True)
    worst = compare_kernel_and_plain(prepared, keep_hits=True, run_loop=True)
    check(worst == 0, f"main path: run-loop kernel differs from plain by "
          f"{worst}")
    check(sorted({p["kw"]["tq"] for p in prepared}) == tiles,
          "the timed launches' tiles differ from the main path's")
    # the variants in turns, three rounds, the median of each
    variants = (("run", "kernel", True), ("row", "kernel", False),
                ("plain", "reference", False))
    rounds = [{key: timed_launches(prepared, method, run_loop)
               for key, method, run_loop in variants} for _ in range(3)]
    timed = {key: statistics.median(r[key] for r in rounds)
             for key, _, _ in variants}
    bound_ms, bound_by, nbytes, flops = kernel_bound(prepared)
    runs = [p["plan"].n_runs for p in prepared]
    rows = [p["args"][1].shape[0] for p in prepared]
    total_pairs = int(pairs.shape[0])
    del pts_gpu, b3_counts, pairs
    # the emit on the main path's own launches: the kernel, its plain
    # version and its bound
    emitted = emit_times(recorded_emits(
        lambda: repro_torch.self_join(pts, eps, device=DEVICE)))
    check(emitted["launches"] == expected, f"the main path emitted "
          f"{emitted['launches']} launches, scheduled {expected}")
    emit("main_path", points=MAIN_POINTS, dims=MAIN_DIMS, eps=eps,
         dtype="float64", total_pairs=total_pairs,
         run_loop=True, launches=launches[-1][0], tq=tiles,
         launch_caps=[p["kw"]["c"] for p in prepared], launch_rows=rows,
         launch_runs=runs, offsets=stats.offsets,
         candidates_checked=stats.candidates_checked,
         sampled_queries_checked=SAMPLED_QUERIES,
         e2e_s=statistics.median(e2e), e2e_runs_s=e2e, peak_mem_bytes=peak,
         kernel_run_loop_ms=timed["run"], kernel_row_loop_ms=timed["row"],
         plain_ms=timed["plain"], timed_rounds_ms=rounds,
         bound_ms=bound_ms, bound_by=bound_by,
         bound_bytes=nbytes, bound_flops=flops, kernel_equals_plain=True,
         oracle_points=MAIN_POINTS, oracle_differing_points=n_differ,
         oracle_s=oracle_s, b3_ms=b3_ms, b3_runs_ms=b3_runs,
         b3_bound_ms=b3_bound[0], b3_bound_by=b3_bound[1],
         b3_issue_floor_ms=b3_issue, b3_rows_vs_plain=SAMPLED_QUERIES,
         b3_rows_max_abs_err=b3_err, emit_launches=launches[-1][3],
         emit_ms=emitted["device_ms"], emit_events_ms=emitted["ms"],
         emit_plain_ms=emitted["plain_ms"], emit_bound_ms=emitted["bound_ms"],
         emit_equals_plain=True)
    return dict(b1=dict(launches=launches[-1][0], tq=tiles[0],
                        run_loop_launches=launches[-1][1],
                        ms=timed["run"], row_loop_ms=timed["row"],
                        plain_ms=timed["plain"], bound_ms=bound_ms,
                        bound_by=bound_by),
                b3_launches=launches[-1][2], b3_ms=b3_ms, b3_err=b3_err,
                b3_bound=b3_bound, b3_issue=b3_issue,
                emit=dict(emitted, launches=launches[-1][3]),
                e2e=statistics.median(e2e), peak=peak,
                total_pairs=total_pairs)


def unfused_launches(index, unicomp: bool = True):
    """B4's inputs on every launch of one unfused join over ``index``, as
    the driver gathers them: (q, cand, valid) per stencil offset (the count
    and the fill pass launch B4 on the same inputs)."""
    from repro_torch.core import selfjoin as sj
    deltas, _ = sj._offset_tables(index, unicomp)
    cap = sj._unfused_cap(index)
    out = []
    for o in range(deltas.shape[0]):
        q, cand, _, valid, _, _ = sj._gather_batch(
            index, sj._neighbor_ranks_for_delta(index, deltas[o]), 0,
            index.num_points, cap)
        out.append((q, cand, valid))
    return out


def b4_vs_plain(launches, eps) -> int:
    """Max |kernel - plain| of B4 over ``launches``."""
    from repro_torch.kernels import cell_join as cj
    worst = 0
    for q, cand, valid in launches:
        a = cj.cell_join_hits(q, cand, valid, eps, method="kernel")
        b = cj.cell_join_hits(q, cand, valid, eps, method="reference")
        sync()
        worst = max(worst, int((a.to(torch.int8) - b.to(torch.int8))
                               .abs().max()))
    return worst


def b4_ms(launches, eps, method: str, reps: int = 5) -> float:
    """Device ms of one B4 launch (or its plain version), by CUDA events
    over ``reps`` back-to-back passes over ``launches``, after an untimed
    pass."""
    from repro_torch.kernels import cell_join as cj

    def one_pass():
        for q, cand, valid in launches:
            cj.cell_join_hits(q, cand, valid, eps, method=method)

    one_pass()
    return event_ms(one_pass, reps) / len(launches)


def b4_work(launches):
    """B4's work over ``launches``, on what this data needs: bytes = the
    32-byte sectors that hold a valid slot's candidate lanes (an invalid
    slot's are never needed), q and valid read once and the int8 hits
    written once; operations = 3n (subtract, multiply, add a lane) on every
    valid slot."""
    nbytes = flops = 0
    for q, cand, valid in launches:
        b, c, n = cand.shape
        width = n * q.element_size()                 # bytes of one slot
        slot = torch.nonzero(valid.reshape(-1)).reshape(-1)
        first = slot * width // 32
        last = ((slot + 1) * width - 1) // 32
        sector = torch.zeros((b * c * width + 31) // 32, dtype=torch.bool,
                             device=valid.device)
        for j in range(width // 32 + 2):              # sectors a slot spans
            s = first + j
            sector[s[s <= last]] = True
        nbytes += (int(sector.sum()) * 32 + q.numel() * q.element_size()
                   + 2 * b * c)
        flops += 3 * n * int(slot.numel())
    return nbytes, flops


def compact_fused_b1(pts, eps, counts) -> dict:
    """``self_join_count_compact(distance_impl="fused")`` into
    ``counts["compact-fused"]``, with B1's launches counted around it and
    the inputs of its one launch (the o = 0 pass: per-cell sweep, no hit
    plane) captured, then B1 held to its plain version on them."""
    import repro_torch
    from repro_torch.kernels import fused_join as fj, ops
    seen = []
    launch = ops.fused_join_hits

    def spy(*args, **kw):
        seen.append((args, kw))
        return launch(*args, **kw)

    ops.fused_join_hits = spy
    try:
        fj.KERNEL_LAUNCHES = 0
        counts["compact-fused"] = repro_torch.self_join_count_compact(
            pts, eps, distance_impl="fused", device=DEVICE)
        sync()
        launches = fj.KERNEL_LAUNCHES
    finally:
        ops.fused_join_hits = launch
    check(launches == 1 == len(seen), f"the compact count launched B1 "
          f"{launches} times over {len(seen)} calls, 1 scheduled")
    args, kw = seen[0]
    check(not kw["keep_hits"] and not kw["merged"],
          "the compact count's B1 launch kept hits or merged lanes")
    worst = max_abs_diff(fj.fused_join_hits(*args, method="kernel", **kw),
                         fj.fused_join_hits(*args, method="reference", **kw))
    check(worst == 0, f"the compact count's B1 launch differs from its "
          f"plain version by {worst}")
    return dict(launches=launches, worst=worst)


def lattice_total(side: int, eps: int) -> int:
    """Ordered pairs of the unfused phase's lattice: sites of a side^3
    integer cube, each twice, within eps. Per nonzero offset o with
    |o|^2 <= eps^2, prod(side - |o_i|) ordered site pairs, each 4 point
    pairs; each site's two copies add 2."""
    r = range(-eps, eps + 1)
    sites = sum(int(np.prod([side - abs(v) for v in o]))
                for o in np.array(np.meshgrid(r, r, r)).reshape(3, -1).T
                if 0 < int((o * o).sum()) <= eps * eps)
    return 4 * sites + 2 * side ** 3


def phase_unfused(main):
    """The unfused offset sweep on the main path's points: joins through
    "pallas" (kernel B4) and "jnp" against the fused join, B4 against its
    plain version on every launch at f64 and f32, the counts of every
    route and impl, the batched join, per-point counts, the bench totals
    through "pallas" and a lattice with d^2 exactly on eps^2."""
    import repro_torch
    from repro_torch.core import selfjoin as sj
    from repro_torch.kernels import cell_join as cj
    t_phase = time.perf_counter()
    pts = syn(MAIN_POINTS, MAIN_DIMS)
    eps = MAIN_EPS
    fused = repro_torch.self_join(pts, eps, device=DEVICE)
    check(fused.shape[0] == MAIN_TOTAL == main["total_pairs"],
          f"fused join emitted {fused.shape[0]} pairs, recorded "
          f"{MAIN_TOTAL}")
    index = repro_torch.build_grid(pts, eps, device=DEVICE)
    n_off = int(sj._offset_tables(index, True)[0].shape[0])
    joins = {impl: (lambda impl=impl: repro_torch.self_join(
        pts, eps, distance_impl=impl, device=DEVICE))
        for impl in ("fused", "pallas", "jnp")}
    timed, launches = {}, []
    for impl in ("fused", "pallas", "jnp"):
        joins[impl]()                                     # warm-up
        sync()
        runs = []
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            cj.KERNEL_LAUNCHES = 0
            t0 = time.perf_counter()
            pairs = joins[impl]()
            sync()
            runs.append(time.perf_counter() - t0)
            if impl == "pallas":
                launches.append(cj.KERNEL_LAUNCHES)
            check(torch.equal(pairs, fused), f"{impl} join's pairs differ "
                  f"from the fused join's")
        timed[impl] = dict(s=statistics.median(runs), runs_s=runs,
                           peak_bytes=torch.cuda.max_memory_allocated())
        del pairs
    check(launches == [2 * n_off] * 3, f"the pallas join launched B4 "
          f"{launches} times, {2 * n_off} scheduled (count and fill per "
          f"offset)")

    # B4 against its plain version on every launch, f64 then f32
    prepared = unfused_launches(index)
    worst = b4_vs_plain(prepared, index.eps)
    check(worst == 0, f"B4 differs from its plain version by {worst}")
    ms = b4_ms(prepared, index.eps, "kernel")
    plain_ms = b4_ms(prepared, index.eps, "reference")
    nbytes, flops = b4_work(prepared)
    bound_ms, bound_by = bound(nbytes, flops, "float64")
    shape = list(prepared[0][1].shape)
    del prepared
    pts32 = pts.astype(np.float32)
    index32 = repro_torch.build_grid(pts32, eps, device=DEVICE)
    worst32 = b4_vs_plain(unfused_launches(index32), index32.eps)
    check(worst32 == 0, f"f32: B4 differs from its plain version by "
          f"{worst32}")
    check(torch.equal(
        repro_torch.self_join(pts32, eps, distance_impl="pallas",
                              device=DEVICE),
        repro_torch.self_join(pts32, eps, device=DEVICE)),
        "f32: the pallas join's pairs differ from the fused join's")
    del index32

    # counts: every impl and route
    t0 = time.perf_counter()
    counts = {impl: repro_torch.self_join_count(pts, eps, distance_impl=impl,
                                                device=DEVICE)
              for impl in ("pallas", "jnp")}
    counts["route=jnp"] = repro_torch.self_join_count(pts, eps, route="jnp",
                                                      device=DEVICE)
    counts["route=compact"] = repro_torch.self_join_count(
        pts, eps, route="compact", device=DEVICE)
    for impl in ("jnp", "pallas"):
        counts[f"compact-{impl}"] = repro_torch.self_join_count_compact(
            pts, eps, distance_impl=impl, device=DEVICE)
    compact_b1 = compact_fused_b1(pts, eps, counts)
    totals = {k: v.total_pairs for k, v in counts.items()}
    check(set(totals.values()) == {MAIN_TOTAL}, f"count totals {totals}")
    check(counts["pallas"] == counts["jnp"]
          and dataclasses.replace(counts["route=jnp"], route="dense")
          == counts["jnp"], "the unfused counts' counters differ")
    counts_s = time.perf_counter() - t0

    got = repro_torch.self_join_batched(pts, eps, distance_impl="pallas",
                                        n_batches=3, sort_result=False,
                                        device=DEVICE)
    check(torch.equal(sj.sort_pairs(got.to(DEVICE), MAIN_POINTS), fused),
          "batched pallas pairs differ from the fused join's")
    del got
    degree = torch.bincount(fused[:, 0].long(), minlength=MAIN_POINTS)
    degree = degree.to(torch.int32).cpu().numpy()
    for merged in (True, False):
        check(np.array_equal(repro_torch.per_point_neighbor_counts(
            pts, eps, merge_last_dim=merged, device=DEVICE), degree),
            f"per-point counts (merged={merged}) differ from the join's")
    del fused

    bench = {}
    for name, (bpts, beps) in bench_workloads().items():
        stats = repro_torch.self_join_count(bpts, beps, distance_impl="pallas",
                                            device=DEVICE)
        check(stats.total_pairs == BENCH_TOTALS[name], f"{name}: pallas "
              f"count {stats.total_pairs}, recorded {BENCH_TOTALS[name]}")
        bench[name] = dict(total_pairs=stats.total_pairs,
                           offsets=stats.offsets)

    g = np.arange(LATTICE_SIDE)
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    lat = np.concatenate([sites, sites]).astype(np.float64)
    want = lattice_total(LATTICE_SIDE, LATTICE_EPS)
    lat_index = repro_torch.build_grid(lat, LATTICE_EPS, device=DEVICE)
    lat_worst = b4_vs_plain(unfused_launches(lat_index), lat_index.eps)
    check(lat_worst == 0, f"lattice: B4 differs from its plain version by "
          f"{lat_worst}")
    for dtype in (np.float64, np.float32):
        got = repro_torch.self_join(lat.astype(dtype), LATTICE_EPS,
                                    distance_impl="pallas", device=DEVICE)
        check(got.shape[0] == want, f"lattice {np.dtype(dtype).name}: "
              f"{got.shape[0]} pairs, the integer count is {want}")

    prof = profiled_join(joins["pallas"], kernel="cell_join_kernel")
    emit("unfused", points=MAIN_POINTS, dims=MAIN_DIMS, eps=eps,
         dtype="float64", total_pairs=MAIN_TOTAL, offsets=n_off,
         launches=launches[-1], join_s={k: v["s"] for k, v in timed.items()},
         join_runs_s={k: v["runs_s"] for k, v in timed.items()},
         peak_bytes={k: v["peak_bytes"] for k, v in timed.items()},
         b4_launch_shape=shape, b4_ms=ms, b4_plain_ms=plain_ms,
         b4_bound_ms=bound_ms / n_off, b4_bound_by=bound_by,
         b4_bound_bytes=nbytes // n_off, b4_bound_flops=flops // n_off,
         b4_max_abs_err=max(worst, worst32, lat_worst),
         b4_f32_max_abs_err=worst32, counts_s=counts_s,
         count_totals=totals, cells_visited=counts["jnp"].cells_visited,
         candidates_checked=counts["jnp"].candidates_checked,
         compact_candidates=counts["route=compact"].candidates_checked,
         compact_b1_launches=compact_b1["launches"],
         compact_b1_max_abs_err=compact_b1["worst"],
         bench_pallas=bench, lattice_points=len(lat),
         lattice_pairs=want, profile=prof,
         phase_s=time.perf_counter() - t_phase)
    return dict(launches=launches[-1], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms / n_off, bound_by=bound_by,
                worst=max(worst, worst32, lat_worst))


def phase_batched(main):
    import repro_torch
    from repro_torch.core.selfjoin import sort_pairs
    pts = syn(MAIN_POINTS, MAIN_DIMS)
    repro_torch.self_join_batched(pts, MAIN_EPS, n_batches=3,
                                  sort_result=False, device=DEVICE)  # warm-up
    times, peaks = {}, {}
    for key in ("one_shot", "batched"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if key == "one_shot":
            one = repro_torch.self_join(pts, MAIN_EPS, sort_result=False,
                                        device=DEVICE)
        else:
            got = repro_torch.self_join_batched(pts, MAIN_EPS, n_batches=3,
                                                sort_result=False,
                                                device=DEVICE)
        sync()
        times[key] = time.perf_counter() - t0
        peaks[key] = torch.cuda.max_memory_allocated()
    check(got.device.type == "cpu", "self_join_batched left its pairs on "
          "the card")
    check(torch.equal(sort_pairs(got.to(DEVICE), MAIN_POINTS),
                      sort_pairs(one, MAIN_POINTS)),
          "batched pairs differ from self_join's")
    n_main = int(got.shape[0])
    del got, one

    pts = syn(PAPER_POINTS, MAIN_DIMS)
    stats = repro_torch.self_join_count(pts, PAPER_EPS, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    big = repro_torch.self_join_batched(pts, PAPER_EPS, n_batches=3,
                                        sort_result=False, device=DEVICE)
    sync()
    big_s = time.perf_counter() - t0
    big_peak = torch.cuda.max_memory_allocated()
    check(big.shape[0] == stats.total_pairs,
          f"10 M batched join emitted {big.shape[0]} pairs, the count says "
          f"{stats.total_pairs}")
    check(bool((big[:, 0] != big[:, 1]).all()), "self pair at 10 M points")
    emit("batched", points=MAIN_POINTS, eps=MAIN_EPS, n_batches=3,
         total_pairs=n_main, batched_s=times["batched"],
         one_shot_s=times["one_shot"], batched_peak_bytes=peaks["batched"],
         one_shot_peak_bytes=peaks["one_shot"],
         paper_points=PAPER_POINTS, paper_eps=PAPER_EPS,
         paper_total_pairs=int(big.shape[0]), paper_batched_s=big_s,
         paper_peak_bytes=big_peak, sort_result=False,
         note="both joins unsorted; the batched result is on the host")


def phase_brute(workloads):
    import repro_torch
    from repro_torch.core import metric
    from repro_torch.kernels import distance_tile as dt
    worst = 0
    shapes = {}
    for name in BRUTE_WORKLOADS:
        pts, eps = workloads[name]
        p = torch.as_tensor(pts).to(DEVICE)
        n = p.shape[1]
        for r0 in range(0, p.shape[0], 256):
            a = dt.distance_tile_hits(p[r0:r0 + 256], p, eps, method="kernel")
            b = dt.distance_tile_hits(p[r0:r0 + 256], p, eps,
                                      method="reference")
            check(torch.equal(a, b), f"{name}: B2 differs from its plain "
                  f"version on rows {r0}..")
        a = dt.distance_tile_counts(p, eps, method="kernel")
        b = dt.distance_tile_counts(p, eps, method="reference")
        worst = max(worst, int((a.long() - b.long()).abs().max()))
        check(torch.equal(a, b), f"{name}: B3 differs from its plain version")
        shapes[name] = (p, eps, n)

    # the brute path: B2 through brute_force_count, counted alone
    dt.HITS_LAUNCHES = 0
    totals = {}
    t0 = time.perf_counter()
    for name in BRUTE_WORKLOADS:
        pts, eps = workloads[name]
        totals[name] = repro_torch.brute_force_count(
            pts, eps, distance_impl="pallas", device=DEVICE)
    brute_s = time.perf_counter() - t0
    hits_launches = dt.HITS_LAUNCHES
    check(hits_launches == sum(-(-len(workloads[w][0]) // 256)
                               for w in BRUTE_WORKLOADS),
          f"brute path launched B2 {hits_launches} times")
    band = {}
    for name in BRUTE_WORKLOADS:
        p, eps, _ = shapes[name]
        pairs = repro_torch.self_join(p.cpu().numpy(), eps, device=DEVICE)
        n_differ, counts = oracle_counts(p, pairs[:, 0], eps, name)
        check(int(counts.sum(dtype=torch.int64)) == totals[name],
              f"{name}: brute_force_count {totals[name]} != B3's total")
        check(totals[name] == BENCH_TOTALS[name] or n_differ > 0,
              f"{name}: brute total {totals[name]} != recorded "
              f"{BENCH_TOTALS[name]} with no band point")
        band[name] = n_differ

    # times at the uniform-2d shapes: the brute path itself (host clock,
    # and its device time under the profiler: B2's and the rest, the torch
    # mask and sums), the brute sweep's B2 launches, and B3
    p, eps, n = shapes["uniform-2d"]
    npts = p.shape[0]

    def brute():
        repro_torch.brute_force_count(p, eps, distance_impl="pallas",
                                      device=DEVICE)

    brute()
    path_s = statistics.median(_host_s(brute) for _ in range(3))
    path_device_ms = profiled_device_ms(brute, reps=3)
    path_b2_ms = profiled_device_ms(brute, reps=3, kernel=B2_KERNEL)
    eps_t = metric.scalar_as(eps, p.dtype, DEVICE)
    b2 = b2_times(p, eps_t)
    timed = {}
    for key, fn in (("b2_plain", lambda: b2_sweep(p, eps_t, "reference")),
                    ("b3", lambda: dt.distance_tile_counts(
                        p, eps, method="kernel")),
                    ("b3_plain", lambda: dt.distance_tile_counts(
                        p, eps, method="reference"))):
        fn()                                              # warm-up
        timed[key] = statistics.median(event_ms(fn) for _ in range(3))
    b3_bound = bound(*counts_tile_work(npts, n, 8), "float64")
    b3_issue = counts_issue_ms(npts, n, "float64")
    emit("brute", workloads=list(BRUTE_WORKLOADS), totals=totals,
         band_points=band, brute_count_s=brute_s,
         uniform_brute_count_s=path_s,
         uniform_brute_device_ms=path_device_ms,
         uniform_brute_b2_device_ms=path_b2_ms,
         uniform_brute_busy_share=path_device_ms / (path_s * 1e3),
         b2_launches=hits_launches, b2_equals_plain=True,
         b3_equals_plain=True, timed_on="uniform-2d", timed_points=npts,
         b2_device_ms=b2["device_ms"], b2_events_ms=b2["events_ms"],
         b2_plain_ms=timed["b2_plain"],
         b2_bound_ms=b2["bound_ms"], b2_bound_by=b2["bound_by"],
         b2_bound_bytes=b2["bound_bytes"], b2_bound_flops=b2["bound_flops"],
         b2_issue_floor_ms=b2["issue_floor_ms"], b2_cdist_ms=b2["cdist_ms"],
         b2_cdist_note=b2["cdist_note"], b2_launches_timed=b2["launches"],
         b3_ms=timed["b3"], b3_plain_ms=timed["b3_plain"],
         b3_bound_ms=b3_bound[0], b3_bound_by=b3_bound[1],
         b3_issue_floor_ms=b3_issue)
    return dict(b2=dict(b2, launches=hits_launches,
                        plain_ms=timed["b2_plain"]),
                b3=dict(ms=timed["b3"], plain_ms=timed["b3_plain"],
                        bound_ms=b3_bound[0], bound_by=b3_bound[1],
                        issue_ms=b3_issue),
                worst=worst)


def phase_profile():
    """One main-path join under ``torch.profiler``: per stage and sub-stage
    span of the join (``self_join.grid`` / ``.plan`` / ``.kernel`` /
    ``.emit``; ``self_join.plan.run_plan`` holds the run plans the l2
    run-loop launches are given and do not read) its host time and the
    device time of the kernels it launched, B1's device time by name, device
    time by kernel name, and the device's busy share of the wall time.
    Reports null device figures when the profiler records no device
    activity."""
    import repro_torch
    pts = syn(MAIN_POINTS, MAIN_DIMS)
    prof = profiled_join(
        lambda: repro_torch.self_join(pts, MAIN_EPS, device=DEVICE))
    check("self_join.plan.run_plan" in prof["stages"], "the profiled join "
          "built no run plan")
    emit("profile", points=MAIN_POINTS, **prof)


# the join's stage spans, which every profiled join enters, and the
# sub-stage spans inside them, which some joins enter
STAGE_SPANS = {"self_join.grid", "self_join.plan", "self_join.kernel",
               "self_join.emit"}
SUB_STAGE_SPANS = {"self_join.plan.tables", "self_join.plan.launch",
                   "self_join.plan.run_plan", "self_join.emit.sort"}


def profiled_join(join, kernel: str = "fused_join_kernel",
                  spans=("self_join.",)):
    """``join()`` once to warm up, then once under ``torch.profiler``: the
    stage spans' host and device ms (the spans named with a prefix of
    ``spans``; the slab join adds ``slab_join.``), the device time of the
    kernels whose name holds ``kernel`` (B1's by default), device time by
    kernel name and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    join()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        join()
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
              if e.key.startswith(spans)
              and e.device_type == torch.autograd.DeviceType.CPU}
    entered = {k for k in stages if k.startswith("self_join.")}
    check(STAGE_SPANS <= entered <= STAGE_SPANS | SUB_STAGE_SPANS,
          f"profiled join entered the stage spans {sorted(stages)}")
    # device-side entries only (kernels, copies, fills): the CPU ops that
    # launched them carry the same device time, the spans' device-side
    # copies (the root ``self_join``'s and the ``host_sync`` spans' too)
    # cover other entries, and the profiler's own activity buffers are not
    # the join's work
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and device_us(e) > 0
              and not e.key.startswith(("Activity Buffer", "self_join",
                                        "host_sync", *spans))]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    ours = [e for e in events if kernel in e.key]
    ours_ms = sum(device_us(e) for e in ours) / 1e3 if ours else None
    top = sorted(events, key=device_us, reverse=True)[:12]
    return dict(
        wall_ms=wall_ms, stages=stages, kernel=kernel,
        kernel_device_ms=ours_ms, kernel_calls=sum(e.count for e in ours),
        kernel_in_kernel_span=(
            ours_ms is not None
            and stages["self_join.kernel"]["device_ms"] >= ours_ms),
        device_busy_ms=busy_ms if events else None,
        device_busy_share=busy_ms / wall_ms if events else None,
        top_device_ms={e.key[:80]: device_us(e) / 1e3 for e in top},
        note="wall and host times include the profiler's own cost")


def b2_counts(q_gpu, pts_gpu, eps: float):
    """Per-query neighbour counts by B2 over all points, 256 query rows a
    launch (a 256 x N int8 plane)."""
    from repro_torch.kernels import distance_tile as dt
    out = [dt.distance_tile_hits(q_gpu[r0:r0 + 256], pts_gpu, eps)
           .sum(dim=1, dtype=torch.int32)
           for r0 in range(0, q_gpu.shape[0], 256)]
    return torch.cat(out)


def query_band(q_gpu, pts_gpu, rows, eps: float) -> int:
    """How many of the query rows ``rows`` have a point whose direct d2
    lies within the expanded form's band of eps^2 (``band_points`` for
    external queries)."""
    eps2 = float(eps) ** 2
    sq = (pts_gpu * pts_gpu).sum(dim=1)
    found = 0
    for chunk in range(0, rows.shape[0], 64):
        q = q_gpu[rows[chunk:chunk + 64]]
        d2 = torch.zeros((q.shape[0], pts_gpu.shape[0]), dtype=torch.float64,
                         device=pts_gpu.device)
        for k in range(pts_gpu.shape[1]):
            t = q[:, k][:, None] - pts_gpu[:, k][None, :]
            d2 = d2 + t * t
        band = ((q * q).sum(dim=1)[:, None] + sq[None, :]) * BAND_SCALE
        found += int(((d2 - eps2).abs() <= band).any(dim=1).sum())
    return found


def counts_vs_b2(q, counts, pts_gpu, eps: float, where: str) -> int:
    """A request's counts against B2's row sums: the queries where they
    differ, all of which must have a point in the band."""
    q_gpu = torch.as_tensor(q).to(DEVICE)
    want = b2_counts(q_gpu, pts_gpu, eps)
    differ = torch.nonzero(want != torch.as_tensor(counts).to(DEVICE))
    differ = differ.flatten()
    if differ.numel():
        explained = query_band(q_gpu, pts_gpu, differ, eps)
        check(explained == differ.numel(),
              f"{where}: {differ.numel() - explained} queries' counts differ "
              f"from B2's with no point in the band")
    return int(differ.numel())


def direct_neighbours(q, pts_gpu, eps: float, rows):
    """Sorted neighbour ids of the query rows ``rows`` by a direct
    evaluation in the kernel's lane order."""
    from repro_torch.core import metric
    eps2 = metric.device_refine_scalar("l2", eps, pts_gpu.dtype, DEVICE)
    qg = torch.as_tensor(q[rows]).to(DEVICE)
    d2 = torch.zeros((len(rows), pts_gpu.shape[0]), dtype=pts_gpu.dtype,
                     device=DEVICE)
    for k in range(pts_gpu.shape[1]):
        t = qg[:, k][:, None] - pts_gpu[:, k][None, :]
        d2 = d2 + t * t
    hit = d2 <= eps2
    return [torch.nonzero(hit[i]).flatten().cpu().numpy().astype(np.int32)
            for i in range(len(rows))]


def check_sampled_pairs(q, res, pts_gpu, eps: float, n: int, where: str):
    """The sorted pair ids of ``n`` sampled queries equal a direct
    evaluation on the card."""
    rows = np.random.default_rng(0).choice(q.shape[0], n, replace=False)
    for r, want in zip(rows, direct_neighbours(q, pts_gpu, eps, rows)):
        lo = np.searchsorted(res.pairs[:, 0], r)
        hi = np.searchsorted(res.pairs[:, 0], r, side="right")
        check(np.array_equal(res.pairs[lo:hi, 1], want),
              f"{where}: neighbours of query {r} differ from the direct "
              f"evaluation ({hi - lo} vs {want.size})")


def same_answer(a, b, where: str, perm=None) -> None:
    """Equal counts and sorted pairs; ``perm`` maps b's point ids to a's
    (an index rebuilt over permuted points numbers them anew)."""
    check(np.array_equal(a.counts, b.counts), f"{where}: counts differ")
    if a.pairs is None:
        return
    pb = b.pairs
    if perm is not None:
        pb = pb.copy()
        pb[:, 1] = perm[pb[:, 1]]
        pb = pb[np.lexsort((pb[:, 1], pb[:, 0]))]
    check(np.array_equal(a.pairs, pb), f"{where}: pairs differ")


def serve_requests(n_requests: int, rng):
    """``n_requests`` of SERVE_BATCH queries uniform in [-0.5, 100.5]^2,
    64 rows of each repeating earlier rows."""
    out = []
    for _ in range(n_requests):
        q = rng.uniform(-0.5, 100.5, (SERVE_BATCH, MAIN_DIMS))
        rows = rng.choice(np.arange(64, SERVE_BATCH), 64, replace=False)
        q[rows] = q[rng.integers(0, 64, 64)]
        out.append(q)
    return out


def profile_requests(svc, requests):
    """Requests under torch.profiler: host and device ms per query-join
    stage span, B1's device time by name, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in requests:
            svc.prepared.join(q)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    stages = {e.key: dict(calls=e.count, host_ms=e.cpu_time_total / 1e3,
                          device_ms=(getattr(e, "device_time_total", 0)
                                     or 0) / 1e3)
              for e in averages
              if e.key.startswith("query_join.")
              and e.device_type == torch.autograd.DeviceType.CPU}
    check(set(stages) == {"query_join.plan", "query_join.kernel",
                          "query_join.wait", "query_join.emit"},
          f"profiled requests entered the spans {sorted(stages)}")
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and device_us(e) > 0
              and not e.key.startswith(("Activity Buffer", "query_join."))]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    b1 = [e for e in events if "fused_join_kernel" in e.key]
    top = sorted(events, key=device_us, reverse=True)[:10]
    return dict(requests=len(requests), wall_ms=wall_ms, stages=stages,
                b1_device_ms=sum(device_us(e) for e in b1) / 1e3,
                device_busy_ms=busy_ms if events else None,
                device_busy_share=busy_ms / wall_ms if events else None,
                top_device_ms={e.key[:80]: device_us(e) / 1e3 for e in top})


def lattice_check():
    """Queries on and between the points of a 0.1-spaced lattice at eps 0.3,
    many on cell boundaries: the join on the card equals a direct
    evaluation of every query. A merged lane or sort key one cell off the
    descriptors (a reciprocal multiply in place of the true division by eps)
    would drop neighbours here."""
    import repro_torch
    g = np.arange(60) * 0.1
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    q = np.concatenate([pts[::3], pts[::7] + 0.05, pts[:50] - 0.3])
    pts_gpu = torch.as_tensor(pts).to(DEVICE)
    want = direct_neighbours(q, pts_gpu, 0.3, np.arange(q.shape[0]))
    for merged in (True, False):
        res = repro_torch.epsilon_join(q, pts, 0.3, device=DEVICE,
                                       merge_last_dim=merged)
        check(np.array_equal(res.counts, [w.size for w in want]),
              f"lattice merged={merged}: counts differ from the direct "
              f"evaluation")
        got = np.concatenate([np.full(w.size, i) for i, w in
                              enumerate(want)]).astype(np.int32)
        check(np.array_equal(res.pairs[:, 0], got) and np.array_equal(
            res.pairs[:, 1], np.concatenate(want)),
            f"lattice merged={merged}: pairs differ")
    return dict(points=len(pts), queries=len(q), eps=0.3,
                pairs=int(res.pairs.shape[0]))


def phase_serve():
    from repro_torch.kernels import fused_join as fj
    from repro_torch.launch import loadgen, serve
    t_phase = time.perf_counter()
    rng = np.random.default_rng(21)
    pts, eps = syn(MAIN_POINTS, MAIN_DIMS), MAIN_EPS
    requests = serve_requests(SERVE_REQUESTS, rng)
    skew_pts = expo(SKEW_POINTS, 3)
    skew_requests = np.split(expo(SKEW_REQUESTS * SERVE_BATCH, 3, seed=7),
                             SKEW_REQUESTS)
    # every service is prepared before any marks steady: the watchdog's
    # counters are process-wide
    t0 = time.perf_counter()
    svc = serve.JoinService(pts, eps, return_pairs=True, device=DEVICE)
    sync()
    build_s = time.perf_counter() - t0
    counts_svc = serve.JoinService(pts, eps, index=svc.index)
    bat = serve.BatchingJoinService(pts, eps, index=svc.index,
                                    return_pairs=True, max_batch=4096)
    skew = serve.JoinService(skew_pts, SKEW_EPS, return_pairs=True,
                             device=DEVICE)
    check(svc.prepared.merged and svc.prepared.n_offsets == 3
          and svc.prepared.run_loop, "index A does not serve the merged "
          "3-offset sweep through the run loop")
    check(skew.prepared.bucketed, "index B is not bucketed")
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # warmup() marks steady
        for s_ in (svc, counts_svc, skew):
            s_.warmup(SERVE_BATCH)
        bat.warmup()
    warm_s = time.perf_counter() - t0

    # the main serve path, counted alone
    expected = sum(len(svc.prepared.launch_inputs(q)[1]) for q in requests)
    sync()
    fj.KERNEL_LAUNCHES = fj.RUN_LOOP_LAUNCHES = fj.EXTERNAL_LAUNCHES = 0
    results = [svc.query(q) for q in requests]
    launches = (fj.KERNEL_LAUNCHES, fj.RUN_LOOP_LAUNCHES,
                fj.EXTERNAL_LAUNCHES)
    check(launches == (expected,) * 3, f"the serve path launched B1 "
          f"(total, run loop, external) {launches} times, planned "
          f"{expected}")
    p50, p99 = svc.percentiles()
    rps = svc.requests_per_sec()
    svc.assert_no_retrace()

    pts_gpu = torch.as_tensor(pts).to(DEVICE)
    band_a = 0
    for q, res in zip(requests, results):
        check(res.pairs.shape[0] == int(res.counts.sum()),
              "index A: pairs and counts disagree")
        band_a += counts_vs_b2(q, res.counts, pts_gpu, eps, "index A")
    check_sampled_pairs(requests[0], results[0], pts_gpu, eps, 32,
                        "index A")
    for q, res in zip(requests, results):
        check(np.array_equal(counts_svc.query(q).counts, res.counts),
              "index A: the counts-only service differs")
    c50, c99 = counts_svc.percentiles()

    # B1 (b) on one request's launches, the variants in turns
    ext = external_launches(svc.prepared, requests[0])
    err = compare_external(ext)
    check(err == 0, f"serve: B1 (b) differs from plain by {err}")
    rounds = [{key: timed_launches(ext, method) for key, method in
               (("kernel", "kernel"), ("plain", "reference"))}
              for _ in range(3)]
    b1b = {key: statistics.median(r[key] for r in rounds)
           for key in ("kernel", "plain")}
    b1b_device = {key: profiled_device_ms(lambda m=method: [
        fj.fused_join_hits(*p["args"], method=m, **p["kw"]) for p in ext])
        for key, method in (("kernel", "kernel"), ("plain", "reference"))}
    check(min(b1b_device.values()) > 0, "the profiler recorded no device "
          "time for B1 (b) or its plain version")
    # the kernel alone, by name (the above adds each launch's eps^2 kernel)
    b1b_named = profiled_device_ms(lambda: [
        fj.fused_join_hits(*p["args"], method="kernel", **p["kw"])
        for p in ext], reps=20, kernel="fused_join_kernel")
    b1b_bound = kernel_bound(ext)
    prof = profile_requests(svc, requests[:8])

    # index B: the capacity classes
    n_classes = len(skew.prepared.launch_inputs(skew_requests[0])[1])
    check(n_classes > 1, f"index B launched {n_classes} class(es)")
    ext_b = external_launches(skew.prepared, skew_requests[0])
    err_b = compare_external(ext_b)
    check(err_b == 0, f"serve: B1 (b) on index B differs from plain by "
          f"{err_b}")
    b1b_b_named = profiled_device_ms(lambda: [
        fj.fused_join_hits(*p["args"], method="kernel", **p["kw"])
        for p in ext_b], reps=20, kernel="fused_join_kernel")
    skew_results = [skew.query(q) for q in skew_requests]
    s50, s99 = skew.percentiles()
    skew_gpu = torch.as_tensor(skew_pts).to(DEVICE)
    band_b = 0
    for q, res in zip(skew_requests, skew_results):
        check(res.pairs.shape[0] == int(res.counts.sum()),
              "index B: pairs and counts disagree")
        band_b += counts_vs_b2(q, res.counts, skew_gpu, SKEW_EPS, "index B")
    skew.assert_no_retrace()
    del skew_gpu

    # batching on index A: every ticket equals the request served alone
    sizes = rng.integers(1, 513, 256)
    reqs = [rng.uniform(-0.5, 100.5, (int(n), MAIN_DIMS)) for n in sizes]
    tickets = [bat.submit(q) for q in reqs]
    t0 = time.perf_counter()
    bat.pump()
    bat.drain()
    bat_wall = time.perf_counter() - t0
    for q, t in zip(reqs, tickets):
        same_answer(svc.prepared.join(q), t.result(), "batching")
    coalesce, bat_launches = bat.coalesce_factor, bat.n_launches
    stream = loadgen.make_request_stream(
        100, loadgen.RequestMix(sizes=(32, 64, 256), lo=-0.5, hi=100.5),
        MAIN_DIMS, seed=3)
    closed = loadgen.run_closed_loop(bat, stream, concurrency=8)
    for s_ in (bat, counts_svc):
        s_.assert_no_retrace()

    # reindex halfway through 16 requests (last: it moves the counters of
    # every other service)
    perm = rng.permutation(MAIN_POINTS)
    for k in range(REINDEX_REQUESTS):
        if k == REINDEX_REQUESTS // 2:
            svc.reindex(pts[perm], wait=True)
        got = svc.query(requests[k])
        same_answer(results[k], got, f"reindex request {k}",
                    perm if k >= REINDEX_REQUESTS // 2 else None)
    same_answer(results[0], svc.query(requests[0]), "reindex again", perm)
    svc.assert_no_retrace()
    lattice = lattice_check()
    del pts_gpu
    emit("serve", points=MAIN_POINTS, eps=eps, dtype="float64",
         requests=SERVE_REQUESTS, request_queries=SERVE_BATCH,
         build_s=build_s, warm_s=warm_s, c=svc.prepared.c,
         classes=list(svc.prepared.classes), offsets=svc.prepared.n_offsets,
         launches=launches[0], p50_ms=p50, p99_ms=p99, requests_per_s=rps,
         neighbors_found=int(sum(r.total for r in results)),
         b2_band_queries=band_a, sampled_queries_checked=32,
         counts_only_p50_ms=c50, counts_only_p99_ms=c99,
         b1b_ms=b1b["kernel"], b1b_plain_ms=b1b["plain"],
         b1b_device_ms=b1b_device["kernel"], b1b_named_ms=b1b_named,
         b1b_plain_device_ms=b1b_device["plain"],
         b1b_bound_ms=b1b_bound[0], b1b_bound_by=b1b_bound[1],
         b1b_bound_bytes=b1b_bound[2], b1b_launches_timed=len(ext),
         b1b_timed_rounds_ms=rounds, profile=prof,
         skew=dict(points=SKEW_POINTS, eps=SKEW_EPS,
                   requests=SKEW_REQUESTS, c=skew.prepared.c,
                   classes_launched_first=n_classes,
                   b1b_named_ms=b1b_b_named, b1b_launches_timed=len(ext_b),
                   p50_ms=s50, p99_ms=s99,
                   neighbors_found=int(sum(r.total for r in skew_results)),
                   b2_band_queries=band_b),
         batching=dict(requests=len(reqs), max_batch=bat.max_batch,
                       launches=bat_launches, coalesce_factor=coalesce,
                       wall_s=bat_wall, equal_to_solo=True,
                       closed_loop=closed.to_dict()),
         reindex=dict(svc.reindex_timings, swaps=svc.swaps,
                      answers_equal=True),
         lattice=lattice, phase_s=time.perf_counter() - t_phase)
    return dict(launches=launches[2], ms=b1b_device["kernel"],
                named_ms=b1b_named, index_b_named_ms=b1b_b_named,
                enqueue_ms=b1b["kernel"], plain_ms=b1b["plain"],
                plain_device_ms=b1b_device["plain"], bound_ms=b1b_bound[0],
                bound_by=b1b_bound[1], worst=max(err, err_b))


# --- metrics: the cosine and Jaccard joins ---------------------------------

def metric_workloads():
    """The bench's metric workloads (benchmarks/bench_selfjoin.py::
    metric_workloads at its defaults): raw Gaussian 4-D embeddings with
    planted scaled duplicates at minimum cosine 0.9, then ~10 %-dense token
    sets over 64 tokens at minimum Jaccard 0.5, from one seeded generator."""
    rng = np.random.default_rng(0)
    n, d = 20_000, 4
    emb = rng.normal(size=(n, d))
    emb[: n // 50] = emb[n // 2: n // 2 + n // 50] * 2.5   # scaled dups
    vocab = 64
    sets = [tuple(np.flatnonzero(rng.random(vocab) < 0.1))
            for _ in range(n)]
    return {"cosine-4d": ("cosine", emb, 0.9),
            "jaccard-v64": ("jaccard", sets, 0.5)}


def cosine_data(n: int, seed: int = 0):
    """Raw Gaussian embeddings, the first 2 % scaled copies (x2.5) of rows
    from the middle: cosine duplicates that an L2 join misses."""
    emb = np.random.default_rng(seed).normal(size=(n, COSINE_DIMS))
    emb[: n // 50] = emb[n // 2: n // 2 + n // 50] * 2.5
    return emb


def jaccard_data(n: int, vocab: int, seed: int = 1):
    """(N, vocab) uint8 token sets of 16-256 tokens; 5 % of them are near
    duplicates of a set that is not one, with 5 % of its tokens swapped
    (Jaccard at least (s - k) / (s + k) >= 0.88 with k = round(0.05 s)).
    Returns (matrix, duplicate rows, their sources)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(16, 257, n)
    mat = np.zeros((n, vocab), np.uint8)
    for i, size in enumerate(sizes):
        mat[i, rng.choice(vocab, size, replace=False)] = 1
    dup = rng.choice(n, n // 20, replace=False)
    others = np.setdiff1d(np.arange(n), dup)
    src = others[rng.integers(0, others.size, dup.size)]
    for i, j in zip(dup, src):
        row = mat[j].copy()
        ones, zeros = np.flatnonzero(row), np.flatnonzero(row == 0)
        k = max(1, round(0.05 * ones.size))
        row[rng.choice(ones, k, replace=False)] = 0
        row[rng.choice(zeros, k, replace=False)] = 1
        mat[i] = row
    return mat, dup, src


def jaccard_launches(canon, index, *, unicomp=True, run_loop=False):
    """The drivers' launch schedule of a Jaccard self-join over its size
    grid, in the form of ``prepared_launches`` (``kw`` carries the metric,
    the feature lanes and, as the drivers pass them, the packed words)."""
    from repro_torch.core import grid, selfjoin as sj
    from repro_torch.kernels import fused_join as fj
    feats = sj._metric_feats_sorted(canon, index)
    deltas, is_zero = sj._offset_tables(index, unicomp)
    tabs = (grid.cell_window_tables(index, deltas, merged=False,
                                    tag=unicomp) if run_loop else None)
    launches, points_pad, _ = sj._fused_launches(index, merged=False,
                                                 feats=feats)
    # a checkout from before the packed refine has no pack_words; the
    # --kernel-times mode may time one
    pack = getattr(fj, "pack_words", None)
    words = ({} if pack is None else
             dict(words=pack(points_pad, 1, canon.n_feat)))
    out = []
    for launch in launches:
        ws, wc, _, qb, qpos = sj._launch_prep(index, points_pad, deltas,
                                              launch, merged=False,
                                              tables=tabs)
        plan = (sj._launch_run_plan(index, qpos, tile=launch[5])
                if run_loop else None)
        out.append(dict(launch=launch, plan=plan,
                        args=(points_pad, qb, ws, wc, is_zero, qpos,
                              canon.eps),
                        kw=dict(c=launch[4], tq=launch[5], n_real=1,
                                unicomp=unicomp, merged=False,
                                metric="jaccard", n_feat=canon.n_feat,
                                **words)))
    return out


def sliced_vs_plain(args, kw, run_ord=None, starts=None,
                    rows: int = PLAIN_ROWS) -> tuple[int, int]:
    """One launch of the kernel against its plain version, the plain one
    run on tile-aligned slices of ``rows`` query rows (its temporaries grow
    with rows x window slots): every slice, or those starting at
    ``starts``. The rows of a tile depend on nothing outside it, so a
    slice's plain result is the launch's. Returns (max |kernel - plain|
    over hits, counts and slot_base, rows compared)."""
    from repro_torch.kernels import fused_join as fj
    points_pad, qb, ws, wc, is_zero, qpos, eps = args
    loop = {} if run_ord is None else dict(run_ord=run_ord, run_loop=True)
    got = fj.fused_join_hits(*args, method="kernel", **loop, **kw)
    qp = qb.shape[0]
    worst = compared = 0
    for a in (range(0, qp, rows) if starts is None else starts):
        b = min(a + rows, qp)
        want = fj.fused_join_hits(points_pad, qb[a:b], ws[:, a:b],
                                  wc[:, a:b], is_zero, qpos[a:b], eps,
                                  method="reference", **kw)
        worst = max(worst, max_abs_diff(
            (got[0][:, a:b], got[1][a:b], got[2][a:b]), want))
        compared += b - a
    return worst, compared


def jaccard_vs_plain(canon, index) -> tuple[int, int]:
    """B1 (e) against its plain version on every launch of a Jaccard
    self-join over ``index``, every row in slices: the UNICOMP and self
    masks, row and run loop, hits plane on and off."""
    worst = compared = 0
    for unicomp in (True, False):
        for run_loop in (False, True):
            for p in jaccard_launches(canon, index, unicomp=unicomp,
                                     run_loop=run_loop):
                for keep_hits in (True, False):
                    err, _ = sliced_vs_plain(
                        p["args"], dict(p["kw"], keep_hits=keep_hits),
                        p["plan"].run_ord if run_loop else None)
                    check(err == 0, f"B1 (e) unicomp={unicomp} run_loop="
                          f"{run_loop} keep_hits={keep_hits}: kernel "
                          f"differs from the plain version by {err}")
                    worst = max(worst, err)
                    compared += 1
    return worst, compared


def jaccard_external_vs_plain(pj, queries) -> tuple[int, int]:
    """B1 (e) with the external mask: every launch of a request through the
    prepared Jaccard index ``pj``, hits plane on and off, every row."""
    worst = compared = 0
    for keep_hits in (True, False):
        _, launches = pj.launch_inputs(queries, keep_hits=keep_hits)
        for _, _, args, kw in launches:
            plain = {k: v for k, v in kw.items()
                     if k not in ("run_ord", "run_loop")}
            err, _ = sliced_vs_plain(args, dict(plain, words=pj.words),
                                     kw.get("run_ord")
                                     if kw.get("run_loop") else None)
            check(err == 0, f"B1 (e) external run_loop={pj.run_loop} "
                  f"keep_hits={keep_hits}: kernel differs from the plain "
                  f"version by {err}")
            worst = max(worst, err)
            compared += 1
    return worst, compared


def jaccard_direct(words, sizes, q_words, q_sizes, t: float, self_rows=None):
    """A direct on-card evaluation of the Jaccard predicate of queries
    against all sets, with the kernel's arithmetic and no grid: (Q, N)
    bool; ``self_rows`` masks each query's own row."""
    from repro_torch.core import metric
    inter = torch.zeros((q_words.shape[0], words.shape[0]),
                        dtype=torch.int32, device=DEVICE)
    for k in range(words.shape[1]):
        inter += metric.popcount16(q_words[:, k][:, None] & words[:, k])
    inter = inter.to(torch.float32)
    union = (q_sizes[:, None] + sizes[None, :]) - inter
    tt = metric.device_refine_scalar("jaccard", t, torch.float32, DEVICE)
    hit = (union > 0) & (inter >= tt * union)
    if self_rows is not None:
        hit[torch.arange(len(self_rows), device=DEVICE), self_rows] = False
    return hit


def canon_on_card(canon):
    """A Jaccard canonical form's words (int32) and sizes on the card."""
    return (torch.as_tensor(canon.feats).to(DEVICE).to(torch.int32),
            torch.as_tensor(canon.geom[:, 0]).to(DEVICE))


def check_jaccard_pairs(pairs, canon, n: int, where: str):
    """Symmetric, no self pair, and the sorted neighbour lists of ``n``
    sampled sets equal a direct evaluation."""
    from repro_torch.core.selfjoin import sort_pairs
    npts = canon.geom.shape[0]
    check(bool((pairs[:, 0] != pairs[:, 1]).all()), f"{where}: self pair")
    check(torch.equal(sort_pairs(pairs.flip(1), npts), pairs),
          f"{where}: pair set is not symmetric")
    words, sizes = canon_on_card(canon)
    rows = torch.as_tensor(np.random.default_rng(0).choice(
        npts, n, replace=False)).to(DEVICE)
    first = pairs[:, 0].contiguous()
    lo = torch.searchsorted(first, rows.to(torch.int32))
    hi = torch.searchsorted(first, rows.to(torch.int32), right=True)
    for a in range(0, n, 16):
        q = rows[a:a + 16]
        hit = jaccard_direct(words, sizes, words[q], sizes[q], canon.eps, q)
        for r in range(q.shape[0]):
            want = torch.nonzero(hit[r]).flatten().to(torch.int32)
            got = pairs[lo[a + r]:hi[a + r], 1]
            check(torch.equal(got, want), f"{where}: neighbours of set "
                  f"{int(q[r])} differ from the direct evaluation "
                  f"({got.numel()} vs {want.numel()})")


def planted_found(pairs, first, second, npts: int) -> bool:
    """Every planted pair (first[i], second[i]) is in the sorted pairs."""
    keys = pairs[:, 0].long() * npts + pairs[:, 1].long()
    want = (torch.as_tensor(first).long() * npts
            + torch.as_tensor(second).long()).to(DEVICE)
    return bool(torch.isin(want, keys).all())


def counted_join(join, expected: int, run_loop: bool, jaccard: bool):
    """One run of ``join()`` with B1's and the emit's counts set to 0 just
    before and read just after: every scheduled launch went through the
    kernel (the run loop and the Jaccard variant where they apply) and
    through the emit kernel."""
    from repro_torch.kernels import emit_pairs as ep
    from repro_torch.kernels import fused_join as fj
    fj.KERNEL_LAUNCHES = fj.RUN_LOOP_LAUNCHES = fj.JACCARD_LAUNCHES = 0
    ep.KERNEL_LAUNCHES = 0
    join()
    sync()
    launches = (fj.KERNEL_LAUNCHES, fj.RUN_LOOP_LAUNCHES,
                fj.JACCARD_LAUNCHES, ep.KERNEL_LAUNCHES)
    check(expected > 0 and launches == (expected, expected * run_loop,
                                         expected * jaccard, expected),
          f"the join launched B1 (total, run loop, jaccard) and the emit "
          f"{launches} times, scheduled {expected}")
    return launches[0]


def timed_join(join, reps: int = 3):
    """(median s, runs, peak bytes, last result) of ``join()``, warmed up
    already, each run ending in a synchronize."""
    runs = []
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = join()
        sync()
        runs.append(time.perf_counter() - t0)
    return (statistics.median(runs), runs, torch.cuda.max_memory_allocated(),
            out)


def metric_bench_totals():
    """The bench's two metric workloads: totals against the recorded JAX
    ones, B1 (e) against its plain version on every launch of the
    jaccard-v64 join and of a request against it."""
    import repro_torch
    from repro_torch.core import metric, query_join as qj, selfjoin as sj
    out = {}
    worst = compared = 0
    for name, (m, data, eps) in metric_workloads().items():
        want = METRIC_TOTALS[name]
        t0 = time.perf_counter()
        stats = repro_torch.self_join_count(data, eps, metric=m,
                                            device=DEVICE)
        run = repro_torch.self_join_count(data, eps, metric=m,
                                          route="dense-run", device=DEVICE)
        pairs = repro_torch.self_join(data, eps, metric=m, device=DEVICE)
        sync()
        check(stats.total_pairs == run.total_pairs == pairs.shape[0] == want,
              f"{name}: count {stats.total_pairs}, dense-run "
              f"{run.total_pairs}, join {pairs.shape[0]}, recorded {want}")
        out[name] = dict(total_pairs=want, seconds=time.perf_counter() - t0,
                         offsets=stats.offsets,
                         candidates_checked=stats.candidates_checked)
        if m == "jaccard":
            canon = metric.canonicalize(data, eps, metric=m)
            index = sj._metric_grid(canon, DEVICE)
            worst, compared = jaccard_vs_plain(canon, index)
            oov = [tuple(np.flatnonzero(r) + 48) for r in
                   np.random.default_rng(5).random((512, 24)) < 0.3]
            queries = list(data[:EXTERNAL_QUERIES]) + oov
            for run_loop in (False, True):
                pj = qj.prepare(index, run_loop=run_loop, canon=canon)
                w, n = jaccard_external_vs_plain(pj, queries)
                worst, compared = max(worst, w), compared + n
            out[name].update(b1e_launches_compared=compared,
                             b1e_max_abs_err=worst, cells=int(
                                 index.num_cells), c=int(index.max_per_cell))
    return out, worst


def metric_cosine_scale():
    """Cosine at 1,000,000 raw embeddings: the join through B1 on the unit
    rows, B3's per-point counts, the planted duplicates, and the plain L2
    join of the same unit rows beside it."""
    import repro_torch
    from repro_torch.core import metric, selfjoin as sj
    from repro_torch.kernels import distance_tile as dt
    from repro_torch.kernels import fused_join as fj
    emb = cosine_data(COSINE_POINTS)
    t0 = time.perf_counter()
    canon = metric.canonicalize(emb, COSINE_T, metric="cosine")
    canon_s = time.perf_counter() - t0
    index = sj._metric_grid(canon, DEVICE)
    run_loop = sj._join_run_loop(index)
    expected = len(sj._fused_launches(
        index, merged=sj._resolve_merge(index, None))[0])
    cells = int(index.num_cells)
    del index

    def join():
        return repro_torch.self_join(emb, COSINE_T, metric="cosine",
                                     device=DEVICE)

    join()                                                  # warm-up
    launches = counted_join(join, expected, run_loop, False)
    e2e, runs, peak, pairs = timed_join(join)
    npairs = int(pairs.shape[0])
    stats = repro_torch.self_join_count(emb, COSINE_T, metric="cosine",
                                        device=DEVICE)
    check(stats.total_pairs == npairs, f"cosine: count {stats.total_pairs}"
          f" != emitted {npairs}")
    n = COSINE_POINTS // 50
    check(planted_found(pairs, np.arange(n), COSINE_POINTS // 2
                        + np.arange(n), COSINE_POINTS),
          "cosine: a planted scaled duplicate was not found")
    unit = torch.as_tensor(canon.geom).to(DEVICE)
    dt.COUNTS_LAUNCHES = 0
    t0 = time.perf_counter()
    n_differ, _ = oracle_counts(unit, pairs[:, 0], canon.eps_geom, "cosine")
    sync()
    oracle_s = time.perf_counter() - t0
    check(dt.COUNTS_LAUNCHES == 1, "the cosine oracle did not launch B3 "
          "once")
    check_pairs(pairs, unit, canon.eps_geom, COSINE_POINTS)
    # the plain L2 join of the same unit rows: the same pair set
    l2_s, l2_runs, l2_peak, l2 = timed_join(
        lambda: repro_torch.self_join(canon.geom, canon.eps_geom,
                                      device=DEVICE))
    check(torch.equal(l2, pairs), "cosine: pairs differ from the L2 join "
          "of the unit rows")
    del l2, unit
    # the same join from the ready canonical form: the join without its
    # host canonicalization, measured as the Jaccard join is
    ready_s, ready_runs, _, ready = timed_join(
        lambda: repro_torch.self_join(canon, None, device=DEVICE))
    check(torch.equal(ready, pairs), "cosine: pairs from the canonical "
          "form differ from those of the raw embeddings")
    del ready
    return dict(points=COSINE_POINTS, dims=COSINE_DIMS, t=COSINE_T,
                chord=canon.eps_geom, cells=cells, run_loop=run_loop,
                launches=launches, total_pairs=npairs,
                neighbours_per_point=npairs / COSINE_POINTS,
                planted_pairs=n, planted_found=True, canonicalize_s=canon_s,
                join_s=e2e, join_runs_s=runs, join_peak_bytes=peak,
                join_canonical_s=ready_s, join_canonical_runs_s=ready_runs,
                l2_join_s=l2_s, l2_join_runs_s=l2_runs,
                l2_join_peak_bytes=l2_peak, l2_pairs_equal=True,
                oracle_differing_points=n_differ, oracle_s=oracle_s,
                b3_launches=dt.COUNTS_LAUNCHES,
                sampled_points_checked=SAMPLED_QUERIES), emb, canon


def metric_jaccard_scale():
    """Jaccard at 100,000 token sets over 1,024 tokens: the join through
    B1 (e)'s run loop, the planted near duplicates, sampled neighbour lists
    against a direct evaluation, B1 (e)'s time beside its plain version
    (on a sample of every launch) and its bound."""
    import repro_torch
    from repro_torch.core import metric, selfjoin as sj
    from repro_torch.kernels import fused_join as fj
    t0 = time.perf_counter()
    mat, dup, src = jaccard_data(JACCARD_POINTS, JACCARD_VOCAB)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    canon = metric.canonicalize(mat, JACCARD_T, metric="jaccard",
                                vocab=JACCARD_VOCAB)
    canon_s = time.perf_counter() - t0
    index = sj._metric_grid(canon, DEVICE)
    check(sj._join_run_loop(index), "the Jaccard join does not take the "
          "run loop")
    prepared = jaccard_launches(canon, index, run_loop=True)

    def join():
        return repro_torch.self_join(canon, None, device=DEVICE)

    join()                                                  # warm-up
    launches = counted_join(join, len(prepared), True, True)
    e2e, runs, peak, pairs = timed_join(join)
    npairs = int(pairs.shape[0])
    for route in ("dense", "dense-run"):
        stats = repro_torch.self_join_count(canon, None, route=route,
                                            device=DEVICE)
        check(stats.total_pairs == npairs, f"jaccard {route}: count "
              f"{stats.total_pairs} != emitted {npairs}")
    check(planted_found(pairs, dup, src, JACCARD_POINTS),
          "jaccard: a planted near duplicate was not found")
    check_jaccard_pairs(pairs, canon, SAMPLED_QUERIES, "jaccard")
    # the same join from the raw sets, as a user calls it: canonicalization
    # (host numpy) included, measured as the cosine join is
    raw_s, raw_runs, raw_peak, raw = timed_join(
        lambda: repro_torch.self_join(mat, JACCARD_T, metric="jaccard",
                                      vocab=JACCARD_VOCAB, device=DEVICE))
    check(torch.equal(raw, pairs), "jaccard: pairs from the raw sets differ "
          "from those of the canonical form")
    del raw
    # B1 (e): the join's launches back to back, and on a sample of each
    # launch (its first PLAIN_ROWS rows) the run loop, the row loop and the
    # plain version, in turns
    ms = timed_launches(prepared, "kernel", run_loop=True, reps=2)
    bound_ms, bound_by, nbytes, ops = kernel_bound(prepared)
    issue_ms = jaccard_issue_ms(prepared)
    head = slice(0, PLAIN_ROWS)
    sample = [dict(p, args=(p["args"][0], p["args"][1][head],
                            p["args"][2][:, head].contiguous(),
                            p["args"][3][:, head].contiguous(), p["args"][4],
                            p["args"][5][head], p["args"][6]),
                   plan=types.SimpleNamespace(
                       run_ord=p["plan"].run_ord[head]))
              for p in prepared]
    worst = 0
    for p in prepared:
        err, _ = sliced_vs_plain(p["args"], p["kw"], p["plan"].run_ord,
                                 starts=[0])
        check(err == 0, f"B1 (e) at scale differs from its plain version "
              f"by {err}")
        worst = max(worst, err)
    rounds = [{key: timed_launches(sample, method, run_loop, reps=1)
               for key, method, run_loop in (
                   ("run", "kernel", True), ("row", "kernel", False),
                   ("plain", "reference", False))} for _ in range(2)]
    timed = {k: statistics.median(r[k] for r in rounds)
             for k in ("run", "row", "plain")}
    sample_bound = kernel_bound(sample)
    prof = profiled_join(join)
    del pairs
    return dict(points=JACCARD_POINTS, vocab=JACCARD_VOCAB, t=JACCARD_T,
                n_feat=canon.n_feat, lanes=int(prepared[0]["args"][0]
                                              .shape[1]),
                eps_geom=canon.eps_geom, cells=int(index.num_cells),
                launches=launches,
                launch_caps=[p["kw"]["c"] for p in prepared],
                launch_rows=[p["args"][1].shape[0] for p in prepared],
                smem_bytes=fj.shared_bytes(
                    128, fj.packed_width(canon.n_feat), True),
                total_pairs=npairs, planted_pairs=int(dup.size),
                planted_found=True, data_s=data_s, canonicalize_s=canon_s,
                join_canonical_s=e2e, join_canonical_runs_s=runs,
                join_canonical_peak_bytes=peak, join_s=raw_s,
                join_runs_s=raw_runs, join_peak_bytes=raw_peak,
                sampled_sets_checked=SAMPLED_QUERIES,
                b1e_ms=ms, b1e_bound_ms=bound_ms, b1e_bound_by=bound_by,
                b1e_bound_bytes=nbytes, b1e_bound_ops=ops,
                b1e_issue_floor_ms=issue_ms,
                b1e_sample_rows=PLAIN_ROWS, b1e_sample_run_ms=timed["run"],
                b1e_sample_row_ms=timed["row"],
                b1e_sample_plain_ms=timed["plain"],
                b1e_sample_bound_ms=sample_bound[0],
                b1e_timed_rounds_ms=rounds, b1e_sample_max_abs_err=worst,
                profile=prof), canon, mat


def metric_services(emb, cos_canon, mat, jac_canon):
    """Both services per metric on the card, requests of 1,024 queries:
    cosine counts against B2's row sums on the unit rows, Jaccard counts
    against a direct evaluation, sampled pairs; one batching stream per
    metric against the solo answers; B1 (e) counted on the Jaccard path."""
    from repro_torch.core import metric
    from repro_torch.kernels import fused_join as fj
    from repro_torch.launch import serve
    rng = np.random.default_rng(31)
    out = {}
    for m, data, canon in (("cosine", emb, cos_canon),
                           ("jaccard", mat, jac_canon)):
        npts = canon.geom.shape[0]
        t0 = time.perf_counter()
        kw = dict(metric=m, device=DEVICE,
                  vocab=JACCARD_VOCAB if m == "jaccard" else None)
        svc = serve.JoinService(data, canon.eps, return_pairs=True, **kw)
        bat = serve.BatchingJoinService(data, canon.eps, return_pairs=True,
                                        max_batch=SERVE_BATCH, **kw)
        sync()
        build_s = time.perf_counter() - t0
        if m == "cosine":
            def make(k):
                near = emb[rng.integers(0, npts, k // 2)]
                near = near * rng.uniform(0.5, 3.0, (k // 2, 1)) + \
                    rng.normal(0, 0.005, near.shape)
                return np.concatenate([near, rng.normal(
                    size=(k - k // 2, COSINE_DIMS))])
        else:
            def make(k):
                rows = [np.flatnonzero(mat[i]) for i in
                        rng.integers(0, npts, k // 2)]
                near = [np.concatenate([r[1:], [JACCARD_VOCAB + 7]])
                        for r in rows]          # one token out of vocabulary
                rand = [rng.choice(JACCARD_VOCAB, int(s), replace=False)
                        for s in rng.integers(16, 257, k - k // 2)]
                return near + rand
        requests = [make(SERVE_BATCH) for _ in range(METRIC_REQUESTS)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # warmup() marks steady
            svc.warmup(SERVE_BATCH)
            bat.warmup()
        sync()
        fj.EXTERNAL_LAUNCHES = fj.JACCARD_LAUNCHES = 0
        results = [svc.query(q) for q in requests]
        launches = (fj.EXTERNAL_LAUNCHES, fj.JACCARD_LAUNCHES)
        check(launches[0] > 0 and launches[1] == (launches[0] if m ==
                                                  "jaccard" else 0),
              f"{m} service launched B1 (external, jaccard) {launches}")
        p50, p99 = svc.percentiles()
        svc.assert_no_retrace()
        band = 0
        if m == "cosine":
            unit = torch.as_tensor(canon.geom).to(DEVICE)
            for q, res in zip(requests, results):
                qu = metric.canonicalize_queries(canon, q)[0]
                band += counts_vs_b2(qu, res.counts, unit, canon.eps_geom,
                                     "cosine service")
            check_sampled_pairs(metric.canonicalize_queries(
                canon, requests[0])[0], results[0], unit, canon.eps_geom,
                32, "cosine service")
            del unit
        else:
            words, sizes = canon_on_card(canon)
            for q, res in zip(requests, results):
                qs, qw = metric.canonicalize_queries(canon, q)
                qw = torch.as_tensor(qw).to(DEVICE).to(torch.int32)
                qs = torch.as_tensor(qs[:, 0]).to(DEVICE)
                got = torch.as_tensor(res.counts).to(DEVICE)
                for a in range(0, len(q), 64):
                    hit = jaccard_direct(words, sizes, qw[a:a + 64],
                                         qs[a:a + 64], canon.eps)
                    check(torch.equal(hit.sum(dim=1, dtype=torch.int32),
                                      got[a:a + 64]),
                          "jaccard service: counts differ from the direct "
                          "evaluation")
                    if a == 0:
                        want = torch.nonzero(hit).to(torch.int32).cpu()
                        pr = torch.as_tensor(res.pairs)
                        check(torch.equal(pr[pr[:, 0] < 64], want),
                              "jaccard service: pairs differ from the "
                              "direct evaluation")
        sizes_b = rng.integers(1, 513, 24)
        stream = [make(int(k)) for k in sizes_b]
        tickets = [bat.submit(q) for q in stream]
        t0 = time.perf_counter()
        bat.pump()
        bat.drain()
        bat_wall = time.perf_counter() - t0
        for q, t in zip(stream, tickets):
            same_answer(svc.prepared.join(q), t.result(), f"{m} batching")
        bat.assert_no_retrace()
        out[m] = dict(points=npts, requests=METRIC_REQUESTS,
                      request_queries=SERVE_BATCH, build_s=build_s,
                      c=svc.prepared.c, classes=list(svc.prepared.classes),
                      offsets=svc.prepared.n_offsets,
                      merged=svc.prepared.merged, launches=launches[0],
                      p50_ms=p50, p99_ms=p99,
                      neighbors_found=int(sum(r.total for r in results)),
                      b2_band_queries=band if m == "cosine" else None,
                      batching=dict(requests=len(stream),
                                    launches=bat.n_launches,
                                    coalesce_factor=bat.coalesce_factor,
                                    wall_s=bat_wall, equal_to_solo=True))
        del svc, bat
    return out


def phase_metrics():
    import repro_torch
    t_phase = time.perf_counter()
    totals, worst = metric_bench_totals()
    emit("metrics", part="bench_totals", workloads=totals)
    cosine, emb, cos_canon = metric_cosine_scale()
    emit("metrics", part="cosine", **cosine)
    jaccard, jac_canon, mat = metric_jaccard_scale()
    emit("metrics", part="jaccard", **jaccard)
    cos_prof = profiled_join(lambda: repro_torch.self_join(
        emb, COSINE_T, metric="cosine", device=DEVICE))
    emit("metrics", part="cosine_profile", points=COSINE_POINTS,
         **cos_prof)
    services = metric_services(emb, cos_canon, mat, jac_canon)
    emit("metrics", part="services", **services,
         phase_s=time.perf_counter() - t_phase)
    return dict(launches=jaccard["launches"], ms=jaccard["b1e_ms"],
                sample_ms=jaccard["b1e_sample_run_ms"],
                plain_ms=jaccard["b1e_sample_plain_ms"],
                bound_ms=jaccard["b1e_bound_ms"],
                bound_by=jaccard["b1e_bound_by"],
                issue_ms=jaccard["b1e_issue_floor_ms"],
                worst=max(worst, jaccard["b1e_sample_max_abs_err"]),
                cosine_launches=cosine["launches"],
                external_launches=services["jaccard"]["launches"])


# --- half-precision points --------------------------------------------------

def as_half(pts, dtype):
    """``pts`` (float64 numpy) as a CPU tensor of the half ``dtype``: float16
    as numpy casts it (one rounding), bfloat16 as torch and ml_dtypes cast
    it (through float32)."""
    if dtype == torch.float16:
        return torch.from_numpy(np.asarray(pts).astype(np.float16))
    return torch.from_numpy(np.asarray(pts)).to(dtype)


def merged_lane_ok(index) -> bool:
    """Whether the merged sweep's lane holds ``index``'s last-dimension cell
    coordinates exactly (``grid.check_merged_lane`` refuses it otherwise)."""
    from repro_torch.core import grid
    limit = grid.MERGED_LANE_LIMIT.get(index.points_sorted.dtype)
    return limit is None or int(grid.host_dims(index)[-1]) - 1 <= limit


def half_band_points(pts_gpu, ids, eps: float) -> int:
    """How many of the points ``ids`` have a neighbour whose exact d^2 lies
    within the half dtype's band of eps^2 (rounded to the dtype, squared
    there): (n + 3) u eps^2 for rule P's roundings, plus B3's float32
    expanded form's (|q|^2 + |p|^2) 2^-22."""
    from repro_torch.core import metric
    e = float(metric.scalar_as(eps, pts_gpu.dtype))
    e2 = float(metric.scalar_as(e * e, pts_gpu.dtype))
    u = HALF_UNIT[pts_gpu.dtype]
    x = pts_gpu.double()
    n = x.shape[1]
    sq = (x * x).sum(dim=1)
    found = 0
    for chunk in range(0, ids.shape[0], 64):
        q = ids[chunk:chunk + 64]
        d2 = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float64,
                         device=x.device)
        for k in range(n):
            t = x[q, k][:, None] - x[:, k][None, :]
            d2 = d2 + t * t
        band = (n + 3) * u * e2 + (sq[q][:, None] + sq[None, :]) * 2.0 ** -22
        near = (d2 - e2).abs() <= band
        near[torch.arange(q.shape[0], device=q.device), q] = False
        found += int(near.any(dim=1).sum())
    return found


def half_oracle_counts(pts_gpu, pairs_first, eps: float, where: str):
    """B3's per-point counts (rule U) against a join's (rule P) on half
    rows: the points where they differ, all of which must have a neighbour
    in ``half_band_points``'s band. Returns (differing points, counts)."""
    from repro_torch.kernels import distance_tile as dt
    counts = dt.distance_tile_counts(pts_gpu, eps)
    joined = torch.bincount(pairs_first.long(), minlength=pts_gpu.shape[0])
    differ = torch.nonzero(counts.long() != joined).flatten()
    if differ.numel():
        explained = half_band_points(pts_gpu, differ, eps)
        check(explained == differ.numel(),
              f"{where}: {differ.numel() - explained} points differ between "
              f"B3's counts and the join's with no neighbour in the band")
    return int(differ.numel()), counts


def direct_counts(q, pts_gpu, eps: float):
    """(Q,) int32 neighbour counts of query rows ``q`` by rule P on the card
    (one rounding per subtract, square and add, in lane order, at the rows'
    dtype): what B1 (b) computes, slot for slot."""
    from repro_torch.core import metric
    scal = metric.device_refine_scalar("l2", eps, pts_gpu.dtype, DEVICE)
    out = []
    for a in range(0, q.shape[0], 64):
        d2 = metric.lane_d2(q[a:a + 64], lambda k: pts_gpu[:, k][None, :],
                            q.shape[1])
        out.append((d2 <= scal).sum(dim=1, dtype=torch.int32))
    return torch.cat(out)


def sliced_launches_vs_plain(prepared, run_loop: bool) -> tuple[int, int]:
    """B1 against its plain version on every launch of ``prepared``, the
    plain one in PLAIN_ROWS slices. Returns (max |kernel - plain|, rows)."""
    worst = rows = 0
    for p in prepared:
        w, r = sliced_vs_plain(
            p["args"], dict(keep_hits=True, **p["kw"]),
            run_ord=p["plan"].run_ord if run_loop else None)
        worst, rows = max(worst, w), rows + r
    return worst, rows


def half_main_path() -> dict:
    """The main path's 2,000,000 points at float16 through the fused join:
    B1 counted on the run, the total against HALF_MAIN_TOTAL, sampled
    neighbour lists against a direct evaluation, B1's float16 instances
    against their plain version on every launch, times, bound and peak."""
    import repro_torch
    from repro_torch.core import selfjoin as sj
    pts = as_half(syn(MAIN_POINTS, MAIN_DIMS), torch.float16)
    eps = MAIN_EPS
    index = repro_torch.build_grid(pts, eps, device=DEVICE)
    merged = sj._resolve_merge(index, None)
    run_loop = sj._join_run_loop(index)
    expected = len(sj._fused_launches(index, merged=merged)[0])

    def join():
        return repro_torch.self_join(pts, eps, device=DEVICE)

    join()                                                  # warm-up
    launches = counted_join(join, expected, run_loop, False)
    e2e, runs, peak, pairs = timed_join(join)
    total = int(pairs.shape[0])
    check(total == HALF_MAIN_TOTAL, f"float16 main path: {total} pairs, "
          f"recorded {HALF_MAIN_TOTAL}")
    stats = repro_torch.self_join_count(pts, eps, device=DEVICE)
    check(stats.total_pairs == total, f"float16 main path: count "
          f"{stats.total_pairs} != emitted {total}")
    pts_gpu = pts.to(DEVICE)
    check_pairs(pairs, pts_gpu, eps, MAIN_POINTS)
    del pairs
    prepared = prepared_launches(index, merged=merged, unicomp=True,
                                 run_loop=run_loop)
    worst, rows = sliced_launches_vs_plain(prepared, run_loop)
    check(worst == 0, f"float16 main path: B1 differs from its plain "
          f"version by {worst}")
    variants = (("run", "kernel", run_loop), ("plain", "reference", False))
    rounds = [{key: timed_launches(prepared, method, loop)
               for key, method, loop in variants} for _ in range(3)]
    timed = {key: statistics.median(r[key] for r in rounds)
             for key, _, _ in variants}
    bound_ms, bound_by, nbytes, flops = kernel_bound(prepared)
    # B4 at float16 on the main path's unfused launches (one per offset)
    b4 = half_b4(unfused_launches(index), index.eps)
    return dict(points=MAIN_POINTS, dims=MAIN_DIMS, eps=eps, dtype="float16",
                total_pairs=total, run_loop=run_loop, merged=merged,
                launches=launches, e2e_s=e2e, e2e_runs_s=runs,
                peak_mem_bytes=peak, sampled_queries_checked=SAMPLED_QUERIES,
                b1_rows_vs_plain=rows, b1_max_abs_err=worst,
                b1_ms=timed["run"], b1_plain_ms=timed["plain"],
                b1_timed_rounds_ms=rounds, b1_bound_ms=bound_ms,
                b1_bound_by=bound_by, b1_bound_bytes=nbytes,
                b1_bound_flops=flops, b4=b4)


def b4_index_vs_plain(index) -> int:
    """Max |kernel - plain| of B4 on every launch of the unfused count over
    ``index`` (UNICOMP), one offset's inputs at a time."""
    from repro_torch.core import selfjoin as sj
    deltas, _ = sj._offset_tables(index, True)
    cap = sj._unfused_cap(index)
    worst = 0
    for o in range(deltas.shape[0]):
        q, cand, _, valid, _, _ = sj._gather_batch(
            index, sj._neighbor_ranks_for_delta(index, deltas[o]), 0,
            index.num_points, cap)
        worst = max(worst, b4_vs_plain([(q, cand, valid)], index.eps))
    return worst


def half_b4(launches, eps) -> dict:
    """B4 at a half dtype on ``launches``: against its plain version on
    every launch, its time per launch, its plain version's and its bound."""
    worst = b4_vs_plain(launches, eps)
    check(worst == 0, f"B4 at {launches[0][0].dtype} differs from its plain "
          f"version by {worst}")
    ms = statistics.median(b4_ms(launches, eps, "kernel") for _ in range(3))
    plain_ms = b4_ms(launches, eps, "reference", reps=1)
    nbytes, flops = b4_work(launches)
    b, c, n = launches[0][1].shape
    bound_ms, bound_by = bound(nbytes // len(launches), flops // len(launches),
                               "float32")
    return dict(launches_compared=len(launches), max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                shape=[b, c, n])


def half_bench(workloads) -> dict:
    """The seven bench workloads at float16 and bfloat16: the fused count
    and join against HALF_TOTALS (per cell at bfloat16 where the merged
    lane would not hold the cell coordinates), B1 against its plain
    version on every launch of the join, the "pallas" count (B4) against
    HALF_TOTALS with B4 against its plain version on every launch; B1's
    and B4's launches counted per dtype around the joins and counts."""
    import repro_torch
    from repro_torch.kernels import cell_join as cj
    from repro_torch.kernels import fused_join as fj
    out = {}
    for dname, dtype in HALF_DTYPES.items():
        rows = {}
        b1 = b4 = worst = 0
        for name, (raw, eps) in workloads.items():
            pts = as_half(raw, dtype)
            index = repro_torch.build_grid(pts, eps, device=DEVICE)
            merge = merged_lane_ok(index)
            fj.KERNEL_LAUNCHES = 0
            stats = repro_torch.self_join_count(pts, eps, index=index,
                                                merge_last_dim=merge,
                                                device=DEVICE)
            pairs = repro_torch.self_join(pts, eps, index=index,
                                          merge_last_dim=merge, device=DEVICE)
            sync()
            b1 += fj.KERNEL_LAUNCHES
            want = HALF_TOTALS[dname]["fused"][name]
            check(stats.total_pairs == pairs.shape[0] == want,
                  f"{name} {dname}: fused count {stats.total_pairs} / join "
                  f"{pairs.shape[0]} != recorded {want}")
            err = compare_kernel_and_plain(prepared_launches(
                index, merged=merge, unicomp=True), keep_hits=True)
            check(err == 0, f"{name} {dname}: B1 differs from its plain "
                  f"version by {err}")
            cj.KERNEL_LAUNCHES = 0
            pal = repro_torch.self_join_count(pts, eps, index=index,
                                              distance_impl="pallas",
                                              device=DEVICE)
            sync()
            b4 += cj.KERNEL_LAUNCHES
            want = HALF_TOTALS[dname]["pallas"][name]
            check(pal.total_pairs == want, f"{name} {dname}: pallas count "
                  f"{pal.total_pairs} != recorded {want}")
            err4 = b4_index_vs_plain(index)
            check(err4 == 0, f"{name} {dname}: B4 differs from its plain "
                  f"version by {err4}")
            worst = max(worst, err, err4)
            rows[name] = dict(fused=stats.total_pairs, pallas=pal.total_pairs,
                              merged=merge)
        check(b1 > 0 and b4 > 0, f"{dname}: the bench joins launched B1 "
              f"{b1} and B4 {b4} times")
        out[dname] = dict(totals=rows, b1_launches=b1, b4_launches=b4,
                          max_abs_err=worst)
    # B1 and B4 at bfloat16 timed on uniform-2d's launches
    raw, eps = workloads["uniform-2d"]
    index = repro_torch.build_grid(as_half(raw, torch.bfloat16), eps,
                                   device=DEVICE)
    prepared = prepared_launches(index, merged=merged_lane_ok(index),
                                 unicomp=True)
    b1_ms = statistics.median(timed_launches(prepared, "kernel")
                              for _ in range(3))
    b1_plain = timed_launches(prepared, "reference", reps=1)
    b1_bound = kernel_bound(prepared)
    out["bfloat16"].update(
        b1_ms=b1_ms, b1_plain_ms=b1_plain, b1_bound_ms=b1_bound[0],
        b1_bound_by=b1_bound[1], b1_timed_on="uniform-2d",
        b4=half_b4(unfused_launches(index), index.eps))
    return out


def half_cosine() -> dict:
    """COSINE_POINTS embeddings from float16 and from bfloat16 input: the
    join's total against HALF_COSINE_TOTALS, B3 at the unit rows' dtype
    (float16; bfloat16 input gives float64 unit rows, as in the JAX
    package) against the join's per-point counts, and a JoinService
    answering METRIC_REQUESTS requests of SERVE_BATCH queries, each count
    against a direct evaluation (B1 (b) at float16)."""
    import repro_torch
    from repro_torch.core import metric
    from repro_torch.kernels import distance_tile as dt
    from repro_torch.kernels import fused_join as fj
    from repro_torch.launch import serve
    emb = cosine_data(COSINE_POINTS)
    rng = np.random.default_rng(41)
    out = {}
    for dname, dtype in HALF_DTYPES.items():
        x = as_half(emb, dtype)
        canon = metric.canonicalize(x, COSINE_T, metric="cosine")

        def join():
            return repro_torch.self_join(x, COSINE_T, metric="cosine",
                                         device=DEVICE)

        join()                                              # warm-up
        fj.KERNEL_LAUNCHES = 0
        e2e, runs, peak, pairs = timed_join(join)
        launches = fj.KERNEL_LAUNCHES // len(runs)
        check(launches > 0, f"cosine {dname}: the join launched no B1")
        total = int(pairs.shape[0])
        check(total == HALF_COSINE_TOTALS[dname], f"cosine {dname}: {total} "
              f"pairs, recorded {HALF_COSINE_TOTALS[dname]}")
        unit = torch.as_tensor(canon.geom).to(DEVICE)
        dt.COUNTS_LAUNCHES = 0
        if unit.dtype in HALF_UNIT:
            n_differ, _ = half_oracle_counts(unit, pairs[:, 0],
                                             canon.eps_geom, f"cosine {dname}")
        else:
            n_differ, _ = oracle_counts(unit, pairs[:, 0], canon.eps_geom,
                                        f"cosine {dname}")
        sync()
        b3 = dt.COUNTS_LAUNCHES
        del pairs
        svc = serve.JoinService(x, COSINE_T, metric="cosine",
                                return_pairs=True, device=DEVICE)
        requests = []
        for _ in range(METRIC_REQUESTS):
            near = emb[rng.integers(0, COSINE_POINTS, SERVE_BATCH // 2)]
            near = near * rng.uniform(0.5, 3.0, (SERVE_BATCH // 2, 1)) + \
                rng.normal(0, 0.005, near.shape)
            q = np.concatenate([near, rng.normal(
                size=(SERVE_BATCH - SERVE_BATCH // 2, COSINE_DIMS))])
            requests.append(as_half(q, dtype))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # warmup() marks steady
            svc.warmup(SERVE_BATCH)
        sync()
        fj.EXTERNAL_LAUNCHES = 0
        results = [svc.query(q) for q in requests]
        external = fj.EXTERNAL_LAUNCHES
        check(external > 0, f"cosine {dname} service launched no B1 (b)")
        for q, res in zip(requests, results):
            qu = torch.as_tensor(
                metric.canonicalize_queries(canon, q)[0]).to(DEVICE)
            want = direct_counts(qu, unit, canon.eps_geom).cpu().numpy()
            check(np.array_equal(want, res.counts), f"cosine {dname} "
                  f"service: counts differ from the direct evaluation")
            check(np.array_equal(np.bincount(res.pairs[:, 0],
                                             minlength=len(q)), res.counts),
                  f"cosine {dname} service: pairs and counts disagree")
        ext_err = compare_external(external_launches(
            svc.prepared, requests[0]))
        check(ext_err == 0, f"cosine {dname}: B1 (b) differs from its plain "
              f"version by {ext_err}")
        p50, p99 = svc.percentiles()
        out[dname] = dict(unit_dtype=str(unit.dtype).replace("torch.", ""),
                          total_pairs=total, join_s=e2e, join_runs_s=runs,
                          join_peak_bytes=peak, b1_launches=launches,
                          b3_launches=b3, oracle_differing_points=n_differ,
                          requests=METRIC_REQUESTS,
                          request_queries=SERVE_BATCH,
                          external_launches=external,
                          external_max_abs_err=ext_err,
                          p50_ms=p50, p99_ms=p99)
        del svc, unit
    return out


def half_brute(workloads) -> dict:
    """Kernel B2-bf16: brute force on HALF_BRUTE_WORKLOAD at bfloat16 and
    float16. B2 and B3 against their plain versions, bit for bit, on every
    launch of the sweep; B3's per-point counts against B2's row sums; the
    brute path (brute_force_count, "pallas") counted; B2 timed by its device
    time under the profiler and by CUDA events over the sweep
    (``b2_times``), B3 by events, each beside its plain version and its
    bound at 2 bytes an element."""
    import repro_torch
    from repro_torch.core import metric
    from repro_torch.kernels import distance_tile as dt
    raw, eps = workloads[HALF_BRUTE_WORKLOAD]
    out = {}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float16", torch.float16)):
        p = as_half(raw, dtype).to(DEVICE)
        npts, n = p.shape
        row_sums = torch.empty(npts, dtype=torch.int32, device=DEVICE)
        ids = torch.arange(npts, device=DEVICE)
        for r0 in range(0, npts, 256):
            a = dt.distance_tile_hits(p[r0:r0 + 256], p, eps, method="kernel")
            b = dt.distance_tile_hits(p[r0:r0 + 256], p, eps,
                                      method="reference")
            check(torch.equal(a, b), f"{dname}: B2 differs from its plain "
                  f"version on rows {r0}..")
            a[torch.arange(a.shape[0], device=DEVICE), ids[r0:r0 + 256]] = \
                False
            row_sums[r0:r0 + 256] = a.sum(dim=1, dtype=torch.int32)
        dt.COUNTS_LAUNCHES = 0
        counts = dt.distance_tile_counts(p, eps, method="kernel")
        sync()
        b3_launches = dt.COUNTS_LAUNCHES
        check(torch.equal(counts, dt.distance_tile_counts(
            p, eps, method="reference")), f"{dname}: B3 differs from its "
            f"plain version")
        check(torch.equal(counts, row_sums), f"{dname}: B3's counts differ "
              f"from B2's row sums")
        dt.HITS_LAUNCHES = 0
        total = repro_torch.brute_force_count(p, eps, distance_impl="pallas",
                                              device=DEVICE)
        b2_launches = dt.HITS_LAUNCHES
        check(b2_launches == -(-npts // 256), f"{dname}: the brute path "
              f"launched B2 {b2_launches} times")
        check(total == int(counts.sum(dtype=torch.int64)), f"{dname}: "
              f"brute_force_count {total} != B3's total")

        eps_t = metric.scalar_as(eps, dtype, DEVICE)
        b2 = b2_times(p, eps_t)
        timed = {}
        for key, fn in (("b2_plain", lambda: b2_sweep(p, eps_t,
                                                      "reference")),
                        ("b3", lambda: dt.distance_tile_counts(
                            p, eps, method="kernel")),
                        ("b3_plain", lambda: dt.distance_tile_counts(
                            p, eps, method="reference"))):
            fn()                                          # warm-up
            timed[key] = statistics.median(event_ms(fn) for _ in range(3))
        b3_bound = bound(*counts_tile_work(npts, n, 2), "float32")
        out[dname] = dict(points=npts, eps=eps, total_pairs=total,
                          b2_launches=b2_launches, b3_launches=b3_launches,
                          b2_device_ms=b2["device_ms"],
                          b2_events_ms=b2["events_ms"],
                          b2_plain_ms=timed["b2_plain"],
                          b2_bound_ms=b2["bound_ms"],
                          b2_bound_by=b2["bound_by"],
                          b2_issue_floor_ms=b2["issue_floor_ms"],
                          b2_cdist_ms=b2["cdist_ms"],
                          b2_cdist_note=b2["cdist_note"],
                          b3_ms=timed["b3"], b3_plain_ms=timed["b3_plain"],
                          b3_bound_ms=b3_bound[0], b3_bound_by=b3_bound[1],
                          b3_issue_floor_ms=counts_issue_ms(npts, n,
                                                            "float32"),
                          b3_equals_b2_row_sums=True)
        del p
    return out


def slab_launch_count(pts, eps: float, n_slabs: int, merged: bool) -> int:
    """B1 (d)'s launches in one ``distributed_self_join`` of ``pts``."""
    from repro_torch.core import distributed as dist, selfjoin as sj
    return sum(len(sj._fused_launches(s.index, merged=merged,
                                      row_ok=s.row_ok, gid=s.ids)[0])
               for s in dist.slab_indexes(pts, eps, n_slabs, device=DEVICE))


def timed_slab_join(join):
    """(result, host s, peak bytes) of one join ending in a sync."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = join()
    sync()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def slab_plan(pts, eps: float, n_slabs: int) -> dict:
    """The host plan of a slab join: hops and the exact halo capacity."""
    from repro_torch.core import distributed as dist
    coords, gids, width = dist.partition_points_host(pts, n_slabs)
    mins, maxs = dist.slab_extents(coords, gids)
    k_hops = dist.halo_reach(mins, maxs, eps)
    need = dist.exact_halo_capacity(coords, gids, mins, maxs, eps, k_hops)
    return dict(slabs=n_slabs, k_hops=k_hops, exact_halo_capacity=need,
                halo_capacity=min(dist._next_pow2(need), coords.shape[1]),
                slab_rows=coords.shape[1], narrowest_slab=float(width))


def slab_vs_plain(slab) -> tuple[int, int]:
    """B1 (d) against its plain version on every launch of one slab's join:
    merged and per-cell sweeps, UNICOMP and self masks, row and run loop,
    hits plane on and off, in PLAIN_ROWS slices (every slice for the join's
    own variant, every SLAB_ROW_STRIDE-th for the others). Returns (max
    |kernel - plain|, launches compared)."""
    worst = compared = 0
    for merged in (True, False):
        for unicomp in (True, False):
            for run_loop in (True, False):
                prepared = prepared_launches(slab.index, merged=merged,
                                             unicomp=unicomp,
                                             run_loop=run_loop, slab=slab)
                for keep_hits in (True, False):
                    own = merged and unicomp and run_loop and keep_hits
                    for p in prepared:
                        qp = p["args"][1].shape[0]
                        step = PLAIN_ROWS * (1 if own else SLAB_ROW_STRIDE)
                        err, _ = sliced_vs_plain(
                            p["args"], dict(p["kw"], keep_hits=keep_hits),
                            p["plan"].run_ord if run_loop else None,
                            starts=range(0, qp, step))
                        check(err == 0, f"B1 (d) merged={merged} unicomp="
                              f"{unicomp} run_loop={run_loop} keep_hits="
                              f"{keep_hits}: kernel differs from the plain "
                              f"version by {err}")
                        worst = max(worst, err)
                        compared += 1
    return worst, compared


def phase_slab() -> dict:
    """The slab join in one process on the card (``distributed_self_join``,
    ROADMAP A14 (i)) and its kernel B1 (d)."""
    import repro_torch
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import fused_join as fj
    t_phase = time.perf_counter()
    pts, eps = syn(MAIN_POINTS, MAIN_DIMS), MAIN_EPS
    merged = True                  # 2-D: room for the merged and id lanes
    repro_torch.self_join(pts, eps, device=DEVICE)            # warm-up
    ref, one_s, one_peak = timed_slab_join(
        lambda: repro_torch.self_join(pts, eps, device=DEVICE))
    check(ref.shape[0] == MAIN_TOTAL, f"self_join gave {ref.shape[0]} "
          f"pairs, recorded {MAIN_TOTAL}")
    runs = []
    for n_slabs in SLAB_COUNTS:
        plan = slab_plan(pts, eps, n_slabs)
        expected = slab_launch_count(pts, eps, n_slabs, merged)
        fj.KERNEL_LAUNCHES = fj.GID_LAUNCHES = fj.RUN_LOOP_LAUNCHES = 0
        got, join_s, peak = timed_slab_join(
            lambda: dist.distributed_self_join(pts, eps, n_slabs,
                                               device=DEVICE))
        launches = dict(total=fj.KERNEL_LAUNCHES, gid=fj.GID_LAUNCHES,
                        run_loop=fj.RUN_LOOP_LAUNCHES)
        check(launches["total"] == launches["gid"] == expected > 0,
              f"{n_slabs} slabs: B1 launches {launches}, scheduled "
              f"{expected} B1 (d) launches")
        check(torch.equal(got, ref), f"{n_slabs} slabs: pairs differ from "
              f"self_join's ({got.shape[0]} vs {ref.shape[0]})")
        del got
        total, count_s, _ = timed_slab_join(
            lambda: dist.distributed_self_join(pts, eps, n_slabs,
                                               return_pairs=False,
                                               device=DEVICE))
        plain_total, plain_s, _ = timed_slab_join(
            lambda: dist.distributed_self_join_count(pts, eps, n_slabs,
                                                     device=DEVICE))
        check(total == plain_total == MAIN_TOTAL, f"{n_slabs} slabs: "
              f"count-only {total}, plain count {plain_total}, recorded "
              f"{MAIN_TOTAL}")
        runs.append(dict(plan, join_s=join_s, peak_mem_bytes=peak,
                         launches=launches, count_only_s=count_s,
                         plain_count_s=plain_s, total_pairs=total))
        emit("slab", part="main_path", points=MAIN_POINTS, eps=eps,
             self_join_s=one_s, self_join_peak_bytes=one_peak, **runs[-1])

    # B1 (d) on one slab's launches: against its plain version, and timed
    # beside B1 (c) / (a) on the same launches without the id masks
    slab, = [s for s in dist.slab_indexes(pts, eps, SLAB_HELD[0],
                                          device=DEVICE)
             if s.slab == SLAB_HELD[1]]
    worst, compared = slab_vs_plain(slab)
    gid = prepared_launches(slab.index, merged=merged, unicomp=True,
                            run_loop=True, slab=slab)
    pos = [dict(p, kw=dict(p["kw"], gid_pairs=False)) for p in gid]
    variants = (("gid", gid, "kernel", True),
                ("gid_row", gid, "kernel", False),
                ("run", pos, "kernel", True), ("row", pos, "kernel", False),
                ("plain", gid, "reference", False))
    rounds = [{key: timed_launches(prep, method, run_loop)
               for key, prep, method, run_loop in variants}
              for _ in range(3)]
    timed = {key: statistics.median(r[key] for r in rounds)
             for key, _, _, _ in variants}
    bound_ms, bound_by, nbytes, flops = kernel_bound(gid)
    held = dict(slabs=SLAB_HELD[0], slab=SLAB_HELD[1],
                rows=int(slab.index.num_points),
                owned_rows=int(slab.row_ok.sum()),
                launch_caps=[p["kw"]["c"] for p in gid],
                launch_rows=[p["args"][1].shape[0] for p in gid],
                launches_compared=compared, max_abs_err=worst,
                gid_ms=timed["gid"], gid_row_loop_ms=timed["gid_row"],
                positions_run_loop_ms=timed["run"],
                positions_row_loop_ms=timed["row"], plain_ms=timed["plain"],
                timed_rounds_ms=rounds, bound_ms=bound_ms, bound_by=bound_by,
                bound_bytes=nbytes, bound_flops=flops)
    emit("slab", part="b1d", **held)
    del slab, gid, pos, ref
    emit("slab", part="profile", points=MAIN_POINTS, slabs=SLAB_HELD[0],
         **profiled_join(lambda: dist.distributed_self_join(
             pts, eps, SLAB_HELD[0], device=DEVICE),
             spans=("self_join.", "slab_join.")))

    # a skewed set whose halo takes two hops or more
    skew = expo(SKEW_POINTS, 3)
    skew_plan = slab_plan(skew, SLAB_SKEW_EPS, SLAB_SKEW_SLABS)
    check(skew_plan["k_hops"] >= 2, f"the skewed case takes "
          f"{skew_plan['k_hops']} hop(s)")
    want, skew_one_s, _ = timed_slab_join(
        lambda: repro_torch.self_join(skew, SLAB_SKEW_EPS, device=DEVICE))
    got, skew_s, skew_peak = timed_slab_join(
        lambda: dist.distributed_self_join(skew, SLAB_SKEW_EPS,
                                           SLAB_SKEW_SLABS, device=DEVICE))
    check(got.shape[0] > 0 and torch.equal(got, want),
          f"skewed slab join: {got.shape[0]} pairs, self_join "
          f"{want.shape[0]}")
    emit("slab", part="skew", points=SKEW_POINTS, eps=SLAB_SKEW_EPS,
         total_pairs=int(got.shape[0]), join_s=skew_s,
         peak_mem_bytes=skew_peak, self_join_s=skew_one_s, **skew_plan)
    del skew, want, got

    # cosine through the slab join
    emb = cosine_data(COSINE_POINTS)
    want, cos_one_s, _ = timed_slab_join(
        lambda: repro_torch.self_join(emb, COSINE_T, metric="cosine",
                                      device=DEVICE))
    got, cos_s, _ = timed_slab_join(
        lambda: dist.distributed_self_join(emb, COSINE_T, SLAB_COSINE_SLABS,
                                           metric="cosine", device=DEVICE))
    check(got.shape[0] > 0 and torch.equal(got, want),
          f"cosine slab join: {got.shape[0]} pairs, self_join "
          f"{want.shape[0]}")
    cos_total = int(got.shape[0])
    del emb, want, got

    # refusals: half points past the exact-id bound, a forced overflow
    refused = {}
    for what, call in (
            ("float16_ids", lambda: dist.distributed_self_join(
                as_half(syn(3000, 2), torch.float16), 2.0, 2,
                device=DEVICE)),
            ("halo_overflow", lambda: dist.distributed_self_join(
                pts, eps, 2, halo_capacity=2, device=DEVICE))):
        try:
            call()
        except (ValueError, RuntimeError) as err:
            refused[what] = str(err)
    check(sorted(refused) == ["float16_ids", "halo_overflow"]
          and "C3" in refused["float16_ids"]
          and "halo capacity overflow" in refused["halo_overflow"],
          f"refusals: {refused}")
    emit("slab", part="cosine_and_refusals", points=COSINE_POINTS,
         t=COSINE_T, slabs=SLAB_COSINE_SLABS, total_pairs=cos_total,
         join_s=cos_s, self_join_s=cos_one_s, refused=refused,
         phase_s=time.perf_counter() - t_phase)
    counted = runs[-1]["launches"]
    return dict(launches=counted["gid"], ms=held["gid_ms"],
                plain_ms=held["plain_ms"], bound_ms=held["bound_ms"],
                bound_by=held["bound_by"], worst=worst)


def phase_half(workloads) -> dict:
    t0 = time.perf_counter()
    main = half_main_path()
    emit("half", part="main_path", **main)
    bench = half_bench(workloads)
    emit("half", part="bench", **bench)
    cosine = half_cosine()
    emit("half", part="cosine", **cosine)
    brute = half_brute(workloads)
    emit("half", part="brute", **brute, phase_s=time.perf_counter() - t0)
    return dict(main=main, bench=bench, cosine=cosine, brute=brute)


def half_kernels(half) -> list:
    """The kernels line's entries of the half instances."""
    csrc = "src/repro_torch/kernels/csrc"
    main, bench, brute = half["main"], half["bench"], half["brute"]
    bf = bench["bfloat16"]
    out = [{
        "name": "fused_join_float16", "route": "cuda",
        "source": f"{csrc}/fused_join.cu",
        "replaces": "src/repro/kernels/fused_join.py:215",
        "launches": main["launches"],
        "launches_by_variant": {
            "bench": bench["float16"]["b1_launches"],
            "cosine_external": half["cosine"]["float16"]["external_launches"]},
        "max_abs_err": max(main["b1_max_abs_err"],
                           bench["float16"]["max_abs_err"],
                           half["cosine"]["float16"]["external_max_abs_err"]),
        "ms": main["b1_ms"], "plain_ms": main["b1_plain_ms"],
        "bound_ms": main["b1_bound_ms"], "bound_by": main["b1_bound_by"],
        "library_ms": None, "matched_plain": True,
        "timed_on": "the float16 main path's launches",
    }, {
        "name": "fused_join_bfloat16", "route": "cuda",
        "source": f"{csrc}/fused_join.cu",
        "replaces": "src/repro/kernels/fused_join.py:215",
        "launches": bf["b1_launches"], "max_abs_err": bf["max_abs_err"],
        "ms": bf["b1_ms"], "plain_ms": bf["b1_plain_ms"],
        "bound_ms": bf["b1_bound_ms"], "bound_by": bf["b1_bound_by"],
        "library_ms": None, "matched_plain": True,
        "timed_on": "uniform-2d at bfloat16",
    }]
    for dname, b4, launches in (
            ("float16", main["b4"], bench["float16"]["b4_launches"]),
            ("bfloat16", bf["b4"], bf["b4_launches"])):
        out.append({
            "name": f"cell_join_hits_{dname}", "route": "cuda",
            "source": f"{csrc}/cell_join.cu",
            "replaces": "src/repro/kernels/cell_join.py:32",
            "launches": launches, "max_abs_err": b4["max_abs_err"],
            "ms": b4["ms"], "plain_ms": b4["plain_ms"],
            "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"],
            "library_ms": None, "matched_plain": True,
            "timed_on": f"{b4['shape']} per launch"})
    for dname in ("bfloat16", "float16"):
        b = brute[dname]
        out.append({
            "name": f"distance_tile_hits_{dname}", "route": "cuda",
            "source": f"{csrc}/distance_tile.cu",
            "replaces": "src/repro/kernels/distance_tile.py:45",
            "launches": b["b2_launches"], "max_abs_err": 0,
            "ms": b["b2_device_ms"], "events_ms": b["b2_events_ms"],
            "plain_ms": b["b2_plain_ms"],
            "bound_ms": b["b2_bound_ms"], "bound_by": b["b2_bound_by"],
            "issue_floor_ms": b["b2_issue_floor_ms"],
            "library_ms": b["b2_cdist_ms"], "library": b["b2_cdist_note"],
            "matched_plain": True,
            "timed_on": f"{HALF_BRUTE_WORKLOAD} brute sweep at {dname}, "
                        f"device time by name"})
        out.append({
            "name": f"distance_tile_counts_{dname}", "route": "cuda",
            "source": f"{csrc}/distance_tile.cu",
            "replaces": "src/repro/kernels/distance_tile.py:62",
            "launches": b["b3_launches"]
            + half["cosine"][dname]["b3_launches"] * (dname == "float16"),
            "max_abs_err": 0, "ms": b["b3_ms"], "plain_ms": b["b3_plain_ms"],
            "bound_ms": b["b3_bound_ms"], "bound_by": b["b3_bound_by"],
            "issue_floor_ms": b["b3_issue_floor_ms"],
            "library_ms": None, "matched_plain": True,
            "timed_on": f"{HALF_BRUTE_WORKLOAD} at {dname}"})
    return out


def record_half_totals() -> dict:
    """HALF_MAIN_TOTAL, HALF_TOTALS and HALF_COSINE_TOTALS from the port's
    plain versions on the CPU (``--record-half-totals``): the fused count
    (per cell at bfloat16 where the merged lane would not hold the cell
    coordinates) and the "pallas" count of every bench workload at both
    half dtypes, the float16 main path, and the cosine join of
    COSINE_POINTS half embeddings."""
    import repro_torch
    cpu = torch.device("cpu")
    main = repro_torch.self_join_count(
        as_half(syn(MAIN_POINTS, MAIN_DIMS), torch.float16), MAIN_EPS,
        device=cpu).total_pairs
    totals = {}
    for dname, dtype in HALF_DTYPES.items():
        totals[dname] = {"fused": {}, "pallas": {}}
        for name, (raw, eps) in bench_workloads().items():
            pts = as_half(raw, dtype)
            index = repro_torch.build_grid(pts, eps, device=cpu)
            totals[dname]["fused"][name] = repro_torch.self_join_count(
                pts, eps, index=index, merge_last_dim=merged_lane_ok(index),
                device=cpu).total_pairs
            totals[dname]["pallas"][name] = repro_torch.self_join_count(
                pts, eps, index=index, distance_impl="pallas",
                device=cpu).total_pairs
    emb = cosine_data(COSINE_POINTS)
    cosine = {dname: repro_torch.self_join_count(
        as_half(emb, dtype), COSINE_T, metric="cosine",
        device=cpu).total_pairs for dname, dtype in HALF_DTYPES.items()}
    return dict(HALF_MAIN_TOTAL=main, HALF_TOTALS=totals,
                HALF_COSINE_TOTALS=cosine)


def b1b_checksum(outs) -> list:
    """Integers of B1 (b)'s outputs over a request's launches: the hits, the
    sum of their flat positions, the counts' total and the slot bases
    weighted by their position."""
    out = [0, 0, 0, 0]
    for hits, counts, base in outs:
        flat = torch.nonzero(hits.reshape(-1)).reshape(-1)
        weight = torch.arange(1, base.numel() + 1, device=base.device)
        out = [out[0] + int(flat.numel()), out[1] + int(flat.sum()),
               out[2] + int(counts.sum(dtype=torch.int64)),
               out[3] + int((base.to(torch.int64) * weight).sum())]
    return out


def b1_launch_times(launches, run_loop: bool = False, reps: int = 20) -> dict:
    """B1 on ``launches`` (``prepared_launches``' form), run loop or row
    loop: device time by kernel name under the profiler (no host gap
    reaches it), the pass by CUDA events over back-to-back passes, and the
    outputs' integers (``b1b_checksum``)."""
    from repro_torch.kernels import fused_join as fj

    def one_pass():
        return [fj.fused_join_hits(*p["args"], method="kernel",
                                   **_loop_kw(p, run_loop), **p["kw"])
                for p in launches]

    checksum = b1b_checksum(one_pass())
    device = [profiled_device_ms(one_pass, reps=reps,
                                 kernel="fused_join_kernel")
              for _ in range(3)]
    events = [timed_launches(launches, "kernel", run_loop, reps=reps)
              for _ in range(3)]
    return dict(launches=len(launches), c=[p["kw"]["c"] for p in launches],
                rows=[int(p["args"][1].shape[0]) for p in launches],
                device_ms=statistics.median(device), device_runs_ms=device,
                events_ms=statistics.median(events), events_runs_ms=events,
                checksum=checksum)


# The bench workloads whose every B1 launch ``b1_times`` times, and at
# which row dtypes.
BENCH_B1_DTYPES = {
    "uniform-2d": ("float64", "float32", "float16", "bfloat16"),
    "clustered-2d": ("float64",), "expo-3d": ("float64", "bfloat16"),
    "uniform-4d": ("float64",), "clustered-4d": ("float64",),
    "uniform-6d": ("float64",), "clustered-6d": ("float64",)}


def b1_times() -> dict:
    """B1's self-join launches alone, from the ``repro_torch`` first on
    ``sys.path`` (``--b1-times [SRC]``, and within ``--kernel-times``):
    B1 (c) and (a) on the main path's launches at f64 (run and row loop),
    B1 on the float16 main path's launches, B1 (d) on slab SLAB_HELD[1] of
    the SLAB_HELD[0]-slab join (run loop), the widest self-join launch
    of the skewed expo-3d bench workload, and every launch of the bench
    workloads' joins (``BENCH_B1_DTYPES``), each by ``b1_launch_times``
    with its byte bound (``kernel_bound``)."""
    import repro_torch
    from repro_torch.core import distributed as dist, selfjoin as sj
    pts = syn(MAIN_POINTS, MAIN_DIMS)
    out = {}

    def join_launches(points, eps):
        index = repro_torch.build_grid(points, eps, device=DEVICE)
        run = sj._join_run_loop(index)
        return prepared_launches(index, merged=sj._resolve_merge(index, None),
                                 unicomp=True, run_loop=run), run

    prepared, run = join_launches(pts, MAIN_EPS)
    out["b1c_main_float64"] = b1_launch_times(prepared, run, reps=10)
    out["b1a_main_float64"] = b1_launch_times(prepared, False, reps=10)
    out["main_float64_bound_ms"] = kernel_bound(prepared)[0]
    prepared, run = join_launches(as_half(pts, torch.float16), MAIN_EPS)
    out["b1_main_float16"] = b1_launch_times(prepared, run, reps=10)
    out["main_float16_bound_ms"] = kernel_bound(prepared)[0]
    del prepared
    slab, = [s_ for s_ in dist.slab_indexes(pts, MAIN_EPS, SLAB_HELD[0],
                                            device=DEVICE)
             if s_.slab == SLAB_HELD[1]]
    gid = prepared_launches(slab.index, merged=True, unicomp=True,
                            run_loop=True, slab=slab)
    out["b1d_slab"] = b1_launch_times(gid, True)
    out["b1d_slab_bound_ms"] = kernel_bound(gid)[0]
    del slab, gid
    work = bench_workloads()
    prepared, run = join_launches(*work["expo-3d"])
    widest = [max(prepared, key=lambda p_: p_["kw"]["c"])]
    out["b1_expo3d_widest"] = b1_launch_times(widest, run)
    out["expo3d_widest_bound_ms"] = kernel_bound(widest)[0]
    # every launch of each bench workload's join, at f64 and at the
    # other row dtypes on uniform-2d and expo-3d
    out["bench"] = {}
    for name, dtypes in BENCH_B1_DTYPES.items():
        raw, eps = work[name]
        for dname in dtypes:
            pts_ = (as_half(raw, HALF_DTYPES[dname]) if dname in HALF_DTYPES
                    else torch.as_tensor(raw, dtype=getattr(torch, dname)))
            prepared, run = join_launches(pts_, eps)
            out["bench"][f"{name}_{dname}"] = dict(
                b1_launch_times(prepared, run, reps=10),
                bound_ms=kernel_bound(prepared)[0])
    return out


def b4_times(pts, eps) -> dict:
    """B4 on the unfused join's launches over ``pts`` (one per stencil
    offset): ms a launch by CUDA events over back-to-back passes and by
    kernel name under the profiler (a small launch's events follow the
    host), and the hits' integers (count and position checksum)."""
    from repro_torch.core import grid
    from repro_torch.kernels import cell_join as cj
    index = grid.build_grid(pts, eps, device=DEVICE)
    launches = unfused_launches(index)
    hits = pos = 0
    for q, cand, valid in launches:
        flat = torch.nonzero(cj.cell_join_hits(q, cand, valid, index.eps)
                             .reshape(-1)).reshape(-1)
        hits += int(flat.numel())
        pos += int(flat.sum())
    runs = [b4_ms(launches, index.eps, "kernel", reps=10) for _ in range(3)]
    device = [profiled_device_ms(lambda: [
        cj.cell_join_hits(q, cand, valid, index.eps)
        for q, cand, valid in launches], reps=10, kernel="cell_join_kernel")
        / len(launches) for _ in range(3)]
    b, c, n = launches[0][1].shape
    return dict(shape=[b, c, n], launches=len(launches),
                ms=statistics.median(runs), runs_ms=runs,
                device_ms=statistics.median(device), device_runs_ms=device,
                hits=hits, checksum=pos)


# The benchmark cells' joins whose emit ``emit_times`` times: 2,000,000
# uniform points in [0, 100)^d at eps (portbench/configs/*.json).
EMIT_CELLS = {"syn2d2m": (2, 0.8), "syn6d2m": (6, 10.0)}


def recorded_emits(join) -> list:
    """The emit calls of one ``join()``, in launch order: the arguments
    ``selfjoin._emit_chunk`` got, recorded by a spy (which keeps each
    launch's B1 outputs alive), so that what ``emit_times`` times is the
    join's own input."""
    from repro_torch.core import selfjoin as sj
    calls, real = [], sj._emit_chunk

    def spy(index, ids, hits, counts, slot_base, win_start, q_pos, *, c,
            tq, unicomp, found):
        calls.append(dict(args=(hits, counts, slot_base, win_start, q_pos,
                                ids),
                          index=index, tq=tq, unicomp=unicomp, found=found))
        return real(index, ids, hits, counts, slot_base, win_start, q_pos,
                    c=c, tq=tq, unicomp=unicomp, found=found)

    sj._emit_chunk = spy
    try:
        join()
    finally:
        sj._emit_chunk = real
    sync()
    return calls


def emit_times(calls, reps: int = 5) -> dict:
    """The emit of a join's fused launches (``recorded_emits``; B1's hit
    planes made once, outside the timing): the kernel (``emit_pairs``) by
    CUDA events over ``reps`` back-to-back passes (median of three) and by
    kernel name under the profiler; the plain version
    (``selfjoin._emit_from_hits`` and the stack, as a CPU tensor takes it)
    by events, median of two; the two held equal row for row; and the byte
    bound: the plane rows these inputs need (those of the rows with a hit;
    a row without one is never read) read once and the pairs written once
    (8 bytes a pair) at HBM_BYTES_PER_S."""
    from repro_torch.core import selfjoin as sj
    from repro_torch.kernels import emit_pairs as ep

    def plain_pass():
        out = []
        for p in calls:
            hits, counts, base, ws, qpos, ids = p["args"]
            ordered = (2 if p["unicomp"] else 1) * p["found"]
            keys, vals = sj._emit_from_hits(
                p["index"], ids, hits, counts, base, ws, qpos,
                c=hits.shape[2], tq=p["tq"], unicomp=p["unicomp"],
                capacity=max(ordered, 1))
            out.append(torch.stack([keys[:ordered], vals[:ordered]], dim=1))
        return out

    def kernel_pass():
        return [ep.emit_pairs(*p["args"], tq=p["tq"],
                              npts=p["index"].num_points, n_hits=p["found"],
                              unicomp=p["unicomp"])
                for p in calls]

    planes = [p["args"][0] for p in calls]
    live_rows = [int((p["args"][1] > 0).sum()) for p in calls]
    live_plane = sum(n * h.shape[0] * h.shape[2]
                     for n, h in zip(live_rows, planes))
    found = sum(p["found"] for p in calls)
    pair_bytes = sum((2 if p["unicomp"] else 1) * p["found"] * 8
                     for p in calls)
    out = dict(launches=len(calls), c=[int(h.shape[2]) for h in planes],
               n_off=[int(h.shape[0]) for h in planes],
               rows=[int(h.shape[1]) for h in planes], live_rows=live_rows,
               slots=sum(h.numel() for h in planes), hits=found,
               live_plane_bytes=live_plane, pair_bytes=pair_bytes,
               bound_ms=(live_plane + pair_bytes) / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    check(all(torch.equal(a, b) for a, b in zip(kernel_pass(),
                                                 plain_pass())),
          "emit_times: the emit kernel differs from the plain version")
    plain = [event_ms(plain_pass) for _ in range(2)]
    runs = [event_ms(kernel_pass, reps) for _ in range(3)]
    device = [profiled_device_ms(kernel_pass, reps=reps,
                                 kernel="emit_pairs_kernel")
              for _ in range(3)]
    out.update(plain_ms=statistics.median(plain), plain_runs_ms=plain,
               ms=statistics.median(runs), runs_ms=runs,
               device_ms=statistics.median(device), device_runs_ms=device,
               matched_plain=True)
    out["bound_share"] = out["bound_ms"] / out["device_ms"]
    return out


def emit_cell_times() -> dict:
    """``emit_times`` on the joins of both benchmark cells (``EMIT_CELLS``)
    and of the 100,000-set Jaccard join, from the ``repro_torch`` first on
    ``sys.path`` (``--emit-times [SRC]``, and within ``--kernel-times``),
    with the kernel's ptxas registers and spills (empty when its library
    was built before the call)."""
    import repro_torch
    from repro_torch.core import metric
    from repro_torch.kernels import build
    out = dict(ptxas=ptxas_by_kernel(
        build.build_all(["emit_pairs"])["emit_pairs"][1],
        "emit_pairs_kernel"))
    for name, (d, eps) in EMIT_CELLS.items():
        pts = syn(2_000_000, d)
        calls = recorded_emits(
            lambda: repro_torch.self_join(pts, eps, device=DEVICE))
        out[name] = emit_times(calls)
        del calls
        torch.cuda.empty_cache()
    mat, _, _ = jaccard_data(JACCARD_POINTS, JACCARD_VOCAB)
    canon = metric.canonicalize(mat, JACCARD_T, metric="jaccard",
                                vocab=JACCARD_VOCAB)
    out["jaccard_100k_sets"] = emit_times(recorded_emits(
        lambda: repro_torch.self_join(canon, None, device=DEVICE)), reps=2)
    return out


def kernel_times() -> dict:
    """B3, B1 (e), B2, B1 (b), B4 and B1's self-join launches alone, from
    the ``repro_torch`` first on ``sys.path``: B3 by CUDA events on the
    main path's 2,000,000 points (f64) and on uniform-2d's 100,000 at f64,
    float16 and bfloat16; B1 (e) by events on the launches of the
    100,000-set Jaccard join (run loop), back to back; B2 on uniform-2d's
    brute sweep (391 launches of 256 rows) at f64, float16 and bfloat16,
    with eps built once by the package's ``metric.scalar_as``: its device
    time by name under the profiler, the sweep's time by events, and
    ``brute_force_count``'s time by the host clock; B1 (b) on the first
    request of the serve phase on index A and on index B
    (``b1_launch_times``); B4 on the unfused sweep's launches of the main
    path at f64 and float16 and of uniform-2d at bfloat16 (``b4_times``);
    B1 (c), (a), (d), f16, a wide class and the bench workloads' launches
    (``b1_times``) with the self-join kernel's ptxas registers and spills.
    Each with its integers (totals; B2's hit positions' checksum; B1's and
    B4's checksums), so two versions can be seen to agree; and
    ``sync_check`` of the package's wrappers."""
    import repro_torch
    from repro_torch.core import metric, selfjoin as sj
    from repro_torch.kernels import build, distance_tile as dt
    from repro_torch.kernels import fused_join as fj
    t0 = time.perf_counter()
    built = build.build_all()
    out = dict(package=str(Path(repro_torch.__file__).resolve().parents[1]),
               build_s=time.perf_counter() - t0,
               b2_ptxas=ptxas_by_kernel(built["distance_tile"][1],
                                        B2_KERNEL))

    def b3(pts, eps, reps):
        counts = dt.distance_tile_counts(pts, eps)               # warm-up
        runs = [event_ms(lambda: dt.distance_tile_counts(pts, eps))
                for _ in range(reps)]
        return dict(ms=statistics.median(runs), runs_ms=runs,
                    total=int(counts.sum(dtype=torch.int64)))

    out["b3_2m_float64"] = b3(torch.as_tensor(
        syn(MAIN_POINTS, MAIN_DIMS)).to(DEVICE), MAIN_EPS, 3)
    raw, eps = bench_workloads()["uniform-2d"]
    for dname, dtype in (("float64", torch.float64),
                         ("float16", torch.float16),
                         ("bfloat16", torch.bfloat16)):
        p = as_half(raw, dtype).to(DEVICE)
        out[f"b3_100k_{dname}"] = b3(p, eps, 5)
        eps_t = metric.scalar_as(eps, dtype, DEVICE)
        b2 = b2_times(p, eps_t, library=False)
        total, checksum = b2_checksum(p, eps_t)
        runs = []
        for _ in range(4):                    # the first is the warm-up
            t1 = time.perf_counter()
            count = repro_torch.brute_force_count(p, eps,
                                                  distance_impl="pallas",
                                                  device=DEVICE)
            runs.append(time.perf_counter() - t1)
        out[f"b2_100k_{dname}"] = dict(
            device_ms=b2["device_ms"], events_ms=b2["events_ms"],
            launches=b2["launches"], total=total, checksum=checksum,
            brute_count_s=statistics.median(runs[1:]),
            brute_count_runs_s=runs[1:], brute_total=count)
    mat, _, _ = jaccard_data(JACCARD_POINTS, JACCARD_VOCAB)
    canon = metric.canonicalize(mat, JACCARD_T, metric="jaccard",
                                vocab=JACCARD_VOCAB)
    prepared = jaccard_launches(canon, sj._metric_grid(canon, DEVICE),
                                run_loop=True)
    total = sum(int(fj.fused_join_hits(
        *p["args"], method="kernel", **_loop_kw(p, True), **p["kw"])[1]
        .sum(dtype=torch.int64)) for p in prepared)
    runs = [timed_launches(prepared, "kernel", run_loop=True, reps=2)
            for _ in range(3)]
    out["b1e_100k_sets"] = dict(ms=statistics.median(runs), runs_ms=runs,
                                launches=len(prepared), total=total)
    del prepared, canon
    # B1 (b): the first request of the serve phase on index A and on index B
    from repro_torch.launch import serve
    pts = syn(MAIN_POINTS, MAIN_DIMS)
    request = serve_requests(1, np.random.default_rng(21))[0]
    svc = serve.JoinService(pts, MAIN_EPS, return_pairs=True, device=DEVICE)
    out["b1b_index_a"] = b1_launch_times(external_launches(svc.prepared,
                                                           request))
    del svc
    skew = serve.JoinService(expo(SKEW_POINTS, 3), SKEW_EPS,
                             return_pairs=True, device=DEVICE)
    request = np.split(expo(SKEW_REQUESTS * SERVE_BATCH, 3, seed=7),
                       SKEW_REQUESTS)[0]
    out["b1b_index_b"] = b1_launch_times(external_launches(skew.prepared,
                                                           request))
    del skew
    # B4: the main path's unfused sweep at f64 and f16, uniform-2d's at bf16
    out["b4_main_float64"] = b4_times(torch.as_tensor(pts).to(DEVICE),
                                      MAIN_EPS)
    out["b4_main_float16"] = b4_times(
        as_half(pts, torch.float16).to(DEVICE), MAIN_EPS)
    out["b4_uniform2d_bfloat16"] = b4_times(
        as_half(raw, torch.bfloat16).to(DEVICE), eps)
    out["b1"] = b1_times()
    out["b1_ptxas"] = ptxas_by_kernel(built["fused_join"][1], B1_KERNEL)
    out["emit"] = emit_cell_times()
    out["syncs"] = sync_check()
    return out


def e2e_times() -> dict:
    """The paths around this round's kernels, from the ``repro_torch`` first
    on ``sys.path``, so that two versions can be compared in one call in
    turns (``--e2e-times [SRC]``): B1 (c) and (a) on the main path's
    launches and B1 (d) on slab 1 of the 4-slab join (CUDA events over
    back-to-back passes, median of three); the main path's joins through
    "pallas" (B4) and "fused" (host clock ending in a synchronize, median
    of three after a warm-up); and serving on index A, 64 requests of
    1,024 queries, with pairs and counts only (the services' p50 and p99)."""
    import repro_torch
    from repro_torch.core import distributed as dist
    from repro_torch.launch import serve
    pts, eps = syn(MAIN_POINTS, MAIN_DIMS), MAIN_EPS
    index = repro_torch.build_grid(pts, eps, device=DEVICE)
    prepared = prepared_launches(index, merged=True, unicomp=True,
                                 run_loop=True)
    out = {key: statistics.median(timed_launches(prepared, "kernel", loop)
                                  for _ in range(3))
           for key, loop in (("b1c_ms", True), ("b1a_ms", False))}
    del index, prepared
    slab, = [s_ for s_ in dist.slab_indexes(pts, eps, SLAB_HELD[0],
                                            device=DEVICE)
             if s_.slab == SLAB_HELD[1]]
    gid = prepared_launches(slab.index, merged=True, unicomp=True,
                            run_loop=True, slab=slab)
    out["b1d_ms"] = statistics.median(timed_launches(gid, "kernel", True)
                                      for _ in range(3))
    del slab, gid
    for impl in ("pallas", "fused"):
        def join(impl=impl):
            return repro_torch.self_join(pts, eps, distance_impl=impl,
                                         device=DEVICE)
        join()
        sync()
        runs = [_host_s(join) for _ in range(3)]
        out[f"{impl}_join_s"] = statistics.median(runs)
        out[f"{impl}_join_runs_s"] = runs
    requests = serve_requests(SERVE_REQUESTS, np.random.default_rng(21))
    svc = serve.JoinService(pts, eps, return_pairs=True, device=DEVICE)
    counts_svc = serve.JoinService(pts, eps, index=svc.index)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # warmup() marks steady
        for s_ in (svc, counts_svc):
            s_.warmup(SERVE_BATCH)
    for s_, key in ((svc, "serve"), (counts_svc, "serve_counts")):
        for q in requests:
            s_.query(q)
        out[f"{key}_p50_ms"], out[f"{key}_p99_ms"] = s_.percentiles()
    out["package"] = str(Path(repro_torch.__file__).resolve().parents[1])
    return out


# --- the routes phase -------------------------------------------------------

# Every count route of self_join_count; "dense", "sparse" and "jnp" report
# the same counters (and the merged / per-cell and run-loop variants too),
# "compact" reports cells_visited 0.
COUNT_ROUTES = ("dense", "dense-run", "dense-flat", "sparse", "sparse-flat",
                "compact", "jnp")
BENCH_ROUTES = ("dense", "sparse", "sparse-flat", "dense-flat")
SKEW_ROUTES = ("sparse", "dense")
# B1's other query tiles, seeded into a table of their own
OTHER_TILES = (64, 256)


TABLE_ENV = ("REPRO_TORCH_AUTOTUNE_CACHE", "REPRO_TORCH_AUTOTUNE")


@contextlib.contextmanager
def pinned_tables():
    """The whole run reads an empty measured table in a temporary directory
    with measuring off, whatever the caller's environment says, so B1's
    tile is the default and ``route=None`` takes the heuristic, and nothing
    is written into the tree. Yields the directory, where the ``routes``
    phase writes its own tables; it is removed at the end."""
    import os
    import tempfile
    saved = {k: os.environ.get(k) for k in TABLE_ENV}
    with tempfile.TemporaryDirectory(prefix="routes-") as d:
        path = Path(d) / "empty.json"
        path.write_text(json.dumps({"__schema__": 3}))
        os.environ[TABLE_ENV[0]] = str(path)
        os.environ[TABLE_ENV[1]] = "0"
        try:
            yield Path(d)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


@contextlib.contextmanager
def recorded_tiles():
    """The query tiles of the B1 launches the drivers make inside the
    block, as they pass them to ``ops.fused_join_hits``."""
    from repro_torch.kernels import ops
    tiles = set()
    orig = ops.fused_join_hits

    def record(*args, **kw):
        tiles.add(kw["tq"])
        return orig(*args, **kw)

    ops.fused_join_hits = record
    try:
        yield tiles
    finally:
        ops.fused_join_hits = orig


@contextlib.contextmanager
def route_table(table_dir: Path, rows=None, measure: bool = False):
    """The port reads its measured table from ``table_dir`` (with ``rows``)
    and measures when ``measure``; never from or into the tree."""
    import os

    from repro_torch.kernels import autotune
    path = table_dir / f"table{len(list(table_dir.iterdir()))}.json"
    path.write_text(json.dumps(dict(rows or {}, __schema__=3)))
    saved = {k: os.environ.get(k) for k in TABLE_ENV}
    os.environ[TABLE_ENV[0]] = str(path)
    os.environ[TABLE_ENV[1]] = "1" if measure else "0"
    autotune._CACHE.reset()
    try:
        yield path
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune._CACHE.reset()


def counters(s) -> tuple:
    return (s.cells_visited, s.candidates_checked)


def timed_count(pts, eps, index, route: str, reps: int = 3):
    """(stats, median ms by CUDA events) of ``self_join_count`` on one
    route, after a warm call; the count reads its totals back, so the
    events span its whole work."""
    import repro_torch
    stats = repro_torch.self_join_count(pts, eps, index=index, route=route,
                                        device=DEVICE)
    runs = [event_ms(lambda: repro_torch.self_join_count(
        pts, eps, index=index, route=route, device=DEVICE))
        for _ in range(reps)]
    return stats, statistics.median(runs), runs


def routes_on(pts, eps, index, routes, where: str, want=None) -> dict:
    """Each route's stats and time on one index; totals equal ``want`` (or
    each other) and the counters as the routes' contract says."""
    out = {}
    for route in routes:
        stats, ms, runs = timed_count(pts, eps, index, route)
        check(stats.route == route, f"{where}: route {route} labelled "
              f"{stats.route}")
        out[route] = dict(stats=stats, ms=ms, runs_ms=runs)
    totals = {r: v["stats"].total_pairs for r, v in out.items()}
    want = next(iter(totals.values())) if want is None else want
    check(all(t == want for t in totals.values()),
          f"{where}: route totals {totals}, expected {want}")
    ref = next(counters(v["stats"]) for r, v in out.items()
               if r != "compact")
    for r, v in out.items():
        if r == "compact":
            check(v["stats"].cells_visited == 0, f"{where}: compact "
                  f"visited {v['stats'].cells_visited} cells")
        else:
            check(counters(v["stats"]) == ref, f"{where}: route {r}'s "
                  f"counters {counters(v['stats'])} differ from {ref}")
    return out


def default_route(pts, eps, index) -> dict:
    """``route=None``'s label and the join's sweep with the table empty."""
    import repro_torch
    from repro_torch.core import selfjoin as sj
    s = repro_torch.self_join_count(pts, eps, index=index, device=DEVICE)
    merged = sj._join_sweep_merged(index, unicomp=True, bucketed=None,
                                   merged=sj._resolve_merge(index, None))
    return dict(route=s.route, join_merged=merged,
                total_pairs=s.total_pairs)


def b1_other_tiles(index, pts, eps, table_dir: Path) -> dict:
    """B1 at tq 64 and 256 against its plain version, bit for bit: the main
    path's launches as the drivers schedule them with a seeded tile row for
    each of its classes (row and run loop), and one external request of
    SERVE_BATCH queries (tq 64 through the service's table; 256, above the
    service's clamp, by the request's launches run at that tile). Times by
    events beside the default tile's."""
    import repro_torch
    from repro_torch.core import query_join as qj
    from repro_torch.core import selfjoin as sj
    from repro_torch.kernels import autotune
    from repro_torch.kernels import fused_join as fj
    caps = sorted({ln[4] for ln in sj._fused_launches(index,
                                                      merged=True)[0]})
    q = serve_requests(1, np.random.default_rng(5))[0]
    out = {}
    for tq in OTHER_TILES:
        rows = {autotune.tile_key(DEVICE.type, MAIN_DIMS, c):
                {"tq": tq, "ms": {}} for c in caps}
        with route_table(table_dir, rows):
            prepared = prepared_launches(index, merged=True, unicomp=True,
                                         run_loop=True)
            tiles = sorted({p["kw"]["tq"] for p in prepared})
            check(tiles == [tq], f"seeded tile {tq}: launches at {tiles}")
            worst = max(compare_kernel_and_plain(prepared, True, True),
                        compare_kernel_and_plain(prepared, True, False),
                        compare_kernel_and_plain(prepared, False, True))
            fj.KERNEL_LAUNCHES = 0
            total = repro_torch.self_join_count(
                pts, eps, index=index, route="dense-run",
                device=DEVICE).total_pairs
            launched = fj.KERNEL_LAUNCHES
            check(total == MAIN_TOTAL and launched == len(prepared),
                  f"tq {tq}: dense-run total {total}, {launched} launches")
            run_ms = timed_launches(prepared, "kernel", True)
            row_ms = timed_launches(prepared, "kernel", False)
            pj = qj.prepare(index)
            launches = external_launches(pj, q)
            for p in launches:
                p["kw"] = dict(p["kw"], tq=tq)
            held = [p for p in launches if p["args"][1].shape[0] % tq == 0]
            check(held, f"tq {tq}: no external launch divides the tile")
            ext_worst = compare_external(held)
        check(worst == 0 and ext_worst == 0, f"B1 at tq {tq} differs from "
              f"its plain version by {worst} (self) / {ext_worst} "
              f"(external)")
        out[str(tq)] = dict(launches=len(prepared), caps=caps,
                            max_abs_err=max(worst, ext_worst),
                            run_loop_ms=run_ms, row_loop_ms=row_ms,
                            external_launches=len(held),
                            service_tiles=sorted(set(pj.tiles.values())))
    prepared = prepared_launches(index, merged=True, unicomp=True,
                                 run_loop=True)
    tiles = sorted({p["kw"]["tq"] for p in prepared})
    check(tiles == [autotune.DEFAULT_TQ], f"the pinned empty table gives "
          f"launches at {tiles}")
    out[str(autotune.DEFAULT_TQ)] = dict(launches=len(prepared),
                      run_loop_ms=timed_launches(prepared, "kernel", True),
                      row_loop_ms=timed_launches(prepared, "kernel", False))
    return out


def measured_choices(index, table_dir: Path) -> dict:
    """With measuring on, into a table in ``table_dir``: the routes raced on
    the main path's index (merged sweep) and B1's tile for each of its
    classes, each candidate's ms and the winner (refused tiles named)."""
    from repro_torch.core import selfjoin as sj
    from repro_torch.kernels import autotune
    caps = sorted({ln[4] for ln in sj._fused_launches(index,
                                                      merged=True)[0]})
    with route_table(table_dir, measure=True) as path:
        route = sj._auto_route_uncached(index, unicomp=True, merged=True)
        tiles = {c: autotune.fused_tile(MAIN_DIMS, c, backend=DEVICE.type)
                 for c in caps}
        table = json.loads(path.read_text())
    rows = {k: v for k, v in table.items() if k != "__schema__"}
    route_rows = [v for k, v in rows.items() if k.startswith("route/")]
    check(len(route_rows) == 1 and route_rows[0]["route"] == route,
          f"measured route {route} not in the table {sorted(rows)}")
    for c, tq in tiles.items():
        row = rows[autotune.tile_key(DEVICE.type, MAIN_DIMS, c)]
        check(int(row["tq"]) == tq and str(tq) in row["ms"],
              f"measured tile row for c {c}: {row}")
        for t, why in row.get("refused", {}).items():
            print(f"routes: tile {t} at c {c} refused by B1's wrapper: "
                  f"{why}", flush=True)
    return dict(route=route, route_ms=route_rows[0]["ms"],
                tiles={str(c): rows[autotune.tile_key(DEVICE.type, MAIN_DIMS,
                                                      c)]
                       for c in tiles})


def phase_routes(workloads, table_dir: Path) -> dict:
    """Every count route on the main path, the bench workloads and index B
    against the recorded totals, the default route and sweep with the
    table empty, the measured choices, and B1 at its other tiles; the
    tables go into ``table_dir`` (``pinned_tables``)."""
    import repro_torch
    from repro_torch.kernels import fused_join as fj
    t_phase = time.perf_counter()
    pts, eps = syn(MAIN_POINTS, MAIN_DIMS), MAIN_EPS
    with route_table(table_dir):
        index = repro_torch.build_grid(pts, eps, device=DEVICE)
        default = {"main_path": default_route(pts, eps, index)}
        check(default["main_path"]["route"] == "dense"
              and default["main_path"]["join_merged"],
              f"main path: route=None gives {default['main_path']}, not "
              f"'dense' and merged")
        launched = {}
        for route in ("dense", "sparse", "jnp"):
            fj.KERNEL_LAUNCHES = 0
            repro_torch.self_join_count(pts, eps, index=index, route=route,
                                        device=DEVICE)
            launched[route] = fj.KERNEL_LAUNCHES
        check(launched["dense"] > 0 and launched["sparse"] == 0
              == launched["jnp"], f"B1 launches by route {launched}")
        main = routes_on(pts, eps, index, COUNT_ROUTES, "main path",
                         MAIN_TOTAL)
        bench = {}
        for name, (bpts, beps) in workloads.items():
            bidx = repro_torch.build_grid(bpts, beps, device=DEVICE)
            default[name] = default_route(bpts, beps, bidx)
            bench[name] = routes_on(bpts, beps, bidx, BENCH_ROUTES, name,
                                    BENCH_TOTALS[name])
            check(default[name]["total_pairs"] == BENCH_TOTALS[name],
                  f"{name}: route=None total {default[name]}")
        skew_pts = expo(SKEW_POINTS, 3)
        sidx = repro_torch.build_grid(skew_pts, SKEW_EPS, device=DEVICE)
        default["index_b"] = default_route(skew_pts, SKEW_EPS, sidx)
        skew = routes_on(skew_pts, SKEW_EPS, sidx, SKEW_ROUTES, "index B")
        check(default["index_b"]["total_pairs"]
              == skew["dense"]["stats"].total_pairs,
              f"index B: route=None total {default['index_b']}")
        del sidx
    measured = measured_choices(index, table_dir)
    tiles = b1_other_tiles(index, pts, eps, table_dir)
    emit("routes", points=MAIN_POINTS, eps=eps, default_routes=default,
         b1_launches_by_route=launched,
         main_path={r: dict(total_pairs=v["stats"].total_pairs,
                            offsets=v["stats"].offsets,
                            cells_visited=v["stats"].cells_visited,
                            candidates_checked=v["stats"].candidates_checked,
                            ms=v["ms"], runs_ms=v["runs_ms"])
                    for r, v in main.items()},
         bench={n: {r: dict(ms=v["ms"], offsets=v["stats"].offsets)
                    for r, v in b.items()} for n, b in bench.items()},
         index_b=dict(points=SKEW_POINTS, eps=SKEW_EPS,
                      total_pairs=skew["dense"]["stats"].total_pairs,
                      **{r: dict(ms=v["ms"]) for r, v in skew.items()}),
         measured=measured, b1_tiles=tiles,
         phase_s=time.perf_counter() - t_phase)
    return dict(b1_tiles=tiles)


# --- the collective slab join, sharded serving, dedup (ROADMAP A14 (ii), A15)

# The collective slab join: the main path's points through gloo ranks that
# share the one card (NCCL needs a card a rank), each rank joining its slab
# there; every spawn stops its ranks after COLLECTIVE_TIMEOUT_S.
COLLECTIVE_RANKS = (2, 4)
COLLECTIVE_GRID = (2, 2)   # (slab, model) on the 4 ranks: the offset-parallel count
COLLECTIVE_TIMEOUT_S = 240.0
# the sharded services: index A's points cut into this many slabs
SHARDED_SLABS = 4
# dedup: raw 6-D embeddings (random directions) with planted scaled and
# noisy copies of earlier rows, a zero row and a NaN row, at a cosine floor
# far above what random directions reach
DEDUP_POINTS, DEDUP_DIMS, DEDUP_COS, DEDUP_SEED = 1_000_000, 6, 0.9999, 23
DEDUP_SCALED = DEDUP_NOISY = 10_000
DEDUP_NOISE = 1e-5
EXAMPLES = ("torch_quickstart", "torch_serve_join", "torch_dedup_pipeline")


def collective_spawn(grids, pts, eps: float) -> tuple[list, dict]:
    """Each rank's ``mesh.run_rank`` result over ``grids`` ((n_slabs,
    n_model, steps) meshes of the same ranks) and the spawn's wall seconds
    (start-up, the ranks' work, shut-down), checked against the
    one-process slab join (``check=True``)."""
    from repro_torch.launch import mesh
    n_ranks = grids[0][0] * grids[0][1]
    t0 = time.time()
    ranks = mesh.spawn(mesh.run_rank, n_ranks, grids, DEVICE, pts, eps,
                       True, device=DEVICE, timeout_s=COLLECTIVE_TIMEOUT_S)
    t1 = time.time()
    for k, (n_slabs, n_model, steps) in enumerate(grids):
        where = f"collective ({n_slabs}, {n_model})"
        done = [r["grids"][k] for r in ranks]
        for r in done:
            for step in steps:
                check(r[step]["value"] == MAIN_TOTAL, f"{where} slab "
                      f"{r['slab']} model {r['model']} {step}: "
                      f"{r[step]['value']}, recorded {MAIN_TOTAL}")
            check(r["blocks_equal"], f"{where}: a rank's candidate block "
                  f"differs from the one-process exchange's")
        if "pairs" in steps:
            check(done[0]["pairs_equal"], f"{where}: rank 0's gathered "
                  f"pairs differ from the one-process slab join's")
            gid = sum(r["pairs"]["gid_launches"] for r in done)
            check(gid == done[0]["one_process_gid_launches"] > 0,
                  f"{where}: B1 (d) launches {gid} over the ranks, "
                  f"{done[0]['one_process_gid_launches']} in one process")
    wall = dict(spawn_s=t1 - t0,
                start_s=max(r["entered_at"] for r in ranks) - t0,
                work_s=(max(r["left_at"] for r in ranks)
                        - min(r["entered_at"] for r in ranks)),
                stop_s=t1 - max(r["left_at"] for r in ranks))
    return ranks, wall


def phase_collective() -> dict:
    """The collective slab join on the card (``launch.mesh.spawn``,
    ``core.distributed`` on a ``SlabMesh``; ROADMAP A14 (ii)): the main
    path at each rank count of COLLECTIVE_RANKS, and the last spawn's ranks
    again as the COLLECTIVE_GRID (slab, model) grid."""
    from repro_torch.launch import mesh
    t_phase = time.perf_counter()
    pts, eps = syn(MAIN_POINTS, MAIN_DIMS), MAIN_EPS
    torch.cuda.empty_cache()        # the ranks share the card
    cards = torch.cuda.device_count()
    steps = ("pairs", "count_only", "plain_count")
    gid = {}
    for n in COLLECTIVE_RANKS:
        grids = [(n, 1, steps)]
        if n == COLLECTIVE_GRID[0] * COLLECTIVE_GRID[1]:
            grids.append((*COLLECTIVE_GRID, ("count_only", "plain_count")))
        ranks, wall = collective_spawn(grids, pts, eps)
        for k, (n_slabs, n_model, done) in enumerate(grids):
            per = [r["grids"][k] for r in ranks]
            if "pairs" in done:
                gid[n] = sum(r["pairs"]["gid_launches"] for r in per)
            emit("collective", part=f"{n_slabs}x{n_model}",
                 points=MAIN_POINTS, eps=eps,
                 backend=mesh.choose_backend(n, DEVICE),
                 devices=sorted({r["device"] for r in ranks}),
                 gid_launches=gid.get(n) if "pairs" in done else None,
                 one_process_gid_launches=per[0].get(
                     "one_process_gid_launches"),
                 ranks=[{key: r[key] for key in ("slab", "model",
                                                  "partition_exchange_s",
                                                  *done)}
                        for r in per], **wall)
    most = max(COLLECTIVE_RANKS)
    if cards < most:
        print(f"nccl: not run ({cards} card{'s' if cards != 1 else ''})",
              flush=True)
    emit("collective", part="done", cards=cards,
         nccl="run" if cards >= most else "not run",
         phase_s=time.perf_counter() - t_phase)
    return dict(gid_launches=gid[most])


def phase_sharded() -> dict:
    """The slab-sharded services on the card (ROADMAP A14 (ii)): index A at
    SHARDED_SLABS slabs against the single-index service, with pairs and
    counts only, the batching service over the slabs, and the serve CLI
    and load generator with ``--slabs``."""
    from repro_torch.kernels import fused_join as fj
    from repro_torch.launch import loadgen, serve
    t_phase = time.perf_counter()
    rng = np.random.default_rng(21)
    pts, eps = syn(MAIN_POINTS, MAIN_DIMS), MAIN_EPS
    requests = serve_requests(SERVE_REQUESTS, rng)
    t0 = time.perf_counter()
    sharded = serve.ShardedJoinService(pts, eps, SHARDED_SLABS,
                                       return_pairs=True, device=DEVICE)
    sync()
    build_s = time.perf_counter() - t0
    counts_sh = serve.ShardedJoinService(pts, eps, SHARDED_SLABS,
                                         device=DEVICE)
    bat = serve.BatchingJoinService(pts, eps, n_slabs=SHARDED_SLABS,
                                    return_pairs=True, max_batch=4096,
                                    device=DEVICE)
    single = serve.JoinService(pts, eps, return_pairs=True, device=DEVICE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # warmup() marks steady
        for s_ in (sharded, counts_sh, single):
            s_.warmup(SERVE_BATCH)
        bat.warmup()
    want = [single.prepared.join(q) for q in requests]
    expected = sum(len(pj.launch_inputs(q)[1]) for q in requests
                   for pj in sharded.prepared)
    sync()
    fj.KERNEL_LAUNCHES = fj.EXTERNAL_LAUNCHES = 0
    got = [sharded.query(q) for q in requests]
    launches = (fj.KERNEL_LAUNCHES, fj.EXTERNAL_LAUNCHES)
    check(launches == (expected,) * 2, f"the sharded service launched B1 "
          f"(total, external) {launches} times, planned {expected}")
    for w, g in zip(want, got):
        same_answer(w, g, "sharded")
    p50, p99 = sharded.percentiles()
    rps = sharded.requests_per_sec()
    for q, w in zip(requests, want):
        res = counts_sh.query(q)
        check(res.pairs is None and np.array_equal(res.counts, w.counts),
              "sharded counts-only service: counts differ")
    c50, c99 = counts_sh.percentiles()
    tickets = [bat.submit(q) for q in requests]
    t0 = time.perf_counter()
    bat.pump()
    bat.drain()
    bat_wall = time.perf_counter() - t0
    for w, t in zip(want, tickets):
        same_answer(w, t.result(), "sharded batching")
    for s_ in (sharded, counts_sh, bat):
        s_.assert_no_retrace()
    slab_rows = [int(i.num_points) for i in sharded.indexes]
    bat_launches = bat.n_launches
    del sharded, counts_sh, bat, single, want, got
    # the command lines, at their default sizes, last: they prepare new
    # services and move the process-wide counters
    cli_p50 = serve.main(["--arch", "selfjoin", "--slabs",
                          str(SHARDED_SLABS), "--return-pairs", "--device",
                          str(DEVICE)])
    rep = loadgen.main(["--slabs", str(SHARDED_SLABS), "--device",
                        str(DEVICE)])
    emit("sharded", points=MAIN_POINTS, eps=eps, slabs=SHARDED_SLABS,
         slab_rows=slab_rows, requests=SERVE_REQUESTS,
         request_queries=SERVE_BATCH, build_s=build_s, launches=launches[1],
         p50_ms=p50, p99_ms=p99, requests_per_s=rps, counts_only_p50_ms=c50,
         counts_only_p99_ms=c99, equal_to_single_index=True,
         batching=dict(launches=bat_launches, wall_s=bat_wall,
                       requests_per_s=len(tickets) / bat_wall,
                       equal_to_single_index=True),
         cli_p50_ms=cli_p50, loadgen=rep.to_dict(),
         phase_s=time.perf_counter() - t_phase)
    return dict(launches=launches[1])


def dedup_data():
    """(embeddings, the planted copies' rows, their sources' rows)."""
    rng = np.random.default_rng(DEDUP_SEED)
    emb = rng.normal(size=(DEDUP_POINTS, DEDUP_DIMS))
    n_copies = DEDUP_SCALED + DEDUP_NOISY
    copies = rng.choice(np.arange(DEDUP_POINTS // 2, DEDUP_POINTS - 2),
                        n_copies, replace=False)
    sources = rng.integers(0, DEDUP_POINTS // 2, n_copies)
    scale = rng.uniform(0.2, 5.0, (n_copies, 1))
    noise = np.zeros((n_copies, DEDUP_DIMS))
    noise[DEDUP_SCALED:] = rng.normal(size=(DEDUP_NOISY, DEDUP_DIMS))
    src = emb[sources]
    emb[copies] = scale * (src + DEDUP_NOISE * np.linalg.norm(
        src, axis=1, keepdims=True) * noise)
    emb[-2] = 0.0                               # an encoder's timeout
    emb[-1] = np.nan                            # an encoder's overflow
    return emb, copies, sources


def phase_dedup() -> dict:
    """``repro_torch.data.dedup_embeddings`` at 1 M raw embeddings (ROADMAP
    A15) against scipy's connected components over the join's pairs, and
    the three torch examples on the card."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    import repro_torch
    from repro_torch.data import dedup
    from repro_torch.kernels import fused_join as fj
    t_phase = time.perf_counter()
    emb, copies, sources = dedup_data()
    sync()
    fj.KERNEL_LAUNCHES = fj.RUN_LOOP_LAUNCHES = 0
    t0 = time.perf_counter()
    keep, valid = dedup.dedup_embeddings(emb, min_cos=DEDUP_COS,
                                         device=DEVICE)
    sync()
    dedup_s = time.perf_counter() - t0
    launches, run_loop = fj.KERNEL_LAUNCHES, fj.RUN_LOOP_LAUNCHES
    check(launches > 0, "dedup launched no B1")
    bad = np.flatnonzero(~valid)
    check(bad.tolist() == [DEDUP_POINTS - 2, DEDUP_POINTS - 1]
          and keep[bad].all(), f"the guard flagged rows {bad[:8]}")
    check(not keep[copies].any(), f"{int(keep[copies].sum())} planted "
          f"copies kept")
    # the keep mask, independently: i is kept iff it is the smallest id of
    # its connected component under the join's pairs
    idx = np.flatnonzero(valid)
    pairs = repro_torch.self_join(emb[idx], DEDUP_COS, metric="cosine",
                                  device=DEVICE).cpu().numpy()
    n = idx.size
    graph = sp.coo_matrix((np.ones(pairs.shape[0], np.int8),
                           (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    n_comp, labels = connected_components(graph, directed=False)
    root = np.full(n_comp, n)
    np.minimum.at(root, labels, np.arange(n))
    want = np.ones(DEDUP_POINTS, bool)
    want[idx] = root[labels] == np.arange(n)
    check(np.array_equal(keep, want), f"keep differs from scipy's "
          f"component roots in {int((keep != want).sum())} rows")
    kept = np.flatnonzero(keep & valid)
    left = repro_torch.self_join(emb[kept], DEDUP_COS, metric="cosine",
                                 device=DEVICE)
    check(left.shape[0] == 0, f"{left.shape[0]} pairs left among the kept "
          f"rows")
    # the examples, started together
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {e: subprocess.Popen([sys.executable,
                                  str(ROOT / "examples" / f"{e}.py"),
                                  "--device", str(DEVICE)],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for e in EXAMPLES}
    examples = {}
    for e, proc in procs.items():
        log, _ = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"example {e} failed:\n{log[-2000:]}")
        examples[e] = log.strip().splitlines()[-1]
    examples_s = time.perf_counter() - t0
    emit("dedup", points=DEDUP_POINTS, dims=DEDUP_DIMS, min_cos=DEDUP_COS,
         planted=int(copies.size), guarded=bad.tolist(),
         kept=int(keep.sum()), join_pairs=int(pairs.shape[0]),
         components=int(n_comp), dedup_s=dedup_s, launches=launches,
         run_loop_launches=run_loop,
         examples=examples, examples_s=examples_s,
         phase_s=time.perf_counter() - t_phase)
    return dict(launches=launches)


# --- analysis: the sanitized kernel mode and the contract prover (A13) ------

ANALYSIS_TURNS = 2     # (unsanitized, sanitized, sanitized, unsanitized) each


@contextlib.contextmanager
def sanitized(flag: bool):
    """Sanitized mode forced on or off inside the block; no code may be
    left pending at its end."""
    from repro_torch.analysis import sanitize
    sanitize.set_enabled(flag)
    try:
        yield
    finally:
        sanitize.set_enabled(None)
    check(sanitize.pending() == 0, "sanitizer codes left pending")


def raises_sanitizer(fn, bit: str) -> str:
    """Run ``fn`` sanitized, synchronise (a CUDA fault would raise here),
    and return the ``SanitizerError`` the drain raises, naming ``bit``."""
    from repro_torch.analysis import sanitize
    with sanitized(True):
        fn()
        sync()
        try:
            sanitize.raise_pending()
        except sanitize.SanitizerError as err:
            check(bit in str(err), f"the sanitizer raised {err}, not {bit}")
            return str(err)
    raise SmokeFailure(f"no SanitizerError for {bit}")


def phase_analysis() -> dict:
    """ROADMAP A13 on the card: the main path, index A's requests and the
    cosine and Jaccard joins in sanitized mode (``REPRO_TORCH_SANITIZE``),
    the sanitized wrapper under the sync debug mode, injected faults raised
    at the drain with the context intact, and the contract prover on
    indexes built on the card, with C6's limit against the card's."""
    import repro_torch
    from repro_torch.analysis import contracts, sanitize
    from repro_torch.analysis import findings as F
    from repro_torch.analysis.__main__ import (DEFAULT_BASELINE,
                                               collect_findings)
    from repro_torch.core import metric, selfjoin as sj
    from repro_torch.kernels import fused_join as fj, ops
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    pts, eps = syn(MAIN_POINTS, MAIN_DIMS), MAIN_EPS
    sanitize.clear()
    recorded = []
    record = sanitize.record
    sanitize.record = lambda label, code: (recorded.append(label),
                                           record(label, code))
    try:
        # the sanitized main path, counted alone, then timed in turns
        with sanitized(True):
            repro_torch.self_join(pts, eps, device=DEVICE)      # warm-up
            sync()
            recorded.clear()
            fj.KERNEL_LAUNCHES = fj.RUN_LOOP_LAUNCHES = 0
            pairs = repro_torch.self_join(pts, eps, device=DEVICE)
            launches = fj.KERNEL_LAUNCHES
            run_loop = fj.RUN_LOOP_LAUNCHES
            codes = len(recorded)
            check(pairs.shape[0] == MAIN_TOTAL, f"sanitized main path: "
                  f"{pairs.shape[0]} pairs, want {MAIN_TOTAL}")
            del pairs
            total = repro_torch.self_join_count(pts, eps, device=DEVICE)
            check(total.total_pairs == MAIN_TOTAL, f"sanitized count: "
                  f"{total.total_pairs}, want {MAIN_TOTAL}")
        check(launches > 0 and codes == launches, f"sanitized main path: "
              f"{launches} B1 launches, {codes} codes recorded")
        turns = {False: [], True: []}
        for _ in range(ANALYSIS_TURNS):
            for flag in (False, True, True, False):
                with sanitized(flag):
                    turns[flag].append(event_ms(
                        lambda: repro_torch.self_join(pts, eps,
                                                      device=DEVICE)))

        # the sanitized wrapper does not wait for the device
        index = repro_torch.build_grid(pts, eps, device=DEVICE)
        merged = sj._resolve_merge(index, None)
        prepared = prepared_launches(index, merged=merged, unicomp=True)
        with sanitized(True):
            for p in prepared:                     # loads, untimed
                ops.fused_join_hits(*p["args"], **p["kw"])
            sync()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for p in prepared:
                    ops.fused_join_hits(*p["args"], **p["kw"])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            sanitize.raise_pending()

        # index A's requests answer what they answer unsanitized
        requests = serve_requests(SERVE_REQUESTS, np.random.default_rng(21))
        svc = serve.JoinService(pts, eps, index=index, return_pairs=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # warmup() marks steady
            svc.warmup(SERVE_BATCH)
        plain = [svc.query(q) for q in requests]
        with sanitized(True):
            recorded.clear()
            served = [svc.query(q) for q in requests]
            served_codes = len(recorded)
        for a, b in zip(plain, served):
            same_answer(a, b, "sanitized index A")
        svc.assert_no_retrace()
        check(served_codes >= SERVE_REQUESTS, "the sanitized requests "
              "recorded no codes")
        del svc, plain, served

        # the cosine and Jaccard joins at the metric phase's sizes
        emb = cosine_data(COSINE_POINTS)
        mat, _, _ = jaccard_data(JACCARD_POINTS, JACCARD_VOCAB)
        jcanon = metric.canonicalize(mat, JACCARD_T, metric="jaccard",
                                     vocab=JACCARD_VOCAB)
        metric_pairs = {}
        for name, join, count in (
                ("cosine",
                 lambda: repro_torch.self_join(emb, COSINE_T,
                                               metric="cosine",
                                               device=DEVICE),
                 lambda: repro_torch.self_join_count(emb, COSINE_T,
                                                     metric="cosine",
                                                     device=DEVICE)),
                ("jaccard",
                 lambda: repro_torch.self_join(jcanon, None, device=DEVICE),
                 lambda: repro_torch.self_join_count(jcanon, None,
                                                     device=DEVICE))):
            with sanitized(True):
                recorded.clear()
                n = int(join().shape[0])
                check(recorded, f"sanitized {name}: no codes recorded")
            want = count().total_pairs
            check(n == want, f"sanitized {name}: {n} pairs, the count "
                  f"says {want}")
            metric_pairs[name] = n

        # injected faults: raised at the drain, the context left intact
        p = prepared[0]
        pp, qb, ws, wc = p["args"][:4]
        c = p["kw"]["c"]
        live = torch.nonzero(wc > 0)[0].tolist()
        bad_ws = ws.clone()
        bad_ws[live[0], live[1]] = pp.shape[0] + 4096
        oob = raises_sanitizer(lambda: ops.fused_join_hits(
            pp, qb, bad_ws, *p["args"][3:], **p["kw"]), "oob-gather")
        after = repro_torch.self_join(pts, eps, device=DEVICE)
        check(after.shape[0] == MAIN_TOTAL, f"after the injected gather "
              f"the main path gave {after.shape[0]} pairs")
        del after
        bad_wc = wc.clone()
        bad_wc[live[0], live[1]] = c + 1
        cap = raises_sanitizer(lambda: ops.fused_join_hits(
            pp, qb, ws, bad_wc, *p["args"][4:], **p["kw"]), "cap-overflow")
        canon = metric.canonicalize(emb[:200_000], COSINE_T,
                                    metric="cosine")
        cindex = sj._metric_grid(canon, DEVICE)
        cp = prepared_launches(cindex, merged=sj._resolve_merge(cindex,
                                                                None),
                               unicomp=True)[0]
        cq = cp["args"][1].clone()
        cq[0, :cindex.n_dims] *= 1.1
        unit = raises_sanitizer(lambda: ops.fused_join_hits(
            cp["args"][0], cq, *cp["args"][2:], metric="cosine",
            **cp["kw"]), "unnormalized-cosine")
        hits, counts, base = fj.fused_join_hits(*p["args"], **p["kw"])
        clean = int(fj.sanitize_errcodes(pp, qb, ws, wc, counts, base, hits,
                                         c=c, tq=p["kw"]["tq"],
                                         check_hits=True))
        check(clean == 0, f"a clean launch gave code {clean}")
        base = base.clone()
        base[5] += 1
        scan = int(fj.sanitize_errcodes(pp, qb, ws, wc, counts, base, hits,
                                        c=c, tq=p["kw"]["tq"],
                                        check_hits=True))
        check(scan == sanitize.E_SCAN_MISMATCH, f"a corrupted slot_base "
              f"gave {sanitize.decode(scan)}")
        del hits, counts, base, prepared, cindex
    finally:
        sanitize.record = record

    # the prover on indexes built on the card
    baseline = F.load_baseline(DEFAULT_BASELINE)
    t0 = time.perf_counter()
    canned = collect_findings(device=DEVICE)
    canned_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    main_found = (contracts.prove_index_contracts(index, tag="index:main")
                  + contracts.prove_halo_contracts(pts, eps, 4,
                                                   tag="halo:main"))
    prover_s = time.perf_counter() - t0
    fresh = F.new_findings(canned + main_found, baseline)
    check(not fresh, "new analysis findings: "
          + "; ".join(f.render() for f in fresh))
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    check(contracts.SMEM_OPTIN_H100 == optin == fj.smem_limit(DEVICE),
          f"C6's limit {contracts.SMEM_OPTIN_H100} B, the card's opt-in "
          f"{optin} B")
    unsan = statistics.median(turns[False])
    san = statistics.median(turns[True])
    emit("analysis", points=MAIN_POINTS, eps=eps, launches=launches,
         run_loop_launches=run_loop, codes=codes,
         unsanitized_ms=turns[False], sanitized_ms=turns[True],
         median_unsanitized_ms=unsan, median_sanitized_ms=san,
         sanitized_over_unsanitized=san / unsan,
         served_requests=SERVE_REQUESTS, served_codes=served_codes,
         metric_pairs=metric_pairs, injected={
             "oob-gather": oob, "cap-overflow": cap,
             "unnormalized-cosine": unit, "scan-mismatch": scan},
         canned_findings=len(canned), canned_s=canned_s,
         main_findings=len(main_found), prover_main_s=prover_s,
         smem_optin=optin, c6_limit=contracts.SMEM_OPTIN_H100,
         nvidia_smi=nvidia_smi_line(),
         phase_s=time.perf_counter() - t_phase)
    del index
    return dict(launches=launches)


# --- the LM substrate and the CPU baselines (ROADMAP A16, A17 (i)) -------------

LM_WEIGHT_SEED = 0       # seeded_params: numpy draws in JAX's distributions
LM_PROMPT_SEED = 1
LM_PIN_SHAPE = (4, 64)   # (batch, prompt) of the recorded teacher-forced pass
LM_MARGIN = 1e-3         # positions whose top-1 / top-2 margin is over this
LM_BF16_TOL = 0.15       # tests/test_models.py's band (rtol = atol)
LM_F32_TOL = 1e-4
LM_ARGMAX_AGREE = 0.95
LM_DECODE_SHAPE = (32, 16)   # (batch, prompt) of smoke-lm's decode check
LM_FAMILY_SHAPE = (2, 15)    # the families': at most 16 tokens a moe routing
                             # row, so no expert passes its 16 slots and the
                             # forward drops no token the decode keeps
LM_CPU_SHAPE = (4, 32)       # (batch, prompt) of the card-vs-CPU check
LM_CPU_STEPS = 8
# JAX's float32 forward of smoke-lm's full CONFIG over lm_pin_prompt() with
# seeded_params(LM_WEIGHT_SEED): per position, the argmax and the top-1 /
# top-2 margin (tests/test_torch_lm_serve.py recomputes both through JAX).
LM_ARGMAX = {
    "argmax": [
        [7333, 1768, 7223, 8045, 1686, 7001, 5195, 6663, 5195,
         7613, 2446, 6704, 5954, 2998, 2998, 7289, 3717, 728,
         3107, 7001, 1754, 7289, 2644, 2644, 1977, 6388, 7499,
         7366, 3221, 3001, 846, 7716, 741, 3615, 1957, 7001, 1728,
         5167, 7589, 6156, 4996, 5167, 6963, 7366, 3844, 6478,
         1369, 1614, 6831, 6809, 1369, 7294, 1957, 5167, 6193,
         5549, 6478, 1884, 7001, 3818, 7293, 5167, 6704, 7294],
        [1516, 581, 1046, 4094, 4094, 7726, 153, 7523, 8, 7523,
         1729, 8, 8070, 7026, 817, 7511, 817, 153, 5199, 1701,
         1911, 1911, 8, 530, 114, 3952, 7917, 3061, 342, 6975,
         4246, 4129, 1761, 7918, 5578, 4125, 5094, 1578, 2858,
         560, 7073, 7102, 5240, 5642, 2863, 6230, 3555, 7726,
         6495, 6209, 6341, 6590, 7563, 411, 6707, 3707, 3788,
         2165, 4383, 3555, 5199, 7207, 5230, 3683],
        [6741, 1967, 1387, 1027, 4239, 1143, 6076, 5930, 231,
         5930, 3426, 2581, 4706, 187, 5286, 1417, 1340, 5122,
         6009, 3426, 2909, 1513, 6695, 392, 4031, 6009, 1927,
         1891, 2509, 1891, 2783, 6240, 3731, 1027, 7694, 7461,
         6009, 3570, 6216, 5930, 4831, 6899, 6054, 4831, 4831,
         4173, 7461, 5930, 5286, 7539, 4831, 4831, 6268, 4536,
         229, 5067, 4831, 5409, 208, 7746, 2059, 6730, 370, 3749],
        [4444, 553, 2874, 5249, 3830, 6094, 6341, 6341, 3475,
         1734, 1384, 3475, 1853, 4193, 4408, 3599, 28, 1614, 5680,
         1449, 3480, 3020, 382, 6573, 6744, 7113, 1614, 4363,
         1900, 1900, 3550, 4509, 1449, 916, 1899, 2037, 1614,
         2559, 5382, 2559, 65, 5413, 3634, 2559, 2559, 4193, 2559,
         2559, 7091, 5656, 2559, 4193, 1900, 7619, 2559, 539,
         2559, 2559, 2559, 2559, 2449, 2559, 5382, 2559]],
    "margin": [
        [0.066274, 0.020443, 0.047534, 0.092013, 0.019018,
         0.026502, 0.197735, 0.077394, 0.073993, 0.01893, 0.00742,
         0.072712, 0.043975, 0.022429, 0.072779, 0.176717,
         0.031649, 0.262244, 0.080889, 0.055362, 0.019007,
         0.281211, 0.237687, 0.177845, 0.087271, 0.066854,
         0.058807, 0.05738, 0.014213, 0.147792, 0.040907,
         0.007549, 0.02259, 0.263667, 0.241156, 0.241314,
         0.165567, 0.04552, 0.02893, 0.062999, 0.123639, 0.225378,
         0.055038, 0.128746, 0.081654, 0.130699, 0.046153,
         0.007145, 0.054254, 0.087108, 0.268808, 0.01159,
         0.439552, 0.006536, 0.083816, 0.062939, 0.067374,
         0.009458, 0.018815, 0.047226, 0.01228, 0.088913,
         0.089757, 0.011962],
        [0.04216, 0.002722, 0.051715, 0.001017, 0.012639, 0.17785,
         0.085175, 0.246485, 0.026832, 0.304142, 0.139844,
         0.079118, 0.1554, 0.004167, 0.591803, 0.04055, 0.041155,
         0.145888, 0.084257, 0.013116, 0.021194, 0.145803,
         0.111095, 0.005992, 0.110576, 0.003166, 0.152657,
         0.045819, 0.008747, 0.158605, 0.179903, 0.036355,
         0.186412, 0.124464, 0.030886, 0.011328, 0.009437,
         0.033674, 9.2e-05, 0.111616, 0.120757, 0.221974, 0.01183,
         0.045068, 0.006772, 0.01593, 0.227923, 0.198971,
         0.018251, 0.220589, 0.039869, 0.002678, 0.028479,
         0.097903, 0.005829, 0.018211, 0.014447, 0.023226,
         0.134966, 0.173719, 0.030159, 0.01129, 0.238051, 0.005903],
        [0.003164, 0.066042, 0.036975, 0.033486, 0.014475,
         0.076976, 0.076753, 0.021638, 0.058737, 0.392102,
         0.032038, 0.044283, 0.035518, 0.035847, 0.3659, 0.08812,
         0.132397, 0.122689, 0.134372, 0.032321, 0.062685,
         0.004685, 0.000931, 0.049749, 0.001649, 0.056059,
         0.101068, 0.013902, 0.094507, 0.014674, 0.109974,
         0.09415, 0.017707, 0.088451, 0.025486, 0.036712,
         0.196489, 0.067879, 0.016256, 0.123595, 0.078617,
         0.046316, 0.029403, 0.059765, 0.199133, 0.106847,
         0.11061, 0.105569, 0.151376, 0.029388, 0.281781,
         0.099959, 0.014477, 0.19969, 0.021493, 0.18815, 0.0564,
         0.316204, 0.078883, 0.078567, 0.021324, 0.141496,
         0.011928, 0.000171],
        [0.01729, 0.045568, 0.019065, 0.060025, 0.023409,
         0.082487, 0.021628, 0.176362, 0.080238, 0.027846,
         0.058246, 0.016361, 0.01052, 0.016511, 0.030815,
         0.102091, 0.013546, 0.181631, 0.084347, 0.002861,
         0.163413, 0.019678, 0.054574, 0.219226, 0.214456,
         0.007389, 0.167962, 0.084348, 0.129858, 0.02055,
         0.190826, 0.108712, 0.144261, 0.02765, 0.012312,
         0.067778, 0.042535, 0.033432, 0.008023, 0.107666,
         0.047207, 0.016876, 0.012365, 0.064492, 0.005879,
         0.105336, 0.089755, 0.107291, 0.028857, 0.07292,
         0.114095, 0.281196, 0.045347, 0.229035, 0.027801,
         0.020261, 0.091235, 0.077077, 0.147653, 0.061847,
         0.024056, 0.023007, 0.149333, 0.177082]]}
# the CPU baselines on the bench's expo-3d at its smoke size (3,000 points,
# eps 1.2): the JAX package's self_join_count total (tests/test_torch_baselines.py
# recomputes it)
A16_POINTS = 3000
A16_EPS = 1.2
A16_TOTAL = 7220


def lm_pin_prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(LM_PROMPT_SEED).integers(0, vocab,
                                                          LM_PIN_SHAPE)


def argmax_margin(logits: np.ndarray):
    """Per row: the argmax and the top-1 / top-2 margin."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return logits.argmax(-1), top2[..., 1] - top2[..., 0]


def lm_decode_vs_forward(cfg, shape, seed: int = 2) -> dict:
    """Prefill then one decode step against the teacher-forced forward's
    last position (tests/test_models.py's check), on the card."""
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.lm import LMModel

    B, S = shape
    model = LMModel(cfg, device=DEVICE)
    params, _ = seeded_params(cfg, LM_WEIGHT_SEED, DEVICE)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    caches = model.init_caches(B, S + 4)
    _, caches = model.prefill(params, {"tokens": toks[:, :S]}, caches)
    dec, _ = model.decode_step(params, toks[:, S], caches)
    ref = model.encode(params, {"tokens": toks})[:, -1]
    a, b = dec.float().cpu().numpy(), ref.float().cpu().numpy()
    tol = LM_BF16_TOL if cfg.dtype == "bfloat16" else LM_F32_TOL
    agree = float((a.argmax(-1) == b.argmax(-1)).mean())
    check(np.all(np.isfinite(a)), f"{cfg.name} {cfg.dtype}: decode logits")
    check(np.allclose(a, b, rtol=tol, atol=tol),
          f"{cfg.name} {cfg.dtype}: decode against the forward, max "
          f"{np.abs(a - b).max()} over {tol}")
    check(agree >= LM_ARGMAX_AGREE or cfg.dtype != "bfloat16",
          f"{cfg.name} bf16: argmax agreement {agree}")
    return {"max_abs": float(np.abs(a - b).max()), "tol": tol,
            "argmax_agree": agree}


def lm_card_vs_cpu(cfg) -> dict:
    """The same seeded weights through params_from_jax on the card and on
    the CPU: the prefill and LM_CPU_STEPS teacher-forced decode steps."""
    from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                            seeded_params)
    from repro_torch.models.lm import LMModel

    tree = params_to_numpy(seeded_params(cfg, LM_WEIGHT_SEED, "cpu")[0])
    B, S = LM_CPU_SHAPE
    toks = np.random.default_rng(3).integers(0, cfg.vocab,
                                             (B, S + LM_CPU_STEPS))
    steps = []
    for dev in (DEVICE, torch.device("cpu")):
        model = LMModel(cfg, device=dev)
        params = params_from_jax(tree, dev)
        caches = model.init_caches(B, S + LM_CPU_STEPS)
        logits, caches = model.prefill(params, {"tokens": toks[:, :S]},
                                       caches)
        out = [logits.float().cpu().numpy()]
        for t in range(LM_CPU_STEPS):
            logits, caches = model.decode_step(params, toks[:, S + t], caches)
            out.append(logits.float().cpu().numpy())
        steps.append(out)
    worst = 0.0
    for i, (a, b) in enumerate(zip(*steps)):
        check(np.allclose(a, b, rtol=LM_F32_TOL, atol=LM_F32_TOL),
              f"card against the CPU, step {i}: max {np.abs(a - b).max()}")
        worst = max(worst, float(np.abs(a - b).max()))
    return {"max_abs": worst, "steps": LM_CPU_STEPS + 1}


def phase_lm() -> dict:
    """ROADMAP A17 (i) and A16 on the card: (a) the smoke-lm decode service
    at its full CONFIG and the CLI's defaults, (b) decode against the
    teacher-forced forward per family, (c) the card against the CPU on one
    set of weights, (d) JAX's recorded argmax, (e) the CPU baselines
    against the card's count."""
    import dataclasses as dc

    from repro_torch.configs.smoke_lm import CONFIG, FAMILY_SMOKES
    from repro_torch.core import ego_join, rtree_join, self_join_count
    from repro_torch.launch import serve
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.lm import LMModel

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (a) serving, bfloat16, batch 256, prompt 32, 16 tokens
        rep = serve.main(["--arch", "smoke-lm"])
        check(rep.finite, "smoke-lm serving: a logit not finite")
        check(rep.tokens.shape == (256, 17) and rep.tokens.min() >= 0
              and rep.tokens.max() < CONFIG.vocab,
              f"smoke-lm serving: token ids {rep.tokens.shape}")
        # (b) decode against the forward
        f32 = dc.replace(CONFIG, dtype="float32")
        decode = {"smoke-lm-bf16": lm_decode_vs_forward(CONFIG,
                                                        LM_DECODE_SHAPE),
                  "smoke-lm-f32": lm_decode_vs_forward(f32, LM_DECODE_SHAPE)}
        for fam, cfg in FAMILY_SMOKES.items():
            decode[fam] = lm_decode_vs_forward(
                dc.replace(cfg, dtype="float32"), LM_FAMILY_SHAPE)
        # (c) the card against the CPU
        cpu = lm_card_vs_cpu(f32)
        # (d) JAX's recorded argmax
        params, _ = seeded_params(f32, LM_WEIGHT_SEED, DEVICE)
        logits = LMModel(f32, device=DEVICE).encode(
            params, {"tokens": lm_pin_prompt(f32.vocab)}).cpu().numpy()
        am, margin = argmax_margin(logits)
        want = np.asarray(LM_ARGMAX["argmax"])
        held = np.asarray(LM_ARGMAX["margin"]) > LM_MARGIN
        check(np.array_equal(am[held], want[held]),
              f"argmax against JAX's at {int((am[held] != want[held]).sum())}"
              f" of {int(held.sum())} positions")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # (e) the CPU baselines on the host against the card's count
    pts = expo(A16_POINTS, 3)
    t0 = time.perf_counter()
    ego = ego_join(pts, A16_EPS)
    ego_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rtree = rtree_join(pts, A16_EPS)
    rtree_s = time.perf_counter() - t0
    card = self_join_count(pts, A16_EPS).total_pairs
    check(ego == rtree == card == A16_TOTAL,
          f"A16: ego {ego}, rtree {rtree}, card {card}, recorded {A16_TOTAL}")
    emit("lm", config=CONFIG.name, dtype=CONFIG.dtype, batch=rep.batch,
         prompt_len=rep.prompt_len, tokens=rep.tokens.shape[1] - 1,
         first_prefill_ms=rep.first_prefill_ms, prefill_ms=rep.prefill_ms,
         token_p50_ms=rep.p50_ms, token_p99_ms=rep.p99_ms,
         token_ms=rep.token_ms, peak_bytes=rep.peak_bytes,
         decode_vs_forward=decode, card_vs_cpu=cpu,
         jax_argmax_positions=int(held.sum()),
         jax_argmax_min_margin=float(margin.min()),
         a16={"points": A16_POINTS, "eps": A16_EPS, "pairs": card,
              "ego_s": ego_s, "rtree_s": rtree_s},
         nvidia_smi=nvidia_smi_line(),
         phase_s=time.perf_counter() - t_phase)
    return {"prefill_ms": rep.prefill_ms, "p50_ms": rep.p50_ms}


# --- single-process LM training (ROADMAP A17 (ii a)) ----------------------

TRAIN_ARGS = ["--arch", "smoke-lm", "--steps", "40", "--batch", "8", "--seq",
              "256", "--dedup", "--ckpt-every", "20"]
TRAIN_LAST = 5           # the mean of the last 5 losses is below the first
LM_TRAIN_SHAPE = (2, 64)     # (batch, seq) of the pinned f32 steps
LM_TRAIN_STEPS = 3
LM_TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 20}   # the driver's defaults
LM_TRAIN_RTOL = 1e-4     # the card against JAX's pin and against the CPU
LM_TRAIN_FAMILY_SHAPE = (2, 16)  # a moe routing row of 16 tokens drops none
# the first step's update on the card against the CPU's, leaf by leaf:
# the norm of the difference over the norm of the CPU's update (an update
# that did nothing reads 1, one of the wrong sign 2)
TRAIN_UPDATE_RTOL = 0.02
# JAX's jitted make_train_step on smoke-lm's full CONFIG at float32 with
# seeded_params(LM_WEIGHT_SEED), AdamWConfig(**LM_TRAIN_OPT), over
# TokenPipeline(seed=0) batches 0-2 of LM_TRAIN_SHAPE, whose tokens are
# recorded too: numpy's zipf draws are not the same in every numpy version,
# so the card trains on these tokens, not on its own pipeline's
# (tests/test_torch_train_driver.py recomputes all three through JAX)
LM_TRAIN_PIN = {
    "tokens": [[[1, 10, 2, 1, 313, 1, 96, 69, 331, 2162, 1, 3, 6664, 1, 3,
                17, 1, 33, 1, 1, 10, 1, 2, 2070, 1, 311, 8, 94, 3, 882, 20,
                8, 3, 15, 2, 20, 3, 1, 170, 1, 3, 1, 281, 2, 66, 1065, 49,
                23, 2, 36, 41, 167, 1, 5044, 135, 1, 580, 5, 3, 1, 8, 4, 4,
                2],
               [388, 587, 54, 2, 9, 28, 3, 62, 1, 13, 14, 8, 1, 14, 1, 686,
                1, 2599, 3, 1117, 1161, 1, 2, 2, 90, 1, 1, 2, 4, 127, 233,
                1, 25, 3, 1011, 115, 10, 1, 4, 531, 1, 15, 17, 32, 10, 1, 1,
                76, 5, 1, 20, 2, 870, 7609, 1, 4, 2, 1, 8163, 3, 3, 7, 1, 10]],
              [[2, 1, 313, 1, 96, 69, 331, 2162, 1, 3, 6664, 1, 3, 17, 1,
                33, 1, 1, 10, 1, 2, 2070, 1, 311, 8, 94, 3, 882, 20, 8, 3,
                15, 2, 20, 3, 1, 170, 1, 3, 1, 281, 2, 66, 1065, 49, 23, 2,
                36, 41, 167, 1, 5044, 135, 1, 580, 5, 3, 1, 8, 4, 4, 2, 388,
                587],
               [54, 2, 9, 28, 3, 62, 1, 13, 14, 8, 1, 14, 1, 686, 1, 2599,
                3, 1117, 1161, 1, 2, 2, 90, 1, 1, 2, 4, 127, 233, 1, 25, 3,
                1011, 115, 10, 1, 4, 531, 1, 15, 17, 32, 10, 1, 1, 76, 5, 1,
                20, 2, 870, 7609, 1, 4, 2, 1, 8163, 3, 3, 7, 1, 10, 86, 292]],
              [[1, 313, 1, 96, 69, 331, 2162, 1, 3, 6664, 1, 3, 17, 1, 33,
                1, 1, 10, 1, 2, 2070, 1, 311, 8, 94, 3, 882, 20, 8, 3, 15,
                2, 20, 3, 1, 170, 1, 3, 1, 281, 2, 66, 1065, 49, 23, 2, 36,
                41, 167, 1, 5044, 135, 1, 580, 5, 3, 1, 8, 4, 4, 2, 388,
                587, 54],
               [2, 9, 28, 3, 62, 1, 13, 14, 8, 1, 14, 1, 686, 1, 2599, 3,
                1117, 1161, 1, 2, 2, 90, 1, 1, 2, 4, 127, 233, 1, 25, 3,
                1011, 115, 10, 1, 4, 531, 1, 15, 17, 32, 10, 1, 1, 76, 5, 1,
                20, 2, 870, 7609, 1, 4, 2, 1, 8163, 3, 3, 7, 1, 10, 86, 292,
                381]]],
    "loss": [9.047532081604004, 9.031447410583496, 8.960970878601074],
    "grad_norm": [7.561369895935059, 7.359340190887451, 7.038341045379639],
}
# a restart from a step-6 checkpoint against an uninterrupted run, at the
# driver's bf16: the embedding's backward and the head's reductions
# accumulate in an order the card does not fix, so the resumed losses are
# held to a relative band, not to their bits (on the CPU they are equal)
TRAIN_RESUME_ARGS = ["--arch", "smoke-lm", "--batch", "4", "--seq", "128"]
TRAIN_RESUME_RTOL = 2e-3
TRAIN_DEDUP_SHAPE = (8, 256)
TRAIN_DEDUP_COPIES = (3, 5, 6)   # rows overwritten by rows 0, 1, 1


def train_steps(cfg, device, batches) -> list:
    """One f32 train step a batch on ``device`` from
    ``seeded_params(cfg, LM_WEIGHT_SEED)`` with AdamWConfig(**LM_TRAIN_OPT):
    the metrics and the float32 master weights after each."""
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.lm import LMModel
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(cfg, dtype="float32")
    model = LMModel(cfg, device=device)
    params, _ = seeded_params(cfg, LM_WEIGHT_SEED, device)
    ocfg = AdamWConfig(**LM_TRAIN_OPT)
    state = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg)
    out = []
    for batch in batches:
        params, state, met = step(params, state, batch)
        out.append({"loss": float(met["loss"]),
                    "grad_norm": float(met["grad_norm"]),
                    "master": state["master"]})
    return out


def train_pin_run(device, steps: int) -> list:
    """``steps`` f32 steps of the full CONFIG over LM_TRAIN_PIN's batches."""
    from repro_torch.configs.smoke_lm import CONFIG

    return train_steps(CONFIG, device, [pin_batch(i) for i in range(steps)])


def card_vs_cpu_steps(cfg, batches) -> dict:
    """Two f32 steps of ``cfg`` on the card and on the CPU from the same
    weights: the relative differences of each step's loss and gradient
    norm (the second step's loss reads the first step's update), the
    largest difference of the master weights after the first step, and
    that step's update (master - init) on the card against the CPU's:
    ``update_rel``, the worst leaf's norm of the difference over the norm
    of the CPU's update, and ``update_rel_max``, the largest element's
    difference over the largest element of the CPU's update (a record:
    an element whose gradient cancels to f32 rounding may change sign,
    and Adam's first step moves it by lr either way). The first step's lr
    is 1/20 of 3e-4, so the master weights move by about 1.5e-5: an
    update that did nothing, or went the wrong way, lies within
    LM_TRAIN_RTOL of the CPU's master weights, but its update_rel reads 1
    or 2."""
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.layers import tree_flatten_with_path

    assert len(batches) == 2
    card, cpu = (train_steps(cfg, dev, batches)
                 for dev in (DEVICE, torch.device("cpu")))
    init, _ = seeded_params(dataclasses.replace(cfg, dtype="float32"),
                            LM_WEIGHT_SEED, "cpu")
    ups = [(a.cpu() - i, b - i) for (_, i), (_, a), (_, b) in zip(
        *(tree_flatten_with_path(t) for t in
          (init, card[0]["master"], cpu[0]["master"])))]
    return {**{f"{k}_{n}": rel(c[k], p[k])
               for n, (c, p) in enumerate(zip(card, cpu), 1)
               for k in ("loss", "grad_norm")},
            "master_max_abs": max(float((a - b).abs().max())
                                  for a, b in ups),
            "update_rel": max(float((a - b).norm() / b.norm().clamp_min(
                1e-30)) for a, b in ups),
            "update_rel_max": (max(float((a - b).abs().max()) for a, b in ups)
                               / max(float(b.abs().max()) for _, b in ups))}


def pin_batch(i: int) -> dict:
    """LM_TRAIN_PIN's batch i, labelled as TokenPipeline labels."""
    tokens = np.asarray(LM_TRAIN_PIN["tokens"][i], np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_dedup_vs_plain() -> dict:
    """Planted copies through TokenPipeline._dedup on the card and on the
    CPU: the same tokens, and every planted copy replaced."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import fused_join as fj

    B, S = TRAIN_DEDUP_SHAPE
    kw = dict(vocab=8192, batch=B, seq=S, seed=0, dedup=True)
    tokens = TokenPipeline(**kw, device="cpu").batch_at(0)["tokens"]
    planted = tokens.copy()
    copies = list(TRAIN_DEDUP_COPIES)
    planted[copies] = planted[[0, 1, 1]]
    before = fj.KERNEL_LAUNCHES
    card = TokenPipeline(**kw, device=DEVICE)._dedup(planted, 7)
    launches = fj.KERNEL_LAUNCHES - before
    plain = TokenPipeline(**kw, device="cpu")._dedup(planted, 7)
    check(launches > 0, "the card's dedup launched no B1")
    check(np.array_equal(card, plain), "dedup on the card differs from its "
          f"plain version in {int((card != plain).any(1).sum())} rows")
    replaced = [c for c in copies if not np.array_equal(card[c], planted[c])]
    check(replaced == copies, f"planted copies kept: "
          f"{sorted(set(copies) - set(replaced))}")
    return {"rows": B, "planted": len(copies),
            "replaced": int((card != planted).any(1).sum()),
            "launches": launches}


TRAIN_PROFILE_STEPS = 3


def train_profile() -> dict:
    """TRAIN_PROFILE_STEPS steps of the full CONFIG at 8 x 256 (bf16, remat
    on) under torch.profiler after as many warm ones: per stage span
    (``train_step.loss`` / ``.grad`` / ``.update``) its host ms and the
    device ms of its kernels, device kernels a step, the device's busy
    share of the wall time and the top kernels by device time. The batch
    is drawn without the dedup: the step alone."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.smoke_lm import CONFIG
    from repro_torch.data import TokenPipeline
    from repro_torch.models.lm import LMModel
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    model = LMModel(CONFIG, device=DEVICE)
    params, _ = model.init(np.random.default_rng(0))
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=20)
    state = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg)
    pipe = TokenPipeline(vocab=CONFIG.vocab, batch=8, seq=256, seed=0)
    batches = [{k: torch.as_tensor(v, device=DEVICE)
                for k, v in pipe.batch_at(i).items()}
               for i in range(2 * TRAIN_PROFILE_STEPS)]
    for b in batches[:TRAIN_PROFILE_STEPS]:
        params, state, met = step(params, state, b)
        float(met["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[TRAIN_PROFILE_STEPS:]:
            params, state, met = step(params, state, b)
            float(met["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    averages = prof.key_averages()
    n = TRAIN_PROFILE_STEPS
    stages = {e.key: dict(host_ms=e.cpu_time_total / 1e3 / n,
                          device_ms=(getattr(e, "device_time_total", 0)
                                     or 0) / 1e3 / n)
              for e in averages if e.key.startswith("train_step.")
              and e.device_type == torch.autograd.DeviceType.CPU}
    check(set(stages) == {"train_step.loss", "train_step.grad",
                          "train_step.update"},
          f"profiled step entered the spans {sorted(stages)}")
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and device_us(e) > 0
              and not e.key.startswith(("Activity Buffer", "train_step."))]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    by_name = collections.Counter()
    for e in events:      # names cut to 90 characters, their times summed
        by_name[e.key[:90]] += device_us(e) / 1e3 / n
    return dict(
        step_wall_ms=wall_ms / n, stages=stages,
        device_kernels_a_step=(sum(e.count for e in events) / n
                               if events else None),
        device_busy_ms_a_step=busy_ms / n if events else None,
        device_busy_share=busy_ms / wall_ms if events else None,
        top_device_ms=dict(by_name.most_common(8)),
        note="per step; wall and host times include the profiler's cost; "
             "the backward's kernels run on autograd's thread, outside "
             "the train_step.grad span's device time")


def phase_train() -> dict:
    """ROADMAP A17 (ii a) on the card: (a) the driver at the full CONFIG
    with the dedup, and its step under the profiler, (b) the dedup against
    its plain version, (c) JAX's recorded losses, (d) the card against the
    CPU, smoke-lm and the moe, ssm and hybrid smokes, (e) a resume."""
    import tempfile

    from repro_torch.ckpt import latest_step
    from repro_torch.configs.smoke_lm import CONFIG, FAMILY_SMOKES
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import fused_join as fj
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the main path: 40 steps at full width, B1 in every batch
        ckpt = os.path.join(tmp, "full")
        sync()
        fj.KERNEL_LAUNCHES = fj.RUN_LOOP_LAUNCHES = 0
        rep = train.run(TRAIN_ARGS + ["--ckpt-dir", ckpt])
        sync()
        launches, run_loop = fj.KERNEL_LAUNCHES, fj.RUN_LOOP_LAUNCHES
        losses = np.asarray(rep.losses)
        check(len(losses) == 40 and np.isfinite(losses).all(),
              f"train: losses {losses[:4]}...")
        check(losses[-TRAIN_LAST:].mean() < losses[0],
              f"train: last {TRAIN_LAST} losses "
              f"{losses[-TRAIN_LAST:].tolist()} not below the first "
              f"{losses[0]}")
        check(launches >= len(losses), f"train: {launches} B1 launches in "
              f"{len(losses)} steps")
        check(latest_step(ckpt) == 40 and sorted(os.listdir(ckpt)) ==
              ["step_00000020", "step_00000040"],
              f"train: checkpoints {sorted(os.listdir(ckpt))}")
        timed = np.asarray(rep.step_ms[1:])
        # the step under the profiler: where its time goes
        profiled = train_profile()
        # (b) the dedup against its plain version
        dedup = train_dedup_vs_plain()
        # (c) JAX's recorded f32 losses and (d) the card against the CPU,
        # with TF32 off: JAX and the CPU compute in full float32
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            card = train_pin_run(DEVICE, LM_TRAIN_STEPS)
            vs_cpu = {"smoke-lm": card_vs_cpu_steps(
                CONFIG, [pin_batch(0), pin_batch(1)])}
            # and each family's small config: the moe's index_add_ and the
            # recurrent scans' backward
            rng = np.random.default_rng(LM_PROMPT_SEED)
            for fam, fcfg in FAMILY_SMOKES.items():
                batches = []
                for _ in range(2):
                    tokens = rng.integers(0, fcfg.vocab,
                                          LM_TRAIN_FAMILY_SHAPE)
                    labels = np.roll(tokens, -1, axis=1)
                    labels[:, -1] = -1
                    batches.append({"tokens": tokens, "labels": labels})
                vs_cpu[fam] = card_vs_cpu_steps(fcfg, batches)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        pin = {k: max(rel(c[k], w) for c, w in zip(card, LM_TRAIN_PIN[k]))
               for k in ("loss", "grad_norm")}
        check(max(pin.values()) <= LM_TRAIN_RTOL,
              f"train: the card against LM_TRAIN_PIN {pin}, card "
              f"{[(c['loss'], c['grad_norm']) for c in card]}")
        for name, d in vs_cpu.items():
            check(max(d[f"{k}_{n}"] for k in ("loss", "grad_norm")
                      for n in (1, 2)) <= LM_TRAIN_RTOL
                  and d["master_max_abs"] <= LM_TRAIN_RTOL
                  and d["update_rel"] <= TRAIN_UPDATE_RTOL,
                  f"train: {name} on the card against the CPU {d}")
        # whether this machine's numpy draws the pin's tokens (a record)
        pipe = TokenPipeline(vocab=CONFIG.vocab, batch=LM_TRAIN_SHAPE[0],
                             seq=LM_TRAIN_SHAPE[1], seed=0, device=DEVICE)
        pipeline_draws_pin = all(
            np.array_equal(pipe.batch_at(i)["tokens"], pin_batch(i)["tokens"])
            for i in range(LM_TRAIN_STEPS))
        # (e) resume: 6 steps and a checkpoint, then on to 8
        whole = train.run(TRAIN_RESUME_ARGS + ["--steps", "8"])
        rdir = os.path.join(tmp, "resume")
        first = train.run(TRAIN_RESUME_ARGS + ["--steps", "6", "--ckpt-dir",
                                               rdir, "--ckpt-every", "6"])
        resumed = train.run(TRAIN_RESUME_ARGS + ["--steps", "8",
                                                 "--ckpt-dir", rdir])
        check(resumed.start == 6 and len(resumed.losses) == 2,
              f"train: resumed at {resumed.start}")
        resume = max(rel(a, b) for a, b in zip(resumed.losses,
                                               whole.losses[6:]))
        check(resume <= TRAIN_RESUME_RTOL,
              f"train: resumed losses {resumed.losses} against "
              f"{whole.losses[6:]}")
        first_vs_whole = max(rel(a, b) for a, b in zip(first.losses,
                                                       whole.losses[:6]))
    emit("train", config="smoke-lm", dtype="bfloat16", remat=True,
         steps=len(losses), batch=8, seq=256, dedup=True,
         first_loss=float(losses[0]),
         last_mean_loss=float(losses[-TRAIN_LAST:].mean()),
         losses=losses.tolist(), first_step_ms=rep.step_ms[0],
         step_p50_ms=float(np.percentile(timed, 50)),
         step_p99_ms=float(np.percentile(timed, 99)),
         batch_p50_ms=float(np.percentile(rep.batch_ms[1:], 50)),
         tokens_per_s=rep.tokens_per_s(),
         step_tokens_per_s=rep.step_tokens_per_s(),
         peak_bytes=rep.peak_bytes,
         b1_launches=launches, run_loop_launches=run_loop,
         dedup_vs_plain=dedup, pin_rel=pin, card_vs_cpu=vs_cpu,
         numpy=np.__version__, pipeline_draws_pin=pipeline_draws_pin,
         resume_rel=resume, resume_tol=TRAIN_RESUME_RTOL,
         first_six_rel=first_vs_whole, profile=profiled,
         nvidia_smi=nvidia_smi_line(),
         phase_s=time.perf_counter() - t_phase)
    return {"launches": launches,
            "step_p50_ms": float(np.percentile(timed, 50))}


# --- the LM meshes, the pod-compressed step, the elastic restore ------------
# (ROADMAP A17 (ii b)): gloo ranks sharing the one card, every collective
# staged through host memory (launch/mesh.py)

TRAIN_MESH_ARGS = ["--arch", "smoke-lm", "--steps", "10", "--batch", "8",
                   "--seq", "256", "--dedup", "--mesh", "smoke",
                   "--log-every", "100"]
TRAIN_MESH_RANKS = (2, 4)         # (data 1, model 2) and (2, 2)
TRAIN_MESH_BATCH = (8, 256)       # TRAIN_MESH_ARGS' --batch and --seq
TRAIN_MESH_STEPS = 10
TRAIN_MESH_TIMEOUT_S = 300.0
POD_MESH = ((2, 1, 2), ("pod", "data", "model"))
# JAX's jitted make_train_step(compress_pods=True) on a (2, 1, 2) mesh of
# placeholder devices, at smoke-lm's full CONFIG and float32, from
# seeded_params(LM_WEIGHT_SEED) with AdamWConfig(**LM_TRAIN_OPT), over
# LM_TRAIN_PIN's batches 0-2 (tests/torch_mesh_jax.py::pod_pin recomputes
# it, tests/test_torch_compression.py holds the port to it on the CPU)
LM_TRAIN_POD_PIN = {
    "loss": [9.047531127929688, 9.033652305603027, 8.967348098754883],
    "grad_norm": [7.566691875457764, 7.374155044555664, 7.04207181930542],
    # pod 0's grad_error after each step: its norm and its elements' sum
    "grad_error_norm": [0.48428765897900466, 0.5073310551626751,
                        0.5681436546180936],
    "grad_error_sum": [5.158006904122762, 10.04926013599318,
                       25.641086476841586],
}
# what only the compression moves, pod 0's residual: the largest
# difference of its norm or sum from the pin's over the pin's norm. The
# port reads 2.2e-3 on the CPU and 1.6e-2 on an H100; on the CPU a
# residual never fed back into the next gradient reads 17, one left at
# zero 45 (the losses and grad norms move by 1.4e-3 under either)
POD_RESIDUAL_RTOL = 0.1
TRAIN_MESH_RESUME_ARGS = TRAIN_RESUME_ARGS + ["--log-every", "100"]


def mesh_f32_steps(device, shape, axes, compress: bool = False,
                   steps: int = LM_TRAIN_STEPS, ref_path=None) -> dict:
    """``steps`` f32 train steps of the full CONFIG on a mesh of this
    spawn's ranks over LM_TRAIN_PIN's batches, from
    ``seeded_params(LM_WEIGHT_SEED)`` with AdamWConfig(**LM_TRAIN_OPT),
    TF32 off: the losses and gradient norms. With ``compress``, pod 0's
    ``grad_error`` after each step: its norm and the sum of its elements
    (float64). With ``ref_path`` (a ``torch.save`` of the unmeshed run's
    initial, first-step and final master weights), rank 0's largest
    difference of the gathered final master weights from the unmeshed
    ones, and the first step's update (master - init) against the
    unmeshed update, as ``card_vs_cpu_steps`` holds the card to the CPU:
    ``update_rel``, the worst leaf's norm of the difference over the norm
    of the unmeshed update (a block left at its initial value reads 1,
    one updated the wrong way 2)."""
    from repro_torch.configs.smoke_lm import CONFIG
    from repro_torch.launch import mesh as lm_mesh
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.layers import tree_flatten_with_path
    from repro_torch.models.lm import LMModel
    from repro_torch.train.compression import init_error_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(CONFIG, dtype="float32")
    mesh = lm_mesh.make_mesh_compat(shape, axes, device=device)
    if mesh is None:
        return {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = LMModel(cfg, mesh)
        params, specs = seeded_params(cfg, LM_WEIGHT_SEED, mesh=mesh)
        ocfg = AdamWConfig(**LM_TRAIN_OPT)
        state = adamw_init(params, ocfg)
        if compress:
            state["grad_error"] = init_error_state(params)
        step = make_train_step(model, ocfg, compress_pods=compress,
                               param_specs=specs)
        out = {"loss": [], "grad_norm": []}
        first = None
        for i in range(steps):
            params, state, met = step(params, state, pin_batch(i))
            for k in ("loss", "grad_norm"):
                out[k].append(float(met[k]))
            if compress:
                # a collective: pod 0's ranks put pod 0's residual together
                err = [t.double() for _, t in tree_flatten_with_path(
                    mesh.gather_tree(state["grad_error"], specs))]
                out.setdefault("grad_error_norm", []).append(
                    float(torch.sqrt(sum((t * t).sum() for t in err))))
                out.setdefault("grad_error_sum", []).append(
                    float(sum(t.sum() for t in err)))
            if i == 0 and ref_path is not None:
                first = mesh.gather_tree(state["master"], specs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if ref_path is not None:
        master = mesh.gather_tree(state["master"], specs)
        if mesh.rank == 0:
            ref = torch.load(ref_path)
            leaves = lambda t: [x.cpu() for _, x in  # noqa: E731
                                tree_flatten_with_path(t)]
            out["master_max_abs"] = max(
                float((a - b).abs().max())
                for a, b in zip(leaves(master), leaves(ref["last"])))
            ups = [(a - i, b - i) for a, b, i in zip(
                leaves(first), leaves(ref["first"]), leaves(ref["init"]))]
            out["update_rel"] = max(
                float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in ups)
    return out


def pod_vs_pin(pods: dict) -> dict:
    """``mesh_f32_steps(compress=True)``'s figures against LM_TRAIN_POD_PIN:
    the losses' and grad norms' largest relative differences, and the
    residual's (see POD_RESIDUAL_RTOL)."""
    pin = LM_TRAIN_POD_PIN
    out = {k: max(rel(a, b) for a, b in zip(pods[k], pin[k]))
           for k in ("loss", "grad_norm")}
    out["residual"] = max(abs(a - b) / n for k in ("grad_error_norm",
                                                    "grad_error_sum")
                          for a, b, n in zip(pods[k], pin[k],
                                             pin["grad_error_norm"]))
    return out


def mesh_step_stats(device, shape, axes, compress: bool = False) -> dict:
    """One train step as the driver runs it with TRAIN_MESH_ARGS (the full
    CONFIG from ``init(default_rng(0))``, AdamWConfig(**LM_TRAIN_OPT), the
    dedup pipeline's batch 0 of TRAIN_MESH_BATCH) on a mesh of this
    spawn's ranks, for the dryrun phase: the mesh's ``stats`` difference
    across the step (kind -> [calls, bytes]), the rank's argument bytes
    (its blocks of the parameters and the state, its rows of the batch),
    the device memory allocated before the step and its peak during it."""
    from repro_torch.configs.smoke_lm import CONFIG
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import mesh as lm_mesh
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.lm import LMModel
    from repro_torch.train.compression import init_error_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    mesh = lm_mesh.make_mesh_compat(shape, axes, device=device)
    if mesh is None:
        return {}
    model = LMModel(CONFIG, mesh)
    dev = model.device
    params, specs = model.init(np.random.default_rng(0))
    ocfg = AdamWConfig(**LM_TRAIN_OPT)
    state = adamw_init(params, ocfg)
    if compress:
        state["grad_error"] = init_error_state(params)
    step = make_train_step(model, ocfg, compress_pods=compress,
                           param_specs=specs)
    batch_rows, seq = TRAIN_MESH_BATCH
    pipe = TokenPipeline(vocab=CONFIG.vocab, batch=batch_rows, seq=seq,
                         seed=0, dedup=True, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch_at(0).items()}
    layout = model.default_layout(batch)
    rows = sum(tree_bytes(model._rows(v, layout)) for v in batch.values())
    before = dict(mesh.stats)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        allocated = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    step(params, state, batch)
    if cuda:
        torch.cuda.synchronize(dev)
    return {"rank": mesh.rank, "stats": mesh.calls_and_bytes(before),
            "argument_bytes": tree_bytes(params) + tree_bytes(state) + rows,
            "allocated_before": allocated if cuda else None,
            "max_allocated": (torch.cuda.max_memory_allocated(dev) if cuda
                              else None)}


def train_mesh_rank(rank, cases) -> dict:
    """One rank of the train_mesh phase (a worker for ``mesh.spawn``): each
    case ``name -> (kind, kwargs)``, in order. "driver" runs
    ``launch.train.run(argv)`` with B1's count set to 0 just before and
    read just after; "f32" runs ``mesh_f32_steps``, "stats"
    ``mesh_step_stats``."""
    from repro_torch.kernels import fused_join as fj
    from repro_torch.launch import train

    out = {}
    for name, (kind, kw) in cases.items():
        if kind == "driver":
            fj.KERNEL_LAUNCHES = 0
            rep = train.run(list(kw["argv"]))
            if rep.device.startswith("cuda"):
                torch.cuda.synchronize()
            out[name] = dict(dataclasses.asdict(rep),
                             b1_launches=fj.KERNEL_LAUNCHES,
                             tokens_per_s=rep.tokens_per_s())
        elif kind == "stats":
            out[name] = mesh_step_stats(**kw)
        else:
            out[name] = mesh_f32_steps(**kw)
    return out


def train_mesh_spawn(n_ranks: int, cases: dict) -> tuple:
    from repro_torch.launch import mesh
    t0 = time.perf_counter()
    ranks = mesh.spawn(train_mesh_rank, n_ranks, cases, device=DEVICE,
                       timeout_s=TRAIN_MESH_TIMEOUT_S)
    return ranks, time.perf_counter() - t0


def phase_train_mesh() -> dict:
    """ROADMAP A17 (ii b) on the card: (a) the driver with ``--mesh smoke
    --dedup`` at the full CONFIG on 2 ranks (1, 2) and 4 ranks (2, 2),
    every rank's losses finite and equal to rank 0's, B1 launched once a
    batch on each rank; (b) the same meshes at f32 against the card's
    unmeshed f32 steps; (c) the pod-compressed step on (2, 1, 2) against
    JAX's LM_TRAIN_POD_PIN; (d) 4 steps with ``--mesh none`` on one rank
    resumed on 4 ranks to step 8 against an uninterrupted 4-rank run."""
    import tempfile

    from repro_torch.configs.smoke_lm import CONFIG
    from repro_torch.launch import train
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.layers import tree_map

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks share the card
    with tempfile.TemporaryDirectory() as tmp:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            unmeshed = train_pin_run(DEVICE, LM_TRAIN_STEPS)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        ref_path = os.path.join(tmp, "ref_master.pt")
        init, _ = seeded_params(dataclasses.replace(CONFIG, dtype="float32"),
                                LM_WEIGHT_SEED, "cpu")
        torch.save({"init": init, **{
            k: tree_map(lambda t: t.detach().cpu(), unmeshed[i]["master"])
            for k, i in (("first", 0), ("last", -1))}}, ref_path)
        ckpt = os.path.join(tmp, "resume")
        first = train.run(TRAIN_MESH_RESUME_ARGS + [
            "--mesh", "none", "--steps", "4", "--ckpt-dir", ckpt,
            "--ckpt-every", "4"])
        runs, spawn_s = {}, {}
        for n in TRAIN_MESH_RANKS:
            shape = (n // 2, 2)
            cases = {
                "driver": ("driver", dict(argv=TRAIN_MESH_ARGS)),
                "f32": ("f32", dict(device=DEVICE, shape=shape,
                                    axes=("data", "model"),
                                    ref_path=ref_path))}
            if n == 4:
                cases.update(
                    pods=("f32", dict(device=DEVICE, shape=POD_MESH[0],
                                      axes=POD_MESH[1], compress=True)),
                    resume=("driver", dict(argv=TRAIN_MESH_RESUME_ARGS + [
                        "--mesh", "smoke", "--steps", "8", "--ckpt-dir",
                        ckpt])),
                    whole=("driver", dict(argv=TRAIN_MESH_RESUME_ARGS + [
                        "--mesh", "smoke", "--steps", "8"])),
                    pod_stats=("stats", dict(device=DEVICE,
                                             shape=POD_MESH[0],
                                             axes=POD_MESH[1],
                                             compress=True)))
            # one step for the dryrun phase, after the timed runs
            cases["stats"] = ("stats", dict(device=DEVICE, shape=shape,
                                            axes=("data", "model")))
            runs[n], spawn_s[n] = train_mesh_spawn(n, cases)
    launches, fields = 0, {}
    for n, ranks in runs.items():
        where = f"train_mesh ({n // 2}, 2)"
        drv = [r["driver"] for r in ranks]
        losses = np.asarray(drv[0]["losses"])
        check(len(losses) == TRAIN_MESH_STEPS and np.isfinite(losses).all(),
              f"{where}: losses {losses.tolist()}")
        for r in drv:
            check(r["losses"] == drv[0]["losses"], f"{where}: rank "
                  f"{r['rank']}'s losses {r['losses']} differ from rank 0's")
            check(r["b1_launches"] >= TRAIN_MESH_STEPS, f"{where}: rank "
                  f"{r['rank']} launched B1 {r['b1_launches']} times in "
                  f"{TRAIN_MESH_STEPS} batches")
            check(r["mesh"] == {"data": n // 2, "model": 2},
                  f"{where}: mesh {r['mesh']}")
        launches += sum(r["b1_launches"] for r in drv)
        f32 = ranks[0]["f32"]
        vs = {k: max(rel(a, b[k]) for a, b in zip(f32[k], unmeshed))
              for k in ("loss", "grad_norm")}
        check(max(vs.values()) <= LM_TRAIN_RTOL
              and f32["master_max_abs"] <= LM_TRAIN_RTOL
              and f32["update_rel"] <= TRAIN_UPDATE_RTOL,
              f"{where}: f32 against the unmeshed steps {vs}, master "
              f"{f32['master_max_abs']}, first update {f32['update_rel']}")
        timed = np.asarray(drv[0]["step_ms"][1:])
        fields[f"{n // 2}x2"] = dict(
            losses=losses.tolist(),
            step_p50_ms=float(np.percentile(timed, 50)),
            step_p99_ms=float(np.percentile(timed, 99)),
            batch_p50_ms=float(np.percentile(drv[0]["batch_ms"][1:], 50)),
            tokens_per_s=drv[0]["tokens_per_s"],
            peak_bytes=[r["peak_bytes"] for r in drv],
            b1_launches=[r["b1_launches"] for r in drv],
            collective_s_a_step={k: v[1] / len(losses) for k, v in
                                 drv[0]["collective"].items()},
            collective_calls={k: v[0] for k, v in
                              drv[0]["collective"].items()},
            collective_bytes={k: v[2] for k, v in
                              drv[0]["collective"].items()},
            f32_vs_unmeshed=vs, f32_master_max_abs=f32["master_max_abs"],
            f32_update_rel=f32["update_rel"],
            spawn_s=spawn_s[n])
    four = runs[4]
    pods = four[0]["pods"]
    pin = pod_vs_pin(pods)
    residual = pin.pop("residual")
    check(all(r["pods"]["loss"] == pods["loss"] for r in four)
          and max(pin.values()) <= LM_TRAIN_RTOL
          and residual <= POD_RESIDUAL_RTOL,
          f"train_mesh pods: {pods} against LM_TRAIN_POD_PIN ({pin}, "
          f"residual {residual})")
    resumed, whole = four[0]["resume"], four[0]["whole"]
    check(resumed["start"] == 4 and resumed["ranks"] == 4
          and len(resumed["losses"]) == 4,
          f"train_mesh resume: start {resumed['start']}, ranks "
          f"{resumed['ranks']}")
    resume = max(rel(a, b) for a, b in zip(resumed["losses"],
                                           whole["losses"][4:]))
    first_vs_whole = max(rel(a, b) for a, b in zip(first.losses,
                                                   whole["losses"][:4]))
    check(resume <= TRAIN_RESUME_RTOL and first_vs_whole <= TRAIN_RESUME_RTOL,
          f"train_mesh resume: {resumed['losses']} against "
          f"{whole['losses'][4:]}, one rank {first.losses} against "
          f"{whole['losses'][:4]}")
    emit("train_mesh", config="smoke-lm", dtype="bfloat16", remat=True,
         steps=TRAIN_MESH_STEPS, batch=8, seq=256, dedup=True,
         backend="gloo", meshes=fields, pods_vs_pin=pin,
         pods_losses=pods["loss"], pods_residual_vs_pin=residual,
         pods_residual_norm=pods["grad_error_norm"], resume_rel=resume,
         first_four_rel=first_vs_whole, resume_tol=TRAIN_RESUME_RTOL,
         b1_launches=launches, nvidia_smi=nvidia_smi_line(),
         phase_s=time.perf_counter() - t_phase)
    stats = {f"{n // 2}x2": [r["stats"] for r in ranks]
             for n, ranks in runs.items()}
    stats["pods"] = [r["pod_stats"] for r in runs[4]]
    return {"launches": launches, "step_stats": stats}


# --- meshed inference (ROADMAP A17 (iv)): tensor parallelism over 'model',
# the KV cache's sequence over cache_seq; gloo ranks sharing the one card

INFER_MESH_SHAPES = {"1x2": (1, 2), "2x2": (2, 2)}
INFER_MESH_BATCH = (256, 32)     # the lm phase's serve shape: 256 prompts
INFER_MESH_TOKENS = 16           # of 32 tokens, 16 decoded
INFER_MESH_TIMEOUT_S = 300.0


def infer_mesh_tokens(vocab: int, batch, n_tokens: int) -> np.ndarray:
    """The prompts and the teacher-forced decode tokens, (B, S + T)."""
    B, S = batch
    return np.random.default_rng(LM_PROMPT_SEED).integers(
        0, vocab, (B, S + n_tokens))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_serve_steps(model, params, toks, n_tokens: int, mesh=None) -> dict:
    """The prefill of the prompts ``toks[:, :-n_tokens]`` and ``n_tokens``
    teacher-forced decode steps on ``model``: every step's logits (float32, on the host),
    the prefill's ms and each decode step's (host clock ending in a
    synchronize, the copy to the host outside it), the KV caches' bytes on
    this rank; on a mesh, the collectives of the decode steps (kind ->
    [calls, seconds, bytes]) and of the last step (kind -> [calls,
    bytes])."""
    B, S = toks.shape[0], toks.shape[1] - n_tokens
    dev = model.device
    caches = model.init_caches(B, S + n_tokens)
    kv = caches.kv.k.numel() * caches.kv.k.element_size() * 2
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": toks[:, :S]}, caches)
    _sync(dev)
    out = {"prefill_ms": 1e3 * (time.perf_counter() - t0), "token_ms": [],
           "kv_bytes": kv}
    steps = [logits.float().cpu()]
    first = dict(mesh.stats) if mesh is not None else {}
    for t in range(n_tokens):
        last = dict(mesh.stats) if mesh is not None else {}
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, toks[:, S + t], caches)
        _sync(dev)
        out["token_ms"].append(1e3 * (time.perf_counter() - t0))
        steps.append(logits.float().cpu())
    if mesh is not None:
        out["decode_collectives"] = {
            k: [c - first.get(k, (0, 0.0, 0))[0],
                s_ - first.get(k, (0, 0.0, 0))[1],
                b - first.get(k, (0, 0.0, 0))[2]]
            for k, (c, s_, b) in mesh.stats.items()
            if (c, s_, b) != first.get(k)}
        out["step_stats"] = {k: v for k, v in
                             mesh.calls_and_bytes(last).items() if v[0]}
    out["logits"] = steps
    return out


def infer_mesh_rank(rank, cases) -> dict:
    """One rank of the infer_mesh phase (a worker for ``mesh.spawn``):
    each case ``name -> kwargs`` of ``infer_mesh_case``, in order."""
    return {name: infer_mesh_case(**kw) for name, kw in cases.items()}


def infer_mesh_case(device, shape, dtype: str, ref_path: str, batch,
                    n_tokens: int) -> dict:
    """smoke-lm's full CONFIG at ``dtype`` from
    ``seeded_params(LM_WEIGHT_SEED)`` on a (data, model) mesh of this
    spawn's ranks, TF32 off: ``lm_serve_steps`` against the card's
    unmeshed run saved at ``ref_path`` (f32: the largest difference of
    any logit; bf16: the argmax agreement over every row), a digest of
    this rank's logits, the layout's batch and cache_seq ranks, this
    rank's peak memory."""
    import hashlib

    from repro_torch.configs.smoke_lm import CONFIG
    from repro_torch.launch import mesh as lm_mesh
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.lm import LMModel, choose_layout

    cfg = dataclasses.replace(CONFIG, dtype=dtype)
    mesh = lm_mesh.make_mesh_compat(shape, ("data", "model"), device=device)
    if mesh is None:
        return {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = LMModel(cfg, mesh)
        params, _ = seeded_params(cfg, LM_WEIGHT_SEED, mesh=mesh)
        dev = model.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        run = lm_serve_steps(model, params,
                             infer_mesh_tokens(cfg.vocab, batch, n_tokens),
                             n_tokens, mesh)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ref = torch.load(ref_path)
    got = run.pop("logits")
    digest = hashlib.sha256()
    for t in got:
        digest.update(t.numpy().tobytes())
    if dtype == "float32":
        run["max_abs"] = max(float((a - b).abs().max())
                             for a, b in zip(got, ref))
    else:
        run["argmax_agree"] = float(torch.cat([
            (a.argmax(-1) == b) for a, b in zip(got, ref)]).float().mean())
    layout = choose_layout(cfg, mesh, batch[0], batch[1] + n_tokens)
    ranks = lambda entry: math.prod(   # noqa: E731
        mesh.shape[a] for a in mesh.entry_live(entry))
    run.update(rank=mesh.rank, digest=digest.hexdigest(),
               layout=dataclasses.astuple(layout),
               batch_ranks=ranks(layout.batch_axes),
               seq_ranks=ranks(layout.cache_seq),
               peak_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None))
    return run


def phase_infer_mesh() -> dict:
    """ROADMAP A17 (iv) on the card: smoke-lm's full CONFIG served at the
    lm phase's shape (256 prompts of 32 tokens, 16 decoded, teacher
    forced) by gloo ranks sharing the card on (1, 2) and (2, 2): every
    rank's logits equal (their digests); f32 within LM_F32_TOL of the
    card's unmeshed model, TF32 off; bf16 argmax agreement with the
    unmeshed bf16 model at least LM_ARGMAX_AGREE; each rank's KV cache
    the unmeshed one's bytes over its batch ranks and cache_seq ranks.
    Prints the bf16 prefill ms, per-token p50 / p99 (the first decode step
    untimed, as the lm phase's), each rank's peak memory and the
    collectives' seconds a token by kind; returns the last decode step's
    collectives of every rank for the dryrun phase."""
    import tempfile

    from repro_torch.configs.smoke_lm import CONFIG
    from repro_torch.launch import mesh as lm_mesh
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.lm import LMModel

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks share the card
    fields, stats = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        refs, kv = {}, {}
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for dtype in ("float32", "bfloat16"):
                cfg = dataclasses.replace(CONFIG, dtype=dtype)
                model = LMModel(cfg, device=DEVICE)
                params, _ = seeded_params(cfg, LM_WEIGHT_SEED, DEVICE)
                run = lm_serve_steps(
                    model, params, infer_mesh_tokens(
                        cfg.vocab, INFER_MESH_BATCH, INFER_MESH_TOKENS),
                    INFER_MESH_TOKENS)
                logits = run["logits"]
                if dtype == "bfloat16":
                    logits = [t.argmax(-1) for t in logits]
                refs[dtype] = os.path.join(tmp, f"{dtype}.pt")
                torch.save(logits, refs[dtype])
                kv[dtype] = run["kv_bytes"]
                del model, params, run, logits
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.empty_cache()
        for name, shape in INFER_MESH_SHAPES.items():
            n = math.prod(shape)
            cases = {dt: dict(device=DEVICE, shape=shape, dtype=dt,
                              ref_path=refs[dt], batch=INFER_MESH_BATCH,
                              n_tokens=INFER_MESH_TOKENS)
                     for dt in ("float32", "bfloat16")}
            t0 = time.perf_counter()
            ranks = lm_mesh.spawn(infer_mesh_rank, n, cases, device=DEVICE,
                                  timeout_s=INFER_MESH_TIMEOUT_S)
            spawn_s = time.perf_counter() - t0
            where = f"infer_mesh {name}"
            for dt in ("float32", "bfloat16"):
                rs = [r[dt] for r in ranks]
                check(len({r["digest"] for r in rs}) == 1,
                      f"{where} {dt}: the ranks' logits differ")
                for r in rs:
                    want = kv[dt] // (r["batch_ranks"] * r["seq_ranks"])
                    check(r["kv_bytes"] == want,
                          f"{where} {dt} rank {r['rank']}: KV cache "
                          f"{r['kv_bytes']} B, not {want}")
            worst = max(r["float32"]["max_abs"] for r in ranks)
            agree = min(r["bfloat16"]["argmax_agree"] for r in ranks)
            check(worst <= LM_F32_TOL, f"{where}: f32 logits {worst} from "
                  f"the unmeshed model's, over {LM_F32_TOL}")
            check(agree >= LM_ARGMAX_AGREE,
                  f"{where}: bf16 argmax agreement {agree}")
            bf = [r["bfloat16"] for r in ranks]
            timed = np.asarray(bf[0]["token_ms"][1:])
            fields[name] = dict(
                layout=bf[0]["layout"], prefill_ms=bf[0]["prefill_ms"],
                f32_prefill_ms=ranks[0]["float32"]["prefill_ms"],
                token_p50_ms=float(np.percentile(timed, 50)),
                token_p99_ms=float(np.percentile(timed, 99)),
                peak_bytes=[r["peak_bytes"] for r in bf],
                kv_bytes=[r["kv_bytes"] for r in bf],
                unmeshed_kv_bytes=kv["bfloat16"],
                collective_s_a_token={
                    k: v[1] / INFER_MESH_TOKENS
                    for k, v in bf[0]["decode_collectives"].items()},
                collective_calls_a_token={
                    k: v[0] / INFER_MESH_TOKENS
                    for k, v in bf[0]["decode_collectives"].items()},
                collective_bytes_a_token={
                    k: v[2] / INFER_MESH_TOKENS
                    for k, v in bf[0]["decode_collectives"].items()},
                f32_max_abs=worst, bf16_argmax_agree=agree,
                spawn_s=spawn_s)
            stats[name] = [(r["rank"], r["step_stats"]) for r in bf]
    emit("infer_mesh", config=CONFIG.name, dtype=CONFIG.dtype,
         batch=INFER_MESH_BATCH[0], prompt_len=INFER_MESH_BATCH[1],
         tokens=INFER_MESH_TOKENS, backend="gloo", meshes=fields,
         f32_tol=LM_F32_TOL, nvidia_smi=nvidia_smi_line(),
         phase_s=time.perf_counter() - t_phase)
    return {"decode_stats": stats}


def decode_plans(inferred: dict) -> dict:
    """The dry run's plan of the infer_mesh phase's decode step (a decode
    cell of its batch and cache length at smoke-lm's CONFIG) on each
    rank's ``PlanMesh``, against that rank's last real decode step: every
    kind's calls and bytes equal. Returns rank 0's plan by mesh."""
    from repro_torch.configs import ShapeCell
    from repro_torch.configs.smoke_lm import CONFIG
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import plan_mesh

    B, S = INFER_MESH_BATCH
    cell = ShapeCell("infer_mesh", S + INFER_MESH_TOKENS, B, "decode")
    out = {}
    for name, shape in INFER_MESH_SHAPES.items():
        for rank, real in inferred["decode_stats"][name]:
            _, _, plan = dryrun.lower_lm_cell(
                "smoke-lm", cell, plan_mesh(shape, ("data", "model"), rank),
                cfg=CONFIG)
            planned = plan["mesh"].calls_and_bytes()
            check(planned == real, f"dryrun decode {name} rank {rank}: "
                  f"planned {planned}, the real step's {real}")
            if rank == 0:
                out[name] = planned
    return out


# --- the dry run and the roofline (ROADMAP A17 (iii)) -----------------------
# no kernel on this path: the dry run counts steps on meta tensors

DRYRUN_ARGS = (["--arch", "smoke-lm", "--shape", "train_4k", "--mesh", "both"],
               ["--arch", "selfjoin", "--shape", "syn6d2m", "--mesh",
                "single"])
DRYRUN_MATMUL_N = 8192
DRYRUN_COPY_BYTES = 2 ** 31
DRYRUN_MATMUL_REPS = 20
DRYRUN_COPY_REPS = 10
# a rate the card measures above its constant by more than this means the
# constant is wrong
DRYRUN_RATE_SLACK = 1.05
DRYRUN_MESHES = {"1x2": ((1, 2), ("data", "model"), False),
                 "2x2": ((2, 2), ("data", "model"), False),
                 "pods": (POD_MESH[0], POD_MESH[1], True)}


def roofline_rates() -> dict:
    """The card's bf16 matmul rate (2 n^3 flops) and copy rate (bytes read
    and written), by CUDA events, as fractions of the roofline's
    ``PEAK_FLOPS`` and ``HBM_BW``."""
    from repro_torch.launch import roofline

    n = DRYRUN_MATMUL_N
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    a = torch.randn((n, n), device=DEVICE, dtype=torch.bfloat16,
                    generator=gen)
    b = torch.randn((n, n), device=DEVICE, dtype=torch.bfloat16,
                    generator=gen)
    torch.matmul(a, b)
    mm_ms = event_ms(lambda: torch.matmul(a, b), DRYRUN_MATMUL_REPS)
    del a, b
    src = torch.empty(DRYRUN_COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)
    dst.copy_(src)
    copy_ms = event_ms(lambda: dst.copy_(src), DRYRUN_COPY_REPS)
    del src, dst
    torch.cuda.empty_cache()
    mm_rate = 2.0 * n ** 3 / (mm_ms / 1e3)
    copy_rate = 2.0 * DRYRUN_COPY_BYTES / (copy_ms / 1e3)
    return {"matmul_ms": mm_ms, "matmul_flops_per_s": mm_rate,
            "matmul_fraction": mm_rate / roofline.PEAK_FLOPS,
            "copy_ms": copy_ms, "copy_bytes_per_s": copy_rate,
            "copy_fraction": copy_rate / roofline.HBM_BW}


def phase_dryrun(trained: dict, meshed: dict, inferred: dict) -> dict:
    """ROADMAP A17 (iii) on the card: (a) the dry run's CLI (DRYRUN_ARGS)
    in this process, each exiting 0 with ``memory_allocated`` unmoved;
    (b) the plan of the train_mesh phase's recorded steps on (1, 2),
    (2, 2) and the pod step on (2, 1, 2), rank by rank: every kind's calls
    and bytes equal the real step's ``LMMesh.stats`` difference; (c) the
    card's matmul and copy rates at most DRYRUN_RATE_SLACK x the
    roofline's constants; (d) the roofline's bound of the train phase's
    cell (the larger of its compute and memory terms) at most that
    phase's step p50; (e) the planned argument bytes on (1, 2) equal to
    the real rank's, the planned peak beside ``max_memory_allocated``;
    (f) the plan of the infer_mesh phase's decode step on (1, 2) and
    (2, 2) against every rank's real step (``decode_plans``)."""
    import tempfile

    from repro_torch.configs import ShapeCell
    from repro_torch.configs.smoke_lm import CONFIG
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import plan_mesh
    from repro_torch.train.optimizer import AdamWConfig

    t_phase = time.perf_counter()
    # (a) the CLI, in this process: meta tensors only
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dryrun.json")
        sync()
        allocated = torch.cuda.memory_allocated()
        for argv in DRYRUN_ARGS:
            rc = dryrun.main(argv + ["--out", out])
            check(rc == 0, f"dryrun: {' '.join(argv)} exited {rc}")
        sync()
        moved = torch.cuda.memory_allocated() - allocated
        check(moved == 0, f"dryrun: the dry run moved the card's allocated "
              f"memory by {moved} B")
        with open(out) as f:
            results = json.load(f)
    cells = {}
    for key, res in results.items():
        if key.startswith("_"):
            continue
        r = res["roofline"]
        cells[key] = {k: r[k] for k in (
            "compute_s", "memory_s", "collective_s", "bottleneck",
            "flops_per_device", "bytes_per_device",
            "wire_bytes_per_device")}
        cells[key]["memory_s_lower"] = r.get("memory_s_lower")
        cells[key]["temp_size_in_bytes"] = res["memory_analysis"][
            "temp_size_in_bytes"]
    # (b) the plans against the train_mesh phase's real steps
    batch_rows, seq = TRAIN_MESH_BATCH
    cell = ShapeCell("train_mesh", seq, batch_rows, "train")
    ocfg = AdamWConfig(**LM_TRAIN_OPT)
    plans = {}
    for name, (shape, axes, compress) in DRYRUN_MESHES.items():
        for real in meshed["step_stats"][name]:
            _, _, plan = dryrun.lower_lm_cell(
                "smoke-lm", cell, plan_mesh(shape, axes, real["rank"]),
                cfg=CONFIG, opt_cfg=ocfg, compress_pods=compress)
            planned = plan["mesh"].calls_and_bytes()
            check(planned == real["stats"],
                  f"dryrun {name} rank {real['rank']}: planned "
                  f"collectives {planned}, the real step's {real['stats']}")
            check(plan["memory"]["argument_size_in_bytes"]
                  == real["argument_bytes"],
                  f"dryrun {name} rank {real['rank']}: planned arguments "
                  f"{plan['memory']['argument_size_in_bytes']} B, the real "
                  f"rank's {real['argument_bytes']} B")
            if real["rank"] == 0:
                plans[name] = (plan, real)
    # (c) the constants against the card
    rates = roofline_rates()
    check(rates["matmul_fraction"] <= DRYRUN_RATE_SLACK
          and rates["copy_fraction"] <= DRYRUN_RATE_SLACK,
          f"dryrun: the card beats the roofline's constants {rates}")
    # (d) the train phase's cell: one rank, no collectives
    tcell = ShapeCell("train", seq, batch_rows, "train")
    probe = dryrun.cost_probe("smoke-lm", tcell)
    compute_s = probe["flops_total"] / roofline.PEAK_FLOPS
    memory_s = probe["bytes_total"] / roofline.HBM_BW
    floor_s = roofline.traffic_floor(CONFIG, tcell, 1) / roofline.HBM_BW
    bound_ms = 1e3 * max(compute_s, memory_s)
    check(bound_ms <= trained["step_p50_ms"],
          f"dryrun: the roofline's bound {bound_ms} ms of the train cell "
          f"is above the measured step p50 {trained['step_p50_ms']} ms")
    # (f) the infer_mesh phase's decode step
    decode = decode_plans(inferred)
    # (e) memory on (1, 2)
    plan, real = plans["1x2"]
    mem = plan["memory"]
    predicted_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    emit("dryrun", cells=cells,
         ranks_checked={k: len(v) for k, v in meshed["step_stats"].items()},
         planned_stats={k: p["mesh"].calls_and_bytes()
                        for k, (p, _) in plans.items()},
         planned_decode_stats=decode,
         decode_ranks_checked={k: len(v) for k, v in
                               inferred["decode_stats"].items()},
         rates=rates, rate_slack=DRYRUN_RATE_SLACK,
         train_cell={"flops": probe["flops_total"],
                     "bytes": probe["bytes_total"],
                     "compute_ms": 1e3 * compute_s,
                     "memory_ms": 1e3 * memory_s,
                     "floor_memory_ms": 1e3 * floor_s,
                     "bound_ms": bound_ms,
                     "step_p50_ms": trained["step_p50_ms"],
                     "bound_over_p50": bound_ms / trained["step_p50_ms"],
                     "floor_over_p50": 1e3 * floor_s
                     / trained["step_p50_ms"]},
         memory_1x2={"argument_bytes": mem["argument_size_in_bytes"],
                     "temp_bytes": mem["temp_size_in_bytes"],
                     "predicted_peak": predicted_peak,
                     "allocated_before": real["allocated_before"],
                     "max_memory_allocated": real["max_allocated"],
                     "predicted_over_real": predicted_peak
                     / real["max_allocated"],
                     # what the step itself added at its peak
                     "step_growth": (real["max_allocated"]
                                     - real["allocated_before"])},
         nvidia_smi=nvidia_smi_line(),
         phase_s=time.perf_counter() - t_phase)
    return {"rates": rates}


def gloo_cuda_rank(rank) -> dict:
    """Which gloo collectives take CUDA tensors on this machine (a worker
    for ``mesh.spawn``): each one's outcome on a small tensor, a record
    (the port stages every collective through host memory)."""
    import torch.distributed as dist

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    n = dist.get_world_size()
    calls = {
        "all_reduce_f32": lambda: dist.all_reduce(torch.ones(4, device=dev)),
        "all_reduce_bf16": lambda: dist.all_reduce(
            torch.ones(4, device=dev, dtype=torch.bfloat16)),
        "all_gather_f32": lambda: dist.all_gather(
            [torch.empty(4, device=dev) for _ in range(n)],
            torch.ones(4, device=dev)),
        "reduce_scatter_tensor_f32": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(4 * n, device=dev)),
        "all_to_all_single_f32": lambda: dist.all_to_all_single(
            torch.empty(4 * n, device=dev), torch.ones(4 * n, device=dev)),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as err:        # noqa: BLE001 -- recorded
            out[name] = f"{type(err).__name__}: {str(err)[:120]}"
    return out


def dryrun_alone() -> int:
    """``--dryrun``: the build, the train, train_mesh, infer_mesh and
    dryrun phases, without the others."""
    phase_env()
    phase_build()
    trained = phase_train()
    meshed = phase_train_mesh()
    inferred = phase_infer_mesh()
    print(json.dumps({"dryrun": phase_dryrun(trained, meshed, inferred)}),
          flush=True)
    return 0


def infer_mesh_alone() -> int:
    """``--infer-mesh``: the infer_mesh phase and the plans of its decode
    step (``decode_plans``), without the others (no kernel on this
    path: no build)."""
    phase_env()
    inferred = phase_infer_mesh()
    print(json.dumps({"infer_mesh": {"planned_decode_stats":
                                     decode_plans(inferred)}}), flush=True)
    return 0


def train_mesh_alone() -> int:
    """``--train-mesh``: the build, the train_mesh phase and the gloo probe
    on CUDA tensors (``gloo_cuda_rank``), without the other phases."""
    from repro_torch.launch import mesh
    phase_env()
    phase_build()
    probe = mesh.spawn(gloo_cuda_rank, 2, device=DEVICE, backend="gloo",
                       timeout_s=120)
    emit("gloo_cuda_probe", ranks=probe)
    out = phase_train_mesh()
    print(json.dumps({"train_mesh": out}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--record-half-totals"]:
        print(json.dumps(record_half_totals()), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    timers = {"--kernel-times": ("kernel_times", kernel_times),
              "--e2e-times": ("e2e_times", e2e_times),
              "--b1-times": ("b1_times", b1_times),
              "--emit-times": ("emit_times", emit_cell_times)}
    if sys.argv[1:2] and sys.argv[1] in timers:
        # another checkout's src (the parent commit's, say) goes first
        for src in sys.argv[2:3]:
            sys.path.insert(0, str(Path(src).resolve()))
        key, timer = timers[sys.argv[1]]
        print(nvidia_smi_line(), flush=True)
        with pinned_tables():
            print(json.dumps({key: timer()}), flush=True)
        return 0
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    if sys.argv[1:] == ["--train-mesh"]:
        print(nvidia_smi_line(), flush=True)
        with pinned_tables():
            return train_mesh_alone()
    if sys.argv[1:] == ["--dryrun"]:
        print(nvidia_smi_line(), flush=True)
        with pinned_tables():
            return dryrun_alone()
    if sys.argv[1:] == ["--infer-mesh"]:
        print(nvidia_smi_line(), flush=True)
        return infer_mesh_alone()
    with pinned_tables() as table_dir:
        return smoke(table_dir)


def smoke(table_dir: Path) -> int:
    """Every phase, then the kernels line, the card's line and the
    contract's last line."""
    phase_env()
    phase_build()
    phase_syncs()
    workloads = bench_workloads()
    worst = phase_kernel_vs_plain(workloads)
    phase_bench_totals(workloads)
    main = phase_main_path()
    unfused = phase_unfused(main)
    phase_batched(main)
    brute = phase_brute(workloads)
    phase_profile()
    served = phase_serve()
    metrics = phase_metrics()
    half = phase_half(workloads)
    slab = phase_slab()
    routes = phase_routes(workloads, table_dir)
    collective = phase_collective()
    sharded = phase_sharded()
    deduped = phase_dedup()
    analysis = phase_analysis()
    phase_lm()
    trained = phase_train()
    meshed = phase_train_mesh()
    inferred = phase_infer_mesh()
    phase_dryrun(trained, meshed, inferred)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the smoke imported JAX or the JAX package")
    csrc = "src/repro_torch/kernels/csrc"
    b1 = main["b1"]
    kernels = [{
        "name": "fused_join", "route": "cuda",
        "source": f"{csrc}/fused_join.cu",
        "replaces": "src/repro/kernels/fused_join.py:215",
        "launches": b1["launches"],
        "launches_by_variant": {"run_loop": b1["run_loop_launches"],
                                "row_loop": (b1["launches"]
                                             - b1["run_loop_launches"]),
                                "external": served["launches"],
                                "cosine": metrics["cosine_launches"],
                                "jaccard": metrics["launches"],
                                "jaccard_external":
                                    metrics["external_launches"],
                                "gid": slab["launches"],
                                "gid_collective_ranks":
                                    collective["gid_launches"],
                                "external_sharded": sharded["launches"],
                                "dedup_cosine": deduped["launches"],
                                "sanitized_main_path":
                                    analysis["launches"],
                                "train_dedup": trained["launches"],
                                "train_mesh_dedup": meshed["launches"]},
        "max_abs_err": max(worst, served["worst"], metrics["worst"],
                           slab["worst"]),
        "ms": b1["ms"],
        "row_loop_ms": b1["row_loop_ms"],
        "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
        "bound_by": b1["bound_by"], "library_ms": None,
        "external_ms": served["ms"], "external_named_ms": served["named_ms"],
        "external_index_b_named_ms": served["index_b_named_ms"],
        "external_events_ms": served["enqueue_ms"],
        "external_plain_ms": served["plain_ms"],
        "external_plain_device_ms": served["plain_device_ms"],
        "external_bound_ms": served["bound_ms"],
        "external_bound_by": served["bound_by"],
        "jaccard_ms": metrics["ms"],
        "jaccard_sample_ms": metrics["sample_ms"],
        "jaccard_sample_plain_ms": metrics["plain_ms"],
        "jaccard_bound_ms": metrics["bound_ms"],
        "jaccard_bound_by": metrics["bound_by"],
        "jaccard_issue_floor_ms": metrics["issue_ms"],
        "jaccard_library_ms": None,
        "gid_ms": slab["ms"], "gid_plain_ms": slab["plain_ms"],
        "gid_bound_ms": slab["bound_ms"], "gid_bound_by": slab["bound_by"],
        "gid_library_ms": None,
        "tq": b1["tq"], "other_tiles": routes["b1_tiles"],
        "matched_plain": True,
    }, {
        "name": "distance_tile_hits", "route": "cuda",
        "source": f"{csrc}/distance_tile.cu",
        "replaces": "src/repro/kernels/distance_tile.py:45",
        "launches": brute["b2"]["launches"], "max_abs_err": 0,
        "ms": brute["b2"]["device_ms"], "events_ms": brute["b2"]["events_ms"],
        "plain_ms": brute["b2"]["plain_ms"],
        "bound_ms": brute["b2"]["bound_ms"],
        "bound_by": brute["b2"]["bound_by"],
        "issue_floor_ms": brute["b2"]["issue_floor_ms"],
        "library_ms": brute["b2"]["cdist_ms"],
        "library": brute["b2"]["cdist_note"], "matched_plain": True,
        "timed_on": "uniform-2d brute sweep (391 launches), device time "
                    "by name",
    }, {
        "name": "distance_tile_counts", "route": "cuda",
        "source": f"{csrc}/distance_tile.cu",
        "replaces": "src/repro/kernels/distance_tile.py:62",
        "launches": main["b3_launches"],
        "max_abs_err": max(brute["worst"], main["b3_err"]),
        "ms": brute["b3"]["ms"], "plain_ms": brute["b3"]["plain_ms"],
        "bound_ms": brute["b3"]["bound_ms"],
        "bound_by": brute["b3"]["bound_by"],
        "issue_floor_ms": brute["b3"]["issue_ms"], "library_ms": None,
        "matched_plain": True, "timed_on": "uniform-2d, 100,000 points",
        "main_path_ms": main["b3_ms"], "main_path_bound_ms": main["b3_bound"][0],
        "main_path_issue_floor_ms": main["b3_issue"],
    }, {
        "name": "cell_join_hits", "route": "cuda",
        "source": f"{csrc}/cell_join.cu",
        "replaces": "src/repro/kernels/cell_join.py:32",
        "launches": unfused["launches"], "max_abs_err": unfused["worst"],
        "ms": unfused["ms"], "plain_ms": unfused["plain_ms"],
        "bound_ms": unfused["bound_ms"], "bound_by": unfused["bound_by"],
        "library_ms": None, "matched_plain": True,
        "timed_on": "one launch of the main path's unfused join, "
                    "2,000,000 x 32 x 2 f64",
    }, {
        "name": "emit_pairs", "route": "cuda",
        "source": f"{csrc}/emit_pairs.cu",
        "replaces": "src/repro/core/selfjoin.py:581 (jnp, no Pallas kernel)",
        "launches": main["emit"]["launches"],
        "launches_by_variant": {"main_path": main["emit"]["launches"],
                                "cosine": metrics["cosine_launches"],
                                "jaccard": metrics["launches"]},
        "max_abs_err": 0, "ms": main["emit"]["device_ms"],
        "events_ms": main["emit"]["ms"],
        "plain_ms": main["emit"]["plain_ms"],
        "bound_ms": main["emit"]["bound_ms"],
        "bound_by": main["emit"]["bound_by"], "library_ms": None,
        "matched_plain": True,
        "timed_on": "the main path's self-join launches (recorded from its "
                    "own run), 2,000,000 x 2 f64, device time by name",
    }] + half_kernels(half)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
