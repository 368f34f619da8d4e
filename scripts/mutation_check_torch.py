#!/usr/bin/env python
"""Mutation check for the port's analysis gate (run by scripts/ci_torch.sh).

    PYTHONPATH=src python scripts/mutation_check_torch.py [--device cpu|cuda]

Proves the gate of ``repro_torch.analysis`` has teeth. Seeding
(a) an undersized window cap, (b) an int64 key literal in the key code,
(c) a ``.item()`` host sync in kernel B1's wrapper, (d) an int32-keyed
index whose volume leaves no device-probe headroom below the padding
sentinel, (e) a cell-run plan that merges two cells into one run, (f) a
refine site that inlines the eps-squared predicate instead of going
through the metric trait, and (g) a launch whose shared memory a block
passes the H100's opt-in limit must each produce a NEW finding, while the
unmutated tree produces zero new findings against the committed baseline.
Mutations are in memory -- a tampered ``BucketPlan`` or ``run_ord``
through the prover's ``plan=`` / ``run_ord=`` seams, source text mutated
before ``lint_source``, a forged ``GridIndex`` via ``dataclasses.replace``
-- so the working tree is never touched. Indexes are built on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import contracts, lint  # noqa: E402
from repro_torch.analysis import findings as F  # noqa: E402
from repro_torch.analysis.__main__ import (DEFAULT_BASELINE,  # noqa: E402
                                           collect_findings)

_FAILED = []
_CHECKS = []


def check(name: str, ok: bool, detail: str = ""):
    print(f"  {'PASS' if ok else 'FAIL'}  {name}"
          + (f": {detail}" if detail and not ok else ""))
    _CHECKS.append(name)
    if not ok:
        _FAILED.append(name)


def _source(rel: str) -> str:
    with open(os.path.join(_REPO, rel)) as fh:
        return fh.read()


def _lint_mutation(name: str, rel: str, old: str, new: str, key: str,
                   baseline: set) -> None:
    text = _source(rel)
    if old not in text:
        raise SystemExit(f"{rel} changed: update mutation {name}")
    found = lint.lint_source(text.replace(old, new, 1), rel)
    check(name, any(f.key == key for f in F.new_findings(found, baseline)),
          f"no new finding {key}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device the indexes are built on (default: cuda)")
    args = ap.parse_args(argv)
    baseline = F.load_baseline(DEFAULT_BASELINE)

    # -- unmutated tree: zero new findings --------------------------------
    fresh = F.new_findings(collect_findings(device=args.device), baseline)
    check("clean tree produces zero new findings", not fresh,
          "; ".join(f.key for f in fresh))

    # -- (a) undersized window cap ----------------------------------------
    from repro_torch.core.grid import (BucketPlan, build_grid, cell_run_plan,
                                       occupancy_plan, round_up)

    rng = np.random.default_rng(3)
    centers = rng.uniform(0.0, 1.0, (4, 3))
    pts = centers[rng.integers(0, 4, 300)] + rng.normal(0.0, 0.03, (300, 3))
    index = build_grid(pts, 0.1, device=args.device)
    exact = contracts.recompute_cell_caps(index, merged=True)
    if exact.max() <= 8:
        raise SystemExit("mutation fixture too sparse to undersize")
    plan = occupancy_plan(index, merged=True)
    tampered = BucketPlan(caps=(8,), sel=(None,), cap_global=plan.cap_global,
                          hist={8: index.num_points})
    found = contracts.check_window_caps(index, merged=True, plan=tampered,
                                        tag="mutated")
    check("(a) undersized window cap is caught",
          any(f.rule == "cap-coverage" for f in found),
          "no cap-coverage finding")

    # -- (b) int64 key literal in the key code ----------------------------
    _lint_mutation(
        "(b) int64 key literal in _pad_probe is caught",
        "src/repro_torch/core/grid.py",
        "    pad = torch.full_like(arr, pad_key_for(key_dtype), dtype=kd)",
        "    pad = torch.full_like(arr, torch.iinfo(torch.int64).max, "
        "dtype=kd)",
        "lint:int64-key-literal:src/repro_torch/core/grid.py::_pad_probe",
        baseline)

    # -- (c) a host sync in B1's wrapper ----------------------------------
    _lint_mutation(
        "(c) .item() in fused_join_hits is caught",
        "src/repro_torch/kernels/fused_join.py",
        "    metric_lib.check_metric(metric)\n",
        "    metric_lib.check_metric(metric)\n"
        "    _widest = win_count.max().item()\n",
        "lint:host-sync:src/repro_torch/kernels/fused_join.py"
        "::fused_join_hits", baseline)

    # -- (d) int32 keys with no probe headroom below the pad sentinel -----
    # volume 2 * (2^30 - 1) = 2^31 - 2: key_dtype_for still says int32
    # (C4 stays clean) but the sentinel margin collapses to 2 -- the
    # device planners' key+2 probe would reach the padding sentinel
    forged = dataclasses.replace(
        index, dims=torch.tensor([2, 2**30 - 1], dtype=torch.int64),
        cell_keys=index.cell_keys.to(torch.int32))
    found = contracts.check_device_sentinel(forged, tag="mutated")
    check("(d) collapsed device-probe sentinel margin is caught",
          any(f.rule == "device-sentinel" for f in found),
          "no device-sentinel finding")
    clean = contracts.check_device_sentinel(index, tag="clean")
    check("(d) healthy index passes the device-sentinel contract",
          not clean, "; ".join(f.key for f in clean))

    # -- (e) corrupted run length: two cells merged into one run ----------
    tq = 128
    rank = index.point_cell_rank.cpu()
    qp = round_up(index.num_points, tq)
    pos = torch.clamp(torch.arange(qp), max=index.num_points - 1)
    ro_clean = cell_run_plan(rank[pos], tq).run_ord.numpy()
    healthy = contracts.check_run_plan(index, run_ord=ro_clean, tq=tq,
                                       tag="clean")
    check("(e) healthy run plan passes the run-partition contract",
          not healthy, "; ".join(f.key for f in healthy))
    ro = ro_clean.reshape(-1, tq).copy()
    tiles_multi = np.flatnonzero(ro.max(axis=1) > 0)
    if not tiles_multi.size:
        raise SystemExit("mutation fixture has one run per tile")
    t = int(tiles_multi[0])
    ro[t][ro[t] >= 1] -= 1   # the first run swallows the next cell's rows
    found = contracts.check_run_plan(index, run_ord=ro.reshape(-1), tq=tq,
                                     tag="mutated")
    check("(e) overlapping-run corruption is caught",
          any(f.rule == "run-partition" for f in found),
          "no run-partition finding")

    # -- (f) inlined eps-squared predicate outside core/metric.py ---------
    brute = "src/repro_torch/core/brute.py"
    found = lint.lint_source(
        _source(brute) + "\n\ndef _mutated_refine(d2, eps):\n"
                         "    return d2 <= eps * eps\n", brute)
    key = f"lint:eps-squared-predicate:{brute}::_mutated_refine"
    check("(f) inlined eps-squared predicate is caught",
          any(f.key == key for f in F.new_findings(found, baseline)),
          "no new eps-squared-predicate finding")
    # the owner module itself stays exempt (it DEFINES the predicate)
    metric_src = "src/repro_torch/core/metric.py"
    owner = [f for f in lint.lint_source(_source(metric_src), metric_src)
             if f.rule == "eps-squared-predicate"]
    check("(f) core/metric.py is exempt from the predicate rule",
          not owner, "; ".join(f.key for f in owner))

    # -- (g) a launch past the shared-memory opt-in limit ------------------
    # a Jaccard vocabulary of 2^15 tokens: 2,048 feature lanes, a 4 KiB
    # query record, 128 records a block
    sizes = build_grid(np.sort(rng.integers(1, 64, 200)).astype(np.float32)
                       [:, None], 1.0, device=args.device)
    found = contracts.check_smem(sizes, merged=False, metric="jaccard",
                                 n_feat=2048, tag="mutated")
    check("(g) oversized shared-memory launch is caught",
          any(f.rule == "smem-budget" for f in found),
          "no smem-budget finding")
    clean = contracts.check_smem(sizes, merged=False, metric="jaccard",
                                 n_feat=64, tag="clean")
    check("(g) a narrow vocabulary passes the shared-memory contract",
          not clean, "; ".join(f.key for f in clean))

    n = len(_CHECKS)
    if _FAILED:
        print(f"mutation check: FAIL ({len(_FAILED)} of {n})",
              file=sys.stderr)
        return 1
    print(f"mutation check: OK ({n}/{n})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
