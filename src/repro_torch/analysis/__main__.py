"""CLI: run the contract prover and linter against the committed baseline.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu     # gate
    PYTHONPATH=src python -m repro_torch.analysis                   # on the card
    PYTHONPATH=src python -m repro_torch.analysis --device cpu --write-baseline
    PYTHONPATH=src python -m repro_torch.analysis --device cpu --json report.json

The gate builds canned small geometries on the device (uniform 2-D,
clustered 3-D, tiny 6-D: one per key-dtype and skew regime; the card
unless ``--device cpu``), proves the bounded-search contracts on them and
on a 4-slab partition, checks the static no-retrace model for a canned
request mix, and lints ``src/repro_torch/``. Findings are compared with
``scripts/analysis_baseline_torch.json`` by (analyzer, rule, site) key:
accepted findings pass, any NEW finding exits nonzero.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from repro_torch.analysis import contracts, lint
from repro_torch.analysis import findings as F

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(os.path.dirname(_PKG))
DEFAULT_BASELINE = os.path.join(_REPO, "scripts",
                                "analysis_baseline_torch.json")


def canned_datasets():
    """Small deterministic geometries covering the planner regimes:
    uniform (single capacity class), clustered (skew -> bucketed plan),
    and 6-D (largest stencil, int32/int64 key boundary pressure). The JAX
    package's, from the same seed."""
    rng = np.random.default_rng(7)
    out = [("uniform-2d", rng.uniform(0.0, 1.0, (400, 2)), 0.08)]
    centers = rng.uniform(0.0, 1.0, (6, 3))
    pts = centers[rng.integers(0, 6, 300)] + rng.normal(0.0, 0.02, (300, 3))
    out.append(("clustered-3d", pts, 0.05))
    out.append(("tiny-6d", rng.uniform(0.0, 1.0, (64, 6)), 0.3))
    return out


def collect_findings(src_root: str = _PKG, device=None) -> list:
    """Every finding of the gate: the contracts and the no-retrace model on
    the canned datasets built on ``device`` (the card by default), and the
    lint of ``src_root``."""
    from repro_torch.core.grid import build_grid
    from repro_torch.core.query_join import prepare

    found = []
    for tag, pts, eps in canned_datasets():
        index = build_grid(pts, float(eps), device=device)
        found += contracts.prove_index_contracts(index, tag=f"index:{tag}")
        found += contracts.prove_halo_contracts(
            pts, float(eps), n_slabs=4, tag=f"halo:{tag}")
        found += lint.check_no_retrace(
            prepare(index), max_batch=256,
            request_sizes=(1, 3, 32, 128, 200), tag=f"retrace:{tag}")
    found += lint.lint_tree(src_root)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="static contract prover + sync/dtype linter")
    ap.add_argument("--device", default=None,
                    help="device the canned indexes are built on "
                         "(default: cuda)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="committed findings baseline (JSON)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings as the baseline")
    ap.add_argument("--json", default=None,
                    help="also write the full findings report to this path")
    ap.add_argument("--src", default=_PKG,
                    help="package directory to lint (default: this "
                         "checkout's src/repro_torch)")
    args = ap.parse_args(argv)

    found = collect_findings(args.src, device=args.device)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(F.report_json(found))
    if args.write_baseline:
        F.save_baseline(found, args.baseline)
        print(f"wrote {len(F.baseline_keys(found))} accepted keys to "
              f"{args.baseline}")
        return 0
    baseline = (F.load_baseline(args.baseline)
                if os.path.exists(args.baseline) else set())
    fresh = F.new_findings(found, baseline)
    accepted = len(found) - len(fresh)
    print(f"analysis: {len(found)} finding(s), {accepted} accepted by "
          f"baseline, {len(fresh)} new")
    for f in fresh:
        print("  NEW " + f.render())
    if fresh:
        print("analysis: FAIL (new findings; fix them or re-run with "
              "--write-baseline to accept)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
