#!/usr/bin/env python3
"""The control: the reference one precision below the configuration's, put
in the program's place in a whole run of a cell, which has to come out not
correct.

    python3 portbench/control.py --workload syn2d2m.join --seeds 1 2 3 \\
        --seconds 5 [--out chiprun_out/control.jsonl]

Each seed is one run of the harness (``harness.run_cell``) at the cell's own
size, with the entry wrapped so that every call returns the control's pairs:
the reference computed in float32, the precision below the configurations'
float64. The check after the window compares them with the reference in
float64, as it does the program's. One JSON line a seed: ``correct`` and
each number beside its limit. The benchmark's own runs never run this; the
program's readings are every run's own check.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOWER = {"float64": "float32"}


def control_pairs(reference, points, eps: float):
    """The reference one precision below, as (K, 2) int32 pairs in the
    program's place."""
    import torch
    low = getattr(torch, LOWER[str(points.dtype).replace("torch.", "")])
    keys = reference.pair_keys(points.to(low), eps)
    n = points.shape[0]
    return torch.stack([keys // n, keys % n], dim=1).to(torch.int32)


def run(root: Path, workload: str, *, seed: int, seconds: float,
        device: str = "cuda", overrides: dict = None) -> tuple:
    """One harness run of the cell with the control in the program's place;
    returns ``run_cell``'s (result, check lines)."""
    from portbench import harness
    spec = harness.resolve(root, workload)
    config = dict(spec.config, **(overrides or {}))
    reference = harness.load_module(root, "references", config["reference"])
    return harness.run_cell(
        root, workload, seed=seed, seconds=seconds, trace=False,
        device=device, overrides=overrides,
        wrap=lambda entry: lambda points, eps, **kw: control_pairs(
            reference, points, eps))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import ALLOC_CONF
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC_CONF    # as run.py's
    for seed in args.seeds:
        t = time.perf_counter()
        result, _ = run(ROOT, args.workload, seed=seed, seconds=args.seconds)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": result["correct"],
                           "calls": result["attempted"],
                           "seconds": time.perf_counter() - t,
                           "checks": result["checks"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
