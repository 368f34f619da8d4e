#!/usr/bin/env python3
"""Run one benchmark cell of the port ``repro_torch`` and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for (``BENCHMARK.json``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, then ``run`` and, last,
``checks``: each number compared beside its limit, which also end standard
error. Exits non-zero with no result when the devices are missing, when the
program is not in the checkout, or when the run loaded JAX or the JAX
package ``repro``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ALLOC_CONF = "expandable_segments:True"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # before CUDA's first allocation: the allocator grows one segment
    # instead of splitting fixed ones, so the card's memory does not
    # fragment under a join that holds most of it beside the results the
    # check keeps
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC_CONF
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    return harness.main(args, root=ROOT, t0=T0)


if __name__ == "__main__":
    sys.exit(main())
