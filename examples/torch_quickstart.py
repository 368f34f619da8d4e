"""Quickstart of the PyTorch port: the paper's distance-similarity self-join.

Builds the epsilon-grid index over a synthetic 4-D dataset (the paper's Syn-
regime), runs the self-join with UNICOMP and the batching scheme on the card
(the fused gather-refine kernel, B1), and validates the result against the
brute-force oracle, as ``quickstart.py`` does with the JAX package.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import (brute_force_count, self_join_batched,
                         self_join_count)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="CUDA by default; 'cpu' runs the plain versions")
device = ap.parse_args().device

rng = np.random.default_rng(42)
D = rng.uniform(0, 100, size=(20_000, 4))   # |D|=20k points in 4-D
eps = 4.0

# the self-join: all ordered pairs within eps (grid index + UNICOMP +
# >=3 result batches, paper SIV-SV; the fused gather-refine kernel)
pairs = self_join_batched(D, eps, unicomp=True, n_batches=3,
                          distance_impl="fused", device=device)
stats = self_join_count(D, eps, unicomp=True, device=device)

print(f"|D|={D.shape[0]} n=4 eps={eps} device={pairs.device}")
print(f"pairs found        : {pairs.shape[0]}")
print(f"cells visited      : {stats.cells_visited}")
print(f"candidates checked : {stats.candidates_checked}")
print(f"stencil offsets    : {stats.offsets} (UNICOMP: (3^n+1)/2)")

# validate against the O(N^2) oracle
expect = brute_force_count(D, eps, device=device)
assert pairs.shape[0] == expect, (pairs.shape[0], expect)
print(f"validated against brute force: {expect} pairs")
