"""Epsilon-join serving on the PyTorch port: index once, answer batched
external-query requests.

``repro_torch.launch.serve.JoinService`` builds the grid index over the
dataset at start-up, does each request bucket's start-up work off the
request path, and answers every batch of external query points through the
fused query join (kernel B1's external-query launches). The command fails
if a steady-state request builds or loads a kernel library or redoes a
prepare-time build, as ``serve_join.py`` does with the JAX package.

Run:  PYTHONPATH=src python examples/torch_serve_join.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import main

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="CUDA by default; 'cpu' runs the plain versions")
    device = ap.parse_args().device
    main(["--arch", "selfjoin", "--points", "50000", "--dims", "4",
          "--eps", "2.5", "--requests", "10", "--request-batch", "512"]
         + ([] if device is None else ["--device", device]))
