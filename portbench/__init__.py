"""portbench -- the benchmark of the PyTorch/CUDA port ``repro_torch``.

Run one cell from the repository root:

    python3 portbench/run.py --workload syn2d2m.join --seed 7 --seconds 30 --trace 0

``BENCHMARK.json`` at the root names the cells, configurations, traffic
mixes and metrics; each lives in a file of its own under this folder
(``configs/``, ``traffic/``, ``drivers/``, ``generators/``, ``references/``,
``checks/``, ``metrics/``), found by the name the manifest gives it. Nothing
here imports JAX or the JAX package ``repro``; the reference and the checks
import nothing of ``repro_torch`` either.
"""
