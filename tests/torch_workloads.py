"""Seeded workloads and JAX reference runs shared by the port's parity tests.

The generators are the bench's (``benchmarks/bench_selfjoin.py``) at the
bench smoke sizes. Test modules import ``one_torch_thread`` to get its
module-scoped autouse fixture.
"""
import numpy as np
import pytest
import torch


def syn(n, d, seed=0):
    return np.random.default_rng(seed).uniform(0, 100, size=(n, d))


def clustered(n, d, seed=3):
    rng = np.random.default_rng(seed)
    k = max(n // 200, 4)
    centers = rng.uniform(0, 100, (k, d))
    pts = centers[rng.integers(0, k, n)]
    return pts + rng.normal(0, 1.5, pts.shape)


def expo(n, d, seed=5):
    return np.random.default_rng(seed).exponential(10.0, (n, d))


SMOKE = {
    "uniform-2d": (syn(4000, 2), 0.4),
    "clustered-2d": (clustered(3000, 2), 0.4),
    "expo-3d": (expo(3000, 3), 1.2),
}
WORKLOADS = dict(SMOKE, **{
    "clustered-4d": (clustered(2000, 4), 3.0),
    "clustered-6d": (clustered(2000, 6), 4.0),
})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel worker
    processes, and a thread pool in each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_runner(table_dir):
    """``get(kind, workload, **kw)``: the JAX package's ``self_join`` (kind
    "join") or ``self_join_count(route="dense")`` (kind "count") on a
    workload, computed once. JAX reads its tile and sweep choices from a
    measured table; an empty one, in ``table_dir``, gives it the default
    128-row tile the port uses."""
    import repro.core.selfjoin as jsj
    from repro.kernels import autotune

    cache = {}
    empty_table = str(table_dir / "none.json")

    def get(kind, workload, **kw):
        key = (kind, workload, tuple(sorted(kw.items())))
        if key not in cache:
            pts, eps = WORKLOADS[workload]
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_AUTOTUNE_CACHE", empty_table)
                autotune._CACHE.reset()
                try:
                    if kind == "join":
                        cache[key] = jsj.self_join(pts, eps,
                                                   distance_impl="fused")
                    else:
                        cache[key] = jsj.self_join_count(
                            pts, eps, distance_impl="fused", route="dense",
                            **kw)
                finally:
                    autotune._CACHE.reset()
        return cache[key]

    return get
