"""The port's batched self-join (paper SV-A), held to the JAX package.

``self_join_batched(distance_impl="fused")`` must return, on the host, the
sorted pair set of JAX's ``self_join_batched(distance_impl="fused")`` and of
the port's own ``self_join``, for any number of batches; the launch schedule
must be JAX's, batch for batch.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import grid as jgrid
from repro.core import selfjoin as jsj
from repro_torch.core import selfjoin as tsj
from torch_workloads import SMOKE, WORKLOADS
from torch_workloads import jax_tables  # noqa: F401  (fixture)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def port_joins():
    cache = {}

    def get(workload):
        if workload not in cache:
            pts, eps = WORKLOADS[workload]
            cache[workload] = repro_torch.self_join(pts, eps, device="cpu")
        return cache[workload]

    return get


# the smoke workloads; 4-D and 6-D batches are held to JAX by the
# schedule test below and by test_torch_runs
CASES = [(w, n) for w in SMOKE for n in (1, 3, 7)]


@pytest.mark.parametrize("workload,n_batches", CASES,
                         ids=[f"{w}-{n}" for w, n in CASES])
def test_self_join_batched_matches_jax(jax_tables, port_joins, workload,
                                       n_batches):
    pts, eps = WORKLOADS[workload]
    with jax_tables():
        want = jsj.self_join_batched(pts, eps, n_batches=n_batches,
                                     distance_impl="fused")
    got = repro_torch.self_join_batched(pts, eps, n_batches=n_batches,
                                        device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.int32
    assert want.shape[0] > 0
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, port_joins(workload))


@pytest.mark.parametrize("workload", ["uniform-2d", "clustered-4d"])
@pytest.mark.parametrize("bucketed", [True, False])
def test_batched_schedule_matches_jax(jax_tables, workload, bucketed):
    """Each bucket (or the one contiguous class) is cut to
    ceil(N / n_batches) rows, as in the JAX package."""
    pts, eps = WORKLOADS[workload]
    jidx = jgrid.build_grid(pts, eps)
    tidx = repro_torch.build_grid(pts, eps, device="cpu")
    with jax_tables():
        want, jpad, _ = jsj._fused_launches(jidx, n_batches=3,
                                            bucketed=bucketed, merged=True)
    got, tpad, _ = tsj._fused_launches(tidx, n_batches=3, bucketed=bucketed,
                                       merged=True)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert (g[0] is None) == (w[0] is None)
        if g[0] is not None:
            assert np.array_equal(g[0], w[0])
        assert g[1:] == w[1:]
    assert np.array_equal(tpad.numpy(), np.asarray(jpad))


@pytest.mark.parametrize("npts", [1, 2])
@pytest.mark.parametrize("n_batches", [1, 3, 7])
def test_batched_tiny_sets_clamp(jax_tables, npts, n_batches):
    """More batches than points clamp to one batch per point."""
    pts = np.array([[0.0, 0.0], [0.05, 0.0]])[:npts]
    with jax_tables():
        want = jsj.self_join_batched(pts, 0.1, n_batches=n_batches,
                                     distance_impl="fused")
    got = repro_torch.self_join_batched(pts, 0.1, n_batches=n_batches,
                                        device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert got.shape[0] == (2 if npts == 2 else 0)
    index = repro_torch.build_grid(pts, 0.1, device="cpu")
    launches, _, _ = tsj._fused_launches(index, n_batches=n_batches,
                                         merged=True)
    assert len(launches) == min(n_batches, npts)

