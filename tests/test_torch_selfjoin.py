"""The port's self-join, held to the JAX package on the CPU.

Sorted pair sets must equal JAX's ``self_join(distance_impl="fused")`` for
every sweep and bucketing choice of the port, on the bench smoke workloads
plus a clustered 4-D and 6-D one.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import selfjoin as tsj
from torch_workloads import WORKLOADS, jax_runner
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return jax_runner(tmp_path_factory.mktemp("autotune"))


JOIN_CASES = [(w, m, b) for w in WORKLOADS for m in (True, False)
              for b in (True, False)]


@pytest.mark.parametrize(
    "workload,merge,bucketed", JOIN_CASES,
    ids=[f"{w}-{'merged' if m else 'cell'}-{'buckets' if b else 'one'}"
         for w, m, b in JOIN_CASES])
def test_self_join_matches_jax(jax_results, workload, merge, bucketed):
    want = jax_results("join", workload)
    pts, eps = WORKLOADS[workload]
    index = repro_torch.build_grid(pts, eps, device="cpu")
    got = tsj._self_join_fused(index, unicomp=True, sort_result=True,
                               bucketed=bucketed,
                               merged=tsj._resolve_merge(index, merge))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.shape[0] > 0


def test_self_join_public_api_matches_jax(jax_results):
    pts, eps = WORKLOADS["expo-3d"]
    got = repro_torch.self_join(pts, eps, device="cpu")
    assert np.array_equal(got.numpy(), jax_results("join", "expo-3d"))


@pytest.mark.parametrize("workload", ["clustered-2d", "expo-3d"])
def test_full_stencil_join_equals_unicomp(workload):
    pts, eps = WORKLOADS[workload]
    index = repro_torch.build_grid(pts, eps, device="cpu")
    a, b = (tsj._self_join_fused(index, unicomp=u, sort_result=True)
            for u in (True, False))
    assert torch.equal(a, b)


@pytest.mark.parametrize("index_dev,join_dev,ok", [
    ("cuda:0", "cuda", True), ("cuda:0", "cuda:0", True),
    ("cuda:1", "cuda:0", False), ("cuda:0", "cpu", False),
    ("cpu", "cuda", False)])
def test_given_index_device_check(index_dev, join_dev, ok):
    """A join on "cuda" takes an index built there, which lies on
    "cuda:<n>"; an index on another device is refused. The device check
    alone runs here, on an index stand-in that only names its device."""
    class Index:
        device = torch.device(index_dev)

    index = Index()
    if ok:
        assert tsj._resolve_index(None, 1.0, index,
                                  torch.device(join_dev)) is index
    else:
        with pytest.raises(ValueError, match="index lies on"):
            tsj._resolve_index(None, 1.0, index, torch.device(join_dev))


def test_self_join_stage_spans():
    """The driver's stages are profiler spans, each entered at least once."""
    pts, eps = WORKLOADS["uniform-2d"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        repro_torch.self_join(pts, eps, device="cpu")
    spans = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith("self_join.")}
    assert set(spans) == {"self_join.grid", "self_join.plan",
                          "self_join.kernel", "self_join.emit"}
    assert spans["self_join.grid"] == 1
