"""The port's self_join_count and public options, held to the JAX package.

The count's work counters must equal JAX's ``self_join_count(route="dense")``,
including ``dma_windows_issued``, which both packages compute from the
default 128-row tile. The other routes are held in ``test_torch_routes.py``.
"""
import pytest
import torch

import repro_torch
from torch_workloads import WORKLOADS, jax_runner
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return jax_runner(tmp_path_factory.mktemp("autotune"))


COUNT_CASES = ([(w, {}) for w in WORKLOADS]
               + [(w, {"merge_last_dim": False})
                  for w in ("uniform-2d", "clustered-2d", "expo-3d")]
               + [(w, {"bucketed": False}) for w in WORKLOADS]
               + [("expo-3d", {"query_batch": 1000})])


@pytest.mark.parametrize(
    "workload,kw", COUNT_CASES,
    ids=[w + "".join(f"-{k}={v}" for k, v in kw.items())
         for w, kw in COUNT_CASES])
def test_self_join_count_matches_jax(jax_results, workload, kw):
    want = jax_results("count", workload, **kw)
    pts, eps = WORKLOADS[workload]
    got = repro_torch.self_join_count(pts, eps, route="dense", device="cpu",
                                      **kw)
    for field in ("total_pairs", "cells_visited", "candidates_checked",
                  "offsets", "dma_windows_issued", "route"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("entry", ["self_join", "self_join_count",
                                   "build_grid", "self_join_count_compact",
                                   "per_point_neighbor_counts"])
def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, eps = WORKLOADS["uniform-2d"]
    fn = getattr(repro_torch, entry)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(pts[:100], eps)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(pts[:100], eps, device="cuda")
    fn(pts[:100], eps, device="cpu")


def test_unknown_route_is_a_value_error():
    with pytest.raises(ValueError, match="unknown route"):
        repro_torch.self_join_count(WORKLOADS["uniform-2d"][0][:100], 0.4,
                                    route="nope", device="cpu")

