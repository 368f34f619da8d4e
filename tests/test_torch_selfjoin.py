"""The port's self-join, held to the JAX package on the CPU.

Sorted pair sets must equal JAX's ``self_join(distance_impl="fused")`` for
every sweep and bucketing choice of the port, on the bench smoke workloads
plus a clustered 4-D and 6-D one.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import grid as tgrid
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


def _profiled(join):
    """``join()`` under the CPU profiler: (profile, the ``JOIN_EVENTS``
    moved by the call)."""
    before = tgrid.join_events()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        join()
    after = tgrid.join_events()
    return prof, {k: after[k] - before[k] for k in after}


def _span_parents(prof) -> list:
    """(name, innermost enclosing span's name or None) of every span of the
    self-join path in a profile."""
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name == "self_join"
             or e.name.startswith(("self_join.", "host_sync"))]
    out = []
    for name, s, e in spans:
        around = [(s2, n2) for n2, s2, e2 in spans
                  if (s2, e2) != (s, e) and s2 <= s and e <= e2]
        out.append((name, max(around)[1] if around else None))
    return out


STAGES = {"self_join.grid", "self_join.plan", "self_join.kernel",
          "self_join.emit"}


def test_self_join_stage_spans():
    """The join's stages are profiler spans under the root span
    ``self_join``, each entered at least once; the planning and emit
    sub-stages nest in their stage, and every ``host_sync`` in the call.
    The workload takes the cell-run loop, so every span is entered."""
    pts, eps = WORKLOADS["clustered-4d"]
    prof, _ = _profiled(lambda: repro_torch.self_join(pts, eps, device="cpu"))
    spans = {e.key: e.count for e in prof.key_averages()
             if e.key == "self_join" or e.key.startswith("self_join.")}
    assert set(spans) == {"self_join", "self_join.plan.tables",
                          "self_join.plan.launch", "self_join.plan.run_plan",
                          "self_join.emit.sort"} | STAGES
    assert spans["self_join"] == spans["self_join.grid"] == 1
    assert spans["self_join.plan.tables"] == 1
    assert spans["self_join.plan.launch"] == spans["self_join.kernel"] >= 1
    parents = _span_parents(prof)
    want = {"self_join.plan.tables": "self_join.plan",
            "self_join.plan.launch": "self_join.plan",
            "self_join.plan.run_plan": "self_join.plan",
            "self_join.emit.sort": "self_join.emit"}
    for name, parent in parents:
        if name == "self_join":
            assert parent is None
        elif name in STAGES:
            assert parent == "self_join", name
        elif name in want:
            assert parent == want[name], name
        else:
            assert name == "host_sync" and parent is not None
    assert any(p == "self_join" for n, p in parents if n == "host_sync")


@pytest.mark.parametrize("entry", ["self_join", "self_join_batched"])
def test_one_call_counts_its_host_syncs(entry):
    """One call moves ``calls`` by 1 and ``host_syncs`` by the ``host_sync``
    spans in its profile; the counters count the same outside a profile,
    where no span is opened."""
    pts, eps = WORKLOADS["clustered-2d"]
    join = getattr(repro_torch, entry)
    prof, moved = _profiled(lambda: join(pts, eps, device="cpu"))
    spans = sum(e.name == "host_sync" for e in prof.events())
    assert moved["calls"] == 1
    assert moved["host_syncs"] == spans > 0
    before = tgrid.join_events()
    join(pts, eps, device="cpu")
    after = tgrid.join_events()
    assert {k: after[k] - before[k] for k in after} == moved


def test_spans_open_only_while_a_profiler_records():
    import contextlib
    assert isinstance(tgrid.trace_span("self_join"), contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(tgrid.trace_span("self_join"),
                          torch.profiler.record_function)


def test_emit_counters_by_hand():
    """A 10 x 10 lattice at spacing 1 and eps 1: each point's own cell, one
    point a cell, so the merged 2-D sweep's UNICOMP stencil has 2 offsets
    and windows of at most 3 points, rounded to c = 8, in one launch of one
    128-row tile: 2 x 8 x 128 slots. Its hits are the 2 x 10 x 9 lattice
    edges, each an unordered pair, half the 360 ordered pairs."""
    xy = np.stack(np.meshgrid(np.arange(10.0), np.arange(10.0)), -1)
    pts = xy.reshape(-1, 2)
    index = repro_torch.build_grid(pts, 1.0, device="cpu")
    assert int(index.num_cells) == 100 and not tsj._join_run_loop(index)
    assert tsj._fused_tile(index, 8) == 128
    _, moved = _profiled(lambda: repro_torch.self_join(pts, 1.0,
                                                       device="cpu"))
    assert moved["emit_slots"] == 2 * 8 * 128
    assert moved["emit_hits"] == 2 * 10 * 9
    pairs = repro_torch.self_join(pts, 1.0, device="cpu")
    assert pairs.shape[0] == 2 * moved["emit_hits"] == 360


@pytest.mark.parametrize("workload", ["uniform-2d", "clustered-6d"])
def test_emit_counters_sum_the_launches(workload):
    """``emit_slots`` sums n_off x c x qp over the launches the schedule
    gives, and twice ``emit_hits`` is the pair count under UNICOMP."""
    pts, eps = WORKLOADS[workload]
    index = repro_torch.build_grid(pts, eps, device="cpu")
    merged = tsj._join_sweep_merged(index, unicomp=True, bucketed=None,
                                    merged=tsj._resolve_merge(index, None))
    tables = tsj._merged_offset_tables if merged else tsj._offset_tables
    n_off = tables(index, True)[1].shape[0]
    launches, _, _ = tsj._fused_launches(index, merged=merged)
    before = tgrid.join_events()
    pairs = repro_torch.self_join(pts, eps, index=index, device="cpu")
    after = tgrid.join_events()
    assert after["emit_slots"] - before["emit_slots"] == sum(
        n_off * launch[3] * launch[4] for launch in launches)
    assert 2 * (after["emit_hits"] - before["emit_hits"]) == pairs.shape[0]
