"""The port's cell-run loop, held to the JAX package on the CPU.

Run plans, per-cell descriptor tables, run-mode preps, run-loop pair sets,
``self_join_count(route="dense-run")`` and ``dma_window_stats`` must equal
the JAX package's exactly. JAX takes its tile from a measured table; every
JAX call here reads an empty one, so both packages use the 128-row tile.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro_torch
from repro.core import grid as jgrid
from repro.core import selfjoin as jsj
from repro_torch.core import grid as tgrid
from repro_torch.core import selfjoin as tsj
from torch_workloads import SMOKE, WORKLOADS, syn
from torch_workloads import jax_tables  # noqa: F401  (fixture)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

STATS_FIELDS = ("total_pairs", "cells_visited", "candidates_checked",
                "offsets", "route", "dma_windows_issued", "dma_bytes_saved")
# about 3.6 points a cell: both packages' joins take the run loop by default
DENSE = (syn(4000, 2, seed=7), 3.0)


@pytest.fixture(scope="module")
def indexes():
    """(JAX index, port index) per workload, built once."""
    cache = {}

    def get(workload):
        if workload not in cache:
            pts, eps = WORKLOADS[workload]
            cache[workload] = (jgrid.build_grid(pts, eps),
                               tgrid.build_grid(pts, eps, device="cpu"))
        return cache[workload]

    return get


def _tables(index, merged, unicomp, pkg):
    mod = jsj if pkg == "jax" else tsj
    fn = mod._merged_offset_tables if merged else mod._offset_tables
    return fn(index, unicomp)


@pytest.mark.parametrize("qp,tq", [(256, 128), (128, 128), (384, 64)])
def test_cell_run_plan_matches_jax(qp, tq):
    rng = np.random.default_rng(qp + tq)
    ids = np.sort(rng.integers(0, qp // 3, qp)).astype(np.int32)
    want = jgrid.cell_run_plan(ids, tq)
    got = tgrid.cell_run_plan(torch.as_tensor(ids), tq)
    assert got.run_ord.dtype == torch.int32
    assert np.array_equal(got.run_ord.numpy(), want.run_ord)
    assert got.n_runs == want.n_runs
    assert np.array_equal(got.run_lengths.numpy(), want.run_lengths)
    with pytest.raises(ValueError, match="multiple of tq"):
        tgrid.cell_run_plan(torch.as_tensor(ids[:-1]), tq)


SCHEDULES = [dict(), dict(bucketed=False), dict(n_batches=3),
             dict(bucketed=False, n_batches=3)]


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("merged", [True, False])
def test_launch_run_plans_match_jax(jax_tables, indexes, workload, merged):
    """Every launch of every schedule (buckets, one batch, batches): the
    same launch, and the same run_ord, n_runs and run_lengths."""
    jidx, tidx = indexes(workload)
    for kw in SCHEDULES:
        with jax_tables():
            want, _, _ = jsj._fused_launches(
                jidx, n_batches=kw.get("n_batches", 1),
                bucketed=kw.get("bucketed"), merged=merged)
            got, _, _ = tsj._fused_launches(tidx, merged=merged, **kw)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert (g[0] is None) == (w[0] is None)
                if g[0] is not None:
                    assert np.array_equal(g[0], w[0])
                assert g[1:] == w[1:]
                sel, q_start, _, qp, _, tile = w
                jp = jsj._launch_run_plan(jidx, sel, q_start, qp=qp,
                                          tile=tile)
                tp = tsj._launch_run_plan(
                    tidx, tsj._launch_positions(tidx, g), tile=tile)
                assert np.array_equal(tp.run_ord.numpy(), jp.run_ord)
                assert tp.n_runs == jp.n_runs
                assert np.array_equal(tp.run_lengths.numpy(), jp.run_lengths)


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("unicomp", [True, False])
def test_cell_window_tables_match_jax(indexes, workload, merged, unicomp):
    jidx, tidx = indexes(workload)
    want = jgrid.cell_window_tables(
        jidx, _tables(jidx, merged, unicomp, "jax")[0], merged=merged,
        tag=unicomp)
    got = tgrid.cell_window_tables(
        tidx, _tables(tidx, merged, unicomp, "torch")[0], merged=merged,
        tag=unicomp)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("merged", [True, False])
def test_table_preps_match(jax_tables, indexes, workload, merged):
    """The run-mode preps equal JAX's on every row, and the port's own
    searchsorted preps on every live row (the shared-window contract)."""
    jidx, tidx = indexes(workload)
    jdeltas, _ = _tables(jidx, merged, True, "jax")
    tdeltas, _ = _tables(tidx, merged, True, "torch")
    jtab = jgrid.cell_window_tables(jidx, jdeltas, merged=merged, tag=True)
    ttab = tgrid.cell_window_tables(tidx, tdeltas, merged=merged, tag=True)
    for kw in ({}, {"bucketed": False, "n_batches": 3}):
        with jax_tables():
            jpad = jsj._fused_launches(jidx, n_batches=kw.get("n_batches", 1),
                                       bucketed=kw.get("bucketed"),
                                       merged=merged)[1]
        launches, tpad, _ = tsj._fused_launches(tidx, merged=merged, **kw)
        for launch in launches:
            sel, q_start, q_size, qp, _, _ = launch
            got = tsj._launch_prep(tidx, tpad, tdeltas, launch, merged=merged,
                                   tables=ttab)
            if sel is None:
                want = jsj._fused_table_prep(
                    jidx, jpad, *jtab, jnp.asarray(q_start, jnp.int32),
                    qp=qp, q_limit=max(q_size, 1))
            else:
                sel_pad = np.zeros(qp, np.int32)
                sel_pad[:sel.shape[0]] = sel
                want = jsj._fused_table_bucket_prep(
                    jidx, jpad, *jtab, jnp.asarray(sel_pad),
                    jnp.asarray(sel.shape[0], jnp.int32), qp=qp)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w))
            search = tsj._launch_prep(tidx, tpad, tdeltas, launch,
                                      merged=merged)
            live = torch.arange(qp) < q_size
            for g, s in zip(got[:3], search[:3]):
                assert torch.equal(g[:, live], s[:, live])
            for g, s in zip(got[1:], search[1:]):
                assert torch.equal(g, s)


@pytest.fixture(scope="module")
def jax_pairs(jax_tables):
    cache = {}

    def get(workload, merged):
        if (workload, merged) not in cache:
            pts, eps = WORKLOADS[workload]
            with jax_tables():
                cache[workload, merged] = jsj._self_join_fused(
                    jgrid.build_grid(pts, eps), unicomp=True,
                    sort_result=True, merged=merged, run_loop=True)
        return cache[workload, merged]

    return get


# the per-cell sweep on the 2-D and 3-D workloads: at 4-D and 6-D its
# 3^n offsets cost the most time and add no case
JOIN_CASES = [(w, m, r) for w in WORKLOADS for m in (True, False)
              for r in (True, False) if m or w in SMOKE]


@pytest.mark.parametrize(
    "workload,merged,run_loop", JOIN_CASES,
    ids=[f"{w}-{'merged' if m else 'cell'}-{'runs' if r else 'rows'}"
         for w, m, r in JOIN_CASES])
def test_run_loop_join_matches_jax(jax_pairs, indexes, workload, merged,
                                   run_loop):
    _, tidx = indexes(workload)
    got = tsj._self_join_fused(tidx, unicomp=True, sort_result=True,
                               merged=merged, run_loop=run_loop)
    want = jax_pairs(workload, merged)
    assert want.shape[0] > 0
    assert np.array_equal(got.numpy(), want)


COUNT_CASES = ([(w, {}) for w in WORKLOADS]
               + [(w, {"merge_last_dim": False})
                  for w in ("uniform-2d", "clustered-4d")]
               + [("clustered-2d", {"bucketed": False}),
                  ("expo-3d", {"query_batch": 1000})])


@pytest.mark.parametrize(
    "workload,kw", COUNT_CASES,
    ids=[w + "".join(f"-{k}={v}" for k, v in kw.items())
         for w, kw in COUNT_CASES])
def test_dense_run_count_matches_jax(jax_tables, workload, kw):
    pts, eps = WORKLOADS[workload]
    with jax_tables():
        want = jsj.self_join_count(pts, eps, distance_impl="fused",
                                   route="dense-run", **kw)
    got = repro_torch.self_join_count(pts, eps, route="dense-run",
                                      device="cpu", **kw)
    for field in STATS_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.dma_bytes_saved > 0


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("merged", [True, False])
def test_dma_window_stats_match_jax(jax_tables, indexes, workload, merged):
    jidx, tidx = indexes(workload)
    with jax_tables():
        want = jsj.dma_window_stats(jidx, merged=merged)
    assert tsj.dma_window_stats(tidx, merged=merged) == want


def test_dense_data_takes_the_run_loop_in_both(jax_tables, monkeypatch):
    """At >= 2 points a cell both packages' ``self_join`` plan cell runs
    for every launch, and give the same pairs."""
    pts, eps = DENSE
    runs = {"jax": 0, "torch": 0}

    def spy(mod, key):
        real = mod._launch_run_plan

        def counted(*a, **k):
            runs[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, "_launch_run_plan", counted)

    spy(jsj, "jax")
    spy(tsj, "torch")
    with jax_tables():
        jidx = jgrid.build_grid(pts, eps)
        assert jsj._join_run_loop(jidx)
        want = jsj.self_join(pts, eps, index=jidx, distance_impl="fused")
        n_launches = len(jsj._fused_launches(jidx, n_batches=1,
                                             bucketed=None, merged=True)[0])
    tidx = tgrid.build_grid(pts, eps, device="cpu")
    assert tsj._join_run_loop(tidx)
    got = repro_torch.self_join(pts, eps, index=tidx, device="cpu")
    assert runs == {"jax": n_launches, "torch": n_launches}
    assert np.array_equal(got.numpy(), want)
