"""The count routes of ``self_join_count``, held to the JAX package.

The forced routes "dense-flat", "sparse" and "sparse-flat" must give JAX's
totals, work counters, offsets and label on every bench smoke workload,
UNICOMP on and off (the 6-D workload with UNICOMP only: its 365-729
per-cell offsets make every plain sweep slow on the CPU). The sparse
counter's pieces (the lookups, the four plane functions) are held element
by element, both lookup kinds at int32 and int64 keys; cosine rides the
sparse routes and Jaccard is refused on them in both packages; half points
follow rule P there (``core/metric.py``'s module note). The join's sweep
follows a "dense-flat" verdict and no other. Zero tolerance everywhere
except float16 totals, held to ``test_torch_half``'s band. Both packages
read empty measured tables (``both_tables``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.grid as jgrid
import repro.core.selfjoin as jsj
import repro_torch
import repro_torch.core.grid as tgrid
import repro_torch.core.selfjoin as tsj
from test_torch_half import BAND_PAIRS, CASES as HALF_CASES, HALVES
from test_torch_half import as_jax, as_torch
from torch_workloads import WORKLOADS, both_tables, clustered, syn
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
FIELDS = ("total_pairs", "cells_visited", "candidates_checked", "offsets",
          "route")


@pytest.fixture(autouse=True)
def empty_tables(tmp_path):
    with both_tables(tmp_path):
        yield


def stats(s):
    return tuple(getattr(s, f) for f in FIELDS)


FORCED = [(w, u, r) for w in WORKLOADS for u in (True, False)
          for r in ("dense-flat", "sparse", "sparse-flat")
          if u or not w.endswith("6d")]


@pytest.mark.parametrize("workload,unicomp,route", FORCED)
def test_forced_route_matches_jax(workload, unicomp, route):
    pts, eps = WORKLOADS[workload]
    want = jsj.self_join_count(pts, eps, unicomp=unicomp,
                               distance_impl="fused", route=route)
    got = repro_torch.self_join_count(pts, eps, unicomp=unicomp, route=route,
                                      device=CPU)
    assert stats(got) == stats(want)


# Both lookup kinds at both key dtypes: indexes built against the workload's
# geometry with the key dtype forced, and a grid fine enough for int64 keys
# by itself (2^31 cells and more).
LOOKUP_DATA = {
    "clustered-2d": (clustered(600, 2, seed=4) / 4, 0.3),
    "uniform-3d": (syn(500, 3, seed=6) / 10, 0.6),
    "fine-2d": (syn(400, 2, seed=8), 0.0015),
}
LOOKUPS = [(d, k, kd, r) for d in ("clustered-2d", "uniform-3d")
           for k in ("table", "keys") for kd in (np.int32, np.int64)
           for r in ("sparse", "sparse-flat")]
LOOKUPS += [("fine-2d", "keys", np.int64, r) for r in ("sparse",
                                                       "sparse-flat")]


def _indexes(data, key_dtype):
    pts, eps = LOOKUP_DATA[data]
    gmin, dims = jgrid.host_grid_geometry(pts, eps)
    jidx = jgrid.build_grid_with_geometry(
        jnp.asarray(pts), eps, jnp.asarray(gmin), jnp.asarray(dims),
        key_dtype=key_dtype)
    tidx = tgrid.build_grid_with_geometry(
        torch.as_tensor(pts), eps, gmin, dims, key_dtype=key_dtype)
    return pts, eps, jidx, tidx


@pytest.mark.parametrize("data,kind,key_dtype,route", LOOKUPS)
def test_both_lookups_match_jax(monkeypatch, data, kind, key_dtype, route):
    """``_LOOKUP_MAX_CELLS`` patched in both packages picks the kind; the
    lookups are equal element by element, and the counts and counters."""
    if kind == "keys":
        monkeypatch.setattr(jsj, "_LOOKUP_MAX_CELLS", 0)
        monkeypatch.setattr(tsj, "_LOOKUP_MAX_CELLS", 0)
    pts, eps, jidx, tidx = _indexes(data, key_dtype)
    assert tidx.cell_keys.dtype == getattr(torch, np.dtype(key_dtype).name)
    jkind, jtab = jsj._sparse_lookup(jidx)
    tkind, ttab = tsj._sparse_lookup(tidx)
    assert tkind == jkind == kind
    jtab = np.asarray(jtab)
    assert ttab.numpy().dtype == jtab.dtype
    assert np.array_equal(ttab.numpy(), jtab)
    for unicomp in (True, False):
        want = jsj.self_join_count(pts, eps, index=jidx, unicomp=unicomp,
                                   distance_impl="fused", route=route)
        got = repro_torch.self_join_count(pts, eps, index=tidx,
                                          unicomp=unicomp, route=route,
                                          device=CPU)
        assert stats(got) == stats(want)
        assert got.total_pairs == repro_torch.self_join_count(
            pts, eps, index=tidx, unicomp=unicomp, route="dense",
            device=CPU).total_pairs


@pytest.mark.parametrize("data,kind,key_dtype",
                         sorted({(d, k, kd) for d, k, kd, _ in LOOKUPS},
                                key=str))
def test_plane_functions_match_jax(monkeypatch, data, kind, key_dtype):
    """``_rank_plane_*`` and ``_range_plane_*`` element by element, UNICOMP
    and full stencils, at a row count past the points."""
    if kind == "keys":
        monkeypatch.setattr(jsj, "_LOOKUP_MAX_CELLS", 0)
        monkeypatch.setattr(tsj, "_LOOKUP_MAX_CELLS", 0)
    _, _, jidx, tidx = _indexes(data, key_dtype)
    _, jlook = jsj._sparse_lookup(jidx)
    _, tlook = tsj._sparse_lookup(tidx)
    qp = tgrid.round_up(tidx.num_points, 128) + 128
    dim_last = int(np.asarray(jidx.dims)[-1])
    for unicomp in (True, False):
        jd, _ = jsj._offset_tables(jidx, unicomp)
        td, _ = tsj._offset_tables(tidx, unicomp)
        jm, _ = jsj._merged_offset_tables(jidx, unicomp)
        tm, _ = tsj._merged_offset_tables(tidx, unicomp)
        if kind == "table":
            want = [jsj._rank_plane_table(
                jlook, jidx.cell_keys, jidx.point_cell_rank,
                jd.astype(jnp.int32), qp=qp)]
            want += jsj._range_plane_table(
                jlook, jidx.cell_keys, jidx.point_cell_rank,
                *(jm[i].astype(jnp.int32) for i in range(3)),
                jnp.asarray(dim_last, jnp.int32), qp=qp)
            got = [tsj._rank_plane_table(tlook, tidx.cell_keys,
                                         tidx.point_cell_rank,
                                         td.to(torch.int32), qp=qp)]
            got += tsj._range_plane_table(
                tlook, tidx.cell_keys, tidx.point_cell_rank,
                *(tm[i].to(torch.int32) for i in range(3)), dim_last, qp=qp)
        else:
            dt = jlook.dtype
            want = [jsj._rank_plane_search(jlook, jidx.point_cell_rank,
                                           jd.astype(dt), qp=qp)]
            want += jsj._range_plane_search(
                jlook, jidx.point_cell_rank,
                *(jm[i].astype(dt) for i in range(3)),
                jnp.asarray(dim_last, dt), qp=qp)
            got = [tsj._rank_plane_search(tlook, tidx.point_cell_rank,
                                          td.to(tlook.dtype), qp=qp)]
            got += tsj._range_plane_search(
                tlook, tidx.point_cell_rank,
                *(tm[i].to(tlook.dtype) for i in range(3)), dim_last, qp=qp)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype
            assert np.array_equal(g.numpy(), w)


def test_cosine_rides_the_sparse_routes():
    emb = np.random.default_rng(5).normal(size=(1500, 3))
    for route in ("sparse", "sparse-flat", None):
        want = jsj.self_join_count(emb, 0.97, metric="cosine",
                                   distance_impl="fused", route=route)
        got = repro_torch.self_join_count(emb, 0.97, metric="cosine",
                                          route=route, device=CPU)
        assert stats(got) == stats(want)


@pytest.mark.parametrize("route", ["sparse", "sparse-flat", "dense-flat"])
def test_jaccard_refuses_the_sparse_routes(route):
    sets = [[1, 2, 3], [2, 3, 4], [5, 6]]
    with pytest.raises(ValueError, match="jaccard"):
        jsj.self_join_count(sets, 0.5, metric="jaccard", route=route)
    with pytest.raises(ValueError, match="jaccard"):
        repro_torch.self_join_count(sets, 0.5, metric="jaccard",
                                    route=route, device=CPU)


@pytest.mark.parametrize("case,half",
                         [(c, h) for c in HALF_CASES for h in HALVES])
def test_half_points_through_the_sparse_routes(case, half):
    """Rule P: the probe refine is one op a subtract, square and add in
    lane order at the half dtype (``fused_window_hits``), as JAX's jitted
    ``_count_probes_span``. bfloat16 agrees exactly; float16 totals are
    held to the band of XLA's jitted float16 code. The counters do not
    depend on distances, and each total is the port's own pair count."""
    pts, eps = HALF_CASES[case]
    pairs = repro_torch.self_join(as_torch(pts, half), eps, device=CPU)
    for route in ("sparse", "sparse-flat"):
        want = jsj.self_join_count(as_jax(pts, half), eps,
                                   distance_impl="fused", route=route)
        got = repro_torch.self_join_count(as_torch(pts, half), eps,
                                          route=route, device=CPU)
        assert stats(got)[1:] == stats(want)[1:]
        if half == "f16":
            print(f"float16 rule-P band: totals differ by "
                  f"{got.total_pairs - want.total_pairs}")
            assert abs(got.total_pairs - want.total_pairs) <= 2 * BAND_PAIRS
        else:
            assert got.total_pairs == want.total_pairs
        assert got.total_pairs == pairs.shape[0]


def test_flat_route_overrides_and_join_sweep_verdict():
    """The port of the JAX package's ``test_flat_route_overrides_and_join_
    sweep_verdict``: "-flat" routes sweep per cell with the same totals and
    counters, and the join follows a cached "dense-flat" verdict only."""
    rng = np.random.default_rng(71)
    pts = rng.uniform(0, 10, (400, 2))
    index = tgrid.build_grid(pts, 0.6, device=CPU)
    a = repro_torch.self_join_count(pts, 0.6, index=index, unicomp=False,
                                    distance_impl="jnp", device=CPU)
    for route, n_off in (("dense-flat", 9), ("sparse-flat", 9),
                         ("dense", 3), ("sparse", 3)):
        s = repro_torch.self_join_count(pts, 0.6, index=index, route=route,
                                        unicomp=False, device=CPU)
        assert s.route == route
        assert s.offsets == n_off, route
        assert (s.total_pairs, s.cells_visited, s.candidates_checked) == \
            (a.total_pairs, a.cells_visited, a.candidates_checked), route
    assert tsj._join_sweep_merged(index, unicomp=True, bucketed=None,
                                  merged=True)
    jidx = jgrid.build_grid_host(pts, 0.6)
    assert jsj._join_sweep_merged(jidx, unicomp=True, bucketed=None,
                                  merged=True)
    assert not tsj._join_sweep_merged(index, unicomp=True, bucketed=None,
                                      merged=False)
    index2 = tgrid.build_grid(pts[:300], 0.6, device=CPU)
    tgrid.index_cached(index2, "route/True/None/True", lambda: "dense-flat")
    assert not tsj._join_sweep_merged(index2, unicomp=True, bucketed=None,
                                      merged=True)
    want = jsj.self_join(pts[:300], 0.6, distance_impl="jnp")
    assert np.array_equal(repro_torch.self_join(
        pts[:300], 0.6, index=index2, device=CPU).numpy(), want)
    index3 = tgrid.build_grid(pts[:300], 0.6, device=CPU)
    tgrid.index_cached(index3, "route/True/None/True", lambda: "sparse-flat")
    assert tsj._join_sweep_merged(index3, unicomp=True, bucketed=None,
                                  merged=True)
    assert np.array_equal(repro_torch.self_join(
        pts[:300], 0.6, index=index3, device=CPU).numpy(), want)


def test_sweep_verdict_reaches_batched_and_cosine_joins(monkeypatch):
    """``self_join_batched`` and the cosine join take their sweep from the
    verdict too; the slab join does not (neither does JAX's)."""
    seen = []
    real = tsj._self_join_fused

    def spy(index, **kw):
        seen.append(kw["merged"])
        return real(index, **kw)

    monkeypatch.setattr(tsj, "_self_join_fused", spy)
    monkeypatch.setattr(repro_torch.core.distributed, "_self_join_fused",
                        spy)
    monkeypatch.setattr(tsj, "_auto_route",
                        lambda *a, **kw: "dense-flat")
    pts, eps = WORKLOADS["uniform-2d"]
    want = jsj.self_join(pts[:800], eps, distance_impl="jnp")
    got = tsj.self_join_batched(pts[:800], eps, device=CPU)
    assert np.array_equal(got.numpy(), want) and seen == [False]
    emb = np.random.default_rng(5).normal(size=(300, 3))
    tsj.self_join(emb, 0.97, metric="cosine", device=CPU)
    assert seen == [False, False]
    repro_torch.core.distributed_self_join(pts[:800], eps, 2, device=CPU)
    assert seen[2:] and all(seen[2:])
