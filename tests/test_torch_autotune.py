"""The port's measured tile and route table (``kernels/autotune.py``), the
route choice and the index-cache counters, held to the JAX package.

For the same table contents and features both packages make the same
decisions: the pure functions on a grid of inputs, the workload features,
the heuristic and the label of ``self_join_count(route=None)`` with both
tables empty and with one seeded row. Seeded tile rows (64 and 256 rows)
steer both packages' launches alike: the same tiles and the same (hits,
counts, slot_base), and the same pairs from ``self_join`` and
``epsilon_join``. Zero tolerance. Each package reads its own table, in a
temporary directory (``both_tables``).
"""
import gc
import json

import numpy as np
import pytest

import repro.core.grid as jgrid
import repro.core.query_join as jqj
import repro.core.selfjoin as jsj
import repro.kernels.autotune as jtune
import repro_torch
import repro_torch.core.grid as tgrid
import repro_torch.core.query_join as tqj
import repro_torch.core.selfjoin as tsj
import repro_torch.kernels.autotune as ttune
import repro_torch.kernels.ops as tops
from test_torch_query_join import query_mix
from torch_workloads import SMOKE, WORKLOADS, both_tables
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
FIELDS = ("total_pairs", "cells_visited", "candidates_checked", "offsets",
          "route")
# the heuristic's sparse regime (the JAX package's test_fused_count_auto_
# route): 6-D points nearly all alone in their neighbourhoods
SPARSE_6D = (np.random.default_rng(21).uniform(0, 60, (250, 6)), 7.0)
DENSE_2D = (np.random.default_rng(21).uniform(0, 10, (400, 2)), 0.6)


def stats(s):
    return tuple(getattr(s, f) for f in FIELDS)


def test_shipped_table_has_no_rows():
    from pathlib import Path

    path = Path(ttune.__file__).with_name("autotune_cache.json")
    assert json.loads(path.read_text()) == {"__schema__": 3}
    assert ttune.SCHEMA_VERSION == jtune.SCHEMA_VERSION
    assert (ttune.DEFAULT_TQ, ttune.TQ_CANDIDATES) == (jtune.DEFAULT_TQ,
                                                      jtune.TQ_CANDIDATES)


def test_autotune_tile_and_route_cache(tmp_path, monkeypatch):
    """The port of the JAX package's ``test_autotune_tile_and_route_cache``:
    defaults on a cold table, measured winners persisted and read again, a
    stale schema discarded."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    ttune._CACHE.reset()
    assert ttune.fused_tile(2, 16, backend=CPU) == ttune.DEFAULT_TQ
    tq = ttune.fused_tile(2, 16, backend=CPU, measure=True)
    assert tq in ttune.TQ_CANDIDATES
    ttune._CACHE.reset()
    assert ttune.fused_tile(2, 16, backend=CPU) == tq
    data = json.loads(path.read_text())
    assert data["__schema__"] == 3
    assert set(data["tile/cpu/2d/c16"]["ms"]) == {"64", "128", "256"}
    # a row of one backend does not steer another, nor jaccard the l2 rows
    assert ttune.fused_tile(2, 16, backend="cuda") == ttune.DEFAULT_TQ
    assert ttune.fused_tile(2, 16, backend=CPU, metric="jaccard",
                            measure=True) == ttune.DEFAULT_TQ
    assert ttune.fused_tile(2, 16, backend=CPU, metric="cosine") == tq
    route, src = ttune.count_route(
        n_dims=6, n_off=365, c=3, occupancy=0.005, live_frac=0.005,
        backend=CPU)
    assert (route, src) == ("sparse", "heuristic")
    calls = []
    cands = {"dense": lambda: calls.append("dense"),
             "jnp": lambda: calls.append("jnp")}
    route, src = ttune.count_route(
        n_dims=6, n_off=365, c=3, occupancy=0.005, live_frac=0.005,
        backend=CPU, candidates=cands, measure=True)
    assert src == "measured" and route in cands and calls
    cached, src = ttune.count_route(
        n_dims=6, n_off=365, c=3, occupancy=0.005, live_frac=0.005,
        backend=CPU)
    assert (cached, src) == (route, "cache")
    assert ttune.count_route(n_dims=6, n_off=365, c=3, occupancy=0.005,
                             live_frac=0.005, backend=CPU,
                             metric="jaccard") == ("dense", "forced")
    path.write_text(json.dumps(dict(data, __schema__=2)))
    ttune._CACHE.reset()
    assert ttune.fused_tile(2, 16, backend=CPU) == ttune.DEFAULT_TQ
    ttune._CACHE.reset()


def test_refused_tile_is_left_out(tmp_path, monkeypatch):
    """A candidate B1's wrapper refuses is not timed, and the refusal is
    kept in the row."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "t.json"))
    ttune._CACHE.reset()
    orig = tops.fused_join_hits

    def refuse_256(*a, tq, **kw):
        if tq == 256:
            raise ValueError("256 query rows need too much shared memory")
        return orig(*a, tq=tq, **kw)

    monkeypatch.setattr(tops, "fused_join_hits", refuse_256)
    tq = ttune.fused_tile(3, 8, backend=CPU, measure=True)
    row = ttune._CACHE.get("tile/cpu/3d/c8")
    assert tq in (64, 128) and set(row["ms"]) == {"64", "128"}
    assert "shared memory" in row["refused"]["256"]
    ttune._CACHE.reset()


def test_pure_functions_match_jax():
    for backend in ("tpu", "cpu", "cuda"):
        for n_dims in (2, 3, 6):
            for n_off in (2, 5, 14, 122, 365, 729):
                for c in (1, 3, 8, 40, 300):
                    for occ in (0.0001, 0.005, 0.3):
                        for live in (0.0, 0.01, 0.059, 0.06, 0.5, 1.0):
                            for merged in (False, True):
                                args = (backend, n_dims, n_off, c, occ, live,
                                        merged)
                                kw = dict(n_dims=n_dims, n_off=n_off, c=c,
                                          occupancy=occ, live_frac=live,
                                          backend=backend, merged=merged,
                                          measure=False)
                                if backend == "cuda":
                                    # the card's own branch: the dense
                                    # sweep until a measured row says
                                    # otherwise (JAX has no such backend)
                                    assert (ttune.route_heuristic(*args)
                                            == "dense")
                                    assert (ttune.count_route(**kw)
                                            == ("dense", "heuristic"))
                                    continue
                                assert (ttune.route_heuristic(*args)
                                        == jtune.route_heuristic(*args))
                                assert (ttune.count_route(**kw)
                                        == jtune.count_route(**kw))
                for metric in ("l2", "cosine", "jaccard"):
                    for c in (8, 16, 136, 3848):
                        assert (ttune.tile_key(backend, n_dims, c, metric)
                                == jtune.tile_key(backend, n_dims, c,
                                                  metric))
                    for live_class in (1, 4):
                        for merged in (False, True):
                            args = (backend, n_dims, 14, 8, live_class,
                                    merged, metric)
                            assert (ttune.route_key(*args)
                                    == jtune.route_key(*args))
    for x in (0, 0.5, 1, 3, 4, 5, 1000.5):
        assert ttune._pow2_class(x) == jtune._pow2_class(x)


@pytest.fixture(autouse=True)
def empty_tables(tmp_path):
    with both_tables(tmp_path):
        yield


@pytest.fixture(scope="module")
def indexes():
    """(JAX index by ``build_grid_host``, port index) per workload."""
    cache = {}

    def get(name):
        if name not in cache:
            pts, eps = {**WORKLOADS, "sparse-6d": SPARSE_6D,
                        "dense-2d": DENSE_2D}[name]
            cache[name] = (jgrid.build_grid_host(pts, eps),
                           tgrid.build_grid(pts, eps, device=CPU))
        return cache[name]

    return get


CASES = list(WORKLOADS) + ["sparse-6d", "dense-2d"]


@pytest.mark.parametrize("name", CASES)
def test_route_features_and_heuristic_match_jax(indexes, name):
    jidx, tidx = indexes(name)
    for unicomp in (True, False):
        jd, _ = jsj._offset_tables(jidx, unicomp)
        td, _ = tsj._offset_tables(tidx, unicomp)
        assert tsj._route_features(tidx, td) == jsj._route_features(jidx, jd)
        for n_off in (int(td.shape[0]), 3 ** tidx.n_dims):
            for backend in ("cpu", "tpu"):
                assert (tsj._fused_count_route(tidx, n_off, backend,
                                               unicomp=unicomp)
                        == jsj._fused_count_route(jidx, n_off, backend,
                                                  unicomp=unicomp))
            assert tsj._fused_count_route(tidx, n_off, "cuda",
                                          unicomp=unicomp) == "dense"
        for merged in (False, True):
            assert (tsj._auto_route(tidx, unicomp=unicomp, merged=merged)
                    == jsj._auto_route(jidx, unicomp=unicomp,
                                       merged=merged))


LABELS = [(n, True) for n in WORKLOADS] + [("sparse-6d", False),
                                           ("dense-2d", True)]


@pytest.mark.parametrize("name,unicomp", LABELS)
def test_route_label_matches_jax(name, unicomp):
    """``route=None`` with both tables empty: the heuristic's route, run and
    labelled as JAX runs and labels it."""
    pts, eps = {**WORKLOADS, "sparse-6d": SPARSE_6D, "dense-2d": DENSE_2D}[
        name]
    want = jsj.self_join_count(pts, eps, unicomp=unicomp,
                               distance_impl="fused")
    got = repro_torch.self_join_count(pts, eps, unicomp=unicomp, device=CPU)
    assert stats(got) == stats(want)
    if name == "sparse-6d":
        assert got.route == "sparse"


@pytest.mark.parametrize("route", ["sparse-flat", "dense-run", "jnp"])
def test_seeded_route_row_is_followed(tmp_path, indexes, route):
    """One route row, the same in both tables, for uniform-2d's class: both
    packages run and label it. The key is the port's, from its features;
    both backends are "cpu" here."""
    pts, eps = WORKLOADS["uniform-2d"]
    _, tidx = indexes("uniform-2d")
    feats = tsj._route_features(tidx, tsj._offset_tables(tidx, True)[0])
    n_off = int(tsj._merged_offset_tables(tidx, True)[1].shape[0])
    key = ttune.route_key(CPU, 2, n_off, ttune._pow2_class(feats["c"]),
                          ttune._pow2_class(feats["live_frac"] * n_off),
                          merged=True)
    row = {key: {"route": route, "ms": {}}}
    with both_tables(tmp_path, jax_rows=row, torch_rows=row):
        want = jsj.self_join_count(pts, eps, distance_impl="fused")
        got = repro_torch.self_join_count(pts, eps, device=CPU)
    assert stats(got) == stats(want)
    assert got.route == route


def tile_rows(tq: int) -> dict:
    """A tile row for every aligned capacity up to 4,096 at 2 and 3
    dimensions (l2)."""
    return {ttune.tile_key(CPU, n, c): {"tq": tq, "ms": {}}
            for n in (2, 3) for c in range(8, 4104, 8)}


def _launch_outputs(pkg, idx, launches, points_pad, deltas, is_zero):
    out = []
    for launch in launches:
        sel, q_start, q_size, qp, cap, tile = launch
        if pkg == "jax":
            kw = dict(qp=qp, c=cap, unicomp=True, keep_hits=True, tq=tile,
                      merged=True)
            if sel is None:
                r = jsj._fused_batch_run(idx, points_pad, deltas, is_zero,
                                         q_start, q_size=q_size, **kw)
            else:
                r = jsj._fused_bucket_launch(idx, points_pad, deltas,
                                             is_zero, sel, **kw)
            hits, counts, base = (np.asarray(x) for x in r[3:6])
        else:
            r = tsj._fused_launch(idx, points_pad, deltas, is_zero, launch,
                                  unicomp=True, keep_hits=True, merged=True)
            hits, counts, base = (x.numpy() for x in r[3:6])
        out.append((tile, qp, hits, counts, base))
    return out


@pytest.mark.parametrize("tq", [64, 256])
@pytest.mark.parametrize("name", list(SMOKE))
def test_seeded_tiles_match_jax(tmp_path, indexes, tq, name):
    pts, eps = SMOKE[name]
    jidx, tidx = indexes(name)
    rows = tile_rows(tq)
    with both_tables(tmp_path, jax_rows=rows, torch_rows=rows):
        jl, jpad, _ = jsj._fused_launches(jidx, n_batches=1, bucketed=None,
                                          merged=True)
        tl, tpad, _ = tsj._fused_launches(tidx, merged=True)
        assert [x[3:] for x in tl] == [x[3:] for x in jl]
        assert {x[5] for x in tl} == {tq}
        jd, jz = jsj._merged_offset_tables(jidx, True)
        td, tz = tsj._merged_offset_tables(tidx, True)
        want = _launch_outputs("jax", jidx, jl, jpad, jd, jz)
        got = _launch_outputs("torch", tidx, tl, tpad, td, tz)
        for g, w in zip(got, want):
            assert g[:2] == w[:2]
            for a, b in zip(g[2:], w[2:]):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        want_pairs = jsj.self_join(pts, eps, distance_impl="fused")
        got_pairs = repro_torch.self_join(pts, eps, device=CPU)
        assert np.array_equal(got_pairs.numpy(), want_pairs)
        q = query_mix(pts, eps, np.random.default_rng(3), n=200)
        jpj, tpj = jqj.prepare(jidx), tqj.prepare(tidx)
        assert tpj.tiles == jpj.tiles
        assert set(tpj.tiles.values()) == {min(tq, 128)}
        want_q, got_q = jpj.join(q), tpj.join(q)
        assert np.array_equal(got_q.counts, want_q.counts)
        assert np.array_equal(got_q.pairs, want_q.pairs)


def test_index_cache_lru_bound_and_stats(monkeypatch):
    """The port of the JAX package's ``test_index_cache_lru_bound_and_stats``
    and ``test_index_cache_eviction_is_recomputable``, the counters moving
    as JAX's do on the same sequence."""
    deltas = []
    for pkg, build in ((jgrid, jgrid.build_grid_host),
                       (tgrid, lambda p, e: tgrid.build_grid(p, e,
                                                             device=CPU))):
        monkeypatch.setattr(pkg, "_INDEX_CACHE_MAX", 3)
        pkg._INDEX_CACHE.clear()
        before = dict(pkg.index_cache_stats())
        rng = np.random.default_rng(12)
        indexes = [build(rng.uniform(0, 1, (60, 2)), 0.2) for _ in range(5)]
        calls = []
        for i, idx in enumerate(indexes):
            pkg.index_cached(idx, "t", lambda i=i: calls.append(i) or i)
        assert len(calls) == 5
        assert pkg.index_cache_stats()["size"] <= 3
        stats_now = pkg.index_cache_stats()
        assert stats_now["misses"] - before["misses"] == 5
        assert stats_now["evictions"] - before["evictions"] == 2
        assert pkg.index_cached(indexes[-1], "t", lambda: "rebuilt") == 4
        assert pkg.index_cache_stats()["hits"] - before["hits"] == 1
        # an evicted entry is rebuilt on demand, with the same value
        assert pkg.index_cached(indexes[0], "t", lambda: 0) == 0
        # dropping the last reference finalizes its entry (the loop
        # variable still aliases it); an evicted entry's late finalizer
        # neither raises nor counts
        idx = None
        indexes.pop()
        gc.collect()
        after = pkg.index_cache_stats()
        assert after["finalized"] > before["finalized"]
        del indexes
        gc.collect()
        final = pkg.index_cache_stats()
        deltas.append({k: final[k] - before.get(k, 0) for k in final})
        pkg._INDEX_CACHE.clear()
    assert deltas[1] == deltas[0]
    assert set(deltas[1]) == {"hits", "misses", "evictions", "finalized",
                              "size"}
