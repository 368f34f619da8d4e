"""The port's counts through the unfused offset sweep (``distance_impl="jnp"
| "pallas"``, ``route="jnp"``), the compact count route and per-point
neighbour counts, held to the JAX package (the joins are in
``test_torch_unfused.py``).

Inputs are the seeded workloads of ``torch_workloads``. JAX's "jnp" is the
reference on every workload; its "pallas" runs the Pallas kernel in the
interpreter (about 500x slower) and is held only at a few hundred points.
The port's "jnp" and "pallas" refine lane by lane in lane order, so they
give the same pairs bit for bit, and JAX's on seeded data, where no d^2 lies
within an ulp of eps^2 (XLA may pair lanes or contract a multiply-add there).
"""
import numpy as np
import pytest

import repro_torch
import repro.core.selfjoin as jsj
from repro_torch.core import selfjoin as tsj
from test_torch_unfused import IMPLS, LOW_DIMS, _same_stats
from test_torch_unfused import jax_runs  # noqa: F401  (fixture)
from torch_workloads import WORKLOADS
from torch_workloads import jax_tables  # noqa: F401  (fixture)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)


COUNT_CASES = ([(w, impl, {}) for w in WORKLOADS for impl in IMPLS]
               + [("expo-3d", impl, {"query_batch": 1000}) for impl in IMPLS]
               + [("uniform-2d", "jnp", {"unicomp": False}),
                  ("clustered-4d", "pallas", {"unicomp": False})])


@pytest.mark.parametrize(
    "workload,impl,kw", COUNT_CASES,
    ids=[f"{w}-{i}" + "".join(f"-{k}={v}" for k, v in kw.items())
         for w, i, kw in COUNT_CASES])
def test_self_join_count_matches_jax(jax_runs, workload, impl, kw):
    """Counters field by field; the route is ignored (labelled "dense")."""
    pts, eps = WORKLOADS[workload]
    want = jax_runs("self_join_count", workload, **kw)
    got = repro_torch.self_join_count(pts, eps, distance_impl=impl,
                                      route="sparse", device="cpu", **kw)
    assert want.route == "dense"
    _same_stats(got, want)


ROUTE_CASES = ([(w, route, unicomp) for w in LOW_DIMS
                for route in ("jnp", "compact") for unicomp in (True, False)]
               + [("clustered-6d", route, True)
                  for route in ("jnp", "compact")])


@pytest.mark.parametrize("workload,route,unicomp", ROUTE_CASES,
                         ids=[f"{w}-{r}-unicomp={u}"
                              for w, r, u in ROUTE_CASES])
def test_count_routes_match_jax(jax_runs, workload, route, unicomp):
    """route="jnp" and "compact" under the fused impl, labelled so."""
    pts, eps = WORKLOADS[workload]
    want = jax_runs("self_join_count", workload, distance_impl="fused",
                    route=route, unicomp=unicomp)
    got = repro_torch.self_join_count(pts, eps, route=route, unicomp=unicomp,
                                      device="cpu")
    assert got.route == route
    _same_stats(got, want)
    dense = repro_torch.self_join_count(pts, eps, unicomp=unicomp,
                                        device="cpu")
    assert got.total_pairs == dense.total_pairs


COMPACT_CASES = ([(w, impl, unicomp) for w in ("uniform-2d", "expo-3d")
                  for impl in ("fused", "jnp", "pallas")
                  for unicomp in (True, False)]
                 + [("clustered-6d", impl, True)
                    for impl in ("fused", "pallas")])


@pytest.mark.parametrize("workload,impl,unicomp", COMPACT_CASES,
                         ids=[f"{w}-{i}-unicomp={u}"
                              for w, i, u in COMPACT_CASES])
def test_self_join_count_compact_matches_jax(jax_runs, workload, impl,
                                             unicomp):
    """Each impl against JAX's "jnp" compact count (its "fused" and
    "pallas" counts give the same numbers; "pallas" is held at 300 points
    below)."""
    pts, eps = WORKLOADS[workload]
    want = jax_runs("self_join_count_compact", workload, unicomp=unicomp)
    got = tsj.self_join_count_compact(pts, eps, unicomp=unicomp,
                                      distance_impl=impl, device="cpu")
    _same_stats(got, want)


@pytest.mark.parametrize("impl", ["fused", "jnp", "pallas"])
def test_compact_small_matches_each_jax_impl(jax_tables, impl):
    pts = np.random.default_rng(23).uniform(0, 60, (300, 4))
    index = repro_torch.build_grid(pts, 6.0, device="cpu")
    for unicomp in (True, False):
        with jax_tables():
            want = jsj.self_join_count_compact(pts, 6.0, unicomp=unicomp,
                                               distance_impl=impl)
        got = tsj.self_join_count_compact(pts, 6.0, unicomp=unicomp,
                                          index=index, distance_impl=impl,
                                          device="cpu")
        _same_stats(got, want)
        assert tsj.compact_cap(index, unicomp) == jsj.compact_cap(
            jsj.build_grid(pts, 6.0), unicomp)


def test_cosine_counts_through_the_unfused_sweep(jax_tables):
    """Cosine with distance_impl="jnp" counts over the unit rows, as in
    the JAX package; route="compact" under "fused" too."""
    emb = np.random.default_rng(14).normal(size=(600, 4))
    emb[300:360] = emb[:60] * 2.5
    for kw in ({"distance_impl": "jnp"}, {"distance_impl": "pallas"},
               {"distance_impl": "fused", "route": "compact"}):
        with jax_tables():
            want = jsj.self_join_count(emb, 0.95, metric="cosine", **kw)
        got = repro_torch.self_join_count(emb, 0.95, metric="cosine",
                                          device="cpu", **kw)
        assert want.total_pairs > 120
        _same_stats(got, want)


PER_POINT_CASES = ([(w, m) for w in LOW_DIMS for m in (True, False)]
                   + [("clustered-6d", True)])


@pytest.mark.parametrize("workload,merged", PER_POINT_CASES,
                         ids=[f"{w}-merged={m}" for w, m in PER_POINT_CASES])
def test_per_point_neighbor_counts_match_jax(workload, merged):
    pts, eps = WORKLOADS[workload]
    want = jsj.per_point_neighbor_counts(pts, eps, merge_last_dim=merged)
    got = repro_torch.per_point_neighbor_counts(pts, eps,
                                                merge_last_dim=merged,
                                                device="cpu")
    assert got.dtype == np.int32 and np.array_equal(got, want)
    pairs = repro_torch.self_join(pts, eps, device="cpu")
    assert np.array_equal(got, np.bincount(pairs[:, 0].numpy(),
                                           minlength=len(pts)))


@pytest.mark.parametrize("merged", [True, False])
def test_per_point_counts_prebuilt_index_and_degenerates(merged):
    rng = np.random.default_rng(29)
    pts = np.concatenate([rng.uniform(0, 10, (300, 2)),
                          rng.normal(5.0, 0.1, (150, 2))])
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    hit = d2 <= 0.25
    np.fill_diagonal(hit, False)
    index = repro_torch.build_grid(pts, 0.5, device="cpu")
    got = repro_torch.per_point_neighbor_counts(pts, 0.5, index=index,
                                                merge_last_dim=merged,
                                                device="cpu")
    assert np.array_equal(got, hit.sum(1))
    assert np.array_equal(got, jsj.per_point_neighbor_counts(
        pts, 0.5, merge_last_dim=merged))
    iso = np.array([[0.0, 0.0], [5.0, 5.0], [9.0, 9.0]])
    assert np.array_equal(repro_torch.per_point_neighbor_counts(
        iso, 1.0, merge_last_dim=merged, device="cpu"), [0, 0, 0])
    dup = np.zeros((4, 3))
    assert np.array_equal(repro_torch.per_point_neighbor_counts(
        dup, 0.1, merge_last_dim=merged, device="cpu"), [3, 3, 3, 3])


