"""Half-precision points (float16, bfloat16) through the port, held to the
JAX package on the CPU.

The JAX package computes half points at the half dtype, by three rules, one
per path (``repro_torch/core/metric.py``'s module note): per-operation
rounding for the fused join and the external-query join (rule P), the
``jnp.sum`` of squares for the unfused sweep, its counts, per-point counts
and brute force "jnp" (rule S), and the float32 expanded form of the
brute-force tiles (rule U). Inputs are made with numpy from a seed; JAX gets
numpy float16 or ml_dtypes bfloat16 arrays, the port the same values as
torch tensors.

Tolerance: zero, except on the float16 rule-P paths (the fused join, its
counts, batched joins, external queries and the compact route's "fused"
refine). There XLA's jitted float16 code departs from per-operation rounding
on about 1 slot in 10^4, at positions no rule of values reproduces (eager
JAX equals the port there). Those comparisons allow a band: every pair that
differs has the port's d^2 within one float16 ulp of eps^2, and the number
of such pairs is printed and at most ``BAND_PAIRS``.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.grid as jgrid
import repro.core.metric as jmetric
import repro.core.query_join as jqj
import repro.core.selfjoin as jsj
import repro_torch
import repro_torch.core.grid as tgrid
from repro_torch.core import metric as tmetric
from repro_torch.core import query_join as tqj
from repro_torch.core import selfjoin as tsj
from torch_workloads import jax_tables  # noqa: F401  (fixture)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
BF16 = ml_dtypes.bfloat16
HALVES = {"f16": (np.float16, torch.float16), "bf16": (BF16, torch.bfloat16)}
# the float16 rule-P band: pairs that may differ from JAX's jitted answer
BAND_PAIRS = 8


def as_jax(x, half: str) -> np.ndarray:
    return np.asarray(x).astype(HALVES[half][0])


def as_torch(x, half: str) -> torch.Tensor:
    """The same values as ``as_jax(x, half)``, as a torch tensor."""
    return torch.from_numpy(as_jax(x, half).astype(np.float32)).to(
        HALVES[half][1])


def f64(x) -> np.ndarray:
    return np.asarray(x).astype(np.float64)


def data(n, d, seed, hi=20.0):
    return np.random.default_rng(seed).uniform(0.0, hi, (n, d))


# (name, raw points, eps): eps 1.3 rounds in both half dtypes, 1.5 in none
CASES = {
    "u2": (data(1500, 2, 0), 1.3),
    "u3": (data(1200, 3, 1), 1.5),
}
CASE_IDS = [(c, h) for c in CASES for h in HALVES]


def _sorted(pairs) -> np.ndarray:
    pairs = np.asarray(pairs).astype(np.int64).reshape(-1, 2)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def rule_p_d2(a: np.ndarray, b: np.ndarray, half: str) -> np.ndarray:
    """d^2 of rows ``a`` and ``b`` by rule P, one rounding to the half dtype
    per subtract, square and add (the port's ``metric.lane_d2``)."""
    dt = HALVES[half][0]
    r = lambda x: x.astype(dt).astype(np.float64)  # noqa: E731
    d2 = np.zeros(a.shape[0])
    for k in range(a.shape[1]):
        t = r(a[:, k] - b[:, k])
        d2 = r(d2 + r(t * t))
    return d2


def assert_pairs(got, want, half: str, *, band: bool, a_pts=None,
                 b_pts=None, eps=None):
    """``got`` equals ``want``; with ``band`` (float16, rule P) each pair in
    only one of them has the port's d^2 within one float16 ulp of eps^2, and
    there are at most ``BAND_PAIRS`` of them."""
    got, want = _sorted(got), _sorted(want)
    if not band or half != "f16":
        assert np.array_equal(got, want)
        return
    g = set(map(tuple, got.tolist()))
    w = set(map(tuple, want.tolist()))
    diff = np.asarray(sorted(g ^ w), np.int64).reshape(-1, 2)
    print(f"float16 rule-P band: {diff.shape[0]} pairs differ from JAX")
    assert diff.shape[0] <= BAND_PAIRS
    if diff.shape[0]:
        e = float(np.float16(eps))
        e2 = float(np.float16(e * e))
        d2 = rule_p_d2(a_pts[diff[:, 0]], b_pts[diff[:, 1]], half)
        assert np.all(np.abs(d2 - e2) <= float(np.spacing(np.float16(e2))))


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

def assert_fields(jidx, tidx):
    got = tgrid.index_to_numpy(tidx)
    for f in tgrid.FIELDS:
        want = np.asarray(getattr(jidx, f))
        dt = str(getattr(tidx, f).dtype).replace("torch.", "")
        assert dt == str(want.dtype), (f, dt, want.dtype)
        if want.dtype == BF16:
            want = want.astype(np.float32)
        assert np.array_equal(got[f], want), f


@pytest.mark.parametrize("case,half", CASE_IDS)
def test_grid_fields_match_jax(case, half):
    pts, eps = CASES[case]
    assert_fields(jgrid.build_grid(as_jax(pts, half), eps),
                  tgrid.build_grid(as_torch(pts, half), eps, device=CPU))


@pytest.mark.parametrize("half", list(HALVES))
def test_grid_geometry_on_a_lattice_of_extremes(half):
    """Extremes and eps over a lattice of scales and offsets: every field,
    grid_min's dtype included (float16 for float16, float32 for bfloat16)."""
    rng = np.random.default_rng(3)
    for lo in (-300.0, -7.25, 0.0, 0.1, 13.0, 250.0):
        for span in (0.5, 3.0, 40.0, 900.0):
            for eps in (0.07, 0.3, 1.3, 4.0):
                if span / eps > 4000:
                    continue
                pts = lo + rng.uniform(0.0, span, (64, 2))
                pts[0], pts[1] = lo, lo + span
                assert_fields(
                    jgrid.build_grid(as_jax(pts, half), eps),
                    tgrid.build_grid(as_torch(pts, half), eps, device=CPU))


def test_float16_geometry_overflow_is_refused():
    """(max - min + 2 eps) / eps past float16's 65,504: the port refuses,
    naming ROADMAP §C."""
    pts = np.array([[0.0, 0.0], [1000.0, 1.0]], np.float16)
    with pytest.raises(ValueError, match="ROADMAP §C"):
        tgrid.build_grid(pts, 0.01, device=CPU)
    tgrid.build_grid(pts.astype(np.float32), 0.01, device=CPU)


@pytest.mark.parametrize("kind", ["build_grid", "self_join", "epsilon_join"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_integer_points_are_refused(kind, dtype):
    """ROADMAP §C, C2: the JAX package casts eps to integer points' dtype and
    joins at a truncated radius; the port refuses integer points."""
    pts = np.random.default_rng(0).integers(0, 20, (200, 2)).astype(dtype)
    with pytest.raises(TypeError, match="ROADMAP §C"):
        if kind == "build_grid":
            tgrid.build_grid(pts, 1.5, device=CPU)
        elif kind == "self_join":
            tsj.self_join(pts, 1.5, device=CPU)
        else:
            tqj.epsilon_join(pts[:10], pts, 1.5, device=CPU)


# ---------------------------------------------------------------------------
# The merged lane
# ---------------------------------------------------------------------------

def deep(half):
    """2-D points dense near 0 whose grid reaches past the merged lane's
    exact range (bfloat16: 256; float16 coordinates are always exact)."""
    rng = np.random.default_rng(4)
    lo = -400.0 if half == "bf16" else -3000.0
    y = np.concatenate([rng.uniform(-2, 2, 998), [lo, 0.0]])
    return np.stack([rng.uniform(0, 3, 1000), y], 1)


def test_bf16_merged_lane_past_256_is_refused():
    """The JAX package's bfloat16 merged lane rounds cell coordinates past
    256 and its boundary mask drops true pairs; the port refuses the merged
    sweep there (ROADMAP §C) and gives JAX's per-cell answer."""
    pts = deep("bf16")
    t = as_torch(pts, "bf16")
    for fn in (lambda: tsj.self_join(t, 1.0, device=CPU),
               lambda: tsj.self_join_count(t, 1.0, device=CPU),
               lambda: tqj.epsilon_join(t[:50], t, 1.0, device=CPU)):
        with pytest.raises(ValueError, match="ROADMAP §C"):
            fn()
    want = jsj.self_join(as_jax(pts, "bf16"), 1.0, distance_impl="fused",
                         merge_last_dim=False)
    merged = jsj.self_join(as_jax(pts, "bf16"), 1.0, distance_impl="fused",
                           merge_last_dim=True)
    assert merged.shape[0] < want.shape[0]      # the reference's fault
    got = tsj.self_join(t, 1.0, merge_last_dim=False, device=CPU)
    assert_pairs(got.numpy(), want, "bf16", band=False)


def test_f16_merged_lane_is_exact_past_2048():
    """float16 cell coordinates are floors of float16 quotients, so the
    merged lane holds them exactly at any depth: merged equals per-cell, in
    both packages."""
    pts = deep("f16")
    t = as_torch(pts, "f16")
    merged = tsj.self_join(t, 1.0, device=CPU).numpy()
    cells = tsj.self_join(t, 1.0, merge_last_dim=False, device=CPU).numpy()
    assert np.array_equal(merged, cells)
    want = jsj.self_join(as_jax(pts, "f16"), 1.0, distance_impl="fused")
    p = f64(as_jax(pts, "f16"))
    assert_pairs(merged, want, "f16", band=True, a_pts=p, b_pts=p, eps=1.0)


# ---------------------------------------------------------------------------
# Joins and counts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_half():
    """``get(fn, case, half, **kw)``: a JAX entry point on a case, once."""
    cache = {}

    def get(fn, case, half, **kw):
        key = (fn, case, half, tuple(sorted(kw.items())))
        if key not in cache:
            pts, eps = CASES[case]
            cache[key] = getattr(jsj, fn)(as_jax(pts, half), eps, **kw)
        return cache[key]

    return get


FUSED = [(c, h, u, m) for c, h in CASE_IDS for u in (True, False)
         for m in (True, False)]


@pytest.mark.parametrize("case,half,unicomp,merge", FUSED)
def test_fused_join_matches_jax(jax_half, case, half, unicomp, merge):
    pts, eps = CASES[case]
    want = jax_half("self_join", case, half, distance_impl="fused",
                    unicomp=unicomp, merge_last_dim=merge)
    got = tsj.self_join(as_torch(pts, half), eps, unicomp=unicomp,
                        merge_last_dim=merge, device=CPU)
    assert got.dtype == torch.int32
    p = f64(as_jax(pts, half))
    assert_pairs(got.numpy(), want, half, band=True, a_pts=p, b_pts=p,
                 eps=eps)


@pytest.mark.parametrize("case,half", CASE_IDS)
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_unfused_join_matches_jax_jnp(jax_half, case, half, impl):
    """Rule S: exact. JAX's "jnp" and "pallas" compute the same sum; its
    "pallas" is held at 300 points below."""
    pts, eps = CASES[case]
    for unicomp in (True, False):
        want = jax_half("self_join", case, half, distance_impl="jnp",
                        unicomp=unicomp)
        got = tsj.self_join(as_torch(pts, half), eps, unicomp=unicomp,
                            distance_impl=impl, device=CPU)
        assert_pairs(got.numpy(), want, half, band=False)


@pytest.mark.parametrize("half", list(HALVES))
def test_unfused_pallas_matches_jax_pallas(half):
    pts = data(300, 2, 7)
    want = jsj.self_join(as_jax(pts, half), 1.3, distance_impl="pallas")
    got = tsj.self_join(as_torch(pts, half), 1.3, distance_impl="pallas",
                        device=CPU)
    assert_pairs(got.numpy(), want, half, band=False)


def _stats(s):
    return (s.total_pairs, s.cells_visited, s.candidates_checked, s.offsets,
            s.route, s.dma_windows_issued, s.dma_bytes_saved)


COUNTS = [(c, h, r) for c, h in CASE_IDS
          for r in ("dense", "dense-run", "compact", "jnp")]


@pytest.mark.parametrize("case,half,route", COUNTS)
def test_count_routes_match_jax(jax_half, jax_tables, case, half, route):
    """Every count route, with its counters. The fused routes ("dense",
    "dense-run" and "compact"'s "fused" refine) follow rule P: at float16
    their totals may differ from JAX's within the band; the counters do
    not depend on distances. Route "jnp" follows rule S: exact."""
    pts, eps = CASES[case]
    with jax_tables():
        want = jax_half("self_join_count", case, half, distance_impl="fused",
                        route=route)
    got = tsj.self_join_count(as_torch(pts, half), eps, route=route,
                              device=CPU)
    g, w = _stats(got), _stats(want)
    assert g[1:] == w[1:]
    if half == "f16" and route != "jnp":
        print(f"float16 rule-P band: totals differ by {g[0] - w[0]}")
        assert abs(g[0] - w[0]) <= 2 * BAND_PAIRS
    else:
        assert g[0] == w[0]
    if route != "jnp":
        pairs = tsj.self_join(as_torch(pts, half), eps, device=CPU)
        assert got.total_pairs == pairs.shape[0]


@pytest.mark.parametrize("case,half", CASE_IDS)
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_unfused_counts_match_jax(jax_half, case, half, impl):
    """self_join_count and the compact count through the unfused impls:
    rule S, exact, counters included."""
    pts, eps = CASES[case]
    want = jax_half("self_join_count", case, half, distance_impl="jnp")
    got = tsj.self_join_count(as_torch(pts, half), eps, distance_impl=impl,
                              device=CPU)
    assert _stats(got) == _stats(want)
    want = jax_half("self_join_count_compact", case, half,
                    distance_impl="jnp")
    got = tsj.self_join_count_compact(as_torch(pts, half), eps,
                                      distance_impl=impl, device=CPU)
    assert _stats(got)[:4] == _stats(want)[:4]


@pytest.mark.parametrize("case,half", CASE_IDS)
def test_batched_join_matches_jax(jax_half, case, half):
    pts, eps = CASES[case]
    for impl in ("fused", "jnp"):
        want = jax_half("self_join_batched", case, half, distance_impl=impl,
                        n_batches=3)
        got = tsj.self_join_batched(as_torch(pts, half), eps, n_batches=3,
                                    distance_impl=impl, device=CPU)
        p = f64(as_jax(pts, half))
        assert_pairs(got.numpy(), want, half, band=impl == "fused",
                     a_pts=p, b_pts=p, eps=eps)


@pytest.mark.parametrize("case,half", CASE_IDS)
@pytest.mark.parametrize("merge", [True, False])
def test_per_point_counts_match_jax(jax_half, case, half, merge):
    """Rule S: exact."""
    pts, eps = CASES[case]
    want = jax_half("per_point_neighbor_counts", case, half,
                    merge_last_dim=merge)
    got = tsj.per_point_neighbor_counts(as_torch(pts, half), eps,
                                        merge_last_dim=merge, device=CPU)
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("case,half", CASE_IDS)
@pytest.mark.parametrize("merge", [True, False])
def test_epsilon_join_matches_jax(case, half, merge):
    """External queries (B1 (b)), inside and around the volume: rule P, so
    float16 takes the band; counts agree with the pairs. A request eps the
    half dtype does not hold (1.3) exceeds the index's rounded build eps, and
    both packages refuse it (ROADMAP §C); the join then runs at the rounded
    eps."""
    pts, eps = CASES[case]
    q = np.random.default_rng(9).uniform(-2.0, 22.0, (300, pts.shape[1]))
    if float(as_jax(eps, half)) != eps:
        for fn, a in ((jqj.epsilon_join, as_jax), (tqj.epsilon_join,
                                                  as_torch)):
            with pytest.raises(ValueError, match="exceeds index build eps"):
                fn(a(q, half), a(pts, half), eps,
                   **({} if fn is jqj.epsilon_join else {"device": CPU}))
        eps = float(as_jax(eps, half))
    want = jqj.epsilon_join(as_jax(q, half), as_jax(pts, half), eps,
                            merge_last_dim=merge)
    got = tqj.epsilon_join(as_torch(q, half), as_torch(pts, half), eps,
                           merge_last_dim=merge, device=CPU)
    assert_pairs(got.pairs, want.pairs, half, band=True,
                 a_pts=f64(as_jax(q, half)), b_pts=f64(as_jax(pts, half)),
                 eps=eps)
    assert np.bincount(got.pairs[:, 0], minlength=300).tolist() == \
        got.counts.tolist()
    if half == "bf16":
        assert np.array_equal(got.counts, np.asarray(want.counts))
    counts = repro_torch.range_query(as_torch(q, half), as_torch(pts, half),
                                     eps, merge_last_dim=merge, device=CPU)
    assert np.array_equal(counts, got.counts)


@pytest.mark.parametrize("half", list(HALVES))
def test_services_serve_half_points(half):
    """JoinService and BatchingJoinService over half points answer as the
    one-shot epsilon_join does (whose answers the JAX package's are held
    to above): requests of half tensors, and of float64 arrays cast as the
    index's dtype, coalesced and sliced back per request."""
    from repro_torch.launch import serve

    pts, eps = CASES["u3"]
    t = as_torch(pts, half)
    rng = np.random.default_rng(12)
    raw = [rng.uniform(-2.0, 22.0, (k, 3)) for k in (5, 130, 64, 1)]
    reqs = [as_torch(raw[0], half), raw[1], as_torch(raw[2], half), raw[3]]
    svc = serve.JoinService(t, eps, return_pairs=True, device=CPU)
    bat = serve.BatchingJoinService(t, eps, return_pairs=True, max_batch=256,
                                    device=CPU)
    tickets = [bat.submit(q) for q in reqs]
    bat.drain()
    assert bat.n_launches < len(reqs)          # requests were coalesced
    for q, ticket in zip(reqs, tickets):
        want = tqj.epsilon_join(q, t, eps, device=CPU)
        for got in (svc.query(q), ticket.result()):
            assert np.array_equal(got.counts, want.counts)
            assert np.array_equal(got.pairs, want.pairs)


# ---------------------------------------------------------------------------
# Cosine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", list(HALVES))
def test_cosine_join_from_half_embeddings(half):
    """float16 embeddings keep float16 unit rows; bfloat16 ones, which numpy
    does not count as floating, become float64 in both packages."""
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(1500, 4))
    emb[700:760] = emb[:60] * 1.5 + 0.01 * rng.normal(size=(60, 4))
    canon = tmetric.canonicalize(as_torch(emb, half), 0.99,
                                 metric="cosine")
    jcanon = jmetric.canonicalize(as_jax(emb, half), 0.99, metric="cosine")
    assert str(canon.geom.dtype) == str(jcanon.geom.dtype) == \
        ("float16" if half == "f16" else "float64")
    assert np.array_equal(canon.geom, jcanon.geom)
    want = jsj.self_join(as_jax(emb, half), 0.99, metric="cosine")
    got = tsj.self_join(as_torch(emb, half), 0.99, metric="cosine",
                        device=CPU)
    g = f64(canon.geom)
    assert_pairs(got.numpy(), want, half, band=True, a_pts=g, b_pts=g,
                 eps=canon.eps_geom)
    total = tsj.self_join_count(as_torch(emb, half), 0.99, metric="cosine",
                                device=CPU).total_pairs
    assert total == got.shape[0]
    q = as_torch(emb[:100], half)
    res = tqj.epsilon_join(q, as_torch(emb, half), 0.99, metric="cosine",
                           device=CPU)
    if half == "bf16":
        jres = jqj.epsilon_join(as_jax(emb[:100], half), as_jax(emb, half),
                                0.99, metric="cosine")
        assert_pairs(res.pairs, jres.pairs, half, band=False)
    else:
        # JAX refuses: its check of the index radius against the chord
        # allows float32 rounding, not float16's (ROADMAP §C). The port
        # serves, and its queries are points of the index: their pairs are
        # the self-join's rows, plus each query's own point.
        with pytest.raises(ValueError, match="does not match"):
            jqj.epsilon_join(as_jax(emb[:100], half), as_jax(emb, half),
                             0.99, metric="cosine")
        mine = got.numpy()
        mine = mine[mine[:, 0] < 100]
        own = np.stack([np.arange(100)] * 2, 1)
        assert_pairs(res.pairs, np.concatenate([mine, own]), half,
                     band=False)


# ---------------------------------------------------------------------------
# Lattices: many pairs at d^2 == eps^2
# ---------------------------------------------------------------------------

def lattice(side=9, d=2):
    """Sites of a grid of pitch 1/8, each twice: at eps 5/8 many d^2 equal
    eps^2 exactly (3-4-5 triangles and axis steps), in every half dtype."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * d, indexing="ij"), -1)
    g = g.reshape(-1, d) / 8.0
    return np.concatenate([g, g])


def lattice_pairs(pts, eps):
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    hit = d2 <= eps * eps
    np.fill_diagonal(hit, False)
    return np.argwhere(hit)


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("rule", ["P", "S", "U"])
def test_lattice_boundary_pairs_exact(half, rule):
    """Each rule of the module note against an exact integer-style count on
    a lattice where many d^2 land exactly on eps^2: rule P (fused join,
    merged and per cell, and its counts), rule S (the unfused sweep through
    "jnp" and "pallas", brute force "jnp", per-point counts), rule U (brute
    force "pallas")."""
    pts = lattice()
    eps = 0.625
    want = lattice_pairs(pts, eps)
    t = as_torch(pts, half)
    assert want.shape[0] > 1000
    if rule == "P":
        for merge in (True, False):
            got = tsj.self_join(t, eps, merge_last_dim=merge, device=CPU)
            assert np.array_equal(got.numpy(), want)
        assert tsj.self_join_count(t, eps, device=CPU).total_pairs == \
            want.shape[0]
    elif rule == "S":
        for impl in ("jnp", "pallas"):
            got = tsj.self_join(t, eps, distance_impl=impl, device=CPU)
            assert np.array_equal(got.numpy(), want)
        assert repro_torch.brute_force_count(t, eps, device=CPU) == \
            want.shape[0]
        deg = tsj.per_point_neighbor_counts(t, eps, device=CPU)
        assert np.array_equal(deg, np.bincount(want[:, 0],
                                               minlength=len(pts)))
    else:
        got = repro_torch.brute_force_join(t, eps, distance_impl="pallas",
                                           device=CPU)
        assert np.array_equal(got.numpy(), want)
