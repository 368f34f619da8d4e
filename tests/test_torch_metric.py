"""The port's metric trait, held to the JAX package with zero tolerance.

Canonicalization, token packing, the per-request threshold rules and the
brute-force oracles are numpy code in both packages and must give equal
arrays; the plain Jaccard refine of the fused sweep (the plain version of
kernel B1 (e)) must give the hits, counts and slot bases of the JAX
package's ``fused_join_hits(method="reference", metric="jaccard")`` on the
same launch inputs, for the self, UNICOMP and external masks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import metric as jmetric
from repro.core import selfjoin as jsj
from repro.kernels import fused_join as jfj
from repro_torch.core import grid as tgrid
from repro_torch.core import metric as tmetric
from repro_torch.core import query_join as tqj
from repro_torch.kernels import fused_join as tfj
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

TQ = 128


def embeddings(seed, n=2000, d=4):
    """Gaussian embeddings with scaled copies (cosine duplicates that L2
    misses) and near copies."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d))
    emb[n - 8: n - 4] = 3.0 * emb[:4]
    emb[n - 4:] = emb[4:8] + 0.01 * rng.normal(size=(4, d))
    return emb


def token_sets(seed, n=1500, vocab=120, hi=30):
    """Seeded token sets of 0..hi tokens (repeats and empty sets included),
    a twentieth of them near copies of an earlier set."""
    rng = np.random.default_rng(seed)
    out = [tuple(rng.integers(0, vocab, int(rng.integers(0, hi + 1))))
           for _ in range(n)]
    out[0] = ()
    out[1] = out[2]
    for i in rng.choice(np.arange(4, n), n // 20, replace=False):
        src = list(out[int(rng.integers(3, i))])
        if src:
            src[-1] = int(rng.integers(0, vocab))
        out[i] = tuple(src)
    return out


def binary_matrix(sets, vocab):
    mat = np.zeros((len(sets), vocab), np.float64)
    for i, s in enumerate(sets):
        mat[i, list(s)] = 1.0
    return mat


def assert_same_canonical(got, want):
    assert got.metric == want.metric
    assert got.geom.dtype == want.geom.dtype
    assert np.array_equal(got.geom, want.geom)
    if want.feats is None:
        assert got.feats is None
    else:
        assert got.feats.dtype == want.feats.dtype
        assert np.array_equal(got.feats, want.feats)
    assert (got.n_feat, got.eps, got.eps_geom, got.vocab, got.refine) == \
        (want.n_feat, want.eps, want.eps_geom, want.vocab, want.refine)


def test_trait_constants_match_jax():
    assert tmetric.METRICS == jmetric.METRICS
    assert tmetric.TOKEN_BITS == jmetric.TOKEN_BITS
    assert tmetric.NORM_TOL == jmetric.NORM_TOL
    for m in tmetric.METRICS:
        assert tmetric.check_metric(m) == jmetric.check_metric(m)
        assert tmetric.metric_feat_lanes(m, 5) == \
            jmetric.metric_feat_lanes(m, 5)
    for mod in (tmetric, jmetric):
        with pytest.raises(ValueError, match="unknown metric"):
            mod.check_metric("hamming")


@pytest.mark.parametrize("eps", [-1.0, -0.3, 0.0, 0.5, 0.9, 0.999, 0.99999])
def test_cosine_eps_geom_matches_jax(eps):
    assert tmetric.cosine_eps_geom(eps) == jmetric.cosine_eps_geom(eps)


CANON_CASES = {
    "l2": lambda: (np.random.default_rng(0).uniform(0, 10, (500, 3)), 0.7,
                   {}),
    "cosine-f64": lambda: (embeddings(1), 0.9, {}),
    "cosine-f32": lambda: (embeddings(2).astype(np.float32), 0.95, {}),
    "cosine-int": lambda: (np.random.default_rng(3).integers(
        -5, 6, (400, 3)) + np.array([[6, 0, 0]]), 0.8, {}),
    "jaccard-sets": lambda: (token_sets(4), 0.5, {}),
    "jaccard-vocab": lambda: (token_sets(5, vocab=70), 0.6,
                              {"vocab": 60}),
    "jaccard-matrix": lambda: (binary_matrix(token_sets(6, vocab=90), 90),
                               0.4, {}),
    "jaccard-t1": lambda: (token_sets(7), 1.0, {}),
}


@pytest.mark.parametrize("case", list(CANON_CASES))
def test_canonicalize_matches_jax(case):
    data, eps, kw = CANON_CASES[case]()
    metric = case.split("-")[0]
    want = jmetric.canonicalize(data, eps, metric=metric, **kw)
    got = tmetric.canonicalize(data, eps, metric=metric, **kw)
    assert_same_canonical(got, want)


@pytest.mark.parametrize("case", ["cosine-f64", "cosine-f32",
                                  "jaccard-sets", "jaccard-vocab",
                                  "jaccard-matrix"])
def test_canonicalize_queries_matches_jax(case):
    """Queries against the index's form; jaccard queries carry tokens out
    of the index's vocabulary, which count toward the size only."""
    data, eps, kw = CANON_CASES[case]()
    metric = case.split("-")[0]
    canon = jmetric.canonicalize(data, eps, metric=metric, **kw)
    if metric == "cosine":
        queries = embeddings(9, n=300).astype(np.asarray(data).dtype)
    elif case == "jaccard-matrix":
        queries = binary_matrix(token_sets(10, n=300, vocab=90), 90)
    else:
        queries = token_sets(10, n=300, vocab=canon.vocab + 40)
    want = jmetric.canonicalize_queries(canon, queries)
    got = tmetric.canonicalize_queries(
        tmetric.canonicalize(data, eps, metric=metric, **kw), queries)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("vocab", [None, 16, 50, 200])
@pytest.mark.parametrize("form", ["sets", "matrix"])
def test_pack_tokens_matches_jax(vocab, form):
    sets = token_sets(11, n=200, vocab=100)
    data = sets if form == "sets" else binary_matrix(sets, 100)
    want = jmetric.pack_tokens(data, vocab=vocab)
    got = tmetric.pack_tokens(data, vocab=vocab)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("bad", ["zero", "nan", "inf", "1d"])
def test_unit_rows_rejects_like_jax(bad):
    emb = embeddings(12, n=50)
    if bad == "zero":
        emb[[3, 17]] = 0.0
    elif bad == "nan":
        emb[5, 1] = np.nan
    elif bad == "inf":
        emb[7, 0] = np.inf
    else:
        emb = emb[:, 0]
    msgs = []
    for mod in (jmetric, tmetric):
        with pytest.raises(ValueError) as err:
            mod._unit_rows(emb, what="points")
        msgs.append(str(err.value))
        with pytest.raises(ValueError):
            mod.canonicalize(emb, 0.9, metric="cosine")
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("metric,data,eps", [
    ("cosine", embeddings(13, n=20), 1.0),
    ("cosine", embeddings(13, n=20), -1.5),
    ("jaccard", [(1, 2)], 0.0),
    ("jaccard", [(1, 2)], 1.5),
    ("jaccard", [(1, -2)], 0.5),
    ("l2", np.zeros(5), 1.0),
])
def test_canonicalize_refuses_like_jax(metric, data, eps):
    msgs = []
    for mod in (jmetric, tmetric):
        with pytest.raises(ValueError) as err:
            mod.canonicalize(data, eps, metric=metric)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


REQUESTS = [("l2", e, 1.0, 1.0) for e in (0.1, 1.0, 1.0 + 1e-13, 1.5)] + [
    ("cosine", e, 0.8, jmetric.cosine_eps_geom(0.8))
    for e in (0.8, 0.8 - 1e-13, 0.95, 0.99999, 0.5)] + [
    ("jaccard", e, 0.5, 4.0) for e in (0.5, 0.7, 1.0, 0.3)]


@pytest.mark.parametrize("metric,eps,index_eps,index_eps_geom", REQUESTS)
def test_request_scalar_matches_jax(metric, eps, index_eps, index_eps_geom):
    """The override rules: tighter requests map onto the kernel scalar,
    looser ones raise, with JAX's message."""
    kw = dict(index_eps=index_eps, index_eps_geom=index_eps_geom)
    try:
        want = jmetric.request_scalar(metric, eps, **kw)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tmetric.request_scalar(metric, eps, **kw)
        assert str(got.value) == str(err)
        return
    assert tmetric.request_scalar(metric, eps, **kw) == want


@pytest.mark.parametrize("metric", ["l2", "cosine", "jaccard"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("eps", [0.3, 0.5, 0.9, 1.0])
def test_refine_scalar_matches_jax(metric, dtype, eps):
    want = np.asarray(jmetric.device_refine_scalar(metric, eps, dtype))
    got = tmetric.device_refine_scalar(
        metric, eps, torch.float64 if dtype == np.float64 else torch.float32)
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)


def test_popcount16_is_exact():
    x = torch.arange(65536, dtype=torch.int32)
    want = jmetric._popcount16_table().astype(np.int32)
    assert np.array_equal(tmetric.popcount16(x).numpy(), want)
    assert np.array_equal(tmetric._popcount16_table(),
                          jmetric._popcount16_table())


@pytest.mark.parametrize("metric,data,eps", [
    ("cosine", embeddings(14, n=600), 0.9),
    ("cosine", embeddings(15, n=600, d=3), 0.999),
    ("jaccard", token_sets(16, n=600), 0.5),
    ("jaccard", token_sets(17, n=600), 1.0),
])
def test_oracles_match_jax(metric, data, eps):
    jc = jmetric.canonicalize(data, eps, metric=metric)
    tc = tmetric.canonicalize(data, eps, metric=metric)
    want = jmetric.brute_force_join_metric(jc)
    got = tmetric.brute_force_join_metric(tc, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert want.shape[0] > 0
    assert tmetric.brute_force_count_metric(tc, device="cpu") == \
        jmetric.brute_force_count_metric(jc) == want.shape[0]


def test_jaccard_similarity_matches_jax():
    sets = token_sets(18, n=40)
    for a in sets[:10]:
        for b in sets:
            assert tmetric.jaccard_similarity(a, b) == \
                jmetric.jaccard_similarity(a, b)


# --- the plain Jaccard refine of the fused sweep (B1 (e)'s plain version) ---

@pytest.fixture(scope="module")
def jaccard_launch():
    """JAX-prepared inputs of one contiguous per-cell launch of a Jaccard
    sweep at the global window capacity, per unicomp, as numpy arrays."""
    cache = {}

    def get(unicomp):
        if unicomp not in cache:
            canon = jmetric.canonicalize(token_sets(19), 0.5,
                                         metric="jaccard")
            jidx = jgrid.build_grid_host(canon.geom, canon.eps_geom)
            feats = jsj._metric_feats_sorted(canon, jidx)
            c = jgrid.global_window_cap(jidx, False)
            pp, qp = jsj._fused_pad(jidx, q_size=jidx.num_points, c=c,
                                    tq=TQ, feats=feats)
            deltas, is_zero = jsj._offset_tables(jidx, unicomp)
            ws, wc, _, qb, qpos = jsj._fused_prep(
                jidx, pp, deltas, jnp.asarray(0, jnp.int32), qp=qp,
                q_limit=jidx.num_points)
            cache[unicomp] = (canon, [np.asarray(a) for a in (
                pp, qb, ws, wc, is_zero.astype(jnp.int32), qpos)], c)
        return cache[unicomp]

    return get


def _compare_reference(arrays, eps, kw):
    want = jfj.fused_join_hits(*[jnp.asarray(a) for a in arrays], eps,
                               method="reference", **kw)
    got = tfj.fused_join_hits(*[torch.as_tensor(np.array(a))
                                for a in arrays], eps,
                              method="reference", **kw)
    for name, g, w in zip(("hits", "counts", "slot_base"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name
    return int(np.asarray(want[1]).sum())


@pytest.mark.parametrize("unicomp", [True, False])
@pytest.mark.parametrize("keep_hits", [True, False])
def test_jaccard_reference_matches_jax_reference(jaccard_launch, unicomp,
                                                 keep_hits):
    canon, arrays, c = jaccard_launch(unicomp)
    kw = dict(c=c, n_real=1, unicomp=unicomp, merged=False, tq=TQ,
              keep_hits=keep_hits, metric="jaccard", n_feat=canon.n_feat)
    assert _compare_reference(arrays, canon.eps, kw) > 0


def test_jaccard_points_pad_matches_jax(jaccard_launch):
    """Feature lanes right after the coordinates, before the merged lane."""
    canon, arrays, c = jaccard_launch(True)
    jidx = jgrid.build_grid_host(canon.geom, canon.eps_geom)
    feats = jsj._metric_feats_sorted(canon, jidx)
    lc = jgrid.point_last_coords(jidx)
    want = jfj.pad_points(jidx.points_sorted, c, last_coord=lc, feats=feats)
    tidx = tgrid.build_grid(canon.geom, canon.eps_geom, device="cpu")
    got = tfj.pad_points(tidx.points_sorted, c,
                         last_coord=tgrid.point_last_coords(tidx),
                         feats=torch.as_tensor(np.asarray(feats)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(arrays[0], np.asarray(jfj.pad_points(
        jidx.points_sorted, arrays[0].shape[0] - jidx.num_points,
        feats=feats)))


@pytest.mark.parametrize("keep_hits", [True, False])
@pytest.mark.parametrize("run_loop", [True, False])
def test_jaccard_external_reference_matches_jax_reference(keep_hits,
                                                          run_loop):
    """The external mask: the port's request launches (token sets, some out
    of the index's vocabulary), through both plain versions."""
    sets = token_sets(20, vocab=100)
    canon = tmetric.canonicalize(sets, 0.6, metric="jaccard")
    index = tgrid.build_grid(canon.geom, canon.eps_geom, device="cpu")
    pj = tqj.prepare(index, run_loop=run_loop, canon=canon)
    queries = sets[:300] + token_sets(21, n=200, vocab=140)
    _, launches = pj.launch_inputs(queries, keep_hits=keep_hits)
    total = 0
    for _, _, args, kw in launches:
        plain = {k: v for k, v in kw.items()
                 if k not in ("run_ord", "run_loop")}
        total += _compare_reference([a.numpy() for a in args[:6]], args[6],
                                    plain)
    assert total > 0
