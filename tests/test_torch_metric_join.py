"""The port's cosine and Jaccard joins, held to the JAX package exactly.

``self_join`` pair sets, ``self_join_count`` totals and work counters on the
"dense" and "dense-run" routes, and ``epsilon_join`` counts and pairs, with
``metric="cosine"`` and ``metric="jaccard"``, against the JAX package's
fused join on the same seeded numpy inputs. The cases of the JAX package's
own metric tests are here too: scaled duplicates that L2 misses, exact
duplicates at t = 1, and the l2 tag equal to the default.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import metric as jmetric
from repro.core import query_join as jqj
from repro.core import selfjoin as jsj
from repro_torch.core import grid as tgrid
from repro_torch.core import metric as tmetric
from repro_torch.core import query_join as tqj
from repro_torch.core import selfjoin as tsj
from repro_torch.kernels import fused_join as tfj
from test_torch_metric import binary_matrix, embeddings, token_sets
from torch_workloads import jax_tables  # noqa: F401  (fixture)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

CASES = {
    "cosine-0.9": ("cosine", lambda: embeddings(0), 0.9),
    "cosine-0.999-3d": ("cosine", lambda: embeddings(1, d=3), 0.999),
    "cosine-f32": ("cosine", lambda: embeddings(2).astype(np.float32), 0.95),
    "jaccard-0.5": ("jaccard", lambda: token_sets(3), 0.5),
    "jaccard-0.3-v60": ("jaccard", lambda: token_sets(4, vocab=60), 0.3),
    "jaccard-t1": ("jaccard", lambda: token_sets(5, vocab=200), 1.0),
}


def fused_join_jax(jax_tables, data, eps, metric, **kw):
    with jax_tables():
        return np.asarray(jsj.self_join(data, eps, metric=metric,
                                        distance_impl="fused", **kw))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("unicomp", [True, False])
def test_metric_self_join_matches_jax(jax_tables, case, unicomp):
    metric, make, eps = CASES[case]
    data = make()
    want = fused_join_jax(jax_tables, data, eps, metric, unicomp=unicomp)
    got = tsj.self_join(data, eps, metric=metric, unicomp=unicomp,
                        device="cpu")
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)
    assert want.shape[0] > 0


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("route", ["dense", "dense-run"])
def test_metric_count_matches_jax(jax_tables, case, route):
    """Totals and work counters, the window-read accounting included."""
    metric, make, eps = CASES[case]
    data = make()
    with jax_tables():
        want = jsj.self_join_count(data, eps, metric=metric,
                                   distance_impl="fused", route=route)
    got = tsj.self_join_count(data, eps, metric=metric, route=route,
                              device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_metric_count_query_batch_matches_jax(jax_tables):
    data = token_sets(6)
    with jax_tables():
        want = jsj.self_join_count(data, 0.5, metric="jaccard",
                                   distance_impl="fused", query_batch=300)
    got = tsj.self_join_count(data, 0.5, metric="jaccard", query_batch=300,
                              device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_l2_metric_tag_is_bit_identical_to_default():
    pts = np.random.default_rng(9).uniform(0, 10, (1500, 3))
    a = tsj.self_join(pts, 0.7, device="cpu")
    b = tsj.self_join(pts, 0.7, metric="l2", device="cpu")
    assert np.array_equal(a.numpy(), b.numpy())
    assert tsj.self_join_count(pts, 0.7, device="cpu") == \
        tsj.self_join_count(pts, 0.7, metric="l2", device="cpu")


def test_cosine_catches_scaled_duplicates_l2_misses(jax_tables):
    emb = embeddings(0)
    n = emb.shape[0]
    cos = tsj.self_join(emb, 0.9999, metric="cosine", device="cpu").numpy()
    l2 = tsj.self_join(emb, 1e-6, device="cpu").numpy()
    cos_pairs, l2_pairs = set(map(tuple, cos)), set(map(tuple, l2))
    for k in range(4):                   # the 3x-scaled copies
        assert (k, n - 8 + k) in cos_pairs
        assert (k, n - 8 + k) not in l2_pairs
    assert np.array_equal(cos, fused_join_jax(jax_tables, emb, 0.9999,
                                              "cosine"))


def test_jaccard_exact_duplicates_at_t1():
    """t = 1 joins exactly the equal non-empty sets (the size grid's cell
    width floors at 1)."""
    sets = token_sets(7)
    got = tsj.self_join(sets, 1.0, metric="jaccard", device="cpu").numpy()
    norm = [frozenset(s) for s in sets]
    want = sorted((i, j) for i in range(len(sets))
                  for j in range(len(sets))
                  if i != j and norm[i] and norm[i] == norm[j])
    assert [tuple(p) for p in got] == want and want


def test_jaccard_binary_matrix_equals_token_sets():
    sets = token_sets(8, vocab=32)
    a = tsj.self_join(sets, 0.5, metric="jaccard", vocab=32, device="cpu")
    b = tsj.self_join(binary_matrix(sets, 32), 0.5, metric="jaccard",
                      device="cpu")
    assert np.array_equal(a.numpy(), b.numpy()) and a.shape[0] > 0


@pytest.mark.parametrize("metric,make,eps", [
    ("cosine", lambda: embeddings(10), 0.9),
    ("jaccard", lambda: token_sets(11), 0.5),
    ("l2", lambda: np.random.default_rng(12).uniform(0, 10, (800, 3)), 0.7),
])
def test_canonical_passes_through(metric, make, eps):
    """A ready Canonical joins as its raw data does; a conflicting metric
    or threshold raises, as in the JAX package."""
    data = make()
    canon = tmetric.canonicalize(data, eps, metric=metric)
    want = tsj.self_join(data, eps, metric=metric, device="cpu")
    assert np.array_equal(tsj.self_join(canon, None, device="cpu").numpy(),
                          want.numpy())
    assert tsj.self_join(canon, eps, metric=metric, device="cpu").shape == \
        want.shape
    assert tsj.self_join_count(canon, None, device="cpu").total_pairs == \
        want.shape[0]
    jcanon = jmetric.canonicalize(data, eps, metric=metric)
    other = "jaccard" if metric != "jaccard" else "cosine"
    for mod, c, kw in ((tsj, canon, {"device": "cpu"}), (jsj, jcanon, {})):
        with pytest.raises(ValueError, match="conflicts with the canonical"):
            mod.self_join(c, eps + 0.001, **kw)
        with pytest.raises(ValueError, match="conflicts with the canonical"):
            mod.self_join_count(c, None, metric=other, **kw)


@pytest.mark.parametrize("route", ["sparse", "compact", "jnp", "dense-flat"])
def test_jaccard_refuses_other_routes(route):
    for mod, kw in ((tsj, {"device": "cpu"}), (jsj, {})):
        with pytest.raises(ValueError, match="does not support"):
            mod.self_join_count(token_sets(13, n=50), 0.5, metric="jaccard",
                                route=route, **kw)


def test_cosine_ignores_the_l2_options(jax_tables):
    """cosine builds its own grid and always runs the fused path, as in the
    JAX package: ``distance_impl`` and ``index`` are l2's."""
    emb = embeddings(14)
    pts = np.random.default_rng(0).uniform(0, 1, (50, 4))
    other = tgrid.build_grid(pts, 0.5, device="cpu")
    want = tsj.self_join(emb, 0.9, metric="cosine", device="cpu")
    got = tsj.self_join(emb, 0.9, metric="cosine", index=other,
                        distance_impl="jnp", device="cpu")
    assert np.array_equal(got.numpy(), want.numpy())


QUERY_CASES = {
    "cosine": ("cosine", lambda: embeddings(15),
               lambda: embeddings(16, n=400), 0.9),
    "cosine-f32": ("cosine", lambda: embeddings(17).astype(np.float32),
                   lambda: embeddings(18, n=300).astype(np.float32), 0.95),
    "jaccard": ("jaccard", lambda: token_sets(19),
                lambda: token_sets(19)[:200] + token_sets(20, n=200,
                                                          vocab=160), 0.5),
    "jaccard-matrix": ("jaccard",
                       lambda: binary_matrix(token_sets(21, vocab=64), 64),
                       lambda: binary_matrix(token_sets(22, n=300,
                                                        vocab=64), 64),
                       0.4),
}


@pytest.mark.parametrize("case", list(QUERY_CASES))
@pytest.mark.parametrize("merged", [True, False])
def test_metric_epsilon_join_matches_jax(jax_tables, case, merged):
    metric, make, make_q, eps = QUERY_CASES[case]
    data, q = make(), make_q()
    with jax_tables():
        want = jqj.epsilon_join(q, data, eps, metric=metric,
                                merge_last_dim=merged, emit="host")
    got = tqj.epsilon_join(q, data, eps, metric=metric,
                           merge_last_dim=merged, device="cpu")
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(got.pairs, want.pairs)
    assert got.n_offsets == want.n_offsets and want.total > 0


@pytest.mark.parametrize("metric,eps,tighter", [("cosine", 0.8, 0.95),
                                                 ("jaccard", 0.4, 0.7)])
def test_metric_request_override_matches_jax(jax_tables, metric, eps,
                                             tighter):
    """A stricter per-request threshold through a prepared index, in metric
    units, equals JAX's; a looser one raises."""
    data = embeddings(23) if metric == "cosine" else token_sets(23)
    q = embeddings(24, n=300) if metric == "cosine" else token_sets(24, n=300)
    tc = tmetric.canonicalize(data, eps, metric=metric)
    jc = jmetric.canonicalize(data, eps, metric=metric)
    from repro.core import grid as jgrid
    with jax_tables():
        jpj = jqj.prepare(jgrid.build_grid(np.asarray(jc.geom), jc.eps_geom),
                          canon=jc)
        want = [jpj.join(q, eps=e, emit="host") for e in (None, tighter)]
    tpj = tqj.prepare(tgrid.build_grid(tc.geom, tc.eps_geom, device="cpu"),
                      canon=tc)
    for w, e in zip(want, (None, tighter)):
        got = tpj.join(q, eps=e)
        assert np.array_equal(got.counts, w.counts)
        assert np.array_equal(got.pairs, w.pairs)
    assert want[1].total < want[0].total
    with pytest.raises(ValueError, match="below the index build"):
        tpj.join(q, eps=eps - 0.1)


def test_prepare_checks_the_canonical_radius():
    canon = tmetric.canonicalize(embeddings(25, n=300), 0.9, metric="cosine")
    index = tgrid.build_grid(canon.geom, 2 * canon.eps_geom, device="cpu")
    with pytest.raises(ValueError, match="does not match the canonical"):
        tqj.prepare(index, canon=canon)
    with pytest.raises(ValueError, match="not a prebuilt index"):
        tqj.epsilon_join(embeddings(26, n=20), None, 0.9, index=index,
                         metric="cosine")


@pytest.mark.parametrize("metric", ["cosine", "jaccard", "l2"])
def test_emit_steps_give_the_same_pairs(monkeypatch, metric):
    """The emits fill wide planes in steps of query tiles; any step gives
    the pairs of one step over the whole plane."""
    if metric == "cosine":
        data, eps, q = embeddings(27), 0.9, embeddings(28, n=500)
    elif metric == "jaccard":
        data, eps, q = token_sets(27), 0.5, token_sets(28, n=500)
    else:
        data = np.random.default_rng(27).uniform(0, 10, (2000, 3))
        eps, q = 0.7, np.random.default_rng(28).uniform(0, 10, (500, 3))
    whole = tsj.self_join(data, eps, metric=metric, device="cpu")
    served = tqj.epsilon_join(q, data, eps, metric=metric, device="cpu")
    monkeypatch.setattr(tfj, "EMIT_STEP_SLOTS", 1000)
    assert np.array_equal(
        tsj.self_join(data, eps, metric=metric, device="cpu").numpy(),
        whole.numpy())
    stepped = tqj.epsilon_join(q, data, eps, metric=metric, device="cpu")
    assert np.array_equal(stepped.pairs, served.pairs)
    assert whole.shape[0] > 0 and served.total > 0
