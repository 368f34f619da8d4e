"""The port's join services with the cosine and Jaccard metrics, held to the
JAX package's services on the same request streams.

``JoinService`` and ``BatchingJoinService`` take raw embeddings or token
sets, canonicalize them against the index's form, and must answer every
request (counts and sorted pairs) exactly as the JAX services do, a
stricter per-request threshold included. After ``warm()`` a stream of
mixed-size metric requests builds, loads and prepares nothing (the
counterpart of the JAX package's no-retrace test across metric requests).
"""
import warnings

import numpy as np
import pytest

from repro.launch import serve as jserve
from repro_torch.core import query_join as tqj
from repro_torch.launch import serve
from repro_torch.launch.serve import (BatchingJoinService, JoinService,
                                      ShardedJoinService)
from test_torch_metric import binary_matrix, embeddings, token_sets
from torch_workloads import jax_tables  # noqa: F401  (fixture)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)


def stream_for(metric, seed):
    """(points, eps, a stricter eps, requests of mixed sizes)."""
    sizes = (3, 17, 32, 8, 100)
    if metric == "cosine":
        return (embeddings(seed), 0.9, 0.97,
                [embeddings(seed + k + 1, n=max(n, 8))[:n]
                 for k, n in enumerate(sizes)])
    return (token_sets(seed), 0.5, 0.7,
            [token_sets(seed + k + 1, n=max(n, 8), vocab=140)[:n]
             for k, n in enumerate(sizes)])


def warm(svc, batch):
    """Warm a service and start its steady window."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # warmup() marks steady
        svc.warmup(batch)
    svc.mark_steady()


def assert_same(got, want):
    assert np.array_equal(got.counts, want.counts)
    if want.pairs is None:
        assert got.pairs is None
    else:
        assert np.array_equal(got.pairs, want.pairs)


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
@pytest.mark.parametrize("return_pairs", [True, False])
def test_join_service_matches_jax(jax_tables, metric, return_pairs):
    pts, eps, tight, reqs = stream_for(metric, 30)
    with jax_tables():
        jsvc = jserve.JoinService(pts, eps, return_pairs=return_pairs,
                                  metric=metric)
        want = [jsvc.query(q) for q in reqs]
        want_tight = [jsvc.query(q, eps=tight) for q in reqs]
    svc = JoinService(pts, eps, return_pairs=return_pairs, metric=metric,
                      device="cpu")
    assert svc.prepared.metric == metric
    assert svc.prepared.merged == (metric == "cosine")
    for q, w, wt in zip(reqs, want, want_tight):
        assert_same(svc.query(q), w)
        assert_same(svc.query(q, eps=tight), wt)
    assert sum(w.total for w in want) > sum(w.total for w in want_tight) > 0
    with pytest.raises(ValueError, match="below the index build"):
        svc.query(reqs[0], eps=eps - 0.2)
    with pytest.raises(ValueError, match="pass raw points"):
        JoinService(pts, eps, index=svc.index, metric=metric, device="cpu")


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
def test_batching_service_matches_jax(jax_tables, metric):
    """Coalesced launches (geometry and feature rows concatenated at
    admission), a request wider than ``max_batch``, and a stricter
    threshold that must not share a launch."""
    pts, eps, tight, reqs = stream_for(metric, 40)
    wide = (embeddings(60, n=300) if metric == "cosine"
            else token_sets(60, n=300, vocab=140))
    stream = reqs + [wide]
    with jax_tables():
        jbat = jserve.BatchingJoinService(pts, eps, return_pairs=True,
                                          max_batch=128, metric=metric)
        jt = [jbat.submit(q) for q in stream] + [jbat.submit(reqs[1],
                                                             eps=tight)]
        jbat.drain()
        want = [t.result() for t in jt]
    bat = BatchingJoinService(pts, eps, return_pairs=True, max_batch=128,
                              metric=metric, device="cpu")
    tickets = [bat.submit(q) for q in stream] + [bat.submit(reqs[1],
                                                            eps=tight)]
    bat.pump()
    bat.drain()
    for t, w in zip(tickets, want):
        assert_same(t.result(), w)
    assert bat.n_launches == jbat.n_launches
    assert bat.coalesce_factor == jbat.coalesce_factor


def test_batching_service_binary_matrix_requests():
    """Jaccard requests as (Q, V) binary matrices, as the serving driver
    sends them, equal the token-set form."""
    sets = token_sets(50, vocab=64)
    q = token_sets(51, n=90, vocab=64)
    a = BatchingJoinService(binary_matrix(sets, 64), 0.5, return_pairs=True,
                            metric="jaccard", device="cpu")
    b = JoinService(sets, 0.5, return_pairs=True, metric="jaccard",
                    vocab=64, device="cpu")
    assert_same(a.query(binary_matrix(q, 64)), b.query(q))


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
def test_join_service_no_rebuild_across_metric_requests(metric):
    """After ``warm()``, mixed-size metric requests build, load and prepare
    nothing (the port's counterpart of the JAX package's no-retrace gate
    across metric requests)."""
    if metric == "cosine":
        pts, eps = embeddings(70, n=1000), 0.95
        make = lambda k, s: np.random.default_rng(s).normal(  # noqa: E731
            size=(k, 4))
    else:
        pts, eps = token_sets(70, n=1000), 0.5
        make = lambda k, s: token_sets(s, n=max(k, 8))[:k]  # noqa: E731
    svc = JoinService(pts, eps, return_pairs=True, metric=metric,
                      device="cpu")
    warm(svc, 32)
    before = tqj.executable_cache_stats()
    for i, size in enumerate((3, 17, 32, 8)):
        res = svc.query(make(size, 20 + i))
        assert res.counts.shape == (size,)
    svc.assert_no_retrace()
    after = tqj.executable_cache_stats()
    assert {k: v for k, v in after.items() if k != "trace_events"} == \
        {k: v for k, v in before.items() if k != "trace_events"}


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
def test_metric_reindex_keeps_answers(metric):
    """A reindex canonicalizes the new points in its thread and swaps; the
    answers to the same requests stay the same (point ids follow the new
    order)."""
    pts, eps, _, reqs = stream_for(metric, 80)
    svc = JoinService(pts, eps, return_pairs=True, metric=metric,
                      device="cpu")
    warm(svc, 128)
    before = [svc.query(q) for q in reqs]
    perm = np.random.default_rng(0).permutation(len(pts))
    new = pts[perm] if metric == "cosine" else [pts[i] for i in perm]
    svc.reindex(new, wait=True)
    assert svc.swaps == 1
    for q, b in zip(reqs, before):
        got = svc.query(q)
        assert np.array_equal(got.counts, b.counts)
        mapped = got.pairs.copy()
        mapped[:, 1] = perm[mapped[:, 1]]
        mapped = mapped[np.lexsort((mapped[:, 1], mapped[:, 0]))]
        assert np.array_equal(mapped, b.pairs)
    svc.assert_no_retrace()


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
@pytest.mark.parametrize("extra", [[], ["--batching"],
                                   ["--return-pairs", "--reindex"]])
def test_serve_cli_metric_on_cpu(metric, extra):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # warmup() marks steady
        p50 = serve.main(["--arch", "selfjoin", "--device", "cpu",
                          "--metric", metric, "--points", "1500",
                          "--dims", "4", "--eps", "2.0", "--requests", "3",
                          "--request-batch", "32"] + extra)
    assert p50 > 0


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
def test_sharded_services_match_jax(jax_tables, metric):
    """ShardedJoinService and BatchingJoinService(n_slabs=3) per metric: the
    slabs cut the canonical geometry, a request is canonicalized once, and
    every answer (a stricter threshold included) equals JAX's sharded
    services' and the port's single index's."""
    pts, eps, tight, reqs = stream_for(metric, 70)
    with jax_tables():
        jsh = jserve.ShardedJoinService(pts, eps, 3, return_pairs=True,
                                        metric=metric)
        want = [jsh.query(q) for q in reqs] + [jsh.query(reqs[1],
                                                         eps=tight)]
        jbat = jserve.BatchingJoinService(pts, eps, n_slabs=3,
                                          return_pairs=True, max_batch=128,
                                          metric=metric)
        jt = [jbat.submit(q) for q in reqs]
        jbat.drain()
    single = JoinService(pts, eps, return_pairs=True, metric=metric,
                         device="cpu")
    svc = ShardedJoinService(pts, eps, 3, return_pairs=True, metric=metric,
                             device="cpu")
    warm(svc, 128)
    got = [svc.query(q) for q in reqs] + [svc.query(reqs[1], eps=tight)]
    svc.assert_no_retrace()
    for g, w in zip(got, want):
        assert_same(g, w)
    for q, g in zip(reqs, got):
        assert_same(g, single.query(q))
    bat = BatchingJoinService(pts, eps, n_slabs=3, return_pairs=True,
                              max_batch=128, metric=metric, device="cpu")
    tickets = [bat.submit(q) for q in reqs]
    bat.drain()
    for t, w in zip(tickets, jt):
        assert_same(t.result(), w.result())
    assert bat.n_launches == jbat.n_launches


@pytest.mark.parametrize("metric", ["cosine", "jaccard"])
@pytest.mark.parametrize("extra", [[], ["--batching", "--return-pairs"]])
def test_serve_cli_metric_slabs_on_cpu(metric, extra):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # warmup() marks steady
        p50 = serve.main(["--arch", "selfjoin", "--device", "cpu",
                          "--metric", metric, "--points", "1500",
                          "--dims", "4", "--eps", "2.0", "--requests", "3",
                          "--request-batch", "32", "--slabs", "2"] + extra)
    assert p50 > 0
