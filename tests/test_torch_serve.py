"""The port's join services and load generator, on the CPU.

Mirrors the JAX package's service tests (``tests/test_serve_batching.py``
and the service tests of ``tests/test_query_join.py``): coalescing is
exact under any partition of a query set, oversized requests split and
merge, requests of different eps never share a launch, the steady-state
statistics exclude warm-up, the watchdog holds across steady requests and
a reindex and fires when a counter moves, and the port's services answer a
request stream exactly as the JAX package's do.
"""
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import grid as jgrid
from repro.core import query_join as jqj
from repro.launch import serve as jserve
from repro_torch.core import grid as tgrid
from repro_torch.core import query_join as tqj
from repro_torch.kernels import build
from repro_torch.launch import loadgen, serve
from repro_torch.launch.serve import (BatchingJoinService, JoinService,
                                      ShardedJoinService)
from torch_workloads import jax_tables  # noqa: F401  (fixture)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)


def brute_counts(queries, pts, eps):
    d2 = ((queries[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return (d2 <= eps * eps).sum(1).astype(np.int32)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(7)
    return rng.uniform(0, 100, size=(2500, 3)), 3.0


@pytest.fixture(scope="module")
def prepared(dataset):
    pts, eps = dataset
    return tqj.prepare(tgrid.build_grid(pts, eps, device="cpu"))


def batching(dataset, **kw):
    pts, eps = dataset
    return BatchingJoinService(pts, eps, device="cpu", **kw)


def test_coalesce_requests_bounds():
    cat, bounds = tqj.coalesce_requests(
        [np.zeros((3, 2)), np.ones((0, 2)), np.full((5, 2), 2.0)])
    assert cat.shape == (8, 2)
    assert bounds.tolist() == [0, 3, 3, 8]
    with pytest.raises(ValueError):
        tqj.coalesce_requests([])
    with pytest.raises(ValueError):
        tqj.coalesce_requests([np.zeros((2, 2)), np.zeros((2, 3))])


def test_slice_result_matches_solo(prepared):
    q = np.random.default_rng(0).uniform(0, 100, size=(90, 3))
    res = prepared.join(q, return_pairs=True)
    mid = tqj.slice_result(res, 30, 70)
    solo = prepared.join(q[30:70], return_pairs=True)
    assert np.array_equal(mid.counts, solo.counts)
    assert np.array_equal(mid.pairs, solo.pairs)
    empty = tqj.slice_result(res, 12, 12)
    assert empty.counts.shape == (0,) and empty.pairs.shape == (0, 2)
    unsorted = prepared.join(q, sort_pairs=False)
    if np.any(np.diff(unsorted.pairs[:, 0]) < 0):
        with pytest.raises(ValueError, match="sorted"):
            tqj.slice_result(unsorted, 0, 10)


def test_join_async_matches_join(prepared):
    q = np.random.default_rng(1).uniform(0, 100, size=(150, 3))
    pending = prepared.join_async(q, return_pairs=True)
    assert isinstance(pending, tqj.PendingJoin)
    assert pending.ready()                     # the CPU has no queue
    res = pending.result()
    ref = prepared.join(q, return_pairs=True)
    assert np.array_equal(res.counts, ref.counts)
    assert np.array_equal(res.pairs, ref.pairs)
    assert pending.ready()
    assert pending.result() is res             # idempotent


def _serve_chunks(dataset, prepared, chunk_sizes, seed):
    rng = np.random.default_rng(seed)
    chunks = [rng.uniform(0, 100, size=(n, 3)) for n in chunk_sizes]
    svc = batching(dataset, return_pairs=True, max_batch=128,
                   max_wait_ms=0.5)
    with pytest.warns(UserWarning, match="auto-marking steady"):
        svc.warmup()
    tickets = [svc.submit(c) for c in chunks]
    svc.pump()
    svc.drain()
    for t, c in zip(tickets, chunks):
        assert t.done()
        got = t.result()
        if c.shape[0] == 0:
            assert got.counts.shape == (0,) and got.pairs.shape == (0, 2)
            continue
        solo = prepared.join(c, return_pairs=True)
        assert np.array_equal(got.counts, solo.counts)
        assert np.array_equal(got.pairs, solo.pairs)
    svc.assert_no_retrace()
    return svc


@pytest.mark.parametrize("chunk_sizes", [
    [40], [0, 40, 0], [17, 1, 63, 9], [200], [130, 0, 70, 200, 5]])
def test_partition_property(dataset, prepared, chunk_sizes):
    """Any partition of a query set served through the batching service
    gives every request the answer of serving it alone."""
    _serve_chunks(dataset, prepared, chunk_sizes, seed=3)


@settings(max_examples=12, deadline=None)
@given(st.lists(st.integers(0, 150), min_size=1, max_size=6),
       st.integers(0, 2**16))
def test_partition_property_any_chunking(dataset, prepared, chunk_sizes,
                                         seed):
    _serve_chunks(dataset, prepared, chunk_sizes, seed)


def test_oversized_request_splits_and_merges(dataset, prepared):
    q = np.random.default_rng(4).uniform(0, 100, size=(300, 3))
    svc = batching(dataset, return_pairs=True, max_batch=128)
    with pytest.warns(UserWarning):
        svc.warmup()
    t = svc.submit(q)
    assert t.n_parts == 3                       # 128 + 128 + 44
    svc.drain()
    got = t.result()
    ref = prepared.join(q, return_pairs=True)
    assert np.array_equal(got.counts, ref.counts)
    assert np.array_equal(got.pairs, ref.pairs)


def test_incomplete_ticket_raises(dataset):
    svc = batching(dataset, max_batch=128, max_wait_ms=1e6)
    with pytest.warns(UserWarning):
        svc.warmup()
    t = svc.submit(np.zeros((4, 3)))
    with pytest.raises(RuntimeError, match="incomplete"):
        t.result()
    svc.drain()
    assert t.result().counts.shape == (4,)


def test_mixed_eps_never_coalesce_but_both_answer(dataset, prepared):
    pts, eps = dataset
    rng = np.random.default_rng(5)
    qa = rng.uniform(0, 100, size=(30, 3))
    qb = rng.uniform(0, 100, size=(30, 3))
    svc = batching(dataset, max_batch=256)
    with pytest.warns(UserWarning):
        svc.warmup()
    ta = svc.submit(qa, eps=eps)
    tb = svc.submit(qb, eps=0.5 * eps)
    svc.drain()
    assert svc.n_launches == 2
    assert np.array_equal(ta.result().counts, prepared.counts(qa))
    assert np.array_equal(tb.result().counts,
                          prepared.counts(qb, eps=0.5 * eps))
    assert np.array_equal(tb.result().counts,
                          brute_counts(qb, pts, 0.5 * eps))


def test_no_retrace_and_coalescing_under_mixed_load(dataset):
    pts, eps = dataset
    rng = np.random.default_rng(6)
    svc = batching(dataset, max_batch=256, max_wait_ms=0.2)
    with pytest.warns(UserWarning):
        svc.warmup()
    for _ in range(30):
        n = int(rng.choice([1, 7, 32, 64, 300]))
        e = float(rng.choice([eps, 0.7 * eps]))
        svc.submit(rng.uniform(0, 100, size=(n, 3)), eps=e)
        svc.pump()
    svc.drain()
    svc.assert_no_retrace()
    assert svc.coalesce_factor > 1.0
    assert svc.n_coalesced / svc.n_launches == pytest.approx(
        svc.coalesce_factor)
    assert tqj.TRACE_EVENTS["metric:batch.launches"] >= svc.n_launches


def test_sync_query_path(dataset, prepared):
    q = np.random.default_rng(9).uniform(0, 100, size=(50, 3))
    svc = batching(dataset, max_batch=128)
    with pytest.warns(UserWarning):
        svc.warmup()
    res = svc.query(q)
    assert np.array_equal(res.counts, prepared.counts(q))
    assert len(svc.latencies_ms) == 1


def test_warmup_auto_marks_steady_with_warning(dataset):
    pts, eps = dataset
    svc = JoinService(pts, eps, device="cpu")
    with pytest.warns(UserWarning, match="auto-marking steady"):
        svc.warmup(32)
    assert svc._steady


def test_stats_exclude_warmup_window(dataset):
    pts, eps = dataset
    q = np.random.default_rng(10).uniform(0, 100, size=(32, 3))
    svc = JoinService(pts, eps, device="cpu")
    svc.query(q)
    assert len(svc.warmup_latencies_ms) == 1 and not svc.latencies_ms
    with pytest.warns(UserWarning):
        svc.warmup(32)
    for _ in range(3):
        svc.query(q)
    assert len(svc.latencies_ms) == 3
    p50, _ = svc.percentiles()
    lat = np.asarray(svc.latencies_ms)
    assert p50 == pytest.approx(float(np.percentile(lat, 50)))
    assert svc.requests_per_sec() == pytest.approx(
        3 / (lat.sum() / 1000), rel=1e-6)


def test_stats_fallback_warns_when_never_steady(dataset):
    pts, eps = dataset
    svc = JoinService(pts, eps, device="cpu")
    svc.query(np.random.default_rng(11).uniform(0, 100, size=(32, 3)))
    with pytest.warns(UserWarning, match="falling back to the warmup"):
        p50, _ = svc.percentiles()
    assert p50 > 0


def test_explicit_mark_steady_suppresses_warning(dataset):
    pts, eps = dataset
    svc = JoinService(pts, eps, device="cpu")
    svc.prepared.warm(32)
    svc.mark_steady()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        svc.warmup(32)
    assert svc._steady


@pytest.mark.parametrize("counter", [
    (build.EVENTS, "loads"), (build.EVENTS, "builds"),
    (tqj.PREPARE_EVENTS, "points_pad"), (tqj.PREPARE_EVENTS, "class_set"),
    (tgrid.BUILD_EVENTS, "external_range_cap")])
def test_assert_no_retrace_holds_and_fires(dataset, counter):
    """Steady requests of any size and eps move no counter; a moved counter
    (a library load, an nvcc build, a prepare-time build) raises."""
    pts, eps = dataset
    svc = JoinService(pts, eps, device="cpu", return_pairs=True)
    with pytest.warns(UserWarning):
        svc.warmup(64)
    rng = np.random.default_rng(12)
    for k in range(4):
        svc.query(rng.uniform(-5, 105, size=(5 + 37 * k, 3)),
                  eps=eps * (1 - 0.1 * k))
    svc.assert_no_retrace()
    table, key = counter
    table[key] += 1
    try:
        with pytest.raises(RuntimeError, match="steady state"):
            svc.assert_no_retrace()
    finally:
        table[key] -= 1
    svc.assert_no_retrace()


def test_reindex_swaps_and_answers_equally(dataset):
    pts, eps = dataset
    rng = np.random.default_rng(13)
    svc = JoinService(pts, eps, device="cpu", return_pairs=True)
    with pytest.warns(UserWarning):
        svc.warmup(64)
    qs = [rng.uniform(0, 100, size=(64, 3)) for _ in range(4)]
    before = [svc.query(q) for q in qs]
    old = svc.index
    perm = rng.permutation(pts.shape[0])
    svc.reindex(pts[perm], wait=True)
    assert svc.swaps == 1 and svc.index is not old
    assert set(svc.reindex_timings) == {"build_s", "plan_s", "warm_s",
                                        "swap_s"}
    for q, b in zip(qs, before):
        a = svc.query(q)
        assert np.array_equal(a.counts, b.counts)
        # the new index numbers the points by the permuted order
        mapped = a.pairs.copy()
        mapped[:, 1] = perm[mapped[:, 1]]
        mapped = mapped[np.lexsort((mapped[:, 1], mapped[:, 0]))]
        assert np.array_equal(mapped, b.pairs)
    svc.assert_no_retrace()
    svc.reindex(pts, wait=False)
    svc.join_reindex()
    assert svc.swaps == 2
    svc.assert_no_retrace()


def test_reindex_error_surfaces(dataset):
    pts, eps = dataset
    svc = JoinService(pts, eps, device="cpu")
    svc.reindex(np.zeros((0, 3)), wait=False)
    with pytest.raises(RuntimeError, match="background reindex failed"):
        svc.join_reindex()
    assert svc.swaps == 0


def test_unported_services_raise(dataset):
    pts, eps = dataset
    # the metrics are ported (ROADMAP A8): a non-L2 service builds its own
    # index, so a given one is refused, and an unknown metric too
    with pytest.raises(ValueError, match="pass raw points"):
        JoinService(pts, 0.9, metric="cosine",
                    index=tgrid.build_grid(pts, eps, device="cpu"))
    # the LM decode service is ported (ROADMAP A17 (i)): an unknown --arch
    # raises from the registry's import, as JAX's get_config does
    with pytest.raises(ModuleNotFoundError, match="no_such_lm"):
        serve.main(["--arch", "no-such-lm", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--metric", "hamming", "--device", "cpu"])


@pytest.mark.parametrize("extra", [[], ["--return-pairs", "--reindex"],
                                   ["--batching", "--no-merge"]])
def test_serve_cli_on_cpu(extra):
    with pytest.warns(UserWarning, match="auto-marking steady"):
        p50 = serve.main(["--arch", "selfjoin", "--device", "cpu",
                          "--points", "2000", "--dims", "3", "--eps", "2.0",
                          "--requests", "4", "--request-batch", "32",
                          *extra])
    assert p50 > 0


def test_poisson_schedule_shape_and_rate():
    s = loadgen.poisson_schedule(2000, 100.0, seed=0)
    assert s.shape == (2000,)
    assert np.all(np.diff(s) > 0)
    assert np.mean(np.diff(s)) == pytest.approx(0.01, rel=0.15)


def test_loadgen_open_and_closed_loops(dataset):
    pts, eps = dataset
    mix = loadgen.RequestMix(sizes=(8, 16), eps_values=(eps, 0.5 * eps))
    stream = loadgen.make_request_stream(12, mix, 3, seed=1)
    assert all(q.shape[1] == 3 for q, _ in stream)
    # the counters are process-wide, as the JAX package's executable caches
    # are: both services prepare before either marks steady
    svc = batching(dataset, max_batch=128, max_wait_ms=0.5)
    base = JoinService(pts, eps, device="cpu")
    with pytest.warns(UserWarning):
        svc.warmup()
    rep = loadgen.run_open_loop(svc, stream, 300.0, seed=2)
    assert rep.n_requests == 12
    assert rep.p99_ms >= rep.p50_ms > 0
    assert rep.coalesce_factor >= 1.0
    assert {"mode", "offered_rps", "achieved_rps", "p50_ms", "p99_ms",
            "coalesce_factor"} <= set(rep.to_dict())
    with pytest.warns(UserWarning):
        base.warmup(16)
    rep2 = loadgen.run_closed_loop(base, stream)
    assert rep2.mode == "closed" and rep2.offered_rps is None
    assert rep2.n_requests == 12
    rep3 = loadgen.run_open_loop(base, stream, 300.0, seed=2)
    assert rep3.coalesce_factor is None
    svc.assert_no_retrace()
    base.assert_no_retrace()
    with pytest.warns(UserWarning, match="auto-marking steady"):
        rep4 = loadgen.main(["--device", "cpu", "--points", "2000",
                             "--dims", "3", "--requests", "6", "--sizes",
                             "8", "16"])
    assert rep4.n_requests == 6


@pytest.mark.parametrize("return_pairs", [True, False])
def test_services_match_jax_services(dataset, jax_tables, return_pairs):
    """One request stream through the JAX package's services and the
    port's: equal counts and pairs, request by request."""
    pts, eps = dataset
    rng = np.random.default_rng(14)
    stream = [(rng.uniform(-5, 105, size=(n, 3)), e) for n, e in
              ((64, None), (17, 2.0), (128, None), (1, 1.0), (90, 3.0))]
    with jax_tables():
        jsvc = jserve.JoinService(pts, eps, return_pairs=return_pairs,
                                  index=jgrid.build_grid_host(pts, eps))
        want = [jsvc.query(q, eps=e) for q, e in stream]
        jbat = jserve.BatchingJoinService(pts, eps,
                                          return_pairs=return_pairs,
                                          max_batch=128)
        jt = [jbat.submit(q, eps=e) for q, e in stream]
        jbat.drain()
    svc = JoinService(pts, eps, device="cpu", return_pairs=return_pairs)
    bat = BatchingJoinService(pts, eps, device="cpu",
                              return_pairs=return_pairs, max_batch=128)
    tickets = [bat.submit(q, eps=e) for q, e in stream]
    bat.drain()
    for (q, e), w, jtk, tk in zip(stream, want, jt, tickets):
        for got, ref in ((svc.query(q, eps=e), w), (tk.result(),
                                                     jtk.result())):
            assert np.array_equal(got.counts, ref.counts)
            if return_pairs:
                assert np.array_equal(got.pairs, ref.pairs)
            else:
                assert got.pairs is None and ref.pairs is None
    assert bat.n_launches == jbat.n_launches
    assert np.array_equal(want[0].counts,
                          brute_counts(stream[0][0], pts, eps))
    assert jqj.bucket_rows(64) == tqj.bucket_rows(64)


@pytest.mark.parametrize("return_pairs", [True, False])
def test_sharded_service_matches_jax_and_single_index(jax_tables,
                                                      return_pairs):
    """ShardedJoinService at 3 slabs answers as JAX's ShardedJoinService and
    as the port's single-index service (counts, and pairs sorted with
    global point ids), its steady state moves no counter, and with more
    slabs than points the empty slabs are skipped (JAX's
    ``test_sharded_service_matches_single_index``)."""
    rng = np.random.default_rng(31)
    pts = rng.uniform(0, 40, (2500, 3))
    eps = 1.5
    qs = [np.random.default_rng(seed).uniform(-2, 42, (100, 3))
          for seed in (0, 1)]
    with jax_tables():
        jsh = jserve.ShardedJoinService(pts, eps, 3,
                                        return_pairs=return_pairs)
        want = [jsh.query(q) for q in qs]
    single = JoinService(pts, eps, return_pairs=return_pairs, device="cpu")
    refs = [single.query(q) for q in qs]
    sharded = ShardedJoinService(pts, eps, 3, return_pairs=return_pairs,
                                 device="cpu")
    assert sharded.n_slabs == 3 and len(sharded.prepared) == 3
    assert sorted(np.concatenate(sharded.slab_gids).tolist()) == list(
        range(pts.shape[0]))
    with pytest.warns(UserWarning, match="auto-marking steady"):
        sharded.warmup(128)
    for q, ref, w in zip(qs, refs, want):
        got = sharded.query(q)
        assert np.array_equal(got.counts, ref.counts)
        assert np.array_equal(got.counts, w.counts)
        if return_pairs:
            assert np.array_equal(got.pairs, ref.pairs)
            assert np.array_equal(got.pairs, w.pairs)
        else:
            assert got.pairs is None
    sharded.assert_no_retrace()
    tiny = ShardedJoinService(pts[:2], eps, 5, return_pairs=True,
                              device="cpu")
    assert len(tiny.prepared) == 2
    ref = JoinService(pts[:2], eps, return_pairs=True,
                      device="cpu").query(qs[0][:16])
    got = tiny.query(qs[0][:16])
    assert np.array_equal(ref.counts, got.counts)
    assert np.array_equal(ref.pairs, got.pairs)


def test_sharded_service_eps_threading(dataset, prepared):
    """A per-request eps reaches every slab (JAX's
    ``test_sharded_service_eps_threading``)."""
    pts, eps = dataset
    q = np.random.default_rng(12).uniform(0, 100, size=(40, 3))
    svc = ShardedJoinService(pts, eps, 3, device="cpu")
    with pytest.warns(UserWarning, match="auto-marking steady"):
        svc.warmup(40)
    for e in (0.6 * eps, eps):
        got = svc.query(q, eps=e)
        assert np.array_equal(got.counts, prepared.counts(q, eps=e))
    svc.assert_no_retrace()


def test_sharded_batching_matches_jax(dataset, prepared, jax_tables):
    """BatchingJoinService(n_slabs=3): each coalesced launch goes to every
    slab and the merged answer is sliced per request; equal to JAX's
    sharded batching and to the single index (JAX's
    ``test_sharded_batching_matches_single``)."""
    pts, eps = dataset
    rng = np.random.default_rng(8)
    reqs = [rng.uniform(0, 100, size=(n, 3)) for n in (120, 7, 300, 1)]
    with jax_tables():
        jbat = jserve.BatchingJoinService(pts, eps, n_slabs=3,
                                          return_pairs=True, max_batch=256)
        jt = [jbat.submit(q) for q in reqs]
        jbat.drain()
    svc = BatchingJoinService(pts, eps, n_slabs=3, return_pairs=True,
                              max_batch=256, device="cpu")
    assert svc.n_slabs == 3 and len(svc.slab_gids) == 3
    with pytest.warns(UserWarning, match="auto-marking steady"):
        svc.warmup()
    tickets = [svc.submit(q) for q in reqs]
    svc.pump()
    svc.drain()
    for q, t, w in zip(reqs, tickets, jt):
        got, ref = t.result(), prepared.join(q, return_pairs=True)
        assert np.array_equal(got.counts, ref.counts)
        assert np.array_equal(got.pairs, ref.pairs)
        assert np.array_equal(got.counts, w.result().counts)
        assert np.array_equal(got.pairs, w.result().pairs)
    assert svc.n_launches == jbat.n_launches
    svc.assert_no_retrace()


@pytest.mark.parametrize("extra", [["--return-pairs"], ["--batching"]])
def test_serve_cli_slabs_on_cpu(extra):
    with pytest.warns(UserWarning, match="auto-marking steady"):
        p50 = serve.main(["--arch", "selfjoin", "--device", "cpu",
                          "--points", "2000", "--dims", "3", "--eps", "2.0",
                          "--requests", "4", "--request-batch", "32",
                          "--slabs", "2", *extra])
    assert p50 > 0
    with pytest.raises(SystemExit, match="reindex"):
        serve.main(["--device", "cpu", "--slabs", "2", "--reindex"])


@pytest.mark.parametrize("extra", [[], ["--batching", "--return-pairs"]])
def test_loadgen_slabs_on_cpu(extra):
    """``--slabs 2`` on the load generator: the sharded service, or the
    batching service over two slabs, through a closed loop."""
    with pytest.warns(UserWarning, match="auto-marking steady"):
        rep = loadgen.main(["--device", "cpu", "--points", "1500",
                            "--dims", "3", "--eps", "3.0", "--requests",
                            "6", "--sizes", "8", "16", "--slabs", "2",
                            *extra])
    assert rep.n_requests == 6 and rep.total_queries > 0
