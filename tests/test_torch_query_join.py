"""The port's external-query join, held to the JAX package on the CPU.

Descriptors (``external_window_descriptors``, ``external_range_descriptors``,
``external_range_cap``), the kernel's external mask, and ``epsilon_join``'s
counts and sorted pairs must equal the JAX package's exactly, with zero
tolerance, on the same seeded numpy inputs. JAX runs its own CPU path (the
reference lowering off the TPU) and reads an empty tile table, so both
packages launch 128-row tiles. Integer-lattice data, where many query-point
distances sit exactly on eps and many queries on cell boundaries, is held
to an integer brute force.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import grid as jgrid
from repro.core import metric as jmetric
from repro.core import query_join as jqj
from repro.core import selfjoin as jsj
from repro.core.stencil import merged_stencil_offsets, stencil_offsets
from repro.kernels import fused_join as jfj
from repro_torch.core import grid as tgrid
from repro_torch.core import metric as tmetric
from repro_torch.core import query_join as tqj
from repro_torch.core import selfjoin as tsj
from repro_torch.kernels import fused_join as tfj
from torch_workloads import SMOKE
from torch_workloads import jax_tables  # noqa: F401  (fixture)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)


def port_index(jidx):
    """The JAX index's fields as a port index on the CPU."""
    return tgrid.index_from_arrays(
        {f: np.asarray(getattr(jidx, f)) for f in tgrid.FIELDS}, device="cpu")


def brute(queries, pts, eps):
    d2 = ((queries[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    hit = d2 <= eps * eps
    q, p = np.nonzero(hit)
    pairs = np.stack([q, p], 1).astype(np.int32)
    return (hit.sum(1).astype(np.int32),
            pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))])


def query_mix(pts, eps, rng, n=60):
    """Queries inside the volume, on cell boundaries, within eps of the
    volume, and far outside it, plus duplicates of the first rows."""
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    d = pts.shape[1]
    inside = rng.uniform(lo, hi, (n, d))
    gmin = lo - eps
    boundary = gmin + eps * np.round((inside - gmin) / eps)
    near = np.concatenate([lo - 0.7 * eps + 0 * inside[:10],
                           hi + 0.9 * eps + 0 * inside[:10]])
    far = np.concatenate([lo - 5 * eps - 0 * inside[:5],
                          hi + 1e6 * eps + 0 * inside[:5]])
    q = np.concatenate([inside, boundary, near, far, inside[:7]])
    return q.astype(pts.dtype)


# (n, key dtype) -> (points, eps): int64 keys need prod(dims) >= 2^31, so
# those sets spread a few hundred points over a vast grid, as clusters so
# that windows are live
def _descriptor_data(n, kd, seed):
    rng = np.random.default_rng(seed)
    if kd == "int32":
        return rng.uniform(0, 10, (400, n)), 0.9
    eps = {1: 2e-6, 2: 0.2}.get(n, 0.5)
    centers = rng.uniform(0, 1e4, (20, n))
    pts = centers[rng.integers(0, 20, 400)] + rng.normal(0, eps, (400, n))
    corners = np.stack([np.zeros(n), np.full(n, 1e4)])   # the full extent
    return np.concatenate([pts, corners]), eps


DESC_CASES = [(n, kd) for n in (1, 2, 3, 4) for kd in ("int32", "int64")]


@pytest.mark.parametrize("n,kd", DESC_CASES,
                         ids=[f"{n}d-{kd}" for n, kd in DESC_CASES])
def test_external_descriptors_match_jax(n, kd):
    pts, eps = _descriptor_data(n, kd, seed=n)
    jidx = jgrid.build_grid_host(pts, eps)
    assert np.dtype(jidx.cell_keys.dtype) == np.dtype(kd)
    tidx = port_index(jidx)
    q = query_mix(pts, eps, np.random.default_rng(10 + n))
    limit = q.shape[0] - 4
    offs = stencil_offsets(n, unicomp=False)
    want = jgrid.external_window_descriptors(
        jidx, jnp.asarray(offs), jnp.asarray(q), jnp.asarray(limit))
    got = tgrid.external_window_descriptors(
        tidx, torch.as_tensor(offs), torch.as_tensor(q), limit)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) > 0
    reduced, lo, hi = merged_stencil_offsets(n, unicomp=False)
    want = jgrid.external_range_descriptors(
        jidx, jnp.asarray(reduced), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(q), jnp.asarray(limit))
    got = tgrid.external_range_descriptors(
        tidx, torch.as_tensor(reduced), torch.as_tensor(lo),
        torch.as_tensor(hi), torch.as_tensor(q), limit)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) > 0
    for align in (8, 16):
        assert (tgrid.external_range_cap(tidx, align)
                == jgrid.external_range_cap(jidx, align))


def test_external_range_cap_is_cached_and_counted():
    pts, eps = _descriptor_data(2, "int32", seed=3)
    tidx = tgrid.build_grid(pts, eps, device="cpu")
    before = tgrid.BUILD_EVENTS["external_range_cap"]
    first = tgrid.external_range_cap(tidx)
    assert tgrid.external_range_cap(tidx) == first
    assert tgrid.BUILD_EVENTS["external_range_cap"] == before + 1


CROSS = [(w, dt, m, rl) for w in SMOKE for dt in (np.float64, np.float32)
         for m in (True, False) for rl in (True, False)]


@pytest.fixture(scope="module")
def indexes():
    """(JAX index, port index) per (workload, dtype), built once."""
    cache = {}

    def get(workload, dtype):
        if (workload, dtype) not in cache:
            pts, eps = SMOKE[workload]
            jidx = jgrid.build_grid_host(pts.astype(dtype), eps)
            cache[workload, dtype] = (jidx, port_index(jidx))
        return cache[workload, dtype]

    return get


@pytest.mark.parametrize(
    "workload,dtype,merged,run_loop", CROSS,
    ids=[f"{w}-{np.dtype(dt).name}-{'merged' if m else 'cell'}-"
         f"{'run' if rl else 'row'}" for w, dt, m, rl in CROSS])
def test_epsilon_join_matches_jax(indexes, jax_tables, workload, dtype,
                                  merged, run_loop):
    jidx, tidx = indexes(workload, dtype)
    pts, eps = SMOKE[workload]
    q = query_mix(pts.astype(dtype), eps, np.random.default_rng(1), n=300)
    with jax_tables():
        want = jqj.prepare(jidx, merge_last_dim=merged,
                           run_loop=run_loop).join(q, with_stats=True)
        want_counts = jqj.prepare(jidx, merge_last_dim=merged,
                                  run_loop=run_loop).counts(q)
    pj = tqj.prepare(tidx, merge_last_dim=merged, run_loop=run_loop)
    got = pj.join(q, with_stats=True)
    assert got.counts.dtype == want.counts.dtype
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(got.pairs, want.pairs)
    assert got.candidates_checked == want.candidates_checked
    assert (got.bucket_rows, got.n_offsets) == (want.bucket_rows,
                                                want.n_offsets)
    assert got.emit == "device"
    assert np.array_equal(pj.counts(q), want_counts)
    assert got.total > 0


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("keep_hits", [True, False])
def test_external_mask_matches_jax_reference(indexes, merged, keep_hits):
    """The plain version with ``external=True`` against the JAX package's
    reference on the port's own launch inputs: hits, counts and slot_base
    bit for bit."""
    jidx, tidx = indexes("clustered-2d", np.float64)
    pts, eps = SMOKE["clustered-2d"]
    q = query_mix(pts, eps, np.random.default_rng(2), n=200)
    pj = tqj.prepare(tidx, merge_last_dim=merged)
    _, launches = pj.launch_inputs(q, keep_hits=keep_hits)
    for _, _, args, kw in launches:
        got = tfj.fused_join_hits(*args, method="reference",
                                  **{k: v for k, v in kw.items()
                                     if k not in ("run_ord", "run_loop")})
        jargs = [jnp.asarray(a.numpy()) for a in args[:6]]
        want = jfj.fused_join_hits(
            *jargs, float(eps), c=kw["c"], n_real=2, unicomp=False,
            external=True, merged=merged, tq=kw["tq"], keep_hits=keep_hits,
            method="reference")
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert int(got[1].sum()) > 0


def skewed(seed=3, n_dims=2, eps=0.5):
    rng = np.random.default_rng(seed)
    bg = rng.uniform(0, 10, (500, n_dims))
    cl = rng.normal(5.0, 0.12, (260, n_dims))
    return np.concatenate([bg, cl]), eps


@pytest.mark.parametrize("run_loop", [True, False])
def test_bucketed_join_matches_jax(jax_tables, run_loop):
    pts, eps = skewed()
    jidx = jgrid.build_grid_host(pts, eps)
    pj = tqj.prepare(port_index(jidx), run_loop=run_loop)
    assert pj.bucketed and len(pj.classes) > 1
    rng = np.random.default_rng(8)
    q = np.concatenate([rng.normal(5.0, 0.2, (30, 2)),
                        rng.uniform(-1, 11, (40, 2)),
                        rng.uniform(20, 30, (5, 2))])
    _, launches = pj.launch_inputs(q)
    assert len(launches) > 1                    # several classes launched
    with jax_tables():
        jpj = jqj.prepare(jidx, run_loop=run_loop)
        for e in (None, 0.3):
            want = jpj.join(q, eps=e)
            got = pj.join(q, eps=e)
            assert np.array_equal(got.counts, want.counts)
            assert np.array_equal(got.pairs, want.pairs)
    counts, pairs = brute(q, pts, eps)
    got = pj.join(q)
    assert np.array_equal(got.counts, counts)
    assert np.array_equal(got.pairs, pairs)
    assert np.array_equal(pj.counts(q), counts)
    # the unsorted rows hold the same pairs
    unsorted = pj.join(q, sort_pairs=False).pairs
    assert np.array_equal(unsorted[np.lexsort((unsorted[:, 1],
                                               unsorted[:, 0]))], pairs)


def test_duplicates_and_coincident_queries():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 10, (500, 2))
    qd = rng.uniform(0, 10, (20, 2))
    for q in (np.repeat(qd, 3, axis=0), pts[::7].copy()):
        counts, pairs = brute(q, pts, 0.6)
        got = tqj.epsilon_join(q, pts, 0.6, device="cpu")
        assert np.array_equal(got.counts, counts)
        assert np.array_equal(got.pairs, pairs)
    # identical rows get identical answers; coincident points count
    got = tqj.epsilon_join(np.repeat(qd, 3, axis=0), pts, 0.6, device="cpu")
    assert np.array_equal(got.counts[0::3], got.counts[1::3])
    assert (tqj.epsilon_join(pts[:5], pts, 0.6, device="cpu").counts
            >= 1).all()


def test_empty_query_batch():
    pts = np.random.default_rng(2).uniform(0, 10, (100, 2))
    for merge in (None, False):
        res = tqj.epsilon_join(np.zeros((0, 2)), pts, 0.5, device="cpu",
                               merge_last_dim=merge)
        assert res.counts.shape == (0,)
        assert res.pairs.shape == (0, 2)
        assert res.bucket_rows == tqj.bucket_rows(0) == 128


def test_tiny_grid_clip_regression():
    """Grids with fewer than 3 cells in a dimension, built against given
    geometry: counts, pairs and ``range_query`` equal brute force and
    JAX."""
    pts = np.array([[0.2, 0.2], [1.8, 0.3], [1.7, 1.6], [0.1, 1.9],
                    [1.0, 1.0], [0.2, 1.6]])
    q = np.array([[0.2, 1.2], [0.3, 0.3], [1.9, 1.9], [-0.5, 0.5],
                  [2.4, 0.1], [5.0, 5.0], [1.0, 2.9]])
    eps = 1.5
    counts, pairs = brute(q, pts, eps)
    for dims in ([2, 2], [2, 4], [4, 2]):
        jidx = jgrid.build_grid_with_geometry(
            jnp.asarray(pts), eps, jnp.zeros(2), jnp.asarray(dims, jnp.int64))
        tidx = tgrid.build_grid_with_geometry(
            torch.as_tensor(pts), eps, np.zeros(2),
            np.asarray(dims, np.int64),
            key_dtype=tgrid.key_dtype_for(dims))
        for merge in (None, False):
            res = tqj.prepare(tidx, merge_last_dim=merge).join(q)
            assert np.array_equal(res.counts, counts), dims
            assert np.array_equal(res.pairs, pairs), dims
        got = tsj.range_query(q, pts, eps, index=tidx, device="cpu")
        assert np.array_equal(got, counts), dims
        assert np.array_equal(got, jsj.range_query(q, pts, eps, index=jidx))


def test_request_eps_overrides_and_errors(jax_tables):
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 10, (300, 2))
    q = rng.uniform(0, 10, (40, 2))
    jidx = jgrid.build_grid_host(pts, 1.0)
    pj = tqj.prepare(port_index(jidx))
    with jax_tables():
        jpj = jqj.prepare(jidx)
        for e in (1.0, 0.5, 0.25):
            want = jpj.join(q, eps=e)
            got = pj.join(q, eps=e)
            assert np.array_equal(got.counts, want.counts)
            assert np.array_equal(got.pairs, want.pairs)
    counts, pairs = brute(q, pts, 0.5)
    assert np.array_equal(pj.join(q, eps=0.5).pairs, pairs)
    with pytest.raises(ValueError, match="exceeds index build eps"):
        pj.join(q, eps=1.5)
    with pytest.raises(ValueError, match=r"queries must be \(Q, 2\)"):
        pj.join(q[:, :1])
    with pytest.raises(ValueError, match="device emit only"):
        pj.join(q, emit="host")
    for e in (0.1, 1.0, 1.0 + 1e-13):
        assert tmetric.request_scalar(
            "l2", e, index_eps=1.0, index_eps_geom=1.0) == \
            jmetric.request_scalar("l2", e, index_eps=1.0,
                                   index_eps_geom=1.0)
    # the metric rules (ported with ROADMAP A8): a cosine request above the
    # build similarity maps to its chord, below it raises; an unknown
    # metric and an l2 index under a cosine form are refused
    g = tmetric.cosine_eps_geom(0.8)
    assert tmetric.request_scalar("cosine", 0.9, index_eps=0.8,
                                  index_eps_geom=g) == \
        jmetric.request_scalar("cosine", 0.9, index_eps=0.8,
                               index_eps_geom=g)
    with pytest.raises(ValueError, match="below the index build"):
        tmetric.request_scalar("cosine", 0.7, index_eps=0.8,
                               index_eps_geom=g)
    with pytest.raises(ValueError, match="unknown metric"):
        tqj.epsilon_join(q, pts, 0.9, metric="hamming", device="cpu")
    with pytest.raises(ValueError, match="does not match the canonical"):
        tqj.prepare(pj.index, canon=tmetric.canonicalize(pts, 0.9,
                                                         metric="cosine"))


def test_range_query_matches_jax():
    rng = np.random.default_rng(13)
    pts = rng.uniform(0, 10, (400, 3))
    q = rng.uniform(-1, 11, (50, 3))
    counts, pairs = brute(q, pts, 0.9)
    got = tsj.range_query(q, pts, 0.9, device="cpu")
    assert np.array_equal(got, counts)
    assert np.array_equal(got, jsj.range_query(q, pts, 0.9))
    got_counts, got_pairs = tsj.range_query(q, pts, 0.9, return_pairs=True,
                                            device="cpu")
    want_counts, want_pairs = jsj.range_query(q, pts, 0.9, return_pairs=True)
    assert np.array_equal(got_counts, want_counts)
    assert np.array_equal(got_pairs, want_pairs)
    assert np.array_equal(got_pairs, pairs)


def _lattice(n):
    g = np.arange(12)
    return np.stack(np.meshgrid(*([g] * n), indexing="ij"),
                    -1).reshape(-1, n).astype(np.float64)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("eps", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("merged", [True, False])
def test_lattice_queries_exact(n, eps, merged):
    """Integer points and queries on the lattice and half-way between: many
    distances exactly eps, many queries on cell boundaries. Counts and
    pairs equal an integer brute force, so the sort key, the merged lane
    and the descriptors agree on every boundary."""
    pts = _lattice(n)
    q = np.concatenate([pts[::5], pts[::7] + 0.5, pts[:9] - 1.0,
                        pts[-9:] + 1.0]).astype(np.float64)
    q2 = np.rint(2 * q).astype(np.int64)
    p2 = np.rint(2 * pts).astype(np.int64)
    d2 = ((q2[:, None, :] - p2[None, :, :]) ** 2).sum(-1)
    hit = d2 <= int(2 * eps) ** 2
    qi, pi = np.nonzero(hit)
    got = tqj.epsilon_join(q, pts, eps, device="cpu", merge_last_dim=merged)
    assert np.array_equal(got.counts, hit.sum(1).astype(np.int32))
    assert np.array_equal(got.pairs,
                          np.stack([qi, pi], 1).astype(np.int32))
    assert (d2 == int(2 * eps) ** 2).sum() > 100


def test_emit_pairs_device_matches_jax(indexes):
    jidx, tidx = indexes("uniform-2d", np.float64)
    pts, eps = SMOKE["uniform-2d"]
    q = query_mix(pts, eps, np.random.default_rng(5), n=150)
    pj = tqj.prepare(tidx, run_loop=False)
    _, launches = pj.launch_inputs(q)
    (_, _, args, kw), = launches
    hits, counts, base = tfj.fused_join_hits(
        *args, **{k: v for k, v in kw.items() if k != "run_ord"})
    total = int(counts.sum())
    for capacity in (total, 1024, max(total - 5, 1)):
        want = jqj._emit_pairs_device(
            jnp.asarray(np.asarray(jidx.order)), jnp.asarray(hits.numpy()),
            jnp.asarray(counts.numpy()), jnp.asarray(base.numpy()),
            jnp.asarray(args[2].numpy()), c=kw["c"], tq=kw["tq"],
            capacity=capacity)
        got = tqj._emit_pairs_device(tidx.order, hits, counts, base, args[2],
                                     c=kw["c"], tq=kw["tq"],
                                     capacity=capacity)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_bucket_rows_and_cell_sort_match_jax(jax_tables):
    for n in (0, 1, 128, 129, 300, 512, 513):
        assert tqj.bucket_rows(n) == jqj.bucket_rows(n)
    pts, eps = SMOKE["expo-3d"]
    jidx = jgrid.build_grid_host(pts, eps)
    q = query_mix(pts, eps, np.random.default_rng(6), n=200)
    plan, _ = tqj.prepare(port_index(jidx)).launch_inputs(q)
    perm = plan[0]
    qc = np.clip(np.floor((q - np.asarray(jidx.grid_min)[None, :])
                          / float(jidx.eps)), -(1 << 24), 1 << 24)
    assert np.array_equal(perm, np.lexsort(qc.astype(np.int64).T))


def test_executable_cache_stats_count_prepare_builds():
    pts = np.random.default_rng(9).uniform(0, 10, (300, 2))
    index = tgrid.build_grid(pts, 0.7, device="cpu")
    before = tqj.executable_cache_stats()
    pj = tqj.prepare(index)
    mid = tqj.executable_cache_stats()
    for key in ("points_pad", "offset_tables", "class_set",
                "external_range_cap"):
        assert mid[key] == before[key] + 1, key
    for k in range(4):
        pj.join(np.random.default_rng(k).uniform(-1, 11, (50 + 40 * k, 2)))
        pj.join(np.zeros((3, 2)), return_pairs=False, eps=0.5)
    assert tqj.executable_cache_stats() == mid
