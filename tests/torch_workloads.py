"""Seeded workloads and JAX reference runs shared by the port's parity tests.

The generators are the bench's (``benchmarks/bench_selfjoin.py``) at the
bench smoke sizes. Test modules import ``one_torch_thread`` to get its
module-scoped autouse fixture.
"""
import contextlib

import numpy as np
import pytest
import torch


def syn(n, d, seed=0):
    return np.random.default_rng(seed).uniform(0, 100, size=(n, d))


def clustered(n, d, seed=3):
    rng = np.random.default_rng(seed)
    k = max(n // 200, 4)
    centers = rng.uniform(0, 100, (k, d))
    pts = centers[rng.integers(0, k, n)]
    return pts + rng.normal(0, 1.5, pts.shape)


def expo(n, d, seed=5):
    return np.random.default_rng(seed).exponential(10.0, (n, d))


SMOKE = {
    "uniform-2d": (syn(4000, 2), 0.4),
    "clustered-2d": (clustered(3000, 2), 0.4),
    "expo-3d": (expo(3000, 3), 1.2),
}
WORKLOADS = dict(SMOKE, **{
    "clustered-4d": (clustered(2000, 4), 3.0),
    "clustered-6d": (clustered(2000, 6), 4.0),
})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel worker
    processes, and a thread pool in each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def jax_default_tables(table_dir):
    """JAX reads its tile and sweep choices from a measured table; inside
    this context it reads an empty one, in ``table_dir``, and so takes the
    default 128-row tile the port uses."""
    from repro.kernels import autotune

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(table_dir / "none.json"))
        autotune._CACHE.reset()
        try:
            yield
        finally:
            autotune._CACHE.reset()


@pytest.fixture(scope="module")
def jax_tables(tmp_path_factory):
    """``with jax_tables():`` runs JAX with an empty tile table."""
    table_dir = tmp_path_factory.mktemp("autotune")
    return lambda: jax_default_tables(table_dir)


@contextlib.contextmanager
def both_tables(table_dir, jax_rows=None, torch_rows=None):
    """Both packages read their measured tables from ``table_dir`` (with
    the given rows, schema 3, none by default) and measure nothing; the
    port's shipped table and the JAX package's shipped cpu rows stay
    out."""
    import json

    from repro.kernels import autotune as jtune
    from repro_torch.kernels import autotune as ttune

    with pytest.MonkeyPatch.context() as mp:
        for env, name, rows in (("REPRO_AUTOTUNE", "jax", jax_rows),
                                ("REPRO_TORCH_AUTOTUNE", "torch",
                                 torch_rows)):
            path = table_dir / f"{name}.json"
            path.write_text(json.dumps(dict(rows or {}, __schema__=3)))
            mp.setenv(env + "_CACHE", str(path))
            mp.delenv(env, raising=False)
        jtune._CACHE.reset()
        ttune._CACHE.reset()
        try:
            yield
        finally:
            jtune._CACHE.reset()
            ttune._CACHE.reset()


def jax_runner(table_dir):
    """``get(kind, workload, **kw)``: the JAX package's ``self_join`` (kind
    "join") or ``self_join_count(route="dense")`` (kind "count") on a
    workload, computed once, with the default tile (``jax_default_tables``)."""
    import repro.core.selfjoin as jsj

    cache = {}

    def get(kind, workload, **kw):
        key = (kind, workload, tuple(sorted(kw.items())))
        if key not in cache:
            pts, eps = WORKLOADS[workload]
            with jax_default_tables(table_dir):
                if kind == "join":
                    cache[key] = jsj.self_join(pts, eps,
                                               distance_impl="fused")
                else:
                    cache[key] = jsj.self_join_count(
                        pts, eps, distance_impl="fused", route="dense", **kw)
        return cache[key]

    return get


def jax_half_totals() -> dict:
    """The JAX package's counterparts of ``chip_smoke.py``'s recorded half
    totals (``HALF_MAIN_TOTAL``, ``HALF_TOTALS``, ``HALF_COSINE_TOTALS``),
    on the CPU, for holding the recorded ones to the reference:

        PYTHONPATH=src:tests python -c "import json, torch_workloads as w;
            print(json.dumps(w.jax_half_totals()))"

    The same data (``chip_smoke.as_half``'s casts: float16 in one rounding,
    bfloat16 through float32) through ``self_join_count``: the fused count
    per cell at bfloat16 where the port refuses the merged lane, and the
    "jnp" count, whose sum of squares is the "pallas" one's."""
    import sys
    from pathlib import Path

    import ml_dtypes

    import repro.core.grid as jgrid
    import repro.core.selfjoin as jsj

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    halves = {"float16": np.float16, "bfloat16": ml_dtypes.bfloat16}

    def cast(x, dt):
        return np.asarray(x).astype(np.float32 if dt is ml_dtypes.bfloat16
                                    else np.float64).astype(dt)

    main = jsj.self_join_count(
        cast(cs.syn(cs.MAIN_POINTS, cs.MAIN_DIMS), np.float16), cs.MAIN_EPS,
        distance_impl="fused", route="dense").total_pairs
    totals = {}
    for dname, dt in halves.items():
        totals[dname] = {"fused": {}, "pallas": {}}
        for name, (raw, eps) in cs.bench_workloads().items():
            pts = cast(raw, dt)
            dims = np.asarray(jgrid.build_grid(pts, eps).dims)
            merge = dt is np.float16 or int(dims[-1]) - 1 <= 256
            totals[dname]["fused"][name] = int(jsj.self_join_count(
                pts, eps, distance_impl="fused", route="dense",
                merge_last_dim=merge).total_pairs)
            totals[dname]["pallas"][name] = int(jsj.self_join_count(
                pts, eps, distance_impl="jnp").total_pairs)
    emb = cs.cosine_data(cs.COSINE_POINTS)
    cosine = {dname: int(jsj.self_join_count(
        cast(emb, dt), cs.COSINE_T, metric="cosine",
        distance_impl="fused").total_pairs) for dname, dt in halves.items()}
    return dict(HALF_MAIN_TOTAL=int(main), HALF_TOTALS=totals,
                HALF_COSINE_TOTALS=cosine)


def slab_blocks(pts, eps: float, n_slabs: int, halo_capacity=None):
    """The port's slab join up to its per-slab grid builds, on the CPU:
    ``(blocks, gmin, dims, key_dtype)`` with one dict a slab holding the
    candidate block as the driver hands it to the grid build (``cc``, the
    invalid slots moved far away, and ``valid``) and the global ids and
    ownership of its rows (``gid``, ``owned``), as numpy arrays."""
    from repro_torch.core import distributed as td
    from repro_torch.core import grid as tgrid
    from repro_torch.core import metric as tmetric

    t = torch.as_tensor(pts)
    cpu = torch.device("cpu")
    coords, gids, coords_t, gids_t = td._slabs(t, n_slabs, cpu)
    mins, maxs = td.slab_extents(coords, gids)
    k_hops = td.halo_reach(mins, maxs, eps)
    if halo_capacity is None:
        need = td.exact_halo_capacity(coords, gids, mins, maxs, eps, k_hops)
        halo_capacity = min(td._next_pow2(need), coords.shape[1])
    cfg = td.DistJoinConfig(coords.shape[1], t.shape[1], halo_capacity, 0,
                            k_hops=k_hops)
    cand_c, cand_g, cand_v, cand_o, _ = td._assemble_candidates(
        coords_t, gids_t, tmetric.scalar_as(eps, t.dtype), cfg=cfg)
    gmin, dims = tgrid.points_geometry(t, eps)
    far = td._far_point(t, eps).to(t.dtype)
    blocks = [dict(cc=torch.where(v[:, None], c, far).numpy(), valid=v.numpy(),
                   gid=g.numpy(), owned=(o & v).numpy())
              for c, g, v, o in zip(cand_c, cand_g, cand_v, cand_o)]
    return blocks, gmin, dims, tgrid.device_key_dtype(dims, padded=True)


# The emit's launch shapes (n_off, c) that the kernel lays out differently
# (``kernels.emit_pairs.row_layout``): c of 1, 7, 16, 33 and past 256,
# rows of one vector (32 rows a warp step) up to rows of many warp steps,
# and 6-D's 122 windows of 16 slots.
EMIT_SHAPES = [(1, 1), (3, 1), (3, 7), (2, 8), (1, 16), (122, 16), (5, 33),
               (3, 300)]


def emit_inputs(n_off: int, c: int, *, rows: int = 200, tq: int = 32,
                npts: int = 500, density: float = 0.3, seed: int = 0,
                global_ids: bool = False, no_hits: bool = False):
    """A seeded fused launch's emit inputs, as numpy arrays: ``(hits,
    counts, slot_base, win_start, q_pos, ids)`` over ``rows`` query rows
    padded to a multiple of ``tq`` (a bucketed launch's padding rows: no
    hits, positions past the last point, which the emit clamps), with a
    fifth of the rows and a run of 40 rows all dead, window starts that
    run past the last point, and ``ids`` a permutation of the points or,
    with ``global_ids``, the slab join's global ids (up to 10^7)."""
    rng = np.random.default_rng(seed)
    qp = -(-rows // tq) * tq
    hits = (rng.random((n_off, qp, c)) < density).astype(np.int8)
    hits[:, rows:] = 0
    hits[:, rng.choice(rows, rows // 5, replace=False)] = 0
    hits[:, rows // 3:rows // 3 + 40] = 0
    if no_hits:
        hits[:] = 0
    counts = hits.sum(axis=(0, 2), dtype=np.int32)
    tiles = counts.reshape(-1, tq)
    slot_base = (np.cumsum(tiles, axis=1) - tiles).reshape(-1)
    win_start = rng.integers(0, npts, (n_off, qp)).astype(np.int32)
    q_pos = rng.integers(0, npts, qp).astype(np.int32)
    q_pos[rows:] = npts + np.arange(qp - rows)
    ids = (rng.choice(10 ** 7, npts, replace=False) if global_ids
           else rng.permutation(npts)).astype(np.int32)
    return hits, counts, slot_base.astype(np.int32), win_start, q_pos, ids
