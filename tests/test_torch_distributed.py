"""The slab join in one process (``repro_torch.core.distributed``), held to
the JAX package on the CPU.

Host planning (partition, extents, halo reach, the capacity plan and its
overflow message) is numpy on both sides and must equal JAX's functions. The
port's ``distributed_self_join`` must give the sorted pairs of JAX's
``self_join(distance_impl="fused")`` at 1-4 slabs, UNICOMP on and off,
merged and per-cell, float64 and float32; its count paths the same totals.
One subprocess with four placeholder JAX devices computes JAX's own halo
exchange (``make_halo_step``) and ``distributed_self_join`` at 2 and 4
slabs, and the port's exchange and pairs are held to them field by field.
Zero tolerance, except float16 against JAX's jitted float16 code, which
takes the band of ``test_torch_half.py``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import distributed as jd
from repro.core import selfjoin as jsj
from repro_torch.core import distributed as td
from repro_torch.core import selfjoin as tsj
from test_torch_half import CASES as HALF_CASES
from test_torch_half import as_jax, assert_pairs
from torch_workloads import clustered, expo, slab_blocks, syn
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parent.parent / "src"
CPU = "cpu"
# (points, eps): uniform, clustered, skewed (k_hops 2 at 4 slabs), and more
# slabs than points (empty slabs)
PLANS = {
    "uniform": (syn(600, 2, seed=1) / 10, 0.5),
    "clustered": (clustered(600, 2, seed=2) / 10, 0.3),
    "skew": (expo(800, 3, seed=7) / 10, 0.6),
    "tiny": (syn(3, 2, seed=3) / 10, 0.5),
}
JOIN = PLANS["uniform"]
# the float16 probe of ROADMAP §C, C3: past 2,049 points the ids collide
PROBE = (np.random.default_rng(0).random((3000, 2)) * 20).astype(np.float16)
SUB_CASES = ("uniform", "skew")


# The JAX side of the exchange and of the slab join, in a subprocess with
# four placeholder devices (the JAX package's own tests run its slab join
# so); started when the module starts, read by the tests at the end.
SUB_CODE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as jd
    from repro.launch.mesh import make_slab_mesh
    data = dict(np.load(sys.argv[1]))
    out = {}
    for name in sorted({k.split("/")[0] for k in data}):
        pts, eps = data[name + "/pts"], float(data[name + "/eps"])
        n = pts.shape[1]
        for n_slabs in (2, 4):
            mesh = make_slab_mesh(n_slabs)
            coords, gids, _ = jd.partition_points_host(pts, n_slabs)
            mins, maxs = jd.slab_extents(coords, gids)
            k = jd.halo_reach(mins, maxs, eps)
            need = jd.exact_halo_capacity(coords, gids, mins, maxs, eps, k)
            h = min(jd._next_pow2(need), coords.shape[1])
            cfg = jd.DistJoinConfig(
                pts_per_device=coords.shape[1], n_dims=n, halo_capacity=h,
                max_per_cell=0, model_axis=None, k_hops=k)
            step, sh = jd.make_halo_step(mesh, cfg)
            blocks = step(jax.device_put(coords.reshape(-1, n), sh[0]),
                          jax.device_put(gids.reshape(-1), sh[1]),
                          jnp.asarray(eps, pts.dtype))
            key = f"{name}/{n_slabs}/"
            for f, x in zip(("cand_c", "cand_g", "cand_v", "cand_o"), blocks):
                out[key + f] = np.asarray(x).reshape(n_slabs, -1, *x.shape[1:])
            out[key + "halo_of"] = np.asarray(blocks[4])
            out[key + "k_hops"] = np.asarray(k)
            out[key + "pairs"] = jd.distributed_self_join(pts, eps, mesh)
            out[key + "count"] = np.asarray(
                jd.distributed_self_join_count(pts, eps, mesh))
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module", autouse=True)
def jax_slabs(tmp_path_factory):
    """``get()``: the subprocess's arrays, waited for at first use."""
    d = tmp_path_factory.mktemp("slabs")
    np.savez(d / "in.npz", **{f"{k}/{f}": v for k in SUB_CASES
                              for f, v in zip(("pts", "eps"), PLANS[k])})
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", SUB_CODE, str(d / "in.npz"),
         str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    cache = {}

    def get():
        if not cache:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            cache.update(np.load(d / "out.npz"))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _partition(pkg, pts, n_slabs, eps):
    coords, gids, width = pkg.partition_points_host(pts, n_slabs)
    mins, maxs = pkg.slab_extents(coords, gids)
    k = pkg.halo_reach(mins, maxs, eps)
    return coords, gids, width, mins, maxs, k


PLAN_CASES = [(w, s) for w in PLANS for s in (2, 3, 4)] + [("tiny", 5)]


@pytest.mark.parametrize("workload,n_slabs", PLAN_CASES)
def test_host_planning_matches_jax(workload, n_slabs):
    """Partition, extents, reach, the parcel plan, the exact capacity and
    the overflow message, against JAX's functions on the same points."""
    pts, eps = PLANS[workload]
    got = _partition(td, pts, n_slabs, eps)
    want = _partition(jd, pts, n_slabs, eps)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype
    coords, gids, _, mins, maxs, k = got
    plan = td.halo_capacity_plan(coords, gids, mins, maxs, eps, k)
    jplan = jd.halo_capacity_plan(coords, gids, mins, maxs, eps, k)
    assert [(p.slab, p.hop, p.direction, p.need, p.dest, p.describe())
            for p in plan] == [(p.slab, p.hop, p.direction, p.need, p.dest,
                                p.describe()) for p in jplan]
    assert (td.exact_halo_capacity(coords, gids, mins, maxs, eps, k)
            == jd.exact_halo_capacity(coords, gids, mins, maxs, eps, k))
    for cap in (1, td.exact_halo_capacity(coords, gids, mins, maxs, eps, k)):
        assert (str(td._halo_overflow_error(cap, plan))
                == str(jd._halo_overflow_error(cap, jplan)))
    assert td._next_pow2(37) == jd._next_pow2(37) == 64
    if workload == "skew" and n_slabs == 4:
        assert k >= 2
    if workload == "tiny" and n_slabs == 5:
        assert not np.isfinite(maxs[-1])           # an empty slab


@pytest.fixture(scope="module")
def jax_join():
    """JAX's ``self_join(distance_impl="fused")`` (and its count) on the
    join workload, once per (dtype, unicomp, merge)."""
    cache = {}

    def get(dtype, unicomp, merge=True, kind="join"):
        key = (dtype, unicomp, merge, kind)
        if key not in cache:
            pts, eps = JOIN
            if kind == "join":
                cache[key] = jsj.self_join(
                    pts.astype(dtype), eps, unicomp=unicomp,
                    distance_impl="fused", merge_last_dim=merge)
            else:
                cache[key] = jsj.self_join_count(
                    pts.astype(dtype), eps, unicomp=unicomp,
                    distance_impl="fused").total_pairs
        return cache[key]

    return get


JOIN_CASES = [(dt, u, m) for dt in (np.float64, np.float32)
              for u in (True, False) for m in (True, False)]


@pytest.mark.parametrize(
    "dtype,unicomp,merge", JOIN_CASES,
    ids=[f"{np.dtype(dt).name}-{'uni' if u else 'full'}-"
         f"{'merged' if m else 'cell'}" for dt, u, m in JOIN_CASES])
def test_slab_join_matches_jax_join(jax_join, dtype, unicomp, merge):
    """Sorted pairs at 1-4 slabs equal JAX's one-device fused join; the
    count-only launches give its total."""
    pts, eps = JOIN
    want = jax_join(dtype, unicomp, merge)
    assert want.shape[0] > 0
    for n_slabs in (1, 2, 3, 4):
        got = td.distributed_self_join(pts.astype(dtype), eps, n_slabs,
                                       unicomp=unicomp, merge_last_dim=merge,
                                       device=CPU)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), n_slabs
        assert td.distributed_self_join(
            pts.astype(dtype), eps, n_slabs, unicomp=unicomp,
            merge_last_dim=merge, return_pairs=False,
            device=CPU) == want.shape[0]


@pytest.mark.parametrize("unicomp", [True, False])
def test_slab_counts_match_jax_count(jax_join, unicomp):
    """The plain offset sweep at 1-4 slabs and the unsorted pair set."""
    pts, eps = JOIN
    want = jax_join(np.float64, unicomp, kind="count")
    for n_slabs in (1, 2, 3, 4):
        assert td.distributed_self_join_count(
            pts, eps, n_slabs, unicomp=unicomp, device=CPU) == want
    raw = td.distributed_self_join(pts, eps, 3, unicomp=unicomp,
                                   sort_result=False, device=CPU)
    assert raw.shape[0] == want
    assert torch.equal(tsj.sort_pairs(raw, pts.shape[0]),
                       torch.as_tensor(jax_join(np.float64, unicomp)))


def test_slab_join_on_skewed_points_with_two_hops():
    """The skewed workload needs 2 hops at 4 slabs; its pairs equal the
    one-process join's at every slab count, its counts their total."""
    pts, eps = PLANS["skew"]
    want = tsj.self_join(pts, eps, device=CPU)
    for n_slabs in (2, 3, 4):
        got = td.distributed_self_join(pts, eps, n_slabs, device=CPU)
        assert torch.equal(got, want), n_slabs
        assert td.distributed_self_join_count(
            pts, eps, n_slabs, device=CPU) == want.shape[0]


def test_cosine_slab_join_matches_jax():
    """metric="cosine" canonicalizes at entry; pairs equal JAX's cosine
    join, and the counts its total."""
    emb = np.random.default_rng(8).normal(size=(500, 4))
    want = jsj.self_join(emb, 0.9, metric="cosine", distance_impl="fused")
    assert want.shape[0] > 0
    for n_slabs in (2, 3):
        got = td.distributed_self_join(emb, 0.9, n_slabs, metric="cosine",
                                       device=CPU)
        assert np.array_equal(got.numpy(), want)
        assert td.distributed_self_join_count(
            emb, 0.9, n_slabs, metric="cosine", device=CPU) == want.shape[0]


def test_jaccard_is_not_distributed():
    sets = [[1, 2, 3], [2, 3, 4], [5]]
    for fn in (td.distributed_self_join, td.distributed_self_join_count):
        with pytest.raises(NotImplementedError, match="jaccard"):
            fn(sets, 0.5, 2, metric="jaccard", device=CPU)


def test_float16_slab_join_below_the_id_limit():
    """Float16 points up to the id limit: at the probe's first 2,049 points
    (ids up to 2,048, exact in float16) the slab join equals the port's
    one-process join exactly; on ``test_torch_half.py``'s 1,500-point case
    it equals JAX's fused join within that file's float16 band. (At the
    2,049 points JAX's jitted float16 join leaves out 20 pairs whose rule-P
    d^2 is exactly eps^2, more than the band's count; ROADMAP §C.)"""
    pts, eps = PROBE[:2049], 2.0
    mine = tsj.self_join(pts, eps, device=CPU)
    for n_slabs in (2, 4):
        got = td.distributed_self_join(pts, eps, n_slabs, device=CPU)
        assert torch.equal(got, mine), n_slabs
    raw, eps = HALF_CASES["u2"]
    pts = as_jax(raw, "f16")
    want = jsj.self_join(pts, eps, distance_impl="fused")
    p = pts.astype(np.float64)
    for n_slabs in (2, 3):
        got = td.distributed_self_join(pts, eps, n_slabs, device=CPU)
        assert_pairs(got.numpy(), want, "f16", band=True, a_pts=p, b_pts=p,
                     eps=eps)


def test_refusals():
    """Half points past the exact-id bound (the probe's 3,000 float16
    points; 258 bfloat16 ones), no free lane for the ids (8 dimensions),
    and ids past float32's integers (a broadcast view of 2^24 rows: no
    large array is built)."""
    with pytest.raises(ValueError, match="C3"):
        td.distributed_self_join(PROBE, 2.0, 2, device=CPU)
    bf = torch.from_numpy(PROBE[:258].astype(np.float32)).to(torch.bfloat16)
    with pytest.raises(ValueError, match="C3"):
        td.distributed_self_join(bf, 2.0, 2, device=CPU)
    assert td.distributed_self_join(bf[:257], 2.0, 2, device=CPU).shape[1] == 2
    with pytest.raises(ValueError, match="NP_PAD"):
        td.distributed_self_join(syn(50, 8), 5.0, 2, device=CPU)
    huge = np.broadcast_to(np.zeros((1, 2)), (1 << 24, 2))
    with pytest.raises(ValueError, match=r"2\^24"):
        td.distributed_self_join(huge, 1.0, 2, device=CPU)


def test_overflows_raise():
    """A forced halo capacity of 2 raises with JAX's message (never a
    silent loss); so does the count path, and a window C below a cell's
    points in the count sweep."""
    pts, eps = PLANS["clustered"]
    coords, gids, _, mins, maxs, k = _partition(jd, pts, 2, eps)
    msg = str(jd._halo_overflow_error(
        2, jd.halo_capacity_plan(coords, gids, mins, maxs, eps, k)))
    with pytest.raises(RuntimeError) as err:
        td.distributed_self_join(pts, eps, 2, halo_capacity=2, device=CPU)
    assert str(err.value) == msg
    with pytest.raises(RuntimeError, match="halo capacity overflow"):
        td.distributed_self_join_count(pts, eps, 2, halo_capacity=2,
                                       device=CPU)
    with pytest.raises(RuntimeError, match="max_per_cell overflow"):
        td.distributed_self_join_count(pts, eps, 2, max_per_cell=1,
                                       device=CPU)


def test_empty_and_tiny_inputs():
    """No points; one point on two slabs; three points on five slabs
    (empty slabs), against brute force."""
    empty = np.zeros((0, 2))
    assert td.distributed_self_join(empty, 1.0, 2, device=CPU).shape == (0, 2)
    assert td.distributed_self_join(empty, 1.0, 2, return_pairs=False,
                                    device=CPU) == 0
    assert td.distributed_self_join_count(empty, 1.0, 2, device=CPU) == 0
    one = syn(1, 2)
    assert td.distributed_self_join(one, 1.0, 2, device=CPU).shape == (0, 2)
    pts = np.array([[0.0, 0.0], [0.3, 0.0], [5.0, 5.0]])
    want = np.array([[0, 1], [1, 0]], np.int32)
    got = td.distributed_self_join(pts, 0.5, 5, device=CPU)
    assert np.array_equal(got.numpy(), want)
    assert td.distributed_self_join_count(pts, 0.5, 5, device=CPU) == 2


@pytest.mark.parametrize("workload", SUB_CASES)
@pytest.mark.parametrize("n_slabs", [2, 4])
def test_exchange_and_pairs_match_jax_slab_join(jax_slabs, workload,
                                                n_slabs):
    """The port's ring exchange equals JAX's ``make_halo_step`` blocks field
    by field (local rows, then per hop the right and the left parcel), and
    its slab join and count equal JAX's ``distributed_self_join`` and
    ``distributed_self_join_count`` on four placeholder devices."""
    out = jax_slabs()
    key = f"{workload}/{n_slabs}/"
    pts, eps = PLANS[workload]
    blocks, _, _, _ = slab_blocks(pts, eps, n_slabs)
    coords, gids, _, mins, maxs, k = _partition(td, pts, n_slabs, eps)
    assert k == int(out[key + "k_hops"])
    h = min(td._next_pow2(td.exact_halo_capacity(coords, gids, mins, maxs,
                                                 eps, k)), coords.shape[1])
    cfg = td.DistJoinConfig(coords.shape[1], pts.shape[1], h, 0, k_hops=k)
    got = td._assemble_candidates(
        torch.as_tensor(coords), torch.as_tensor(gids),
        torch.tensor(eps, dtype=torch.float64), cfg=cfg)
    for f, g in zip(("cand_c", "cand_g", "cand_v", "cand_o"), got):
        w = out[key + f]
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), f
    assert not bool(got[4]) and not bool(out[key + "halo_of"])
    # the driver moves invalid slots far away before its grid builds
    for b, v in zip(blocks, out[key + "cand_v"]):
        assert np.array_equal(b["valid"], v)
    pairs = td.distributed_self_join(pts, eps, n_slabs, device=CPU)
    assert np.array_equal(pairs.numpy(), out[key + "pairs"])
    assert td.distributed_self_join_count(
        pts, eps, n_slabs, device=CPU) == int(out[key + "count"])
