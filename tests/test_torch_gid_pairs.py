"""Kernel B1 (d), the global-id masks of the slab join, and the planning
pieces under it, held to the JAX package on the CPU.

The slab join (``repro_torch.core.distributed``) joins each slab over its own
points and a halo of its neighbours', so the fused kernel's masks compare
global point ids riding a pad lane (``gid_pairs``) instead of sorted
positions. Here the port's plain version of that kernel must equal JAX's
reference lowering and JAX's Pallas kernel in interpret mode, bit for bit on
hits, counts and slot_base, on every launch of one slab's join; the padded
grid build (``valid=``) must equal JAX's field for field, and
``filter_plan_rows`` JAX's plan for plan. A lattice with every point twice
and ties across slab boundaries, where many d^2 equal eps^2 exactly and the
id triangle decides most pairs inside a cell, is held to an integer brute
force. Zero tolerance throughout.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import grid as jgrid
from repro.kernels import fused_join as jfj
from repro_torch.core import distributed as td
from repro_torch.core import grid as tgrid
from repro_torch.core import selfjoin as tsj
from repro_torch.kernels import fused_join as tfj
from torch_workloads import expo, slab_blocks, syn
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
# 3-D skewed points at 3 slabs: the middle slab has halos on both sides
SLAB = (expo(700, 3, seed=9) / 4, 0.6, 3, 1)


def _slab_index(dtype):
    """The middle slab's grid as the slab join builds it, its global ids
    and owned rows."""
    pts, eps, n_slabs, k = SLAB
    slab, = [s for s in td.slab_indexes(pts.astype(dtype), eps, n_slabs,
                                        device=CPU) if s.slab == k]
    return slab.index, slab.ids, slab.row_ok


@pytest.fixture(scope="module")
def slab_index():
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = _slab_index(dtype)
        return cache[dtype]

    return get


def _launches(index, gid, row_ok, *, merged, unicomp, run_loop):
    """The slab join's launches of ``index``, as its driver prepares them:
    (launch, launch inputs, run plan or None)."""
    tables = tsj._merged_offset_tables if merged else tsj._offset_tables
    deltas, is_zero = tables(index, unicomp)
    tabs = (tgrid.cell_window_tables(index, deltas, merged=merged,
                                     tag=unicomp) if run_loop else None)
    launches, points_pad, _ = tsj._fused_launches(
        index, merged=merged, row_ok=row_ok, gid=gid)
    out = []
    for launch in launches:
        ws, wc, _, qb, qpos = tsj._launch_prep(index, points_pad, deltas,
                                               launch, merged=merged,
                                               tables=tabs)
        plan = (tsj._launch_run_plan(index, qpos, tile=launch[5])
                if run_loop else None)
        out.append((launch, (points_pad, qb, ws, wc, is_zero.to(torch.int32),
                             qpos), plan))
    return out


CASES = [(dt, m, u, r) for dt in (np.float64, np.float32)
         for m in (True, False) for u in (True, False) for r in (False, True)]


@pytest.mark.parametrize(
    "dtype,merged,unicomp,run_loop", CASES,
    ids=[f"{np.dtype(dt).name}-{'merged' if m else 'cell'}-"
         f"{'uni' if u else 'full'}-{'run' if r else 'row'}"
         for dt, m, u, r in CASES])
def test_plain_gid_kernel_matches_jax(slab_index, dtype, merged, unicomp,
                                      run_loop):
    """Every launch of the middle slab's join, hits plane on and off: the
    port's plain B1 (d) equals JAX's reference lowering and JAX's Pallas
    kernel in interpret mode (row or run loop) on hits, counts and
    slot_base (on counts and slot_base alone without the hits plane, where
    JAX's kernel hands back a scratch block)."""
    index, gid, row_ok = slab_index(dtype)
    launches = _launches(index, gid, row_ok, merged=merged, unicomp=unicomp,
                         run_loop=run_loop)
    assert launches
    eps = jnp.asarray(index.eps.numpy())
    total = 0
    for launch, args, plan in launches:
        jargs = [jnp.asarray(a.numpy()) for a in args]
        run = ({} if plan is None else
               dict(run_ord=jnp.asarray(plan.run_ord.numpy()), run_loop=True))
        for keep_hits in (True, False):
            kw = dict(c=launch[4], tq=launch[5], n_real=index.n_dims,
                      unicomp=unicomp, merged=merged, gid_pairs=True,
                      keep_hits=keep_hits)
            got = tfj.fused_join_hits(*args, index.eps, **kw)
            ref = jfj.fused_join_hits(*jargs, eps, method="reference", **kw)
            ker = jfj.fused_join_hits(*jargs, eps, method="kernel",
                                      interpret=True, **run, **kw)
            for name, g, r, k in zip(("hits", "counts", "slot_base"), got,
                                     ref, ker):
                assert g.numpy().dtype == np.asarray(r).dtype, name
                assert np.array_equal(g.numpy(), np.asarray(r)), name
                # without the plane, JAX's kernel returns its scratch block
                if keep_hits or name != "hits":
                    assert np.array_equal(g.numpy(), np.asarray(k)), name
        total += int(got[1].sum())
    assert total > 0


def test_gid_lane_layout():
    """The id lane follows the coordinates and the merged lane; tail rows
    hold -1 there and 0 elsewhere; the merged sweep needs one more free
    lane beside it; the wrapper refuses the masks it never takes."""
    pts = torch.arange(12, dtype=torch.float64).reshape(4, 3)
    last = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    gid = torch.tensor([7, 3, 9, 0], dtype=torch.int32)
    pp = tfj.pad_points(pts, 2, last_coord=last, gid=gid)
    assert pp.shape == (6, 8)
    assert torch.equal(pp[:4, 3], last.double())
    assert torch.equal(pp[:4, 4], gid.double())
    assert torch.equal(pp[4:, 4], torch.full((2,), -1.0, dtype=torch.float64))
    assert not pp[4:, :4].any() and not pp[:, 5:].any()
    assert torch.equal(tfj.pad_points(pts, 2, gid=gid)[:4, 3], gid.double())
    assert tfj.resolve_merge_last_dim(6, None, extra_lanes=1)
    assert not tfj.resolve_merge_last_dim(7, None, extra_lanes=1)
    assert tfj.resolve_merge_last_dim(7, None)
    q = pp[:4]
    ws = torch.zeros((1, 128), dtype=torch.int32)
    args = (pp, torch.cat([q, q.new_zeros((124, 8))]), ws, ws,
            torch.ones(1, dtype=torch.int32),
            torch.zeros(128, dtype=torch.int32))
    for bad in (dict(external=True), dict(metric="jaccard")):
        with pytest.raises(ValueError, match="gid_pairs"):
            tfj.fused_join_hits(*args, 1.0, c=8, n_real=3, unicomp=True,
                                gid_pairs=True, **bad)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_slabs", [2, 3])
def test_padded_grid_build_matches_jax(dtype, n_slabs):
    """``build_grid_with_geometry(valid=)`` on every slab's candidate block
    equals JAX's field for field: invalid slots in the sentinel cell, and
    ``max_per_cell`` without it."""
    pts, eps, _, _ = SLAB
    blocks, gmin, dims, kd = slab_blocks(pts.astype(dtype), eps, n_slabs)
    assert kd == jgrid.device_key_dtype(dims, padded=True)
    for b in blocks:
        want = jgrid.build_grid_with_geometry_jit(
            jnp.asarray(b["cc"]), jnp.asarray(eps, dtype), jnp.asarray(gmin),
            jnp.asarray(dims), jnp.asarray(b["valid"]), key_dtype=kd)
        got = tgrid.build_grid_with_geometry(
            torch.as_tensor(b["cc"]), eps, gmin, dims,
            torch.as_tensor(b["valid"]), key_dtype=kd)
        for f in tgrid.FIELDS:
            w = np.asarray(getattr(want, f))
            g = getattr(got, f).numpy()
            assert g.dtype == w.dtype and np.array_equal(g, w), f
        # the sentinel cell holds more than any real cell on these blocks
        assert int(got.cell_count.max()) > int(got.max_per_cell) > 0


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("bucketed", [True, False])
def test_filter_plan_rows_matches_jax(merged, bucketed):
    """The occupancy plan (or the single contiguous class) filtered to the
    owned rows, against JAX's ``filter_plan_rows`` on its own index; and an
    all-False mask leaves one empty class at the global capacity."""
    pts, eps, n_slabs, k = SLAB
    blocks, gmin, dims, kd = slab_blocks(pts, eps, n_slabs)
    b = blocks[k]
    jidx = jgrid.build_grid_with_geometry_jit(
        jnp.asarray(b["cc"]), jnp.asarray(eps), jnp.asarray(gmin),
        jnp.asarray(dims), jnp.asarray(b["valid"]), key_dtype=kd)
    tidx = tgrid.build_grid_with_geometry(
        torch.as_tensor(b["cc"]), eps, gmin, dims, torch.as_tensor(b["valid"]),
        key_dtype=kd)
    row_ok = b["owned"][np.asarray(jidx.order)]
    cap = tgrid.global_window_cap(tidx, merged)
    if bucketed:
        jplan = jgrid.occupancy_plan(jidx, merged=merged)
        tplan = tgrid.occupancy_plan(tidx, merged=merged)
        assert len(tplan.caps) > 1
    else:
        jplan = jgrid.BucketPlan(caps=(cap,), sel=(None,), cap_global=cap,
                                 hist={cap: tidx.num_points})
        tplan = tgrid.BucketPlan(caps=(cap,), sel=(None,), cap_global=cap,
                                 hist={cap: tidx.num_points})
    for mask in (row_ok, np.zeros_like(row_ok)):
        want = jgrid.filter_plan_rows(jplan, mask)
        got = tgrid.filter_plan_rows(tplan, mask)
        assert got.caps == want.caps and got.hist == want.hist
        assert got.cap_global == want.cap_global
        assert len(got.sel) == len(want.sel)
        for g, w in zip(got.sel, want.sel):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert sum(got.hist.values()) == 0


def _lattice(dtype):
    g = np.arange(14)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    return np.concatenate([pts, pts]).astype(dtype)   # every point twice


def _lattice_pairs(pts, eps):
    ip = pts.astype(np.int64)
    d2 = ((ip[:, None, :] - ip[None, :, :]) ** 2).sum(-1)
    hit = d2 <= int(eps) ** 2
    np.fill_diagonal(hit, False)
    return np.argwhere(hit).astype(np.int32)      # row-major = sorted


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("unicomp", [True, False])
def test_lattice_slab_join_exact(dtype, merge, unicomp):
    """Integer sites, each twice, at eps 2: many d^2 equal eps^2 = 4, every
    cell holds coincident points, and 28 points share each x0, so equal-count
    slabs split a column of equal x0 across a boundary. The slab join at 1-4
    slabs equals an integer brute force, and its counts the same total."""
    pts = _lattice(dtype)
    want = _lattice_pairs(pts, 2.0)
    _, gids, _ = td.partition_points_host(pts, 3)
    split = {float(x) for x in pts[gids[0][gids[0] >= 0], 0]} & {
        float(x) for x in pts[gids[1][gids[1] >= 0], 0]}
    assert split                     # a column of equal x0 on two slabs
    for n_slabs in (1, 2, 3, 4):
        got = td.distributed_self_join(pts, 2.0, n_slabs, unicomp=unicomp,
                                       merge_last_dim=merge, device=CPU)
        assert np.array_equal(got.numpy(), want), n_slabs
        assert td.distributed_self_join(
            pts, 2.0, n_slabs, unicomp=unicomp, merge_last_dim=merge,
            return_pairs=False, device=CPU) == want.shape[0]
    assert td.distributed_self_join_count(pts, 2.0, 3, unicomp=unicomp,
                                          device=CPU) == want.shape[0]


def test_slab_join_on_uniform_points_equals_the_join():
    """A second workload shape for the masks: uniform 2-D points where most
    slabs' rows take the run loop (several points a cell)."""
    pts = syn(1500, 2, seed=4) / 10
    want = tsj.self_join(pts, 0.5, device=CPU)
    for n_slabs in (2, 4):
        got = td.distributed_self_join(pts, 0.5, n_slabs, device=CPU)
        assert torch.equal(got, want)
