"""The PyTorch port's grid index and planning, held to the JAX package.

Every compared output is an integer array or an exact float copy, so the
tolerance is zero: values and dtypes must be equal. The JAX side runs as its
own tests run it on the CPU; inputs are made with numpy from a seed and
handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.grid as jgrid
import repro_torch
import repro_torch.core
import repro_torch.core.grid as tgrid
from repro.core.stencil import merged_stencil_offsets, stencil_offsets
from repro_torch.core import stencil as tstencil
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"


def assert_fields_equal(jax_index, torch_index):
    want = {f: np.asarray(getattr(jax_index, f)) for f in tgrid.FIELDS}
    got = tgrid.index_to_numpy(torch_index)
    for f in tgrid.FIELDS:
        assert got[f].dtype == want[f].dtype, (f, got[f].dtype, want[f].dtype)
        assert np.array_equal(got[f], want[f]), f


def clustered(rng, n, d, spread=0.05):
    centers = rng.uniform(0.0, 1.0, (max(2, n // 200), d))
    which = rng.integers(0, centers.shape[0], n)
    return centers[which] + rng.normal(0.0, spread, (n, d))


def build_cases():
    rng = np.random.default_rng(7)
    for d, eps in ((2, 0.04), (3, 0.1), (4, 0.25), (5, 0.4), (6, 0.5)):
        yield f"uniform-{d}d", rng.uniform(0.0, 1.0, (900, d)), eps
    yield "clustered-3d", clustered(rng, 800, 3), 0.08
    yield "clustered-3d-f32", clustered(rng, 800, 3).astype(np.float32), 0.08
    yield "uniform-2d-f32", rng.uniform(0, 100, (700, 2)).astype(np.float32), 0.4
    dup = rng.integers(0, 4, (300, 3)).astype(np.float64)
    yield "duplicates", dup, 0.5
    yield "one-point", rng.uniform(0, 1, (1, 3)), 0.1
    yield "two-points", rng.uniform(0, 1, (2, 2)), 0.1
    six = rng.uniform(0, 100, size=(400, 6))
    six[0], six[1] = 0.0, 100.0          # ~3.0e9 cells: int64 keys
    yield "int64-keys-6d", six, 2.9


BUILD_CASES = list(build_cases())


@pytest.mark.parametrize("name,pts,eps", BUILD_CASES,
                         ids=[c[0] for c in BUILD_CASES])
def test_build_grid_matches_jax_host_build(name, pts, eps):
    want = jgrid.build_grid_host(pts, eps)
    got = tgrid.build_grid(pts, eps, device=CPU)
    assert_fields_equal(want, got)
    if name == "int64-keys-6d":
        assert got.cell_keys.dtype == torch.int64
    elif name == "uniform-2d-f32":
        assert got.cell_keys.dtype == torch.int32


@pytest.mark.parametrize("dims", [
    (10, 10), (46341, 46341), (46340, 46340), (1290, 1290, 1290),
    (2, 3, 5, 7, 11, 13), (215, 215, 215, 215), (1 << 31, 1), (3,),
])
def test_key_rules_match_jax(dims):
    dims = np.asarray(dims, np.int64)
    assert tgrid.key_dtype_for(dims) == jgrid.key_dtype_for(dims)
    kd = tgrid.key_dtype_for(dims)
    assert tgrid.pad_key_for(kd) == jgrid.pad_key_for(kd)
    assert tgrid.sentinel_margin(dims) == jgrid.sentinel_margin(dims)
    for padded in (False, True):
        assert (tgrid.device_key_dtype(dims, padded)
                == jgrid.device_key_dtype(dims, padded))


@pytest.mark.parametrize("kd", [np.int32, np.int64])
def test_pad_probe_matches_jax(kd):
    rng = np.random.default_rng(1)
    arr = rng.integers(-50, 50, 64).astype(np.int64)
    mask = rng.random(64) < 0.5
    want = np.asarray(jgrid._pad_probe(jnp.asarray(arr), jnp.asarray(mask),
                                       kd))
    got = tgrid._pad_probe(torch.as_tensor(arr), torch.as_tensor(mask),
                           kd).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("unicomp", [True, False])
def test_stencils_match_jax(n, unicomp):
    assert np.array_equal(tstencil.stencil_offsets(n, unicomp),
                          stencil_offsets(n, unicomp))
    for a, b in zip(tstencil.merged_stencil_offsets(n, unicomp),
                    merged_stencil_offsets(n, unicomp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def plan_cases():
    rng = np.random.default_rng(11)
    yield "uniform-2d", rng.uniform(0, 100, (3000, 2)), 0.4
    yield "clustered-2d", clustered(rng, 2000, 2, spread=0.02), 0.01
    yield "expo-3d", rng.exponential(10.0, (2000, 3)), 1.2
    yield "clustered-4d", clustered(rng, 1500, 4), 0.1
    yield "uniform-6d-int64", BUILD_CASES[-1][1], 2.9


PLAN_CASES = list(plan_cases())


@pytest.fixture(scope="module", params=PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def planned(request):
    """One JAX host-built index per case, and the port's copy of it."""
    _, pts, eps = request.param
    jidx = jgrid.build_grid_host(pts, eps)
    fields = {f: np.asarray(getattr(jidx, f)) for f in tgrid.FIELDS}
    return jidx, tgrid.index_from_arrays(fields, device=CPU), fields


def test_index_from_arrays_round_trips(planned):
    _, tidx, fields = planned
    back = tgrid.index_to_numpy(tidx)
    for f in tgrid.FIELDS:
        assert back[f].dtype == fields[f].dtype
        assert np.array_equal(back[f], fields[f])


def _query_positions(npts, seed):
    rng = np.random.default_rng(seed)
    q = np.sort(rng.choice(npts, size=min(npts, 300), replace=False))
    q = np.concatenate([q, [npts, npts + 5]]).astype(np.int32)  # padding rows
    ok = q < npts
    ok[::7] = False
    return q, ok


@pytest.mark.parametrize("unicomp", [True, False])
def test_window_descriptors_match_jax(planned, unicomp):
    jidx, tidx, _ = planned
    offs = stencil_offsets(tidx.n_dims, unicomp)
    deltas = offs @ np.asarray(jgrid.row_major_strides(jidx.dims))
    q, ok = _query_positions(tidx.num_points, 2)
    want = jgrid.window_descriptors_at(jidx, jnp.asarray(deltas),
                                       jnp.asarray(q), jnp.asarray(ok))
    got = tgrid.window_descriptors_at(tidx, torch.as_tensor(deltas),
                                      torch.as_tensor(q), torch.as_tensor(ok))
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("unicomp", [True, False])
def test_range_window_descriptors_match_jax(planned, unicomp):
    jidx, tidx, _ = planned
    reduced, lo, hi = merged_stencil_offsets(tidx.n_dims, unicomp)
    deltas = reduced @ np.asarray(jgrid.row_major_strides(jidx.dims))
    q, ok = _query_positions(tidx.num_points, 3)
    want = jgrid.range_window_descriptors_at(
        jidx, jnp.asarray(deltas), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(q), jnp.asarray(ok))
    got = tgrid.range_window_descriptors_at(
        tidx, torch.as_tensor(deltas), torch.as_tensor(lo),
        torch.as_tensor(hi), torch.as_tensor(q), torch.as_tensor(ok))
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_point_last_coords_and_starts_match_jax(planned):
    jidx, tidx, _ = planned
    assert np.array_equal(tgrid.point_last_coords(tidx).numpy(),
                          np.asarray(jgrid.point_last_coords(jidx)))
    assert np.array_equal(tgrid.starts_ext(tidx), jgrid.starts_ext(jidx))


@pytest.mark.parametrize("merged", [True, False])
def test_capacity_plans_match_jax(planned, merged):
    jidx, tidx, _ = planned
    want_caps = jgrid.cell_window_caps(jidx, merged=merged)
    got_caps = tgrid.cell_window_caps(tidx, merged=merged)
    assert got_caps.dtype == want_caps.dtype
    assert np.array_equal(got_caps, want_caps)
    assert (tgrid.global_window_cap(tidx, merged)
            == jgrid.global_window_cap(jidx, merged))
    want = jgrid.occupancy_plan(jidx, merged=merged)
    got = tgrid.occupancy_plan(tidx, merged=merged)
    assert got.caps == want.caps
    assert got.cap_global == want.cap_global
    assert got.hist == want.hist
    assert len(got.sel) == len(want.sel)
    for a, b in zip(got.sel, want.sel):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)


# ROADMAP §C, C4: an eps that is not finite and positive, or a cell count
# past int64, used to reach an unchecked int64 cast (-2^63), and the port's
# join then emitted (i, i) pairs and doubled pairs. The probe's data.
C4_POINTS = np.random.default_rng(2).random((40, 2)) * 3
C4_REFUSED = [0.0, 1e-300, 1e-19, float("inf"), -0.5, float("nan")]
C4_ENTRIES = {
    "build_grid": lambda p, e: tgrid.build_grid(p, e, device=CPU),
    "self_join": lambda p, e: repro_torch.self_join(p, e, device=CPU),
    "self_join_count": lambda p, e: repro_torch.self_join_count(
        p, e, device=CPU),
    "distributed_self_join": lambda p, e: repro_torch.core.
    distributed_self_join(p, e, 2, device=CPU),
    "distributed_self_join_count": lambda p, e: repro_torch.core.
    distributed_self_join_count(p, e, 2, device=CPU),
}


@pytest.mark.parametrize("entry", sorted(C4_ENTRIES))
@pytest.mark.parametrize("eps", C4_REFUSED, ids=str)
def test_degenerate_geometry_is_refused(entry, eps):
    with pytest.raises(ValueError, match="C4"):
        C4_ENTRIES[entry](C4_POINTS, eps)


@pytest.mark.parametrize("duplicates", [0, 5])
def test_cell_count_below_int64_still_joins(tmp_path, duplicates):
    """eps 1e-18 puts ~3e18 cells on a side, below 2^63: the join runs and
    gives JAX's pairs (the duplicated rows' pairs, at d = 0)."""
    import repro.core.selfjoin as jsj
    from torch_workloads import jax_default_tables

    pts = np.concatenate([C4_POINTS, C4_POINTS[:duplicates]])
    with jax_default_tables(tmp_path):
        want = np.asarray(jsj.self_join(pts, 1e-18, distance_impl="fused"))
    got = repro_torch.self_join(pts, 1e-18, device=CPU).numpy()
    assert want.shape[0] == 2 * duplicates
    assert np.array_equal(got, want)
    assert (repro_torch.self_join_count(pts, 1e-18, device=CPU).total_pairs
            == want.shape[0])
