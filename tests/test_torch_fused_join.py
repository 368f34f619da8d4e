"""The port's fused gather-refine sweep, held to the JAX package.

Both packages get the same launch inputs: a JAX-built index, padded and
prepared by the JAX drivers, handed over as numpy arrays. The plain PyTorch
version must equal JAX's ``fused_join_hits(method="reference")`` bit for bit
on hits, counts and slot_base. Seeded random data puts no d^2 within an ulp
of eps^2, so exact parity holds even though XLA on the CPU may contract a
multiply-add there; boundary semantics are checked on an integer lattice
whose arithmetic is exact, against an integer brute force.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import grid as jgrid
from repro.core import selfjoin as jsj
from repro.kernels import fused_join as jfj
from repro_torch.core import grid as tgrid
from repro_torch.core import selfjoin as tsj
from repro_torch.kernels import fused_join as tfj
from torch_workloads import SMOKE
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

TQ = 128


@pytest.fixture(scope="module")
def launch_inputs():
    """JAX-prepared inputs of one contiguous launch at the global window
    capacity, per (workload, dtype, merged, unicomp), as numpy arrays."""
    cache = {}

    def get(workload, dtype, merged, unicomp):
        key = (workload, dtype, merged, unicomp)
        if key not in cache:
            pts, eps = SMOKE[workload]
            jidx = jgrid.build_grid_host(pts.astype(dtype), eps)
            c = jgrid.global_window_cap(jidx, merged)
            pp, qp = jsj._fused_pad(jidx, q_size=jidx.num_points, c=c,
                                    tq=TQ, merged=merged)
            tables = (jsj._merged_offset_tables if merged
                      else jsj._offset_tables)
            deltas, is_zero = tables(jidx, unicomp)
            ws, wc, _, qb, qpos = jsj._fused_prep(
                jidx, pp, deltas, jnp.asarray(0, jnp.int32), qp=qp,
                q_limit=jidx.num_points, merged=merged)
            arrays = [np.asarray(a) for a in
                      (pp, qb, ws, wc, is_zero.astype(jnp.int32), qpos)]
            cache[key] = (jidx, arrays, c, eps)
        return cache[key]

    return get


def _torch(arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


CROSS = [(w, dt, m, u, k) for w in SMOKE for dt in (np.float64, np.float32)
         for m in (True, False) for u in (True, False) for k in (True, False)]


@pytest.mark.parametrize(
    "workload,dtype,merged,unicomp,keep_hits", CROSS,
    ids=[f"{w}-{np.dtype(dt).name}-{'merged' if m else 'cell'}-"
         f"{'uni' if u else 'full'}-{'hits' if k else 'count'}"
         for w, dt, m, u, k in CROSS])
def test_reference_matches_jax_reference(launch_inputs, workload, dtype,
                                         merged, unicomp, keep_hits):
    jidx, arrays, c, _ = launch_inputs(workload, dtype, merged, unicomp)
    kw = dict(c=c, n_real=jidx.n_dims, unicomp=unicomp, merged=merged,
              tq=TQ, keep_hits=keep_hits)
    want = jfj.fused_join_hits(*[jnp.asarray(a) for a in arrays],
                               jidx.eps, method="reference", **kw)
    teps = torch.as_tensor(np.array(jidx.eps))
    got = tfj.fused_join_hits(*_torch(arrays), teps, method="reference", **kw)
    for name, g, w in zip(("hits", "counts", "slot_base"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("workload", list(SMOKE))
@pytest.mark.parametrize("merged", [True, False])
def test_port_prep_matches_jax_prep(launch_inputs, workload, merged):
    """The port's pad and descriptor prep, fed the JAX index, produce the
    same launch inputs the JAX drivers do."""
    jidx, arrays, c, _ = launch_inputs(workload, np.float64, merged, True)
    tidx = tgrid.index_from_arrays(
        {f: np.asarray(getattr(jidx, f)) for f in tgrid.FIELDS}, device="cpu")
    pp, qp = tsj._fused_pad(tidx, q_size=tidx.num_points, c=c, tq=TQ,
                            merged=merged)
    tables = tsj._merged_offset_tables if merged else tsj._offset_tables
    deltas, is_zero = tables(tidx, True)
    ws, wc, _, qb, qpos = tsj._fused_prep(tidx, pp, deltas, 0, qp=qp,
                                          q_limit=tidx.num_points,
                                          merged=merged)
    for g, w in zip((pp, qb, ws, wc, is_zero, qpos), arrays):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("eps", [0.1, 0.4, 1.2, 3.0, 14.0])
def test_refine_scalar_matches_jax(dtype, eps):
    """eps is cast to the points' dtype first, then squared in it."""
    from repro.core import metric as jmetric
    from repro_torch.core import metric as tmetric
    want = np.asarray(jmetric.device_refine_scalar("l2", eps, dtype))
    got = tmetric.device_refine_scalar(
        "l2", eps, torch.float64 if dtype == np.float64 else torch.float32)
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)


def _lattice(dtype):
    g = np.arange(20)
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
def test_lattice_boundary_pairs_exact(dtype, merge, unicomp):
    """Integer points at eps = 2: many d^2 land exactly on eps^2 = 4, and
    coincident points have d^2 = 0. Held to an integer brute force."""
    pts = _lattice(dtype)
    want = _lattice_pairs(pts, 2.0)
    got = tsj.self_join(pts, 2.0, unicomp=unicomp, merge_last_dim=merge,
                        device="cpu")
    assert np.array_equal(got.numpy(), want)
    stats = tsj.self_join_count(pts, 2.0, unicomp=unicomp,
                                merge_last_dim=merge, device="cpu")
    assert stats.total_pairs == want.shape[0]


def test_kernel_method_refuses_cpu_tensors(launch_inputs):
    jidx, arrays, c, eps = launch_inputs("uniform-2d", np.float64, True, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfj.fused_join_hits(*_torch(arrays), eps, c=c, n_real=2,
                            unicomp=True, merged=True, method="kernel")


@pytest.mark.parametrize("option", [
    dict(external=True, metric="cosine"), dict(),
    dict(metric="cosine"), dict(metric="jaccard"), dict(n_feat=2)])
def test_unported_kernel_options_raise(launch_inputs, option):
    """gid_pairs (B1 (d), ROADMAP A14 (i)) refuses what the slab join never
    asks of it, external queries and the jaccard metric; with the other
    metrics and lane layouts it equals JAX's reference on a launch whose id
    lane holds the ids in reverse order of the sorted positions (so the id
    triangle and the position triangle disagree)."""
    jidx, arrays, c, eps = launch_inputs("uniform-2d", np.float64, True, True)
    kw = dict(c=c, n_real=2, unicomp=True, merged=True, gid_pairs=True,
              tq=TQ, **option)
    if option.get("external") or option.get("metric") == "jaccard":
        with pytest.raises(ValueError, match="gid_pairs"):
            tfj.fused_join_hits(*_torch(arrays), eps, **kw)
        return
    pp, qb, ws, wc, is_zero, qpos = (np.array(a) for a in arrays)
    npts, qp = jidx.num_points, qb.shape[0]
    assert np.array_equal(qb, pp[:qp])          # one contiguous batch
    gl = 2 + option.get("n_feat", 0) + 1        # after the merged lane
    pp[:npts, gl] = np.arange(npts)[::-1]
    pp[npts:, gl] = -1
    qb = pp[:qp].copy()
    arrays = (pp, qb, ws, wc, is_zero, qpos)
    want = jfj.fused_join_hits(*[jnp.asarray(a) for a in arrays], jidx.eps,
                               method="reference", **kw)
    got = tfj.fused_join_hits(*_torch(arrays),
                              torch.as_tensor(np.array(jidx.eps)), **kw)
    for name, g, w in zip(("hits", "counts", "slot_base"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert int(got[1].sum()) > 0


def test_run_loop_needs_a_run_plan(launch_inputs):
    jidx, arrays, c, eps = launch_inputs("uniform-2d", np.float64, True, True)
    args = _torch(arrays)
    kw = dict(c=c, n_real=2, unicomp=True, merged=True)
    with pytest.raises(ValueError, match="run_ord"):
        tfj.fused_join_hits(*args, eps, run_loop=True, **kw)
    qp = args[1].shape[0]
    for bad in (torch.zeros(qp, dtype=torch.int64),
                torch.zeros(qp + 1, dtype=torch.int32),
                torch.zeros(2 * qp, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="run_ord"):
            tfj.fused_join_hits(*args, eps, run_loop=True, run_ord=bad, **kw)
