"""The port's joins through the unfused offset sweep (``distance_impl="jnp" |
"pallas"``), held to the JAX package; its counts, the compact count route
and per-point neighbour counts are in ``test_torch_unfused_count.py``.

Inputs are the seeded workloads of ``torch_workloads``. JAX's "jnp" is the
reference on every workload; its "pallas" runs the Pallas kernel in the
interpreter (about 500x slower) and is held only at a few hundred points.
The port's "jnp" and "pallas" refine lane by lane in lane order, so they
give the same pairs bit for bit, and JAX's on seeded data, where no d^2 lies
within an ulp of eps^2 (XLA may pair lanes or contract a multiply-add there).
On an integer lattice, where many d^2 land exactly on eps^2, both are held
to an integer brute force. Unsorted pairs must come in JAX's order too:
offset-major, then row-major over (query row, slot), a UNICOMP hit writing
(q, c) and then (c, q).
"""
import numpy as np
import pytest
import torch

import repro_torch
import repro.core.selfjoin as jsj
from repro_torch.core import selfjoin as tsj
from torch_workloads import SMOKE, WORKLOADS
from torch_workloads import jax_tables  # noqa: F401  (fixture)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

IMPLS = ["jnp", "pallas"]
# the join cases sweep 5-41 offsets; the 6-D workload (365 UNICOMP offsets,
# 729 without) is held through the counts, UNICOMP on
# (test_torch_unfused_count.py)
LOW_DIMS = [w for w in WORKLOADS if w != "clustered-6d"]
FIELDS = ("total_pairs", "cells_visited", "candidates_checked", "offsets",
          "route", "dma_windows_issued", "dma_bytes_saved")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """``get(fn, workload, **kw)``: a JAX entry point on a workload with
    ``distance_impl="jnp"`` unless ``kw`` names one, computed once, with the
    default tile."""
    from torch_workloads import jax_default_tables

    table_dir = tmp_path_factory.mktemp("autotune")
    cache = {}

    def get(fn, workload, **kw):
        key = (fn, workload, tuple(sorted(kw.items())))
        if key not in cache:
            pts, eps = WORKLOADS[workload]
            kw.setdefault("distance_impl", "jnp")
            with jax_default_tables(table_dir):
                cache[key] = getattr(jsj, fn)(pts, eps, **kw)
        return cache[key]

    return get


def _same_stats(got, want):
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field


JOIN_CASES = [(w, impl, unicomp) for w in LOW_DIMS for impl in IMPLS
              for unicomp in (True, False)]


@pytest.mark.parametrize("workload,impl,unicomp", JOIN_CASES,
                         ids=[f"{w}-{i}-unicomp={u}"
                              for w, i, u in JOIN_CASES])
def test_self_join_matches_jax(jax_runs, workload, impl, unicomp):
    """Sorted and unsorted pairs, order included."""
    pts, eps = WORKLOADS[workload]
    for sort_result in (True, False):
        want = jax_runs("self_join", workload, unicomp=unicomp,
                        sort_result=sort_result)
        got = repro_torch.self_join(pts, eps, unicomp=unicomp,
                                    distance_impl=impl,
                                    sort_result=sort_result, device="cpu")
        assert got.dtype == torch.int32 and want.shape[0] > 0
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("workload", LOW_DIMS)
def test_unfused_pairs_equal_fused(workload):
    pts, eps = WORKLOADS[workload]
    fused = repro_torch.self_join(pts, eps, device="cpu")
    for impl in IMPLS:
        assert torch.equal(repro_torch.self_join(pts, eps, distance_impl=impl,
                                                 device="cpu"), fused)


BATCH_CASES = [(w, impl, n) for w in SMOKE for impl in IMPLS for n in (3, 7)]


@pytest.mark.parametrize("workload,impl,n_batches", BATCH_CASES,
                         ids=[f"{w}-{i}-{n}" for w, i, n in BATCH_CASES])
def test_self_join_batched_matches_jax(jax_runs, workload, impl, n_batches):
    """Unsorted pairs in JAX's order (batch-major), on the host; sorted,
    the pair set of self_join."""
    pts, eps = WORKLOADS[workload]
    want = jax_runs("self_join_batched", workload, n_batches=n_batches,
                    sort_result=False)
    got = repro_torch.self_join_batched(pts, eps, n_batches=n_batches,
                                        distance_impl=impl, sort_result=False,
                                        device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(
        tsj.sort_pairs(got, len(pts)),
        repro_torch.self_join(pts, eps, distance_impl=impl, device="cpu"))


@pytest.mark.parametrize("npts", [1, 2, 3, 5])
@pytest.mark.parametrize("impl", IMPLS)
def test_batched_more_batches_than_points(npts, impl):
    """n_batches beyond the point count clamps to one batch a point."""
    pts = np.random.default_rng(23).uniform(0, 2, (npts, 2))
    want = jsj.self_join(pts, 0.8, distance_impl="jnp")
    got = repro_torch.self_join_batched(pts, 0.8, n_batches=npts + 4,
                                        distance_impl=impl, device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        repro_torch.self_join(pts, 0.8, distance_impl=impl,
                              device="cpu").numpy(), want)


@pytest.mark.parametrize("unicomp", [True, False])
def test_pallas_matches_jax_pallas(unicomp):
    """At 300 points JAX runs its Pallas kernel (interpreted) through the
    join, the count and the batched join."""
    pts = np.random.default_rng(17).uniform(0, 10, (300, 2))
    for sort_result in (True, False):
        want = jsj.self_join(pts, 0.7, unicomp=unicomp,
                             distance_impl="pallas", sort_result=sort_result)
        got = repro_torch.self_join(pts, 0.7, unicomp=unicomp,
                                    distance_impl="pallas",
                                    sort_result=sort_result, device="cpu")
        assert want.shape[0] > 0 and np.array_equal(got.numpy(), want)
    _same_stats(repro_torch.self_join_count(pts, 0.7, unicomp=unicomp,
                                            distance_impl="pallas",
                                            device="cpu"),
                jsj.self_join_count(pts, 0.7, unicomp=unicomp,
                                    distance_impl="pallas"))
    want = jsj.self_join_batched(pts, 0.7, unicomp=unicomp, n_batches=3,
                                 distance_impl="pallas", sort_result=False)
    got = repro_torch.self_join_batched(pts, 0.7, unicomp=unicomp,
                                        n_batches=3, distance_impl="pallas",
                                        sort_result=False, device="cpu")
    assert np.array_equal(got.numpy(), want)


def _lattice(dtype):
    g = np.arange(12)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([pts, pts[::5]]).astype(dtype)  # some twice


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("unicomp", [True, False])
def test_lattice_boundary_pairs_exact(dtype, impl, unicomp):
    """Integer points at eps = 2: many d^2 land exactly on eps^2 = 4, and
    duplicates have d^2 = 0. Held to an integer brute force."""
    pts = _lattice(dtype)
    ip = pts.astype(np.int64)
    hit = ((ip[:, None, :] - ip[None, :, :]) ** 2).sum(-1) <= 4
    np.fill_diagonal(hit, False)
    want = np.argwhere(hit).astype(np.int32)          # row-major = sorted
    got = repro_torch.self_join(pts, 2.0, unicomp=unicomp, distance_impl=impl,
                                device="cpu")
    assert np.array_equal(got.numpy(), want)
    stats = repro_torch.self_join_count(pts, 2.0, unicomp=unicomp,
                                        distance_impl=impl, device="cpu")
    compact = tsj.self_join_count_compact(pts, 2.0, unicomp=unicomp,
                                          distance_impl=impl, device="cpu")
    assert stats.total_pairs == compact.total_pairs == want.shape[0]
    assert np.array_equal(repro_torch.per_point_neighbor_counts(
        pts, 2.0, merge_last_dim=unicomp, device="cpu"), hit.sum(1))


def test_unknown_impl_is_a_value_error():
    pts = WORKLOADS["uniform-2d"][0][:100]
    for call in (repro_torch.self_join, repro_torch.self_join_count,
                 repro_torch.self_join_batched,
                 repro_torch.self_join_count_compact):
        with pytest.raises(ValueError, match="unknown distance_impl"):
            call(pts, 0.4, distance_impl="nope", device="cpu")
