"""Rank workers of ``test_torch_collective.py``.

``repro_torch.launch.mesh.spawn`` starts each rank in a new process, which
imports its function by name; these live here, on the tests' path, for that
reason. Each rank runs a list of cases on a CPU ``SlabMesh`` (gloo) and
returns, per case, numpy arrays or the text of the error it raised, so a
test can check that every rank raised the same error.
"""
import numpy as np
import torch

from repro_torch.core import distributed as td
from repro_torch.launch import mesh as tmesh

CPU = "cpu"


def _host_plan(pts, eps, n_slabs, halo_capacity=None, max_per_cell=0):
    """The plan every rank and JAX's step compute alike: the partition and
    the ``DistJoinConfig`` of JAX's ``make_halo_step`` test."""
    coords, gids, _ = td.partition_points_host(pts, n_slabs)
    mins, maxs = td.slab_extents(coords, gids)
    k = td.halo_reach(mins, maxs, eps)
    if halo_capacity is None:
        need = td.exact_halo_capacity(coords, gids, mins, maxs, eps, k)
        halo_capacity = min(td._next_pow2(need), coords.shape[1])
    cfg = td.DistJoinConfig(coords.shape[1], pts.shape[1], halo_capacity,
                            max_per_cell, k_hops=k)
    return coords, gids, cfg


def _block(mesh, pts, eps):
    """This rank's candidate block from the halo step, and whether
    ``candidate_blocks`` gives the same."""
    coords, gids, cfg = _host_plan(pts, eps, mesh.n_slabs)
    step = td.make_halo_step(mesh, cfg)
    c, g, v, o, halo_of = step(torch.as_tensor(coords[mesh.slab]),
                               torch.as_tensor(gids[mesh.slab]),
                               torch.tensor(eps, dtype=torch.float64))
    joined = td.candidate_blocks(pts, eps, mesh)
    return dict(cand_c=c.numpy(), cand_g=g.numpy(), cand_v=v.numpy(),
                cand_o=o.numpy(), halo_of=np.asarray(halo_of),
                blocks_match=np.asarray(all(
                    torch.equal(a, b[0]) for a, b in zip((c, g, v, o),
                                                         joined))))


def _pairs(mesh, pts, eps, **kw):
    return td.distributed_self_join(pts, eps, mesh, **kw).numpy()


def _count_only(mesh, pts, eps, **kw):
    return np.asarray(td.distributed_self_join(pts, eps, mesh,
                                               return_pairs=False, **kw))


def _count(mesh, pts, eps, **kw):
    return np.asarray(td.distributed_self_join_count(pts, eps, mesh, **kw))


def _count_step(mesh, pts, eps, halo_capacity, max_per_cell):
    """JAX's overflow test: the count step's flags at a forced capacity."""
    coords, gids, cfg = _host_plan(pts, eps, mesh.n_slabs, halo_capacity,
                                   max_per_cell)
    step = td.make_distributed_count_step(mesh, cfg)
    total, halo_of, cell_of = step(torch.as_tensor(coords[mesh.slab]),
                                   torch.as_tensor(gids[mesh.slab]), eps)
    return np.asarray([total, halo_of, cell_of])


def _wrong_size(mesh, pts, eps):
    return np.asarray(tmesh.make_slab_mesh(mesh.n_slabs + 1, device=CPU))


KINDS = {"block": _block, "pairs": _pairs, "count_only": _count_only,
         "count": _count, "count_step": _count_step,
         "wrong_size": _wrong_size}


def cases_rank(rank, n_slabs, n_model, cases):
    """Run ``cases`` ((name, kind, points, eps, keywords) tuples) on this
    rank of a CPU ``(n_slabs, n_model)`` mesh."""
    mesh = tmesh.make_slab_mesh(n_slabs, n_model, device=CPU)
    out = {"slab": mesh.slab, "model": mesh.model, "backend": mesh.backend}
    for name, kind, pts, eps, kw in cases:
        try:
            out[name] = KINDS[kind](mesh, pts, eps, **kw)
        except (RuntimeError, ValueError, NotImplementedError) as err:
            out[name] = f"{type(err).__name__}: {err}"
    return out


def overflow_rank(rank, pts, eps):
    """A slab join at a halo capacity too small, left to raise: ``spawn``
    must raise the rank's error in the caller."""
    mesh = tmesh.make_slab_mesh(2, device=CPU)
    return td.distributed_self_join(pts, eps, mesh, halo_capacity=2)


def sanitized_rank(rank, pts, eps):
    """The slab join on this rank of a 2-slab CPU mesh in sanitized mode:
    the pairs it returns, the B1 codes it recorded and those left pending
    (``test_torch_sanitize.py``)."""
    from repro_torch.analysis import sanitize

    recorded = []
    record = sanitize.record
    sanitize.record = lambda label, code: (recorded.append(label),
                                           record(label, code))
    sanitize.set_enabled(True)
    mesh = tmesh.make_slab_mesh(2, device=CPU)
    pairs = td.distributed_self_join(pts, eps, mesh)
    return dict(pairs=int(pairs.shape[0]), recorded=len(recorded),
                pending=sanitize.pending())
