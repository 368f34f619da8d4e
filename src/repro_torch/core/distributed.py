"""The slab join: spatial slabs with an eps-halo, in one process or over ranks.

The counterpart of the JAX package's ``repro.core.distributed`` (the scale-out
design of DESIGN.md S3). Points are cut into equal-count slabs along
dimension 0 on the host (``partition_points_host``; empty slabs are legal).
Each slab then

  1. receives a k-hop eps-halo from its neighbours: exactly the points
     within eps, along dimension 0, of its boundary, which is all another
     slab can ever need (``_assemble_candidates``; ``halo_reach`` derives k,
     parcels hold at most ``halo_capacity`` rows and an overflow raises,
     never drops a point);
  2. builds its own grid over its points and the halo against the GLOBAL
     grid geometry, so cell coordinates, and with them the UNICOMP
     ownership of a pair of cells, agree across slabs; and
  3. joins only the pairs whose query point it owns.

The entry points take JAX's ``mesh`` argument in two forms. A slab count runs
every slab in one process: the exchange is a shift over the stacked (S, P,
n) slabs on one device, with JAX's block layout, and the slabs are joined in
turn on that device. A ``launch.mesh.SlabMesh`` runs SPMD over
``torch.distributed``, one rank a slab (times ``n_model``): every rank
partitions the same points on the host and keeps its own slab, and the
exchange is the collective of JAX's ``_halo_exchange``: the boundaries and
parcels of hop h go to and come from the ranks h slabs away, both
directions in one ``batch_isend_irecv`` (``_RankRing``). Overflow flags and
failures are all-reduced before any rank raises, so the ranks raise
together. The pairs are all-gathered, the totals all-reduced, and every
rank returns what the one-process path returns.

``distributed_self_join`` is the fused pair join: per slab the one-process
fast path (``selfjoin._self_join_fused``: merged sweep, occupancy buckets,
count -> fill) over the slab's owned rows, with global point ids riding a
pad lane of the kernel (B1 (d), ``gid_pairs``), so that a tie inside a cell
breaks the same way on every slab. Its sorted pairs equal
``self_join(distance_impl="fused")``'s.

``distributed_self_join_count`` is the plain offset sweep the JAX package
keeps for its offset-parallel mesh axis: on a ``SlabMesh`` with
``model_axis="model"`` each rank sweeps the block of stencil offsets of its
model index, and the totals are summed over every rank (JAX's ``psum`` over
``(slab, model)``).

Single counting: with global cell coordinates the UNICOMP half-stencil gives
each unordered pair of adjacent cells to one directed evaluation; the slab
owning that evaluation's query point is unique, and its candidates hold the
other point (a pair within eps is within eps along dimension 0, so inside
the k-hop halo). Pairs inside a cell are ordered by global id.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import metric as metric_lib
from repro_torch.core.grid import (GridIndex, build_grid,
                                   build_grid_with_geometry,
                                   check_float_points, device_key_dtype,
                                   geometry_dtype, host_grid_geometry,
                                   points_geometry, resolve_device,
                                   row_major_strides)
from repro_torch.core.selfjoin import (_distance_hits_jnp, _gather_batch,
                                       _neighbor_ranks_for_delta,
                                       _self_join_count_fused,
                                       _self_join_fused, sort_pairs)
from repro_torch.core.stencil import stencil_offsets
from repro_torch.kernels.fused_join import NP_PAD, resolve_merge_last_dim

# The most points whose global ids (0 .. npts - 1) a half dtype holds
# exactly in the kernel's id lane: float16 integers are exact up to 2,048,
# bfloat16 ones up to 256. The JAX package refuses only npts >= 2^24 and
# loses pairs past these (ROADMAP §C, C3).
GID_EXACT_POINTS = {torch.float16: 2049, torch.bfloat16: 257}


@dataclasses.dataclass(frozen=True)
class DistJoinConfig:
    pts_per_device: int          # P: rows of a slab (padded)
    n_dims: int
    halo_capacity: int           # H: rows of a parcel, per direction and hop
    max_per_cell: int            # C: window of the plain count sweep
    # hops of the halo: an equal-count slab narrower than eps (skewed data,
    # many slabs) needs points from more than one slab away
    k_hops: int = 1
    # cell-key dtype of the padded slab grids (``device_key_dtype`` with
    # padded=True: the slab grids hold the out-of-set sentinel cell)
    key_dtype: str = "int64"
    unicomp: bool = True         # the count step's stencil
    # "model": the count step shards the stencil offsets over the mesh's
    # model index; None: model index 0 sweeps them all
    model_axis: Optional[str] = None


def partition_points_host(points: np.ndarray, n_slabs: int):
    """Equal-count slabs along dimension 0, on the host.

    Returns (coords (n_slabs, P, n), gids (n_slabs, P) int32 with -1 in the
    padding, the narrowest slab's width along dimension 0). Equal counts
    keep the slabs balanced under skew."""
    pts = np.asarray(points)
    npts, n = pts.shape
    order = np.argsort(pts[:, 0], kind="stable")
    slabs = np.array_split(order, n_slabs)
    pcap = max(len(s) for s in slabs)
    coords = np.zeros((n_slabs, pcap, n), dtype=pts.dtype)
    gids = np.full((n_slabs, pcap), -1, dtype=np.int32)
    for k, s in enumerate(slabs):
        coords[k, :len(s)] = pts[s]
        gids[k, :len(s)] = s
        if len(s):
            coords[k, len(s):] = pts[s[0]]  # filler, masked by its gid
    widths = [pts[s, 0].max() - pts[s, 0].min() for s in slabs if len(s) > 1]
    return coords, gids, min(widths) if widths else 0.0


def slab_extents(coords: np.ndarray, gids: np.ndarray):
    """Each slab's [min, max] along dimension 0; an empty slab (possible
    when ``n_slabs`` nears the point count) gets (+inf, -inf)."""
    n_slabs = coords.shape[0]
    mins = np.full(n_slabs, np.inf)
    maxs = np.full(n_slabs, -np.inf)
    for i in range(n_slabs):
        own = gids[i] >= 0
        if own.any():
            mins[i] = coords[i, own, 0].min()
            maxs[i] = coords[i, own, 0].max()
    return mins, maxs


def halo_reach(mins: np.ndarray, maxs: np.ndarray, eps: float) -> int:
    """The hop count k such that every slab's eps-neighbourhood along
    dimension 0 lies within its k-hop neighbours. Empty slabs sit at the
    end of the partition, so an empty slab's +inf min ends the scan where a
    slab too far away would."""
    n_slabs = mins.shape[0]
    k_hops = 1
    for i in range(n_slabs):
        if not np.isfinite(maxs[i]):
            continue
        for h in range(1, n_slabs - i):
            if mins[i + h] <= maxs[i] + eps:
                k_hops = max(k_hops, h)
            else:
                break
    return k_hops


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class HaloParcel:
    """One (shipping slab, hop, direction) halo parcel and its exact size."""
    slab: int          # the slab shipping the parcel
    hop: int           # 1..k_hops
    direction: int     # -1 toward lower slabs, +1 toward higher ones
    need: int          # rows the parcel must carry

    @property
    def dest(self) -> int:
        return self.slab + self.direction * self.hop

    def describe(self) -> str:
        return (f"slab {self.slab} -> slab {self.dest} (hop {self.hop}, "
                f"direction {self.direction:+d}) ships {self.need} rows")


def halo_capacity_plan(coords: np.ndarray, gids: np.ndarray,
                       mins: np.ndarray, maxs: np.ndarray, eps: float,
                       k_hops: int) -> list:
    """Every parcel the exchange ships, with its exact size: slabs hold
    points sorted along dimension 0, so each size is one searchsorted
    against the receiving slab's boundary."""
    n_slabs = coords.shape[0]
    plan = []
    for j in range(n_slabs):
        x0 = coords[j, gids[j] >= 0, 0]          # ascending
        if not x0.size:
            continue
        for h in range(1, k_hops + 1):
            if j - h >= 0 and np.isfinite(maxs[j - h]):
                # parcel j -> j - h: points with x0 <= maxs[j - h] + eps
                need = int(np.searchsorted(x0, maxs[j - h] + eps,
                                           side="right"))
                plan.append(HaloParcel(j, h, -1, need))
            if j + h < n_slabs and np.isfinite(mins[j + h]):
                # parcel j -> j + h: points with x0 >= mins[j + h] - eps
                need = int(x0.size - np.searchsorted(
                    x0, mins[j + h] - eps, side="left"))
                plan.append(HaloParcel(j, h, +1, need))
    return plan


def worst_halo_parcel(plan) -> Optional[HaloParcel]:
    return max(plan, key=lambda p: p.need) if plan else None


def exact_halo_capacity(coords: np.ndarray, gids: np.ndarray,
                        mins: np.ndarray, maxs: np.ndarray, eps: float,
                        k_hops: int) -> int:
    """The largest parcel of ``halo_capacity_plan``: the capacity at which
    no parcel overflows."""
    worst = worst_halo_parcel(
        halo_capacity_plan(coords, gids, mins, maxs, eps, k_hops))
    return worst.need if worst is not None else 1


def _halo_overflow_error(capacity: int, plan) -> RuntimeError:
    """The overflow report: the worst parcel and the capacity that fits."""
    worst = worst_halo_parcel(plan)
    if worst is None:
        return RuntimeError(f"halo capacity overflow: capacity {capacity}")
    over = [p for p in plan if p.need > capacity]
    return RuntimeError(
        f"halo capacity overflow: capacity {capacity} < required "
        f"{worst.need}; {len(over)} parcel(s) exceed it, worst: "
        f"{worst.describe()}. Pass halo_capacity >= {worst.need}, or "
        f"omit it for the exact default.")


def _canonicalize_for_slabs(points, eps, metric: str):
    """The metric gate of the slab drivers: cosine becomes L2 on the unit
    rows (exact), so the slab pipeline runs unchanged; jaccard's packed
    words do not ride the halo exchange, so it raises."""
    metric_lib.check_metric(metric)
    if metric == "jaccard":
        raise NotImplementedError(
            "distributed jaccard join: bitmap feature lanes do not ride "
            "the slab halo exchange yet; use the single-device fused path "
            "(core.selfjoin.self_join(metric='jaccard'))")
    if metric == "cosine":
        canon = metric_lib.canonicalize(points, eps, metric="cosine")
        return np.asarray(canon.geom), float(canon.eps_geom)
    return points, eps


# ---------------------------------------------------------------------------
# The halo exchange: over the stacked slabs of one device, or between ranks
# ---------------------------------------------------------------------------

def _halo_exchange(x: torch.Tensor, valid: torch.Tensor, direction: int,
                   hops: int = 1):
    """Shift (x, valid) ``hops`` slabs along the slab axis (axis 0):
    direction +1 sends right (slab i's value lands on slab i + hops). Slabs
    with no sender receive zeros, flagged invalid."""
    s = x.shape[0]
    rx = torch.zeros_like(x)
    rv = torch.zeros_like(valid)
    if hops < s:
        if direction > 0:
            rx[hops:], rv[hops:] = x[:s - hops], valid[:s - hops]
        else:
            rx[:s - hops], rv[:s - hops] = x[hops:], valid[hops:]
    return rx, rv


class _Stacked:
    """The exchange over the stacked (S, ...) slabs of one device: each
    hop is a shift along the slab axis."""

    @staticmethod
    def bounds(my_max0, my_min0, h):
        """(left_max, ok, right_min, ok): the maximum along dimension 0 of
        the slab h to the left and the minimum of the slab h to the
        right."""
        every = torch.ones(my_max0.shape[0], dtype=torch.bool,
                           device=my_max0.device)
        left_max, lm_ok = _halo_exchange(my_max0, every, +1, h)
        right_min, rm_ok = _halo_exchange(my_min0, every, -1, h)
        return left_max, lm_ok, right_min, rm_ok

    @staticmethod
    def parcels(left, right, h):
        """Ship the (coords, gids, sent) parcel ``left`` h slabs to the left
        and ``right`` h slabs to the right; returns what each slab receives
        from its right and from its left."""
        (cl, gl, vl), (cr, gr, vr) = left, right
        hcl, hvl = _halo_exchange(cl, vl, -1, h)
        hgl, _ = _halo_exchange(gl, vl, -1, h)
        hcr, hvr = _halo_exchange(cr, vr, +1, h)
        hgr, _ = _halo_exchange(gr, vr, +1, h)
        return (hcl, hgl, hvl), (hcr, hgr, hvr)


# gloo's sends may refuse half dtypes: those cross as their raw bits
_WIRE_BITS = {torch.float16: torch.int16, torch.bfloat16: torch.int16}


class _RankRing:
    """One rank's side of the exchange over ``torch.distributed``: its
    block is a stack of one slab, and a hop of h is a send to and a
    receive from the ranks h slabs away at the same model index. Both
    directions of a hop go in one ``batch_isend_irecv``, so no order of
    sends can deadlock. A rank with no neighbour at a hop receives
    nothing and flags those slots invalid, as JAX's ``ppermute`` edge
    does."""

    def __init__(self, mesh: SlabMesh):
        self.mesh = mesh

    def _global(self, slab: int) -> int:
        r = self.mesh.peer(slab)
        g = self.mesh.group
        return r if g is None else dist.get_global_rank(g, r)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh.backend != "nccl" and t.dtype in _WIRE_BITS:
            t = t.view(_WIRE_BITS[t.dtype])
        return t.to(self.mesh.wire).contiguous()

    def _swap(self, h: int, to_left: list, to_right: list):
        """Send ``to_left`` to the slab h to the left and ``to_right`` to
        the one h to the right; returns (what the right one sent left,
        what the left one sent right), each None without that
        neighbour."""
        m = self.mesh
        ops, got = [], {}
        for side, step, send in (("left", -h, to_left),
                                 ("right", h, to_right)):
            if not 0 <= m.slab + step < m.n_slabs:
                continue
            peer = self._global(m.slab + step)
            wire = [self._wire(t) for t in send]
            bufs = [torch.empty_like(w) for w in wire]
            for tag, (w, buf) in enumerate(zip(wire, bufs)):
                ops.append(dist.P2POp(dist.isend, w, peer, m.group, tag))
                ops.append(dist.P2POp(dist.irecv, buf, peer, m.group, tag))
            got[side] = (bufs, send)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        def back(side):
            if side not in got:
                return None
            bufs, like = got[side]
            return [b.to(m.device).view(t.dtype) for b, t in zip(bufs, like)]

        return back("right"), back("left")

    def bounds(self, my_max0, my_min0, h):
        from_right, from_left = self._swap(h, [my_min0], [my_max0])
        ok = torch.ones(1, dtype=torch.bool, device=my_max0.device)
        left_max, lm_ok = ((from_left[0], ok) if from_left
                           else (torch.zeros_like(my_max0), ~ok))
        right_min, rm_ok = ((from_right[0], ok) if from_right
                            else (torch.zeros_like(my_min0), ~ok))
        return left_max, lm_ok, right_min, rm_ok

    def parcels(self, left, right, h):
        (cl, gl, vl), (cr, gr, vr) = left, right
        # a slot is valid where it carries a gid: sent slots are owned rows
        from_right, from_left = self._swap(
            h, [cl, torch.where(vl, gl, -1)], [cr, torch.where(vr, gr, -1)])

        def parcel(got, like_c, like_g):
            if got is None:
                return (torch.zeros_like(like_c),
                        torch.full_like(like_g, -1),
                        torch.zeros(like_g.shape, dtype=torch.bool,
                                    device=like_g.device))
            return got[0], got[1], got[1] >= 0

        return parcel(from_right, cl, gl), parcel(from_left, cr, gr)


def _pack_mask(coords: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
               capacity: int):
    """Each slab's masked rows, in order, into ``capacity`` slots flagged
    valid: (coords (S, H, n), gids (S, H), sent (S, H), overflow (S,))."""
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    take = order[:, :min(capacity, mask.shape[1])]
    sent = torch.gather(mask, 1, take)
    pc = torch.gather(coords, 1, take[:, :, None].expand(-1, -1,
                                                         coords.shape[2]))
    pg = torch.gather(gids, 1, take)
    short = capacity - take.shape[1]
    if short > 0:   # a capacity past the slab's rows: invalid slots
        pc = torch.cat([pc, pc.new_zeros((pc.shape[0], short, pc.shape[2]))],
                       dim=1)
        pg = torch.cat([pg, pg.new_full((pg.shape[0], short), -1)], dim=1)
        sent = torch.cat([sent, sent.new_zeros((sent.shape[0], short))],
                         dim=1)
    return pc, pg, sent, mask.sum(dim=1) > capacity


def _assemble_candidates(coords: torch.Tensor, gids: torch.Tensor, eps,
                         *, cfg: DistJoinConfig, ring=None):
    """Every slab's candidate block: its own P rows and the k-hop halo.

    ``coords`` (S, P, n) and ``gids`` (S, P) are stacked slabs on one
    device, ``eps`` a 0-d tensor of the points' dtype. For each hop h a
    slab learns the boundary of its h-hop neighbours, selects the points
    each needs (within eps of that boundary along dimension 0) and ships
    the parcel h slabs on. ``ring`` moves the boundaries and parcels: by
    default a shift over all S slabs of one device; ``_RankRing`` sends
    one rank's slab (S = 1) to its neighbours' ranks. The block layout is
    the JAX package's (``make_halo_step``): the local P rows, then for
    each hop the parcel from the right neighbour and the one from the
    left. Returns

        (cand_coords (S, P + 2Hk, n), cand_gids, cand_valid, cand_owned,
         halo_overflow (a 0-d bool, this device's slabs only))

    Invalid parcel slots carry the slab's first row as coordinates and -1
    as gid."""
    ring = _Stacked() if ring is None else ring
    h_cap = cfg.halo_capacity
    owned = gids >= 0
    x0 = coords[:, :, 0]
    big = torch.tensor(torch.finfo(coords.dtype).max / 4, dtype=coords.dtype,
                       device=coords.device)
    my_min0 = torch.where(owned, x0, big).min(dim=1).values
    my_max0 = torch.where(owned, x0, -big).max(dim=1).values
    parcels_c, parcels_g, parcels_v = [], [], []
    overflow = torch.zeros((), dtype=torch.bool, device=coords.device)
    for h in range(1, cfg.k_hops + 1):
        left_max, lm_ok, right_min, rm_ok = ring.bounds(my_max0, my_min0, h)
        left_max = torch.where(lm_ok, left_max, -big)
        right_min = torch.where(rm_ok, right_min, big)
        send_left = owned & (x0 <= (left_max + eps)[:, None])
        send_right = owned & (x0 >= (right_min - eps)[:, None])
        cl, gl, vl, ofl = _pack_mask(coords, gids, send_left, h_cap)
        cr, gr, vr, ofr = _pack_mask(coords, gids, send_right, h_cap)
        # a parcel sent left (slab i -> i - h) is the one slab i - h
        # receives from its right, and the other way round
        (hcl, hgl, hvl), (hcr, hgr, hvr) = ring.parcels(
            (cl, gl, vl), (cr, gr, vr), h)
        parcels_c += [hcl, hcr]
        parcels_g += [hgl, hgr]
        parcels_v += [hvl, hvr]
        overflow = overflow | ofl.any() | ofr.any()
    halo_c = torch.cat(parcels_c, dim=1)
    halo_g = torch.cat(parcels_g, dim=1)
    halo_v = torch.cat(parcels_v, dim=1)
    anchor = coords[:, :1, :]
    cand_c = torch.cat([coords, torch.where(halo_v[:, :, None], halo_c,
                                            anchor)], dim=1)
    cand_g = torch.cat([gids, torch.where(halo_v, halo_g, -1)], dim=1)
    cand_v = torch.cat([owned, halo_v], dim=1)
    cand_o = torch.cat([owned, torch.zeros_like(halo_v)], dim=1)
    return cand_c, cand_g, cand_v, cand_o, overflow


# ---------------------------------------------------------------------------
# Collectives of a rank
# ---------------------------------------------------------------------------

def _is_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``launch.mesh.SlabMesh`` (imported here, so
    that importing the package leaves the launcher to ``python -m``)."""
    from repro_torch.launch.mesh import SlabMesh
    return isinstance(mesh, SlabMesh)


def _all_reduce(mesh: SlabMesh, values, op) -> list:
    """``values`` (Python ints) reduced by ``op`` over every rank."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=mesh.wire)
    dist.all_reduce(t, op=op, group=mesh.group)
    return t.tolist()


def _any(mesh, flag) -> bool:
    """A flag raised on any slab: of this device's, or, on a mesh, of any
    rank's (all-reduced before any rank acts on it)."""
    if _is_mesh(mesh):
        return bool(_all_reduce(mesh, [bool(flag)], dist.ReduceOp.MAX)[0])
    return bool(flag)


def _on_every_rank(mesh, work):
    """``work()``; on a mesh a rank's failure is all-reduced first, so the
    ranks raise together and none waits in a later collective."""
    if not _is_mesh(mesh):
        return work()
    err, out = None, None
    try:
        out = work()
    except Exception as e:       # noqa: BLE001 -- re-raised on every rank
        err = e
    if _any(mesh, err is not None):
        raise err if err is not None else RuntimeError(
            "the slab join failed on another rank")
    return out


def _gather_pairs(mesh: SlabMesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's (K_r, 2) pairs, concatenated in rank order on every
    rank: an all-gather of the sizes, then a padded all-gather."""
    world = mesh.n_slabs * mesh.n_model
    sizes = [torch.zeros(1, dtype=torch.int64, device=mesh.wire)
             for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([local.shape[0]], dtype=torch.int64,
                                        device=mesh.wire), group=mesh.group)
    sizes = [int(s) for s in sizes]
    if max(sizes) == 0:
        return local
    pad = torch.zeros((max(sizes), 2), dtype=torch.int32, device=mesh.wire)
    pad[:local.shape[0]] = local.to(mesh.wire)
    bufs = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(bufs, pad, group=mesh.group)
    return torch.cat([b[:k] for b, k in zip(bufs, sizes)]).to(mesh.device)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def _host_tensor(points) -> torch.Tensor:
    """``points`` as a CPU tensor of a dtype the joins take."""
    t = (points.detach().cpu() if isinstance(points, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(points)))
    check_float_points(t)
    return t


def _placement(mesh, device):
    """(slab count, the device the joins run on, the stacked slabs this
    process holds) of ``mesh``: a slab count runs every slab on ``device``
    in one process; a ``SlabMesh`` its rank's slab on the rank's device."""
    if _is_mesh(mesh):
        if device is not None:
            raise ValueError("a SlabMesh names its rank's device; pass "
                             "device= to make_slab_mesh")
        return mesh.n_slabs, mesh.device, slice(mesh.slab, mesh.slab + 1)
    if isinstance(mesh, bool) or not isinstance(mesh, (int, np.integer)):
        raise TypeError(f"mesh must be a slab count or a SlabMesh, got "
                        f"{type(mesh).__name__}")
    return int(mesh), resolve_device(device), slice(None)


def _slabs(pts: torch.Tensor, n_slabs: int, device: torch.device,
           rows: slice = slice(None)):
    """The host partition and, on ``device``, the slabs ``rows`` of it:
    (coords (S, P, n) host array, gids (S, P) host array, those slabs as
    tensors in the points' dtype and int32). bfloat16 points partition as
    their exact float32 copy."""
    if n_slabs < 1:
        raise ValueError(f"n_slabs must be at least 1, got {n_slabs}")
    host = (pts.float() if pts.dtype == torch.bfloat16 else pts).numpy()
    coords, gids, _ = partition_points_host(host, n_slabs)
    coords_dev = torch.from_numpy(coords[rows]).to(pts.dtype).to(device)
    return coords, gids, coords_dev, torch.from_numpy(gids[rows]).to(device)


def _far_point(pts: torch.Tensor, eps: float) -> torch.Tensor:
    """Coordinates of the invalid candidate slots: far outside the volume,
    computed as the JAX package computes them (``max + eps + 4 max(eps,
    1)``), so that a window reaching the sentinel cell (a top-corner probe
    can alias its key) finds no hit."""
    top = pts.max(dim=0).values.to(geometry_dtype(pts.dtype)).numpy()
    gmax = top + eps
    return torch.from_numpy(np.asarray(gmax + 4.0 * max(float(eps), 1.0)))


def _checked_points(points, eps, metric: str):
    """(points as a CPU tensor, eps as a float) after the metric gate and
    the slab join's refusals (``distributed_self_join``'s docstring). The
    shape is read first, so a refusal copies no points."""
    points, eps = _canonicalize_for_slabs(points, eps, metric)
    npts, n = (tuple(points.shape) if hasattr(points, "shape")
               else np.shape(points))
    if n >= NP_PAD:
        raise ValueError(
            f"distributed pairs need a free global-id pad lane: n_dims={n} "
            f">= NP_PAD={NP_PAD}")
    if npts >= 1 << 24:
        raise ValueError(
            f"distributed pairs carry global ids in a float pad lane, "
            f"exact only below 2^24: npts={npts}")
    pts = _host_tensor(points)
    limit = GID_EXACT_POINTS.get(pts.dtype)
    if limit is not None and npts > limit:
        raise ValueError(
            f"distributed pairs carry global ids in a {pts.dtype} pad lane, "
            f"which holds ids exactly only up to {limit - 1}: npts={npts} > "
            f"{limit} (ROADMAP §C, C3: the JAX package loses pairs there); "
            f"join these points at float32")
    return pts, float(eps)


@dataclasses.dataclass(frozen=True)
class SlabIndex:
    """One slab's grid in the slab join and what its launches need."""
    slab: int
    index: GridIndex         # over the slab's points and its halo
    ids: torch.Tensor        # (rows,) int32 global id of each sorted row
    row_ok: np.ndarray       # (rows,) bool: the sorted rows the slab owns


def _exchange(coords, gids, coords_dev, gids_dev, eps: float, cfg, mins,
              maxs, mesh):
    """The halo exchange of the held slabs; raises on an overflow of any
    slab (on a mesh, on every rank together)."""
    ring = _RankRing(mesh) if _is_mesh(mesh) else None
    cand = _assemble_candidates(
        coords_dev, gids_dev,
        metric_lib.scalar_as(eps, coords_dev.dtype, coords_dev.device),
        cfg=cfg, ring=ring)
    if _any(mesh, cand[4]):
        raise _halo_overflow_error(
            cfg.halo_capacity,
            halo_capacity_plan(coords, gids, mins, maxs, eps, cfg.k_hops))
    return cand[:4]


def _held_blocks(pts: torch.Tensor, eps: float, mesh, halo_capacity,
                 device):
    """Partition and halo exchange: (the slab ids held here, the device,
    the held slabs' candidate blocks (cand_c, cand_g, cand_v, cand_o),
    stacked). Raises on a halo overflow."""
    n_slabs, dev, rows = _placement(mesh, device)
    with record_function("slab_join.partition"):
        coords, gids, coords_dev, gids_dev = _slabs(pts, n_slabs, dev, rows)
        mins, maxs = slab_extents(coords, gids)
        k_hops = halo_reach(mins, maxs, eps)
        h_need = exact_halo_capacity(coords, gids, mins, maxs, eps, k_hops)
    cfg = DistJoinConfig(
        pts_per_device=coords.shape[1], n_dims=pts.shape[1],
        halo_capacity=(min(_next_pow2(h_need), coords.shape[1])
                       if halo_capacity is None else int(halo_capacity)),
        max_per_cell=0, k_hops=k_hops)
    with record_function("slab_join.exchange"):
        blocks = _exchange(coords, gids, coords_dev, gids_dev, eps, cfg,
                           mins, maxs, mesh)
    return range(n_slabs)[rows], dev, blocks


def candidate_blocks(points, eps, mesh, *,
                     halo_capacity: Optional[int] = None,
                     metric: str = "l2", device=None):
    """The held slabs' candidate blocks after the halo exchange, as the
    joins build their grids from them: ``(coords (S, P + 2Hk, n), gids,
    valid, owned)`` with JAX's layout (``make_halo_step``); S is every slab
    for a slab count, 1 on a ``SlabMesh`` (the rank's slab). The
    arguments are ``distributed_self_join``'s."""
    pts, eps = _checked_points(points, eps, metric)
    return _held_blocks(pts, eps, mesh, halo_capacity, device)[2]


def slab_indexes(points, eps, mesh, *, halo_capacity: Optional[int] = None,
                 metric: str = "l2", device=None):
    """The slab join up to its per-slab joins: partition, halo exchange and
    the slabs' grids against the global geometry. ``mesh`` is a slab count
    (every slab in this process, on ``device``) or a ``SlabMesh`` (this
    rank's slab, exchanged with the other ranks'). Yields a ``SlabIndex``
    for each held slab that owns a point; raises on a halo overflow
    before the first. The arguments are ``distributed_self_join``'s. The
    stages run in profiler spans: ``slab_join.partition`` (the host
    partition and plan, the slabs' copy to the device),
    ``slab_join.exchange`` and, per slab, ``self_join.grid``."""
    pts, eps = _checked_points(points, eps, metric)
    _placement(mesh, device)
    if pts.shape[0] == 0:
        return
    held, dev, (cand_c, cand_g, cand_v, cand_o) = _held_blocks(
        pts, eps, mesh, halo_capacity, device)
    # the global geometry, as build_grid derives it: cell coordinates (and
    # the UNICOMP ownership of cell pairs) agree across slabs and with the
    # one-process join
    gmin, dims = points_geometry(pts, eps)
    slab_kd = device_key_dtype(dims, padded=True)
    far = _far_point(pts, eps).to(pts.dtype).to(dev)
    for k, slab in enumerate(held):
        with record_function("self_join.grid"):
            v = cand_v[k]
            o = cand_o[k] & v
            if not bool(o.any()):
                continue
            cc = torch.where(v[:, None], cand_c[k], far)
            index = build_grid_with_geometry(cc, eps, gmin, dims, v,
                                             key_dtype=slab_kd)
            order = index.order.long()
            held_slab = SlabIndex(slab, index, cand_g[k][order],
                                  o[order].cpu().numpy())
        yield held_slab


def distributed_self_join(points, eps, mesh, *, unicomp: bool = True,
                          merge_last_dim: Optional[bool] = None,
                          bucketed: Optional[bool] = None,
                          sort_result: bool = True,
                          halo_capacity: Optional[int] = None,
                          return_pairs: bool = True, metric: str = "l2",
                          device=None):
    """The slab join's pairs: equal-count slabs along dimension 0, their
    eps-halo exchanged, each slab joined by the fused kernel over the rows
    it owns with global ids in the kernel's masks (B1 (d)).

    ``mesh`` is JAX's: a slab count runs every slab in this process on
    ``device`` (CUDA by default; ``device="cpu"`` runs the plain
    versions); a ``launch.mesh.SlabMesh`` runs SPMD, each rank calling
    with the same points, exchanging the halo with its neighbours' ranks
    and joining its own slab on its device (ranks of model index > 0 hold
    their slab and join nothing). The pairs are then gathered, and every
    rank returns the same result.

    Returns the (K, 2) int32 ordered pairs of global ids, equal to
    ``self_join(distance_impl="fused")``'s after the ``sort_result``
    lexicographic sort; ``return_pairs=False`` runs the count-only
    launches and returns the ordered-pair total (summed over the ranks).
    ``metric="cosine"`` joins unit rows of raw embeddings (``eps`` a
    minimum similarity); jaccard raises ``NotImplementedError``.

    ``halo_capacity`` defaults to the exact need (``exact_halo_capacity``)
    rounded up to a power of two and capped at the slab size; a smaller one
    raises on overflow instead of dropping candidates.

    Refused: ``n_dims >= NP_PAD`` (no free lane for the ids), ``npts >=
    2^24`` (ids past float32's exact integers), and float16 / bfloat16
    points whose largest id the dtype does not hold exactly (more than
    2,049 / 257 points; ROADMAP §C, C3).
    """
    pts, eps = _checked_points(points, eps, metric)
    _, dev, _ = _placement(mesh, device)
    npts, n = pts.shape
    # the merged sweep rides the last-dimension cell coordinate too: two
    # free lanes, or the per-cell sweep
    merged = resolve_merge_last_dim(n, merge_last_dim, extra_lanes=1)
    joins = not _is_mesh(mesh) or mesh.model == 0

    def local():
        chunks, total = [], 0
        for s in slab_indexes(pts, eps, mesh, halo_capacity=halo_capacity,
                              device=device):
            if not joins:
                continue
            if return_pairs:
                chunks.append(_self_join_fused(
                    s.index, unicomp=unicomp, sort_result=False,
                    bucketed=bucketed, merged=merged, row_ok=s.row_ok,
                    ids=s.ids, gid_pairs=True))
            else:
                total += _self_join_count_fused(
                    s.index, unicomp=unicomp, bucketed=bucketed,
                    merged=merged, row_ok=s.row_ok, ids=s.ids,
                    gid_pairs=True).total_pairs
        return chunks, total

    chunks, total = _on_every_rank(mesh, local)
    if not return_pairs:
        if _is_mesh(mesh):
            total = _all_reduce(mesh, [total], dist.ReduceOp.SUM)[0]
        return total
    with record_function("self_join.emit"):
        out = (torch.cat(chunks, dim=0) if chunks
               else torch.empty((0, 2), dtype=torch.int32, device=dev))
        if _is_mesh(mesh):
            out = _gather_pairs(mesh, out)
        return sort_pairs(out, npts) if sort_result else out


# ---------------------------------------------------------------------------
# The plain offset-sweep count, with the offset-parallel model axis
# ---------------------------------------------------------------------------

def _offset_block(n: int, unicomp: bool, n_model: int = 1, model: int = 0,
                  model_axis: Optional[str] = "model"):
    """The stencil offsets a model index sweeps, with their is-zero flags.
    The JAX package pads the table to a multiple of ``n_model`` (zero
    rows flagged invalid) and shards it over the model axis, each index
    a contiguous block; the padding rows count nothing, so they are left
    out. Without a model axis model index 0 sweeps every offset and the
    others none (their totals would repeat it)."""
    offs = stencil_offsets(n, unicomp)
    zero = np.all(offs == 0, axis=1)
    if model_axis is None:
        keep = slice(None) if model == 0 else slice(0)
    else:
        per = -(-offs.shape[0] // n_model)
        keep = slice(model * per, (model + 1) * per)
    return offs[keep], zero[keep]


def _count_block(cand_c, cand_g, cand_v, cand_o, eps: float, gmin, dims,
                 cfg: DistJoinConfig, offs, zero):
    """One slab's ordered-pair total over ``offs`` by the plain sweep: per
    offset the (rows, C, n) candidate gather and refine of the unfused
    sweep, masked to valid candidates, owned queries and the global-id
    order. Returns (total, a 0-d int64 tensor; the cell overflow: a cell
    holds more than C points, and then nothing is swept)."""
    dev = cand_c.device
    total = torch.zeros((), dtype=torch.int64, device=dev)
    if not bool(cand_o.any()):
        return total, False
    index = build_grid_with_geometry(cand_c, eps, gmin, dims, cand_v,
                                     key_dtype=np.dtype(cfg.key_dtype))
    if int(index.max_per_cell) > cfg.max_per_cell:
        return total, True
    order = index.order.long()
    valid_sorted = cand_v[order]
    owned_sorted = cand_o[order]
    gid_sorted = cand_g[order]
    deltas = (offs @ row_major_strides(dims)).tolist()
    for delta, is_zero in zip(deltas, zero.tolist()):
        nbr = _neighbor_ranks_for_delta(index, delta)
        q, cand, cand_pos, vmask, q_pos, _ = _gather_batch(
            index, nbr, 0, index.num_points, cfg.max_per_cell)
        cand_pos, q_pos = cand_pos.long(), q_pos.long()
        hits = _distance_hits_jnp(q, cand, vmask, index.eps)
        hits = hits & valid_sorted[cand_pos] & owned_sorted[q_pos][:, None]
        gq = gid_sorted[q_pos][:, None]
        gc = gid_sorted[cand_pos]
        if cfg.unicomp:
            # every UNICOMP hit is one unordered pair, two ordered ones
            hits = hits & ((gc > gq) if is_zero else (gc != gq))
            total += 2 * hits.sum(dtype=torch.int64)
        else:
            total += (hits & (gc != gq)).sum(dtype=torch.int64)
    return total, False


def _mesh_geometry(mesh: SlabMesh, coords: torch.Tensor, gids: torch.Tensor,
                   eps: float):
    """``points_geometry`` of the points of every rank's slab: the owned
    rows' per-dimension extremes, all-reduced (exactly, in float64)."""
    owned = (gids >= 0)[:, None]
    x = coords.to(torch.float64)
    ext = torch.stack([torch.where(owned, x, torch.inf).min(dim=0).values,
                       torch.where(owned, x, -torch.inf).max(dim=0).values])
    ext = ext.to(mesh.wire)
    lo, hi = ext[0].clone(), ext[1].clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    ext = torch.stack([lo, hi]).cpu().to(geometry_dtype(coords.dtype))
    return host_grid_geometry(ext.numpy(), float(eps))


def make_halo_step(mesh: SlabMesh, cfg: DistJoinConfig):
    """The halo step of a rank (JAX's ``make_halo_step``): ``step(coords,
    gids, eps)`` takes the rank's slab rows, (P, n) and (P,), and returns
    its candidate block ``(coords (P + 2Hk, n), gids, valid, owned)`` on
    the rank's device, and the halo-overflow flag all-reduced over every
    rank."""
    ring = _RankRing(mesh)

    def step(coords, gids, eps):
        c = torch.as_tensor(coords).to(mesh.device)[None]
        g = torch.as_tensor(gids).to(mesh.device)[None]
        cand_c, cand_g, cand_v, cand_o, halo_of = _assemble_candidates(
            c, g, metric_lib.scalar_as(eps, c.dtype, mesh.device), cfg=cfg,
            ring=ring)
        return (cand_c[0], cand_g[0], cand_v[0], cand_o[0],
                _any(mesh, halo_of))

    return step


def make_distributed_count_step(mesh: SlabMesh, cfg: DistJoinConfig):
    """The count step of a rank (JAX's ``make_distributed_count_step``):
    ``step(coords, gids, eps)`` takes the rank's slab rows and returns
    ``(ordered-pair total, halo_overflow, cell_overflow)``, the total
    summed and the flags maxed over every rank (JAX's ``psum`` /
    ``pmax`` over ``(slab, model)``). With ``cfg.model_axis`` the rank
    sweeps the block of the stencil offsets of its model index."""
    halo = make_halo_step(mesh, cfg)
    offs, zero = _offset_block(cfg.n_dims, cfg.unicomp, mesh.n_model,
                               mesh.model, cfg.model_axis)

    def step(coords, gids, eps):
        coords = torch.as_tensor(coords).to(mesh.device)
        gids = torch.as_tensor(gids).to(mesh.device)
        cand_c, cand_g, cand_v, cand_o, halo_of = halo(coords, gids, eps)
        gmin, dims = _mesh_geometry(mesh, coords, gids, eps)
        total, cell_of = _count_block(cand_c, cand_g, cand_v, cand_o,
                                      float(eps), gmin, dims, cfg, offs,
                                      zero)
        total, = _all_reduce(mesh, [total], dist.ReduceOp.SUM)
        cell_of, = _all_reduce(mesh, [cell_of], dist.ReduceOp.MAX)
        return total, halo_of, bool(cell_of)

    return step


def distributed_self_join_count(points, eps, mesh, *,
                                unicomp: bool = True,
                                halo_capacity: Optional[int] = None,
                                max_per_cell: Optional[int] = None,
                                model_axis: Optional[str] = None,
                                metric: str = "l2", device=None) -> int:
    """The slab join's ordered-pair total by the plain offset sweep (the
    JAX package's ``make_distributed_count_step``): per slab and stencil
    offset, the (rows, C, n) candidate gather and refine of the unfused
    sweep, masked to valid candidates, owned queries and the global-id
    order. ``mesh`` is ``distributed_self_join``'s. On a ``SlabMesh``,
    ``model_axis="model"`` shards the stencil offsets over the model
    index (JAX's offset-parallel axis); the total is summed over every
    rank, which all return it. ``model_axis`` with a slab count or a
    mesh of one model index raises ``ValueError``. ``halo_capacity``
    defaults to a whole slab, ``max_per_cell`` (the window C) to the
    global grid's. Raises on a halo overflow and when a slab's cell holds
    more than ``max_per_cell`` points (on every rank together). ``metric``
    is ``distributed_self_join``'s."""
    if model_axis is not None and (
            model_axis != "model" or not _is_mesh(mesh)
            or mesh.n_model == 1):
        raise ValueError(
            f"model_axis={model_axis!r} shards the offsets over the model "
            f"index of a SlabMesh with n_model > 1 (model_axis='model'); "
            f"got mesh {mesh!r}")
    points, eps = _canonicalize_for_slabs(points, eps, metric)
    pts = _host_tensor(points)
    n_slabs, dev, rows = _placement(mesh, device)
    npts, n = pts.shape
    if npts == 0:
        return 0
    eps = float(eps)
    coords, gids, coords_dev, gids_dev = _slabs(pts, n_slabs, dev, rows)
    mins, maxs = slab_extents(coords, gids)
    k_hops = halo_reach(mins, maxs, eps)
    if halo_capacity is None:
        halo_capacity = coords.shape[1]          # the worst case: a slab
    if max_per_cell is None:
        max_per_cell = int(build_grid(pts, eps, device=dev).max_per_cell)
    gmin, dims = points_geometry(pts, eps)
    cfg = DistJoinConfig(
        pts_per_device=coords.shape[1], n_dims=n,
        halo_capacity=int(halo_capacity),
        max_per_cell=max(8, -(-int(max_per_cell) // 8) * 8), k_hops=k_hops,
        key_dtype=device_key_dtype(dims, padded=True).name, unicomp=unicomp,
        model_axis=model_axis)
    if _is_mesh(mesh):
        step = make_distributed_count_step(mesh, cfg)
        total, halo_of, cell_of = step(coords_dev[0], gids_dev[0], eps)
        if halo_of:
            raise _halo_overflow_error(
                cfg.halo_capacity,
                halo_capacity_plan(coords, gids, mins, maxs, eps, k_hops))
        if cell_of:
            raise RuntimeError("max_per_cell overflow")
        return total
    cand_c, cand_g, cand_v, cand_o = _exchange(
        coords, gids, coords_dev, gids_dev, eps, cfg, mins, maxs, mesh)
    offs, zero = _offset_block(n, unicomp)
    total = 0
    for k in range(n_slabs):
        part, cell_of = _count_block(cand_c[k], cand_g[k], cand_v[k],
                                     cand_o[k], eps, gmin, dims, cfg, offs,
                                     zero)
        if cell_of:
            raise RuntimeError("max_per_cell overflow")
        total += int(part)
    return total
