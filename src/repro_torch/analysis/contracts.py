"""Contract prover for the bounded-search invariants (DESIGN.md S9).

The counterpart of ``repro.analysis.contracts`` over the port's
``GridIndex`` and planners. Every capacity and shape bound kernel B1
relies on is re-derived here from first principles -- coordinate-space
stencil enumeration over the decoded cell keys, brute-force boolean-mask
parcel counts, binary search over ``cell_start`` -- with algorithms
deliberately DIFFERENT from the planners in ``core.grid`` and
``core.distributed`` (linear-key arithmetic, searchsorted on the device).
A planner bug that undercounts a capacity therefore cannot hide: the
prover's exact bound exceeds the planner's and a finding is emitted.

Contracts proved per index (host-side numpy, no kernel launches; an index
on the card is copied to the host once per field):

  C1 cap-coverage      every cell's worst-case (merged) window fits the
                       capacity class its query rows are bucketed into,
                       and the global cap dominates all cells
  C2 plan-partition    the occupancy plan is a true partition: each row
                       in exactly one bucket, caps ascending and aligned
  C3 external-cap      ``external_range_cap`` dominates every window an
                       external query can form (any integer base key)
  C4 key-sentinel      the pad sentinel can never alias a real cell key
                       (and the key dtype matches ``key_dtype_for``)
  C5 slot-base-range   the kernel's int32 per-tile exclusive scan and
                       per-row counts cannot overflow at any (class, tile)
                       the plan can launch
  C6 smem-budget       re-based for the H100: each (class, tile) launch's
                       dynamic shared memory per block, re-derived from the
                       layouts of ``csrc/fused_join.cu``, fits the opt-in
                       limit, and the wrapper's mirrors of it
                       (``fused_join.self_stage_bytes``, ``shared_bytes``)
                       agree (the JAX package's C6 is a TPU VMEM budget)
  C9 device-sentinel   the device planners' probe headroom: every probe key
                       (up to 2 above the largest real key) and a padded
                       build's out-of-set sentinel cell stay strictly below
                       the dtype-max padding sentinel
  C10 run-partition    every cell-run plan the fused drivers can launch is
                       a true partition of its rows into per-tile runs of
                       ONE cell each

plus, for a slab partition (C7/C8): k-hop halo reach covers every
eps-close slab pair, and ``exact_halo_capacity`` covers the brute-force
parcel counts.

Findings carry the JAX package's keys for every contract but C6, so the
two provers compare key for key on the same points.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.findings import SEV_WARNING, Finding
# C6's limit: the H100's opt-in shared memory a block, defined beside the
# roofline's other H100 constants (JAX's prover imports its VMEM budget
# from its roofline the same way)
from repro_torch.launch.roofline import SMEM_OPTIN_H100

_AN = "contracts"



def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def key_dtype(index) -> np.dtype:
    """The index's cell-key dtype as numpy names it."""
    from repro_torch.core.grid import _NUMPY_DTYPES

    return _NUMPY_DTYPES[index.cell_keys.dtype]


# ---------------------------------------------------------------------------
# independent re-derivations
# ---------------------------------------------------------------------------

def recompute_cell_caps(index, merged: bool) -> np.ndarray:
    """Exact per-cell worst-case window length, derived in COORDINATE
    space: decode every present cell key to its multi-index
    (``np.unravel_index``), enumerate the stencil as coordinate offsets,
    and drop any neighbour that leaves the grid box -- the arithmetic
    ``grid.cell_window_caps`` does in linear-key space (where an off-grid
    probe can alias a real cell across a row boundary and only ever
    OVERcounts). The planner's caps must dominate these."""
    dims = _host(index.dims).astype(np.int64)
    n = dims.size
    ncells = int(index.num_cells)
    if ncells == 0:
        return np.zeros(0, np.int64)
    keys = _host(index.cell_keys[:ncells]).astype(np.int64)
    counts = _host(index.cell_count[:ncells]).astype(np.int64)
    coords = np.stack(np.unravel_index(keys, dims), axis=1)   # (ncells, n)
    starts = np.concatenate(
        [_host(index.cell_start[:ncells]),
         [int(index.num_points)]]).astype(np.int64)
    caps = np.zeros(ncells, np.int64)
    if not merged:
        for off in itertools.product((-1, 0, 1), repeat=n):
            tgt = coords + np.asarray(off, np.int64)
            ok = np.all((tgt >= 0) & (tgt < dims), axis=1)
            tkey = np.ravel_multi_index(
                np.clip(tgt, 0, dims - 1).T, dims)
            pos = np.minimum(np.searchsorted(keys, tkey), ncells - 1)
            live = ok & (keys[pos] == tkey)
            caps = np.maximum(caps, np.where(live, counts[pos], 0))
        return caps
    dim_last = int(dims[-1])
    for off in itertools.product((-1, 0, 1), repeat=max(n - 1, 0)):
        base = coords.copy()
        if n > 1:
            base[:, : n - 1] += np.asarray(off, np.int64)
            ok = np.all((base[:, : n - 1] >= 0)
                        & (base[:, : n - 1] < dims[: n - 1]), axis=1)
        else:
            ok = np.ones(ncells, bool)
        lo = base.copy()
        hi = base.copy()
        lo[:, -1] = np.maximum(lo[:, -1] - 1, 0)
        hi[:, -1] = np.minimum(hi[:, -1] + 1, dim_last - 1)
        lo_key = np.ravel_multi_index(np.clip(lo, 0, dims - 1).T, dims)
        hi_key = np.ravel_multi_index(np.clip(hi, 0, dims - 1).T, dims)
        lo_rank = np.searchsorted(keys, lo_key, side="left")
        hi_rank = np.searchsorted(keys, hi_key, side="right")
        span = starts[hi_rank] - starts[lo_rank]
        caps = np.maximum(caps, np.where(ok & (hi_rank > lo_rank), span, 0))
    return caps


def recompute_external_cap(index) -> int:
    """Exact maximum window ANY external query base key can form.

    A window spans keys [b-1, b+1] for an arbitrary integer base b; a
    nonempty window's smallest present key k lies in that range, so
    b in {k-1, k, k+1} anchored at each present key k enumerates every
    distinct nonempty window. Brute force over those 3*ncells bases."""
    ncells = int(index.num_cells)
    if ncells == 0:
        return 0
    keys = _host(index.cell_keys[:ncells]).astype(np.int64)
    starts = np.concatenate(
        [_host(index.cell_start[:ncells]),
         [int(index.num_points)]]).astype(np.int64)
    best = 0
    for shift in (-1, 0, 1):
        base = keys + shift
        lo_rank = np.searchsorted(keys, base - 1, side="left")
        hi_rank = np.searchsorted(keys, base + 1, side="right")
        span = starts[hi_rank] - starts[lo_rank]
        if span.size:
            best = max(best, int(span.max()))
    return best


# ---------------------------------------------------------------------------
# per-index contracts
# ---------------------------------------------------------------------------

def _plan_cell_caps(index, plan) -> np.ndarray:
    """Per-cell capacity the plan actually grants: the cap of the class
    each cell's rows land in (the least over the cell's rows when tampering
    split a cell -- the prover must still catch it; -1 for a row no class
    holds)."""
    npts = int(index.num_points)
    rank = _host(index.point_cell_rank).astype(np.int64)
    ncells = int(index.num_cells)
    granted = np.full(npts, -1, np.int64)
    for cap, sel in zip(plan.caps, plan.sel):
        rows = np.arange(npts) if sel is None else np.asarray(sel)
        granted[rows] = cap
    # far above any real capacity (not a key sentinel)
    cell_granted = np.full(ncells, 1 << 62, np.int64)
    np.minimum.at(cell_granted, rank, granted)
    return cell_granted


def check_window_caps(index, *, merged: bool, plan=None,
                      tag: str = "index") -> list:
    """C1 + C2: plan/cap coverage of the exact worst-case windows."""
    from repro_torch.core.grid import (CAP_ALIGN, cell_window_caps,
                                       global_window_cap, occupancy_plan)

    out = []
    site = f"{tag}:merged={merged}"
    exact = recompute_cell_caps(index, merged)
    planner = np.asarray(cell_window_caps(index, merged=merged), np.int64)
    if exact.size and np.any(planner < exact):
        i = int(np.argmax(exact - planner))
        out.append(Finding(_AN, "cap-coverage", site,
                           f"cell_window_caps undercounts cell {i}: planner "
                           f"{int(planner[i])} < exact {int(exact[i])}"))
    cap_global = int(global_window_cap(index, merged=merged))
    if exact.size and cap_global < int(exact.max()):
        out.append(Finding(_AN, "cap-coverage", site + ":global",
                           f"global_window_cap {cap_global} < exact max "
                           f"window {int(exact.max())}"))
    if plan is None:
        plan = occupancy_plan(index, merged=merged)
    # C2: partition + ladder shape
    npts = int(index.num_points)
    covered = np.zeros(npts, np.int64)
    for sel in plan.sel:
        if sel is None:
            covered += 1
        else:
            np.add.at(covered, np.asarray(sel), 1)
    if npts and not np.all(covered == 1):
        bad = int(np.flatnonzero(covered != 1)[0])
        out.append(Finding(_AN, "plan-partition", site,
                           f"occupancy plan covers row {bad} "
                           f"{int(covered[bad])} times (want exactly 1)"))
    caps = [int(c) for c in plan.caps]
    if any(c % CAP_ALIGN for c in caps):
        out.append(Finding(_AN, "plan-partition", site + ":align",
                           f"bucket caps {caps} not {CAP_ALIGN}-aligned"))
    if caps != sorted(caps):
        out.append(Finding(_AN, "plan-partition", site + ":order",
                           f"bucket caps {caps} not ascending"))
    if caps and max(caps) > int(plan.cap_global):
        out.append(Finding(_AN, "plan-partition", site + ":ceiling",
                           f"bucket cap {max(caps)} exceeds cap_global "
                           f"{plan.cap_global}"))
    # C1 against the plan: the capacity each cell's rows are GRANTED must
    # dominate that cell's exact worst-case window
    if exact.size:
        granted = _plan_cell_caps(index, plan)
        short = granted < exact
        if np.any(short):
            i = int(np.flatnonzero(short)[0])
            out.append(Finding(
                _AN, "cap-coverage", site + ":bucket",
                f"cell {i} granted capacity {int(granted[i])} < exact "
                f"worst-case window {int(exact[i])}: the fused kernel "
                f"would silently truncate its candidate window"))
    return out


def check_external_cap(index, tag: str = "index") -> list:
    """C3: the serving-path capacity dominates every possible query."""
    from repro_torch.core.grid import external_range_cap

    exact = recompute_external_cap(index)
    cap = int(external_range_cap(index))
    if cap < exact:
        return [Finding(_AN, "external-cap", tag,
                        f"external_range_cap {cap} < exact worst external "
                        f"window {exact}")]
    return []


def check_key_sentinel(index, tag: str = "index") -> list:
    """C4: dtype route + sentinel aliasing, exact python-int arithmetic."""
    from repro_torch.core.grid import key_dtype_for, sentinel_margin

    out = []
    dims = _host(index.dims).astype(np.int64)
    volume = 1
    for d in dims.ravel():
        volume *= int(d)
    want = key_dtype_for(dims)
    have = key_dtype(index)
    if have != want:
        out.append(Finding(_AN, "key-sentinel", f"{tag}:dtype",
                           f"index key dtype {have} != key_dtype_for "
                           f"{want} for volume {volume}"))
    margin = sentinel_margin(dims, have)
    sentinel = margin + volume - 1
    if margin <= 0:
        out.append(Finding(_AN, "key-sentinel", f"{tag}:alias",
                           f"max real key {volume - 1} >= pad sentinel "
                           f"{sentinel}: padding slots alias real cells"))
    elif volume == sentinel:
        out.append(Finding(
            _AN, "key-sentinel", f"{tag}:edge", severity=SEV_WARNING,
            message=f"volume {volume} equals the pad sentinel: a padded "
                    f"build's out-of-grid sentinel cell (key == volume) "
                    f"aliases padding slots"))
    if dims.size and int(dims.min()) < 3:
        out.append(Finding(
            _AN, "key-sentinel", f"{tag}:interior", severity=SEV_WARNING,
            message=f"grid has a dimension with {int(dims.min())} < 3 "
                    f"cells: the interior-coordinate guarantee (probe keys "
                    f"stay in [0, volume)) does not hold for self-join "
                    f"descriptors on this geometry"))
    return out


def check_device_sentinel(index, tag: str = "index") -> list:
    """C9: device-planner probe headroom, exact python-int arithmetic.

    The device build pads B with the dtype-max sentinel; the device
    planners probe up to 2 above the largest real key and a padded build
    stores the out-of-set sentinel cell at key == volume. All of these must
    stay strictly BELOW the padding sentinel, or a probe ranks into the
    padding tail as a false hit: require ``sentinel_margin > 2``
    (``grid.external_range_cap`` raises below it, and
    ``device_key_dtype`` widens padded builds that would violate it)."""
    from repro_torch.core.grid import sentinel_margin

    dims = _host(index.dims).astype(np.int64)
    kd = key_dtype(index)
    margin = sentinel_margin(dims, kd)
    if margin <= 2:
        return [Finding(_AN, "device-sentinel", f"{tag}:margin",
                        f"sentinel margin {margin} <= 2 for key dtype "
                        f"{kd}: a device probe key (up to max real key "
                        f"+ 2) or a padded build's sentinel cell reaches "
                        f"the padding sentinel and aliases padding slots")]
    return []


def _plan_tiles(index, plan, metric: str = "l2") -> dict:
    """The query tile of each class, as the drivers take it for the
    index's device."""
    from repro_torch.kernels import autotune

    return {int(cap): autotune.fused_tile(index.n_dims, int(cap),
                                          backend=index.device.type,
                                          metric=metric)
            for cap in plan.caps}


def _launch_rows(index, sel) -> int:
    return int(index.num_points) if sel is None else int(np.asarray(sel).size)


def check_slot_base(index, *, merged: bool, plan=None, tiles=None,
                    metric: str = "l2", tag: str = "index") -> list:
    """C5: int32 range of the kernel's counts and per-tile scan.

    Per query: count <= n_off * c. Per tile of tq rows: the exclusive
    scan's last base <= (tq - 1) * n_off * c. Both live in int32 inside
    the kernel; prove they cannot wrap for any (class, tile) launch.
    ``metric`` keys the tile lookup (a jaccard row may launch another tq)."""
    from repro_torch.core.grid import occupancy_plan

    out = []
    if plan is None:
        plan = occupancy_plan(index, merged=merged)
    if tiles is None:
        tiles = _plan_tiles(index, plan, metric)
    n = index.n_dims
    n_off = 3 ** (n - 1) if merged else 3 ** n   # full stencil bounds UNICOMP
    lim = 2 ** 31 - 1
    for cap in plan.caps:
        cap = int(cap)
        tq = int(tiles[cap])
        per_query = n_off * cap
        scan_top = (tq - 1) * per_query
        if per_query > lim:
            out.append(Finding(
                _AN, "slot-base-range", f"{tag}:c{cap}",
                f"per-query hit count bound n_off*c = {per_query} "
                f"overflows int32"))
        elif scan_top > lim:
            out.append(Finding(
                _AN, "slot-base-range", f"{tag}:c{cap}:t{tq}",
                f"per-tile slot-base bound (tq-1)*n_off*c = {scan_top} "
                f"overflows the kernel's int32 exclusive scan "
                f"(tq={tq}, n_off={n_off}, c={cap})"))
    return out


def self_smem_need(tq: int, n_real: int, merged: bool, item: int) -> int:
    """Most shared memory a block of ``fused_join_kernel_self`` stages: its
    query rows, at most the tile's tq, each n_real coordinates and the
    merged lane, ``item`` bytes a value (``csrc/fused_join.cu``)."""
    return tq * (n_real + int(merged)) * item


def jaccard_smem_need(tq: int, n_feat: int) -> int:
    """Shared memory of a block of the Jaccard ``fused_join_kernel`` with
    the run loop (the larger of its two modes): tq query records -- the
    n_feat 16-bit words packed into 16-byte vectors (at least one), one
    vector for the size, an odd count in all -- four int tables of tq rows,
    the window stage and the run tables of 2 tq + 2 ints
    (``csrc/fused_join.cu``)."""
    from repro_torch.kernels.fused_join import RUN_STAGE_BYTES

    words = -(-int(n_feat) // 2)                 # 32-bit words
    vectors = max(1, -(-words // 4)) + 1         # + the size's vector
    if vectors % 2 == 0:
        vectors += 1
    return (tq * vectors * 16 + 4 * tq * 4 + RUN_STAGE_BYTES
            + (2 * tq + 2) * 4)


def check_smem(index, *, merged: bool, plan=None, tiles=None,
               metric: str = "l2", n_feat: int = 0,
               limit: int = SMEM_OPTIN_H100, tag: str = "index") -> list:
    """C6: each (class, tile) launch's dynamic shared memory per block
    against the opt-in limit, and the wrapper's mirrors against the .cu
    layouts.

    l2 and cosine self-join launches run ``fused_join_kernel_self``, which
    stages a block's query rows: at most a tile, exactly a tile on a launch
    of ``SPREAD_TILES`` tiles or more. Jaccard launches run
    ``fused_join_kernel`` (records, tables, the run stage). A need past
    ``limit`` cannot launch; a mirror that disagrees with the layout would
    let the wrapper pass a launch the card refuses, or refuse one it
    takes. External l2 launches (B1 (b)) stage nothing."""
    from repro_torch.core.grid import occupancy_plan, round_up
    from repro_torch.kernels.fused_join import (SPREAD_TILES, packed_width,
                                                self_stage_bytes,
                                                shared_bytes)

    out = []
    if plan is None:
        plan = occupancy_plan(index, merged=merged)
    if tiles is None:
        tiles = _plan_tiles(index, plan, metric)
    item = index.points_sorted.element_size()
    for cap, sel in zip(plan.caps, plan.sel):
        cap = int(cap)
        tq = int(tiles[cap])
        site = f"{tag}:c{cap}:t{tq}"
        if metric == "jaccard":
            need = jaccard_smem_need(tq, n_feat)
            mirror = shared_bytes(tq, packed_width(n_feat), True)
            agrees = mirror == need
        else:
            qp = round_up(max(_launch_rows(index, sel), 1), tq)
            need = self_smem_need(tq, index.n_dims, merged, item)
            mirror = self_stage_bytes(qp, tq, cap, index.n_dims, merged,
                                      False, item)
            agrees = mirror <= need and (qp // tq < SPREAD_TILES
                                         or mirror == need)
        if need > limit:
            out.append(Finding(
                _AN, "smem-budget", site,
                f"fused kernel needs {need} B of shared memory a block, "
                f"above the {limit} B a block may opt in to (c={cap}, "
                f"tq={tq}, metric={metric}, n_feat={n_feat}); shrink the "
                f"tile"))
        if not agrees:
            out.append(Finding(
                _AN, "smem-budget", site + ":mirror",
                f"the wrapper's mirror gives {mirror} B where the kernel's "
                f"layout needs {need} B (c={cap}, tq={tq}, "
                f"metric={metric})"))
    return out


def _oracle_cell_of_row(index) -> np.ndarray:
    """Independent A-order row -> cell rank map: derived from the CSR
    ``cell_start`` boundaries by binary search, NOT from the stored
    ``point_cell_rank`` (whose consistency is exactly what C10 proves)."""
    ncells = int(index.num_cells)
    starts = _host(index.cell_start[:ncells]).astype(np.int64)
    rows = np.arange(int(index.num_points), dtype=np.int64)
    return np.searchsorted(starts, rows, side="right") - 1


def _validate_run_ord(run_ord: np.ndarray, cells: np.ndarray, tq: int,
                      site: str) -> list:
    """Core C10 validation of ONE launch's run_ord against the oracle
    per-row cell ids (same length, pad rows already carry their clamped
    row's cell)."""
    out = []
    ro = _host(run_ord).astype(np.int64)
    if tq <= 0 or ro.size % tq:
        return [Finding(_AN, "run-partition", site,
                        f"run plan length {ro.size} is not a multiple of "
                        f"the query tile tq={tq}")]
    o = ro.reshape(-1, tq)
    c = np.asarray(cells).astype(np.int64).reshape(-1, tq)
    if o.size and np.any(o[:, 0] != 0):
        t = int(np.flatnonzero(o[:, 0] != 0)[0])
        out.append(Finding(
            _AN, "run-partition", f"{site}:tile{t}",
            f"run ordinal does not reset at tile {t} start (got "
            f"{int(o[t, 0])}): the kernel's slot phase would leak across "
            f"the tile boundary"))
    d = np.diff(o, axis=1)
    if np.any((d < 0) | (d > 1)):
        t, r = [int(x[0]) for x in np.nonzero((d < 0) | (d > 1))]
        out.append(Finding(
            _AN, "run-partition", f"{site}:tile{t}:row{r + 1}",
            f"run ordinal steps by {int(d[t, r])} at tile {t} row "
            f"{r + 1} (must be 0 or 1): rows would skip or rewind the "
            f"shared window"))
        return out   # step checks below assume sane ordinals
    changed = c[:, 1:] != c[:, :-1]
    merged_runs = (d == 0) & changed
    if np.any(merged_runs):
        t, r = [int(x[0]) for x in np.nonzero(merged_runs)]
        out.append(Finding(
            _AN, "run-partition", f"{site}:tile{t}:row{r + 1}",
            f"rows of cells {int(c[t, r])} and {int(c[t, r + 1])} share "
            f"run {int(o[t, r])} in tile {t}: the second cell's queries "
            f"would be refined against the first cell's window "
            f"(overlapping runs)"))
    split_cell = (d == 1) & ~changed
    if np.any(split_cell):
        t, r = [int(x[0]) for x in np.nonzero(split_cell)]
        out.append(Finding(
            _AN, "run-partition", f"{site}:tile{t}:row{r + 1}",
            severity=SEV_WARNING,
            message=f"cell {int(c[t, r])} is split across runs "
                    f"{int(o[t, r])} and {int(o[t, r + 1])} inside tile "
                    f"{t}: correct but reads a shared window again "
                    f"(run maximality)"))
    return out


def check_run_plan(index, *, merged: bool = True, plan=None, tiles=None,
                   run_ord=None, tq: Optional[int] = None,
                   metric: str = "l2", tag: str = "index") -> list:
    """C10: cell-run plans are exact partitions (DESIGN.md S11).

    Default mode rebuilds every run plan the fused self-join drivers can
    launch -- the whole-range launch or each occupancy bucket's plan --
    through ``grid.cell_run_plan`` on the stored ``point_cell_rank``, then
    validates each against cell ids re-derived INDEPENDENTLY from the CSR
    boundaries (``_oracle_cell_of_row``), so a bug in either the rank array
    or the run planner is caught. ``run_ord``/``tq`` inject one tampered
    plan through the seam the mutation check uses (validated over A-order
    rows, pad rows clamped to the last row -- the drivers' padding
    convention)."""
    from repro_torch.core.grid import cell_run_plan, occupancy_plan, round_up

    npts = int(index.num_points)
    if npts == 0:
        return []
    oracle = _oracle_cell_of_row(index)
    if run_ord is not None:
        if tq is None:
            raise ValueError("check_run_plan(run_ord=...) needs tq")
        pos = np.minimum(np.arange(np.asarray(_host(run_ord)).size),
                         npts - 1)
        return _validate_run_ord(run_ord, oracle[pos], int(tq),
                                 f"{tag}:injected")
    rank = _host(index.point_cell_rank).astype(np.int64)
    if plan is None:
        plan = occupancy_plan(index, merged=merged)
    if tiles is None:
        tiles = _plan_tiles(index, plan, metric)
    out = []
    for cap, sel in zip(plan.caps, plan.sel):
        t = int(tiles[int(cap)])
        if sel is None:
            qp = round_up(npts, t)
            pos = np.minimum(np.arange(qp), npts - 1)
            site = f"{tag}:merged={merged}:all:c{int(cap)}"
        else:
            sel = np.asarray(sel)
            if not sel.size:
                continue
            qp = round_up(sel.size, t)
            pos = np.zeros(qp, np.int64)
            pos[: sel.size] = sel   # pad rows group with row 0's cell,
            pos[sel.size:] = 0      # matching the driver (their windows
                                    # are zeroed, so the grouping is inert)
            site = f"{tag}:merged={merged}:bucket:c{int(cap)}"
        ro = cell_run_plan(torch.from_numpy(rank[pos]), t).run_ord
        out += _validate_run_ord(ro, oracle[pos], t, site)
    return out


def prove_index_contracts(index, *, merged: Optional[bool] = None,
                          plan=None, tiles=None, metric: str = "l2",
                          n_feat: int = 0, tag: str = "index") -> list:
    """All per-index contracts (C1-C6, C9, C10). ``merged=None`` proves both
    sweep modes; ``plan``/``tiles`` override the planner outputs (the
    mutation check injects tampered plans through exactly this seam).
    ``metric``/``n_feat`` describe the refine layout the index serves: they
    key the tile lookups and pick C6's kernel. A jaccard index never runs a
    merged sweep, so its merged-mode proof is skipped."""
    modes = (False, True) if merged is None else (bool(merged),)
    if metric == "jaccard":
        modes = tuple(m for m in modes if not m) or (False,)
    out = check_key_sentinel(index, tag)
    out += check_device_sentinel(index, tag)
    out += check_external_cap(index, tag)
    for m in modes:
        out += check_window_caps(index, merged=m, plan=plan, tag=tag)
        out += check_slot_base(index, merged=m, plan=plan, tiles=tiles,
                               metric=metric, tag=tag)
        out += check_smem(index, merged=m, plan=plan, tiles=tiles,
                          metric=metric, n_feat=n_feat, tag=tag)
        out += check_run_plan(index, merged=m, plan=plan, tiles=tiles,
                              metric=metric, tag=tag)
    return out


# ---------------------------------------------------------------------------
# halo contracts (C7/C8)
# ---------------------------------------------------------------------------

def prove_halo_contracts(points: np.ndarray, eps: float, n_slabs: int,
                         *, k_hops: Optional[int] = None,
                         halo_capacity: Optional[int] = None,
                         tag: str = "halo") -> list:
    """C7 reach + C8 parcel coverage for a slab partition.

    Parcels are recounted with direct boolean masks over each slab's
    owned dim-0 coordinates (the planner uses searchsorted over the
    sorted slab); ``exact_halo_capacity`` must dominate every parcel,
    and a user-supplied ``halo_capacity`` must dominate the plan."""
    from repro_torch.core.distributed import (exact_halo_capacity,
                                              halo_capacity_plan, halo_reach,
                                              partition_points_host,
                                              slab_extents)

    out = []
    pts = np.asarray(points)
    if pts.shape[0] == 0:
        return out
    coords, gids, _ = partition_points_host(pts, n_slabs)
    mins, maxs = slab_extents(coords, gids)
    k_auto = halo_reach(mins, maxs, eps)
    if k_hops is None:
        k_hops = k_auto
    # C7: every eps-close slab pair within k hops
    for i in range(n_slabs):
        if not np.isfinite(maxs[i]):
            continue
        for j in range(i + 1, n_slabs):
            if not np.isfinite(mins[j]):
                continue
            if mins[j] <= maxs[i] + eps and j - i > k_hops:
                out.append(Finding(
                    _AN, "halo-reach", f"{tag}:{i}->{j}",
                    f"slabs {i} and {j} are eps-close along dim 0 "
                    f"(gap {mins[j] - maxs[i]:.4g} <= eps {eps}) but "
                    f"{j - i} hops > k_hops {k_hops}: their pairs are "
                    f"silently dropped"))
    # C8: brute-force parcel recount vs the searchsorted plan
    plan = halo_capacity_plan(coords, gids, mins, maxs, eps, k_hops)
    cap_exact = exact_halo_capacity(coords, gids, mins, maxs, eps, k_hops)
    for j in range(n_slabs):
        own = gids[j] >= 0
        x0 = coords[j, own, 0]
        if not x0.size:
            continue
        for h in range(1, k_hops + 1):
            checks = []
            if j - h >= 0 and np.isfinite(maxs[j - h]):
                checks.append((-1, int((x0 <= maxs[j - h] + eps).sum())))
            if j + h < n_slabs and np.isfinite(mins[j + h]):
                checks.append((+1, int((x0 >= mins[j + h] - eps).sum())))
            for direction, need in checks:
                if need > cap_exact:
                    out.append(Finding(
                        _AN, "halo-parcel", f"{tag}:{j}:{h}:{direction:+d}",
                        f"parcel slab {j} -> {j + direction * h} needs "
                        f"{need} rows > exact_halo_capacity {cap_exact}"))
    if halo_capacity is not None and plan:
        worst = max(plan, key=lambda p: p.need)
        if halo_capacity < worst.need:
            out.append(Finding(
                _AN, "halo-parcel", f"{tag}:capacity",
                f"halo_capacity {halo_capacity} < required {worst.need} "
                f"(worst parcel: slab {worst.slab} -> "
                f"{worst.slab + worst.direction * worst.hop}, hop "
                f"{worst.hop}); pass halo_capacity >= {worst.need}"))
    return out
