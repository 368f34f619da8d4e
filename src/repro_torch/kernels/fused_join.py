"""Fused gather-refine sweep of the self-join: CUDA kernel and plain version.

One launch sweeps every stencil offset for a batch of query rows. Per
(offset, row) the candidate window is a contiguous span of the padded,
grid-sorted points, described by ``win_start`` / ``win_count``; each slot is
refined by the metric's predicate (``core.metric.plane_refine_hits``: the L2
distance against epsilon for l2 and cosine, the bitmap popcount against the
threshold t for jaccard) and masked (window length, merged last-dimension
boundary, then the UNICOMP triangle, the self pair, or nothing for external
queries, which are not points of the index; with ``gid_pairs`` the
UNICOMP and self masks compare global point ids riding a pad lane instead
of sorted positions, as the slab join needs). The launch returns

    hits      (n_off, Q_pad, C) int8  -- masked epsilon hits
    counts    (Q_pad,)          int32 -- per-row hits over all offsets
    slot_base (Q_pad,)          int32 -- exclusive scan of counts per tile

so the emit scatters pairs without computing a distance again.

Two implementations of the same function live here:

  * ``_fused_join_hits_cuda`` launches ``csrc/fused_join.cu`` (the port of
    the JAX package's Pallas kernel ``_fused_kernel``) on CUDA tensors;
  * ``_fused_join_hits_reference`` is the plain PyTorch version, the
    counterpart of the JAX package's ``_fused_join_hits_reference``. The CPU
    runs it, and the kernel is held to it bit for bit on the card.

The kernel's Jaccard refine reads the token words packed two to a 32-bit
word (``pack_words``), the plain version the 16-bit words as they ride
the float lanes; the popcounts are the same integers.

``fused_join_hits`` picks by where the tensors lie: the kernel for CUDA
tensors, the plain version for CPU tensors. There is no fallback: a kernel
that fails to build or launch raises.

With ``run_loop`` the kernel takes a cell-run plan (``grid.cell_run_plan``):
rows of one run share their windows, so the Jaccard kernel stages each
run's window once per offset and refines all the run's rows against that
copy; the l2 kernels below accept the plan and do not read it. Every row
still masks with its own descriptors, so the result is the row loop's; the
plain version ignores the plan, as the JAX package's does.

External queries with the l2 refine (B1 (b)) launch a kernel of their own,
``fused_join_kernel_external``: P warps a query row (``external_row_warps``)
so a request's few tiles spread over the card, and the per-tile scan in
the launch's last block of each tile (per-stream arrival counters,
``_tile_arrivals``). It accepts the run plan and does not read it.

Self-join launches with the l2 refine (B1 (a), (c), (d), at every dtype)
launch ``fused_join_kernel_self``: a block stages its query rows in shared
memory (``self_stage_bytes``), a warp takes a chunk of consecutive query
rows, 32 slots of one row a step or, where windows hold at most 16 slots,
SW slots of each of 32 / SW rows, and each lane holds its window slot's
lanes in registers while the rows of a run share the window, so it too
accepts the run plan and does not read it. Launches of few tiles spread a
tile's rows over blocks as B1 (b) does; ``self_layout`` mirrors how it lays
a launch out.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import metric as metric_lib

NP_PAD = 8        # minimum lane padding of the coordinate axis
# the row dtypes of the CUDA kernels (csrc/*.cu number them alike)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
TQ_DEFAULT = 128  # query tile rows

# Launches of the CUDA kernel since import (or since a caller reset them):
# one per call that reaches the kernel, and nowhere else; the others count
# the run-loop, the external-query, the Jaccard and the global-id (slab
# join) launches among them.
KERNEL_LAUNCHES = 0
RUN_LOOP_LAUNCHES = 0
EXTERNAL_LAUNCHES = 0
JACCARD_LAUNCHES = 0
GID_LAUNCHES = 0
# the kernel's mask modes (csrc/fused_join.cu): the self mask, the UNICOMP
# triangle, and none for external queries
MASK_SELF, MASK_UNICOMP, MASK_EXTERNAL = 0, 1, 2


def pad_width(n_lanes: int) -> int:
    """Padded lane count for ``n_lanes`` occupied lanes: at least NP_PAD,
    rounded up to a multiple of 8."""
    return max(NP_PAD, -(-int(n_lanes) // 8) * 8)


def resolve_merge_last_dim(n_dims: int, merge_last_dim: bool | None,
                           extra_lanes: int = 0) -> bool:
    """Merged-range sweeps default on, and need a free pad lane for the
    last-dimension cell coordinate besides the ``n_dims`` coordinates and
    ``extra_lanes`` more (the slab join's global-id lane):
    ``n_dims + extra_lanes < NP_PAD``."""
    if merge_last_dim is None:
        merge_last_dim = True
    return bool(merge_last_dim) and n_dims + extra_lanes < NP_PAD


def pad_points(points_sorted: torch.Tensor, tail: int,
               last_coord: torch.Tensor | None = None,
               gid: torch.Tensor | None = None,
               feats: torch.Tensor | None = None) -> torch.Tensor:
    """(N, n) -> (N + tail, L) zero-padded copy for window reads, with L the
    ``pad_width`` of the occupied lanes.

    ``tail`` >= C keeps every C-slot window read in bounds. ``feats`` (the
    jaccard metric's packed token words, in sorted point order) fill lanes
    [n, n + n_feat), right after the coordinates. ``last_coord`` (merged
    sweeps) is each point's last-dimension cell coordinate, stored as an
    exact float in the next lane. ``gid`` (the slab join) is each point's
    global id, as a float of the points' dtype in the lane after those;
    its tail rows hold -1. Other tail lanes hold 0.
    """
    n_pts, n = points_sorted.shape
    n_feat = 0 if feats is None else feats.shape[1]
    lane = n + n_feat + (0 if last_coord is None else 1)
    out = points_sorted.new_zeros(
        (n_pts + tail, pad_width(lane + (0 if gid is None else 1))))
    out[:n_pts, :n] = points_sorted
    if feats is not None:
        out[:n_pts, n:n + n_feat] = feats.to(points_sorted.dtype)
    if last_coord is not None:
        out[:n_pts, n + n_feat] = last_coord.to(points_sorted.dtype)
    if gid is not None:
        out[:n_pts, lane] = gid.to(points_sorted.dtype)
        out[n_pts:, lane] = -1
    return out


def packed_width(n_feat: int) -> int:
    """int32 words a row of ``pack_words``: ceil(n_feat / 2), rounded up to
    a multiple of 4, at least 4."""
    return max(4, -(-int(n_feat) // 8) * 4)


def pack_words(rows: torch.Tensor, n_real: int, n_feat: int) -> torch.Tensor:
    """The jaccard metric's 16-bit token words of ``rows`` (float lanes
    [n_real, n_real + n_feat), as ``pad_points(feats=)`` lays them out)
    packed two to a 32-bit word: (R, W) int32, word k = lane n_real + 2k in
    the low half and lane n_real + 2k + 1 in the high half, zero past
    n_feat, W = ceil(n_feat / 2) rounded up to a multiple of 4 (at least 4)
    so that a row is whole 16-byte vectors. The popcount of an AND over the
    packed words is the sum of the 16-bit popcounts, exactly. B1 (e) reads
    its candidates' words here; plain torch glue, on any device."""
    width = packed_width(n_feat)
    halves = torch.zeros((rows.shape[0], 2 * width), dtype=torch.int64,
                         device=rows.device)
    halves[:, :n_feat] = rows[:, n_real:n_real + n_feat].to(torch.int64)
    packed = halves[:, 0::2] | (halves[:, 1::2] << 16)
    # into int32's range, two's complement: the bits stay as they are
    packed = packed - ((packed >> 31) << 32)
    return packed.to(torch.int32).contiguous()


def _mask_hits(hit, cand_pos, q_pos, zero, unicomp: bool,
               external: bool = False, gq=None, gc=None, ldiff=None):
    """UNICOMP triangle on the zero offset, else the self-pair mask.
    External queries have no self pair and no triangle: the identity.

    ``gq`` / ``gc`` (the slab join, B1 (d)): global ids of query and
    candidate replace sorted positions, so every slab breaks a tie inside a
    cell the same way. On the merged sweep the zero offset's window spans
    the own cell and the next one along the last dimension; only the own
    cell (``ldiff == 0``) takes the id triangle, the next cell (``ldiff >
    0``) counts whole, as sorted positions gave for free."""
    if external:
        return hit
    if gq is not None:
        if not unicomp:
            return hit & (gc != gq)
        tri = gc > gq
        if ldiff is not None:
            tri = (ldiff > 0) | ((ldiff == 0) & tri)
        return hit & (tri | (zero == 0))
    if unicomp:
        return hit & ((cand_pos > q_pos) | (zero == 0))
    return hit & (cand_pos != q_pos)


def _offset_hits(points_pad, q_batch, ws, wc, zero, q_pos, scal, *, c,
                 n_real, unicomp, external, merged, metric, n_feat,
                 gid_pairs=False):
    """Masked (Q, C) hits of every query row against one offset's windows."""
    slots = torch.arange(c, dtype=torch.int32, device=points_pad.device)
    cand_pos = ws[:, None] + slots[None, :]
    hit = metric_lib.plane_refine_hits(metric, points_pad, q_batch, cand_pos,
                                       scal, n_real=n_real, n_feat=n_feat)
    hit = hit & (slots[None, :] < wc[:, None])
    ldiff = gq = gc = None
    if merged:
        # cell coordinates ride the lane after the coordinate and feature
        # lanes as exact integers
        ml = n_real + n_feat
        ldiff = (points_pad[:, ml][cand_pos.long()]
                 - q_batch[:, ml][:, None])
        hit = hit & (torch.abs(ldiff) <= 1)
    if gid_pairs:
        # global ids ride the lane after the merged lane, exact in the dtype
        gl = n_real + n_feat + (1 if merged else 0)
        gq = q_batch[:, gl][:, None]
        gc = points_pad[:, gl][cand_pos.long()]
    return _mask_hits(hit, cand_pos, q_pos[:, None], zero, unicomp,
                      external, gq, gc, ldiff if gid_pairs else None)


def _fused_join_hits_reference(points_pad, q_batch, win_start, win_count,
                               is_zero, q_pos, scal, *, c, tq, n_real,
                               unicomp, external, merged, keep_hits,
                               metric="l2", n_feat=0, gid_pairs=False):
    """The plain PyTorch version of the kernel."""
    n_off, qp = win_start.shape
    dev = points_pad.device
    counts = torch.zeros(qp, dtype=torch.int32, device=dev)
    hits = torch.zeros((n_off if keep_hits else 1, qp, c), dtype=torch.int8,
                       device=dev)
    for j in range(n_off):
        hit = _offset_hits(points_pad, q_batch, win_start[j], win_count[j],
                           is_zero[j], q_pos, scal, c=c, n_real=n_real,
                           unicomp=unicomp, external=external,
                           merged=merged, metric=metric, n_feat=n_feat,
                           gid_pairs=gid_pairs)
        counts = counts + hit.sum(dim=1, dtype=torch.int32)
        if keep_hits:
            hits[j] = hit.to(torch.int8)
    ctile = counts.reshape(-1, tq)
    base = (torch.cumsum(ctile, dim=1, dtype=torch.int32) - ctile).reshape(-1)
    return hits, counts, base


_ARGTYPES = ([ctypes.c_int] * 7 + [ctypes.c_void_p] * 13
             + [ctypes.c_int] * 9 + [ctypes.c_void_p])
# Shared memory the Jaccard run loop stages windows in.
RUN_STAGE_BYTES = 14 * 1024
# Shared memory a launch gets without opting in; past it (a wide Jaccard
# vocabulary's query tile) the launch opts in, up to the device's limit.
SMEM_DEFAULT = 48 * 1024
_SMEM_OPTIN: dict = {}
# B1 (b), the external-query kernel (``fused_join_kernel_external``): a
# block of EXT_WARPS warps takes EXT_WARPS / P query rows of one tile, P
# warps a row (``external_row_warps``: more where windows pass EXT_SLOTS
# slots), so a tile of tq rows spreads over ``external_grid``'s row groups.
# The self-join kernel's blocks and spread launches are alike.
EXT_WARPS = 8
EXT_THREADS = 32 * EXT_WARPS
EXT_SLOTS = 128
_GRID_Y_MAX = 65535
# Its per-tile arrival counters, one uint32 a tile, a buffer per (device,
# stream): the last block of a tile sets its counter back to 0, so the
# buffer is zeroed only when it is made or grown, launches on one stream
# (which run in order) share it, and a launch on another stream never
# meets a counter in use.
_ARRIVALS: dict = {}


def _kernel_library():
    from repro_torch.kernels import build

    lib = build.load("fused_join")
    lib.fused_join_launch.argtypes = _ARGTYPES
    lib.fused_join_launch.restype = ctypes.c_int
    lib.fused_join_smem_optin.argtypes = [ctypes.c_int]
    lib.fused_join_smem_optin.restype = ctypes.c_int
    return lib


def smem_limit(device: torch.device) -> int:
    """The most dynamic shared memory a block may opt in to on ``device``
    (232,448 bytes on the H100), asked of the CUDA runtime once."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    limit = _SMEM_OPTIN.get(idx)
    if limit is None:
        limit = _kernel_library().fused_join_smem_optin(idx)
        if limit <= 0:
            raise RuntimeError(f"cannot read the shared-memory limit of "
                               f"cuda:{idx}")
        _SMEM_OPTIN[idx] = limit
    return limit


def external_row_warps(c: int) -> int:
    """P, the warps one query row of B1 (b) spreads over: the smallest
    power of two with P * EXT_SLOTS >= c, at most EXT_WARPS."""
    p = 1
    while p < EXT_WARPS and p * EXT_SLOTS < c:
        p *= 2
    return p


def external_grid(qp: int, tq: int, c: int) -> tuple:
    """B1 (b)'s grid: (query tiles, row groups of a tile), a group the
    EXT_WARPS / P rows of one block."""
    return qp // tq, -(-tq // (EXT_WARPS // external_row_warps(c)))


# Self-join launches of fewer tiles than SPREAD_TILES (``kSpreadTiles`` in
# ``csrc/fused_join.cu``) spread each tile's rows over blocks; a larger one
# gives each block a tile (on the H100 the bench workloads' launches of 111
# tiles and more ran faster a block a tile, of 79 and fewer spread:
# scripts/b1_variants.py). A lane holds a window slot's coordinates in
# registers, up to HELD_LANES of them where n_real is not an instance's
# constant (1-4).
SPREAD_TILES = 96
HELD_LANES = 8


def self_layout(qp: int, tq: int, c: int, gid_pairs: bool = False) -> tuple:
    """How B1's self-join kernel lays a launch out: (P warps a row, RW
    rows a chunk, rows a warp, blocks a tile, SW slots a row takes a step).
    A window of at most 16 slots takes SW, the smallest power of two that
    holds it, so a step of 32 lanes refines 32 / SW rows; wider ones, and
    every global-id launch, take 32. Fewer than SPREAD_TILES tiles: a warp
    takes one step's rows (one row, P = ``external_row_warps(c)``, past 16
    slots), the tile over row groups of blocks, scanned by the last block
    to arrive. Else one block a tile, each of its EXT_WARPS warps
    ceil(tq / EXT_WARPS) consecutive rows in chunks of RW, the smallest
    power of two that holds them (at most 32), SW at least 32 / RW, and the
    block scans its own tile."""
    cw = 5 if c > 16 or gid_pairs else (int(c) - 1).bit_length()
    if qp // tq < SPREAD_TILES:
        p = external_row_warps(c)
        rows = EXT_WARPS // p * (32 >> cw)
        return p, 32 >> cw, 32 >> cw, -(-tq // rows), 1 << cw
    per = -(-tq // EXT_WARPS)
    rw = min(32, 1 << (per - 1).bit_length())
    return 1, rw, -(-per // rw) * rw, 1, max(1 << cw, 32 // rw)


def self_stage_bytes(qp: int, tq: int, c: int, n_real: int, merged: bool,
                   gid_pairs: bool, item: int) -> int:
    """Shared memory of one block of B1's self-join kernel: its query
    rows (a tile, or a spread block's share of one), each n_real
    coordinates, the merged lane and the id lane (``csrc/fused_join.cu``'s
    ``self_stage_bytes``)."""
    p, _, rows_a_warp, _, _ = self_layout(qp, tq, c, gid_pairs)
    rows = min(EXT_WARPS // p * rows_a_warp, tq)
    return rows * (n_real + int(merged) + int(gid_pairs)) * item


def _tile_arrivals(dev: torch.device, stream: int, tiles: int):
    """The arrival counters of the launches on ``stream`` that spread a
    tile over blocks (B1 (b), B1's spread self-join launches): at least
    ``tiles`` zeros when no launch of the stream is in flight."""
    key = (dev.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 64), dtype=torch.int32, device=dev)
        _ARRIVALS[key] = buf
    return buf


def jaccard_record_bytes(word_lanes: int) -> int:
    """Bytes of one Jaccard record in shared memory (a query row or a
    staged slot): its packed words, then its size in one more 16-byte
    vector, an odd number of vectors in all (``csrc/fused_join.cu``)."""
    return ((word_lanes // 4 + 1) | 1) * 16


def shared_bytes(tq: int, word_lanes: int, run_loop: bool) -> int:
    """Dynamic shared memory of one block of the Jaccard kernel: the query
    tile's records of ``word_lanes`` packed words, four per-row int tables
    and, for the run loop, the window stage and its run tables
    (``csrc/fused_join.cu``'s layout)."""
    smem = tq * jaccard_record_bytes(word_lanes) + 4 * tq * 4
    if run_loop:
        smem += RUN_STAGE_BYTES + (2 * tq + 2) * 4
    return smem


def _launch(points_pad, words, q_batch, win_start, win_count, is_zero, q_pos,
            run_ord, scal, hits, counts, slot_base, merged, unicomp,
            external, keep_hits, c, n_real, tq, metric, n_feat, gid_pairs):
    """The kernel launch on the current stream, as the CUDA implementation
    of the torch op ``repro_torch::fused_join`` (below)."""
    dev = points_pad.device
    n_off, qp = win_start.shape
    lib = _kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        arrivals = (_tile_arrivals(dev, stream, qp // tq)
                    if _spreads(external, metric, gid_pairs, qp, tq, c)
                    else None)
        err = lib.fused_join_launch(
            DTYPE_CODES[points_pad.dtype], int(merged),
            (MASK_EXTERNAL if external
             else MASK_UNICOMP if unicomp else MASK_SELF),
            int(keep_hits), int(run_ord is not None),
            int(metric == "jaccard"), int(gid_pairs), points_pad.data_ptr(),
            0 if words is None else words.data_ptr(), q_batch.data_ptr(),
            win_start.data_ptr(), win_count.data_ptr(), is_zero.data_ptr(),
            q_pos.data_ptr(), 0 if run_ord is None else run_ord.data_ptr(),
            scal.data_ptr(), hits.data_ptr(), counts.data_ptr(),
            slot_base.data_ptr(),
            0 if arrivals is None else arrivals.data_ptr(), n_off, qp, c,
            n_real, n_feat,
            points_pad.shape[1], 0 if words is None else words.shape[1], tq,
            RUN_STAGE_BYTES, stream)
    if err != 0:
        raise RuntimeError(f"fused_join kernel launch failed: CUDA error {err}")


def _spreads(external: bool, metric: str, gid_pairs: bool, qp: int,
             tq: int, c: int) -> bool:
    """Whether a launch spreads a tile over blocks, which then need the
    per-stream arrival counters: every l2 external launch, and the l2
    self-join launches ``self_layout`` spreads."""
    if metric == "jaccard":
        return False
    return external or self_layout(qp, tq, c, gid_pairs)[3] > 1


# The launch runs inside a torch op because torch.profiler ties a kernel's
# device time to the op that launched it, and through the op to every
# profiler span around it; a launch made outside any op is tied to nothing.
_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("fused_join(Tensor points_pad, Tensor? words, Tensor q_batch, "
            "Tensor win_start, Tensor win_count, Tensor is_zero, "
            "Tensor q_pos, Tensor? run_ord, "
            "Tensor scal, Tensor(a!) hits, Tensor(b!) counts, "
            "Tensor(c!) slot_base, bool merged, bool unicomp, bool external, "
            "bool keep_hits, int c, int n_real, int tq, str metric, "
            "int n_feat, bool gid_pairs) -> ()")
_OPS.impl("fused_join", _launch, "CUDA")


def _fused_join_hits_cuda(points_pad, q_batch, win_start, win_count, is_zero,
                          q_pos, run_ord, scal, *, c, tq, n_real, unicomp,
                          external, merged, keep_hits, metric, n_feat,
                          gid_pairs, words=None):
    """Launch ``csrc/fused_join.cu`` on the current stream (no sync);
    ``run_ord`` None runs the row loop, a (Qp,) plan the run loop.
    ``words``: jaccard's ``pack_words(points_pad, n_real, n_feat)``, packed
    here when not given."""
    global KERNEL_LAUNCHES, RUN_LOOP_LAUNCHES, EXTERNAL_LAUNCHES
    global JACCARD_LAUNCHES, GID_LAUNCHES
    dev = points_pad.device
    dtype = points_pad.dtype
    n_off, qp = win_start.shape
    lanes = points_pad.shape[1]
    jaccard = metric == "jaccard"
    if dtype not in DTYPE_CODES:
        raise TypeError(f"fused_join kernel takes float32/float64 or "
                        f"float16/bfloat16, got {dtype}")
    if jaccard and dtype != torch.float32:
        raise TypeError(f"the Jaccard kernel takes float32 rows (the packed "
                        f"16-bit words are exact in float32, as "
                        f"metric.pack_tokens makes them), got {dtype}")
    if jaccard and merged:
        raise ValueError("the Jaccard kernel has no merged sweep: its size "
                         "grid is 1-D")
    if n_feat and not jaccard:
        raise ValueError(f"feature lanes ride the Jaccard kernel only; "
                         f"metric {metric!r} got n_feat={n_feat}")
    for name, t, dt, shape in (
            ("q_batch", q_batch, dtype, (qp, lanes)),
            ("win_start", win_start, torch.int32, (n_off, qp)),
            ("win_count", win_count, torch.int32, (n_off, qp)),
            ("is_zero", is_zero, torch.int32, (n_off,)),
            ("q_pos", q_pos, torch.int32, (qp,)),
            ("scal", scal, dtype, (1, 1))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not points_pad.is_contiguous():
        raise ValueError("points_pad must be contiguous")
    if tq <= 0 or qp % tq:
        raise ValueError(f"query rows {qp} must be a multiple of tq={tq}")
    if not jaccard and (external_grid(qp, tq, c)[1] if external else
                        self_layout(qp, tq, c, gid_pairs)[3]) > _GRID_Y_MAX:
        raise ValueError(f"a tile of {tq} rows needs more than {_GRID_Y_MAX} "
                         f"blocks")
    if n_real + n_feat + (1 if merged else 0) + (1 if gid_pairs else 0) \
            > lanes:
        raise ValueError(f"{lanes} lanes cannot hold {n_real} coordinates"
                         f"{f' and {n_feat} feature lanes' if n_feat else ''}"
                         f"{' and the merged lane' if merged else ''}"
                         f"{' and the global-id lane' if gid_pairs else ''}")
    if not jaccard and not external:
        smem = self_stage_bytes(qp, tq, c, n_real, merged, gid_pairs,
                              points_pad.element_size())
        if smem > SMEM_DEFAULT and smem > smem_limit(dev):
            raise ValueError(f"{tq} query rows of {n_real} coordinates need "
                             f"{smem} B of shared memory, above the "
                             f"{smem_limit(dev)} B a block of {dev} may opt "
                             f"in to")
    word_lanes = None
    if jaccard:
        word_lanes = packed_width(n_feat)
        if words is not None and (
                words.device != dev or words.dtype != torch.int32
                or tuple(words.shape) != (points_pad.shape[0], word_lanes)
                or not words.is_contiguous() or words.data_ptr() % 16):
            raise ValueError(
                f"words: expected a contiguous 16-byte aligned int32 "
                f"({points_pad.shape[0]}, {word_lanes}) tensor on {dev} "
                f"(pack_words), got {words.dtype} {tuple(words.shape)} on "
                f"{words.device}")
        smem = shared_bytes(tq, word_lanes, run_ord is not None)
        if smem > SMEM_DEFAULT and smem > smem_limit(dev):
            raise ValueError(f"tile of {tq} rows x {lanes} lanes needs "
                             f"{smem} B of shared memory, above the "
                             f"{smem_limit(dev)} B a block of {dev} may opt "
                             f"in to")
        if words is None:
            words = pack_words(points_pad, n_real, n_feat)
    counts = torch.empty(qp, dtype=torch.int32, device=dev)
    base = torch.empty(qp, dtype=torch.int32, device=dev)
    hits = (torch.empty((n_off, qp, c), dtype=torch.int8, device=dev)
            if keep_hits else
            torch.zeros((1, qp, c), dtype=torch.int8, device=dev))
    torch.ops.repro_torch.fused_join(
        points_pad, words if jaccard else None, q_batch, win_start,
        win_count, is_zero, q_pos, run_ord, scal, hits, counts, base, merged,
        unicomp, external, keep_hits, c, n_real, tq, metric, n_feat,
        gid_pairs)
    KERNEL_LAUNCHES += 1
    RUN_LOOP_LAUNCHES += run_ord is not None
    EXTERNAL_LAUNCHES += external
    JACCARD_LAUNCHES += jaccard
    GID_LAUNCHES += gid_pairs
    return hits, counts, base


def fused_join_hits(points_pad, q_batch, win_start, win_count, is_zero,
                    q_pos, eps, *, c, n_real, unicomp, external=False,
                    merged=False, gid_pairs=False, tq=TQ_DEFAULT,
                    keep_hits=True, run_ord=None, run_loop=False,
                    method=None, metric="l2", n_feat=0, words=None):
    """Fused gather-refine sweep over all stencil offsets in one launch.

    Args:
      points_pad: (N + tail, L) ``pad_points`` output, tail >= c.
      q_batch:    (Q_pad, L) query rows, Q_pad % tq == 0: rows of
                  ``points_pad`` at sorted positions ``q_pos`` for a self
                  join, any points laid out like them when ``external``.
      win_start / win_count: (n_off, Q_pad) int32 window descriptors; count
                  0 for padding rows and absent cells.
      is_zero:    (n_off,) int32, 1 for the zero offset.
      q_pos:      (Q_pad,) int32 sorted position of every query row
                  (zeros for external queries; no mask reads them).
      eps:        the refine threshold, unsquared: the L2 radius for l2
                  and cosine (squared once in the points' dtype by
                  ``metric.device_refine_scalar``), the similarity t for
                  jaccard.
      c:          window capacity of this launch.
      n_real:     true dimensionality (lanes >= n_real are not distance).
      unicomp:    triangle rule on the zero offset, else the self mask.
      external:   the queries are not points of the index: no self pair
                  and no triangle (overrides ``unicomp``).
      merged:     windows are merged last-dimension ranges, and lane
                  ``n_real`` carries last-dimension cell coordinates.
      keep_hits:  False returns a zero (1, Q_pad, c) plane, counts only.
      run_ord:    (Q_pad,) int32 per-tile run ordinals
                  (``grid.cell_run_plan(...).run_ord``) on the points'
                  device; needed by ``run_loop``, else unused.
      run_loop:   the kernel reads one window per run of equal ordinals.
                  The caller owns the contract that a run's rows share
                  their descriptors; each row still masks with its own.
      method:     None picks by device: the CUDA kernel for CUDA tensors,
                  the plain version for CPU tensors. "kernel" and
                  "reference" force one; "kernel" on CPU tensors raises.
      metric:     "l2", "cosine" (the l2 refine, on unit rows) or
                  "jaccard" (the bitmap popcount; float32 rows, per-cell
                  sweep only on the kernel).
      n_feat:     feature lanes after the ``n_real`` coordinates (jaccard's
                  packed words; ``pad_points(feats=)`` lays them out).
      words:      jaccard only: ``pack_words(points_pad, n_real, n_feat)``,
                  the kernel's 32-bit copy of the candidates' words, which
                  the drivers make once with ``points_pad``; the kernel
                  path packs it per call when it is None, the plain version
                  never reads it.
      gid_pairs:  the lane after the coordinates and the merged lane holds
                  global point ids (``pad_points(gid=)``), and the UNICOMP
                  and self masks compare them instead of sorted positions
                  (the slab join, B1 (d)); l2 and cosine only, never with
                  ``external``.

    Returns (hits, counts, slot_base).
    """
    if gid_pairs and (external or metric == "jaccard"):
        raise ValueError("gid_pairs masks the self join of a slab: it takes "
                         "neither external queries nor the jaccard metric")
    if run_loop:
        if run_ord is None:
            raise ValueError("run_loop=True requires a run_ord plan "
                             "(grid.cell_run_plan)")
        qp = win_start.shape[1]
        if (run_ord.dtype != torch.int32 or tuple(run_ord.shape) != (qp,)
                or run_ord.device != points_pad.device
                or not run_ord.is_contiguous()):
            raise ValueError(
                f"run_ord: expected a contiguous int32 ({qp},) tensor on "
                f"{points_pad.device}, got {run_ord.dtype} "
                f"{tuple(run_ord.shape)} on {run_ord.device}")
    metric_lib.check_metric(metric)
    if method is None:
        method = "kernel" if points_pad.is_cuda else "reference"
    scal = metric_lib.device_refine_scalar(metric, eps, points_pad.dtype,
                                           points_pad.device)
    kw = dict(c=c, tq=tq, n_real=n_real, unicomp=unicomp,
              external=bool(external), merged=merged, keep_hits=keep_hits,
              metric=metric, n_feat=n_feat, gid_pairs=bool(gid_pairs))
    if method == "kernel":
        if not points_pad.is_cuda:
            raise RuntimeError("the fused_join CUDA kernel needs CUDA "
                               "tensors; these lie on the CPU")
        return _fused_join_hits_cuda(
            points_pad, q_batch, win_start, win_count,
            is_zero.to(torch.int32), q_pos.to(torch.int32),
            run_ord if run_loop else None, scal, words=words, **kw)
    if method == "reference":
        # the plan is ignored: each row against its own descriptors is the
        # run loop's result whenever the plan keeps its contract
        return _fused_join_hits_reference(
            points_pad, q_batch, win_start, win_count, is_zero, q_pos, scal,
            **kw)
    raise ValueError(f"unknown fused_join method {method!r}")


# Slots (query rows x offsets x window slots) one emit step holds: its
# temporaries take ~60 bytes a slot, so a step stays near 4 GB however wide
# the windows (a Jaccard size cell's window spans a whole cell).
EMIT_STEP_SLOTS = 1 << 26


def emit_steps(hits, counts, slot_base, win_start, *, c: int, tq: int,
               npts: int):
    """The hit plane of one launch in steps of whole query tiles of at most
    ``EMIT_STEP_SLOTS`` slots, for the emits that scatter its pairs.

    Yields (a, b, h, cand, pos) for query rows [a, b): ``h`` the (b - a,
    n_off * c) hits, query-major (per row: offsets in sweep order, slots in
    window order), ``cand`` each slot's sorted point position clamped to
    [0, npts), ``pos`` each hit's output slot (the tile base from the scan
    of the tile totals, plus the kernel's per-tile ``slot_base``, plus the
    hit's rank in its row). Each step writes the slots the global scan gives
    its rows, so the pairs do not depend on the step."""
    n_off, qp, _ = hits.shape
    slots = torch.arange(c, dtype=torch.int32, device=hits.device)
    tile_tot = counts.reshape(-1, tq).sum(dim=1, dtype=torch.int64)
    tile_base = torch.cumsum(tile_tot, 0) - tile_tot
    qbase = torch.repeat_interleave(tile_base, tq) + slot_base.long()
    step = max(EMIT_STEP_SLOTS // max(n_off * c, 1) // tq, 1) * tq
    for a in range(0, qp, step):
        b = min(a + step, qp)
        h = hits[:, a:b].to(torch.bool).permute(1, 0, 2).reshape(b - a,
                                                                 n_off * c)
        cand = win_start[:, a:b, None] + slots[None, None, :]
        cand = torch.clamp(cand.permute(1, 0, 2).reshape(b - a, n_off * c),
                           max=npts - 1)
        rank = torch.cumsum(h, dim=1) - 1        # hit rank within its row
        yield a, b, h, cand.long(), qbase[a:b, None] + rank


def fused_window_hits(points_sorted, q, cand_pos, valid, eps):
    """(B, n) queries x (B, C) candidate positions into ``points_sorted`` ->
    (B, C) bool hits, ``sum((q - p)^2) <= eps^2`` and valid: the compact
    count route's refine for ``distance_impl="fused"``, by column gathers
    lane by lane, with no (B, C, n) candidate tensor. Plain torch code, as
    the JAX package's ``fused_window_hits`` is plain array code."""
    idx = cand_pos.long()
    d2 = metric_lib.lane_d2(q, lambda k: points_sorted[:, k][idx], q.shape[1])
    return metric_lib.l2_sq_hits(d2, eps) & valid
