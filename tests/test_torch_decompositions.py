"""The decompositions of the redesigned kernels B1 (b) and B4, on the CPU.

B1 (b) (``csrc/fused_join.cu``, ``fused_join_kernel_external``) takes the
external-query launches: block (x, y) of ``external_grid`` takes
EXT_WARPS / P query rows of tile x, P warps a row (``external_row_warps``,
more for wider windows); each warp loads up to 32 offsets' descriptors at
once, strides over its share of a window's slots 32 lanes at a time (past
the window only when the hit plane is kept), counts with a ballot, the P
warps of a row add their counts, and the last block of a tile to arrive
on its counter scans the tile's counts (warp shuffles, EXT_THREADS counts
at a time) and sets the counter back to 0. A model of that, built from the wrapper's mirror of the kernel's
rules, must write every (offset, row, slot) of the plane once, refine each
slot of a window once, and give the plain version's counts and slot bases,
whatever order the blocks arrive in, launch after launch.

B4 (``csrc/cell_join.cu``) gives each thread W consecutive slots (W the
largest power of two dividing C, at most MAX_WIDTH), read and written W
bytes at a time, while the warp refines its 32 * W slots in W coalesced
steps and hands each owner its bits from the step's ballot. The model must
load and store every slot's byte once with aligned accesses, read every
valid slot's candidate once (and no invalid one) with each step's slots
consecutive, step each lane's row without a division, and give the plain
version's hits; batches past the slot limit launch in row chunks.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import grid as tgrid
from repro_torch.core import metric as tmetric
from repro_torch.core import query_join as tqj
from repro_torch.kernels import cell_join as tcj
from repro_torch.kernels import fused_join as tfj
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

CSRC = Path(tfj.__file__).parent / "csrc"


def test_rules_mirror_the_sources():
    """The wrappers' constants are the kernels' own, by name."""
    fj = (CSRC / "fused_join.cu").read_text()
    assert re.search(rf"constexpr int kExtWarps = {tfj.EXT_WARPS};", fj)
    assert re.search(r"constexpr int kExtThreads = 32 \* kExtWarps;", fj)
    assert re.search(rf"constexpr int kExtSlots = {tfj.EXT_SLOTS};", fj)
    assert tfj.EXT_THREADS == 32 * tfj.EXT_WARPS
    assert re.search(r"\bext_row_warps\(", fj)
    assert re.search(r"const dim3 grid\(a\.qp / a\.tq, \(a\.tq \+ rows "
                     r"- 1\) / rows\);", fj)
    assert [tfj.external_row_warps(c) for c in (1, 128, 129, 256, 257, 512,
                                                513, 3848)] == [
        1, 1, 2, 2, 4, 4, 8, 8]
    cj = (CSRC / "cell_join.cu").read_text()
    assert re.search(rf"constexpr int kThreads = {tcj.THREADS};", cj)
    assert re.search(rf"constexpr int kMaxWidth = {tcj.MAX_WIDTH};", cj)
    assert tcj.MAX_SLOTS == 1 << 31
    assert re.search(r"constexpr long long kMaxSlots = 1LL << 31;", cj)
    assert re.search(r"\bslot_width\(", cj)
    assert [tcj.slot_width(c) for c in range(1, 17)] == [
        1, 2, 1, 4, 1, 2, 1, 8, 1, 2, 1, 4, 1, 2, 1, 8]


# --- B1 (b) ------------------------------------------------------------------

def warp_inclusive_sum(v: np.ndarray) -> np.ndarray:
    """``warp_inclusive_sum`` over the last axis of 32 lanes: five
    ``__shfl_up_sync`` steps, lane l adding lane l - d's value where
    l >= d."""
    v = v.copy()
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):
        up = np.concatenate([v[..., :d], v[..., :-d]], axis=-1)
        v = np.where(lane >= d, v + up, v)
    return v


def tile_scan(tile_counts: np.ndarray) -> np.ndarray:
    """The last block's exclusive scan of one tile's counts, as the kernel
    takes it: EXT_THREADS counts at a time, a warp scan of each warp's 32,
    warp 0's exclusive scan of the warp totals, a carry across chunks."""
    tq = tile_counts.size
    out = np.empty(tq, np.int64)
    carry = 0
    for r0 in range(0, tq, tfj.EXT_THREADS):
        v = np.zeros(tfj.EXT_THREADS, np.int64)
        n = min(tfj.EXT_THREADS, tq - r0)
        v[:n] = tile_counts[r0:r0 + n]
        v = v.reshape(tfj.EXT_WARPS, 32)
        incl = warp_inclusive_sum(v)
        t = np.zeros(32, np.int64)
        t[:tfj.EXT_WARPS] = incl[:, 31]
        ti = warp_inclusive_sum(t)
        warp_excl = (ti - t)[:tfj.EXT_WARPS]
        out[r0:r0 + n] = (carry + warp_excl[:, None] + incl - v).ravel()[:n]
        carry += ti[31]
    return out


def external_model(hit, wc, tq, keep_hits, arrivals, rng):
    """One launch of B1 (b) as its blocks and warps make it, over a plane
    ``hit`` (n_off, qp, c) of the refine's answers (False past each window).
    Every warp of the grid takes its row and share; then the blocks arrive
    in a random order on their tile's counter in ``arrivals``, and the block
    that finds the tile's other blocks arrived scans the tile's counts, all
    written by then. Returns the plane written, how often each byte was
    written and each slot refined, counts and slot_base."""
    n_off, qp, c = hit.shape
    gx, gy = tfj.external_grid(qp, tq, c)
    pw = tfj.external_row_warps(c)
    plane = np.zeros(hit.shape, np.int8)
    writes = np.zeros(hit.shape, np.int64)
    refined = np.zeros(hit.shape, np.int64)
    lane = np.arange(32)
    # every warp of the grid: block (x, y), warp w -> row y * R + w // P of
    # tile x, share w % P
    x, y, w = (a.ravel() for a in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(tfj.EXT_WARPS),
        indexing="ij"))
    r_in = y * (tfj.EXT_WARPS // pw) + w // pw
    busy = r_in < tq
    rows, sub = (x * tq + r_in)[busy], (w % pw)[busy]
    assert np.array_equal(np.bincount(rows, minlength=qp),
                          np.full(qp, pw))
    cnt = np.zeros(rows.size, np.int64)
    for j in range(n_off):   # lane j % 32 of round j // 32 loads j's
        count = np.minimum(wc[j, rows], c)
        end = np.full(rows.size, c) if keep_hits else count
        for k in range(-(-int(end.max(initial=0)) // (32 * pw))):
            s0 = sub * 32 + k * 32 * pw      # each warp's own chunk
            warps = s0 < end                 # warps still looping
            s = s0[:, None] + lane[None, :]
            live = warps[:, None] & (s < count[:, None])
            rr, ss = np.nonzero(live)
            refined[j, rows[rr], s[rr, ss]] += 1
            h = np.zeros(live.shape, bool)
            h[rr, ss] = hit[j, rows[rr], s[rr, ss]]
            if keep_hits:
                rr, ss = np.nonzero(warps[:, None] & (s < c))
                writes[j, rows[rr], s[rr, ss]] += 1
                plane[j, rows[rr], s[rr, ss]] = h[rr, ss]
            cnt += h.sum(axis=1)             # __popc of the ballot
    # the first warp of a row adds its P warps' counts (warps of a row are
    # consecutive)
    counts = np.full(qp, -1, np.int64)
    counts[rows[sub == 0]] = cnt.reshape(-1, pw).sum(axis=1)
    written = np.zeros(qp, bool)
    base = np.full(qp, -1, np.int64)
    rows_of = {}
    for xi, yi, row in zip(x[busy], y[busy], x[busy] * tq + r_in[busy]):
        rows_of.setdefault((xi, yi), []).append(row)
    for xi, yi in rng.permutation([(a, b) for a in range(gx)
                                   for b in range(gy)]):
        written[rows_of[(xi, yi)]] = True     # then it arrives
        arrivals[xi] += 1
        if arrivals[xi] == gy:                # the last to arrive
            tile = slice(xi * tq, (xi + 1) * tq)
            assert written[tile].all()
            base[tile] = tile_scan(counts[tile])
            arrivals[xi] = 0
    return plane, writes, refined, counts, base


def external_plane(qp: int, c: int, n_off: int, rng):
    """A refine plane with windows of random lengths (some empty, some
    past c) and random hits inside them; tile 0 has no hit, tile 1 one,
    tile 2 every slot of every window, when there are so many tiles."""
    tq = tfj.TQ_DEFAULT
    wc = rng.integers(0, c + 3, (n_off, qp))
    wc[:, rng.random(qp) < 0.1] = 0
    inside = np.arange(c)[None, None, :] < np.minimum(wc, c)[:, :, None]
    hit = inside & (rng.random((n_off, qp, c)) < 0.3)
    if qp >= tq:
        hit[:, :tq] = False
    if qp >= 2 * tq:
        hit[:, tq:2 * tq] = False
        j, r, s = np.nonzero(inside[:, tq:2 * tq])
        if j.size:
            k = rng.integers(j.size)
            hit[j[k], tq + r[k], s[k]] = True
    if qp >= 3 * tq:
        hit[:, 2 * tq:3 * tq] = inside[:, 2 * tq:3 * tq]
    return hit, wc


@pytest.mark.parametrize("qp,n_off", [(128, 1), (128, 40), (384, 3),
                                      (384, 40), (1024, 1), (1024, 3),
                                      (4096, 3)])
@pytest.mark.parametrize("c", [1, 7, 33, 100, 200, 300, 700])
def test_external_launch_covers_the_plane_once(qp, c, n_off):
    """Every (offset, row, slot) is written once with the plane kept, every
    slot inside a window refined once either way; counts are the hits a
    row, and slot_base the per-tile exclusive scan, over two launches back
    to back on one counter buffer, which ends zeroed each time."""
    rng = np.random.default_rng(qp + c + n_off)
    tq = tfj.TQ_DEFAULT
    hit, wc = external_plane(qp, c, n_off, rng)
    inside = np.arange(c)[None, None, :] < np.minimum(wc, c)[:, :, None]
    arrivals = np.zeros(qp // tq, np.int64)
    want_counts = hit.sum(axis=(0, 2))
    want_base = (np.cumsum(want_counts.reshape(-1, tq), axis=1)
                 - want_counts.reshape(-1, tq)).ravel()
    for keep_hits in (True, False):
        plane, writes, refined, counts, base = external_model(
            hit, wc, tq, keep_hits, arrivals, rng)
        assert np.array_equal(refined, inside.astype(np.int64))
        if keep_hits:
            assert np.all(writes == 1)
            assert np.array_equal(plane, hit.astype(np.int8))
        else:
            assert not writes.any()
        assert np.array_equal(counts, want_counts)
        assert np.array_equal(base, want_base)
        assert not arrivals.any()
    gx, gy = tfj.external_grid(qp, tq, c)
    pw = tfj.external_row_warps(c)
    assert gx * gy * tfj.EXT_WARPS == qp * pw  # no idle warp at tq = 128


@pytest.mark.parametrize("tq", [8, 100, 128, 300, 1024])
def test_tile_scan_is_the_exclusive_scan(tq):
    """The last block's scan at any tile height (one chunk, several, a
    ragged warp) equals the exclusive scan of the counts."""
    rng = np.random.default_rng(tq)
    for counts in (np.zeros(tq, np.int64), rng.integers(0, 5000, tq),
                   np.full(tq, 2 ** 20)):
        assert np.array_equal(tile_scan(counts),
                              np.cumsum(counts) - counts)


@pytest.mark.parametrize("merged", [True, False])
def test_external_model_equals_the_plain_version(merged):
    """The model over the plain refine's hits of a real request (the
    windows and hits of ``fused_join_hits(..., method="reference")`` on
    every launch) gives the plain version's hits, counts and slot_base."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 20, (3000, 2))
    q = rng.uniform(-1, 21, (700, 2))
    index = tgrid.build_grid(torch.as_tensor(pts), 0.6, device="cpu")
    pj = tqj.prepare(index, merge_last_dim=merged)
    _, launches = pj.launch_inputs(q)
    assert launches
    for _, _, args, kw in launches:
        plain = {k: v for k, v in kw.items() if k not in ("run_ord",
                                                          "run_loop")}
        hits, counts, base = tfj.fused_join_hits(*args, method="reference",
                                                 **plain)
        wc = args[3].numpy()
        arrivals = np.zeros(args[2].shape[1] // kw["tq"], np.int64)
        plane, writes, _, c_model, b_model = external_model(
            hits.numpy().astype(bool), wc, kw["tq"], True, arrivals, rng)
        assert np.all(writes == 1)
        assert np.array_equal(plane, hits.numpy())
        assert np.array_equal(c_model, counts.numpy())
        assert np.array_equal(b_model, base.numpy())


# --- B4 ----------------------------------------------------------------------

def b4_model(rows: int, c: int, n: int, valid: np.ndarray,
             hit: np.ndarray, max_slots: int = tcj.MAX_SLOTS):
    """B4's accesses as its launches, threads and steps make them, over the
    valid mask and the refine's answers ``hit`` (rows * c,) at the valid
    slots. Returns
    the hits stored, how often each byte is loaded as valid and stored,
    and how often each candidate element (n a slot) is read."""
    out = np.full(rows * c, -1, np.int64)
    loads = np.zeros(rows * c, np.int64)
    stores = np.zeros(rows * c, np.int64)
    reads = np.zeros(rows * c * n, np.int64)
    w = tcj.slot_width(c)
    q32, r32 = 32 // c, 32 % c
    for r0, nr, blocks in tcj.launch_chunks(rows, c, max_slots):
        base = r0 * c                   # the chunk's first valid/hit byte
        slots = nr * c
        assert nr * c <= max_slots
        g = np.arange(blocks * tcj.THREADS, dtype=np.int64)
        lane = g % 32
        own = g * w < slots
        first = base + g[own] * w       # a W-byte access, aligned
        assert not np.any(first % w)
        for b in range(w):
            loads[first + b] += 1
        s = (g - lane) * w + lane
        row = s // c
        col = s - row * c
        ball = np.zeros((g.size // 32, w), np.int64)
        for i in range(w):
            owner = (g - lane) + i * (32 // w) + lane // w
            assert np.array_equal(owner * w + lane % w, s)  # the shuffle
            live = s < slots
            assert np.array_equal(row[live], s[live] // c)  # stepped rows
            # the step's candidate reads: consecutive lanes, consecutive
            # slots, so each warp's live reads are one contiguous span
            ls = s.reshape(-1, 32)
            assert np.all(np.diff(ls, axis=1) == 1)
            # the owner's valid bit; an invalid slot's candidate is unread
            live[live] = valid[base + s[live]]
            for k in range(n):
                reads[(base + s[live]) * n + k] += 1
            h = np.zeros(g.size, bool)
            h[live] = hit[base + s[live]]
            ball[:, i] = (h.reshape(-1, 32).astype(np.int64)
                          << np.arange(32)).sum(axis=1)
            s = s + 32
            row = row + q32
            col = col + r32
            wrap = col >= c
            col[wrap] -= c
            row[wrap] += 1
        mine = ball[g // 32, (lane * w) >> 5] >> ((lane * w) & 31)
        for b in range(w):
            stores[first + b] += 1
            out[first + b] = (mine[own] >> b) & 1
    return out, loads, stores, reads


B4_C = list(range(1, 25)) + [31, 32, 33, 40, 64, 100]


@pytest.mark.parametrize("n", range(1, 9))
def test_b4_covers_every_slot_once(n):
    """For every c of every residue mod 8 and B from 1 to 70: each valid
    byte loaded once and each hit byte stored once, with W-byte aligned
    accesses; each slot's candidate read once, by coalesced steps; and the
    stored hits are the refine's."""
    rng = np.random.default_rng(n)
    for c in B4_C:
        for rows in range(1, 71):
            valid = rng.random(rows * c) < 0.7
            hit = valid & (rng.random(rows * c) < 0.6)
            out, loads, stores, reads = b4_model(rows, c, n, valid, hit)
            assert np.all(loads == 1) and np.all(stores == 1), (rows, c)
            assert np.array_equal(reads, np.repeat(valid, n)), (rows, c)
            assert np.array_equal(out, hit.astype(np.int64)), (rows, c)


@pytest.mark.parametrize("max_slots", [64, 100, 1000])
def test_b4_row_chunks_cover_every_slot_once(max_slots):
    """Past the slot limit a batch launches in row chunks, each starting on
    a W-byte boundary, together covering every slot once."""
    rng = np.random.default_rng(max_slots)
    for c in (1, 3, 8, 24, 33, 64):
        if c > max_slots:
            continue
        for rows in (1, 7, 70, 500):
            chunks = tcj.launch_chunks(rows, c, max_slots)
            assert sum(nr for _, nr, _ in chunks) == rows
            assert all(nr * c <= max_slots for _, nr, _ in chunks)
            valid = rng.random(rows * c) < 0.7
            hit = valid & (rng.random(rows * c) < 0.6)
            out, loads, stores, reads = b4_model(rows, c, 2, valid, hit,
                                                 max_slots)
            assert np.all(loads == 1) and np.all(stores == 1)
            assert np.array_equal(reads, np.repeat(valid, 2))
            assert np.array_equal(out, hit.astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.float16, torch.bfloat16])
def test_b4_model_equals_the_plain_version(dtype):
    """The model over the plain refine's answers (random valid masks, a
    lattice with d^2 on eps^2) stores the plain version's hit plane."""
    rng = np.random.default_rng(3)
    for rows, c, n in ((70, 24, 2), (33, 7, 3), (5, 40, 8), (64, 32, 1)):
        q = torch.as_tensor(rng.integers(0, 4, (rows, n))).to(dtype)
        cand = torch.as_tensor(rng.integers(0, 4, (rows, c, n))).to(dtype)
        valid = torch.as_tensor(rng.random((rows, c)) < 0.7)
        want = tcj.cell_join_hits(q, cand, valid, 2.0, method="reference")
        out, _, stores, _ = b4_model(rows, c, n, valid.numpy().ravel(),
                                     want.numpy().ravel())
        assert np.all(stores == 1)
        assert np.array_equal(out.reshape(rows, c),
                              want.numpy().astype(np.int64))
        scal = tmetric.device_refine_scalar("l2", 2.0, dtype,
                                            torch.device("cpu"))
        assert torch.equal(want, tcj._cell_join_hits_reference(
            q, cand, valid, scal))
