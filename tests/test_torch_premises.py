"""The premises of the redesigned kernels B3, B1 (e) and B2, on the CPU.

B3 (``csrc/distance_tile.cu``) evaluates each unordered pair once, over the
upper triangle of tile pairs, and credits a hit to both points. That gives
the plain version's counts only if the expanded-form d2 is symmetric bit for
bit and zero on the diagonal, at every dtype the kernel takes: here
``_expanded_d2`` (the plain arithmetic, on ``_acc_rows``) on random rows,
duplicate rows, a lattice and rows near the lanes' extremes, and the
triangle's counts, taken the way the kernel's blocks take them, against
``_distance_tile_counts_reference`` and the JAX package's Pallas tile in
interpret mode.

B1 (e) (``csrc/fused_join.cu``, template JACCARD) reads the 16-bit token
words packed two to a 32-bit word (``kernels.fused_join.pack_words``). The
popcount of an AND over the packed words must be the per-slot intersection
the plain version sums over the float lanes with ``popcount16``, and the
hits it gives must be the JAX package's.

B2 (``csrc/distance_tile.cu``, ``distance_tile_hits_kernel``) writes the
(nq, npts) int8 plane from blocks of HITS_ROWS query rows against
HITS_THREADS * G candidates, G a thread, each thread storing its G hit bytes
of a row W bytes at a time. A model of that decomposition, built from the
wrapper's mirror of the kernel's rules (``hits_group``, ``hits_width``,
``hits_grid``), must write every byte of the plane exactly once with
aligned stores inside one row, stay inside CUDA's grid limits, and give the
plain version's hits when the hits are computed block by block and group
by group.
"""
import re
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import metric as jmetric
from repro.kernels import distance_tile as jdt
from repro_torch.core import metric as tmetric
from repro_torch.kernels import distance_tile as tdt
from repro_torch.kernels import fused_join as tfj
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = {"f64": torch.float64, "f32": torch.float32, "f16": torch.float16,
          "bf16": torch.bfloat16}
JAX_DTYPES = {"f64": np.float64, "f32": np.float32, "f16": np.float16,
              "bf16": ml_dtypes.bfloat16}
# per row dtype: the largest magnitude whose squared norms stay finite in
# the accumulator at 8 lanes, and a magnitude whose squares underflow
EXTREMES = {"f64": (1e150, 1e-160), "f32": (1e18, 1e-22),
            "f16": (65504.0, 6e-8), "bf16": (1e18, 1e-22)}


def rows(kind: str, npts: int, n: int, dtype: str, seed: int = 0):
    """Seeded (npts, n) rows at the row dtype: "random" uniform in [0, 10),
    "dups" the same with a tenth of the rows copies of earlier ones,
    "lattice" small integers (many d2 exactly on an integer eps^2),
    "extreme" rows scaled to the dtype's largest finite-norm magnitude, 1
    or its underflowing one, with random signs."""
    rng = np.random.default_rng(seed)
    if kind == "lattice":
        x = rng.integers(0, 4, (npts, n)).astype(np.float64)
    else:
        x = rng.uniform(0, 10, (npts, n))
    if kind == "dups" and npts > 1:
        dup = rng.choice(np.arange(1, npts), max(npts // 10, 1))
        x[dup] = x[rng.integers(0, dup)]
    if kind == "extreme":
        big, tiny = EXTREMES[dtype]
        scale = rng.choice([big, 1.0, tiny], (npts, 1))
        x = rng.choice([-1.0, 1.0], x.shape) * rng.uniform(0.5, 1.0,
                                                          x.shape) * scale
    t = torch.as_tensor(x.astype(JAX_DTYPES[dtype]).astype(np.float64))
    return t.to(DTYPES[dtype])


def bits(x: torch.Tensor) -> torch.Tensor:
    """The bit patterns of ``x`` (float32 or float64), NaNs made one."""
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", range(1, 9))
def test_expanded_d2_is_symmetric_with_zero_diagonal(dtype, n):
    """d2(i, j) == d2(j, i) bit for bit and d2(i, i) == 0, in the
    accumulator the kernels compute in; rows whose norms overflow keep the
    symmetry (their NaNs sit at mirrored places)."""
    for kind in ("random", "dups", "lattice", "extreme"):
        (x,) = tdt._acc_rows(rows(kind, 300, n, dtype, seed=n))
        d2 = tdt._expanded_d2(x, x)
        assert torch.equal(bits(d2), bits(d2.T)), kind
        assert torch.equal(torch.diagonal(d2),
                           torch.zeros(x.shape[0], dtype=x.dtype)), kind
    # past the extremes (f16 widens to float32, where its norms never
    # overflow)
    (over,) = tdt._acc_rows(rows("extreme", 200, n, dtype, seed=n)
                            * (1.0 if dtype == "f16" else 1e5))
    d2 = tdt._expanded_d2(over, over)
    assert torch.equal(bits(d2), bits(d2.T))


def tile_pairs(nt: int):
    """Block b -> tile pair (I, J) for every block of a triangle of ``nt``
    tiles: the decode of ``distance_tile_counts_kernel``, in numpy."""
    b = np.arange(nt * (nt + 1) // 2, dtype=np.int64)
    w = 2.0 * nt + 1.0
    i = np.clip((w - np.sqrt(w * w - 8.0 * b)) / 2.0, 0, nt - 1).astype(
        np.int64)

    def start(r):
        return r * nt - r * (r - 1) // 2

    for _ in range(2):   # the kernel's fix-up loops, which stop sooner
        i = np.where((i + 1 < nt) & (start(i + 1) <= b), i + 1, i)
        i = np.where(start(i) > b, i - 1, i)
    assert np.all((start(i) <= b) & ((i + 1 == nt) | (b < start(i + 1))))
    return i, i + b - start(i)


@pytest.mark.parametrize("nt", [1, 2, 3, 7, 98, 1954])
def test_triangle_blocks_cover_each_tile_pair_once(nt):
    """The kernel's blocks enumerate the upper triangle of tile pairs row by
    row, each pair once: 98 tiles at 100 k points, 1,954 at 2 M."""
    i, j = tile_pairs(nt)
    want_i, want_j = np.triu_indices(nt)
    assert np.array_equal(i, want_i) and np.array_equal(j, want_j)


def triangle_counts(x: torch.Tensor, scal: torch.Tensor, tile: int):
    """Counts as the kernel's blocks take them: for every tile pair (I, J),
    I <= J, the hits of rows of I against candidates of J, only j > i on the
    diagonal, credited to both points."""
    npts = x.shape[0]
    hits = tdt._expanded_d2(x, x) <= scal.reshape(())
    counts = torch.zeros(npts, dtype=torch.int32)
    nt = -(-npts // tile)
    for i, j in zip(*tile_pairs(nt)):
        r = slice(i * tile, min((i + 1) * tile, npts))
        c = slice(j * tile, min((j + 1) * tile, npts))
        h = hits[r, c]
        if i == j:
            h = torch.triu(h, diagonal=1)
        counts[r] += h.sum(dim=1, dtype=torch.int32)
        counts[c] += h.sum(dim=0, dtype=torch.int32)
    return counts


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("npts", [1, 2, 63, 64, 65, 1000])
def test_triangle_counts_equal_the_plain_version(dtype, npts):
    """The strict upper triangle's counts equal the plain version's full
    N^2 evaluation, with tiles of 64 rows so that N falls below, on and
    just past a tile edge; on random rows with duplicates, a lattice with
    d2 exactly on eps^2 and extreme rows."""
    for kind, eps in (("dups", 1.5), ("lattice", 1.0), ("extreme", 1.5)):
        for n in (1, 2, 5, 8):
            x = rows(kind, npts, n, dtype, seed=npts + n)
            scal = tmetric.device_refine_scalar("l2", eps, x.dtype,
                                                torch.device("cpu"))
            want = tdt._distance_tile_counts_reference(x, scal)
            (acc, acc_scal) = tdt._acc_rows(x, scal)
            got = triangle_counts(acc, acc_scal, 64)
            assert torch.equal(got, want), (kind, n)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 3, 8])
def test_triangle_counts_equal_jax(dtype, n):
    """The triangle's counts against the JAX package's count tile (Pallas,
    interpret mode) on the same rows: duplicates and a lattice."""
    for kind, eps in (("dups", 2.0), ("lattice", 1.0)):
        x = rows(kind, 300, n, dtype, seed=7 * n)
        jx = jnp.asarray(x.double().numpy().astype(JAX_DTYPES[dtype]))
        want = np.asarray(jdt.distance_tile_counts(jx, eps, interpret=True))
        scal = tmetric.device_refine_scalar("l2", eps, x.dtype,
                                            torch.device("cpu"))
        got = triangle_counts(*tdt._acc_rows(x, scal), 128)
        assert np.array_equal(got.numpy(), want) and want.sum() > 0, kind


def popcount32(x: torch.Tensor) -> torch.Tensor:
    return tmetric.popcount16(x & 0xFFFF) + tmetric.popcount16(
        (x >> 16) & 0xFFFF)


def jaccard_rows(vocab: int, npts: int = 240, seed: int = 0):
    """Padded Jaccard rows (size lane, then the float words) of seeded token
    sets of 0 to 40 tokens, empty sets included, with their canonical form."""
    rng = np.random.default_rng(seed)
    sets = [tuple(rng.choice(vocab, int(rng.integers(0, min(vocab, 40) + 1)),
                             replace=False)) for _ in range(npts)]
    sets[3] = ()
    sets[5] = sets[7] = tuple(range(min(vocab, 5)))
    canon = tmetric.canonicalize(sets, 0.5, metric="jaccard", vocab=vocab)
    padded = tfj.pad_points(torch.as_tensor(canon.geom), 0,
                            feats=torch.as_tensor(canon.feats))
    return canon, padded


@pytest.mark.parametrize("vocab", [1, 16, 17, 40, 100, 1024])
def test_packed_words_give_the_same_intersection(vocab):
    """pack_words: two 16-bit words to an int32, the ragged last one and the
    row's padding zero; every slot's popcount of the AND over the packed
    words equals the plain version's sum over the float lanes. n_feat is
    1, 1, 2, 3 (odd), 7 (a vocabulary that is no multiple of 32) and 64."""
    canon, padded = jaccard_rows(vocab, seed=vocab)
    n_feat = canon.n_feat
    words = tfj.pack_words(padded, 1, n_feat)
    assert words.dtype == torch.int32 and words.is_contiguous()
    assert words.shape == (padded.shape[0], tfj.packed_width(n_feat))
    assert tfj.packed_width(n_feat) % 4 == 0
    f = canon.feats.astype(np.int64)
    lo = f[:, 0::2]
    hi = np.zeros_like(lo)
    hi[:, : f[:, 1::2].shape[1]] = f[:, 1::2]
    want = (lo | (hi << 16)).astype(np.uint32).view(np.int32)
    assert np.array_equal(words[:, : want.shape[1]].numpy(), want)
    assert not words[:, want.shape[1]:].any()
    plain = torch.zeros((padded.shape[0],) * 2, dtype=torch.int32)
    for k in range(n_feat):
        w = padded[:, 1 + k].to(torch.int32)
        plain += tmetric.popcount16(w[:, None] & w[None, :])
    packed = torch.zeros_like(plain)
    for k in range(words.shape[1]):
        packed += popcount32(words[:, k, None] & words[None, :, k])
    assert torch.equal(packed, plain) and int(plain.sum()) > 0


@pytest.mark.parametrize("vocab", [17, 40, 1024])
def test_packed_refine_equals_jax(vocab):
    """The refine on packed words, in the kernel's float32 order (union =
    (sq + sc) - inter, hit = union > 0 and inter >= t * union), gives the
    JAX package's plain Jaccard hits of every set against every set."""
    canon, padded = jaccard_rows(vocab, seed=3)
    words = tfj.pack_words(padded, 1, canon.n_feat)
    inter = torch.zeros((padded.shape[0],) * 2, dtype=torch.int32)
    for k in range(words.shape[1]):
        inter += popcount32(words[:, k, None] & words[None, :, k])
    t = tmetric.device_refine_scalar("jaccard", canon.eps, torch.float32,
                                     torch.device("cpu")).reshape(())
    fi = inter.to(torch.float32)
    union = (padded[:, 0, None] + padded[None, :, 0]) - fi
    got = (union > 0) & (fi >= t * union)
    npts = padded.shape[0]
    cand = jnp.broadcast_to(jnp.arange(npts, dtype=jnp.int32), (npts, npts))
    want = jmetric.plane_refine_hits(
        "jaccard", jnp.asarray(padded.numpy()), jnp.asarray(padded.numpy()),
        cand, jmetric.device_refine_scalar("jaccard", canon.eps, jnp.float32),
        n_real=1, n_feat=canon.n_feat)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert bool(got[5, 7]) and not bool(got[3, 3])


# B2's write map: the plane widths of the brute workloads (100,000, 30,000,
# 20,000 points), every width 1..70 and two more of each parity
HITS_NPTS = list(range(1, 71)) + [1000, 3001, 20000, 30000, 100000]
HITS_NQ = (1, 7, 256)
ACC = {"f64": torch.float64, "f32": torch.float32}
CUDA_GRID = dict(x=2 ** 31 - 1, y=65535, threads=1024, smem=48 * 1024)


def hits_map(nq: int, npts: int, n: int, dtype):
    """B2's stores as its blocks and threads make them: block (x, y) takes
    query rows [y * HITS_ROWS, ...) up to nq and, in thread t, the G
    columns from (x * HITS_THREADS + t) * G; store s of a row covers W
    bytes from that column plus s * W, and is made when its column lies
    before npts. Returns the rows written (one entry a block row), the
    store columns (one entry a store of a row), W and G."""
    g = tdt.hits_group(n, dtype)
    w = tdt.hits_width(npts, g)
    gx, gy = tdt.hits_grid(nq, npts, n, dtype)
    rows = np.concatenate([
        y * tdt.HITS_ROWS + np.arange(min(tdt.HITS_ROWS,
                                          nq - y * tdt.HITS_ROWS))
        for y in range(gy)])
    col = ((np.arange(gx, dtype=np.int64)[:, None, None] * tdt.HITS_THREADS
            + np.arange(tdt.HITS_THREADS)[None, :, None]) * g
           + np.arange(g // w)[None, None, :] * w).ravel()
    return rows, col[col < npts], w, g


@pytest.mark.parametrize("acc", list(ACC))
@pytest.mark.parametrize("n", range(1, 9))
def test_hits_stores_cover_the_plane_once(acc, n):
    """Every byte of the (nq, npts) plane is written by exactly one store;
    no store crosses a row or starts off a W-byte boundary (a row starts at
    byte row * npts); the grid, block and shared memory stay inside CUDA's
    limits. Each written row gets the same column stores, so the plane is
    covered once when the rows are and one row's columns are."""
    dtype = ACC[acc]
    for npts in HITS_NPTS:
        for nq in HITS_NQ:
            rows, col, w, g = hits_map(nq, npts, n, dtype)
            assert w in (1, 2, 4, 8, 16) and g % w == 0 and g % 4 == 0
            assert np.array_equal(np.bincount(rows, minlength=nq),
                                  np.ones(nq, dtype=np.int64))
            written = (col[:, None] + np.arange(w)).ravel()
            assert written.max() < npts       # inside the row
            assert np.array_equal(np.bincount(written, minlength=npts),
                                  np.ones(npts, dtype=np.int64))
            starts = rows[:, None] * npts + col[None, :]
            assert not np.any(starts % w), (npts, nq)
            gx, gy = tdt.hits_grid(nq, npts, n, dtype)
            assert gx <= CUDA_GRID["x"] and gy <= CUDA_GRID["y"]
            assert tdt.HITS_THREADS <= CUDA_GRID["threads"]
            assert tdt.hits_shared_bytes(n, dtype) <= CUDA_GRID["smem"]
    # the brute workloads take 16-byte stores where G allows them
    for npts in (100000, 30000, 20000):
        assert tdt.hits_width(npts, tdt.hits_group(n, dtype)) == min(
            16, tdt.hits_group(n, dtype))


def test_hits_rules_mirror_the_source():
    """The wrapper's constants and rules are the kernel's, by name; G keeps
    a thread's candidates within the register budget, and 256 query rows of
    100,000 f64 2-D points fill the card (about three blocks an SM)."""
    src = (Path(tdt.__file__).parent / "csrc" / "distance_tile.cu").read_text()
    for name, value in (("kHitsThreads", tdt.HITS_THREADS),
                        ("kHitsRows", tdt.HITS_ROWS),
                        ("kHitsRegBudget", tdt.HITS_REG_BUDGET)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    for fn in ("hits_group", "hits_width"):
        assert re.search(rf"\b{fn}\(", src), fn
    want = {torch.float64: [16, 16, 8, 8, 8, 4, 4, 4],
            torch.float32: [16, 16, 16, 16, 16, 8, 8, 8]}
    for dtype, groups in want.items():
        assert [tdt.hits_group(n, dtype) for n in range(1, 9)] == groups
    assert tdt.hits_group(4, torch.float16) == tdt.hits_group(4,
                                                              torch.float32)
    gx, gy = tdt.hits_grid(256, 100000, 2, torch.float64)
    assert (gx, gy) == (49, 8) and gx * gy >= 2 * 132


def hits_by_groups(q, pts, scal) -> torch.Tensor:
    """The plane as the kernel's blocks compute it: each block's query rows
    against each thread's G candidates, through ``_expanded_d2`` on the
    accumulator rows, placed at the model's stores."""
    nq, n = q.shape
    npts = pts.shape[0]
    g = tdt.hits_group(n, q.dtype)
    rows, col, w, _ = hits_map(nq, npts, n, q.dtype)
    qa, pa, sa = tdt._acc_rows(q, pts, scal)
    plane = torch.full((nq, npts), 7, dtype=torch.int8)
    for y in range(0, nq, tdt.HITS_ROWS):
        r = slice(y, min(y + tdt.HITS_ROWS, nq))
        for c0 in range(0, npts, g):
            c = slice(c0, min(c0 + g, npts))
            hit = tdt._expanded_d2(qa[r], pa[c]) <= sa.reshape(())
            plane[r, c] = hit.to(torch.int8)
    assert set(col.tolist()) == set(range(0, npts, w))
    return plane


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", range(1, 9))
def test_hits_by_groups_equal_the_plain_version(dtype, n):
    """Block by block and group by group, the hits equal the plain
    version's (nq, npts) plane: random rows with duplicates, a lattice with
    d2 exactly on eps^2 and extreme rows, eps^2 of +inf included, on a
    query slice that starts at an odd row."""
    for kind, eps in (("dups", 2.5), ("lattice", 1.0), ("extreme", 1.5),
                      ("extreme", 1e160)):
        for npts, nq in ((1, 1), (17, 7), (70, 33), (1001, 40)):
            x = rows(kind, npts, n, dtype, seed=npts + n)
            q = x[npts // 2:npts // 2 + nq]
            scal = tmetric.device_refine_scalar("l2", eps, x.dtype,
                                                torch.device("cpu"))
            want = tdt._distance_tile_hits_reference(q, x, scal)
            got = hits_by_groups(q, x, scal)
            assert torch.equal(got, want.to(torch.int8)), (kind, npts, nq)
