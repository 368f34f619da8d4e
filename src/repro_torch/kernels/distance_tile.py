"""Tiled brute-force epsilon distances: CUDA kernels and plain versions.

The compute core of the paper's GPU brute-force baseline (SVI-B), the
counterpart of the JAX package's ``repro.kernels.distance_tile``:

  * ``distance_tile_hits(q, pts, eps)`` -> (nq, N) bool, d2 <= eps^2;
  * ``distance_tile_counts(pts, eps)`` -> (N,) int32 neighbour counts,
    excluding each point itself.

Both compute d2 in the expanded form the TPU kernels compute on the MXU,
``d2 = (qn + pn) - 2 * cross`` with qn, pn the squared norms and cross the
dot product, each summed lane by lane from the left, in float64 for float64
input and float32 for float32 (``_expanded_d2``); float16 and bfloat16
input (kernel B2-bf16) is upcast to float32 and takes the float32 form, as
the TPU kernels upcast to their accumulator dtype, with eps rounded to the
half dtype and squared there, then upcast, as the JAX package forms it
(``_acc_rows``). The expanded form rounds
differently from the direct ``sum((q - p)^2)`` of the oracles
(``distance_tile_hits_ref``, ``distance_tile_counts_ref``), so the two may
disagree on pairs whose d2 lies within a few ulps of (qn + pn) of eps^2.

Each function has a CUDA kernel (``csrc/distance_tile.cu``) for CUDA tensors
and its plain PyTorch version for CPU tensors; the kernel equals the plain
version bit for bit. The count kernel evaluates each unordered pair once,
since d2 is symmetric bit for bit, where the plain version evaluates all
N^2 ordered pairs. There is no fallback: a kernel that fails to build or
launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import metric as metric_lib
from repro_torch.kernels.fused_join import DTYPE_CODES

TQ_DEFAULT = 256   # query rows of a tile
TC_DEFAULT = 256   # candidate rows of a tile
MAX_LANES = 8      # the TPU kernels' padded lane count (NP_PAD)
_GRID_Y_MAX = 65535
_GRID_X_MAX = 2 ** 31 - 1
# The count kernel's own tile (csrc/distance_tile.cu kTile): 256 threads x 4
# query rows each, on both sides of a tile pair.
COUNTS_TILE = 1024
# The hits kernel's decomposition (csrc/distance_tile.cu, the same names in
# its constants kHitsThreads, kHitsRows, kHitsRegBudget and its functions
# hits_group, hits_width): a block of HITS_THREADS threads takes HITS_ROWS
# query rows against HITS_THREADS * G candidates, G a thread.
HITS_THREADS = 128
HITS_ROWS = 32
HITS_REG_BUDGET = 96   # 32-bit registers for a thread's candidates
_SMEM_DEFAULT = 48 * 1024

# Launches of each CUDA kernel since import (or since a caller reset them):
# one per call that reaches the kernel, and nowhere else.
HITS_LAUNCHES = 0
COUNTS_LAUNCHES = 0


def _check_dtype(dtype) -> None:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"distance_tile takes float32/float64 or "
                        f"float16/bfloat16, got {dtype}")


def _acc_dtype(dtype) -> torch.dtype:
    """The dtype the tiles compute in: float64 for float64, else float32
    (the JAX kernels' ``_acc_dtype``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _acc_rows(*xs):
    """``xs`` (rows and the squared threshold) upcast to ``_acc_dtype``:
    exact, and a no-op at float32 and float64."""
    acc = _acc_dtype(xs[0].dtype)
    return tuple(x.to(acc) for x in xs)


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.ndim != 2 or not 1 <= x.shape[1] <= MAX_LANES:
        raise ValueError(f"{name}: expected (rows, n) with 1 <= n <= "
                         f"{MAX_LANES}, got {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared row norms, lane by lane from the left, each op rounded."""
    acc = x[:, 0] * x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k] * x[:, k]
    return acc


def _expanded_d2(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(nq, N) d2 = (qn + pn) - 2 * cross in the kernels' order."""
    cross = q[:, 0, None] * pts[None, :, 0]
    for k in range(1, q.shape[1]):
        cross = cross + q[:, k, None] * pts[None, :, k]
    return (_sq_norms(q)[:, None] + _sq_norms(pts)[None, :]) - 2 * cross


def _distance_tile_hits_reference(q, pts, scal):
    """The plain version of the hits kernel: (nq, N) bool."""
    q, pts, scal = _acc_rows(q, pts, scal)
    return metric_lib.l2_sq_hits_presquared(_expanded_d2(q, pts), scal)


def _distance_tile_counts_reference(pts, scal, *, chunk_elems: int = 1 << 24):
    """The plain version of the count kernel: (N,) int32, by chunks of
    query rows of about ``chunk_elems`` pairs each."""
    npts = pts.shape[0]
    counts = torch.empty(npts, dtype=torch.int32, device=pts.device)
    rows = max(1, chunk_elems // max(npts, 1))
    cols = torch.arange(npts, device=pts.device)
    for r0 in range(0, npts, rows):
        hit = _distance_tile_hits_reference(pts[r0:r0 + rows], pts, scal)
        hit &= cols[None, :] != cols[r0:r0 + rows, None]
        counts[r0:r0 + rows] = hit.sum(dim=1, dtype=torch.int32)
    return counts


def distance_tile_hits_ref(q, pts, eps):
    """Direct-form oracle: (nq, n) x (N, n) -> (nq, N) bool,
    ``sum((q - p)^2) <= eps^2`` (the JAX package's ``ref`` module)."""
    d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(dim=-1)
    return metric_lib.l2_sq_hits(d2, torch.as_tensor(eps, dtype=q.dtype))


def distance_tile_counts_ref(pts, eps):
    """Direct-form oracle: (N, n) -> (N,) int32 neighbour counts, excluding
    self."""
    hits = distance_tile_hits_ref(pts, pts, eps)
    hits &= ~torch.eye(pts.shape[0], dtype=torch.bool, device=pts.device)
    return hits.sum(dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _kernel_library():
    from repro_torch.kernels import build

    lib = build.load("distance_tile")
    lib.distance_tile_hits_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    lib.distance_tile_hits_launch.restype = ctypes.c_int
    lib.distance_tile_counts_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    lib.distance_tile_counts_launch.restype = ctypes.c_int
    return lib


def _acc_item(dtype) -> int:
    """Bytes of one staged value: the kernels stage rows and norms in the
    accumulator dtype."""
    return _acc_dtype(dtype).itemsize


def _record_len(n: int, dtype) -> int:
    """Values of one staged record (csrc ``Record::kLen``): a row's ``n``
    lanes and its norm in the accumulator dtype, padded to 16 bytes."""
    per16 = 16 // _acc_item(dtype)
    return -(-(n + 1) // per16) * per16


def counts_shared_bytes(n: int, dtype, tc: int) -> int:
    """Shared memory of one count-kernel block: the tile's candidate
    credits (int32) and two chunks of ``tc`` staged records."""
    return COUNTS_TILE * 4 + 2 * tc * _record_len(n, dtype) * _acc_item(dtype)


def hits_group(n: int, dtype) -> int:
    """G, the candidates one thread of the hits kernel owns: 16, halved (to
    no fewer than 4) while their lanes and norms, G * (n + 1) values of the
    accumulator dtype, would take more than HITS_REG_BUDGET 32-bit
    registers."""
    words = _acc_item(dtype) // 4
    g = 16
    while g > 4 and g * (n + 1) * words > HITS_REG_BUDGET:
        g //= 2
    return g


def hits_width(npts: int, group: int) -> int:
    """W, the bytes of one store of the hits kernel: the largest power of
    two that divides ``npts`` (the plane's row length), at most ``group``."""
    w = min(group, 16)
    while npts % w:
        w //= 2
    return w


def hits_grid(nq: int, npts: int, n: int, dtype) -> tuple:
    """The hits kernel's grid (x: candidate tiles, y: blocks of HITS_ROWS
    query rows)."""
    tile = HITS_THREADS * hits_group(n, dtype)
    return -(-npts // tile), -(-nq // HITS_ROWS)


def hits_shared_bytes(n: int, dtype) -> int:
    """Shared memory of one hits-kernel block: its HITS_ROWS query rows as
    staged records, and its candidate tile in the row dtype, each thread's
    G * n values at a stride one bank (4 bytes; 8 for float64) longer
    (csrc ``CandTile``)."""
    item = dtype.itemsize
    stride = hits_group(n, dtype) * n + max(4 // item, 1)
    return (HITS_ROWS * _record_len(n, dtype) * _acc_item(dtype)
            + HITS_THREADS * stride * item)


def _check_tiles(tq: int, tc: int, smem: int) -> None:
    if tq <= 0 or tc <= 0:
        raise ValueError(f"tiles must be positive, got tq={tq}, tc={tc}")
    if smem > _SMEM_DEFAULT:
        raise ValueError(f"tiles tq={tq}, tc={tc} need {smem} B of shared "
                         f"memory, above the 48 KiB default")


def _distance_tile_hits_cuda(q, pts, scal, *, tq, tc):
    """Launch the hits kernel on the current stream (no sync). ``tq`` and
    ``tc`` are only checked: the kernel's tile is its own."""
    global HITS_LAUNCHES
    nq, n = q.shape
    npts = pts.shape[0]
    _check_tiles(tq, tc, hits_shared_bytes(n, q.dtype))
    if hits_grid(nq, npts, n, q.dtype)[1] > _GRID_Y_MAX:
        raise ValueError(f"{nq} query rows need more than {_GRID_Y_MAX} "
                         f"blocks of {HITS_ROWS}")
    # a fresh allocation: aligned far past the kernel's 16-byte stores
    out = torch.empty((nq, npts), dtype=torch.int8, device=q.device)
    if nq and npts:
        lib = _kernel_library()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.distance_tile_hits_launch(
                DTYPE_CODES[q.dtype], n, q.data_ptr(),
                pts.data_ptr(), scal.data_ptr(), out.data_ptr(), nq, npts,
                stream)
        if err != 0:
            raise RuntimeError(f"distance_tile hits kernel launch failed: "
                               f"CUDA error {err}")
        HITS_LAUNCHES += 1
    return out.view(torch.bool)


def _distance_tile_counts_cuda(pts, scal, *, tq, tc):
    """Launch the count kernel on the current stream (no sync)."""
    global COUNTS_LAUNCHES
    npts, n = pts.shape
    _check_tiles(tq, tc, counts_shared_bytes(n, pts.dtype, tc))
    tiles = -(-npts // COUNTS_TILE)
    if tiles * (tiles + 1) // 2 > _GRID_X_MAX:
        raise ValueError(f"{npts} points need more than {_GRID_X_MAX} tile "
                         f"pairs of {COUNTS_TILE} rows")
    # the kernel adds each block's credits to the counts
    counts = torch.zeros(npts, dtype=torch.int32, device=pts.device)
    if npts:
        lib = _kernel_library()
        with torch.cuda.device(pts.device):
            stream = torch.cuda.current_stream(pts.device).cuda_stream
            err = lib.distance_tile_counts_launch(
                DTYPE_CODES[pts.dtype], n, pts.data_ptr(),
                scal.data_ptr(), counts.data_ptr(), npts, tc, stream)
        if err != 0:
            raise RuntimeError(f"distance_tile count kernel launch failed: "
                               f"CUDA error {err}")
        COUNTS_LAUNCHES += 1
    return counts


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _resolve_method(method, x: torch.Tensor) -> str:
    if method is None:
        return "kernel" if x.is_cuda else "reference"
    if method == "kernel" and not x.is_cuda:
        raise RuntimeError("the distance_tile CUDA kernels need CUDA "
                           "tensors; these lie on the CPU")
    if method not in ("kernel", "reference"):
        raise ValueError(f"unknown distance_tile method {method!r}")
    return method


def distance_tile_hits(q, pts, eps, *, tq: int = TQ_DEFAULT,
                       tc: int = TC_DEFAULT, method=None):
    """(nq, n) x (N, n) -> (nq, N) bool epsilon hits in the expanded form.

    ``pts`` is cast to ``q``'s dtype; eps is cast to it, then squared.
    ``method`` None picks the CUDA kernel for CUDA tensors and the plain
    version for CPU tensors; "kernel" and "reference" force one.

    The kernel's tiles are its own: a block takes HITS_ROWS query rows
    against HITS_THREADS * ``hits_group(n, dtype)`` candidates, held in
    registers, and stores the plane ``hits_width`` bytes at a time. ``tq``
    and ``tc`` are only checked to be positive; the hits depend on
    neither.
    """
    _check_dtype(q.dtype)
    _check_rows("q", q)
    _check_rows("pts", pts)
    if pts.shape[1] != q.shape[1]:
        raise ValueError(f"q has {q.shape[1]} lanes, pts {pts.shape[1]}")
    pts = pts.to(device=q.device, dtype=q.dtype)
    scal = metric_lib.device_refine_scalar("l2", eps, q.dtype, q.device)
    if _resolve_method(method, q) == "kernel":
        return _distance_tile_hits_cuda(q.contiguous(), pts.contiguous(),
                                        scal, tq=tq, tc=tc)
    return _distance_tile_hits_reference(q, pts, scal)


def distance_tile_counts(pts, eps, *, tq: int = TQ_DEFAULT,
                         tc: int = TC_DEFAULT, method=None):
    """(N, n) -> (N,) int32 epsilon-neighbour counts, excluding self: every
    pair evaluated, with an O(N) output. ``method`` as in
    ``distance_tile_hits``.

    The plain version evaluates all N^2 ordered pairs. The kernel evaluates
    each unordered pair once, over the upper triangle of tile pairs of
    ``COUNTS_TILE`` rows, and credits a hit to both points; d2 is symmetric
    bit for bit, so the counts are the same. Its tiles are its own: ``tc``
    is the number of candidate rows it stages in shared memory at a time
    (two such chunks must fit the 48 KiB default), and ``tq`` is only
    checked to be positive. The counts depend on neither."""
    _check_dtype(pts.dtype)
    _check_rows("pts", pts)
    scal = metric_lib.device_refine_scalar("l2", eps, pts.dtype, pts.device)
    if _resolve_method(method, pts) == "kernel":
        return _distance_tile_counts_cuda(pts.contiguous(), scal, tq=tq,
                                          tc=tc)
    return _distance_tile_counts_reference(pts, scal)
