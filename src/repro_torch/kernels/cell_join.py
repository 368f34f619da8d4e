"""Grid-cell candidate refine of the unfused sweep: CUDA kernel and plain
version.

The counterpart of the JAX package's ``repro.kernels.cell_join``: the refine
step of ``distance_impl="pallas"``, which consumes what the unfused offset
sweep gathers for one stencil offset,

    q (B, n), cand (B, C, n), valid (B, C) bool -> (B, C) bool hits,

a hit where ``sum((q - c)^2) <= eps^2`` and the slot is valid. ``cand`` is
cast to ``q``'s dtype, and eps to it before it is squared
(``metric.device_refine_scalar``), as in the JAX package. The sum is the
Pallas kernel's ``jnp.sum(d * d, axis=-1)`` as XLA computes it: at float16
and bfloat16 the differences round to the half dtype (float16 squares too),
the squares add in float32 and the sum rounds once (``metric.lane_d2_sum``).

Two implementations of the same function live here:

  * ``_cell_join_hits_cuda`` launches ``csrc/cell_join.cu`` (the port of the
    Pallas kernel ``_cell_join_kernel``) on CUDA tensors: a thread owns
    ``slot_width(C)`` consecutive slots of a row, its warp refines them in
    coalesced steps, and a large batch launches in ``launch_chunks``;
  * ``_cell_join_hits_reference`` is the plain PyTorch version: d^2 summed
    lane by lane in lane order, one eager op per subtract, multiply and add
    (``metric.lane_d2_sum``). The CPU runs it, and the kernel is held to it
    bit for bit on the card.

``cell_join_hits`` picks by where the tensors lie: the kernel for CUDA
tensors, the plain version for CPU tensors. There is no fallback: a kernel
that fails to build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import metric as metric_lib
from repro_torch.kernels.fused_join import DTYPE_CODES

# Launches of the CUDA kernel since import (or since a caller reset it): one
# per call that reaches the kernel, and nowhere else.
KERNEL_LAUNCHES = 0
# The kernel's decomposition (csrc/cell_join.cu; ``slot_width``,
# ``launch_chunks``): a thread owns W consecutive slots of a row, a block
# THREADS threads, and a launch at most MAX_SLOTS slots (32-bit indexes).
THREADS = 256
MAX_WIDTH = 8
MAX_SLOTS = 1 << 31


def slot_width(c: int) -> int:
    """W, the slots one thread owns and the bytes of its valid load and
    hit store: the largest power of two dividing ``c``, at most MAX_WIDTH."""
    w = MAX_WIDTH
    while c % w:
        w //= 2
    return w


def launch_chunks(rows: int, c: int, max_slots: int = MAX_SLOTS) -> list:
    """The kernel's launches for a (rows, c) batch: (first row, rows,
    blocks) each, in row chunks of at most ``max_slots`` slots."""
    chunk = max_slots // c
    w = slot_width(c)
    out = []
    for r0 in range(0, rows, chunk):
        nr = min(chunk, rows - r0)
        out.append((r0, nr, -(-(nr * c // w) // THREADS)))
    return out


def _cell_join_hits_reference(q, cand, valid, scal):
    """The plain version of the kernel: (B, C) bool."""
    d2 = metric_lib.lane_d2_sum(q, lambda k: cand[:, :, k], q.shape[1])
    return metric_lib.l2_sq_hits_presquared(d2, scal) & valid


def _kernel_library():
    from repro_torch.kernels import build

    lib = build.load("cell_join")
    lib.cell_join_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.cell_join_launch.restype = ctypes.c_int
    return lib


def _launch(q, cand, valid, scal, out):
    """The kernel launch on the current stream, as the CUDA implementation
    of the torch op ``repro_torch::cell_join`` (below)."""
    rows, c, n = cand.shape
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cell_join_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), cand.data_ptr(),
            valid.data_ptr(), scal.data_ptr(), out.data_ptr(), rows, c, n,
            stream)
    if err != 0:
        raise RuntimeError(f"cell_join kernel launch failed: CUDA error {err}")


# Inside a torch op, so that torch.profiler ties the kernel's device time to
# the op and to every profiler span around it (as for fused_join).
_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("cell_join(Tensor q, Tensor cand, Tensor valid, Tensor scal, "
            "Tensor(a!) out) -> ()")
_OPS.impl("cell_join", _launch, "CUDA")


def _cell_join_hits_cuda(q, cand, valid, scal):
    """Launch ``csrc/cell_join.cu`` on the current stream (no sync)."""
    global KERNEL_LAUNCHES
    rows, c, _ = cand.shape
    # a fresh allocation: aligned far past the kernel's W-byte stores
    out = torch.empty((rows, c), dtype=torch.int8, device=q.device)
    if rows and c:
        if valid.data_ptr() % slot_width(c):
            valid = valid.clone()      # a view off the W-byte boundary
        torch.ops.repro_torch.cell_join(q, cand, valid, scal, out)
        KERNEL_LAUNCHES += 1
    return out.view(torch.bool)


def _resolve_method(method, x: torch.Tensor) -> str:
    if method is None:
        return "kernel" if x.is_cuda else "reference"
    if method == "kernel" and not x.is_cuda:
        raise RuntimeError("the cell_join CUDA kernel needs CUDA tensors; "
                           "these lie on the CPU")
    if method not in ("kernel", "reference"):
        raise ValueError(f"unknown cell_join method {method!r}")
    return method


def cell_join_hits(q, cand, valid, eps, *, method=None):
    """(B, n) x (B, C, n) x (B, C) bool -> (B, C) bool epsilon hits.

    ``method`` None picks the CUDA kernel for CUDA tensors and the plain
    version for CPU tensors; "kernel" and "reference" force one ("kernel" on
    CPU tensors raises)."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"cell_join takes float32/float64 or "
                        f"float16/bfloat16, got {q.dtype}")
    if q.ndim != 2 or cand.ndim != 3 or cand.shape[0] != q.shape[0] \
            or cand.shape[2] != q.shape[1] or q.shape[1] < 1 \
            or tuple(valid.shape) != tuple(cand.shape[:2]):
        raise ValueError(f"expected q (B, n), cand (B, C, n), valid (B, C); "
                         f"got {tuple(q.shape)}, {tuple(cand.shape)}, "
                         f"{tuple(valid.shape)}")
    cand = cand.to(device=q.device, dtype=q.dtype)
    valid = valid.to(device=q.device, dtype=torch.bool)
    scal = metric_lib.device_refine_scalar("l2", eps, q.dtype, q.device)
    if _resolve_method(method, q) == "kernel":
        return _cell_join_hits_cuda(q.contiguous(), cand.contiguous(),
                                    valid.contiguous(), scal)
    return _cell_join_hits_reference(q, cand, valid, scal)
