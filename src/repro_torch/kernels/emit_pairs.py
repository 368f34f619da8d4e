"""The self-join's emit as a CUDA kernel: one fused launch's hit plane
compacted into its ordered pairs.

One B1 launch (``fused_join``) leaves

    hits      (n_off, qp, c) int8  -- the masked hits of every window slot
    counts    (qp,)          int32 -- hits a query row
    slot_base (qp,)          int32 -- exclusive scan of counts in each tile

with the windows' ``win_start`` (n_off, qp) int32 and the rows' sorted
positions ``q_pos`` (qp,) int32. ``emit_pairs`` turns them into the
launch's (mult * n_hits, 2) int32 pairs of ``ids`` in query-major order
(per query: offsets in sweep order, slots in window order): the pair of a
hit goes to the scan of the tile totals plus its row's ``slot_base`` plus
its rank in the row, two ordered rows a hit with UNICOMP (query first,
then candidate first) and one without. That is
``core/selfjoin.py::_emit_from_hits``'s output stacked, bit for bit and
row for row; that function is the plain version, run for CPU tensors and
held to the kernel on the card.

``csrc/emit_pairs.cu`` reads the plane once and writes only the hits
(its source note has the design). A CUDA tensor launches the kernel or
raises; there is no fallback. The wrapper checks what it is given,
allocates the output, launches on the current stream and does not
synchronise: ``n_hits``, the launch's ``counts.sum()``, is the caller's.
"""
from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel since import (or since a caller reset it): one
# per call that reaches the kernel, and nowhere else.
KERNEL_LAUNCHES = 0
# The kernel's decomposition (csrc/emit_pairs.cu): a lane reads at most
# MAX_VEC plane bytes at once, and a warp holds WARP lanes.
MAX_VEC = 16
WARP = 32


def row_layout(n_off: int, c: int, address: int = 0) -> tuple:
    """(V, G) of a launch: V the plane bytes a lane reads at once, the
    largest power of two up to MAX_VEC dividing ``c`` and the plane's
    ``address``; G the lanes that take a row of ``n_off * c`` slots, the
    smallest power of two up to WARP holding its n_off * c / V vectors, so
    a warp takes WARP / G rows at once."""
    vec = MAX_VEC
    while c % vec or address % vec:
        vec //= 2
    n_vec = n_off * c // vec
    group = WARP
    while group > 1 and group // 2 >= n_vec:
        group //= 2
    return vec, group


def check_inputs(hits, counts, slot_base, win_start, q_pos, ids, *,
                 tq: int, npts: int, n_hits: int) -> None:
    """Raise on what the kernel does not take: dtypes, shapes, contiguity,
    the tile, the point count and the hit count."""
    named = dict(hits=hits, counts=counts, slot_base=slot_base,
                 win_start=win_start, q_pos=q_pos, ids=ids)
    if hits.dtype != torch.int8:
        raise TypeError(f"emit_pairs takes an int8 hit plane, got "
                        f"{hits.dtype}")
    for name, t in named.items():
        if name != "hits" and t.dtype != torch.int32:
            raise TypeError(f"emit_pairs takes int32 {name}, got {t.dtype}")
    if hits.ndim != 3:
        raise ValueError(f"expected hits (n_off, qp, c), got "
                         f"{tuple(hits.shape)}")
    n_off, qp, _ = hits.shape
    want = dict(counts=(qp,), slot_base=(qp,), win_start=(n_off, qp),
                q_pos=(qp,))
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"expected {name} {shape} for hits "
                             f"{tuple(hits.shape)}, got "
                             f"{tuple(named[name].shape)}")
    if ids.ndim != 1 or not 1 <= npts <= ids.shape[0]:
        raise ValueError(f"expected ids (N,) with 1 <= npts <= N, got "
                         f"{tuple(ids.shape)} and npts {npts}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"emit_pairs takes a contiguous {name}")
        if t.device != hits.device:
            raise ValueError(f"{name} lies on {t.device}, hits on "
                             f"{hits.device}")
    if tq < 1 or qp % tq:
        raise ValueError(f"the tile {tq} does not divide the {qp} rows")
    if n_hits < 0:
        raise ValueError(f"n_hits must be >= 0, got {n_hits}")


# emit_pairs_launch's parameters (csrc/emit_pairs.cu), in order: the eight
# tensors, qp, n_off, c, tq, npts, n_hits, vec, group_log2, unicomp, stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 4
             + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _kernel_library():
    from repro_torch.kernels import build

    lib = build.load("emit_pairs")
    lib.emit_pairs_launch.argtypes = _ARGTYPES
    lib.emit_pairs_launch.restype = ctypes.c_int
    return lib


def _launch(hits, counts, slot_base, tile_base, win_start, q_pos, ids, out,
            tq, npts, n_hits, vec, group, unicomp):
    """The kernel launch on the current stream, as the CUDA implementation
    of the torch op ``repro_torch::emit_pairs`` (below)."""
    n_off, qp, c = hits.shape
    lib = _kernel_library()
    with torch.cuda.device(hits.device):
        stream = torch.cuda.current_stream(hits.device).cuda_stream
        err = lib.emit_pairs_launch(
            hits.data_ptr(), counts.data_ptr(), slot_base.data_ptr(),
            tile_base.data_ptr(), win_start.data_ptr(), q_pos.data_ptr(),
            ids.data_ptr(), out.data_ptr(), qp, n_off, c, tq, npts, n_hits,
            vec, group.bit_length() - 1, int(unicomp), stream)
    if err != 0:
        raise RuntimeError(f"emit_pairs kernel launch failed: CUDA error "
                           f"{err}")


# Inside a torch op, so that torch.profiler ties the kernel's device time to
# the op and to every profiler span around it (as for fused_join).
_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("emit_pairs(Tensor hits, Tensor counts, Tensor slot_base, "
            "Tensor tile_base, Tensor win_start, Tensor q_pos, Tensor ids, "
            "Tensor(a!) out, int tq, int npts, int n_hits, int vec, "
            "int group, bool unicomp) -> ()")
_OPS.impl("emit_pairs", _launch, "CUDA")


def emit_pairs(hits, counts, slot_base, win_start, q_pos, ids, *, tq: int,
               npts: int, n_hits: int, unicomp: bool) -> torch.Tensor:
    """One launch's ((2 if unicomp else 1) * n_hits, 2) int32 pairs of
    ``ids``, from the kernel on the current stream (no sync). ``npts``
    clamps the window slots and query positions as the plain version does;
    ``n_hits`` is ``counts.sum()``."""
    global KERNEL_LAUNCHES
    check_inputs(hits, counts, slot_base, win_start, q_pos, ids, tq=tq,
                 npts=npts, n_hits=n_hits)
    if not hits.is_cuda:
        raise RuntimeError("the emit_pairs CUDA kernel needs CUDA tensors; "
                           "these lie on the CPU")
    mult = 2 if unicomp else 1
    out = torch.empty((mult * n_hits, 2), dtype=torch.int32,
                      device=hits.device)
    n_off, qp, c = hits.shape
    if hits.numel():
        tile_tot = counts.view(-1, tq).sum(dim=1, dtype=torch.int64)
        tile_base = torch.cumsum(tile_tot, 0) - tile_tot
        vec, group = row_layout(n_off, c, hits.data_ptr())
        torch.ops.repro_torch.emit_pairs(hits, counts, slot_base, tile_base,
                                         win_start, q_pos, ids, out, tq, npts,
                                         n_hits, vec, group, unicomp)
        KERNEL_LAUNCHES += 1
    return out
