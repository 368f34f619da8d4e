"""The emit kernel's decomposition and its wrapper, on the CPU.

``csrc/emit_pairs.cu`` compacts one fused launch's hit plane into its pairs:
a group of G lanes takes a row of n_off * c slots, reading V bytes a lane
(``emit_pairs.row_layout``), a warp prefix sum ranks the hits of a step,
and the step's pairs, staged in rank order, go to consecutive addresses
from the row's scan base. A model of that, built from the wrapper's layout,
must give the plain version's pairs (``core/selfjoin.py::_emit_from_hits``,
stacked) row for row, write every output row once, read no plane byte
twice and none of a row that counts no hit. The kernel itself is held to
the plain version on the card (``tests/test_torch_kernel_cuda.py``).

On the CPU the joins take the plain emit and never the kernel, and the
tensors every fused path hands the emit pass the kernel's checks.
"""
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as tdist
from repro_torch.core import selfjoin as tsj
from repro_torch.kernels import build
from repro_torch.kernels import emit_pairs as tep
from torch_workloads import EMIT_SHAPES, emit_inputs
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

SOURCE = Path(tep.__file__).parent / "csrc" / "emit_pairs.cu"


def plain_emit(hits, counts, slot_base, win_start, q_pos, ids, *, tq,
               unicomp):
    """``_emit_from_hits`` stacked, as ``selfjoin._emit_chunk`` runs it on
    CPU tensors."""
    args = [torch.as_tensor(a) for a in (hits, counts, slot_base, win_start,
                                         q_pos, ids)]
    index = types.SimpleNamespace(num_points=ids.shape[0])
    found = int(counts.sum())
    return tsj._emit_chunk(index, args[5], *args[:5], c=hits.shape[2], tq=tq,
                           unicomp=unicomp, found=found).numpy()


def kernel_model(hits, counts, slot_base, win_start, q_pos, ids, *, tq,
                 unicomp, address=0):
    """The kernel's decomposition over warp steps, in numpy: returns the
    (mult * n_hits, 2) pairs, how often each output row was written, and
    how often each plane byte was read."""
    n_off, qp, c = hits.shape
    npts = ids.shape[0]
    n_hits = int(counts.sum())
    vec, group = tep.row_layout(n_off, c, address)
    rows = tep.WARP // group
    cv = c // vec
    nv = n_off * cv
    iters = -(-nv // group)
    tile_tot = counts.reshape(-1, tq).sum(axis=1, dtype=np.int64)
    tile_base = np.cumsum(tile_tot) - tile_tot
    plane = hits.reshape(-1)
    reads = np.zeros(plane.shape, np.int64)
    out = np.full((n_hits, 4 if unicomp else 2), -1, np.int64)
    written = np.zeros(n_hits, np.int64)
    lane = np.arange(tep.WARP)
    gl = lane % group
    for step in range(-(-qp // rows)):
        q0 = step * rows
        q = q0 + lane // group
        cnt = np.where(q < qp, counts[np.minimum(q, qp - 1)], 0)
        need = int(cnt[gl == 0].sum())
        if need == 0:
            continue
        base = int(tile_base[q0 // tq] + slot_base[q0])
        qc = np.minimum(q, qp - 1)
        qid = ids[np.minimum(q_pos[qc], npts - 1)]
        done = 0
        for it in range(iters):
            v = it * group + gl
            live = (cnt > 0) & (v < nv)
            o = np.where(live, v // cv, 0)
            s0 = (v - o * cv) * vec
            addr = (o * qp + qc) * c + s0
            assert (addr[live] % vec == 0).all()
            bits = np.zeros((tep.WARP, vec), bool)
            idx = addr[live, None] + np.arange(vec)
            bits[live] = plane[idx] != 0
            np.add.at(reads, idx.reshape(-1), 1)
            k = bits.sum(axis=1)
            total = int(np.cumsum(k)[-1])
            # the staged pairs in rank order: lanes in order, bits ascending
            ln, b = np.nonzero(bits)
            cand = np.minimum(win_start[o[ln], qc[ln]] + s0[ln] + b, npts - 1)
            cid = ids[cand]
            pos = base + done + np.arange(total)
            keep = pos < n_hits
            e = (np.stack([qid[ln], cid, cid, qid[ln]], 1) if unicomp
                 else np.stack([qid[ln], cid], 1))
            out[pos[keep]] = e[keep]
            written[pos[keep]] += 1
            done += total
            if done >= need:
                break
    return out.reshape(-1, 2), written, reads.reshape(hits.shape)


def test_layout_mirrors_the_source():
    """The wrapper's constants and argument list are the kernel's own."""
    src = SOURCE.read_text()
    assert re.search(r"constexpr int kThreads = kWarps \* 32;", src)
    assert re.search(r"__shared__ int2 stage\[kWarps\]\[32 \* V\];", src)
    assert tep.MAX_VEC == 16 and tep.WARP == 32
    for v in (16, 8, 4, 2, 1):
        assert f"case {v}: kernel = pick<{v}>(unicomp != 0); break;" in src
    params = re.search(r'extern "C" int emit_pairs_launch\((.*?)\) \{', src,
                       re.S)[1]
    kinds = {"long long": ctypes.c_longlong, "int": ctypes.c_int}
    want = [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
            for p in (" ".join(p.split()) for p in params.split(","))]
    assert want == tep._ARGTYPES and len(want) == 18
    assert "emit_pairs" in build.SOURCES
    # one power of two per case: V divides c and the plane's address, G
    # the smallest group holding a row's vectors
    assert [tep.row_layout(1, c) for c in (1, 2, 3, 4, 8, 16, 24, 32, 33)] \
        == [(1, 1), (2, 1), (1, 4), (4, 1), (8, 1), (16, 1), (8, 4),
            (16, 2), (1, 32)]
    assert tep.row_layout(122, 16) == (16, 32)
    assert tep.row_layout(2, 16, address=8) == (8, 4)
    assert tep.row_layout(3, 300) == (4, 32)


@pytest.mark.parametrize("n_off,c", EMIT_SHAPES)
@pytest.mark.parametrize("unicomp", [True, False])
@pytest.mark.parametrize("ids_kind", ["order", "global"])
def test_kernel_model_matches_plain_version(n_off, c, unicomp, ids_kind):
    """Every layout the shapes give, on a bucketed launch with padding
    rows, dead rows and runs of them, windows past the last point, and the
    slab join's global ids: the model's pairs are the plain version's, each
    output row written once, each plane byte read at most once and none of
    a row without hits."""
    args = emit_inputs(n_off, c, seed=n_off * 100 + c,
                       global_ids=ids_kind == "global")
    hits, counts = args[0], args[1]
    want = plain_emit(*args, tq=32, unicomp=unicomp)
    got, written, reads = kernel_model(*args, tq=32, unicomp=unicomp)
    assert counts.sum() > 0 and (counts == 0).sum() > 40
    assert np.array_equal(got, want)
    assert (written == 1).all()
    assert reads.max() <= 1
    assert not reads[:, counts == 0].any()


@pytest.mark.parametrize("address", [1, 2, 4, 8])
def test_kernel_model_off_the_vector_boundary(address):
    """A plane whose address is off the 16-byte boundary reads narrower
    vectors and gives the same pairs."""
    args = emit_inputs(4, 32, seed=address)
    want = plain_emit(*args, tq=32, unicomp=True)
    got, written, _ = kernel_model(*args, tq=32, unicomp=True,
                                   address=address)
    assert tep.row_layout(4, 32, address)[0] == address
    assert np.array_equal(got, want) and (written == 1).all()


@pytest.mark.parametrize("unicomp", [True, False])
def test_kernel_model_without_hits(unicomp):
    """A launch with no hit: no pair, no plane byte read."""
    args = emit_inputs(3, 16, no_hits=True)
    got, written, reads = kernel_model(*args, tq=32, unicomp=unicomp)
    assert got.shape == (0, 2) and written.size == 0 and not reads.any()
    assert plain_emit(*args, tq=32, unicomp=unicomp).shape == (0, 2)


def test_cpu_join_takes_the_plain_emit(monkeypatch):
    """``self_join(..., device="cpu")`` emits through ``_emit_from_hits``
    and never reaches the kernel."""
    calls = []
    plain = tsj._emit_from_hits

    def spy(*args, **kw):
        calls.append(kw["capacity"])
        return plain(*args, **kw)

    monkeypatch.setattr(tsj, "_emit_from_hits", spy)
    before = tep.KERNEL_LAUNCHES
    pts = np.random.default_rng(0).uniform(0, 100, (4000, 2))
    got = tsj.self_join(pts, 2.0, device="cpu")
    assert calls and got.shape[0] > 0
    assert tep.KERNEL_LAUNCHES == before == 0


def _cpu_paths():
    rng = np.random.default_rng(3)
    uni = rng.uniform(0, 100, (3000, 2))
    dense = rng.uniform(0, 20, (3000, 2))
    sets = (rng.random((400, 32)) < 0.2).astype(np.int8)
    return {
        "join": lambda: tsj.self_join(uni, 2.0, device="cpu"),
        "no_unicomp": lambda: tsj.self_join(uni, 2.0, unicomp=False,
                                            device="cpu"),
        "run_loop": lambda: tsj.self_join(dense, 1.0, device="cpu"),
        "per_cell": lambda: tsj.self_join(uni, 2.0, merge_last_dim=False,
                                          bucketed=False, device="cpu"),
        "batched": lambda: tsj.self_join_batched(uni, 2.0, n_batches=3,
                                                 device="cpu"),
        "jaccard": lambda: tsj.self_join(sets, 0.5, metric="jaccard",
                                         device="cpu"),
        "slab": lambda: tdist.distributed_self_join(uni, 2.0, 2,
                                                    device="cpu"),
    }


@pytest.mark.parametrize("path", list(_cpu_paths()))
def test_every_fused_path_passes_the_kernels_checks(monkeypatch, path):
    """The tensors each fused join hands its emit (bucketed and contiguous
    launches, the run loop, without UNICOMP, batches, Jaccard's size grid,
    the slab join's global ids) are what the kernel takes."""
    seen = []
    real = tsj._emit_chunk

    def spy(index, ids, hits, counts, slot_base, win_start, q_pos, *, c,
            tq, unicomp, found):
        tep.check_inputs(hits, counts, slot_base, win_start, q_pos, ids,
                         tq=tq, npts=index.num_points, n_hits=found)
        assert c == hits.shape[2] and found == int(counts.sum())
        seen.append(hits.shape)
        return real(index, ids, hits, counts, slot_base, win_start, q_pos,
                    c=c, tq=tq, unicomp=unicomp, found=found)

    monkeypatch.setattr(tsj, "_emit_chunk", spy)
    out = _cpu_paths()[path]()
    assert seen and out.shape[0] > 0


def _valid_inputs():
    return [torch.as_tensor(a) for a in emit_inputs(3, 16)]


@pytest.mark.parametrize("case", [
    "hits_dtype", "counts_dtype", "ids_dtype", "win_start_dtype",
    "hits_ndim", "counts_shape", "win_start_shape", "q_pos_shape",
    "ids_short", "hits_view", "win_start_view", "tile", "n_hits"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    """Dtypes, shapes, contiguity, the tile and the hit count are checked
    before any device is asked for."""
    hits, counts, base, ws, qpos, ids = _valid_inputs()
    kw = dict(tq=32, npts=ids.shape[0], n_hits=int(counts.sum()),
              unicomp=True)
    err = ValueError
    if case == "hits_dtype":
        hits, err = hits.to(torch.uint8), TypeError
    elif case == "counts_dtype":
        counts, err = counts.long(), TypeError
    elif case == "ids_dtype":
        ids, err = ids.long(), TypeError
    elif case == "win_start_dtype":
        ws, err = ws.long(), TypeError
    elif case == "hits_ndim":
        hits = hits.reshape(hits.shape[0], -1)
    elif case == "counts_shape":
        counts = counts[:-32]
    elif case == "win_start_shape":
        ws = ws[:2]
    elif case == "q_pos_shape":
        qpos = qpos[None]
    elif case == "ids_short":
        kw["npts"] = ids.shape[0] + 1
    elif case == "hits_view":
        hits = hits.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "win_start_view":
        ws = ws.t().contiguous().t()
    elif case == "tile":
        kw["tq"] = 48
    else:
        kw["n_hits"] = -1
    with pytest.raises(err):
        tep.emit_pairs(hits, counts, base, ws, qpos, ids, **kw)


def test_wrapper_needs_cuda_tensors():
    """Inputs it takes, on the CPU: the kernel raises, and nothing is
    counted as a launch."""
    hits, counts, base, ws, qpos, ids = _valid_inputs()
    before = tep.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tep.emit_pairs(hits, counts, base, ws, qpos, ids, tq=32,
                       npts=ids.shape[0], n_hits=int(counts.sum()),
                       unicomp=False)
    assert tep.KERNEL_LAUNCHES == before
