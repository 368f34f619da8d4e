#!/usr/bin/env python3
"""Time design variants of kernel B4 (``csrc/cell_join.cu``) on the card.

Run from the repository root on a machine with an NVIDIA H100:

    PYTHONPATH=src python3 scripts/b4_variants.py

Each variant replaces the kernel body of ``cell_join.cu`` and keeps the
rest of the file (the launch, the dtypes, the width template). All are
built with the repository's nvcc flags into ``build/b4_variants/`` and
launched raw (ctypes, no wrapper) on the unfused sweep's launches of the
main path (2,000,000 points, f64 and float16) and of uniform-2d (bfloat16),
each checked against the plain version, then timed by CUDA events over 20
back-to-back passes, three rounds in turns. Variants:

  step           the kernel as it is: one step of 32 slots a warp at a
                 time, shuffle, load, refine, ballot
  step_vec       the same, a slot's lanes read as one 4/8/16-byte vector
  defer          every step's loads and refines first, the ballots last
  defer_vec      the same with vector loads
  prefetch       the next step's lanes loaded before this step's refine
  prefetch_vec   the same with vector loads
  prefetch_cs    prefetch with streaming (evict-first) candidate loads
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import grid, metric  # noqa: E402
from repro_torch.kernels import build, cell_join as cj  # noqa: E402
from repro_torch.kernels.fused_join import DTYPE_CODES  # noqa: E402

OUT = ROOT / "build" / "b4_variants"

HELPERS = r'''
template <int B> struct VecOf;
template <> struct VecOf<4> { using V = unsigned; };
template <> struct VecOf<8> { using V = uint2; };
template <> struct VecOf<16> { using V = uint4; };

template <typename T, int N, bool VEC, bool STREAM = false>
__device__ __forceinline__ void load_row(const T* p, T (&v)[N]) {
  constexpr int B = N * (int)sizeof(T);
  if constexpr (VEC && (B == 4 || B == 8 || B == 16)) {
    using V = typename VecOf<B>::V;
    const V x = STREAM ? __ldcs(reinterpret_cast<const V*>(p))
                       : __ldg(reinterpret_cast<const V*>(p));
    memcpy(&v[0], &x, B);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = STREAM ? __ldcs(p + k) : p[k];
  }
}
'''

PROLOGUE = r'''template <typename T, int N, int W>
__global__ void __launch_bounds__(kThreads) cell_join_kernel(
    const T* __restrict__ q, const T* __restrict__ cand,
    const uint8_t* __restrict__ valid, const T* __restrict__ scal,
    int8_t* __restrict__ out,
    unsigned slots, unsigned c, unsigned q32, unsigned r32, int n_rt) {
  using L = Lane<T>;
  using A = typename L::A;
  using V = typename Word<W>::V;
  constexpr int NL = N ? N : 8;
  const int n = N ? N : n_rt;
  const T eps2 = scal[0];
  const unsigned lane = threadIdx.x & 31;
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  const bool own = g * W < slots;
  unsigned vbits = 0;
  if (own) {
    const V v = reinterpret_cast<const V*>(valid)[g];
#pragma unroll
    for (int b = 0; b < W; ++b)
      if ((static_cast<unsigned long long>(v) >> (8 * b)) & 0xffu)
        vbits |= 1u << b;
  }
  unsigned s = (g - lane) * W + lane;
  unsigned row = s / c;
  unsigned col = s - row * c;
  unsigned ball[W];
'''

EPILOGUE = r'''  if (!own) return;
  unsigned mine = 0;
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i == static_cast<int>((lane * W) >> 5)) mine = ball[i];
  mine >>= (lane * W) & 31u;
  V o = 0;
#pragma unroll
  for (int b = 0; b < W; ++b)
    o |= static_cast<V>(static_cast<V>((mine >> b) & 1u) << (8 * b));
  reinterpret_cast<V*>(out)[g] = o;
}

'''

STEP = r'''    s += 32;
    row += q32;
    col += r32;
    if (col >= c) {
      col -= c;
      ++row;
    }
'''

SHUFFLE = r'''    const unsigned vb =
        __shfl_sync(kFullMask, vbits, i * (32 / W) + lane / W);
'''


def refine(vec: str) -> str:
    return r'''      A d2 = A(0);
      if constexpr (N > 0) {
        T qv[NL], cv[NL];
        load_row<T, NL, VEC>(q + (size_t)row * N, qv);
        load_row<T, NL, VEC>(cand + (size_t)s * N, cv);
#pragma unroll
        for (int k = 0; k < NL; ++k) d2 = L::add(d2, L::sq(qv[k], cv[k]));
      } else {
        const T* qr = q + (size_t)row * n;
        const T* cr = cand + (size_t)s * n;
        for (int k = 0; k < n; ++k) d2 = L::add(d2, L::sq(qr[k], cr[k]));
      }
      hit = L::le(d2, eps2);
'''.replace("VEC", vec)


def per_step(vec: str) -> str:
    return (PROLOGUE + "#pragma unroll\n  for (int i = 0; i < W; ++i) {\n"
            + SHUFFLE + "    bool hit = false;\n"
            "    if (s < slots && ((vb >> (lane % W)) & 1u)) {\n"
            + refine(vec) + "    }\n"
            "    ball[i] = __ballot_sync(kFullMask, hit);\n"
            + STEP + "  }\n" + EPILOGUE)


def deferred(vec: str) -> str:
    return (PROLOGUE + "  unsigned okm = 0;\n#pragma unroll\n"
            "  for (int i = 0; i < W; ++i) {\n" + SHUFFLE
            + "    if (s + 32u * i < slots && ((vb >> (lane % W)) & 1u))\n"
            "      okm |= 1u << i;\n  }\n  unsigned hm = 0;\n"
            "#pragma unroll\n  for (int i = 0; i < W; ++i) {\n"
            "    bool hit = false;\n    if ((okm >> i) & 1u) {\n"
            + refine(vec) + "    }\n    hm |= (hit ? 1u : 0u) << i;\n"
            + STEP + "  }\n#pragma unroll\n  for (int i = 0; i < W; ++i)\n"
            "    ball[i] = __ballot_sync(kFullMask, (hm >> i) & 1u);\n"
            + EPILOGUE)


def prefetch(vec: str, stream: str = "false") -> str:
    body = r'''  if constexpr (N > 0) {
    T qv[NL], cv[NL];
    unsigned vb = __shfl_sync(kFullMask, vbits, lane / W);
    bool ok = s < slots && ((vb >> (lane % W)) & 1u);
    if (ok) {
      load_row<T, NL, VEC>(q + (size_t)row * N, qv);
      load_row<T, NL, VEC, STREAM>(cand + (size_t)s * N, cv);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      T qn[NL], cn[NL];
      bool okn = false;
      unsigned sn = s + 32, rown = row + q32, coln = col + r32;
      if (coln >= c) {
        coln -= c;
        ++rown;
      }
      if (i + 1 < W) {
        vb = __shfl_sync(kFullMask, vbits, (i + 1) * (32 / W) + lane / W);
        okn = sn < slots && ((vb >> (lane % W)) & 1u);
        if (okn) {
          load_row<T, NL, VEC>(q + (size_t)rown * N, qn);
          load_row<T, NL, VEC, STREAM>(cand + (size_t)sn * N, cn);
        }
      }
      bool hit = false;
      if (ok) {
        A d2 = A(0);
#pragma unroll
        for (int k = 0; k < NL; ++k) d2 = L::add(d2, L::sq(qv[k], cv[k]));
        hit = L::le(d2, eps2);
      }
      ball[i] = __ballot_sync(kFullMask, hit);
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        qv[k] = qn[k];
        cv[k] = cn[k];
      }
      ok = okn;
      s = sn;
      row = rown;
      col = coln;
    }
  } else {
'''.replace("VEC", vec).replace("STREAM", stream)
    rest = ("#pragma unroll\n  for (int i = 0; i < W; ++i) {\n" + SHUFFLE
            + "    bool hit = false;\n"
            "    if (s < slots && ((vb >> (lane % W)) & 1u)) {\n"
            + refine("false") + "    }\n"
            "    ball[i] = __ballot_sync(kFullMask, hit);\n"
            + STEP + "  }\n  }\n")
    return PROLOGUE + body + rest + EPILOGUE


VARIANTS = {"step": per_step("false"), "step_vec": per_step("true"),
            "defer": deferred("false"), "defer_vec": deferred("true"),
            "prefetch": prefetch("false"), "prefetch_vec": prefetch("true"),
            "prefetch_cs": prefetch("false", "true")}


def write_and_build(names) -> dict:
    """Each variant's source from the repository's ``cell_join.cu``, built
    with ``build.NVCC_FLAGS``; returns {name: loaded library}."""
    src = (build.CSRC / "cell_join.cu").read_text()
    a = src.index("// Thread g owns slots")
    b = src.index("template <typename T, int N, int W>\nvoid launch_chunks")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(src[:a] + HELPERS + VARIANTS[name] + src[b:])
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
               str(OUT / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.cell_join_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.cell_join_launch.restype = ctypes.c_int
        libs[name] = lib
        regs = cs.ptxas_by_kernel(log, "cell_join_kernel")
        print(name, {k: regs.get(k) for k in ("f64_n2_w8", "f16_n2_w8",
                                              "bf16_n2_w8")}, flush=True)
    return libs


def launches(pts, eps):
    index = grid.build_grid(pts, eps, device=cs.DEVICE)
    return (cs.unfused_launches(index),
            metric.device_refine_scalar("l2", index.eps, pts.dtype,
                                        pts.device))


def main() -> int:
    if not torch.cuda.is_available():
        print("b4_variants: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line(), flush=True)
    libs = write_and_build(sys.argv[1:] or list(VARIANTS))
    raw = cs.syn(cs.MAIN_POINTS, cs.MAIN_DIMS)
    u2d, u2d_eps = cs.bench_workloads()["uniform-2d"]
    cases = {
        "f64 main 2,000,000 x 32 x 2": launches(
            torch.as_tensor(raw).to(cs.DEVICE), cs.MAIN_EPS),
        "f16 main 2,000,000 x 32 x 2": launches(
            cs.as_half(raw, torch.float16).to(cs.DEVICE), cs.MAIN_EPS),
        "bf16 uniform-2d 100,000 x 16 x 2": launches(
            cs.as_half(u2d, torch.bfloat16).to(cs.DEVICE), u2d_eps)}
    stream = torch.cuda.current_stream().cuda_stream
    for case, (ls, scal) in cases.items():
        outs = [torch.empty(v.shape, dtype=torch.int8, device=cs.DEVICE)
                for _, _, v in ls]
        want = [cj._cell_join_hits_reference(q, cand, v, scal)
                for q, cand, v in ls]

        def one_pass(lib):
            for (q, cand, v), o in zip(ls, outs):
                b, c, n = cand.shape
                err = lib.cell_join_launch(
                    DTYPE_CODES[q.dtype], q.data_ptr(), cand.data_ptr(),
                    v.data_ptr(), scal.data_ptr(), o.data_ptr(), b, c, n,
                    stream)
                cs.check(err == 0, f"launch failed: CUDA error {err}")

        runs = {}
        for rnd in range(3):
            for name, lib in libs.items():
                one_pass(lib)
                cs.sync()
                if rnd == 0:
                    cs.check(all(torch.equal(o.view(torch.bool), w)
                                 for o, w in zip(outs, want)),
                             f"{name} differs from the plain version")
                runs.setdefault(name, []).append(
                    cs.event_ms(lambda: one_pass(lib), 20) / len(ls))
        for name, r in runs.items():
            print(f"{case}: {name} {statistics.median(r):.5f} ms a launch "
                  f"(runs {', '.join(f'{x:.5f}' for x in r)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
