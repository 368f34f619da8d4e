// The self-join's emit for Hopper (sm_90a): the hit plane of one fused
// launch compacted into its ordered pairs.
//
// Replaces no Pallas kernel: the JAX package's emit
// (repro/core/selfjoin.py, the fill after the fused count) is plain jnp,
// and so was this port's until this kernel, a step-wise scatter in which
// every slot of the plane, live or dead, wrote an int64 index
// (repro_torch/core/selfjoin.py::_emit_from_hits, the plain version this
// kernel is held to bit for bit and row for row).
//
// For every hit (o, q, s) of the (n_off, qp, c) int8 plane, with rows in
// query-major order (per query: offsets in sweep order, slots in window
// order), the pair of the query and its candidate goes to
//
//   pos  = tile_base[q / tq] + slot_base[q] + (the hit's rank in its row)
//   cand = min(win_start[o, q] + s, npts - 1)
//   qid  = ids[min(q_pos[q], npts - 1)],  cid = ids[cand]
//
// as the row (qid, cid) at pos, or with UNICOMP as (qid, cid) at 2 pos and
// (cid, qid) at 2 pos + 1. slot_base is B1's exclusive scan of counts in
// each tile and tile_base the exclusive scan of the tile totals, so the
// rows of a launch fill the output in row order without a gap: a warp
// that holds consecutive rows writes one contiguous range.
//
// Bound on the H100 by bytes: the plane is read once (n_off * qp * c
// bytes) and the pairs written once (8 bytes a pair), against no
// arithmetic to speak of. Syn6D2M's 3.93 GB plane holds 8.66 M hits, so
// nearly all of its bytes are reads of dead slots.
//
// Design. A row is the n_off * c slots of one query; a group of G lanes
// takes a row, G the smallest power of two, at most 32, holding the row's
// V-byte vectors (row_layout in kernels/emit_pairs.py), so a warp takes
// 32 / G consecutive rows a step and a long row in steps of 32 vectors.
// A lane reads V bytes at once (V the largest power of two up to 16
// dividing c and the plane's address), turns them into a bit mask of the
// live slots (__vcmpne4), and a warp prefix sum of the masks' popcounts
// (shuffles) ranks every hit of the step. The live pairs are staged in
// shared memory in rank order and stored by the whole warp to consecutive
// addresses, 16 bytes a lane with UNICOMP (both ordered rows of a hit), 8
// without. A step whose rows count no hit reads nothing of the plane, and
// a row stops at the step that finds its last hit. Offsets into the plane
// and the output are 64-bit. No slot that is not a hit writes anything.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;

// bit b set where byte b of w is nonzero (b = 0..3)
__device__ __forceinline__ unsigned live_bits4(unsigned w) {
  unsigned x = __vcmpne4(w, 0u) & 0x01010101u;
  return (x * 0x01020408u) >> 24;
}

// The live-slot mask of V consecutive plane bytes at p (aligned to V).
template <int V>
__device__ __forceinline__ unsigned live_mask(const uint8_t* p) {
  if constexpr (V == 16) {
    uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    return live_bits4(w.x) | (live_bits4(w.y) << 4) |
           (live_bits4(w.z) << 8) | (live_bits4(w.w) << 12);
  } else if constexpr (V == 8) {
    uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    return live_bits4(w.x) | (live_bits4(w.y) << 4);
  } else if constexpr (V == 4) {
    return live_bits4(__ldg(reinterpret_cast<const unsigned*>(p)));
  } else if constexpr (V == 2) {
    return live_bits4(__ldg(reinterpret_cast<const unsigned short*>(p)));
  } else {
    return __ldg(p) != 0 ? 1u : 0u;
  }
}

template <int V, bool kUnicomp>
__global__ void __launch_bounds__(kThreads)
emit_pairs_kernel(const uint8_t* __restrict__ hits,
                  const int* __restrict__ counts,
                  const int* __restrict__ slot_base,
                  const long long* __restrict__ tile_base,
                  const int* __restrict__ win_start,
                  const int* __restrict__ q_pos,
                  const int* __restrict__ ids, int* __restrict__ out,
                  long long qp, int n_off, int c, int tq, int npts,
                  long long n_hits, int group_log2, long long n_steps) {
  __shared__ int2 stage[kWarps][32 * V];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = 1 << group_log2;
  const int rows = 32 >> group_log2;          // rows a warp step
  const int gl = lane & (group - 1);          // lane within its row
  const int cv = c / V;                       // vectors an offset
  const int nv = n_off * cv;                  // vectors a row
  const int iters = (nv + group - 1) / group; // 1 unless a warp a row
  int2* st = stage[warp];
  for (long long step = static_cast<long long>(blockIdx.x) * kWarps + warp;
       step < n_steps; step += static_cast<long long>(gridDim.x) * kWarps) {
    const long long q0 = step * rows;
    const long long q = q0 + (lane >> group_log2);
    const int cnt = q < qp ? __ldg(counts + q) : 0;
    // hits of the step's rows, summed over one lane of each row
    const unsigned need = __reduce_add_sync(
        kFullMask, gl == 0 ? static_cast<unsigned>(cnt) : 0u);
    if (need == 0) continue;
    const long long base =
        __ldg(tile_base + q0 / tq) + __ldg(slot_base + q0);
    int qid = 0;
    if (cnt > 0) qid = __ldg(ids + min(__ldg(q_pos + q), npts - 1));
    const uint8_t* row = hits + q * c;
    const int* ws_row = win_start + q;
    long long done = 0;                       // hits of the step written
    for (int it = 0; it < iters; ++it) {
      const int v = it * group + gl;
      unsigned m = 0;
      int o = 0, s0 = 0;
      if (cnt > 0 && v < nv) {
        o = v / cv;
        s0 = (v - o * cv) * V;
        m = live_mask<V>(row + static_cast<long long>(o) * qp * c + s0);
      }
      const int k = __popc(m);
      int incl = k;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += y;
      }
      const int total = __shfl_sync(kFullMask, incl, 31);
      if (m) {
        const int start =
            __ldg(ws_row + static_cast<long long>(o) * qp) + s0;
        int r = incl - k;
        do {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          st[r++] = make_int2(qid, __ldg(ids + min(start + b, npts - 1)));
        } while (m);
      }
      __syncwarp();
      for (int i = lane; i < total; i += 32) {
        const long long pos = base + done + i;
        if (pos < n_hits) {
          const int2 e = st[i];
          if constexpr (kUnicomp) {
            reinterpret_cast<int4*>(out)[pos] =
                make_int4(e.x, e.y, e.y, e.x);
          } else {
            reinterpret_cast<int2*>(out)[pos] = e;
          }
        }
      }
      __syncwarp();
      done += total;
      if (done >= need) break;
    }
  }
}

using Kernel = void (*)(const uint8_t*, const int*, const int*,
                        const long long*, const int*, const int*, const int*,
                        int*, long long, int, int, int, int, long long, int,
                        long long);

template <int V>
Kernel pick(bool unicomp) {
  return unicomp ? emit_pairs_kernel<V, true> : emit_pairs_kernel<V, false>;
}

}  // namespace

// One launch's pairs into out ((unicomp ? 2 : 1) * n_hits, 2) int32; vec is
// V and group_log2 log2(G) of kernels/emit_pairs.py::row_layout. Returns
// the CUDA error of the launch (0 when it was accepted).
extern "C" int emit_pairs_launch(const void* hits, const void* counts,
                                 const void* slot_base, const void* tile_base,
                                 const void* win_start, const void* q_pos,
                                 const void* ids, void* out, long long qp,
                                 int n_off, int c, int tq, int npts,
                                 long long n_hits, int vec, int group_log2,
                                 int unicomp, void* stream) {
  if (qp <= 0 || n_off <= 0 || c <= 0 || tq <= 0 || qp % tq || npts <= 0 ||
      n_hits < 0 || group_log2 < 0 || group_log2 > 5 || vec <= 0 || c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel kernel;
  switch (vec) {
    case 16: kernel = pick<16>(unicomp != 0); break;
    case 8: kernel = pick<8>(unicomp != 0); break;
    case 4: kernel = pick<4>(unicomp != 0); break;
    case 2: kernel = pick<2>(unicomp != 0); break;
    case 1: kernel = pick<1>(unicomp != 0); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  // one warp step a warp of the grid: 32 / G rows
  const long long n_steps = ((qp << group_log2) + 31) / 32;
  const long long blocks = (n_steps + kWarps - 1) / kWarps;
  const unsigned grid =
      static_cast<unsigned>(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hits), static_cast<const int*>(counts),
      static_cast<const int*>(slot_base),
      static_cast<const long long*>(tile_base),
      static_cast<const int*>(win_start), static_cast<const int*>(q_pos),
      static_cast<const int*>(ids), static_cast<int*>(out), qp, n_off, c, tq,
      npts, n_hits, group_log2, n_steps);
  return static_cast<int>(cudaGetLastError());
}
