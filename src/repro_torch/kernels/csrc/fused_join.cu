// Fused gather-refine kernel of the L2 epsilon self-join, for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_join.py::_fused_kernel, the Pallas TPU kernel,
// for the l2 metric: per-cell and merged sweeps, UNICOMP on and off, with and
// without the hits plane, in float64 and float32. It computes what
// repro_torch/kernels/fused_join.py::_fused_join_hits_reference computes, bit
// for bit:
//
//   for every query row and stencil offset j, the window
//   points_pad[win_start[j, row] : + c] is refined against the row,
//     d2 = 0; for k < n_real: t = q[k] - p[k]; d2 = d2 + t * t   (this order)
//     hit = d2 <= eps2 && slot < win_count[j, row]
//   then masked: merged sweeps need |p[n_real] - q[n_real]| <= 1 (last-dim
//   cell coordinates ride lane n_real as exact floats); UNICOMP keeps
//   cand > q_pos on the zero offset; without UNICOMP, cand != q_pos.
//   Outputs: int8 hits (n_off, qp, c), per-row counts summed over offsets,
//   and slot_base, the exclusive scan of the counts within each tq-row tile.
//
// Rounding: every add, subtract and multiply is an explicit round-to-nearest
// intrinsic, and the library is built with -fmad=false, because the plain
// PyTorch version is an unfused IEEE sequence. A contracted multiply-add
// would flip pairs whose d2 lies within an ulp of eps2.
//
// What bounds it on the H100: bytes. Per slot it writes one int8 hit and
// reads one candidate row (n_real + 1 lanes), against 3 * n_real floating
// point operations; the hits plane alone is n_off * qp * c bytes. FP64 is
// native on Hopper (no tensor cores needed for this arithmetic), so f64 stays
// f64 end to end, unlike the TPU kernel, which computes in f32.
//
// Design (simple first, made faster in later work):
//   * one thread block per tq-row query tile; the stencil-offset loop runs
//     inside the block, so the block owns its rows' counts across all
//     offsets and no reduction crosses blocks. This replaces the TPU's
//     sequential offset grid axis and its VMEM-resident counts.
//   * the tile's query rows and q_pos are staged once in shared memory; each
//     offset's win_start / win_count are staged per offset (the TPU kernel
//     prefetched them as scalars).
//   * threads stride over the tile's (row, slot) pairs, so neighbouring
//     threads write neighbouring hit bytes and read neighbouring window rows.
//   * counts accumulate with shared-memory atomics (integer sums are exact
//     in any order); the per-tile exclusive scan runs after the last offset.
//   * no double-buffered window copies yet: windows are read straight from
//     global memory through L1/L2 (the TPU kernel's two-slot DMA pipeline is
//     the later cp.async/TMA work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

template <typename T, bool MERGED, bool UNICOMP, bool KEEP_HITS>
__global__ void __launch_bounds__(kThreads) fused_join_kernel(
    const T* __restrict__ points_pad,   // (rows, lanes)
    const T* __restrict__ q_batch,      // (qp, lanes)
    const int* __restrict__ win_start,  // (n_off, qp)
    const int* __restrict__ win_count,  // (n_off, qp)
    const int* __restrict__ is_zero,    // (n_off,)
    const int* __restrict__ q_pos,      // (qp,)
    const T* __restrict__ scal,         // (1,) eps^2 in T
    int8_t* __restrict__ hits,          // (n_off, qp, c), KEEP_HITS only
    int* __restrict__ counts,           // (qp,)
    int* __restrict__ slot_base,        // (qp,)
    int n_off, int qp, int c, int n_real, int lanes, int tq) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                        // tq * lanes
  int* cnt_s = reinterpret_cast<int*>(q_s + (size_t)tq * lanes);  // tq
  int* ws_s = cnt_s + tq;                                     // tq
  int* wc_s = ws_s + tq;                                      // tq
  int* qpos_s = wc_s + tq;                                    // tq

  const int row0 = blockIdx.x * tq;
  for (int i = threadIdx.x; i < tq * lanes; i += blockDim.x)
    q_s[i] = q_batch[(size_t)row0 * lanes + i];
  for (int r = threadIdx.x; r < tq; r += blockDim.x) {
    cnt_s[r] = 0;
    qpos_s[r] = q_pos[row0 + r];
  }
  const T eps2 = scal[0];
  const int work = tq * c;

  for (int j = 0; j < n_off; ++j) {
    __syncthreads();  // the previous offset's readers of ws_s / wc_s are done
    for (int r = threadIdx.x; r < tq; r += blockDim.x) {
      ws_s[r] = win_start[(size_t)j * qp + row0 + r];
      wc_s[r] = win_count[(size_t)j * qp + row0 + r];
    }
    __syncthreads();
    const bool zero = is_zero[j] != 0;
    int8_t* hits_j = hits + ((size_t)j * qp + row0) * c;
    for (int idx = threadIdx.x; idx < work; idx += blockDim.x) {
      const int r = idx / c;
      const int s = idx - r * c;
      bool hit = false;
      if (s < wc_s[r]) {
        const int cand = ws_s[r] + s;
        const T* p = points_pad + (size_t)cand * lanes;
        const T* q = q_s + r * lanes;
        T d2 = T(0);
        for (int k = 0; k < n_real; ++k) {
          const T t = sub_rn(q[k], p[k]);
          d2 = add_rn(d2, mul_rn(t, t));
        }
        hit = d2 <= eps2;
        if (MERGED) hit = hit && fabs(sub_rn(p[n_real], q[n_real])) <= T(1);
        if (UNICOMP) hit = hit && (!zero || cand > qpos_s[r]);
        else hit = hit && cand != qpos_s[r];
      }
      if (KEEP_HITS) hits_j[idx] = hit ? 1 : 0;
      if (hit) atomicAdd(&cnt_s[r], 1);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < tq; r += blockDim.x) {
    int excl = 0;
    for (int k = 0; k < r; ++k) excl += cnt_s[k];
    counts[row0 + r] = cnt_s[r];
    slot_base[row0 + r] = excl;
  }
}

struct Args {
  const void* points_pad; const void* q_batch;
  const void* win_start; const void* win_count; const void* is_zero;
  const void* q_pos; const void* scal;
  void* hits; void* counts; void* slot_base;
  int n_off, qp, c, n_real, lanes, tq;
};

template <typename T, bool MERGED, bool UNICOMP, bool KEEP_HITS>
void launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.tq * a.lanes * sizeof(T) + 4 * a.tq * sizeof(int);
  fused_join_kernel<T, MERGED, UNICOMP, KEEP_HITS>
      <<<a.qp / a.tq, kThreads, smem, stream>>>(
          static_cast<const T*>(a.points_pad), static_cast<const T*>(a.q_batch),
          static_cast<const int*>(a.win_start), static_cast<const int*>(a.win_count),
          static_cast<const int*>(a.is_zero), static_cast<const int*>(a.q_pos),
          static_cast<const T*>(a.scal), static_cast<int8_t*>(a.hits),
          static_cast<int*>(a.counts), static_cast<int*>(a.slot_base),
          a.n_off, a.qp, a.c, a.n_real, a.lanes, a.tq);
}

template <typename T, bool MERGED, bool UNICOMP>
void launch_keep(const Args& a, bool keep_hits, cudaStream_t s) {
  if (keep_hits) launch<T, MERGED, UNICOMP, true>(a, s);
  else launch<T, MERGED, UNICOMP, false>(a, s);
}

template <typename T, bool MERGED>
void launch_unicomp(const Args& a, bool unicomp, bool keep_hits, cudaStream_t s) {
  if (unicomp) launch_keep<T, MERGED, true>(a, keep_hits, s);
  else launch_keep<T, MERGED, false>(a, keep_hits, s);
}

template <typename T>
void launch_merged(const Args& a, bool merged, bool unicomp, bool keep_hits,
                   cudaStream_t s) {
  if (merged) launch_unicomp<T, true>(a, unicomp, keep_hits, s);
  else launch_unicomp<T, false>(a, unicomp, keep_hits, s);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). The Python wrapper validates shapes and dtypes
// (qp % tq == 0, lanes > n_real when merged); the self-join driver pads
// points_pad with a tail of at least c rows, so every window read is in bounds.
extern "C" int fused_join_launch(
    int is_double, int merged, int unicomp, int keep_hits,
    const void* points_pad, const void* q_batch, const void* win_start,
    const void* win_count, const void* is_zero, const void* q_pos,
    const void* scal, void* hits, void* counts, void* slot_base,
    int n_off, int qp, int c, int n_real, int lanes, int tq, void* stream) {
  Args a{points_pad, q_batch, win_start, win_count, is_zero, q_pos, scal,
         hits, counts, slot_base, n_off, qp, c, n_real, lanes, tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) launch_merged<double>(a, merged, unicomp, keep_hits, s);
  else launch_merged<float>(a, merged, unicomp, keep_hits, s);
  return static_cast<int>(cudaGetLastError());
}
