// Tiled brute-force epsilon distances for Hopper (sm_90a): the hits tile and
// the count tile of the paper's GPU brute-force baseline (SVI-B).
//
// Replaces repro/kernels/distance_tile.py::_hits_kernel and ::_count_kernel,
// the Pallas TPU kernels. Both compute the expanded form the TPU kernels
// compute on the MXU, in the order of
// repro_torch/kernels/distance_tile.py::_expanded_d2, bit for bit:
//
//   qn = q0*q0 + q1*q1 + ...      (lane by lane, left to right)
//   pn = p0*p0 + p1*p1 + ...
//   cross = q0*p0 + q1*p1 + ...
//   d2 = (qn + pn) - 2 * cross;   hit = d2 <= eps2
//
// in float64 for float64 input, else float32. float16 and bfloat16 input
// (B2-bf16: __half, __nv_bfloat16 rows) is loaded and converted to float32,
// exactly, and the float32 form runs on it, as the TPU kernels upcast to
// their float32 accumulator (_acc_dtype); eps2 arrives squared at the half
// dtype, as the JAX package squares it, and is widened the same way. A
// product of two half values is exact in float32, so only the order of the
// float32 sums has to match the plain version's. Every add, subtract and
// multiply is an explicit round-to-nearest intrinsic and the library is built
// with -fmad=false, so no multiply-add is contracted. The cross term is
// computed here, not by a library product: at a contraction depth of 1-8 a
// matrix-multiply routine is the wrong tool, and FP64 tensor cores (mma.sync
// m8n8k4) would need the plain version to follow their order.
//
// distance_tile_hits_kernel (B2): one block per (query tile, candidate tile).
//   It stages both tiles' rows and their squared norms in shared memory, and
//   neighbouring threads write neighbouring int8 bytes of one query row of
//   the (nq, N) output. Bound on the H100 by bytes: one output byte per pair
//   against 2n + 2 FP64 operations, and the byte plane is written once.
//   Only real rows and columns are computed and written: the TPU kernel's
//   padding candidates (at 1e9, never a hit; +inf at float16, where their
//   d2 is inf or NaN and still no hit) are sliced off its output, so they
//   have no counterpart here.
//
// distance_tile_counts_kernel (B3): one block per tile of tq query rows, one
//   thread per query row, with the loop over candidate tiles inside the
//   block. A thread keeps its row and its count in registers, so no
//   reduction crosses blocks: this replaces the TPU kernel's sequential
//   candidate-tile grid axis, which kept the counts in VMEM. The block stages
//   each candidate tile and its norms in shared memory, read by all threads
//   at once (a broadcast). Bound by operations: N^2 pairs x (2n + 2) FP64
//   operations, with O(N) bytes in and out. The mask is col < N (the loop
//   bound) and col != row, as the TPU kernel's (row < N is the thread's own).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// Row dtypes, as kernels/fused_join.py numbers them (DTYPE_CODES).
constexpr int kFloat32 = 0;
constexpr int kFloat64 = 1;
constexpr int kFloat16 = 2;
constexpr int kBFloat16 = 3;

// The type a row type T computes in (A) and its exact widening (load):
// float32 for the half types, T itself otherwise.
template <typename T>
struct Acc {
  using A = T;
  static __device__ __forceinline__ A load(T x) { return x; }
};
template <>
struct Acc<__half> {
  using A = float;
  static __device__ __forceinline__ A load(__half x) { return __half2float(x); }
};
template <>
struct Acc<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

template <typename T, int N>
__device__ __forceinline__ T sq_norm(const T* x) {
  T acc = mul_rn(x[0], x[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) acc = add_rn(acc, mul_rn(x[k], x[k]));
  return acc;
}

template <typename T, int N>
__device__ __forceinline__ bool expanded_hit(const T* q, T qn, const T* p,
                                             T pn, T eps2) {
  T cross = mul_rn(q[0], p[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) cross = add_rn(cross, mul_rn(q[k], p[k]));
  const T d2 = sub_rn(add_rn(qn, pn), mul_rn(T(2), cross));
  return d2 <= eps2;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) distance_tile_hits_kernel(
    const T* __restrict__ q,      // (nq, N)
    const T* __restrict__ pts,    // (npts, N)
    const T* __restrict__ scal,   // (1,) eps^2 in T
    int8_t* __restrict__ out,     // (nq, npts)
    int nq, int npts, int tq, int tc) {
  using A = typename Acc<T>::A;
  extern __shared__ __align__(16) unsigned char smem[];
  A* q_s = reinterpret_cast<A*>(smem);   // tq * N
  A* p_s = q_s + (size_t)tq * N;         // tc * N
  A* qn_s = p_s + (size_t)tc * N;        // tq
  A* pn_s = qn_s + tq;                   // tc
  const int i0 = blockIdx.y * tq;
  const int j0 = blockIdx.x * tc;
  const int rows = min(tq, nq - i0);
  const int cols = min(tc, npts - j0);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    A v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = Acc<T>::load(q[(size_t)(i0 + r) * N + k]);
#pragma unroll
    for (int k = 0; k < N; ++k) q_s[r * N + k] = v[k];
    qn_s[r] = sq_norm<A, N>(v);
  }
  for (int r = threadIdx.x; r < cols; r += blockDim.x) {
    A v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = Acc<T>::load(pts[(size_t)(j0 + r) * N + k]);
#pragma unroll
    for (int k = 0; k < N; ++k) p_s[r * N + k] = v[k];
    pn_s[r] = sq_norm<A, N>(v);
  }
  __syncthreads();
  const A eps2 = Acc<T>::load(scal[0]);
  const int work = rows * cols;
  for (int idx = threadIdx.x; idx < work; idx += blockDim.x) {
    const int i = idx / cols;
    const int j = idx - i * cols;
    const bool hit = expanded_hit<A, N>(q_s + i * N, qn_s[i], p_s + j * N,
                                        pn_s[j], eps2);
    out[(size_t)(i0 + i) * npts + j0 + j] = hit ? 1 : 0;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) distance_tile_counts_kernel(
    const T* __restrict__ pts,    // (npts, N)
    const T* __restrict__ scal,   // (1,) eps^2 in T
    int* __restrict__ counts,     // (npts,)
    int npts, int tq, int tc) {
  using A = typename Acc<T>::A;
  extern __shared__ __align__(16) unsigned char smem[];
  A* p_s = reinterpret_cast<A*>(smem);   // tc * N
  A* pn_s = p_s + (size_t)tc * N;        // tc
  const A eps2 = Acc<T>::load(scal[0]);
  for (int g = 0; g < tq; g += blockDim.x) {
    const int row = blockIdx.x * tq + g + threadIdx.x;
    const bool live = g + (int)threadIdx.x < tq && row < npts;
    A qr[N];
    A qn = A(0);
    if (live) {
#pragma unroll
      for (int k = 0; k < N; ++k) qr[k] = Acc<T>::load(pts[(size_t)row * N + k]);
      qn = sq_norm<A, N>(qr);
    }
    int cnt = 0;
    for (int j0 = 0; j0 < npts; j0 += tc) {
      const int cols = min(tc, npts - j0);
      __syncthreads();   // the previous tile is read
      for (int r = threadIdx.x; r < cols; r += blockDim.x) {
        A v[N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = Acc<T>::load(pts[(size_t)(j0 + r) * N + k]);
#pragma unroll
        for (int k = 0; k < N; ++k) p_s[r * N + k] = v[k];
        pn_s[r] = sq_norm<A, N>(v);
      }
      __syncthreads();
      if (live) {
        for (int j = 0; j < cols; ++j) {
          const bool hit = expanded_hit<A, N>(qr, qn, p_s + j * N, pn_s[j],
                                              eps2);
          cnt += (hit && j0 + j != row) ? 1 : 0;
        }
      }
    }
    if (live) counts[row] = cnt;
  }
}

template <typename T, int N>
void launch_hits(const void* q, const void* pts, const void* scal, void* out,
                 int nq, int npts, int tq, int tc, cudaStream_t s) {
  const size_t smem = (size_t)(tq + tc) * (N + 1) * sizeof(typename Acc<T>::A);
  const dim3 grid((npts + tc - 1) / tc, (nq + tq - 1) / tq);
  distance_tile_hits_kernel<T, N><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(pts),
      static_cast<const T*>(scal), static_cast<int8_t*>(out), nq, npts, tq, tc);
}

template <typename T, int N>
void launch_counts(const void* pts, const void* scal, void* counts, int npts,
                   int tq, int tc, cudaStream_t s) {
  const size_t smem = (size_t)tc * (N + 1) * sizeof(typename Acc<T>::A);
  distance_tile_counts_kernel<T, N><<<(npts + tq - 1) / tq, kThreads, smem, s>>>(
      static_cast<const T*>(pts), static_cast<const T*>(scal),
      static_cast<int*>(counts), npts, tq, tc);
}

template <typename T>
int dispatch_hits(int n, const void* q, const void* pts, const void* scal,
                  void* out, int nq, int npts, int tq, int tc, cudaStream_t s) {
  switch (n) {
    case 1: launch_hits<T, 1>(q, pts, scal, out, nq, npts, tq, tc, s); break;
    case 2: launch_hits<T, 2>(q, pts, scal, out, nq, npts, tq, tc, s); break;
    case 3: launch_hits<T, 3>(q, pts, scal, out, nq, npts, tq, tc, s); break;
    case 4: launch_hits<T, 4>(q, pts, scal, out, nq, npts, tq, tc, s); break;
    case 5: launch_hits<T, 5>(q, pts, scal, out, nq, npts, tq, tc, s); break;
    case 6: launch_hits<T, 6>(q, pts, scal, out, nq, npts, tq, tc, s); break;
    case 7: launch_hits<T, 7>(q, pts, scal, out, nq, npts, tq, tc, s); break;
    case 8: launch_hits<T, 8>(q, pts, scal, out, nq, npts, tq, tc, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_counts(int n, const void* pts, const void* scal, void* counts,
                    int npts, int tq, int tc, cudaStream_t s) {
  switch (n) {
    case 1: launch_counts<T, 1>(pts, scal, counts, npts, tq, tc, s); break;
    case 2: launch_counts<T, 2>(pts, scal, counts, npts, tq, tc, s); break;
    case 3: launch_counts<T, 3>(pts, scal, counts, npts, tq, tc, s); break;
    case 4: launch_counts<T, 4>(pts, scal, counts, npts, tq, tc, s); break;
    case 5: launch_counts<T, 5>(pts, scal, counts, npts, tq, tc, s); break;
    case 6: launch_counts<T, 6>(pts, scal, counts, npts, tq, tc, s); break;
    case 7: launch_counts<T, 7>(pts, scal, counts, npts, tq, tc, s); break;
    case 8: launch_counts<T, 8>(pts, scal, counts, npts, tq, tc, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or cudaErrorInvalidValue for an unknown dtype code.
// The Python wrappers check dtypes, shapes (1 <= n <= 8, contiguous rows),
// grid limits and shared memory.
extern "C" int distance_tile_hits_launch(
    int dtype, int n, const void* q, const void* pts, const void* scal,
    void* out, int nq, int npts, int tq, int tc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_hits<float>(n, q, pts, scal, out, nq, npts, tq, tc, s);
    case kFloat64: return dispatch_hits<double>(n, q, pts, scal, out, nq, npts, tq, tc, s);
    case kFloat16: return dispatch_hits<__half>(n, q, pts, scal, out, nq, npts, tq, tc, s);
    case kBFloat16:
      return dispatch_hits<__nv_bfloat16>(n, q, pts, scal, out, nq, npts, tq, tc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int distance_tile_counts_launch(
    int dtype, int n, const void* pts, const void* scal, void* counts,
    int npts, int tq, int tc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_counts<float>(n, pts, scal, counts, npts, tq, tc, s);
    case kFloat64: return dispatch_counts<double>(n, pts, scal, counts, npts, tq, tc, s);
    case kFloat16: return dispatch_counts<__half>(n, pts, scal, counts, npts, tq, tc, s);
    case kBFloat16:
      return dispatch_counts<__nv_bfloat16>(n, pts, scal, counts, npts, tq, tc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
