// Masked direct-difference refine of the unfused offset sweep for Hopper
// (sm_90a): kernel B4 of distance_impl="pallas".
//
// Replaces repro/kernels/cell_join.py::_cell_join_kernel, the Pallas TPU
// kernel. For every (row, slot) of one stencil offset's gathered candidates
//
//   d2 = 0;  for k in 0..n-1: t = q[row, k] - cand[row, slot, k]; d2 = d2 + t*t
//   hit = d2 <= eps2  and  valid[row, slot]
//
// in the input's dtype, lane by lane in lane order: the order of
// repro_torch/kernels/cell_join.py::_cell_join_hits_reference, bit for bit.
// Every subtract, multiply and add is an explicit round-to-nearest intrinsic
// and the library is built with -fmad=false, so no multiply-add is
// contracted. float16 and bfloat16 (__half, __nv_bfloat16) follow the Pallas
// kernel's jnp.sum(d * d) as XLA computes it on the CPU: t is computed in
// float32 and rounds to the half dtype (one rounding: float32's 24 bits are
// at least 2p + 2 for p = 11 and 8); t*t rounds to float16 for __half and
// stays the exact float32 product for __nv_bfloat16; the squares add in
// float32 in lane order, and the sum rounds to the half dtype once before
// the comparison.
//
// Design, a first and simple one: one thread per (row, slot), over a
// grid-stride loop with 64-bit offsets (B * C * n passes 2^31 at 10 M
// points). A thread reads its valid byte and, only where it is set, its
// row's n query lanes (shared by the C threads of the row, so served by L1)
// and its candidate's n lanes; it writes one byte. Neighbouring threads read
// neighbouring candidates, so the candidate reads, the valid reads and the
// stores are coalesced, and the sweep's valid slots (a prefix of each row's
// C) leave the sectors of the invalid ones unread. n is a runtime argument
// and the ragged edge is the loop bound: the TPU kernel's padding of B to
// 512 rows and of the lanes to 8 has no counterpart here.
//
// Bound on the H100 by bytes: the 32-byte sectors of the valid slots'
// candidates, q, and one valid byte and one output byte a slot, against 3n
// floating-point operations a valid slot (at n = 2, f64: 16 candidate bytes
// against 6 operations, far below the card's ~10 FP64 operations a byte).
// The (B, C, n) candidate tensor it reads is the unfused sweep's own cost:
// the fused kernel (fused_join.cu) never builds it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// enough blocks to fill 132 SMs many times over; the loop covers the rest
constexpr long long kMaxBlocks = 132 * 64;

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

// d2 of one slot. float and double: the input dtype throughout. The half
// types: each difference rounds to the half dtype (round), a float16 square
// too (round_sq), the squares sum in float32, and the sum rounds once.
template <typename T>
struct Sum {
  using A = T;
  static __device__ __forceinline__ A load(T x) { return x; }
  static __device__ __forceinline__ A round(A x) { return x; }
  static __device__ __forceinline__ A round_sq(A x) { return x; }
};
template <>
struct Sum<__half> {
  using A = float;
  static __device__ __forceinline__ A load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ A round(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ A round_sq(float x) { return round(x); }
};
template <>
struct Sum<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ A round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ A round_sq(float x) { return x; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) cell_join_kernel(
    const T* __restrict__ q,            // (B, n)
    const T* __restrict__ cand,         // (B, C, n)
    const uint8_t* __restrict__ valid,  // (B, C) bool
    const T* __restrict__ scal,         // (1,) eps^2 in T
    int8_t* __restrict__ out,           // (B, C)
    long long slots, int c, int n) {
  using S = Sum<T>;
  using A = typename S::A;
  const A eps2 = S::load(scal[0]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       s < slots; s += stride) {
    int8_t hit = 0;
    if (valid[s] != 0) {  // an invalid slot's candidate is never read
      const T* qr = q + (s / c) * n;
      const T* cr = cand + s * n;
      A d2 = A(0);
      for (int k = 0; k < n; ++k) {
        const A t = S::round(sub_rn(S::load(qr[k]), S::load(cr[k])));
        d2 = add_rn(d2, S::round_sq(mul_rn(t, t)));
      }
      hit = S::round(d2) <= eps2 ? 1 : 0;
    }
    out[s] = hit;
  }
}

template <typename T>
void launch(const void* q, const void* cand, const void* valid,
            const void* scal, void* out, long long slots, int c, int n,
            cudaStream_t s) {
  long long blocks = (slots + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cell_join_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(cand),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(scal),
      static_cast<int8_t*>(out), slots, c, n);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted), or cudaErrorInvalidValue for an unknown dtype code. The Python
// wrapper checks dtypes, shapes and contiguity, and launches only when
// rows * c > 0.
extern "C" int cell_join_launch(int dtype, const void* q, const void* cand,
                                const void* valid, const void* scal, void* out,
                                long long rows, int c, int n, void* stream) {
  if (rows <= 0 || c <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long slots = rows * c;
  switch (dtype) {
    case kFloat32: launch<float>(q, cand, valid, scal, out, slots, c, n, s); break;
    case kFloat64: launch<double>(q, cand, valid, scal, out, slots, c, n, s); break;
    case kFloat16: launch<__half>(q, cand, valid, scal, out, slots, c, n, s); break;
    case kBFloat16:
      launch<__nv_bfloat16>(q, cand, valid, scal, out, slots, c, n, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
