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
// Design (redesigned for Hopper; the first design gave each thread one
// slot, found its row by a 64-bit division a slot and loaded and stored
// one byte a slot, so instructions, not bytes, set its time). A thread owns
// W consecutive slots of one row, W the largest power of two dividing C,
// at most kMaxWidth (slot_width): it reads their W valid bytes as one load
// and writes their W hit bytes as one store, both aligned since a row
// starts at byte row * C. The candidates are read warp-cooperatively, so
// the loads stay coalesced: a warp owns 32 * W consecutive slots, and in
// step i of W its lane L refines slot i * 32 + L of them (its valid bit
// comes from the owner by __shfl_sync); the step's hits are a
// __ballot_sync, and each owner takes its W bits from the step that holds
// them. A lane finds its slot's row by one 32-bit division a thread and
// then steps it by 32 slots (q32 = 32 / C rows, r32 = 32 % C slots), and
// reads the query row's n lanes through L1 (the C slots of a row share
// them). n is a template argument for n = 1..8 (0: at run time, beyond).
// More reads in flight a warp measured slower on the H100 (PERF.md §6):
// loading several steps' lanes before refining any, prefetching the next
// step, deferring the ballots, or 16-byte row loads.
// Indexes are 32-bit: a batch past 2^31 slots launches in row chunks of
// at most 2^31. The ragged edge is the slot bound: the TPU kernel's
// padding of B to 512 rows and of the lanes to 8 has no counterpart here.
//
// Half precision with native arithmetic where it rounds the same: at
// float16, __hsub_rn and __hmul_rn are the correctly rounded difference
// and square of rule S (one rounding each, as float32 then half gives);
// at bfloat16, __hsub_rn is the rounded difference and the square stays the
// exact float32 product. One conversion a lane feeds the float32 sum.
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
// the most slots a thread owns (the widest valid load and hit store)
constexpr int kMaxWidth = 8;
// slots one launch of 32-bit indexes covers; a larger batch launches in
// row chunks
constexpr long long kMaxSlots = 1LL << 31;
constexpr unsigned kFullMask = 0xffffffffu;

// Row dtypes, as kernels/fused_join.py numbers them (DTYPE_CODES).
constexpr int kFloat32 = 0;
constexpr int kFloat64 = 1;
constexpr int kFloat16 = 2;
constexpr int kBFloat16 = 3;

// W, the slots a thread owns: the largest power of two dividing c, at most
// kMaxWidth (kernels/cell_join.py::slot_width mirrors it).
int slot_width(int c) {
  int w = kMaxWidth;
  while (c % w) w /= 2;
  return w;
}

// W bytes as one word.
template <int W> struct Word;
template <> struct Word<1> { using V = uint8_t; };
template <> struct Word<2> { using V = uint16_t; };
template <> struct Word<4> { using V = uint32_t; };
template <> struct Word<8> { using V = unsigned long long; };

__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// One lane's square, the sum and the final test. float and double: the
// input dtype throughout. The half types: the difference rounds to the half
// dtype, a float16 square too, the squares sum in float32 (A), and the sum
// rounds once before the comparison.
template <typename T>
struct Lane {
  using A = T;
  static __device__ __forceinline__ A sq(T q, T p) {
    const T t = sub_rn(q, p);
    return mul_rn(t, t);
  }
  static __device__ __forceinline__ A add(A a, A b) { return add_rn(a, b); }
  static __device__ __forceinline__ bool le(A d2, T eps2) { return d2 <= eps2; }
};
template <>
struct Lane<__half> {
  using A = float;
  static __device__ __forceinline__ A sq(__half q, __half p) {
    const __half t = __hsub_rn(q, p);
    return __half2float(__hmul_rn(t, t));
  }
  static __device__ __forceinline__ A add(A a, A b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ bool le(A d2, __half eps2) {
    return __half2float(__float2half_rn(d2)) <= __half2float(eps2);
  }
};
template <>
struct Lane<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A sq(__nv_bfloat16 q, __nv_bfloat16 p) {
    const float t = __bfloat162float(__hsub_rn(q, p));
    return __fmul_rn(t, t);
  }
  static __device__ __forceinline__ A add(A a, A b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ bool le(A d2, __nv_bfloat16 eps2) {
    return __bfloat162float(__float2bfloat16_rn(d2)) <=
           __bfloat162float(eps2);
  }
};

// Thread g owns slots [g * W, + W) of the launch; its warp refines the
// warp's 32 * W slots in W coalesced steps (the note above).
template <typename T, int N, int W>
__global__ void __launch_bounds__(kThreads) cell_join_kernel(
    const T* __restrict__ q,            // (B, n)
    const T* __restrict__ cand,         // (B, C, n)
    const uint8_t* __restrict__ valid,  // (B, C) bool
    const T* __restrict__ scal,         // (1,) eps^2 in T
    int8_t* __restrict__ out,           // (B, C)
    unsigned slots, unsigned c, unsigned q32, unsigned r32, int n_rt) {
  using L = Lane<T>;
  using A = typename L::A;
  using V = typename Word<W>::V;
  const int n = N ? N : n_rt;
  const T eps2 = scal[0];
  const unsigned lane = threadIdx.x & 31;
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  const bool own = g * W < slots;
  unsigned vbits = 0;  // bit b: slot g * W + b is valid
  if (own) {
    const V v = reinterpret_cast<const V*>(valid)[g];
#pragma unroll
    for (int b = 0; b < W; ++b)
      if ((static_cast<unsigned long long>(v) >> (8 * b)) & 0xffu)
        vbits |= 1u << b;
  }
  unsigned s = (g - lane) * W + lane;  // this lane's slot in step 0
  unsigned row = s / c;
  unsigned col = s - row * c;
  unsigned ball[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    // slot i * 32 + lane of the warp's: owner lane i * 32 / W + lane / W,
    // its bit lane % W
    const unsigned vb = __shfl_sync(kFullMask, vbits, i * (32 / W) + lane / W);
    bool hit = false;
    if (s < slots && ((vb >> (lane % W)) & 1u)) {
      // an invalid slot's candidate is never read
      const T* qr = q + (size_t)row * n;
      const T* cr = cand + (size_t)s * n;
      A d2 = A(0);
      for (int k = 0; k < n; ++k) d2 = L::add(d2, L::sq(qr[k], cr[k]));
      hit = L::le(d2, eps2);
    }
    ball[i] = __ballot_sync(kFullMask, hit);
    s += 32;
    row += q32;
    col += r32;
    if (col >= c) {
      col -= c;
      ++row;
    }
  }
  if (!own) return;
  // this thread's W bits: step lane * W / 32, from bit lane * W % 32
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

template <typename T, int N, int W>
void launch_chunks(const T* q, const T* cand, const uint8_t* valid,
                   const T* scal, int8_t* out, long long rows, int c, int n,
                   cudaStream_t st) {
  const long long chunk = kMaxSlots / c;  // rows a launch
  for (long long r0 = 0; r0 < rows; r0 += chunk) {
    const long long nr = rows - r0 < chunk ? rows - r0 : chunk;
    const unsigned slots = static_cast<unsigned>(nr * c);
    const unsigned blocks = (slots / W + kThreads - 1) / kThreads;
    cell_join_kernel<T, N, W><<<blocks, kThreads, 0, st>>>(
        q + r0 * n, cand + r0 * c * n, valid + r0 * c, scal, out + r0 * c,
        slots, static_cast<unsigned>(c), 32u / c, 32u % c, n);
  }
}

template <typename T, int N>
void launch_width(const void* q, const void* cand, const void* valid,
                  const void* scal, void* out, long long rows, int c, int n,
                  cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* ct = static_cast<const T*>(cand);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const T* sc = static_cast<const T*>(scal);
  int8_t* o = static_cast<int8_t*>(out);
  switch (slot_width(c)) {
    case 8: launch_chunks<T, N, 8>(qt, ct, v, sc, o, rows, c, n, st); break;
    case 4: launch_chunks<T, N, 4>(qt, ct, v, sc, o, rows, c, n, st); break;
    case 2: launch_chunks<T, N, 2>(qt, ct, v, sc, o, rows, c, n, st); break;
    default: launch_chunks<T, N, 1>(qt, ct, v, sc, o, rows, c, n, st); break;
  }
}

template <typename T>
void launch(const void* q, const void* cand, const void* valid,
            const void* scal, void* out, long long rows, int c, int n,
            cudaStream_t s) {
  switch (n) {
    case 1: launch_width<T, 1>(q, cand, valid, scal, out, rows, c, n, s); break;
    case 2: launch_width<T, 2>(q, cand, valid, scal, out, rows, c, n, s); break;
    case 3: launch_width<T, 3>(q, cand, valid, scal, out, rows, c, n, s); break;
    case 4: launch_width<T, 4>(q, cand, valid, scal, out, rows, c, n, s); break;
    case 5: launch_width<T, 5>(q, cand, valid, scal, out, rows, c, n, s); break;
    case 6: launch_width<T, 6>(q, cand, valid, scal, out, rows, c, n, s); break;
    case 7: launch_width<T, 7>(q, cand, valid, scal, out, rows, c, n, s); break;
    case 8: launch_width<T, 8>(q, cand, valid, scal, out, rows, c, n, s); break;
    default: launch_width<T, 0>(q, cand, valid, scal, out, rows, c, n, s); break;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 when the launches
// were accepted), or cudaErrorInvalidValue for an unknown dtype code or an
// empty batch. The Python wrapper checks dtypes, shapes and contiguity,
// hands `valid` and `out` aligned to slot_width(c) bytes, and launches
// only when rows * c > 0.
extern "C" int cell_join_launch(int dtype, const void* q, const void* cand,
                                const void* valid, const void* scal, void* out,
                                long long rows, int c, int n, void* stream) {
  if (rows <= 0 || c <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: launch<float>(q, cand, valid, scal, out, rows, c, n, s); break;
    case kFloat64: launch<double>(q, cand, valid, scal, out, rows, c, n, s); break;
    case kFloat16: launch<__half>(q, cand, valid, scal, out, rows, c, n, s); break;
    case kBFloat16:
      launch<__nv_bfloat16>(q, cand, valid, scal, out, rows, c, n, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
