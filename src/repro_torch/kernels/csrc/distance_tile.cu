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
// distance_tile_hits_kernel (B2): the (nq, N) int8 plane of hits. A block
//   takes kHitsRows = 32 query rows against a candidate tile of
//   kHitsThreads = 128 threads x G candidates; 256 x 100,000 points at f64,
//   n = 2 (G = 16) is 8 x 49 = 392 blocks, about three an SM. Design:
//   * a thread owns G consecutive candidates: it loads their lanes once,
//     widening half rows as Acc::load does, computes their norms once with
//     sq_norm, and keeps both in registers, so a pair costs no index
//     arithmetic and no shared-memory read of its candidate. G is 16, halved
//     (to 8, then 4) while G * (n + 1) values of the compute type would take
//     more than 96 registers: at f64 16 to n = 2, 8 to n = 5, then 4; at
//     f32 16 to n = 5, then 8;
//   * the block's query rows are staged once in shared memory as records
//     (lanes, then the norm, padded to 16 bytes, as B3 stages them), and all
//     threads read the same record at the same time: n + 1 broadcast values
//     for G pairs;
//   * per query row a thread packs its G hit bytes into 32-bit words and
//     stores them W bytes at a time, so a warp writes 32 * G contiguous bytes
//     of one output row. Row i starts at byte i * npts, so the store width W
//     follows npts: the largest power of two dividing it, at most G (16 at
//     the brute workloads' 100,000, 30,000 and 20,000 points; byte stores at
//     an odd npts, which stay exact). A template on W, chosen at launch.
//   d2 is B3's pair_d2 with the fused last step (and its unfused fall-back
//   when eps2 is +inf, the one case where they can differ). What bounds it
//   on the H100: at f64 the FP64 issue rate, 2n + 2 instructions a pair (n
//   multiplies, n - 1 adds, the norms' add, the fma, the compare) against
//   one byte written a pair; at the half dtypes (FP32 at twice the rate)
//   the bytes of the plane. Shared memory (one broadcast record per G pairs)
//   and the integer pipe (packing, one store per G pairs) stay off the
//   critical path. Only real rows and columns are written: the TPU kernel's
//   padding candidates (at 1e9, never a hit; +inf at float16, where their
//   d2 is inf or NaN and still no hit) are sliced off its output, so they
//   have no counterpart here.
//
// distance_tile_counts_kernel (B3): (N,) neighbour counts, self excluded,
//   over all N^2 ordered pairs. The TPU kernel swept every ordered pair along
//   a sequential candidate-tile axis with its counts in VMEM; here each
//   unordered pair is evaluated once, over the upper triangle, and credited
//   to both points. That is exact: qn and pn come from the same sq_norm,
//   IEEE add and multiply are commutative and the lanes of cross are summed
//   in one fixed order, so d2(i, j) == d2(j, i) bit for bit, and the
//   diagonal (self) is never evaluated. Integer sums are exact in any
//   order, so the counts are deterministic whatever the atomics' order.
//   Design:
//   * tiles of kTile = 1024 rows; block b takes the b-th tile pair (I, J),
//     I <= J, so every block does the same work (the diagonal's half and
//     the ragged last tile aside) and the grid is filled to the end;
//   * a thread holds kRows = 4 query rows and their norms in registers;
//     the candidate tile is staged tc rows at a time, double-buffered, as
//     records (lanes, then the norm, padded to 16 bytes) read with 16-byte
//     shared loads that all threads share (a broadcast), so one staged
//     candidate serves four pairs a thread;
//   * on the diagonal tile a pair counts only if its candidate follows its
//     row; off it, every pair of the two tiles counts;
//   * a hit credits its row in a register and its candidate in a shared
//     per-tile array; hits are sparse, so that bookkeeping sits behind one
//     branch a candidate; each block adds its rows and candidates to the
//     zeroed global counts with one atomicAdd apiece.
//   The last two steps of d2 are one __fma_rn(-2, cross, qn + pn): 2 * cross
//   is exact, so the fused form rounds once, as the subtract of the plain
//   version does. They differ only where 2 * cross overflows while
//   qn + pn is +inf (NaN against +inf), which changes a hit only when eps2
//   is +inf itself; a block then takes the unfused form. What bounds it:
//   operations, N(N-1)/2 pairs x (2n + 2) FP64 instructions (n multiplies,
//   n - 1 adds, the norms' add, the fma, the compare; FP32 ones for float32
//   and the half rows), with O(N) bytes in and out.

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

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// d2 of one pair in the expanded form. With FMA the last two steps are one
// __fma_rn: 2 * cross is exact, so fma(-2, cross, qn + pn) rounds once, as
// the subtract does (the note at the top says where they could differ).
template <typename A, int N, bool FMA>
__device__ __forceinline__ A pair_d2(const A* q, A qn, const A* p, A pn) {
  A cross = mul_rn(q[0], p[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) cross = add_rn(cross, mul_rn(q[k], p[k]));
  const A s = add_rn(qn, pn);
  if (FMA) return fma_rn(A(-2), cross, s);
  return sub_rn(s, mul_rn(A(2), cross));
}

// B3's tile: each thread holds kRows query rows in registers, so a block
// covers kTile rows on each side of a tile pair.
constexpr int kRows = 4;
constexpr int kTile = kThreads * kRows;

// A staged candidate: its N lanes and its squared norm in A, padded to a
// whole number of 16-byte vectors (kLen values).
template <typename A, int N>
struct Record {
  static constexpr int kPer16 = 16 / static_cast<int>(sizeof(A));
  static constexpr int kLen = (N + 1 + kPer16 - 1) / kPer16 * kPer16;
};

template <int L>
__device__ __forceinline__ void load_record(const double* src, double (&dst)[L]) {
#pragma unroll
  for (int k = 0; k < L / 2; ++k) {
    const double2 v = reinterpret_cast<const double2*>(src)[k];
    dst[2 * k] = v.x;
    dst[2 * k + 1] = v.y;
  }
}
template <int L>
__device__ __forceinline__ void load_record(const float* src, float (&dst)[L]) {
#pragma unroll
  for (int k = 0; k < L / 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(src)[k];
    dst[4 * k] = v.x;
    dst[4 * k + 1] = v.y;
    dst[4 * k + 2] = v.z;
    dst[4 * k + 3] = v.w;
  }
}

// Rows [r0, r0 + rows) as records in `dst`, one thread a row.
template <typename T, int N>
__device__ __forceinline__ void stage_records(const T* __restrict__ pts,
                                              typename Acc<T>::A* dst, int r0,
                                              int rows) {
  using A = typename Acc<T>::A;
  constexpr int L = Record<A, N>::kLen;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    A v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = Acc<T>::load(pts[(size_t)(r0 + r) * N + k]);
    A* rec = dst + (size_t)r * L;
#pragma unroll
    for (int k = 0; k < N; ++k) rec[k] = v[k];
    rec[N] = sq_norm<A, N>(v);
#pragma unroll
    for (int k = N + 1; k < L; ++k) rec[k] = A(0);
  }
}

// One tile pair of B3's triangle: the kTile rows of the tile at i0 (kRows a
// thread, rows i0 + threadIdx.x + a * kThreads) against the candidates of
// the tile at j0, staged tc at a time in two alternating shared buffers. On
// the diagonal tile (DIAG) a pair counts only with its candidate after its
// row, so each unordered pair is evaluated once and self never is; rows
// past npts lie only in the last tile, whose one pair is diagonal, so that
// mask drops them too. A hit credits both points: the row in a register,
// the candidate in col_s (shared), each added to counts once at the end.
template <typename T, int N, bool DIAG, bool FMA>
__device__ __forceinline__ void counts_tile_pair(
    const T* __restrict__ pts, typename Acc<T>::A eps2, int* __restrict__ counts,
    int npts, int i0, int j0, int tc, typename Acc<T>::A* bufs, int* col_s) {
  using A = typename Acc<T>::A;
  constexpr int L = Record<A, N>::kLen;
  A q[kRows][N];
  A qn[kRows];
  int rc[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int row = i0 + threadIdx.x + a * kThreads;
    rc[a] = 0;
#pragma unroll
    for (int k = 0; k < N; ++k)
      q[a][k] = row < npts ? Acc<T>::load(pts[(size_t)row * N + k]) : A(0);
    qn[a] = sq_norm<A, N>(q[a]);
  }
  const int j_end = min(j0 + kTile, npts);
  stage_records<T, N>(pts, bufs, j0, min(tc, j_end - j0));
  __syncthreads();   // the first chunk and the zeroed col_s
  int k = 0;
  for (int c0 = j0; c0 < j_end; c0 += tc, ++k) {
    const int cols = min(tc, j_end - c0);
    const A* buf = bufs + (size_t)(k & 1) * tc * L;
    // the next chunk goes to the other buffer, whose readers passed the
    // barrier that ended the previous chunk
    if (c0 + tc < j_end)
      stage_records<T, N>(pts, bufs + (size_t)((k + 1) & 1) * tc * L,
                          c0 + tc, min(tc, j_end - c0 - tc));
    for (int jj = 0; jj < cols; ++jj) {
      A p[L];
      load_record<L>(buf + (size_t)jj * L, p);   // a broadcast
      const int lj = c0 - j0 + jj;
      bool h[kRows];
      bool any = false;
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        h[a] = pair_d2<A, N, FMA>(q[a], qn[a], p, p[N]) <= eps2;
        if (DIAG) h[a] = h[a] && lj > (int)threadIdx.x + a * kThreads;
        any |= h[a];
      }
      if (__builtin_expect(any, 0)) {   // hits are sparse
        int hs = 0;
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          rc[a] += h[a];
          hs += h[a];
        }
        atomicAdd(&col_s[lj], hs);
      }
    }
    __syncthreads();   // the chunk is read; the next one is staged
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a)
    if (rc[a]) atomicAdd(&counts[i0 + threadIdx.x + a * kThreads], rc[a]);
  for (int j = threadIdx.x; j < j_end - j0; j += kThreads)
    if (col_s[j]) atomicAdd(&counts[j0 + j], col_s[j]);
}

// Block b takes the b-th tile pair (I, J), I <= J, of the upper triangle,
// enumerated row by row: every block does the same kTile^2 pairs but the
// diagonal ones (half) and the ragged last tile.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) distance_tile_counts_kernel(
    const T* __restrict__ pts,    // (npts, N)
    const T* __restrict__ scal,   // (1,) eps^2 in T
    int* __restrict__ counts,     // (npts,), zeroed
    int npts, int n_tiles, int tc) {
  using A = typename Acc<T>::A;
  extern __shared__ __align__(16) unsigned char smem[];
  int* col_s = reinterpret_cast<int*>(smem);                   // kTile
  A* bufs = reinterpret_cast<A*>(smem + kTile * sizeof(int));  // 2 chunks
  const long long b = blockIdx.x;
  const long long nt = n_tiles;
  // row I of the triangle starts at I * nt - I * (I - 1) / 2
  const double w = 2.0 * nt + 1.0;
  long long I = (long long)((w - sqrt(w * w - 8.0 * (double)b)) / 2.0);
  I = I < 0 ? 0 : (I > nt - 1 ? nt - 1 : I);
  while (I + 1 < nt && (I + 1) * nt - (I + 1) * I / 2 <= b) ++I;
  while (I * nt - I * (I - 1) / 2 > b) --I;
  const int J = (int)(I + b - (I * nt - I * (I - 1) / 2));
  for (int j = threadIdx.x; j < kTile; j += kThreads) col_s[j] = 0;
  const A eps2 = Acc<T>::load(scal[0]);
  const int i0 = (int)I * kTile;
  const int j0 = J * kTile;
  // eps2 = +inf is the one case where the fused form can differ (the note)
  if (isinf(eps2)) {
    if (I == J)
      counts_tile_pair<T, N, true, false>(pts, eps2, counts, npts, i0, j0, tc,
                                          bufs, col_s);
    else
      counts_tile_pair<T, N, false, false>(pts, eps2, counts, npts, i0, j0,
                                           tc, bufs, col_s);
  } else if (I == J) {
    counts_tile_pair<T, N, true, true>(pts, eps2, counts, npts, i0, j0, tc,
                                       bufs, col_s);
  } else {
    counts_tile_pair<T, N, false, true>(pts, eps2, counts, npts, i0, j0, tc,
                                        bufs, col_s);
  }
}

// B2's decomposition; kernels/distance_tile.py mirrors each name
// (HITS_THREADS, HITS_ROWS, HITS_REG_BUDGET, hits_group, hits_width).
constexpr int kHitsThreads = 128;   // threads a block
constexpr int kHitsRows = 32;       // query rows a block
constexpr int kHitsRegBudget = 96;  // 32-bit registers for a thread's candidates

// G, the candidates a thread owns: 16, halved (to no fewer than 4) while
// their lanes and norms, G * (N + 1) values of A, would take more than
// kHitsRegBudget registers.
template <typename A, int N>
__host__ __device__ constexpr int hits_group() {
  int g = 16;
  while (g > 4 && g * (N + 1) * static_cast<int>(sizeof(A) / 4) > kHitsRegBudget)
    g /= 2;
  return g;
}

// W, the bytes of one store: the largest power of two that divides npts, at
// most G (and so at most 16). Row i of the plane starts at byte i * npts and
// a thread's G columns at a multiple of G, so every W-byte store is aligned
// and lies inside one row; the plane's base comes from the allocator, which
// aligns to far more than 16 bytes.
inline int hits_width(int npts, int group) {
  int w = group < 16 ? group : 16;
  while (npts % w) w /= 2;
  return w;
}

// The G hit bytes of one query row, packed four to a word (byte g of the
// group in byte g % 4 of word g / 4), stored W bytes at a time. The plane's
// width is a multiple of W, so a W-byte chunk lies wholly before the last
// column or wholly past it.
template <int G, int W>
__device__ __forceinline__ void store_hits(int8_t* dst, const uint32_t (&w)[G / 4],
                                           long long col, int npts) {
#pragma unroll
  for (int s = 0; s < G / W; ++s) {
    if (col + s * W >= npts) continue;
    if constexpr (W == 16) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(w[4 * s], w[4 * s + 1], w[4 * s + 2], w[4 * s + 3]);
    } else if constexpr (W == 8) {
      *reinterpret_cast<uint2*>(dst + 8 * s) = make_uint2(w[2 * s], w[2 * s + 1]);
    } else if constexpr (W == 4) {
      *reinterpret_cast<uint32_t*>(dst + 4 * s) = w[s];
    } else if constexpr (W == 2) {
      *reinterpret_cast<uint16_t*>(dst + 2 * s) =
          static_cast<uint16_t>(w[s / 2] >> (16 * (s % 2)));
    } else {
      dst[s] = static_cast<int8_t>((w[s / 4] >> (8 * (s % 4))) & 0xFF);
    }
  }
}

// One thread's sweep over the block's staged query rows: per row, one
// broadcast record read, G pair_d2 against the candidates in registers, the
// hits packed and stored.
template <typename A, int N, int G, int W, bool FMA>
__device__ __forceinline__ void hits_rows(const A* q_s, A (&p)[G][N],
                                          A (&pn)[G], A eps2,
                                          int8_t* __restrict__ out, int rows,
                                          long long row0, int npts,
                                          long long col) {
  constexpr int L = Record<A, N>::kLen;
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    A qr[L];
    load_record<L>(q_s + r * L, qr);   // a broadcast
    uint32_t w[G / 4];
#pragma unroll
    for (int k = 0; k < G / 4; ++k) w[k] = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bool hit = pair_d2<A, N, FMA>(qr, qr[N], p[g], pn[g]) <= eps2;
      w[g / 4] |= static_cast<uint32_t>(hit) << (8 * (g % 4));
    }
    store_hits<G, W>(out + (row0 + r) * npts + col, w, col, npts);
  }
}

// The candidate tile as a block stages it: thread t's G rows (G * N values
// of T, consecutive in memory) from value t * kStride, one 4-byte bank (an
// 8-byte one for double) past the previous thread's, so that the threads
// of a warp reading their own values at the same offset hit distinct
// banks.
template <typename T, int N, int G>
struct CandTile {
  static constexpr int kValues = G * N;
  static constexpr int kStride = kValues + (sizeof(T) >= 4 ? 1 : 2);
};

// B2: block (x, y) takes query rows [32y, 32y + 32) against the candidate
// tile of kHitsThreads * G columns at x. The tile's rows are copied to
// shared memory with coalesced loads (zeros past npts), and a thread takes
// its G consecutive candidates from there: it widens their lanes as
// Acc::load does, computes their norms once with sq_norm, and keeps both
// in registers. The block's query rows are staged once as records (lanes,
// then the norm), which every thread reads at the same time.
template <typename T, int N, int W>
__global__ void __launch_bounds__(kHitsThreads) distance_tile_hits_kernel(
    const T* __restrict__ q,      // (nq, N)
    const T* __restrict__ pts,    // (npts, N)
    const T* __restrict__ scal,   // (1,) eps^2 in T
    int8_t* __restrict__ out,     // (nq, npts)
    int nq, int npts) {
  using A = typename Acc<T>::A;
  constexpr int G = hits_group<A, N>();
  constexpr int L = Record<A, N>::kLen;
  using Tile = CandTile<T, N, G>;
  static_assert(G % W == 0 && G % 4 == 0, "a store never splits a word");
  __shared__ __align__(16) A q_s[kHitsRows * L];
  __shared__ __align__(16) T c_s[kHitsThreads * Tile::kStride];
  const int i0 = blockIdx.y * kHitsRows;
  const int rows = min(kHitsRows, nq - i0);
  stage_records<T, N>(q, q_s, i0, rows);
  const long long tile0 = (long long)blockIdx.x * (kHitsThreads * G);
  const long long real = (npts - tile0) * N;   // values of the tile in pts
  const T* src = pts + tile0 * N;
  for (int e = threadIdx.x; e < kHitsThreads * Tile::kValues; e += kHitsThreads) {
    const int t = e / Tile::kValues;
    c_s[t * Tile::kStride + (e - t * Tile::kValues)] = e < real ? src[e] : T{};
  }
  __syncthreads();
  const long long col = tile0 + (long long)threadIdx.x * G;
  const T* mine = c_s + threadIdx.x * Tile::kStride;
  A p[G][N];
  A pn[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int k = 0; k < N; ++k) p[g][k] = Acc<T>::load(mine[g * N + k]);
    pn[g] = sq_norm<A, N>(p[g]);
  }
  const A eps2 = Acc<T>::load(scal[0]);
  // eps2 = +inf is the one case where the fused form can differ (the note)
  if (isinf(eps2))
    hits_rows<A, N, G, W, false>(q_s, p, pn, eps2, out, rows, i0, npts, col);
  else
    hits_rows<A, N, G, W, true>(q_s, p, pn, eps2, out, rows, i0, npts, col);
}

template <typename T, int N, int W>
void launch_hits_w(const void* q, const void* pts, const void* scal, void* out,
                   int nq, int npts, cudaStream_t s) {
  constexpr int G = hits_group<typename Acc<T>::A, N>();
  const long long tile = (long long)kHitsThreads * G;
  const dim3 grid((unsigned)((npts + tile - 1) / tile),
                  (unsigned)((nq + kHitsRows - 1) / kHitsRows));
  distance_tile_hits_kernel<T, N, W><<<grid, kHitsThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(pts),
      static_cast<const T*>(scal), static_cast<int8_t*>(out), nq, npts);
}

template <typename T, int N>
void launch_hits(const void* q, const void* pts, const void* scal, void* out,
                 int nq, int npts, cudaStream_t s) {
  constexpr int G = hits_group<typename Acc<T>::A, N>();
  switch (hits_width(npts, G)) {
    case 16:
      if constexpr (G >= 16) launch_hits_w<T, N, 16>(q, pts, scal, out, nq, npts, s);
      break;
    case 8:
      if constexpr (G >= 8) launch_hits_w<T, N, 8>(q, pts, scal, out, nq, npts, s);
      break;
    case 4: launch_hits_w<T, N, 4>(q, pts, scal, out, nq, npts, s); break;
    case 2: launch_hits_w<T, N, 2>(q, pts, scal, out, nq, npts, s); break;
    default: launch_hits_w<T, N, 1>(q, pts, scal, out, nq, npts, s); break;
  }
}

template <typename T, int N>
void launch_counts(const void* pts, const void* scal, void* counts, int npts,
                   int tc, cudaStream_t s) {
  using A = typename Acc<T>::A;
  const size_t smem =
      kTile * sizeof(int) + 2 * (size_t)tc * Record<A, N>::kLen * sizeof(A);
  const long long tiles = (npts + kTile - 1) / kTile;
  distance_tile_counts_kernel<T, N>
      <<<(unsigned)(tiles * (tiles + 1) / 2), kThreads, smem, s>>>(
          static_cast<const T*>(pts), static_cast<const T*>(scal),
          static_cast<int*>(counts), npts, (int)tiles, tc);
}

template <typename T>
int dispatch_hits(int n, const void* q, const void* pts, const void* scal,
                  void* out, int nq, int npts, cudaStream_t s) {
  switch (n) {
    case 1: launch_hits<T, 1>(q, pts, scal, out, nq, npts, s); break;
    case 2: launch_hits<T, 2>(q, pts, scal, out, nq, npts, s); break;
    case 3: launch_hits<T, 3>(q, pts, scal, out, nq, npts, s); break;
    case 4: launch_hits<T, 4>(q, pts, scal, out, nq, npts, s); break;
    case 5: launch_hits<T, 5>(q, pts, scal, out, nq, npts, s); break;
    case 6: launch_hits<T, 6>(q, pts, scal, out, nq, npts, s); break;
    case 7: launch_hits<T, 7>(q, pts, scal, out, nq, npts, s); break;
    case 8: launch_hits<T, 8>(q, pts, scal, out, nq, npts, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_counts(int n, const void* pts, const void* scal, void* counts,
                    int npts, int tc, cudaStream_t s) {
  switch (n) {
    case 1: launch_counts<T, 1>(pts, scal, counts, npts, tc, s); break;
    case 2: launch_counts<T, 2>(pts, scal, counts, npts, tc, s); break;
    case 3: launch_counts<T, 3>(pts, scal, counts, npts, tc, s); break;
    case 4: launch_counts<T, 4>(pts, scal, counts, npts, tc, s); break;
    case 5: launch_counts<T, 5>(pts, scal, counts, npts, tc, s); break;
    case 6: launch_counts<T, 6>(pts, scal, counts, npts, tc, s); break;
    case 7: launch_counts<T, 7>(pts, scal, counts, npts, tc, s); break;
    case 8: launch_counts<T, 8>(pts, scal, counts, npts, tc, s); break;
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
    void* out, int nq, int npts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_hits<float>(n, q, pts, scal, out, nq, npts, s);
    case kFloat64: return dispatch_hits<double>(n, q, pts, scal, out, nq, npts, s);
    case kFloat16: return dispatch_hits<__half>(n, q, pts, scal, out, nq, npts, s);
    case kBFloat16:
      return dispatch_hits<__nv_bfloat16>(n, q, pts, scal, out, nq, npts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// counts must be zeroed: B3 adds to it.
extern "C" int distance_tile_counts_launch(
    int dtype, int n, const void* pts, const void* scal, void* counts,
    int npts, int tc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_counts<float>(n, pts, scal, counts, npts, tc, s);
    case kFloat64: return dispatch_counts<double>(n, pts, scal, counts, npts, tc, s);
    case kFloat16: return dispatch_counts<__half>(n, pts, scal, counts, npts, tc, s);
    case kBFloat16:
      return dispatch_counts<__nv_bfloat16>(n, pts, scal, counts, npts, tc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
