// Fused gather-refine kernel of the epsilon self-join, for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_join.py::_fused_kernel, the Pallas TPU kernel,
// for the l2 metric (and cosine, which is l2 on unit rows): per-cell and
// merged sweeps, the three masks (UNICOMP, self, external queries), with and
// without the hits plane, in float64, float32, float16 and bfloat16 (see
// the note on half precision below); for the jaccard metric (its own
// kernel, below); and with the global-id masks of the slab join (the GID
// template parameter, below). It computes what
// repro_torch/kernels/fused_join.py::_fused_join_hits_reference computes, bit
// for bit:
//
//   for every query row and stencil offset j, the window
//   points_pad[win_start[j, row] : + c] is refined against the row,
//     d2 = 0; for k < n_real: t = q[k] - p[k]; d2 = d2 + t * t   (this order)
//     hit = d2 <= eps2 && slot < win_count[j, row]
//   then masked: merged sweeps need |p[n_real] - q[n_real]| <= 1 (last-dim
//   cell coordinates ride lane n_real as exact floats); then by the mask
//   mode: UNICOMP keeps cand > q_pos on the zero offset, SELF keeps
//   cand != q_pos, EXTERNAL keeps every hit (the TPU kernel's external=True:
//   the queries are not points of the index, q_pos is all zeros and unread).
//   Outputs: int8 hits (n_off, qp, c), per-row counts summed over offsets,
//   and slot_base, the exclusive scan of the counts within each tq-row tile.
//
// Rounding: every add, subtract and multiply is an explicit round-to-nearest
// intrinsic, and the library is built with -fmad=false, because the plain
// PyTorch version is an unfused IEEE sequence. A contracted multiply-add
// would flip pairs whose d2 lies within an ulp of eps2.
//
// Half precision (__half and __nv_bfloat16 rows, ROADMAP C1): the plain
// version rounds to the half dtype after every subtract, square and add
// (the JAX package's reference lowering, metric.plane_refine_hits). The
// self-join kernel uses the native intrinsics (Native<T>): __hsub_rn,
// __hmul_rn and __hadd_rn round once each, and the compares run in the
// half type. In B1 (b)'s kernel each operation runs in float32 with
// __f*_rn and rounds to the half dtype at once (Arith<T>::round).
// Rounding twice, to float32 and then to half, is the same as rounding
// once for +, - and x: float32 keeps 24 bits, at least 2p + 2 for p = 11
// (f16) and 8 (bf16).
//
// The l2 refine's self-join launches (B1 (a), (c), (d) and their half
// instances) run fused_join_kernel_self (below), its external queries (B1
// (b)) fused_join_kernel_external (below); fused_join_kernel, under
// "Design" and "The run loop", is the Jaccard instances' (B1 (e)) alone.
//
// fused_join_kernel_self. A block of kExtWarps warps owns a 128-row tile:
// it stages the tile's query rows (their used lanes) in shared memory
// once, behind the only barrier before its scan, and each warp takes a
// chunk of RW consecutive rows (RW a power of two, 16 on a 128-row tile)
// and walks the stencil offsets itself. Its lanes load the descriptors of the
// chunk's rows for 32 / RW offsets at once (lane i: row i & (RW - 1),
// offset i >> log2 RW: contiguous rows, so an offset's descriptors are one
// coalesced load), then for each offset it strides the window 32 slots a
// step, lane s refining slot s0 + s of each row of the chunk in turn, with
// no division: the step's hit bytes are neighbours, the query row is one
// shared-memory broadcast, and the count is a __ballot_sync and __popc
// kept in the row's lane, with no shared atomics and no barrier inside the
// offset loop. A window of at most 16 slots (the NARROW instances) takes
// SW lanes, the smallest power of two that holds it, and a step then
// refines 32 / SW rows at once (lane l: row l >> log2 SW, slot l & (SW -
// 1)), each row's lane taking its SW bits of the ballot, so a window of 8
// slots does not leave three lanes in four idle. Rows of one cell share
// their windows: a lane holds its slot's lanes (coordinates, merged lane,
// id lane) in registers and loads them again only where a row's window
// start differs from the one it holds, so a run of rows reads its window
// once a step, from L1/L2, without a plan: the run plan is accepted and
// not read, and run-loop launches give the row loop's result bit for bit.
// n_real 1-4 is a template constant (NR), so the coordinate loops unroll
// with no predicate a lane; more coordinates take the instance that reads
// n_real at run time. A launch of fewer than kSpreadTiles tiles (a narrow
// class, a small slab, a skewed workload's wide class) would leave most
// SMs idle with one block a tile, so it spreads a tile's rows over blocks
// as B1 (b) does: a step's rows a warp (one row past 16 slots), or P warps
// a row where windows pass kExtSlots slots, and the last block of a tile
// to arrive scans its counts (the per-stream arrival counters, below);
// one block a tile scans its own counts with the same warp-shuffle scan,
// without a counter. What bounds it: instructions and their latency, not
// bytes (the main path's 143 M slots move ~0.3 GB);
// scripts/b1_variants.py times the design's choices. B1 (b)'s external
// launches keep their own kernel: tried through this one (spread, with
// the external mask), index A's request took 0.0171 ms on the H100
// against its own kernel's 0.0161 ms (PERF.md).
//
// External queries (the external-query join of core/query_join.py; B1
// (b)) with the l2 refine run fused_join_kernel_external (below): a
// request of 1,024 queries split over a few capacity classes is a few
// 128-row tiles, and one block a tile would run 8 blocks on 132 SMs. There
// a block holds kExtWarps warps and a query row takes one warp, or P of
// them (ext_row_warps: where windows pass kExtSlots slots, as a skewed
// index's wide classes do), so a tile spreads over tq * P / kExtWarps
// blocks. Each warp walks its row's offsets itself: its lanes load up to
// 32 offsets' descriptors at once and stride over its share of the
// window's slots, storing neighbouring hit bytes, and count with
// __ballot_sync and __popc in registers, with no shared atomics and no
// barrier inside the offset loop (P warps add their counts once, through
// shared memory). The run plan is accepted and not read. The per-tile
// scan of the counts runs in the same launch: the last block of a tile to
// finish (a per-tile arrival counter, after __threadfence) scans the
// tile's counts with warp shuffles and sets its counter back to 0, so the
// next launch on the stream finds it zeroed with no memset. The wrapper
// keeps one counter buffer a (device, stream). A query row is read only
// from q_batch and points_pad only at window rows, so queries that are
// not rows of points_pad (and q_pos of zeros) are safe. What bounds it at
// a request's size is latency, not bytes: a 1,024-query request moves
// about 2 MB (under a microsecond at 3.35 TB/s), and a launch costs its
// ramp plus each warp's few dependent descriptor and window loads. The
// Jaccard refine keeps fused_join_kernel's external mask.
//
// Design of the Jaccard kernel (simple first, made faster in later work):
//   * one thread block per tq-row query tile; the stencil-offset loop runs
//     inside the block, so the block owns its rows' counts across all
//     offsets and no reduction crosses blocks. This replaces the TPU's
//     sequential offset grid axis and its VMEM-resident counts.
//   * the tile's query records and q_pos are staged once in shared memory;
//     each offset's win_start / win_count are staged per offset (the TPU
//     kernel prefetched them as scalars).
//   * threads stride over the tile's (row, slot) pairs, so neighbouring
//     threads write neighbouring hit bytes and read neighbouring window rows.
//   * counts accumulate with shared-memory atomics (integer sums are exact
//     in any order); the per-tile exclusive scan runs after the last offset.
//   * no double-buffered window copies yet: windows are read straight from
//     global memory through L1/L2 (the TPU kernel's two-slot DMA pipeline is
//     the later cp.async/TMA work).
//
// The run loop (RUN_LOOP, the TPU kernel's run_loop variant). On the TPU it
// issues one window DMA per run of rows that share a cell (equal run_ord)
// instead of one per row. Here the block stages each run's window
// words[win_start[j, head] : + c] and its sizes in shared memory once per
// offset, and every row of the run refines against that copy. Runs and
// slots are staged in chunks that fit stage_bytes of shared memory (a run
// of c slots, or c-slot segments when a whole window does not fit). Every
// row still masks with its own win_start / win_count, and a row whose
// window is not its head's (a plan that breaks the shared-window contract)
// reads global memory, so the result is the row loop's, bit for bit. Runs
// are found from changes of run_ord inside the tile, whatever its values.
//
// Jaccard (fused_join_kernel, the TPU kernel's metric="jaccard"; refine in
// repro/core/metric.py::tile_refine_hits; B1 (e)). Rows hold the set size in
// lane 0 and n_feat packed 16-bit token words, exact small integers in
// float32, in lanes [n_real, n_real + n_feat); the plain version computes
//     inter = sum_k popc16(int(q[k]) & int(p[k]))    (int, then to float)
//     union = (q[0] + p[0]) - inter
//     hit   = union > 0 && inter >= t * union        (t = scal, unsquared)
// with the same round-to-nearest intrinsics, then the same masks. The
// kernel takes the words packed two to a 32-bit word (low half lane
// n_real + 2k, high half n_real + 2k + 1, zero past n_feat): the candidates
// from `words`, an int32 companion of points_pad made once with it
// (kernels/fused_join.py::pack_words, wl words a row, a multiple of 4), the
// query tile packed here as it is staged. Packing is exact: the two halves'
// bits never meet, so popc(a & b) over a 32-bit word is the sum of the two
// 16-bit popcounts, and inter is the same integer. Per 32 bits that is one
// AND, one __popc and one add, with no float-to-int conversion, read as
// 16-byte vectors. The query tile and the run loop's stage hold records:
// the words, then the size (float bits) in one more vector, an odd number
// of vectors a record so that neighbouring records' 16-byte loads fall in
// distinct banks. Only the per-cell sweep (the size grid is 1-D) in float32
// is instantiated, with the three masks, both loops and both hit modes;
// feature lanes ride only this variant (the wrapper refuses them
// elsewhere). What bounds it: __popc, which issues at a quarter of the
// INT32 rate, ceil(n_feat / 2) of them a slot over windows as long as a
// whole size cell. A very wide vocabulary's query tile passes the 48 KiB
// default of shared memory, so the launch opts in to more, up to the
// device's limit (227 KB on the H100); the wrapper refuses a tile beyond
// that.
//
// Global ids (GID, the TPU kernel's gid_pairs; B1 (d)). The slab join of
// core/distributed.py runs each slab's join over its own points and a halo
// of its neighbours', so sorted positions differ from slab to slab and
// cannot break a tie inside a cell the same way everywhere. Each row then
// carries its global point id, a float of the row dtype, in lane
// n_real + MERGED (after the merged lane; tail rows hold -1), and the masks
// compare ids instead of positions:
//     SELF     keep gc != gq
//     UNICOMP  on the zero offset keep gc > gq; on the merged sweep, whose
//              zero offset's window spans the own cell and the next one
//              along the last dimension, keep ldiff > 0 || (ldiff == 0 &&
//              gc > gq), with ldiff = p[n_real] - q[n_real] rounded as in
//              the boundary test
// Ids are compared as floats of the row dtype, as the plain version
// compares them; the driver refuses ids the dtype does not hold exactly.
// The lane is one more a lane holds in registers. Only the l2 refine at
// the four dtypes with the SELF and UNICOMP masks is instantiated with
// ids: external queries and Jaccard never take them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the Jaccard kernel's threads a block
constexpr int kThreads = 256;
// the self-join and external-query kernels: warps a block, and the window
// slots a warp takes an offset before a row spreads over more warps
// (ext_row_warps)
constexpr int kExtWarps = 8;
constexpr int kExtThreads = 32 * kExtWarps;
constexpr int kExtSlots = 128;
constexpr unsigned kFullMask = 0xffffffffu;
// the self-join kernel's launches of fewer tiles spread a tile over
// blocks (on the H100 the bench workloads' launches of 111 tiles and more
// ran faster a block a tile, of 79 and fewer spread:
// scripts/b1_variants.py)
constexpr int kSpreadTiles = 96;
// the self-join kernel: the coordinate lanes a lane holds in registers where
// n_real is not a template constant (more are read again from memory)
constexpr int kHeld = 8;
// The blocks an SM should hold with NR coordinates: 5 for one or two (at
// most 51 registers a thread: the 2-D main path ran 6 % faster than at the
// compiler's own choice of 58, scripts/b1_variants.py), else 4 (at most 64,
// about what the compiler chooses unbounded).
constexpr int self_blocks(int nr) { return nr == 1 || nr == 2 ? 5 : 4; }

// Row dtypes, as kernels/fused_join.py numbers them (DTYPE_CODES).
constexpr int kFloat32 = 0;
constexpr int kFloat64 = 1;
constexpr int kFloat16 = 2;
constexpr int kBFloat16 = 3;

// Mask modes, as kernels/fused_join.py numbers them.
constexpr int kMaskSelf = 0;
constexpr int kMaskUnicomp = 1;
constexpr int kMaskExternal = 2;

__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// B1 (b)'s arithmetic of a row type T: A is the type it computes in,
// load widens a stored lane exactly, and sub / mul / add round each
// result to T. For float and double that is the operation itself; for
// the half types it is a float32 operation rounded to T (see the note on
// half precision above).
template <typename T>
struct Arith {
  using A = T;
  static __device__ __forceinline__ A load(T x) { return x; }
  static __device__ __forceinline__ A sub(A a, A b) { return sub_rn(a, b); }
  static __device__ __forceinline__ A mul(A a, A b) { return mul_rn(a, b); }
  static __device__ __forceinline__ A add(A a, A b) { return add_rn(a, b); }
};
template <>
struct Arith<__half> {
  using A = float;
  static __device__ __forceinline__ A load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ A round(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ A sub(A a, A b) { return round(__fsub_rn(a, b)); }
  static __device__ __forceinline__ A mul(A a, A b) { return round(__fmul_rn(a, b)); }
  static __device__ __forceinline__ A add(A a, A b) { return round(__fadd_rn(a, b)); }
};
template <>
struct Arith<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ A round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ A sub(A a, A b) { return round(__fsub_rn(a, b)); }
  static __device__ __forceinline__ A mul(A a, A b) { return round(__fmul_rn(a, b)); }
  static __device__ __forceinline__ A add(A a, A b) { return round(__fadd_rn(a, b)); }
};

// One slot's l2 refine for an external query (B1 (b)), in the plain
// version's order of operations, in Arith<T>; the external mask keeps
// every hit.
template <typename T, bool MERGED>
__device__ __forceinline__ bool refine_external(const T* p, const T* q,
                                                T eps2, int n_real) {
  using Ar = Arith<T>;
  using A = typename Ar::A;
  A d2 = A(0);
  for (int k = 0; k < n_real; ++k) {
    const A t = Ar::sub(Ar::load(q[k]), Ar::load(p[k]));
    d2 = Ar::add(d2, Ar::mul(t, t));
  }
  bool hit = d2 <= Ar::load(eps2);
  if (MERGED) {
    const A ldiff = Ar::sub(Ar::load(p[n_real]), Ar::load(q[n_real]));
    hit = hit && fabs(ldiff) <= A(1);
  }
  return hit;
}

// The mask mode's rule: UNICOMP keeps the triangle on the zero offset, SELF
// drops the self pair, EXTERNAL keeps every hit.
template <int MASK>
__device__ __forceinline__ bool mask_hit(bool hit, bool zero, int cand,
                                         int qpos) {
  if (MASK == kMaskUnicomp) return hit && (!zero || cand > qpos);
  if (MASK == kMaskSelf) return hit && cand != qpos;
  return hit;
}

// The self-join kernel's arithmetic: every operation in the row type T,
// rounded to nearest once (the half types by the native intrinsics, rule P),
// and the compares in T.
template <typename T>
struct Native {
  static __device__ __forceinline__ T zero() { return T(0); }
  static __device__ __forceinline__ T one() { return T(1); }
  static __device__ __forceinline__ T sub(T a, T b) { return sub_rn(a, b); }
  static __device__ __forceinline__ T mul(T a, T b) { return mul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return add_rn(a, b); }
  static __device__ __forceinline__ T abs(T a) { return fabs(a); }
  static __device__ __forceinline__ bool le(T a, T b) { return a <= b; }
  static __device__ __forceinline__ bool gt(T a, T b) { return a > b; }
  static __device__ __forceinline__ bool eq(T a, T b) { return a == b; }
  static __device__ __forceinline__ bool ne(T a, T b) { return a != b; }
};
template <>
struct Native<__half> {
  static __device__ __forceinline__ __half zero() { return __ushort_as_half(0); }
  static __device__ __forceinline__ __half one() { return __ushort_as_half(0x3c00); }
  static __device__ __forceinline__ __half sub(__half a, __half b) { return __hsub_rn(a, b); }
  static __device__ __forceinline__ __half mul(__half a, __half b) { return __hmul_rn(a, b); }
  static __device__ __forceinline__ __half add(__half a, __half b) { return __hadd_rn(a, b); }
  static __device__ __forceinline__ __half abs(__half a) { return __habs(a); }
  static __device__ __forceinline__ bool le(__half a, __half b) { return __hle(a, b); }
  static __device__ __forceinline__ bool gt(__half a, __half b) { return __hgt(a, b); }
  static __device__ __forceinline__ bool eq(__half a, __half b) { return __heq(a, b); }
  static __device__ __forceinline__ bool ne(__half a, __half b) { return __hneu(a, b); }
};
template <>
struct Native<__nv_bfloat16> {
  using B = __nv_bfloat16;
  static __device__ __forceinline__ B zero() { return __ushort_as_bfloat16(0); }
  static __device__ __forceinline__ B one() { return __ushort_as_bfloat16(0x3f80); }
  static __device__ __forceinline__ B sub(B a, B b) { return __hsub_rn(a, b); }
  static __device__ __forceinline__ B mul(B a, B b) { return __hmul_rn(a, b); }
  static __device__ __forceinline__ B add(B a, B b) { return __hadd_rn(a, b); }
  static __device__ __forceinline__ B abs(B a) { return __habs(a); }
  static __device__ __forceinline__ bool le(B a, B b) { return __hle(a, b); }
  static __device__ __forceinline__ bool gt(B a, B b) { return __hgt(a, b); }
  static __device__ __forceinline__ bool eq(B a, B b) { return __heq(a, b); }
  static __device__ __forceinline__ bool ne(B a, B b) { return __hneu(a, b); }
};

// A window slot's or a query row's lanes as the self-join kernel holds
// them in registers: its NR coordinates (NR = 0: the first kHeld, the rest
// read from memory; n_real at run time), the merged and the global-id lane.
template <typename T, int NR>
struct Held {
  static constexpr int kN = NR ? NR : kHeld;
  T x[kN];
  T m, g;
};

template <typename T, int NR, bool MERGED, bool GID>
__device__ __forceinline__ void hold_row(Held<T, NR>& h, const T* p, int nr) {
#pragma unroll
  for (int k = 0; k < Held<T, NR>::kN; ++k)
    if (NR || k < nr) h.x[k] = p[k];
  if (MERGED) h.m = p[nr];
  if (GID) h.g = p[nr + MERGED];
}

// The plain version's refine and masks (kernels/fused_join.py::
// _offset_hits), in its order of operations, on a held slot h and a held
// query row q (coordinates past kHeld from their rows p and qp in memory,
// read only where `live`), in Native arithmetic; `mask` is SELF or
// UNICOMP. The sum starts from the first square: the plain version's
// 0 + t * t is t * t bit for bit (a square is +0, positive or NaN).
template <typename T, int NR, bool MERGED, bool GID>
__device__ __forceinline__ bool refine_held(const Held<T, NR>& h, const T* p,
                                            const Held<T, NR>& q,
                                            const T* qp, T eps2, int nr,
                                            bool live, int mask, bool zero,
                                            int cand, int qpos) {
  using N = Native<T>;
  T d2 = N::zero();
#pragma unroll
  for (int k = 0; k < Held<T, NR>::kN; ++k) {
    if (NR || k < nr) {
      const T t = N::sub(q.x[k], h.x[k]);
      d2 = k ? N::add(d2, N::mul(t, t)) : N::mul(t, t);
    }
  }
  if (!NR && live) {
    for (int k = kHeld; k < nr; ++k) {
      const T t = N::sub(qp[k], p[k]);
      d2 = N::add(d2, N::mul(t, t));
    }
  }
  bool hit = N::le(d2, eps2);
  T ldiff = N::zero();
  if (MERGED) {
    ldiff = N::sub(h.m, q.m);
    hit = hit && N::le(N::abs(ldiff), N::one());
  }
  if constexpr (GID) {
    if (mask == kMaskSelf) return hit && N::ne(h.g, q.g);
    bool tri = N::gt(h.g, q.g);
    if (MERGED)
      tri = N::gt(ldiff, N::zero()) || (N::eq(ldiff, N::zero()) && tri);
    return hit && (!zero || tri);
  } else {
    if (mask == kMaskSelf) return hit && cand != qpos;
    return hit && (!zero || cand > qpos);
  }
}

// Jaccard (B1 (e)): a slot's record holds its packed 32-bit words in
// uint4 vectors [0, w4) and its set size (float bits) in .x of vector w4.
__device__ __forceinline__ float record_size(const uint4* rec, int w4) {
  return __uint_as_float(rec[w4].x);
}

// The intersection is the popcount of the AND of the packed words, summed
// as int and converted exactly; then the plain version's float32 union and
// threshold.
template <int MASK>
__device__ __forceinline__ bool refine_jaccard(const uint4* pw, float ps,
                                               const uint4* qw, float qs,
                                               int w4, float t, bool zero,
                                               int cand, int qpos) {
  int inter = 0;
  for (int k = 0; k < w4; ++k) {
    const uint4 a = qw[k];
    const uint4 b = pw[k];
    inter += __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
             __popc(a.w & b.w);
  }
  const float fi = static_cast<float>(inter);
  const float uni = sub_rn(add_rn(qs, ps), fi);
  return mask_hit<MASK>(uni > 0.f && fi >= mul_rn(t, uni), zero, cand, qpos);
}

template <int MASK, bool KEEP_HITS, bool RUN_LOOP>
__global__ void __launch_bounds__(kThreads) fused_join_kernel(
    const float* __restrict__ points_pad,  // (rows, lanes), the set sizes
    const uint4* __restrict__ words,       // (rows, wl / 4)
    const float* __restrict__ q_batch,     // (qp, lanes)
    const int* __restrict__ win_start,     // (n_off, qp)
    const int* __restrict__ win_count,     // (n_off, qp)
    const int* __restrict__ is_zero,       // (n_off,)
    const int* __restrict__ q_pos,         // (qp,)
    const int* __restrict__ run_ord,       // (qp,), RUN_LOOP only
    const float* __restrict__ scal,        // (1,) t
    int8_t* __restrict__ hits,             // (n_off, qp, c), KEEP_HITS only
    int* __restrict__ counts,              // (qp,)
    int* __restrict__ slot_base,           // (qp,)
    int n_off, int qp, int c, int n_real, int n_feat, int lanes, int wl,
    int tq, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  // records: w4 vectors of packed words, then the size vector, an odd
  // number of vectors in all (rec4), so the 16-byte loads of neighbouring
  // records fall in distinct banks
  const int w4 = wl / 4;
  const int rec4 = (w4 + 1) | 1;
  uint4* qrec_s = reinterpret_cast<uint4*>(smem);   // tq * rec4
  unsigned char* stage_b = smem + (size_t)tq * rec4 * 16;
  uint4* stage4 = reinterpret_cast<uint4*>(stage_b);  // RUN_LOOP
  int* cnt_s = reinterpret_cast<int*>(stage_b + (RUN_LOOP ? stage_bytes : 0));
  int* ws_s = cnt_s + tq;                                     // tq
  int* wc_s = ws_s + tq;                                      // tq
  int* qpos_s = wc_s + tq;                                    // tq
  int* run_of_s = qpos_s + tq;                                // tq, RUN_LOOP
  int* run_start_s = run_of_s + tq;                           // tq + 1
  int* nruns_s = run_start_s + tq + 1;                        // 1

  const int row0 = blockIdx.x * tq;
  {
    // the query tile packed as it is staged: word k of a row holds the
    // 16-bit words of lanes n_real + 2k (low half) and n_real + 2k + 1
    uint32_t* qw = reinterpret_cast<uint32_t*>(qrec_s);
    const int rw = rec4 * 4;
    for (int i = threadIdx.x; i < tq * rw; i += blockDim.x) {
      const int r = i / rw;
      const int k = i - r * rw;
      const float* q = q_batch + (size_t)(row0 + r) * lanes;
      uint32_t v = 0;
      if (k < wl) {
        if (2 * k < n_feat) v = static_cast<uint32_t>(q[n_real + 2 * k]);
        if (2 * k + 1 < n_feat)
          v |= static_cast<uint32_t>(q[n_real + 2 * k + 1]) << 16;
      } else if (k == wl) {
        v = __float_as_uint(q[0]);
      }
      qw[i] = v;
    }
  }
  for (int r = threadIdx.x; r < tq; r += blockDim.x) {
    cnt_s[r] = 0;
    qpos_s[r] = q_pos[row0 + r];
    if (RUN_LOOP) run_of_s[r] = run_ord[row0 + r];
  }
  if (RUN_LOOP) {
    __syncthreads();
    if (threadIdx.x == 0) {
      // runs of the tile: a new run wherever the ordinal changes; the
      // ordinals staged above become run indices in place
      int u = -1, prev = 0;
      for (int r = 0; r < tq; ++r) {
        const int o = run_of_s[r];
        if (r == 0 || o != prev) run_start_s[++u] = r;
        run_of_s[r] = u;
        prev = o;
      }
      run_start_s[u + 1] = tq;
      *nruns_s = u + 1;
    }
  }
  const float eps2 = scal[0];
  const int stage_rows = stage_bytes / (rec4 * 16);
  const int seg_cap = c < stage_rows ? c : stage_rows;  // slots per segment
  const int runs_per_chunk = stage_rows / seg_cap;

  for (int j = 0; j < n_off; ++j) {
    __syncthreads();  // the previous offset's readers of ws_s / wc_s are done
    for (int r = threadIdx.x; r < tq; r += blockDim.x) {
      ws_s[r] = win_start[(size_t)j * qp + row0 + r];
      wc_s[r] = win_count[(size_t)j * qp + row0 + r];
    }
    __syncthreads();
    const bool zero = is_zero[j] != 0;
    int8_t* hits_j = hits + ((size_t)j * qp + row0) * c;
    if (!RUN_LOOP) {
      const int work = tq * c;
      for (int idx = threadIdx.x; idx < work; idx += blockDim.x) {
        const int r = idx / c;
        const int s = idx - r * c;
        bool hit = false;
        if (s < wc_s[r]) {
          const int cand = ws_s[r] + s;
          const uint4* qr = qrec_s + (size_t)r * rec4;
          hit = refine_jaccard<MASK>(
              words + (size_t)cand * w4, points_pad[(size_t)cand * lanes],
              qr, record_size(qr, w4), w4, eps2, zero, cand, qpos_s[r]);
        }
        if (KEEP_HITS) hits_j[idx] = hit ? 1 : 0;
        if (hit) atomicAdd(&cnt_s[r], 1);
      }
      continue;
    }
    const int nruns = *nruns_s;
    for (int u0 = 0; u0 < nruns; u0 += runs_per_chunk) {
      const int u1 = min(u0 + runs_per_chunk, nruns);
      const int r_lo = run_start_s[u0];
      const int r_hi = run_start_s[u1];
      for (int s0 = 0; s0 < c; s0 += seg_cap) {
        const int seg = min(seg_cap, c - s0);
        // stage the chunk's windows: slot s of run u at (u - u0) * seg_cap
        // + s; neighbouring threads copy neighbouring 16-byte vectors of
        // one window's words, then each slot's size
        const int stage_slots = (u1 - u0) * seg;
        for (int t = threadIdx.x; t < stage_slots * (w4 + 1);
             t += blockDim.x) {
          const int slot = t / (w4 + 1);
          const int k = t - slot * (w4 + 1);
          const int u = u0 + slot / seg;
          const int s = slot - (u - u0) * seg;
          const int h = run_start_s[u];
          if (s0 + s < wc_s[h]) {
            const size_t row = (size_t)ws_s[h] + s0 + s;
            uint4* dst = stage4 + ((size_t)(u - u0) * seg_cap + s) * rec4;
            dst[k] = k < w4 ? words[row * w4 + k]
                            : make_uint4(__float_as_uint(
                                             points_pad[row * lanes]),
                                         0u, 0u, 0u);
          }
        }
        __syncthreads();
        const int work = (r_hi - r_lo) * seg;
        for (int idx = threadIdx.x; idx < work; idx += blockDim.x) {
          const int r = r_lo + idx / seg;
          const int s = idx - (idx / seg) * seg;
          const int slot = s0 + s;
          bool hit = false;
          if (slot < wc_s[r]) {
            const int cand = ws_s[r] + slot;
            const int u = run_of_s[r];
            const int h = run_start_s[u];
            const bool staged = ws_s[r] == ws_s[h] && slot < wc_s[h];
            const size_t at = (size_t)(u - u0) * seg_cap + s;
            const uint4* qr = qrec_s + (size_t)r * rec4;
            const uint4* pw = staged ? stage4 + at * rec4
                                     : words + (size_t)cand * w4;
            const float ps = staged ? record_size(pw, w4)
                                    : points_pad[(size_t)cand * lanes];
            hit = refine_jaccard<MASK>(pw, ps, qr, record_size(qr, w4), w4,
                                       eps2, zero, cand, qpos_s[r]);
          }
          if (KEEP_HITS) hits_j[(size_t)r * c + slot] = hit ? 1 : 0;
          if (hit) atomicAdd(&cnt_s[r], 1);
        }
        __syncthreads();  // the stage is read before the next chunk fills it
      }
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

// The sum of v over lanes 0..lane of the warp.
__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// The end of a launch whose blocks of kExtThreads threads have written
// their rows' counts: the tile's block scans the tile's counts into
// slot_base, kExtThreads counts at a time, with warp shuffles. ARRIVE: the
// tile spans gridDim.y blocks, which wrote their counts behind a
// __threadfence; the block that arrives last on the tile's counter scans,
// reading the counts from L2 (__ldcg), and sets the counter back to 0.
// Else the tile's only block scans its own counts after the barrier.
// `warp_tot`, `chunk_tot` and `last` are the block's shared scratch.
template <bool ARRIVE>
__device__ __forceinline__ void finish_tile(const int* counts,
                                            int* __restrict__ slot_base,
                                            unsigned* arrivals, int tile,
                                            int tq, int* warp_tot,
                                            int& chunk_tot, bool& last) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (ARRIVE) {
    if (threadIdx.x == 0)
      last = atomicAdd(arrivals + tile, 1u) == gridDim.y - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  const int* tile_counts = counts + (size_t)tile * tq;
  int carry = 0;
  for (int r0 = 0; r0 < tq; r0 += kExtThreads) {
    const int r = r0 + threadIdx.x;
    const int v = r >= tq   ? 0
                  : ARRIVE ? __ldcg(tile_counts + r)
                           : tile_counts[r];
    const int incl = warp_inclusive_sum(v, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int t = lane < kExtWarps ? warp_tot[lane] : 0;
      const int ti = warp_inclusive_sum(t, lane);
      if (lane < kExtWarps) warp_tot[lane] = ti - t;  // exclusive
      if (lane == 31) chunk_tot = ti;
    }
    __syncthreads();
    if (r < tq)
      slot_base[(size_t)tile * tq + r] = carry + warp_tot[warp] + incl - v;
    carry += chunk_tot;
    __syncthreads();  // warp_tot and chunk_tot are read before they change
  }
  if (ARRIVE && threadIdx.x == 0) arrivals[tile] = 0;
}

// P, the warps a query row of the l2 kernels spreads over: the smallest
// power of two with P * kExtSlots >= c, at most kExtWarps
// (kernels/fused_join.py::external_row_warps mirrors it).
int ext_row_warps(int c) {
  int p = 1;
  while (p < kExtWarps && p * kExtSlots < c) p *= 2;
  return p;
}

// B1 (b), external queries with the l2 refine (the note at the top):
// block (x, y) takes rows [y * R, + R) of query tile x, R = kExtWarps / P,
// P warps a row, warp `sub` of a row taking its slots [sub * 32, + 32)
// of every 32 * P; the last block of a tile to arrive writes its
// slot_base.
template <typename T, bool MERGED, bool KEEP_HITS>
__global__ void __launch_bounds__(kExtThreads) fused_join_kernel_external(
    const T* __restrict__ points_pad,   // (rows, lanes)
    const T* __restrict__ q_batch,      // (qp, lanes)
    const int* __restrict__ win_start,  // (n_off, qp)
    const int* __restrict__ win_count,  // (n_off, qp)
    const T* __restrict__ scal,         // (1,) eps^2 in T
    int8_t* __restrict__ hits,          // (n_off, qp, c), KEEP_HITS only
    int* counts,                        // (qp,)
    int* __restrict__ slot_base,        // (qp,)
    unsigned* __restrict__ arrivals,    // (>= qp / tq,), zero between launches
    int n_off, int qp, int c, int n_real, int lanes, int tq, int p_warps) {
  __shared__ int warp_tot[kExtWarps];
  __shared__ int chunk_tot;
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int sub = warp % p_warps;  // this warp's share of its row's slots
  const int r_in = blockIdx.y * (kExtWarps / p_warps) + warp / p_warps;
  const int row = tile * tq + r_in;
  int cnt = 0;
  if (r_in < tq) {  // the whole warp takes this branch
    const T* q = q_batch + (size_t)row * lanes;
    const T eps2 = scal[0];
    for (int j0 = 0; j0 < n_off; j0 += 32) {
      // the descriptors of up to 32 offsets, one a lane, loaded together
      int ws = 0, wc = 0;
      if (j0 + lane < n_off) {
        ws = win_start[(size_t)(j0 + lane) * qp + row];
        wc = win_count[(size_t)(j0 + lane) * qp + row];
      }
      const int jn = min(32, n_off - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const int start = __shfl_sync(kFullMask, ws, jj);
        const int count = min(__shfl_sync(kFullMask, wc, jj), c);
        int8_t* h = hits + ((size_t)(j0 + jj) * qp + row) * c;
        // without the plane, slots past the window are not visited
        const int end = KEEP_HITS ? c : count;
        for (int s0 = sub * 32; s0 < end; s0 += 32 * p_warps) {
          const int s = s0 + lane;
          bool hit = false;
          if (s < count)
            hit = refine_external<T, MERGED>(
                points_pad + (size_t)(start + s) * lanes, q, eps2, n_real);
          if (KEEP_HITS && s < c) h[s] = hit ? 1 : 0;
          cnt += __popc(__ballot_sync(kFullMask, hit));
        }
      }
    }
  }
  if (p_warps > 1) {
    // the row's first warp adds its P warps' counts
    if (lane == 0) warp_tot[warp] = cnt;
    __syncthreads();
    for (int k = 1; k < p_warps; ++k) cnt += warp_tot[warp + k];
  }
  if (r_in < tq && sub == 0 && lane == 0) {
    counts[row] = cnt;
    __threadfence();  // seen by the tile's last block before it arrives
  }
  finish_tile<true>(counts, slot_base, arrivals, tile, tq, warp_tot,
                    chunk_tot, last);
}

// B1's l2 self-join launches (the note "fused_join_kernel_self" at the
// top): block
// (x, y) takes rows [y * R * row_warp, + R * row_warp) of query tile x,
// R = kExtWarps / P, warp w the row_warp rows from (w / P) * row_warp on
// in chunks of RW = 1 << rw_log2, P warps a row (P > 1 only with one row a
// warp), warp `sub` of a row taking its slots [sub * 32, + 32) of every
// 32 * P. NARROW: a step takes SR = 32 / SW rows of SW = 1 << sw_log2 >= c
// slots (P = 1, SR <= RW). One block a tile (gridDim.y == 1) scans its own
// counts; a tile over more blocks is scanned by the last to arrive. NR > 0
// is n_real as a constant (the loops over the coordinates unrolled, no
// predicate a lane); NR = 0 takes any n_real. `mask` is SELF or UNICOMP.
template <typename T, bool MERGED, bool GID, int NR, bool NARROW>
__global__ void __launch_bounds__(kExtThreads, self_blocks(NR))
    fused_join_kernel_self(
    const T* __restrict__ points_pad,   // (rows, lanes)
    const T* __restrict__ q_batch,      // (qp, lanes)
    const int* __restrict__ win_start,  // (n_off, qp)
    const int* __restrict__ win_count,  // (n_off, qp)
    const int* __restrict__ is_zero,    // (n_off,)
    const int* __restrict__ q_pos,      // (qp,)
    const T* __restrict__ scal,         // (1,) eps^2 in T
    int8_t* __restrict__ hits,          // (n_off, qp, c), with keep_hits
    int* counts,                        // (qp,)
    int* __restrict__ slot_base,        // (qp,)
    unsigned* __restrict__ arrivals,    // (>= qp / tq,) when gridDim.y > 1
    int n_off, int qp, int c, int n_real, int lanes, int tq, int mask,
    int keep_hits, int p_warps, int rw_log2, int row_warp, int sw_log2) {
  __shared__ int warp_tot[kExtWarps];
  __shared__ int chunk_tot;
  __shared__ bool last;
  const int nr = NR ? NR : n_real;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int sub = warp % p_warps;
  const int rw = 1 << rw_log2;
  const int jw = 32 >> rw_log2;       // offsets a descriptor load covers
  const int my_r = lane & (rw - 1);   // this lane's row of a chunk
  const int my_j = lane >> rw_log2;   // and offset of a descriptor load
  const int r_block = blockIdx.y * (kExtWarps / p_warps) * row_warp;
  const int r_first = r_block + (warp / p_warps) * row_warp;
  const int r_end = min(r_first + row_warp, tq);
  const T eps2 = scal[0];
  // the block's query rows, their n_use lanes, staged once: every offset
  // of a row reads them, as one broadcast a lane
  extern __shared__ __align__(16) unsigned char q_stage[];
  T* q_s = reinterpret_cast<T*>(q_stage);
  const int n_use = nr + MERGED + GID;
  const int block_rows =
      min((kExtWarps / p_warps) * row_warp, max(tq - r_block, 0));
  for (int i = threadIdx.x; i < block_rows * n_use; i += blockDim.x) {
    const int r = i / n_use;
    q_s[i] = q_batch[(size_t)(tile * tq + r_block + r) * lanes + i - r * n_use];
  }
  __syncthreads();
  int cnt = 0;
  for (int rc = r_first; rc < r_end; rc += rw) {
    const int nrows = min(rw, r_end - rc);
    const int row0 = tile * tq + rc;  // the chunk's first row
    const bool row_ok = my_r < nrows;
    const int qpos = (!GID && row_ok) ? q_pos[row0 + my_r] : 0;
    cnt = 0;  // lane r counts the chunk's row r
    for (int j0 = 0; j0 < n_off; j0 += jw) {
      const int jl = j0 + my_j;
      int ws = 0, wc = 0, zr = 0, end = -1;
      if (row_ok && jl < n_off) {
        ws = win_start[(size_t)jl * qp + row0 + my_r];
        wc = min(win_count[(size_t)jl * qp + row0 + my_r], c);
        zr = is_zero[jl];
        // without the plane, slots past the window are not visited
        end = keep_hits ? c : wc;
      }
      // the last slot step of each offset: the most over its rows
      for (int d = 1; d < rw; d <<= 1)
        end = max(end, __shfl_xor_sync(kFullMask, end, d));
      const int jn = min(jw, n_off - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const int g = jj << rw_log2;
        const int j_end = __shfl_sync(kFullMask, end, g);
        const bool zero = __shfl_sync(kFullMask, zr, g) != 0;
        int8_t* h_j = hits + ((size_t)(j0 + jj) * qp + row0) * c;
        if constexpr (NARROW) {
          // one step covers the window: lane l takes slot l & (SW - 1) of
          // row r + (l >> log2 SW) of the chunk
          if (j_end <= 0) continue;
          const int sw = 1 << sw_log2;
          const int sr = 32 >> sw_log2;
          const int s = lane & (sw - 1);
          const bool in_row = s < c;
          Held<T, NR> held;
          int held_start = -1;  // the window start of the slot held
          for (int r = 0; r < nrows; r += sr) {
            const int row = r + (lane >> sw_log2);  // this lane's chunk row
            const int src = min(row, nrows - 1);
            const int start = __shfl_sync(kFullMask, ws, g + src);
            const int count = __shfl_sync(kFullMask, wc, g + src);
            const int qpos_r = __shfl_sync(kFullMask, qpos, src);
            const bool go = row < nrows && (keep_hits || count > 0);
            if (!__any_sync(kFullMask, go)) continue;
            const bool live = go && s < count;
            const T* p = points_pad + (size_t)(start + s) * lanes;
            if (live && start != held_start) {
              hold_row<T, NR, MERGED, GID>(held, p, nr);
              held_start = start;
            }
            // the query row from the stage, one address for the lanes of
            // a row; a lane past its window refines what it holds and
            // drops it
            const T* q_row = q_s + (rc - r_block + src) * n_use;
            Held<T, NR> q;
            hold_row<T, NR, MERGED, GID>(q, q_row, nr);
            const bool hit =
                refine_held<T, NR, MERGED, GID>(held, p, q, q_row, eps2, nr,
                                                live, mask, zero, start + s,
                                                qpos_r) &&
                live;
            if (keep_hits && go && in_row) h_j[row * c + s] = hit ? 1 : 0;
            // lane r + u of the chunk counts row r + u: its SW bits
            const unsigned ball = __ballot_sync(kFullMask, hit);
            if (lane >= r && lane < r + sr)
              cnt += __popc((ball >> ((lane - r) << sw_log2)) &
                            ((1u << sw) - 1));
          }
        } else {
          for (int s0 = sub * 32; s0 < j_end; s0 += 32 * p_warps) {
            const int s = s0 + lane;
            int8_t* h_s = h_j + s;  // this lane's byte of the chunk's row 0
            const bool in_row = s < c;
            Held<T, NR> held;
            int held_start = -1;  // the window start of the slot held
            for (int r = 0; r < nrows; ++r) {
              const int start = __shfl_sync(kFullMask, ws, g + r);
              const int count = __shfl_sync(kFullMask, wc, g + r);
              const int qpos_r = __shfl_sync(kFullMask, qpos, r);
              if (s0 >= (keep_hits ? c : count)) continue;  // the whole warp
              const bool live = s < count;
              const T* p = points_pad + (size_t)(start + s) * lanes;
              if (live && start != held_start) {
                hold_row<T, NR, MERGED, GID>(held, p, nr);
                held_start = start;
              }
              // the query row from the stage, one address for every lane;
              // a lane past its window refines what it holds and drops it
              const T* q_row = q_s + (rc - r_block + r) * n_use;
              Held<T, NR> q;
              hold_row<T, NR, MERGED, GID>(q, q_row, nr);
              const bool hit =
                  refine_held<T, NR, MERGED, GID>(held, p, q, q_row, eps2,
                                                  nr, live, mask, zero,
                                                  start + s, qpos_r) &&
                  live;
              if (keep_hits && in_row) h_s[r * c] = hit ? 1 : 0;
              const int n = __popc(__ballot_sync(kFullMask, hit));
              if (lane == r) cnt += n;
            }
          }
        }
      }
    }
    if (p_warps == 1 && lane < nrows) counts[row0 + lane] = cnt;
  }
  if (p_warps > 1) {
    // one row a warp: the row's first warp adds its P warps' counts
    if (lane == 0) warp_tot[warp] = cnt;
    __syncthreads();
    if (sub == 0 && lane == 0 && r_first < tq) {
      for (int k = 1; k < p_warps; ++k) cnt += warp_tot[warp + k];
      counts[tile * tq + r_first] = cnt;
    }
  }
  if (gridDim.y > 1) {
    __threadfence();  // seen by the tile's last block
    finish_tile<true>(counts, slot_base, arrivals, tile, tq, warp_tot,
                      chunk_tot, last);
  } else {
    finish_tile<false>(counts, slot_base, arrivals, tile, tq, warp_tot,
                       chunk_tot, last);
  }
}

struct Args {
  const void* points_pad; const void* words; const void* q_batch;
  const void* win_start; const void* win_count; const void* is_zero;
  const void* q_pos; const void* run_ord; const void* scal;
  void* hits; void* counts; void* slot_base; void* arrivals;
  int n_off, qp, c, n_real, n_feat, lanes, wl, tq, stage_bytes;
};

// B1 (b): grid (tiles, row groups of a tile).
template <typename T, bool MERGED, bool KEEP_HITS>
int launch_external(const Args& a, cudaStream_t stream) {
  if (a.arrivals == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int p_warps = ext_row_warps(a.c);
  const int rows = kExtWarps / p_warps;  // query rows a block
  const dim3 grid(a.qp / a.tq, (a.tq + rows - 1) / rows);
  fused_join_kernel_external<T, MERGED, KEEP_HITS>
      <<<grid, kExtThreads, 0, stream>>>(
          static_cast<const T*>(a.points_pad),
          static_cast<const T*>(a.q_batch),
          static_cast<const int*>(a.win_start),
          static_cast<const int*>(a.win_count),
          static_cast<const T*>(a.scal), static_cast<int8_t*>(a.hits),
          static_cast<int*>(a.counts), static_cast<int*>(a.slot_base),
          static_cast<unsigned*>(a.arrivals), a.n_off, a.qp, a.c, a.n_real,
          a.lanes, a.tq, p_warps);
  return 0;
}


template <int MASK, bool KEEP_HITS, bool RUN_LOOP>
int launch_jaccard(const Args& a, cudaStream_t stream) {
  // the query tile's packed records, the per-row tables and the stage
  const size_t smem = (size_t)a.tq * ((a.wl / 4 + 1) | 1) * 16
      + 4 * a.tq * sizeof(int)
      + (RUN_LOOP ? (size_t)a.stage_bytes + (2 * a.tq + 2) * sizeof(int) : 0);
  auto kernel = fused_join_kernel<MASK, KEEP_HITS, RUN_LOOP>;
  if (smem > 48 * 1024) {
    // a wide vocabulary's query tile: opt in past the 48 KiB default (the
    // wrapper has checked the device's opt-in limit)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.qp / a.tq, kThreads, smem, stream>>>(
      static_cast<const float*>(a.points_pad),
      static_cast<const uint4*>(a.words), static_cast<const float*>(a.q_batch),
      static_cast<const int*>(a.win_start), static_cast<const int*>(a.win_count),
      static_cast<const int*>(a.is_zero), static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.run_ord), static_cast<const float*>(a.scal),
      static_cast<int8_t*>(a.hits), static_cast<int*>(a.counts),
      static_cast<int*>(a.slot_base), a.n_off, a.qp, a.c, a.n_real, a.n_feat,
      a.lanes, a.wl, a.tq, a.stage_bytes);
  return 0;
}

template <int MASK, bool KEEP_HITS>
int launch_jaccard_run(const Args& a, bool run_loop, cudaStream_t s) {
  if (run_loop) return launch_jaccard<MASK, KEEP_HITS, true>(a, s);
  return launch_jaccard<MASK, KEEP_HITS, false>(a, s);
}

template <int MASK>
int launch_jaccard_keep(const Args& a, bool keep_hits, bool run_loop,
                        cudaStream_t s) {
  if (keep_hits) return launch_jaccard_run<MASK, true>(a, run_loop, s);
  return launch_jaccard_run<MASK, false>(a, run_loop, s);
}

// B1's l2 layout (kernels/fused_join.py::self_layout mirrors it): P warps a
// row, chunks of RW = 1 << rw_log2 rows, row_warp rows a warp, gy blocks a
// tile, SW = 1 << sw_log2 slots a row takes in a step (32 / SW rows a
// step). A window of at most 16 slots takes the smallest power of two that
// holds it, so a step's lanes refine several rows (`narrow`: the global-id
// launches, whose windows of 16 slots or fewer are a small class of the
// slab join, take 32). A launch of fewer than kSpreadTiles tiles spreads:
// a warp takes a step's rows (one row past 16 slots, P by the window,
// ext_row_warps); else a block owns a tile, each warp its ceil(tq /
// kExtWarps) rows, in chunks of at most 32.
struct SelfLayout {
  int p_warps, rw_log2, row_warp, gy, sw_log2;
};

SelfLayout self_layout(int qp, int tq, int c, bool narrow) {
  int cw = 0;  // log2 of the slots a row takes a step
  while (cw < 5 && ((1 << cw) < c || c > 16 || !narrow)) ++cw;
  if (qp / tq < kSpreadTiles) {
    const int p = ext_row_warps(c);
    const int rows = kExtWarps / p * (32 >> cw);  // query rows a block
    return {p, 5 - cw, 32 >> cw, (tq + rows - 1) / rows, cw};
  }
  const int per = (tq + kExtWarps - 1) / kExtWarps;  // rows a warp
  int lg = 0;
  while (lg < 5 && (1 << lg) < per) ++lg;
  // a step's rows lie in one chunk: at least 32 / RW slots a row
  return {1, lg, ((per + (1 << lg) - 1) >> lg) << lg, 1,
          cw > 5 - lg ? cw : 5 - lg};
}

// The self-join kernel's query stage: the block's rows, each its n_real
// coordinates, the merged lane and the id lane
// (kernels/fused_join.py::self_stage_bytes mirrors it).
size_t self_stage_bytes(const SelfLayout& l, const Args& a, bool merged,
                      bool gid, size_t item) {
  const int rows = (kExtWarps / l.p_warps) * l.row_warp;
  return (size_t)(rows < a.tq ? rows : a.tq) * (a.n_real + merged + gid) *
         item;
}

template <typename T, bool MERGED, bool GID, int NR, bool NARROW>
int launch_self(const Args& a, const SelfLayout& l, int mask, bool keep_hits,
              cudaStream_t stream) {
  if (l.gy > 1 && a.arrivals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.qp / a.tq, l.gy);
  const size_t smem = self_stage_bytes(l, a, MERGED, GID, sizeof(T));
  auto kernel = fused_join_kernel_self<T, MERGED, GID, NR, NARROW>;
  if (smem > 48 * 1024) {
    // many coordinates: opt in past the 48 KiB default (the wrapper has
    // checked the device's opt-in limit)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kExtThreads, smem, stream>>>(
          static_cast<const T*>(a.points_pad),
          static_cast<const T*>(a.q_batch),
          static_cast<const int*>(a.win_start),
          static_cast<const int*>(a.win_count),
          static_cast<const int*>(a.is_zero),
          static_cast<const int*>(a.q_pos), static_cast<const T*>(a.scal),
          static_cast<int8_t*>(a.hits), static_cast<int*>(a.counts),
          static_cast<int*>(a.slot_base), static_cast<unsigned*>(a.arrivals),
          a.n_off, a.qp, a.c, a.n_real, a.lanes, a.tq, mask, keep_hits,
          l.p_warps, l.rw_log2, l.row_warp, l.sw_log2);
  return 0;
}

// An instance a launch: n_real 1-4 a constant, or read at run time (its
// coordinate loops, predicated up to kHeld, waste at most three lanes'
// work from n_real 5 on); NARROW where a window of at most 16 slots lets a
// step refine several rows (never with ids: self_layout).
template <typename T, bool MERGED, bool GID, bool NARROW>
int launch_self_nr(const Args& a, const SelfLayout& l, int mask, bool keep_hits,
                 cudaStream_t s) {
  const bool k = keep_hits;
  switch (a.n_real) {
    case 1: return launch_self<T, MERGED, GID, 1, NARROW>(a, l, mask, k, s);
    case 2: return launch_self<T, MERGED, GID, 2, NARROW>(a, l, mask, k, s);
    case 3: return launch_self<T, MERGED, GID, 3, NARROW>(a, l, mask, k, s);
    case 4: return launch_self<T, MERGED, GID, 4, NARROW>(a, l, mask, k, s);
    default: return launch_self<T, MERGED, GID, 0, NARROW>(a, l, mask, k, s);
  }
}

template <typename T, bool MERGED, bool GID>
int launch_self_layout(const Args& a, int mask, bool keep_hits,
                     cudaStream_t s) {
  const SelfLayout l = self_layout(a.qp, a.tq, a.c, !GID);
  if constexpr (!GID) {
    if (l.sw_log2 < 5)
      return launch_self_nr<T, MERGED, GID, true>(a, l, mask, keep_hits, s);
  }
  return launch_self_nr<T, MERGED, GID, false>(a, l, mask, keep_hits, s);
}

// The l2 refine takes fused_join_kernel_self for the SELF and UNICOMP masks
// (the global-id masks with `gid`, B1 (d)) and B1 (b)'s kernel for
// external queries; neither reads the run plan. A global-id launch with
// the external mask is refused.
template <typename T>
int launch_merged(const Args& a, bool merged, int mask, bool gid,
                  bool keep_hits, cudaStream_t s) {
  if (mask == kMaskExternal) {
    if (gid) return static_cast<int>(cudaErrorInvalidValue);
    if (merged) {
      if (keep_hits) return launch_external<T, true, true>(a, s);
      return launch_external<T, true, false>(a, s);
    }
    if (keep_hits) return launch_external<T, false, true>(a, s);
    return launch_external<T, false, false>(a, s);
  }
  if (mask != kMaskSelf && mask != kMaskUnicomp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (merged) {
    if (gid) return launch_self_layout<T, true, true>(a, mask, keep_hits, s);
    return launch_self_layout<T, true, false>(a, mask, keep_hits, s);
  }
  if (gid) return launch_self_layout<T, false, true>(a, mask, keep_hits, s);
  return launch_self_layout<T, false, false>(a, mask, keep_hits, s);
}

// Jaccard's kernel by mask; a global-id launch is refused.
int launch_jaccard_mask(const Args& a, int mask, bool gid, bool keep_hits,
                        bool run_loop, cudaStream_t s) {
  if (gid) return static_cast<int>(cudaErrorInvalidValue);
  switch (mask) {
    case kMaskSelf:
      return launch_jaccard_keep<kMaskSelf>(a, keep_hits, run_loop, s);
    case kMaskUnicomp:
      return launch_jaccard_keep<kMaskUnicomp>(a, keep_hits, run_loop, s);
    case kMaskExternal:
      return launch_jaccard_keep<kMaskExternal>(a, keep_hits, run_loop, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or cudaErrorInvalidValue for an unknown dtype code
// (0 float32, 1 float64, 2 float16, 3 bfloat16) or mask mode (0 self,
// 1 UNICOMP, 2 external), a Jaccard launch that is not float32 per-cell, or
// a global-id launch with the external mask or Jaccard, or an l2 launch
// that spreads a tile over blocks (every external one; a self-join one
// with self_layout's gy > 1) without `arrivals`,
// its per-tile counters (at least qp / tq uint32 zeros, zero again when the
// launch ends). The Python wrapper validates shapes and dtypes (qp % tq ==
// 0, lanes >= n_real + n_feat + merged + gid, run_ord with run_loop,
// Jaccard's words as (rows, word_lanes) int32 with word_lanes a multiple
// of 4) and the shared-memory totals against fused_join_smem_optin; the
// drivers pad points_pad with a tail of at least c rows, so every window
// read is in bounds.
extern "C" int fused_join_launch(
    int dtype, int merged, int mask, int keep_hits, int run_loop,
    int jaccard, int gid, const void* points_pad, const void* words,
    const void* q_batch, const void* win_start, const void* win_count,
    const void* is_zero, const void* q_pos, const void* run_ord,
    const void* scal, void* hits, void* counts, void* slot_base,
    void* arrivals, int n_off, int qp, int c, int n_real, int n_feat,
    int lanes, int word_lanes, int tq, int stage_bytes, void* stream) {
  Args a{points_pad, words, q_batch, win_start, win_count, is_zero, q_pos,
         run_ord, scal, hits, counts, slot_base, arrivals, n_off, qp, c,
         n_real, n_feat, lanes, word_lanes, tq, stage_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bad;
  if (jaccard) {
    // the drivers reach Jaccard only as float32 words on the per-cell sweep
    if (dtype != kFloat32 || merged)
      return static_cast<int>(cudaErrorInvalidValue);
    bad = launch_jaccard_mask(a, mask, gid, keep_hits, run_loop, s);
  } else {
    switch (dtype) {
      case kFloat32:
        bad = launch_merged<float>(a, merged, mask, gid, keep_hits, s);
        break;
      case kFloat64:
        bad = launch_merged<double>(a, merged, mask, gid, keep_hits, s);
        break;
      case kFloat16:
        bad = launch_merged<__half>(a, merged, mask, gid, keep_hits, s);
        break;
      case kBFloat16:
        bad = launch_merged<__nv_bfloat16>(a, merged, mask, gid, keep_hits,
                                           s);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (bad != 0) return bad;
  return static_cast<int>(cudaGetLastError());
}

// The largest dynamic shared memory a block of this kernel may opt in to on
// `device` (227 KB on the H100), or -1 when the query fails.
extern "C" int fused_join_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}
