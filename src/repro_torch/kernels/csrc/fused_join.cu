// Fused gather-refine kernel of the epsilon self-join, for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_join.py::_fused_kernel, the Pallas TPU kernel,
// for the l2 metric (and cosine, which is l2 on unit rows): per-cell and
// merged sweeps, the three masks (UNICOMP, self, external queries), with and
// without the hits plane, in float64, float32, float16 and bfloat16 (see
// the note on half precision below); for the jaccard metric (the JACCARD
// template parameter, below); and with the global-id masks of the slab join
// (the GID template parameter, below). It computes what
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
// (the JAX package's reference lowering, metric.plane_refine_hits). Here each
// operation runs in float32 with __f*_rn and rounds to the half dtype at
// once (Arith<T>::round). Rounding twice, to float32 and then to half, is
// the same as rounding once for +, - and x: float32 keeps 24 bits, at least
// 2p + 2 for p = 11 (f16) and 8 (bf16).
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
//
// The run loop (RUN_LOOP, the TPU kernel's run_loop variant). On the TPU it
// issues one window DMA per run of rows that share a cell (equal run_ord)
// instead of one per row. Here the block stages each run's window
// points_pad[win_start[j, head] : + c] (the coordinate lanes and the merged
// lane only) in shared memory once per offset, and every row of the run
// refines against that copy. Runs and slots are staged in chunks that fit
// stage_bytes of shared memory (a run of c slots, or c-slot segments when a
// whole window does not fit), so any capacity works within the 48 KiB a
// launch gets by default (l2). Every row still masks with its own win_start /
// win_count, and a row whose window is not its head's (a plan that breaks
// the shared-window contract) reads global memory, so the result is the row
// loop's, bit for bit. Runs are found from changes of run_ord inside the
// tile, whatever its values.
//
// External queries (the external-query join of core/query_join.py; B1 (b))
// with the l2 refine run their own kernel, fused_join_kernel_external
// (below), which launch_mask picks for the external mask: a request of
// 1,024 queries split over a few capacity classes is a few 128-row tiles,
// and one block a tile would run 8 blocks on 132 SMs, each a serial chain
// of run staging and barriers. There a block holds kExtWarps warps and a
// query row takes one warp, or P of them (ext_row_warps: where windows pass
// kExtSlots slots, as a skewed index's wide classes do), so a tile
// spreads over tq * P / kExtWarps blocks. Each warp walks its row's
// offsets itself: its lanes load up to 32 offsets' descriptors at once and
// stride over its share of the window's slots, storing neighbouring hit
// bytes, and count with __ballot_sync and __popc in registers, with no
// shared atomics and no barrier inside the offset loop (P warps add their
// counts once, through shared memory). Runs are not staged:
// the windows are read through L1/L2, where the rows of one run find the
// same lines; the run plan is accepted and not read, and every row masks
// with its own descriptors, so the result is both loops' bit for bit. The
// per-tile scan of the counts runs in the same launch: the last block of a
// tile to finish (a per-tile arrival counter, after __threadfence) scans
// the tile's counts with warp shuffles and sets its counter back to 0, so
// the next launch on the stream finds it zeroed with no memset. The
// wrapper keeps one counter buffer a (device, stream). A query row is read
// only from q_batch and points_pad only at window rows, so queries that
// are not rows of points_pad (and q_pos of zeros) are safe. What bounds it
// at a request's size is latency, not bytes: a 1,024-query request moves
// about 2 MB (under a microsecond at 3.35 TB/s), and a launch costs its
// ramp plus each warp's few dependent descriptor and window loads. The
// Jaccard refine keeps the external mask of the kernel above (its query
// words are packed as the tile is staged).
//
// Jaccard (JACCARD, the TPU kernel's metric="jaccard"; refine in
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
// The lane is one more the refine reads, so the run loop stages it too.
// Only the l2 refine at the four dtypes with the SELF and UNICOMP masks is
// instantiated: external queries and Jaccard never take ids. The lane
// costs 2 to 8 bytes a slot on top of the candidate row, so the bound is
// still bytes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the external-query kernel: warps a block, and the window slots a warp
// takes an offset before a row spreads over more warps (ext_row_warps)
constexpr int kExtWarps = 8;
constexpr int kExtThreads = 32 * kExtWarps;
constexpr int kExtSlots = 128;
constexpr unsigned kFullMask = 0xffffffffu;

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

// The arithmetic of a row type T: A is the type it computes in, load widens
// a stored lane exactly, and sub / mul / add round each result to T. For
// float and double that is the operation itself; for the half types it is a
// float32 operation rounded to T (see the note on rounding above).
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

// The mask mode's rule: UNICOMP keeps the triangle on the zero offset, SELF
// drops the self pair, EXTERNAL keeps every hit.
template <int MASK>
__device__ __forceinline__ bool mask_hit(bool hit, bool zero, int cand,
                                         int qpos) {
  if (MASK == kMaskUnicomp) return hit && (!zero || cand > qpos);
  if (MASK == kMaskSelf) return hit && cand != qpos;
  return hit;
}

// One slot's L2 refine and masks, in the plain version's order of operations.
template <typename T, bool MERGED, int MASK, bool GID>
__device__ __forceinline__ bool refine_slot(const T* p, const T* q, T eps2,
                                            int n_real, bool zero, int cand,
                                            int qpos) {
  using Ar = Arith<T>;
  using A = typename Ar::A;
  A d2 = A(0);
  for (int k = 0; k < n_real; ++k) {
    const A t = Ar::sub(Ar::load(q[k]), Ar::load(p[k]));
    d2 = Ar::add(d2, Ar::mul(t, t));
  }
  bool hit = d2 <= Ar::load(eps2);
  A ldiff = A(0);
  if (MERGED) {
    ldiff = Ar::sub(Ar::load(p[n_real]), Ar::load(q[n_real]));
    hit = hit && fabs(ldiff) <= A(1);
  }
  if constexpr (GID) {
    // the global-id masks (B1 (d), the note above)
    const A gc = Ar::load(p[n_real + MERGED]);
    const A gq = Ar::load(q[n_real + MERGED]);
    if (MASK == kMaskSelf) return hit && gc != gq;
    bool tri = gc > gq;
    if (MERGED) tri = ldiff > A(0) || (ldiff == A(0) && tri);
    return hit && (!zero || tri);
  } else {
    return mask_hit<MASK>(hit, zero, cand, qpos);
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

template <typename T, bool MERGED, int MASK, bool KEEP_HITS, bool RUN_LOOP,
          bool JACCARD, bool GID>
__global__ void __launch_bounds__(kThreads) fused_join_kernel(
    const T* __restrict__ points_pad,   // (rows, lanes)
    const uint4* __restrict__ words,    // (rows, wl / 4), JACCARD only
    const T* __restrict__ q_batch,      // (qp, lanes)
    const int* __restrict__ win_start,  // (n_off, qp)
    const int* __restrict__ win_count,  // (n_off, qp)
    const int* __restrict__ is_zero,    // (n_off,)
    const int* __restrict__ q_pos,      // (qp,)
    const int* __restrict__ run_ord,    // (qp,), RUN_LOOP only
    const T* __restrict__ scal,         // (1,) eps^2, or t for Jaccard, in T
    int8_t* __restrict__ hits,          // (n_off, qp, c), KEEP_HITS only
    int* __restrict__ counts,           // (qp,)
    int* __restrict__ slot_base,        // (qp,)
    int n_off, int qp, int c, int n_real, int n_feat, int lanes, int wl,
    int tq, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Jaccard records: w4 vectors of packed words, then the size vector, an
  // odd number of vectors in all (rec4), so the 16-byte loads of
  // neighbouring records fall in distinct banks
  const int w4 = wl / 4;
  const int rec4 = (w4 + 1) | 1;
  T* q_s = reinterpret_cast<T*>(smem);              // tq * lanes (l2)
  uint4* qrec_s = reinterpret_cast<uint4*>(smem);   // tq * rec4 (Jaccard)
  unsigned char* stage_b =
      smem + (JACCARD ? (size_t)tq * rec4 * 16 : (size_t)tq * lanes * sizeof(T));
  T* stage = reinterpret_cast<T*>(stage_b);         // RUN_LOOP
  uint4* stage4 = reinterpret_cast<uint4*>(stage_b);
  int* cnt_s = reinterpret_cast<int*>(stage_b + (RUN_LOOP ? stage_bytes : 0));
  int* ws_s = cnt_s + tq;                                     // tq
  int* wc_s = ws_s + tq;                                      // tq
  int* qpos_s = wc_s + tq;                                    // tq
  int* run_of_s = qpos_s + tq;                                // tq, RUN_LOOP
  int* run_start_s = run_of_s + tq;                           // tq + 1
  int* nruns_s = run_start_s + tq + 1;                        // 1

  const int row0 = blockIdx.x * tq;
  if constexpr (JACCARD) {
    // the query tile packed as it is staged: word k of a row holds the
    // 16-bit words of lanes n_real + 2k (low half) and n_real + 2k + 1
    uint32_t* qw = reinterpret_cast<uint32_t*>(qrec_s);
    const int rw = rec4 * 4;
    for (int i = threadIdx.x; i < tq * rw; i += blockDim.x) {
      const int r = i / rw;
      const int k = i - r * rw;
      const T* q = q_batch + (size_t)(row0 + r) * lanes;
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
  } else {
    for (int i = threadIdx.x; i < tq * lanes; i += blockDim.x)
      q_s[i] = q_batch[(size_t)row0 * lanes + i];
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
  const T eps2 = scal[0];
  // lanes an l2 refine reads: coordinates, merged lane, global-id lane
  const int n_use = n_real + (MERGED ? 1 : 0) + (GID ? 1 : 0);
  const int stage_rows = JACCARD ? stage_bytes / (rec4 * 16)
                                 : stage_bytes / (n_use * (int)sizeof(T));
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
          if constexpr (JACCARD) {
            const uint4* qr = qrec_s + (size_t)r * rec4;
            hit = refine_jaccard<MASK>(
                words + (size_t)cand * w4, points_pad[(size_t)cand * lanes],
                qr, record_size(qr, w4), w4, eps2, zero, cand, qpos_s[r]);
          } else {
            hit = refine_slot<T, MERGED, MASK, GID>(
                points_pad + (size_t)cand * lanes, q_s + r * lanes, eps2,
                n_real, zero, cand, qpos_s[r]);
          }
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
        // stage the chunk's windows: slot s of run u at (u - u0) * seg_cap + s
        const int stage_slots = (u1 - u0) * seg;
        if constexpr (JACCARD) {
          // neighbouring threads copy neighbouring 16-byte vectors of one
          // window's words, then each slot's size
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
        } else {
          // one thread a slot, its n_use lanes in turn
          for (int t = threadIdx.x; t < stage_slots; t += blockDim.x) {
            const int u = u0 + t / seg;
            const int s = t - (u - u0) * seg;
            const int h = run_start_s[u];
            if (s0 + s < wc_s[h]) {
              const T* src = points_pad + (size_t)(ws_s[h] + s0 + s) * lanes;
              T* dst = stage + ((size_t)(u - u0) * seg_cap + s) * n_use;
              for (int k = 0; k < n_use; ++k) dst[k] = src[k];
            }
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
            if constexpr (JACCARD) {
              const uint4* qr = qrec_s + (size_t)r * rec4;
              const uint4* pw = staged ? stage4 + at * rec4
                                       : words + (size_t)cand * w4;
              const float ps = staged ? record_size(pw, w4)
                                      : points_pad[(size_t)cand * lanes];
              hit = refine_jaccard<MASK>(pw, ps, qr, record_size(qr, w4), w4,
                                         eps2, zero, cand, qpos_s[r]);
            } else {
              const T* p = staged ? stage + at * n_use
                                  : points_pad + (size_t)cand * lanes;
              hit = refine_slot<T, MERGED, MASK, GID>(
                  p, q_s + r * lanes, eps2, n_real, zero, cand, qpos_s[r]);
            }
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

// P, the warps a query row of B1 (b) spreads over: the smallest power of
// two with P * kExtSlots >= c, at most kExtWarps
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
            hit = refine_slot<T, MERGED, kMaskExternal, false>(
                points_pad + (size_t)(start + s) * lanes, q, eps2, n_real,
                false, 0, 0);
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
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(arrivals + tile, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the tile's exclusive scan, kExtThreads counts at a time; the counts
  // are read from L2 (__ldcg): other blocks wrote them
  const int* tile_counts = counts + (size_t)tile * tq;
  int carry = 0;
  for (int r0 = 0; r0 < tq; r0 += kExtThreads) {
    const int r = r0 + threadIdx.x;
    const int v = r < tq ? __ldcg(tile_counts + r) : 0;
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
  if (threadIdx.x == 0) arrivals[tile] = 0;
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

template <typename T, bool MERGED, int MASK, bool KEEP_HITS, bool RUN_LOOP,
          bool JACCARD, bool GID>
int launch(const Args& a, cudaStream_t stream) {
  // the query tile: Jaccard's packed records, else the rows as they are
  const size_t q_bytes = JACCARD ? (size_t)a.tq * ((a.wl / 4 + 1) | 1) * 16
                                 : (size_t)a.tq * a.lanes * sizeof(T);
  const size_t smem = q_bytes + 4 * a.tq * sizeof(int)
      + (RUN_LOOP ? (size_t)a.stage_bytes + (2 * a.tq + 2) * sizeof(int) : 0);
  auto kernel =
      fused_join_kernel<T, MERGED, MASK, KEEP_HITS, RUN_LOOP, JACCARD, GID>;
  if (smem > 48 * 1024) {
    // a wide vocabulary's query tile: opt in past the 48 KiB default (the
    // wrapper has checked the device's opt-in limit)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.qp / a.tq, kThreads, smem, stream>>>(
      static_cast<const T*>(a.points_pad), static_cast<const uint4*>(a.words),
      static_cast<const T*>(a.q_batch),
      static_cast<const int*>(a.win_start), static_cast<const int*>(a.win_count),
      static_cast<const int*>(a.is_zero), static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.run_ord), static_cast<const T*>(a.scal),
      static_cast<int8_t*>(a.hits), static_cast<int*>(a.counts),
      static_cast<int*>(a.slot_base), a.n_off, a.qp, a.c, a.n_real, a.n_feat,
      a.lanes, a.wl, a.tq, a.stage_bytes);
  return 0;
}

template <typename T, bool MERGED, int MASK, bool KEEP_HITS, bool JACCARD,
          bool GID>
int launch_run(const Args& a, bool run_loop, cudaStream_t s) {
  if (run_loop)
    return launch<T, MERGED, MASK, KEEP_HITS, true, JACCARD, GID>(a, s);
  return launch<T, MERGED, MASK, KEEP_HITS, false, JACCARD, GID>(a, s);
}

template <typename T, bool MERGED, int MASK, bool JACCARD, bool GID = false>
int launch_keep(const Args& a, bool keep_hits, bool run_loop, cudaStream_t s) {
  if (keep_hits)
    return launch_run<T, MERGED, MASK, true, JACCARD, GID>(a, run_loop, s);
  return launch_run<T, MERGED, MASK, false, JACCARD, GID>(a, run_loop, s);
}

// `gid` (B1 (d)) is instantiated for the l2 refine with the SELF and
// UNICOMP masks only; any other combination is refused.
template <typename T, bool MERGED, bool JACCARD>
int launch_mask(const Args& a, int mask, bool gid, bool keep_hits,
                bool run_loop, cudaStream_t s) {
  if (gid) {
    if constexpr (JACCARD) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      switch (mask) {
        case kMaskSelf:
          return launch_keep<T, MERGED, kMaskSelf, false, true>(
              a, keep_hits, run_loop, s);
        case kMaskUnicomp:
          return launch_keep<T, MERGED, kMaskUnicomp, false, true>(
              a, keep_hits, run_loop, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  switch (mask) {
    case kMaskSelf:
      return launch_keep<T, MERGED, kMaskSelf, JACCARD>(a, keep_hits, run_loop, s);
    case kMaskUnicomp:
      return launch_keep<T, MERGED, kMaskUnicomp, JACCARD>(a, keep_hits, run_loop, s);
    case kMaskExternal:
      if constexpr (JACCARD) {
        return launch_keep<T, MERGED, kMaskExternal, true>(a, keep_hits,
                                                           run_loop, s);
      } else {
        // B1 (b): the run plan is accepted and not read
        if (keep_hits) return launch_external<T, MERGED, true>(a, s);
        return launch_external<T, MERGED, false>(a, s);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_merged(const Args& a, bool merged, int mask, bool gid,
                  bool keep_hits, bool run_loop, cudaStream_t s) {
  if (merged)
    return launch_mask<T, true, false>(a, mask, gid, keep_hits, run_loop, s);
  return launch_mask<T, false, false>(a, mask, gid, keep_hits, run_loop, s);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or cudaErrorInvalidValue for an unknown dtype code
// (0 float32, 1 float64, 2 float16, 3 bfloat16) or mask mode (0 self,
// 1 UNICOMP, 2 external), a Jaccard launch that is not float32 per-cell, or
// a global-id launch with the external mask or Jaccard, or an l2 external
// launch without `arrivals`, its per-tile counters (at least qp / tq
// uint32 zeros, zero again when the launch ends). The Python wrapper
// validates shapes and dtypes (qp % tq == 0, lanes >= n_real + n_feat +
// merged + gid, run_ord with run_loop, Jaccard's words as (rows,
// word_lanes) int32 with word_lanes a multiple of 4) and the
// shared-memory total against fused_join_smem_optin; the drivers pad
// points_pad with a tail of at least c rows, so every window read is in
// bounds.
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
    bad = launch_mask<float, false, true>(a, mask, gid, keep_hits, run_loop,
                                          s);
  } else {
    switch (dtype) {
      case kFloat32:
        bad = launch_merged<float>(a, merged, mask, gid, keep_hits, run_loop,
                                   s);
        break;
      case kFloat64:
        bad = launch_merged<double>(a, merged, mask, gid, keep_hits,
                                    run_loop, s);
        break;
      case kFloat16:
        bad = launch_merged<__half>(a, merged, mask, gid, keep_hits,
                                    run_loop, s);
        break;
      case kBFloat16:
        bad = launch_merged<__nv_bfloat16>(a, merged, mask, gid, keep_hits,
                                           run_loop, s);
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
