// The shared SNN predicate, and the tile product of the count and compact
// kernels (snn_query.cu) and the filter (snn_filter.cu).
//
// Both passes of the CSR engine must make the same keep decision for every
// (query, row) pair: pass 1 sizes each CSR row, pass 2 fills it.  They agree
// because both call the functions below: one tile product that accumulates
// every dot product as one fmaf chain over the feature axis in ascending
// order, whatever the tile or the block it lands in, and one elementwise
// predicate written as the same float32 expression tree as the plain version
// (repro_torch/kernels/ref.py).  The filter calls the same product and the
// same keep decisions, so its finite entries are the compact's dhalf.  The
// files are built with --fmad=false, so no other multiply-add is
// contracted, and without fast math: the padding sentinels rely on IEEE inf
// and NaN.
//
// What bounds the product on an H100: the exact predicate needs IEEE float32
// products, which Hopper's tensor cores do not offer, so it runs on FFMA
// (67 TFLOP/s on the H100 SXM at 700 W: 128 FFMA a clock an SM).  A
// product that loads a shared-memory word for each FFMA is bound by shared
// memory (128 bytes a clock an SM) at a quarter of that, and one whose
// loads and barriers stall the warps that issue the FFMAs by latency.
//
// What the design does about it:
// - register blocking: a block owns kTeams * 8 query slots x 128 rows and
//   each thread an 8 x 8 micro-tile, so per feature a thread reads two
//   float4 of query slots and two float4 of rows (LDS.128) and issues 64
//   FFMA;
// - feature-major operands in shared memory, rows of kSlots + 4 and
//   128 * kSubs + 4 floats: the float4 reads stay aligned, the 16 lanes of
//   a team read 256 contiguous bytes (the least two wavefronts can carry),
//   the two teams of a warp read neighbouring query chunks, and a warp's
//   transposing stores meet at most two to a bank;
// - two stages in turn: each thread's 16-byte global loads of the next
//   chunk of features are in flight to registers while the FFMAs run on
//   this stage, and are stored transposed into the other stage after them,
//   so there is one barrier a chunk.  This beat cp.async rings of 2 and 3
//   stages (4-byte copies into the same feature-major layout, or 16-byte
//   copies into feature-contiguous rows read as float4 along the features)
//   by 17-36% on the H100, since a 16-byte cp.async cannot transpose and a
//   4-byte one costs an instruction and an address a word
//   (experiments/tile_product);
// - an epilogue that tests the radius on every pair of the micro-tile from
//   registers and leaves the window and the box to the few pairs that pass
//   it.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace snn {

constexpr float kBoxEps = 1e-2f;        // ref.BOX_EPS
constexpr float kMixEps = 1.0f / 64.0f;  // ref.MIX_EPS
constexpr int kBigBits = 0x7dffffff;     // ref.BIG = FLT_MAX / 8, exactly

struct Operands {
  const float* q;   // (m_pad, d_pad) centred queries
  const float* aq;  // (m_pad,) query alphas
  const float* r;   // (m_pad,) radii; -BIG on padding queries
  const float* th;  // (m_pad,) half-norm thresholds; -BIG on padding queries
  const float* xs;  // (S, n_pad, d_pad) sorted rows of every segment
  const float* al;  // (S, n_pad) alphas, +BIG on padding rows
  const float* hn;  // (S, n_pad) half norms, +BIG on padding rows
  const float* pq;  // (ke, m_pad) extra query projections, or null
  const float* px;  // (S, ke, n_pad) extra row projections, or null
  int S, m_pad, n_pad, d_pad, ke, bn;
};

// ---------------------------------------------------------------------------
// The predicate, term by term (ref.snn_filter_ref, ref.box_mask,
// ref.norm_scales, ref.mixed_keep_ref).
// ---------------------------------------------------------------------------

// max(v, 0) that keeps a NaN, like torch.clamp_min and jnp.maximum.
__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float row_norm(float hn) {
  return sqrtf(clamp0(2.0f * hn));
}
__device__ __forceinline__ float query_norm(float r, float th) {
  return sqrtf(clamp0(r * r - 2.0f * th));
}
// the radius test on the half distance hn - q.x
__device__ __forceinline__ bool in_ball(float hn, float dot, float th) {
  return hn - dot <= th;
}
// the alpha window
__device__ __forceinline__ bool in_window(float al, float aq, float r) {
  return fabsf(al - aq) <= r;
}
// the box half-width of one pair, from the row's and the query's norms
__device__ __forceinline__ float box_lim(float r, float xn, float qn) {
  return r + kBoxEps * ((xn + qn) + fabsf(r));
}
__device__ __forceinline__ bool in_box(float px, float pq, float lim) {
  return fabsf(px - pq) <= lim;
}

// ---------------------------------------------------------------------------
// The tile product of the count, compact and filter kernels.
// ---------------------------------------------------------------------------

// A block has kTeams teams of 16 threads.  Thread (team ty, lane tx) holds
// the 8 x 8 micro-tile of query slots ty*8 + i (i < 8) and rows row_of(j)
// (j < 8) of a kRows-row tile: rows 4*tx .. 4*tx + 3 and 64 + 4*tx ..
// 64 + 4*tx + 3, so that each half is one float4 in shared memory.
constexpr int kRows = 128;
constexpr int kMI = 8;
constexpr int kMJ = 8;

__device__ __forceinline__ int row_of(int tx, int j) {
  return (j & 4) * 16 + 4 * tx + (j & 3);
}

// A block of kTeams teams with kTeams * 8 query slots and room for kSubs
// 128-row sub-tiles in shared memory, kKC features a stage.
template <int kTeams, int kSubs, int kKC>
struct Tile {
  static constexpr int kThreads = kTeams * 16;
  static constexpr int kSlots = kTeams * kMI;
  static constexpr int kXRows = kSubs * kRows;
  // a stage holds kKC features of every slot and every row, feature-major;
  // rows of kSlots + 4 and kXRows + 4 floats keep the float4 reads aligned
  // and put feature k's word of row r in bank (4k + r) mod 32
  static constexpr int kQld = kSlots + 4;
  static constexpr int kXld = kXRows + 4;
  static constexpr int kStageQ = kKC * kQld;
  static constexpr int kStage = kStageQ + kKC * kXld;
  // the copy: each thread moves up to kPer float4 (4 features of one row) a
  // stage, of rows t / (kKC/4) + kRowStep * u, the query slots first, then
  // the rows
  static constexpr int kRowStep = kThreads / (kKC / 4);
  static constexpr int kPer = (kSlots + kXRows + kRowStep - 1) / kRowStep;
  // dynamic shared memory: two stages, then the slots' extra projections
  static size_t smem_bytes(int ke) {
    return sizeof(float) * (2 * (size_t)kStage + (size_t)kSlots * ke);
  }
  // the column of query slot p: slots 8g .. 8g + 3 at 4g, 8g + 4 .. 8g + 7
  // at kSlots/2 + 4g
  static __device__ __forceinline__ int slot_col(int p) {
    return (p & 4) * (kSlots / 8) + 4 * (p >> 3) + (p & 3);
  }
};

// Per-slot query operands, loaded once per block.
template <int kSlots>
struct SlotOps {
  float aq[kSlots], r[kSlots], th[kSlots], qn[kSlots];
};

// Fill slot p with query q's operands; q < 0 leaves an empty slot that
// matches nothing (the radius and threshold of a padding query, -inf).
template <int kSlots>
__device__ __forceinline__ void fill_slot(const Operands& op, int p, int q,
                                          SlotOps<kSlots>& so, float* spq) {
  const float inf = __int_as_float(0x7f800000);
  const bool ok = q >= 0;
  const float r = ok ? op.r[q] : -inf, th = ok ? op.th[q] : -inf;
  so.aq[p] = ok ? op.aq[q] : 0.f;
  so.r[p] = r;
  so.th[p] = th;
  so.qn[p] = query_norm(r, th);
  for (int c = 0; c < op.ke; ++c)
    spq[c * kSlots + p] = ok ? op.pq[(size_t)c * op.m_pad + q] : 0.f;
}

// acc[i][j] = sum_k Q[slot 8g + i, k] * X[128 sub + row_of(tx, j), k], each
// summed over k = 0, 1, ..., d_pad - 1 in that order with fmaf: team
// (g, sub) of the calling thread.  Q's slots hold rows qrow(0), ...,
// qrow(n_q - 1) (later slots are not loaded), X's rows xrow(0), ...,
// xrow(n_x - 1).  With kBf16 both operands are first rounded to bfloat16
// (their products stay exact in float32, the sum is float32): the count
// pass of mixed=True.  Every thread of the block takes part in the copies
// and barriers; only those with `compute` run the FFMAs.  Shared memory is
// free again on return.
//
// Two stages alternate: while the FFMAs run on one, each thread's 16-byte
// loads of the next chunk are in flight to registers, and they are stored
// into the other stage, transposed to feature-major, after the FFMAs.  One
// barrier a chunk.
template <int kTeams, int kSubs, int kKC, bool kBf16, class QRow, class XRow>
__device__ __forceinline__ void tile_product(const Operands& op, QRow qrow,
                                             int n_q, XRow xrow, int n_x,
                                             int g, int sub, bool compute,
                                             float* smem,
                                             float (&acc)[kMI][kMJ]) {
  using T = Tile<kTeams, kSubs, kKC>;
  const int t = threadIdx.x, tx = t & 15;
  const int c4 = 4 * (t % (kKC / 4)), r0 = t / (kKC / 4);
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kMJ; ++j) acc[i][j] = 0.f;
  const int nk = op.d_pad / kKC;
  // operand row `row`: query slot row below kSlots, row row - kSlots of X
  // above
  auto loaded = [&](int row) {
    return row < T::kSlots ? row < n_q : row - T::kSlots < n_x;
  };
  float4 v[T::kPer];
  auto fetch = [&](int kc) {
#pragma unroll
    for (int u = 0; u < T::kPer; ++u) {
      const int row = r0 + T::kRowStep * u;
      if (!loaded(row)) continue;
      const float* src = row < T::kSlots ? qrow(row) : xrow(row - T::kSlots);
      v[u] = *reinterpret_cast<const float4*>(src + kc * kKC + c4);
      if (kBf16) {
        v[u].x = round_bf16(v[u].x); v[u].y = round_bf16(v[u].y);
        v[u].z = round_bf16(v[u].z); v[u].w = round_bf16(v[u].w);
      }
    }
  };
  auto store = [&](int st) {
#pragma unroll
    for (int u = 0; u < T::kPer; ++u) {
      const int row = r0 + T::kRowStep * u;
      if (!loaded(row)) continue;
      float* dst = row < T::kSlots
          ? smem + st * T::kStage + c4 * T::kQld + T::slot_col(row)
          : smem + st * T::kStage + T::kStageQ + c4 * T::kXld + row - T::kSlots;
      const int ld = row < T::kSlots ? T::kQld : T::kXld;
      dst[0] = v[u].x;
      dst[ld] = v[u].y;
      dst[2 * ld] = v[u].z;
      dst[3 * ld] = v[u].w;
    }
  };
  fetch(0);
  store(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < nk) fetch(kc + 1);
    if (compute) {
      const float* sq = smem + st * T::kStage + 4 * g;
      const float* sx = smem + st * T::kStage + T::kStageQ + kRows * sub +
                        4 * tx;
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(sq + k * T::kQld);
        const float4 a1 = *reinterpret_cast<const float4*>(
            sq + k * T::kQld + T::kSlots / 2);
        const float4 b0 = *reinterpret_cast<const float4*>(sx + k * T::kXld);
        const float4 b1 =
            *reinterpret_cast<const float4*>(sx + k * T::kXld + 64);
        const float a[kMI] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[kMJ] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int j = 0; j < kMJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (kc + 1 < nk) store(st ^ 1);
    __syncthreads();
  }
}

// The box test of one pair: row `row` of segment s (half norm hn) against
// query slot `slot`.
template <int kSlots>
__device__ __forceinline__ bool in_box_all(const Operands& op, int s, int row,
                                           float hn, int slot,
                                           const SlotOps<kSlots>& so,
                                           const float* spq) {
  const float lim = box_lim(so.r[slot], row_norm(hn), so.qn[slot]);
  for (int c = 0; c < op.ke; ++c)
    if (!in_box(op.px[((size_t)s * op.ke + c) * op.n_pad + row],
                spq[c * kSlots + slot], lim))
      return false;
  return true;
}

// The float32 keep decisions of a thread's micro-tile: bit i*8 + j for slot
// 8g + i and row row0 + row_of(tx, j) of segment s, whose alphas and half
// norms ral and rhn hold (128 rows from row0, in shared or global memory).
// The radius test runs on every pair, the window and the box only on the
// few pairs that pass it (the survivors and their near misses).
template <int kSlots>
__device__ __forceinline__ uint64_t keep_f32(const Operands& op, int s,
                                             int row0, const float* ral,
                                             const float* rhn,
                                             const SlotOps<kSlots>& so,
                                             const float* spq, int g,
                                             const float (&acc)[kMI][kMJ]) {
  const int tx = threadIdx.x & 15;
  float hn[kMJ];
#pragma unroll
  for (int j = 0; j < kMJ; ++j) hn[j] = rhn[row_of(tx, j)];
  uint64_t ball = 0;
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const float th = so.th[g * kMI + i];
#pragma unroll
    for (int j = 0; j < kMJ; ++j)
      if (in_ball(hn[j], acc[i][j], th)) ball |= (uint64_t)1 << (i * kMJ + j);
  }
  uint64_t keep = 0;
  for (uint64_t rest = ball; rest; rest &= rest - 1) {
    const int bit = __ffsll(static_cast<long long>(rest)) - 1;
    const int slot = g * kMI + bit / kMJ, row = row_of(tx, bit % kMJ);
    if (in_window(ral[row], so.aq[slot], so.r[slot]) &&
        (op.ke == 0 ||
         in_box_all(op, s, row0 + row, rhn[row], slot, so, spq)))
      keep |= (uint64_t)1 << bit;
  }
  return keep;
}

// Does the alpha window of query slot `slot` meet the alpha range of rows
// row0 .. row1 (sorted) of segment s?  The block-skip test of the TPU
// kernels (_window_hit).
template <int kSlots>
__device__ __forceinline__ bool slot_meets(const Operands& op, int s,
                                           int row0, int row1, int slot,
                                           const SlotOps<kSlots>& so) {
  const float a_lo = op.al[(size_t)s * op.n_pad + row0];
  const float a_hi = op.al[(size_t)s * op.n_pad + row1];
  return (so.aq[slot] + so.r[slot] >= a_lo) &&
         (so.aq[slot] - so.r[slot] <= a_hi);
}

}  // namespace snn
