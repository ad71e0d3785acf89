// The shared SNN predicate of the count and compact kernels (snn_query.cu).
//
// Both passes of the CSR engine must make the same keep decision for every
// (query, row) pair: pass 1 sizes each CSR row, pass 2 fills it.  They agree
// because both call the functions below: one tile product that accumulates
// every dot product over the feature axis in ascending order with explicit
// fmaf, and one elementwise predicate written as the same float32 expression
// tree as the plain version (repro_torch/kernels/ref.py).  The file is built
// with --fmad=false, so no other multiply-add is contracted, and without
// fast math: the padding sentinels rely on IEEE inf and NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace snn {

constexpr float kBoxEps = 1e-2f;        // ref.BOX_EPS
constexpr float kMixEps = 1.0f / 64.0f;  // ref.MIX_EPS
constexpr int kBigBits = 0x7dffffff;     // ref.BIG = FLT_MAX / 8, exactly

// Tile geometry: a block of kThreads threads owns kTQ queries x kTR rows of
// one segment at a time; thread (ty, tx) holds queries ty*4 + i (i < 4) and
// rows tx + 16*j (j < 8).  The feature axis streams through shared memory in
// chunks of kKC.
constexpr int kThreads = 256;
constexpr int kTQ = 64;
constexpr int kTR = 128;
constexpr int kKC = 32;
constexpr int kQI = 4;
constexpr int kRJ = 8;

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

struct TileSmem {
  float q[kKC][kTQ + 1];  // transposed chunks; +1 keeps the stores
  float x[kKC][kTR + 1];  // and the reads free of bank conflicts
};

// max(v, 0) that keeps a NaN, like torch.clamp_min and jnp.maximum.
__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[i][j] = sum_k q[q0 + ty*4 + i, k] * xs[s, row0 + tx + 16*j, k], summed
// over k = 0, 1, ..., d_pad - 1 in that order with fmaf.  With kBf16 both
// operands are first rounded to bfloat16 (the products stay exact in float32
// and the sum is float32): the count pass of mixed=True.
template <bool kBf16>
__device__ __forceinline__ void tile_dot(const Operands& op, int s, int q0,
                                         int row0, TileSmem& sm,
                                         float (&acc)[kQI][kRJ]) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
#pragma unroll
  for (int i = 0; i < kQI; ++i)
#pragma unroll
    for (int j = 0; j < kRJ; ++j) acc[i][j] = 0.f;
  const float* xb = op.xs + ((size_t)s * op.n_pad + row0) * op.d_pad;
  for (int k0 = 0; k0 < op.d_pad; k0 += kKC) {
    for (int e = t; e < kTQ * kKC / 4; e += kThreads) {
      const int row = e >> 3, k4 = (e & 7) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + row < op.m_pad)
        v = *reinterpret_cast<const float4*>(
            op.q + (size_t)(q0 + row) * op.d_pad + k0 + k4);
      if (kBf16) {
        v.x = round_bf16(v.x); v.y = round_bf16(v.y);
        v.z = round_bf16(v.z); v.w = round_bf16(v.w);
      }
      sm.q[k4 + 0][row] = v.x; sm.q[k4 + 1][row] = v.y;
      sm.q[k4 + 2][row] = v.z; sm.q[k4 + 3][row] = v.w;
    }
    for (int e = t; e < kTR * kKC / 4; e += kThreads) {
      const int row = e >> 3, k4 = (e & 7) * 4;
      float4 v = *reinterpret_cast<const float4*>(
          xb + (size_t)row * op.d_pad + k0 + k4);
      if (kBf16) {
        v.x = round_bf16(v.x); v.y = round_bf16(v.y);
        v.z = round_bf16(v.z); v.w = round_bf16(v.w);
      }
      sm.x[k4 + 0][row] = v.x; sm.x[k4 + 1][row] = v.y;
      sm.x[k4 + 2][row] = v.z; sm.x[k4 + 3][row] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float a[kQI], b[kRJ];
#pragma unroll
      for (int i = 0; i < kQI; ++i) a[i] = sm.q[kk][ty * kQI + i];
#pragma unroll
      for (int j = 0; j < kRJ; ++j) b[j] = sm.x[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kQI; ++i)
#pragma unroll
        for (int j = 0; j < kRJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Per-query operands of one thread's kQI queries.  A query index past m_pad
// gets the match-nothing radius, like a padding query.
struct QueryOps {
  float aq[kQI], r[kQI], th[kQI];
  int qi[kQI];
};

__device__ __forceinline__ void load_queries(const Operands& op, int q0,
                                             QueryOps& qo) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kQI; ++i) {
    const int qi = q0 + ty * kQI + i;
    qo.qi[i] = qi;
    const bool ok = qi < op.m_pad;
    qo.aq[i] = ok ? op.aq[qi] : 0.f;
    qo.r[i] = ok ? op.r[qi] : -__int_as_float(0x7f800000);
    qo.th[i] = ok ? op.th[qi] : -__int_as_float(0x7f800000);
  }
}

// ref.norm_scales for one row / one query.
__device__ __forceinline__ float row_norm(float hn) {
  return sqrtf(clamp0(2.0f * hn));
}
__device__ __forceinline__ float query_norm(float r, float th) {
  return sqrtf(clamp0(r * r - 2.0f * th));
}

// The window and box parts of the predicate (everything but the distance):
// ref.snn_filter_ref's inwin and ref.box_mask, term for term.
__device__ __forceinline__ bool geometry_keep(const Operands& op, int s,
                                              int row, int qi, float aq,
                                              float r, float th, float al,
                                              float hn) {
  if (!(fabsf(al - aq) <= r)) return false;
  if (op.ke == 0) return true;
  const float lim = r + kBoxEps * ((row_norm(hn) + query_norm(r, th)) + fabsf(r));
  for (int c = 0; c < op.ke; ++c) {
    const float p = op.px[((size_t)s * op.ke + c) * op.n_pad + row];
    if (!(fabsf(p - op.pq[(size_t)c * op.m_pad + qi]) <= lim)) return false;
  }
  return true;
}

// The full float32 predicate of one pair given its dot product.
__device__ __forceinline__ bool pair_keep(const Operands& op, int s, int row,
                                          int qi, float aq, float r, float th,
                                          float al, float hn, float dot) {
  return (hn - dot <= th) && geometry_keep(op, s, row, qi, aq, r, th, al, hn);
}

// Does any query window of the tile meet the block's alpha range?  The
// block-skip test of the TPU kernels (_window_hit), taken over kTQ queries.
__device__ __forceinline__ bool window_hit(const Operands& op, int s, int q0,
                                           int b0) {
  const int t = threadIdx.x;
  bool hit = false;
  if (t < kTQ && q0 + t < op.m_pad) {
    const float a_lo = op.al[(size_t)s * op.n_pad + b0];
    const float a_hi = op.al[(size_t)s * op.n_pad + b0 + op.bn - 1];
    const float aq = op.aq[q0 + t], r = op.r[q0 + t];
    hit = (aq + r >= a_lo) && (aq - r <= a_hi);
  }
  return __syncthreads_or(hit) != 0;
}

}  // namespace snn
