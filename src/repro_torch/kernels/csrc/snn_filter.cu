// Hopper kernel for the dense SNN filter: masked half distances.
//
// snn_filter replaces src/repro/kernels/snn_query.py::snn_filter (the Pallas
// TPU kernel; _filter_kernel) and snn_query_gpu.py::snn_filter.  out[k, j] =
// hn[j] - q[k].xs[j] where the window, radius and box tests keep the pair,
// +BIG elsewhere, over one (n_pad, d_pad) segment.
//
// What bounds it on an H100: it writes the whole (m_pad, n_pad) float32
// matrix, 4*m*n bytes, and evaluates the float32 product of every pair whose
// row block some query window of its tile meets, 2*d FLOP a pair on FFMA
// (no IEEE-float32 tensor-core mode).  At d = 128 a pair costs 256 FLOP
// against 4 bytes written, and the card does about 20 FP32 FLOP per byte
// of memory traffic, so the FFMA rate bounds it where the windows hold more
// than about a third of the pairs and the write rate where they hold fewer.
//
// What the design does about it: each block computes a 64-query x 128-row
// tile with a register-blocked product (4 x 8 outputs a thread, operands
// staged through shared memory), so every shared-memory load feeds several
// FFMAs; each pair's dot product is the fmaf chain over ascending features
// of the count and compact kernels, and its predicate their terms
// (snn_predicate.cuh), so finite entries are the same float32 numbers the
// two CSR passes decide on.  A block whose alpha range no query window of
// the tile meets writes +BIG over its tile and does no product.  Grid axis
// x walks the query tiles of one row block, so the blocks that read a row
// block run together and find it in L2.
#include "snn_predicate.cuh"

namespace snn {
namespace {

// Tile geometry: a block of kThreads threads owns kTQ queries x kTR rows at
// a time; thread (ty, tx) holds queries ty*4 + i (i < 4) and rows tx + 16*j
// (j < 8).  The feature axis streams through shared memory in chunks of
// kChunk.
constexpr int kThreads = 256;
constexpr int kTQ = 64;
constexpr int kTR = 128;
constexpr int kQI = 4;
constexpr int kRJ = 8;
constexpr int kChunk = 32;

struct TileSmem {
  float q[kChunk][kTQ + 1];  // transposed chunks; +1 keeps the stores
  float x[kChunk][kTR + 1];  // and the reads free of bank conflicts
};

// acc[i][j] = sum_k q[q0 + ty*4 + i, k] * xs[row0 + tx + 16*j, k], summed
// over k = 0, 1, ..., d_pad - 1 in that order with fmaf.
__device__ __forceinline__ void filter_tile_dot(const Operands& op, int q0,
                                                int row0, TileSmem& sm,
                                                float (&acc)[kQI][kRJ]) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
#pragma unroll
  for (int i = 0; i < kQI; ++i)
#pragma unroll
    for (int j = 0; j < kRJ; ++j) acc[i][j] = 0.f;
  const float* xb = op.xs + (size_t)row0 * op.d_pad;
  for (int k0 = 0; k0 < op.d_pad; k0 += kChunk) {
    for (int e = t; e < kTQ * kChunk / 4; e += kThreads) {
      const int row = e >> 3, k4 = (e & 7) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + row < op.m_pad)
        v = *reinterpret_cast<const float4*>(
            op.q + (size_t)(q0 + row) * op.d_pad + k0 + k4);
      sm.q[k4 + 0][row] = v.x; sm.q[k4 + 1][row] = v.y;
      sm.q[k4 + 2][row] = v.z; sm.q[k4 + 3][row] = v.w;
    }
    for (int e = t; e < kTR * kChunk / 4; e += kThreads) {
      const int row = e >> 3, k4 = (e & 7) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          xb + (size_t)row * op.d_pad + k0 + k4);
      sm.x[k4 + 0][row] = v.x; sm.x[k4 + 1][row] = v.y;
      sm.x[k4 + 2][row] = v.z; sm.x[k4 + 3][row] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
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

// The full float32 predicate of one pair given its dot product.
__device__ __forceinline__ bool pair_keep(const Operands& op, int row, int qi,
                                          float aq, float r, float th,
                                          float al, float hn, float dot) {
  if (!(in_ball(hn, dot, th) && in_window(al, aq, r))) return false;
  if (op.ke == 0) return true;
  const float lim = box_lim(r, row_norm(hn), query_norm(r, th));
  for (int c = 0; c < op.ke; ++c)
    if (!in_box(op.px[(size_t)c * op.n_pad + row],
                op.pq[(size_t)c * op.m_pad + qi], lim))
      return false;
  return true;
}

__global__ void __launch_bounds__(kThreads)
snn_filter_kernel(Operands op, float* __restrict__ out) {
  __shared__ TileSmem sm;
  const int q0 = blockIdx.x * kTQ, b0 = blockIdx.y * op.bn;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const float big = __int_as_float(kBigBits);
  const float inf = __int_as_float(0x7f800000);
  bool hit = false;
  if (t < kTQ && q0 + t < op.m_pad) {
    const float aq = op.aq[q0 + t], r = op.r[q0 + t];
    hit = (aq + r >= op.al[b0]) && (aq - r <= op.al[b0 + op.bn - 1]);
  }
  if (!__syncthreads_or(hit)) {
    for (int e = t; e < kTQ * op.bn; e += kThreads) {
      const int qq = e / op.bn, c = e - qq * op.bn;
      if (q0 + qq < op.m_pad) out[(size_t)(q0 + qq) * op.n_pad + b0 + c] = big;
    }
    return;
  }
  // a query index past m_pad gets the match-nothing radius
  float aq[kQI], r[kQI], th[kQI];
#pragma unroll
  for (int i = 0; i < kQI; ++i) {
    const int qi = q0 + ty * kQI + i;
    const bool ok = qi < op.m_pad;
    aq[i] = ok ? op.aq[qi] : 0.f;
    r[i] = ok ? op.r[qi] : -inf;
    th[i] = ok ? op.th[qi] : -inf;
  }
  for (int sub = 0; sub < op.bn; sub += kTR) {
    const int row0 = b0 + sub;
    float acc[kQI][kRJ];
    float al[kRJ], hn[kRJ];
#pragma unroll
    for (int j = 0; j < kRJ; ++j) {
      al[j] = op.al[row0 + tx + 16 * j];
      hn[j] = op.hn[row0 + tx + 16 * j];
    }
    filter_tile_dot(op, q0, row0, sm, acc);
#pragma unroll
    for (int i = 0; i < kQI; ++i) {
      const int qi = q0 + ty * kQI + i;
      if (qi >= op.m_pad) continue;
      float* orow = out + (size_t)qi * op.n_pad + row0 + tx;
#pragma unroll
      for (int j = 0; j < kRJ; ++j)
        orow[16 * j] = pair_keep(op, row0 + tx + 16 * j, qi, aq[i], r[i],
                                 th[i], al[j], hn[j], acc[i][j])
                           ? hn[j] - acc[i][j] : big;
    }
  }
}

}  // namespace
}  // namespace snn

// The C interface bound with ctypes (repro_torch/kernels/snn_query.py): xs
// (n_pad, d_pad), al/hn (n_pad,), px (ke, n_pad) or null, out (m_pad, n_pad).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int snn_filter(const float* q, const float* aq, const float* r,
                          const float* th, const float* xs, const float* al,
                          const float* hn, const float* pq, const float* px,
                          int m_pad, int n_pad, int d_pad, int ke, int bn,
                          float* out, void* stream) {
  using namespace snn;
  const Operands op{q, aq, r, th, xs, al, hn, pq, px,
                    1, m_pad, n_pad, d_pad, ke, bn};
  const dim3 grid((m_pad + kTQ - 1) / kTQ, n_pad / bn, 1);
  snn_filter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, out);
  return static_cast<int>(cudaGetLastError());
}
