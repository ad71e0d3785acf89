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
// What the design does about it: the tile product and predicate are those
// of the count and compact kernels (snn_predicate.cuh: 64 queries x 128
// rows a block, 4 x 8 outputs a thread, operands through shared memory), so
// finite entries are the same float32 numbers the two CSR passes decide on.
// A block whose alpha range no query window of the tile meets writes +BIG
// over its tile and does no product.  Grid axis x walks the query tiles of
// one row block, so the blocks that read a row block run together and find
// it in L2.
#include "snn_predicate.cuh"

namespace snn {
namespace {

__global__ void __launch_bounds__(kThreads)
snn_filter_kernel(Operands op, float* __restrict__ out) {
  __shared__ TileSmem sm;
  const int q0 = blockIdx.x * kTQ, b0 = blockIdx.y * op.bn;
  const int t = threadIdx.x, tx = t & 15;
  const float big = __int_as_float(kBigBits);
  if (!window_hit(op, 0, q0, b0)) {
    for (int e = t; e < kTQ * op.bn; e += kThreads) {
      const int qq = e / op.bn, c = e - qq * op.bn;
      if (q0 + qq < op.m_pad) out[(size_t)(q0 + qq) * op.n_pad + b0 + c] = big;
    }
    return;
  }
  QueryOps qo;
  load_queries(op, q0, qo);
  for (int sub = 0; sub < op.bn; sub += kTR) {
    const int row0 = b0 + sub;
    float acc[kQI][kRJ];
    float al[kRJ], hn[kRJ];
#pragma unroll
    for (int j = 0; j < kRJ; ++j) {
      al[j] = op.al[row0 + tx + 16 * j];
      hn[j] = op.hn[row0 + tx + 16 * j];
    }
    tile_dot<false>(op, 0, q0, row0, sm, acc);
#pragma unroll
    for (int i = 0; i < kQI; ++i) {
      if (qo.qi[i] >= op.m_pad) continue;
      float* orow = out + (size_t)qo.qi[i] * op.n_pad + row0 + tx;
#pragma unroll
      for (int j = 0; j < kRJ; ++j) {
        const float dhalf = hn[j] - acc[i][j];
        orow[16 * j] = pair_keep(op, 0, row0 + tx + 16 * j, qo.qi[i],
                                 qo.aq[i], qo.r[i], qo.th[i], al[j], hn[j],
                                 acc[i][j])
                           ? dhalf : big;
      }
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
