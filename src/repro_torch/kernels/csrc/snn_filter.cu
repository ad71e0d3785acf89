// Hopper kernel for the dense SNN filter: masked half distances.
//
// snn_filter replaces src/repro/kernels/snn_query.py::snn_filter (the Pallas
// TPU kernel; _filter_kernel) and snn_query_gpu.py::snn_filter.  out[k, j] =
// hn[j] - q[k].xs[j] where the window, radius and box tests keep the pair,
// +BIG elsewhere, over one (n_pad, d_pad) segment.
//
// What bounds it on an H100: it writes the whole (m_pad, n_pad) float32
// matrix, 4*m*n bytes, and evaluates the float32 product of every pair whose
// 128 x 128 tile some query window of the tile meets, 2*d FLOP a pair on
// FFMA (no IEEE-float32 tensor-core mode).  At d = 128 a pair costs 256 FLOP
// against 4 bytes written, and the card does about 20 FP32 FLOP per byte of
// memory traffic, so the FFMA rate bounds it where the windows hold more
// than about a third of the pairs and the write rate where they hold fewer.
//
// What the design does about it:
// - the count's tile product (snn_predicate.cuh): one block a 128-query x
//   128-row tile, 256 threads with 8 x 8 outputs each, two register-staged
//   stages, and the radius test on every pair from registers with the
//   window and box only on the pairs that pass it (keep_f32).  Each finite
//   entry is the same fmaf chain and the same keep decision as the count's
//   and the compact's, so it equals the compact's dhalf bit for bit;
// - query tiles in alpha order: slot p of query tile qt holds query
//   order[qt*128 + p] (the wrapper's stable argsort of the query alphas) and
//   writes that query's row of out.  A tile of alpha-sorted queries has a
//   narrow union of windows, so more 128 x 128 tiles meet none of them (at
//   the point-query shape 31% of the tiles, not 0.2%); such a tile writes
//   +BIG and does no load or product;
// - 16-byte stores: a thread holds rows 4*tx .. 4*tx + 3 and 64 + 4*tx ..
//   of its slots, so each slot's outputs leave as two float4 stores and a
//   team of 16 lanes writes two runs of 256 contiguous bytes; a skipped
//   tile's +BIG leaves the same way.  The stores are streaming (__stcs,
//   evict first), so that the output pushes less out of L2 of the rows that
//   the row tile's other query tiles read again: 1.0-1.3% faster than plain
//   stores at the point-query shape on the H100, and without the plain
//   build's 12 bytes of spills (PERF.md);
// - a one-dimensional grid with the query tile fastest, so the blocks that
//   read a row tile run together and find it in L2.
#include "snn_launch.cuh"
#include "snn_predicate.cuh"

namespace snn {
namespace {

using FilterTile = Tile<16, 1, 16>;

// a 16-byte streaming (evict first) store
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// One block a (query tile, row tile); grid ceil(m_pad / 128) * (n_pad / 128)
// blocks, the query tile fastest.  `order` (m_pad,) lists the queries in
// the order they are tiled.
__global__ void __launch_bounds__(FilterTile::kThreads, 2)
snn_filter_kernel(Operands op, const long long* __restrict__ order, int nqt,
                  float* __restrict__ out) {
  using T = FilterTile;
  extern __shared__ __align__(16) float smem[];
  __shared__ SlotOps<T::kSlots> so;
  __shared__ int qid[T::kSlots];  // each slot's query, -1 past m_pad
  __shared__ __align__(16) float ral[kRows], rhn[kRows];  // the tile's rows
  float* spq = smem + 2 * T::kStage;
  const int qt = blockIdx.x % nqt, row0 = (blockIdx.x / nqt) * kRows;
  const int q0 = qt * T::kSlots, n_q = min(T::kSlots, op.m_pad - q0);
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const float big = __int_as_float(kBigBits);

  bool hit = false;
  if (t < T::kSlots) {
    const int q = t < n_q ? static_cast<int>(order[q0 + t]) : -1;
    qid[t] = q;
    fill_slot(op, t, q, so, spq);
    hit = slot_meets(op, 0, row0, row0 + kRows - 1, t, so);
  }
  for (int r = t; r < kRows; r += T::kThreads) {
    ral[r] = op.al[row0 + r];
    rhn[r] = op.hn[row0 + r];
  }
  if (!__syncthreads_or(hit)) {
    const float4 big4 = make_float4(big, big, big, big);
    for (int e = t; e < T::kSlots * kRows / 4; e += T::kThreads) {
      const int q = qid[e / (kRows / 4)];
      if (q >= 0)
        store4(out + (size_t)q * op.n_pad + row0 + 4 * (e % (kRows / 4)), big4);
    }
    return;
  }

  auto qrow = [&](int p) { return op.q + (size_t)qid[p] * op.d_pad; };
  auto xrow = [&](int r) { return op.xs + (size_t)(row0 + r) * op.d_pad; };
  float acc[kMI][kMJ];
  tile_product<16, 1, 16, false>(op, qrow, n_q, xrow, kRows, ty, 0, true,
                                 smem, acc);
  const uint64_t keep = keep_f32(op, 0, row0, ral, rhn, so, spq, ty, acc);
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int q = qid[ty * kMI + i];
    if (q < 0) continue;
    const uint32_t kb = static_cast<uint32_t>(keep >> (i * kMJ)) & 0xffu;
    float* o = out + (size_t)q * op.n_pad + row0 + 4 * tx;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows 4*tx.. of each 64-row half
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * h + c;
        v[c] = (kb >> j) & 1u ? rhn[row_of(tx, j)] - acc[i][j] : big;
      }
      store4(o + 64 * h, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
}

}  // namespace
}  // namespace snn

// The C interface bound with ctypes (repro_torch/kernels/snn_query.py): xs
// (n_pad, d_pad), al/hn (n_pad,), px (ke, n_pad) or null, order (m_pad,) a
// permutation of the queries (their stable alpha order), out (m_pad,
// n_pad).  bn is a multiple of 128 that divides n_pad; the kernel skips by
// 128-row tiles.  Launches on `stream` and returns the CUDA error of the
// launch.
extern "C" int snn_filter(const float* q, const float* aq, const float* r,
                          const float* th, const float* xs, const float* al,
                          const float* hn, const float* pq, const float* px,
                          int m_pad, int n_pad, int d_pad, int ke, int bn,
                          const long long* order, float* out, void* stream) {
  using namespace snn;
  using T = FilterTile;
  const Operands op{q, aq, r, th, xs, al, hn, pq, px,
                    1, m_pad, n_pad, d_pad, ke, bn};
  const int nqt = (int)ceil_div(m_pad, T::kSlots);
  const Geometry g{T::kSlots, T::kThreads, nqt * (long long)(n_pad / kRows),
                   T::smem_bytes(ke)};
  return static_cast<int>(launch<snn_filter_kernel>(
      g, current_device().id, static_cast<cudaStream_t>(stream), op, order,
      nqt, out));
}
