// Hopper kernels for the two passes of the SNN CSR engine.
//
// snn_count_stacked   replaces src/repro/kernels/snn_query.py::snn_count_stacked
//                     (the Pallas TPU kernel; _count_stacked_kernel, _count_tile).
// snn_compact_stacked replaces src/repro/kernels/snn_query.py::snn_compact_stacked
//                     (_compact_stacked_kernel).
// snn_count           replaces src/repro/kernels/snn_query.py::snn_count and
//                     snn_query_gpu.py::_partial_counts (one segment).
// snn_compact         replaces src/repro/kernels/snn_query.py::snn_compact and
//                     snn_query_gpu.py::snn_compact (one segment).
//
// The single-segment entry points launch the stacked kernels with S = 1: a
// (n_pad, d_pad) segment is a stack of one, and a pack-flat id s*n_pad + row
// is then the local row.  The looped executor (one launch per segment) and
// the packed one (one launch per stack) thus run one compiled predicate, so
// their outputs are bit-identical.
//
// What bounds them on an H100: both passes evaluate the distance predicate of
// every (query, row) pair whose block the alpha window does not skip, up to
// 2*m*n*d floating-point operations in float32, against reading the
// database once.  The exact predicate has to be float32: Hopper's tensor
// cores have no IEEE-float32 mode, so the products run on FFMA and the bound
// is the FFMA rate (NVIDIA's data sheet: 67 TFLOP/s for the H100 SXM at its
// 700 W limit), not memory.
//
// What the design does about it: each block computes a 64-query x 128-row
// tile with a register-blocked product (4 x 8 outputs per thread, operands
// staged through shared memory), so every shared-memory load feeds several
// FFMAs.  Grid axis x walks the query tiles of one row block, so the blocks
// that read a row block run together and find it in L2: the database is read
// from device memory about once.  Blocks whose alpha range no query window of
// the tile meets return before any product (the sorted-window prune).
// wgmma, TMA and a deeper pipeline are later work.
//
// The TPU compact kernel runs a sequential grid and carries a per-query
// cursor across row blocks.  Here blocks run in parallel: the count kernel
// also writes per-(segment, query, row block) partial counts, the wrapper
// turns them into an exclusive prefix over row blocks, and each compact block
// starts writing query k's survivors at its own base.  Inside a block a
// survivor's slot is the base plus its rank in its CSR row, taken from a
// shared-memory bitmask of the tile's keep decisions.  The outputs live in
// device memory, so nnz has no on-chip cap.
#include <cstdint>

#include "snn_predicate.cuh"

namespace snn {
namespace {

// Per-(segment, query) survivor counts, summed over row blocks with integer
// atomics (an order-free, exact sum).  `partials`, when not null, receives
// the (S, m_pad, n_pad / bn) per-row-block counts that size the compact pass.
template <bool kMixed>
__global__ void __launch_bounds__(kThreads)
snn_count_stacked_kernel(Operands op, int* __restrict__ counts,
                         int* __restrict__ partials) {
  __shared__ TileSmem sm;
  __shared__ int cnt[kTQ];
  const int q0 = blockIdx.x * kTQ, blk = blockIdx.y, s = blockIdx.z;
  const int b0 = blk * op.bn, nb = op.n_pad / op.bn;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  if (t < kTQ) cnt[t] = 0;
  if (window_hit(op, s, q0, b0)) {
    QueryOps qo;
    load_queries(op, q0, qo);
    for (int sub = 0; sub < op.bn; sub += kTR) {
      const int row0 = b0 + sub;
      float acc[kQI][kRJ];
      float al[kRJ], hn[kRJ];
#pragma unroll
      for (int j = 0; j < kRJ; ++j) {
        al[j] = op.al[(size_t)s * op.n_pad + row0 + tx + 16 * j];
        hn[j] = op.hn[(size_t)s * op.n_pad + row0 + tx + 16 * j];
      }
      uint32_t keep = 0;  // bit i*8 + j
      if (!kMixed) {
        tile_dot<false>(op, s, q0, row0, sm, acc);
#pragma unroll
        for (int i = 0; i < kQI; ++i)
#pragma unroll
          for (int j = 0; j < kRJ; ++j)
            if (pair_keep(op, s, row0 + tx + 16 * j, qo.qi[i], qo.aq[i],
                          qo.r[i], qo.th[i], al[j], hn[j], acc[i][j]))
              keep |= 1u << (i * kRJ + j);
      } else {
        // _count_tile with mix=True: bf16 products give the definite
        // survivors; the pairs within the MIX_EPS band are re-verified with
        // the exact float32 predicate, only when the tile has any.
        tile_dot<true>(op, s, q0, row0, sm, acc);
        uint32_t band = 0;
#pragma unroll
        for (int i = 0; i < kQI; ++i) {
          const float qn = query_norm(qo.r[i], qo.th[i]);
#pragma unroll
          for (int j = 0; j < kRJ; ++j) {
            if (!geometry_keep(op, s, row0 + tx + 16 * j, qo.qi[i], qo.aq[i],
                               qo.r[i], qo.th[i], al[j], hn[j]))
              continue;
            const float dh16 = hn[j] - acc[i][j];
            const float margin = kMixEps * row_norm(hn[j]) * qn;
            const float th = qo.th[i];
            if (dh16 <= th - margin) keep |= 1u << (i * kRJ + j);
            if ((dh16 > th - margin) && (dh16 <= th + margin))
              band |= 1u << (i * kRJ + j);
          }
        }
        if (__syncthreads_or(band != 0)) {
          tile_dot<false>(op, s, q0, row0, sm, acc);
#pragma unroll
          for (int i = 0; i < kQI; ++i)
#pragma unroll
            for (int j = 0; j < kRJ; ++j)
              if (((band >> (i * kRJ + j)) & 1u) &&
                  (hn[j] - acc[i][j] <= qo.th[i]))
                keep |= 1u << (i * kRJ + j);
        }
      }
      // row sums over the 16 threads (one half warp) that share a query row
#pragma unroll
      for (int i = 0; i < kQI; ++i) {
        int c = __popc((keep >> (i * kRJ)) & 0xffu);
        c += __shfl_xor_sync(0xffffffffu, c, 8);
        c += __shfl_xor_sync(0xffffffffu, c, 4);
        c += __shfl_xor_sync(0xffffffffu, c, 2);
        c += __shfl_xor_sync(0xffffffffu, c, 1);
        if (tx == 0) cnt[ty * kQI + i] += c;
      }
    }
  }
  __syncthreads();
  if (t < kTQ && q0 + t < op.m_pad) {
    const int c = cnt[t];
    if (c) atomicAdd(counts + (size_t)s * op.m_pad + q0 + t, c);
    if (partials) partials[((size_t)s * op.m_pad + q0 + t) * nb + blk] = c;
  }
}

// Scatter every survivor as (pack-flat id s*n_pad + row, dhalf) into the
// flat CSR slot bases[s, k, blk] + (its rank among query k's survivors in
// this row block).  Writes nothing when *total + 1 > nnz_cap: the fused path
// launches this without reading the total on the host.  With total null
// (the single-segment entry point) there is no such guard; a slot outside
// [0, nnz_cap - 1) is never written either way.
__global__ void __launch_bounds__(kThreads)
snn_compact_stacked_kernel(Operands op, const int* __restrict__ bases,
                           const int* __restrict__ total, int nnz_cap,
                           int* __restrict__ idx, float* __restrict__ dh) {
  __shared__ TileSmem sm;
  __shared__ int base[kTQ];
  __shared__ uint32_t mask[kTQ][kTR / 32];
  if (total && (long long)*total + 1 > nnz_cap) return;
  const int q0 = blockIdx.x * kTQ, blk = blockIdx.y, s = blockIdx.z;
  const int b0 = blk * op.bn, nb = op.n_pad / op.bn;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4, lane = t & 31;
  if (t < kTQ)
    base[t] = q0 + t < op.m_pad
                  ? bases[((size_t)s * op.m_pad + q0 + t) * nb + blk] : 0;
  if (!window_hit(op, s, q0, b0)) return;
  QueryOps qo;
  load_queries(op, q0, qo);
  for (int sub = 0; sub < op.bn; sub += kTR) {
    const int row0 = b0 + sub;
    float acc[kQI][kRJ];
    float al[kRJ], hn[kRJ];
#pragma unroll
    for (int j = 0; j < kRJ; ++j) {
      al[j] = op.al[(size_t)s * op.n_pad + row0 + tx + 16 * j];
      hn[j] = op.hn[(size_t)s * op.n_pad + row0 + tx + 16 * j];
    }
    tile_dot<false>(op, s, q0, row0, sm, acc);
    uint32_t keep = 0;
#pragma unroll
    for (int i = 0; i < kQI; ++i)
#pragma unroll
      for (int j = 0; j < kRJ; ++j)
        if (pair_keep(op, s, row0 + tx + 16 * j, qo.qi[i], qo.aq[i], qo.r[i],
                      qo.th[i], al[j], hn[j], acc[i][j]))
          keep |= 1u << (i * kRJ + j);
    // Row c = tx + 16*j of the tile is bit (c & 31) of word c >> 5 = j >> 1.
    // Lanes 0-15 of a warp hold the even ty, lanes 16-31 the odd one.
#pragma unroll
    for (int i = 0; i < kQI; ++i)
#pragma unroll
      for (int w = 0; w < kTR / 32; ++w) {
        const uint32_t lo =
            __ballot_sync(0xffffffffu, (keep >> (i * kRJ + 2 * w)) & 1u);
        const uint32_t hi =
            __ballot_sync(0xffffffffu, (keep >> (i * kRJ + 2 * w + 1)) & 1u);
        if (tx == 0) {
          const int half = lane & 16;
          mask[ty * kQI + i][w] =
              ((lo >> half) & 0xffffu) | (((hi >> half) & 0xffffu) << 16);
        }
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kQI; ++i) {
      const int qrow = ty * kQI + i;
#pragma unroll
      for (int j = 0; j < kRJ; ++j) {
        if (!((keep >> (i * kRJ + j)) & 1u)) continue;
        const int c = tx + 16 * j, w = c >> 5, bit = c & 31;
        int rank = __popc(mask[qrow][w] & ((1u << bit) - 1u));
        for (int u = 0; u < w; ++u) rank += __popc(mask[qrow][u]);
        const long long slot = (long long)base[qrow] + rank;
        // a slot past the last data slot would mean pass 1 and pass 2
        // disagree; never write out of bounds or into the trash slot
        if (slot >= 0 && slot < nnz_cap - 1) {
          idx[slot] = s * op.n_pad + row0 + c;
          dh[slot] = hn[j] - acc[i][j];
        }
      }
    }
    __syncthreads();
    if (t < kTQ) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < kTR / 32; ++w) c += __popc(mask[t][w]);
      base[t] += c;
    }
    __syncthreads();
  }
}

Operands make_operands(const float* q, const float* aq, const float* r,
                       const float* th, const float* xs, const float* al,
                       const float* hn, const float* pq, const float* px,
                       int S, int m_pad, int n_pad, int d_pad, int ke, int bn) {
  return Operands{q, aq, r, th, xs, al, hn, pq, px,
                  S, m_pad, n_pad, d_pad, ke, bn};
}

}  // namespace
}  // namespace snn

// The C interface bound with ctypes (repro_torch/kernels/snn_query.py).  The
// caller checks shapes and allocates the outputs; `counts` must be zeroed.
// Each function launches on `stream` and returns cudaGetLastError().
extern "C" int snn_count_stacked(const float* q, const float* aq,
                                 const float* r, const float* th,
                                 const float* xs, const float* al,
                                 const float* hn, const float* pq,
                                 const float* px, int S, int m_pad, int n_pad,
                                 int d_pad, int ke, int bn, int mixed,
                                 int* counts, int* partials, void* stream) {
  using namespace snn;
  const Operands op = make_operands(q, aq, r, th, xs, al, hn, pq, px, S,
                                    m_pad, n_pad, d_pad, ke, bn);
  const dim3 grid((m_pad + kTQ - 1) / kTQ, n_pad / bn, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mixed)
    snn_count_stacked_kernel<true><<<grid, kThreads, 0, st>>>(op, counts,
                                                              partials);
  else
    snn_count_stacked_kernel<false><<<grid, kThreads, 0, st>>>(op, counts,
                                                               partials);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int snn_compact_stacked(const float* q, const float* aq,
                                   const float* r, const float* th,
                                   const float* xs, const float* al,
                                   const float* hn, const float* pq,
                                   const float* px, int S, int m_pad,
                                   int n_pad, int d_pad, int ke, int bn,
                                   const int* bases, const int* total,
                                   int nnz_cap, int* idx, float* dh,
                                   void* stream) {
  using namespace snn;
  const Operands op = make_operands(q, aq, r, th, xs, al, hn, pq, px, S,
                                    m_pad, n_pad, d_pad, ke, bn);
  const dim3 grid((m_pad + kTQ - 1) / kTQ, n_pad / bn, S);
  snn_compact_stacked_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      op, bases, total, nnz_cap, idx, dh);
  return static_cast<int>(cudaGetLastError());
}

// One segment: the kernels above with S = 1 (xs (n_pad, d_pad), al/hn
// (n_pad,), px (ke, n_pad), counts (m_pad,), partials (m_pad, n_pad / bn),
// bases (m_pad, n_pad / bn)); idx receives local rows.
extern "C" int snn_count(const float* q, const float* aq, const float* r,
                         const float* th, const float* xs, const float* al,
                         const float* hn, const float* pq, const float* px,
                         int m_pad, int n_pad, int d_pad, int ke, int bn,
                         int mixed, int* counts, int* partials, void* stream) {
  return snn_count_stacked(q, aq, r, th, xs, al, hn, pq, px, 1, m_pad, n_pad,
                           d_pad, ke, bn, mixed, counts, partials, stream);
}

extern "C" int snn_compact(const float* q, const float* aq, const float* r,
                           const float* th, const float* xs, const float* al,
                           const float* hn, const float* pq, const float* px,
                           int m_pad, int n_pad, int d_pad, int ke, int bn,
                           const int* bases, int nnz_cap, int* idx, float* dh,
                           void* stream) {
  return snn_compact_stacked(q, aq, r, th, xs, al, hn, pq, px, 1, m_pad,
                             n_pad, d_pad, ke, bn, bases, nullptr, nnz_cap,
                             idx, dh, stream);
}
