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
// is then the local row.  Every launch shape computes each pair's dot product
// as the same fmaf chain (snn_predicate.cuh), so the looped executor (one
// launch per segment) and the packed one (one launch per stack) are
// bit-identical, and so are count and compact.
//
// What bounds them on an H100.  The count pass evaluates the predicate of
// every (query, row) pair whose 128 x 128 tile the alpha window does not
// skip: 2*d FP32 operations a pair on FFMA (no IEEE-float32 tensor-core
// mode), against reading the database about once, so the FFMA rate bounds
// it.  The tile product alone reaches about 63% of the 67 TFLOP/s peak and
// the whole count about 57% (PERF.md); no profiler breaks the rest down.
// The compact pass needs the product only for the window rows of the
// (segment, query, row block) cells that hold a survivor, which the count's
// per-row-block partials name: on the eps-graph 2% of the count's pairs, on
// wide point queries about a fifth.  A block that lists one or a few
// queries is bound by the latency of its loads and barriers, not by FFMA:
// the compact runs 7-70x over that work's FFMA time on the H100 (PERF.md).
//
// What the design does about it.
// - The count: one block a (kTeams*8 queries x 128 rows) tile of one
//   segment, the register-blocked product of snn_predicate.cuh, and the
//   per-query counts of the tile summed into counts and into the per-row-
//   block partials (S, m_pad, n_pad / bn) with integer atomics (order-free,
//   exact).  Blocks whose rows no query window of the tile meets return
//   before any load.  The query tile is 128 (16 teams, 256 threads) unless
//   that leaves fewer blocks than the card has SMs (the looped executor's
//   small segments): then 32 (4 teams, 64 threads).
// - The compact: one block a (query tile, bn-row block) cell.  It reads its
//   queries' partials first and returns when they are all zero.  Otherwise
//   it lists the queries with survivors in shared memory and runs the product
//   over that list only, in groups of 8 (a team's slots), against the
//   block's 128-row sub-tiles that some listed window meets, up to four at
//   a time: team ty takes group ty % groups of sub-tile ty / groups, so a
//   list of one group keeps four teams busy, not one, and only the warps
//   that hold such a team issue FFMAs.  A survivor's slot is its row block's
//   base (the wrapper's prefix of the partials) plus its rank in its CSR
//   row: the kept rows before it in its lane, plus those of the lanes before
//   it (a shuffle scan over the 16 lanes that hold the query's rows), plus
//   the query's survivors in earlier sub-tiles (one count a slot and
//   sub-tile through shared memory, one exchange a round of sub-tiles); no
//   bitmask.  The query tile is 128, or 32 or 8 when fewer blocks would
//   leave SMs idle.
//
// The grid is one-dimensional: the query tile varies fastest, so the blocks
// that read a row tile run together and find it in L2, and the database is
// read from device memory about once.
#include <cstdint>

#include "snn_launch.cuh"
#include "snn_predicate.cuh"

namespace snn {
namespace {

// The count's tile: 128 rows, 16 features a stage.  The compact's: room for
// kCompactSubs 128-row sub-tiles of its row block, 8 features a stage, so
// that a thread's staging registers stay few (8 and 16 features a stage ran
// the count's product within 2% of each other on the H100,
// experiments/tile_product).
constexpr int kCountKC = 16;
constexpr int kCompactSubs = 4;
constexpr int kCompactKC = 8;
template <int kTeams>
using CountTile = Tile<kTeams, 1, kCountKC>;
template <int kTeams>
using CompactTile = Tile<kTeams, kCompactSubs, kCompactKC>;

// Per-(segment, query) survivor counts, summed over row tiles with integer
// atomics.  `partials`, when not null, accumulates the (S, m_pad, n_pad / bn)
// per-row-block counts that size the compact pass; counts and partials must
// be zeroed.  Grid: ceil(m_pad / (kTeams*8)) x (n_pad / 128) x S blocks.
template <int kTeams, bool kMixed>
__global__ void __launch_bounds__(kTeams * 16, kTeams == 16 && !kMixed ? 2 : 1)
snn_count_stacked_kernel(Operands op, int nqt, int* __restrict__ counts,
                         int* __restrict__ partials) {
  using T = CountTile<kTeams>;
  extern __shared__ __align__(16) float smem[];
  __shared__ SlotOps<T::kSlots> so;
  __shared__ __align__(16) float ral[kRows], rhn[kRows];  // the tile's rows
  float* spq = smem + 2 * T::kStage;
  const int nrt = op.n_pad / kRows;
  int b = blockIdx.x;
  const int qt = b % nqt;
  b /= nqt;
  const int row0 = (b % nrt) * kRows, s = b / nrt;
  const int q0 = qt * T::kSlots;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  bool hit = false;
  if (t < T::kSlots) {
    fill_slot(op, t, q0 + t < op.m_pad ? q0 + t : -1, so, spq);
    hit = slot_meets(op, s, row0, row0 + kRows - 1, t, so);
  }
  for (int r = t; r < kRows; r += T::kThreads) {
    ral[r] = op.al[(size_t)s * op.n_pad + row0 + r];
    rhn[r] = op.hn[(size_t)s * op.n_pad + row0 + r];
  }
  if (!__syncthreads_or(hit)) return;

  auto qrow = [&](int p) {
    return op.q + (size_t)min(q0 + p, op.m_pad - 1) * op.d_pad;
  };
  const float* xrows = op.xs + ((size_t)s * op.n_pad + row0) * op.d_pad;
  auto xrow = [&](int r) { return xrows + (size_t)r * op.d_pad; };
  float acc[kMI][kMJ];
  uint64_t keep = 0;
  if (!kMixed) {
    tile_product<kTeams, 1, kCountKC, false>(op, qrow, T::kSlots, xrow,
                                             kRows, ty, 0, true, smem, acc);
    keep = keep_f32(op, s, row0, ral, rhn, so, spq, ty, acc);
  } else {
    // _count_tile with mix=True: bf16 products give the definite survivors;
    // the pairs within the MIX_EPS band are re-verified with the exact
    // float32 predicate, only when the tile has any.
    tile_product<kTeams, 1, kCountKC, true>(op, qrow, T::kSlots, xrow,
                                            kRows, ty, 0, true, smem, acc);
    uint64_t band = 0;
    float al[kMJ], hn[kMJ];
#pragma unroll
    for (int j = 0; j < kMJ; ++j) {
      al[j] = ral[row_of(tx, j)];
      hn[j] = rhn[row_of(tx, j)];
    }
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int slot = ty * kMI + i;
      const float aq = so.aq[slot], r = so.r[slot], th = so.th[slot];
      const float qn = so.qn[slot];
      uint32_t kb = 0, bb = 0;
#pragma unroll
      for (int j = 0; j < kMJ; ++j) {
        const float dh16 = hn[j] - acc[i][j];
        const float margin = kMixEps * row_norm(hn[j]) * qn;
        const bool sure = dh16 <= th - margin;
        const bool near = (dh16 > th - margin) && (dh16 <= th + margin);
        // the window and the box only for the pairs the margin keeps or
        // sends to the float32 re-check
        if ((sure || near) && in_window(al[j], aq, r) &&
            (op.ke == 0 || in_box_all(op, s, row0 + row_of(tx, j), hn[j],
                                      slot, so, spq))) {
          if (sure) kb |= 1u << j;
          else bb |= 1u << j;
        }
      }
      keep |= (uint64_t)kb << (i * kMJ);
      band |= (uint64_t)bb << (i * kMJ);
    }
    if (__syncthreads_or(band != 0)) {
      tile_product<kTeams, 1, kCountKC, false>(op, qrow, T::kSlots, xrow,
                                               kRows, ty, 0, true, smem, acc);
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const float th = so.th[ty * kMI + i];
#pragma unroll
        for (int j = 0; j < kMJ; ++j)
          if (((band >> (i * kMJ + j)) & 1u) &&
              in_ball(rhn[row_of(tx, j)], acc[i][j], th))
            keep |= (uint64_t)1 << (i * kMJ + j);
      }
    }
  }

  // row sums over the 16 lanes (half a warp) that share a query slot
  const int nb = op.n_pad / op.bn, blk = row0 / op.bn;
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    int c = __popc(static_cast<uint32_t>(keep >> (i * kMJ)) & 0xffu);
    c += __shfl_xor_sync(0xffffffffu, c, 8);
    c += __shfl_xor_sync(0xffffffffu, c, 4);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    const int q = q0 + ty * kMI + i;
    if (tx == 0 && c && q < op.m_pad) {
      const size_t sq = (size_t)s * op.m_pad + q;
      atomicAdd(counts + sq, c);
      if (partials) atomicAdd(partials + sq * nb + blk, c);
    }
  }
}

// Scatter every survivor as (pack-flat id s*n_pad + row, dhalf) into the
// flat CSR slot bases[s, k, blk] + (its rank among query k's survivors in
// this row block).  `partials` are the count pass's: a query whose partial
// is zero has no survivor in the block.  Writes nothing when
// *total + 1 > nnz_cap: the fused path launches this without reading the
// total on the host.  With total null (the single-segment entry point) there
// is no such guard; a slot outside [0, nnz_cap - 1) is never written either
// way.  Grid: ceil(m_pad / kTQ) x (n_pad / bn) x S blocks.
template <int kTeams, int kTQ>
__global__ void __launch_bounds__(kTeams * 16, kTeams == 16 ? 2 : 1)
snn_compact_stacked_kernel(Operands op, int nqt, const int* __restrict__ bases,
                           const int* __restrict__ partials,
                           const int* __restrict__ total, int nnz_cap,
                           int* __restrict__ idx, float* __restrict__ dh) {
  using T = CompactTile<kTeams>;
  static_assert(kTQ <= T::kSlots && kTQ <= 128, "a list slot per query");
  extern __shared__ __align__(16) float smem[];
  __shared__ SlotOps<T::kSlots> so;
  __shared__ int list[kTQ], lbase[kTQ];
  __shared__ int wcount[(kTQ + 31) / 32];
  __shared__ int subs[kCompactSubs];             // a round's sub-tiles
  __shared__ int cnt[kCompactSubs][T::kSlots];   // their survivors a slot
  if (total && (long long)*total + 1 > nnz_cap) return;
  float* spq = smem + 2 * T::kStage;
  const int nb = op.n_pad / op.bn;
  int b = blockIdx.x;
  const int qt = b % nqt;
  b /= nqt;
  const int blk = b % nb, s = b / nb;
  const int q0 = qt * kTQ, b0 = blk * op.bn;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int lane = t & 31, warp = t >> 5;
  constexpr uint32_t kAll = 0xffffffffu;

  // the tile's queries with a survivor in this row block, in query order
  bool has = false;
  size_t at = 0;
  if (t < kTQ && q0 + t < op.m_pad) {
    at = ((size_t)s * op.m_pad + q0 + t) * nb + blk;
    has = partials[at] > 0;
  }
  const uint32_t m = __ballot_sync(kAll, has);
  if (t < kTQ && lane == 0) wcount[warp] = __popc(m);
  __syncthreads();
  int ns = 0, pos = 0;
#pragma unroll
  for (int w = 0; w < (kTQ + 31) / 32; ++w) {
    pos += w < warp ? wcount[w] : 0;
    ns += wcount[w];
  }
  if (ns == 0) return;  // no survivor: no load, no product
  if (has) {
    pos += __popc(m & ((1u << lane) - 1u));
    list[pos] = q0 + t;
    lbase[pos] = bases[at];
  }
  __syncthreads();
  if (t < T::kSlots) fill_slot(op, t, t < ns ? list[t] : -1, so, spq);
  __syncthreads();

  // The product runs over the listed queries only, in groups of 8 (one
  // team's slots), against up to `width` live 128-row sub-tiles at once:
  // team ty takes group ty % groups of the round's sub-tile ty / groups, so
  // a short list keeps as many teams busy as a long one.
  const int groups = (ns + kMI - 1) / kMI;
  const int width = min(kCompactSubs, kTeams / groups);
  const int g = ty % groups, j = ty / groups;
  auto qrow = [&](int p) {
    return op.q + (size_t)list[min(p, ns - 1)] * op.d_pad;
  };
  auto xrow = [&](int r) {
    return op.xs + ((size_t)s * op.n_pad + b0 + kRows * subs[r / kRows] +
                    r % kRows) * op.d_pad;
  };
  const int n_sub = op.bn / kRows;
  for (int u = 0; u < n_sub;) {
    // the next sub-tiles that some listed window meets
    int nu = 0;
    for (; u < n_sub && nu < width; ++u) {
      const int row0 = b0 + u * kRows;
      const bool hit =
          t < ns && slot_meets(op, s, row0, row0 + kRows - 1, t, so);
      if (__syncthreads_or(hit)) {
        if (t == 0) subs[nu] = u;
        ++nu;
      }
    }
    if (nu == 0) break;
    __syncthreads();
    const bool on = j < nu;  // this team has a (group, sub-tile) this round
    const bool active = 2 * warp < groups * nu;  // teams 2w and 2w + 1
    const int sj = on ? j : 0;
    float acc[kMI][kMJ];
    tile_product<kTeams, kCompactSubs, kCompactKC, false>(
        op, qrow, groups * kMI, xrow, nu * kRows, on ? g : 0, sj, active,
        smem, acc);
    const int row0 = b0 + kRows * subs[sj];
    const float* rhn = op.hn + (size_t)s * op.n_pad + row0;
    const uint64_t keep =
        active && on ? keep_f32(op, s, row0, op.al + (size_t)s * op.n_pad +
                                row0, rhn, so, spq, g, acc)
                     : 0;
    // each slot's survivors in this sub-tile, for the teams on its later
    // sub-tiles
    if (active) {
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        int c = __popc(static_cast<uint32_t>(keep >> (i * kMJ)) & 0xffu);
        c += __shfl_xor_sync(kAll, c, 8);
        c += __shfl_xor_sync(kAll, c, 4);
        c += __shfl_xor_sync(kAll, c, 2);
        c += __shfl_xor_sync(kAll, c, 1);
        if (on && tx == 0) cnt[j][g * kMI + i] = c;
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const uint32_t mine = static_cast<uint32_t>(keep >> (i * kMJ)) & 0xffu;
        if (!__any_sync(kAll, mine != 0)) continue;
        // the slot's rows in order: rows 0-63 are bits 0-3 of lanes 0-15 of
        // its team, rows 64-127 bits 4-7; exclusive prefix counts over the
        // lanes by an inclusive scan in 16-lane segments
        const uint32_t lo = mine & 0xfu, hi = mine >> 4;
        const int n_lo = __popc(lo), n_hi = __popc(hi);
        int s_lo = n_lo, s_hi = n_hi;
#pragma unroll
        for (int d = 1; d < 16; d <<= 1) {
          const int u_lo = __shfl_up_sync(kAll, s_lo, d, 16);
          const int u_hi = __shfl_up_sync(kAll, s_hi, d, 16);
          if (tx >= d) {
            s_lo += u_lo;
            s_hi += u_hi;
          }
        }
        const int all_lo = __shfl_sync(kAll, s_lo, 15, 16);
        if (!mine) continue;
        // the slot's base: its row block's, plus its survivors in the
        // sub-tiles before this one
        const int p = g * kMI + i;
        int base = lbase[p];
        for (int jj = 0; jj < j; ++jj) base += cnt[jj][p];
#pragma unroll
        for (int jr = 0; jr < kMJ; ++jr) {
          if (!((mine >> jr) & 1u)) continue;
          const int rank =
              jr < 4 ? s_lo - n_lo + __popc(lo & ((1u << jr) - 1u))
                     : all_lo + s_hi - n_hi +
                           __popc(hi & ((1u << (jr - 4)) - 1u));
          const long long slot = (long long)base + rank;
          // a slot past the last data slot would mean pass 1 and pass 2
          // disagree; never write out of bounds or into the trash slot
          if (slot >= 0 && slot < nnz_cap - 1) {
            idx[slot] = s * op.n_pad + row0 + row_of(tx, jr);
            dh[slot] = rhn[row_of(tx, jr)] - acc[i][jr];
          }
        }
      }
    }
    __syncthreads();
    if (t < ns) {
      int add = 0;
      for (int jj = 0; jj < nu; ++jj) add += cnt[jj][t];
      lbase[t] += add;
    }
  }
}

Operands make_operands(const float* q, const float* aq, const float* r,
                       const float* th, const float* xs, const float* al,
                       const float* hn, const float* pq, const float* px,
                       int S, int m_pad, int n_pad, int d_pad, int ke, int bn) {
  return Operands{q, aq, r, th, xs, al, hn, pq, px,
                  S, m_pad, n_pad, d_pad, ke, bn};
}

// The launch geometry of each pass: the largest query tile whose grid still
// has a block for every SM, else the smallest.
Geometry count_geometry(int sms, int S, int m_pad, int n_pad, int ke) {
  using Big = CountTile<16>;
  using Small = CountTile<4>;
  const long long rows = (long long)(n_pad / kRows) * S;
  if (ceil_div(m_pad, Big::kSlots) * rows >= sms)
    return {Big::kSlots, Big::kThreads, ceil_div(m_pad, Big::kSlots) * rows,
            Big::smem_bytes(ke)};
  return {Small::kSlots, Small::kThreads,
          ceil_div(m_pad, Small::kSlots) * rows, Small::smem_bytes(ke)};
}

Geometry compact_geometry(int sms, int S, int m_pad, int n_pad, int bn,
                          int ke) {
  using Big = CompactTile<16>;
  using Small = CompactTile<4>;
  const long long cells = (long long)(n_pad / bn) * S;
  if (ceil_div(m_pad, 128) * cells >= sms)
    return {128, Big::kThreads, ceil_div(m_pad, 128) * cells,
            Big::smem_bytes(ke)};
  const int tq = ceil_div(m_pad, 32) * cells >= sms ? 32 : 8;
  return {tq, Small::kThreads, ceil_div(m_pad, tq) * cells,
          Small::smem_bytes(ke)};
}

}  // namespace
}  // namespace snn

// The C interface bound with ctypes (repro_torch/kernels/snn_query.py).  The
// caller checks shapes and allocates the outputs; `counts` and `partials`
// must be zeroed.  Each function launches on `stream` and returns the CUDA
// error of the launch (0 on success).
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
  const Device dv = current_device();
  const Geometry g = count_geometry(dv.sms, S, m_pad, n_pad, ke);
  const int nqt = (int)ceil_div(m_pad, g.query_tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (g.query_tile == CountTile<16>::kSlots)
    e = mixed ? launch<snn_count_stacked_kernel<16, true>>(
                    g, dv.id, st, op, nqt, counts, partials)
              : launch<snn_count_stacked_kernel<16, false>>(
                    g, dv.id, st, op, nqt, counts, partials);
  else
    e = mixed ? launch<snn_count_stacked_kernel<4, true>>(
                    g, dv.id, st, op, nqt, counts, partials)
              : launch<snn_count_stacked_kernel<4, false>>(
                    g, dv.id, st, op, nqt, counts, partials);
  return static_cast<int>(e);
}

// `bases` (S, m_pad, n_pad / bn) is the flat slot of each (segment, query,
// row block)'s first survivor, `partials` the count pass's per-row-block
// counts of the same shape.
extern "C" int snn_compact_stacked(const float* q, const float* aq,
                                   const float* r, const float* th,
                                   const float* xs, const float* al,
                                   const float* hn, const float* pq,
                                   const float* px, int S, int m_pad,
                                   int n_pad, int d_pad, int ke, int bn,
                                   const int* bases, const int* partials,
                                   const int* total, int nnz_cap, int* idx,
                                   float* dh, void* stream) {
  using namespace snn;
  const Operands op = make_operands(q, aq, r, th, xs, al, hn, pq, px, S,
                                    m_pad, n_pad, d_pad, ke, bn);
  const Device dv = current_device();
  const Geometry g = compact_geometry(dv.sms, S, m_pad, n_pad, bn, ke);
  const int nqt = (int)ceil_div(m_pad, g.query_tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (g.query_tile == 128)
    e = launch<snn_compact_stacked_kernel<16, 128>>(
        g, dv.id, st, op, nqt, bases, partials, total, nnz_cap, idx, dh);
  else if (g.query_tile == 32)
    e = launch<snn_compact_stacked_kernel<4, 32>>(
        g, dv.id, st, op, nqt, bases, partials, total, nnz_cap, idx, dh);
  else
    e = launch<snn_compact_stacked_kernel<4, 8>>(
        g, dv.id, st, op, nqt, bases, partials, total, nnz_cap, idx, dh);
  return static_cast<int>(e);
}

// One segment: the kernels above with S = 1 (xs (n_pad, d_pad), al/hn
// (n_pad,), px (ke, n_pad), counts (m_pad,), partials and bases (m_pad,
// n_pad / bn)); idx receives local rows.
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
                           const int* bases, const int* partials, int nnz_cap,
                           int* idx, float* dh, void* stream) {
  return snn_compact_stacked(q, aq, r, th, xs, al, hn, pq, px, 1, m_pad,
                             n_pad, d_pad, ke, bn, bases, partials, nullptr,
                             nnz_cap, idx, dh, stream);
}

// The launch geometry the two passes choose for a stack on the current
// device: pass 0 is the count, 1 the compact.  Writes (query tile, threads a
// block, blocks, dynamic shared-memory bytes) to out[0..3].
extern "C" int snn_launch_geometry(int pass, int S, int m_pad, int n_pad,
                                   int bn, int ke, long long* out) {
  using namespace snn;
  const int sms = current_device().sms;
  const Geometry g = pass == 0 ? count_geometry(sms, S, m_pad, n_pad, ke)
                               : compact_geometry(sms, S, m_pad, n_pad, bn, ke);
  out[0] = g.query_tile;
  out[1] = g.threads;
  out[2] = g.blocks;
  out[3] = (long long)g.smem;
  return 0;
}
