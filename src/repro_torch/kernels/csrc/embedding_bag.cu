// Hopper kernels for the embedding bag of the recsys models.
//
// embedding_bag replaces src/repro/kernels/embedding_bag.py::embedding_bag
// (the Pallas TPU kernel; _bag_kernel): out[b] = sum_f w_f * table[max(id, 0)]
// over the F ids of bag b, with w_f = (id >= 0), so any id < 0 is padding.
// It takes float32 and bfloat16 tables and writes the table's dtype.
//
// Arithmetic: the TPU kernel walks the bag slots f on a sequential grid axis
// and adds into its output block, which has the table's dtype, so it rounds
// to that dtype after every add.  Here a thread keeps its columns of the sum
// in float registers, starts from +0.0, adds the slots in order f = 0 .. F-1,
// and rounds to the table's dtype after each add (a no-op for float32).  The
// float sum of two bfloat16 values rounded to bfloat16 is the correctly
// rounded bfloat16 sum, so the result is bit-identical to the TPU kernel's
// and to the plain version (repro_torch/kernels/ref.py::embedding_bag_ref).
// A bag of one is 0.f + w * x, not a copy: +0.0 + (-0.0) is +0.0, and a
// padded slot reads row 0 and gives 0 * row0, NaN where row 0 holds a NaN or
// an inf.  Ids at or above V read row V - 1 instead of memory outside the
// table, as the plain version does and as the Pallas kernel's clamped block
// index does off the TPU.  Row offsets are 64-bit: the MLPerf DLRM table has
// 2.4e10 elements.
//
// What bounds it on an H100: bytes.  A bag reads F rows of D elements and
// writes one, with no arithmetic to speak of, so the least time is (distinct
// rows read + rows written) * D * itemsize + ids, over 3.35 TB/s.
//
// What the design does about it, by the shape of the lookup (times from
// experiments/embedding_bag/run.py on the H100, PERF.md):
// - bags of one (F = 1) with rows a multiple of 16 bytes, the stacked
//   lookups of DLRM, Wide & Deep and MIND: a warp loads 32 bags' ids with
//   one coalesced load and hands them out by shuffle; the group's rows are
//   32 * L 16-byte chunks (L = row bytes / 16), lane l takes chunks l,
//   l + 32, ..., keeps kInFlight row loads (ld.global.nc) in flight before
//   it stores them, and writes with streaming stores (st.global.cs), so the
//   output, which nothing here reads again, pushes fewer table rows out of
//   L2.  In bag order the group's output is one contiguous run.  The grid
//   has a block for every 256 bags (a grid capped at the blocks the card
//   holds, walked by a grid-stride loop, was slower in both orders); 2
//   loads in flight were within 2-4% of 1 or 4 and faster than 8 or 16,
//   which cost resident warps (PERF.md).  Bags too few for a block an SM
//   (a serve_p99 lookup) take the per-chunk kernel below, which spreads
//   them over 8 to 16 times the threads;
// - bags of one over a table larger than the L2 with more ids than table
//   rows (MIND's history gather, Wide & Deep's deep lookup; the wrapper's
//   rule, snn_query.py::bag_order): the same gather over the bags grouped
//   by ranges of table rows that fill an eighth of the L2, so each row
//   comes from HBM about once and not once a hit.  A histogram of the bags
//   by range and a scatter of (bag, id) pairs into range order come first:
//   a one-digit counting sort whose blocks rank their bags with a shared
//   atomic each, stage them in shared memory in range order and reserve
//   their run of every range with one global atomic.  The order inside a
//   range does not matter, since each output row has one writer.  Ranges of
//   half the L2 were 23% slower for MIND than ranges of an eighth, probably
//   because each of the L2's two partitions keeps its own copy of what its
//   SMs read;
// - bags of many over rows narrower than 16 bytes (Wide & Deep's wide bag,
//   40 ids over a D = 1 table): a block of one warp stages its 32 bags' ids
//   in shared memory with coalesced 16-byte loads (an odd row stride, so the
//   warp reads its bags' slot f from 32 banks), then each thread walks its
//   bag's ids from shared memory with kStagedInFlight table reads in flight
//   and adds them in slot order;
// - everything else (bags of many over 16-byte rows, rows of other widths,
//   unaligned tables): one thread a (bag, 16-byte or one-element column
//   chunk), the slot loop unrolled so that several slots' loads are in
//   flight before their adds, which stay in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "snn_launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// 16-byte row loads a lane of the bag-of-one gather keeps in flight before
// its first store
constexpr int kInFlight = 2;
// the staged path: bags a block (one warp), table reads in flight a thread,
// and the shared memory its ids may take (the default 48 KB, so the launch
// needs no attribute set)
constexpr int kStagedBags = 32;
constexpr int kStagedInFlight = 8;
constexpr int kStagedSmemBytes = 48 * 1024;
// ranges of the blocked order: the wrapper keeps n_ranges at or below this
// (snn_query.py::MAX_BAG_RANGES), the histogram's shared-memory bins
constexpr int kMaxRanges = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ long long clamp_row(int id, long long V) {
  return id < 0 ? 0 : (id < V ? id : V - 1);
}

// VEC elements of a row: one 16-byte load when VEC * sizeof(T) == 16.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&x)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) x[v] = to_float(e[v]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) x[v] = to_float(p[v]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&x)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) e[v] = from_float<T>(x[v]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) p[v] = from_float<T>(x[v]);
  }
}

// One thread per (bag, VEC-wide column chunk); the L = D / VEC threads of a
// bag are consecutive.  `n_items` = B * L.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int* __restrict__ ids, const T* __restrict__ table,
                     T* __restrict__ out, long long n_items, int F, int D,
                     int L, long long V) {
  const long long item = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  if (item >= n_items) return;
  const long long b = item / L;
  const int col = static_cast<int>(item - b * L) * VEC;
  const int* __restrict__ bag = ids + b * F;
  const T* __restrict__ base = table + col;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;

  int f = 0;
  for (; f + kUnroll <= F; f += kUnroll) {
    float w[kUnroll];
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int id = __ldg(bag + f + u);
      w[u] = id >= 0 ? 1.f : 0.f;
      load_vec<T, VEC>(base + clamp_row(id, V) * D, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v] = to_float(from_float<T>(acc[v] + w[u] * x[u][v]));
    }
  }
  for (; f < F; ++f) {
    const int id = __ldg(bag + f);
    const float w = id >= 0 ? 1.f : 0.f;
    float x[VEC];
    load_vec<T, VEC>(base + clamp_row(id, V) * D, x);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      acc[v] = to_float(from_float<T>(acc[v] + w * x[v]));
  }
  store_vec<T, VEC>(out + b * D + col, acc);
}

// A bag of one on a 16-byte chunk: each element x becomes 0.f + w * x in
// the table's dtype (+0.0 for -0.0, NaN for a padded inf or NaN).
template <typename T>
__device__ __forceinline__ uint4 bag_of_one(uint4 raw, float w) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 res;
  const T* e = reinterpret_cast<const T*>(&raw);
  T* r = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int v = 0; v < VEC; ++v) r[v] = from_float<T>(0.f + w * to_float(e[v]));
  return res;
}

// Bags of one over rows of L 16-byte chunks, a group of 32 bags a warp.
// kListed: bag i of the walk is pairs[i] = (bag, id) (the blocked order);
// otherwise it is (i, ids[i]).  Chunk c = lane + 32 k of the group is
// column chunk c % L of the group's bag c / L, so k is warp-uniform and
// every shuffle has all 32 lanes.
template <typename T, bool kListed>
__global__ void __launch_bounds__(kThreads)
bag_of_one_kernel(const int* __restrict__ ids, const int2* __restrict__ pairs,
                  const T* __restrict__ table, T* __restrict__ out, int B,
                  int L, long long V) {
  const int lane = threadIdx.x & 31;
  const long long g = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) / 32;
  if (g * 32 >= B) return;
  const int q32 = 32 / L, r32 = 32 % L;
  const uint4* __restrict__ tab = reinterpret_cast<const uint4*>(table);
  uint4* __restrict__ dst = reinterpret_cast<uint4*>(out);
  const long long i = g * 32 + lane;
  const int n_here = static_cast<int>(B - g * 32 < 32 ? B - g * 32 : 32);
  int my_bag = 0, my_id = -1;
  if (i < B) {
    if constexpr (kListed) {
      const int2 p = __ldcs(pairs + i);
      my_bag = p.x;
      my_id = p.y;
    } else {
      my_bag = static_cast<int>(i);
      my_id = __ldcs(ids + i);
    }
  }
  int slot = lane / L, col = lane % L;  // of chunk lane + 32 k0
  for (int k0 = 0; k0 < L; k0 += kInFlight) {
    uint4 v[kInFlight];
    float w[kInFlight];
    long long at[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      at[u] = -1;
      if (k0 + u < L) {
        const int id = __shfl_sync(kFull, my_id, slot);
        const int bag = __shfl_sync(kFull, my_bag, slot);
        if (slot < n_here) {
          w[u] = id >= 0 ? 1.f : 0.f;
          v[u] = __ldg(tab + clamp_row(id, V) * L + col);
          at[u] = static_cast<long long>(bag) * L + col;
        }
        slot += q32;
        col += r32;
        if (col >= L) {
          col -= L;
          ++slot;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (at[u] >= 0) __stcs(dst + at[u], bag_of_one<T>(v[u], w[u]));
  }
}

// The range of table rows bag id `id` reads.  Rows fit 32 bits: ids are
// int32 and clamp below V.
__device__ __forceinline__ int range_of(int id, long long V, int rows) {
  return static_cast<int>(static_cast<unsigned>(clamp_row(id, V)) /
                          static_cast<unsigned>(rows));
}


// The list kernels take kIdsPerThread ids a thread at once, so that as many
// loads are in flight: lane l of warp w of a block whose span starts at i0
// holds ids i0 + 256 * w + 32 * u + l, u = 0 .. kIdsPerThread - 1 (each
// load coalesced across the warp).
constexpr int kIdsPerThread = 8;
constexpr int kSpan = kThreads * kIdsPerThread;

__device__ __forceinline__ long long id_index(long long i0, int u) {
  return i0 + (threadIdx.x & ~31) * kIdsPerThread + 32 * u +
         (threadIdx.x & 31);
}

// The blocked order's first pass: counts[r] += the bags whose row lies in
// range r (rows [r * rows, (r + 1) * rows)), from a shared histogram a
// block over spans of kSpan bags, grid-stride.
__global__ void __launch_bounds__(kThreads)
bag_range_histogram_kernel(const int* __restrict__ ids, int B, long long V,
                           int rows, int n_ranges, int* __restrict__ counts) {
  __shared__ int hist[kMaxRanges];
  for (int r = threadIdx.x; r < n_ranges; r += kThreads) hist[r] = 0;
  __syncthreads();
  for (long long i0 = static_cast<long long>(blockIdx.x) * kSpan; i0 < B;
       i0 += static_cast<long long>(gridDim.x) * kSpan) {
    int key[kIdsPerThread];
#pragma unroll
    for (int u = 0; u < kIdsPerThread; ++u) {
      const long long i = id_index(i0, u);
      key[u] = i < B ? range_of(__ldcs(ids + i), V, rows) : -1;
    }
#pragma unroll
    for (int u = 0; u < kIdsPerThread; ++u)
      if (key[u] >= 0) atomicAdd(hist + key[u], 1);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_ranges; r += kThreads)
    if (hist[r]) atomicAdd(counts + r, hist[r]);
}

// The blocked order's second pass: block k takes bags [k * kSpan, (k + 1) *
// kSpan), ranks each within its range among the block's bags, stages the
// (bag, id) pairs in shared memory in range order, reserves the block's
// run of each range with one atomic on fill[r] (after the exclusive prefix
// of counts, which every block computes for itself), and copies the staged
// pairs out, so that each run is written by consecutive threads.  A bag's
// rank is a shared-memory atomic of its own (the lanes of a warp that share
// a range serialize on its counter): grouping them first, by one ballot a
// bit of the range or by __match_any_sync, with one atomic a range, was
// slower on the H100 at MIND's 40 and Wide & Deep's 79 ranges (PERF.md).
__global__ void __launch_bounds__(kThreads)
bag_range_scatter_kernel(const int* __restrict__ ids, int B, long long V,
                         int rows, int n_ranges,
                         const int* __restrict__ counts,
                         int* __restrict__ fill, int2* __restrict__ pairs) {
  __shared__ int base[kMaxRanges];   // where the block's run of r starts
  __shared__ int local[kMaxRanges];  // the block's bags of r, then prefix
  __shared__ int2 staged[kSpan];
  const long long i0 = static_cast<long long>(blockIdx.x) * kSpan;
  const int n = B - i0 < kSpan ? static_cast<int>(B - i0) : kSpan;
  const int lane = threadIdx.x & 31;
  int id[kIdsPerThread], key[kIdsPerThread], pos[kIdsPerThread];
#pragma unroll
  for (int u = 0; u < kIdsPerThread; ++u) {
    const long long i = id_index(i0, u);
    id[u] = i < B ? __ldcs(ids + i) : 0;
    key[u] = i < B ? range_of(id[u], V, rows) : -1;
  }
  for (int r = threadIdx.x; r < n_ranges; r += kThreads) local[r] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kIdsPerThread; ++u)
    pos[u] = key[u] >= 0 ? atomicAdd(local + key[u], 1) : 0;
  __syncthreads();
  if (threadIdx.x < 32) {  // 32 ranges a step: exclusive prefixes, runs
    int carry = 0, lcarry = 0;
    for (int r0 = 0; r0 < n_ranges; r0 += 32) {
      const int r = r0 + lane;
      const int c = r < n_ranges ? counts[r] : 0;
      const int l = r < n_ranges ? local[r] : 0;
      int incl = c, lincl = l;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        const int lt = __shfl_up_sync(kFull, lincl, off);
        if (lane >= off) {
          incl += t;
          lincl += lt;
        }
      }
      if (r < n_ranges) {
        base[r] = carry + incl - c + (l ? atomicAdd(fill + r, l) : 0);
        local[r] = lcarry + lincl - l;
      }
      carry += __shfl_sync(kFull, incl, 31);
      lcarry += __shfl_sync(kFull, lincl, 31);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kIdsPerThread; ++u)
    if (key[u] >= 0)
      staged[local[key[u]] + pos[u]] =
          make_int2(static_cast<int>(id_index(i0, u)), id[u]);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int2 p = staged[j];
    const int r = range_of(p.y, V, rows);
    pairs[base[r] + j - local[r]] = p;
  }
}

// Bags of many over rows narrower than 16 bytes (D < 16 / sizeof(T)): one
// thread a bag, blockDim.x bags a block.  The block's ids are contiguous in
// memory; they are staged in shared memory with bag t's slot f at
// t * stride + f (stride odd), loaded in 16-byte chunks when `vec_ids` says
// the block's first id is 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
staged_bag_kernel(const int* __restrict__ ids, const T* __restrict__ table,
                  T* __restrict__ out, int B, int F, int D, long long V,
                  int stride, int vec_ids) {
  constexpr int kMaxD = 16 / sizeof(T) - 1;
  extern __shared__ int staged[];
  const int nt = blockDim.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * nt;
  const int nb = B - b0 < nt ? static_cast<int>(B - b0) : nt;
  const int n = nb * F;
  const int* __restrict__ src = ids + b0 * F;
  auto put = [&](int e, int v) { staged[(e / F) * stride + e % F] = v; };
  int e0 = 0;
  if (vec_ids) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (int j = threadIdx.x; j < n / 4; j += nt) {
      const int4 v = __ldcs(src4 + j);
      put(4 * j, v.x);
      put(4 * j + 1, v.y);
      put(4 * j + 2, v.z);
      put(4 * j + 3, v.w);
    }
    e0 = n / 4 * 4;
  }
  for (int e = e0 + threadIdx.x; e < n; e += nt) put(e, __ldcs(src + e));
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= nb) return;
  const int* my = staged + threadIdx.x * stride;
  float acc[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc[d] = 0.f;
  for (int f0 = 0; f0 < F; f0 += kStagedInFlight) {
    float w[kStagedInFlight];
    float x[kStagedInFlight][kMaxD];
#pragma unroll
    for (int u = 0; u < kStagedInFlight; ++u) {
      if (f0 + u < F) {
        const int id = my[f0 + u];
        w[u] = id >= 0 ? 1.f : 0.f;
        const T* row = table + clamp_row(id, V) * D;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d)
          if (d < D) x[u][d] = to_float(__ldg(row + d));
      }
    }
#pragma unroll
    for (int u = 0; u < kStagedInFlight; ++u) {
      if (f0 + u < F) {
#pragma unroll
        for (int d = 0; d < kMaxD; ++d)
          if (d < D) acc[d] = to_float(from_float<T>(acc[d] + w[u] * x[u][d]));
      }
    }
  }
  T* dst = out + (b0 + threadIdx.x) * D;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d)
    if (d < D) dst[d] = from_float<T>(acc[d]);
}

// The launches below take no more than the default 48 KB of shared memory,
// so they need no attribute set: a serve batch's lookup of a few thousand
// bags pays for the host's time of each call.
template <typename T>
int launch_bag_of_one(const int* ids, const int2* pairs, const void* table,
                      void* out, int B, int D, long long V, cudaStream_t s) {
  const int L = D * static_cast<int>(sizeof(T)) / 16;
  const auto t = static_cast<const T*>(table);
  const auto o = static_cast<T*>(out);
  const auto grid = static_cast<unsigned>(snn::ceil_div(B, kThreads));
  if (pairs)
    bag_of_one_kernel<T, true><<<grid, kThreads, 0, s>>>(ids, pairs, t, o, B,
                                                         L, V);
  else
    bag_of_one_kernel<T, false><<<grid, kThreads, 0, s>>>(ids, pairs, t, o,
                                                          B, L, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_staged(const int* ids, const void* table, void* out, int B, int F,
                  int D, long long V, cudaStream_t s) {
  const int stride = F | 1;
  const long long b0_bytes = static_cast<long long>(kStagedBags) * F * 4;
  const int vec_ids = reinterpret_cast<unsigned long long>(ids) % 16 == 0 &&
                      b0_bytes % 16 == 0;
  const auto smem = static_cast<size_t>(kStagedBags) * stride * sizeof(int);
  staged_bag_kernel<T><<<static_cast<unsigned>(snn::ceil_div(B, kStagedBags)),
                         kStagedBags, smem, s>>>(
      ids, static_cast<const T*>(table), static_cast<T*>(out), B, F, D, V,
      stride, vec_ids);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch(const int* ids, const void* table, void* out, int B, int F, int D,
           long long V, cudaStream_t stream) {
  const int L = D / VEC;
  const long long n_items = static_cast<long long>(B) * L;
  const long long grid = (n_items + kThreads - 1) / kThreads;
  embedding_bag_kernel<T, VEC><<<static_cast<unsigned>(grid), kThreads, 0,
                                 stream>>>(
      ids, static_cast<const T*>(table), static_cast<T*>(out), n_items, F, D,
      L, V);
  return static_cast<int>(cudaGetLastError());
}

enum Path { kPerElement = 0, kPerChunk = 1, kBagOfOne = 2, kStaged = 3 };

// The path of (B, F) bags over a (V, D) table of T at `table`: 16-byte
// loads where a row is a multiple of 16 bytes and the table 16-byte aligned
// (the output, from PyTorch's allocator, always is); bags of one on those
// rows take the bag-of-one gather, listed (`listed`, the blocked order) or
// where its grid has a block for every SM; fewer bags of one (a serve_p99
// lookup: 52-100 blocks of 256 bags on the H100's 132 SMs) spread over 8 to
// 16 times the threads on the per-chunk kernel; bags of many over rows
// narrower than 16 bytes the staged path, where kStagedBags bags' ids fit
// kStagedSmemBytes.
template <typename T>
Path path_of(long long B, int F, int D, const void* table, bool listed) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC == 0 && reinterpret_cast<unsigned long long>(table) % 16 == 0)
    return F == 1 && (listed || B >= static_cast<long long>(kThreads) *
                                         snn::current_device().sms)
               ? kBagOfOne
               : kPerChunk;
  if (F >= 2 && D < VEC &&
      static_cast<long long>(kStagedBags) * (F | 1) * 4 <= kStagedSmemBytes)
    return kStaged;
  return kPerElement;
}

template <typename T>
int dispatch(const int* ids, const int2* pairs, const void* table, void* out,
             int B, int F, int D, long long V, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const Path path = path_of<T>(B, F, D, table, pairs != nullptr);
  if (pairs && path != kBagOfOne) return cudaErrorInvalidValue;
  switch (path) {
    case kBagOfOne:
      return launch_bag_of_one<T>(ids, pairs, table, out, B, D, V, s);
    case kPerChunk:
      return launch<T, VEC>(ids, table, out, B, F, D, V, s);
    case kStaged:
      return launch_staged<T>(ids, table, out, B, F, D, V, s);
    default:
      return launch<T, 1>(ids, table, out, B, F, D, V, s);
  }
}

}  // namespace

// The C interface bound with ctypes (repro_torch/kernels/snn_query.py): ids
// (B, F) int32, table (V, D) and out (B, D) of `dtype` (0 float32,
// 1 bfloat16), all contiguous, out 16-byte aligned; B, D >= 1 and V >= 1.
// Takes the path of embedding_bag_path; on the bag-of-one gather, in bag
// order, or, when `pairs` is not null, in the order of the (B,) (bag, id)
// pairs that embedding_bag_list wrote.  Launches on `stream` and returns the
// launch's CUDA error.
extern "C" int embedding_bag(const int* ids, const int* pairs,
                             const void* table, void* out, int B, int F,
                             int D, long long V, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = reinterpret_cast<const int2*>(pairs);
  if (dtype == 0) return dispatch<float>(ids, p, table, out, B, F, D, V, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(ids, p, table, out, B, F, D, V, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The path embedding_bag takes for B bags of F ids over rows of D elements
// of `dtype` at `table`, in bag order (`listed` = 0) or listed: 0 one
// thread an element, 1 one thread a 16-byte chunk, 2 the bag-of-one gather,
// 3 the staged path; -1 for an unknown dtype.
extern "C" int embedding_bag_path(long long B, int F, int D, int dtype,
                                  const void* table, int listed) {
  if (dtype == 0) return path_of<float>(B, F, D, table, listed);
  if (dtype == 1) return path_of<__nv_bfloat16>(B, F, D, table, listed);
  return -1;
}

// The blocked order's list: (B,) bags of one, ids (B,) int32 over V table
// rows, grouped by range r = clamp(id, 0, V - 1) / rows (n_ranges <= 1024
// ranges).  Zeroes `scratch` (2 * n_ranges int32: the counts, then the
// fill cursors), counts the bags by range, then writes pairs (B, 2) int32 =
// (bag, id) with the bags of range r in [prefix(r), prefix(r + 1)), in no
// set order within a range.  Returns the first CUDA error.
extern "C" int embedding_bag_list(const int* ids, int B, long long V,
                                  int rows, int n_ranges, int* scratch,
                                  int* pairs, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || n_ranges < 1 || n_ranges > kMaxRanges)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, 2 * static_cast<size_t>(n_ranges) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const snn::Device dev = snn::current_device();
  const long long spans = snn::ceil_div(B, kSpan);
  // the histogram walks the spans grid-stride with 8 blocks an SM, as many
  // as its 256 threads, 30 registers and 4 KB of shared memory let reside
  const long long fit = 8LL * dev.sms;
  e = snn::launch<bag_range_histogram_kernel>(
      snn::Geometry{0, kThreads, spans < fit ? spans : fit, 0}, dev.id, s,
      ids, B, V, rows, n_ranges, scratch);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = snn::launch<bag_range_scatter_kernel>(
      snn::Geometry{0, kThreads, spans, 0}, dev.id, s, ids, B, V, rows,
      n_ranges, scratch, scratch + n_ranges, reinterpret_cast<int2*>(pairs));
  return static_cast<int>(e);
}

// The device's L2 size in bytes (cudaDevAttrL2CacheSize) into *bytes.
extern "C" int embedding_bag_l2_bytes(int device, long long* bytes) {
  int v = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&v, cudaDevAttrL2CacheSize, device);
  *bytes = v;
  return static_cast<int>(e);
}
