// Hopper kernel for the embedding bag of the recsys models.
//
// embedding_bag replaces src/repro/kernels/embedding_bag.py::embedding_bag
// (the Pallas TPU kernel; _bag_kernel): out[b] = sum_f w_f * table[max(id, 0)]
// over the F ids of bag b, with w_f = (id >= 0), so any id < 0 is padding.
// It takes float32 and bfloat16 tables and writes the table's dtype.
//
// Arithmetic: the TPU kernel walks the bag slots f on a sequential grid axis
// and adds into its output block, which has the table's dtype, so it rounds
// to that dtype after every add.  Here a thread keeps its columns of the sum
// in float registers, adds the slots in order f = 0 .. F-1, and rounds to the
// table's dtype after each add (a no-op for float32).  The float sum of two
// bfloat16 values rounded to bfloat16 is the correctly rounded bfloat16 sum,
// so the result is bit-identical to the TPU kernel's and to the plain version
// (repro_torch/kernels/ref.py::embedding_bag_ref).  The loop over f inside
// the thread replaces the TPU's sequential f axis; nothing carries between
// blocks.
//
// What bounds it on an H100: bytes.  A bag reads F rows of D elements and
// writes one, with no arithmetic to speak of, so the least time is (distinct
// rows read + rows written) * D * itemsize + ids, over 3.35 TB/s.
//
// What the design does about it: a bag gets L = D * itemsize / 16 consecutive
// threads (a warp for a 128-wide float32 row, half a warp for a 128-wide
// bfloat16 row, a whole block or more for rows wider than 4 KiB), each of
// which moves 16 bytes of the row per load, so a row is one coalesced read
// and the output row one coalesced write.  Rows whose width is not a multiple
// of 16 bytes (the wide model's D = 1 table) take a scalar path with one
// thread per output element.  The slot loop is unrolled so that the loads of
// several slots are in flight before their adds, which stay in order.  Row
// offsets are 64-bit: the MLPerf DLRM table has 2.4e10 elements.  Ids at or
// above V read row V - 1 instead of memory outside the table, as the plain
// version does and as the Pallas kernel's clamped block index does off the
// TPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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
      const long long row = id < 0 ? 0 : (id < V ? id : V - 1);
      w[u] = id >= 0 ? 1.f : 0.f;
      load_vec<T, VEC>(base + row * D, x[u]);
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
    const long long row = id < 0 ? 0 : (id < V ? id : V - 1);
    const float w = id >= 0 ? 1.f : 0.f;
    float x[VEC];
    load_vec<T, VEC>(base + row * D, x);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      acc[v] = to_float(from_float<T>(acc[v] + w * x[v]));
  }
  store_vec<T, VEC>(out + b * D + col, acc);
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

}  // namespace

// The C interface bound with ctypes (repro_torch/kernels/snn_query.py): ids
// (B, F) int32, table (V, D) and out (B, D) of `dtype` (0 float32,
// 1 bfloat16), all contiguous.  `vec16` = 1 takes the 16-byte path; the
// caller sets it only where D * itemsize is a multiple of 16 and both
// pointers are 16-byte aligned.  B, D >= 1 and V >= 1.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int embedding_bag(const int* ids, const void* table, void* out,
                             int B, int F, int D, long long V, int dtype,
                             int vec16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec16 ? launch<float, 4>(ids, table, out, B, F, D, V, s)
                 : launch<float, 1>(ids, table, out, B, F, D, V, s);
  }
  if (dtype == 1) {
    return vec16 ? launch<__nv_bfloat16, 8>(ids, table, out, B, F, D, V, s)
                 : launch<__nv_bfloat16, 1>(ids, table, out, B, F, D, V, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
