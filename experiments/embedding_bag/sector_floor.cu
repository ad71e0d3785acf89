// The wide bag's L2-sector floor: the least work of a lookup of B bags of F
// ids over a (V, 1) float32 table without the sums.  Each thread reads its
// ids coalesced (grid-stride over the flat B * F ids) and, for each, the one
// 4-byte table entry it names, which moves a whole 32-byte sector from L2
// (the table is 16 MB and stays there); kInFlight reads are in flight a
// thread, and the values are folded into one word a thread so that no load
// is dead.  Built and timed by run.py beside the shipped staged kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 8;

__global__ void __launch_bounds__(kThreads)
sector_floor_kernel(const int* __restrict__ ids,
                    const float* __restrict__ table, long long n, long long V,
                    unsigned* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  unsigned acc = 0;
  for (long long i0 = t; i0 < n; i0 += stride * kInFlight) {
    float x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = i0 + u * stride;
      x[u] = 0.f;
      if (i < n) {
        const int id = __ldcs(ids + i);
        const long long row = id < 0 ? 0 : (id < V ? id : V - 1);
        x[u] = __ldg(table + row);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) acc ^= __float_as_uint(x[u]);
  }
  out[t] = acc;
}

}  // namespace

// `blocks` blocks of 256 threads over the n = B * F ids; out holds one word
// a thread.  Returns the launch's CUDA error.
extern "C" int sector_floor(const int* ids, const float* table, long long n,
                            long long V, unsigned* out, int blocks,
                            void* stream) {
  sector_floor_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(ids, table, n, V,
                                                             out);
  return static_cast<int>(cudaGetLastError());
}
