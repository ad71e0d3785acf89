// The launch path of the SNN kernels (snn_query.cu, snn_filter.cu): the
// current device, a launch's geometry, and one launch helper that raises a
// kernel's dynamic shared-memory limit once a device, not on every call.
#pragma once

#include <atomic>
#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace snn {
namespace {

// The current device and its SM count; the count is asked of the runtime
// once a device.
constexpr int kMaxDevices = 64;
struct Device {
  int id, sms;
};
Device current_device() {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return {0, 1};
  if (dev < kMaxDevices &&
      (n = known[dev].load(std::memory_order_relaxed)) > 0)
    return {dev, n};
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1)
    return {dev, 1};
  if (dev < kMaxDevices) known[dev].store(n, std::memory_order_relaxed);
  return {dev, n};
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// A launch's query tile, threads a block, blocks and dynamic shared memory.
struct Geometry {
  int query_tile, threads;
  long long blocks;
  size_t smem;
};

// Launch kKernel with geometry g on device dev.  Static and dynamic shared
// memory together may pass the default 48 KB, so the kernel's dynamic limit
// is raised on a device the first time a launch needs more than it was
// given: the looped executor launches thousands of times a graph, and the
// attribute call would add host time to each.
template <auto kKernel, class... Args>
cudaError_t launch(const Geometry& g, int dev, cudaStream_t st, Args... args) {
  static std::atomic<int> raised[kMaxDevices];  // this kernel's limit a device
  if (g.blocks > INT_MAX || dev >= kMaxDevices)
    return cudaErrorInvalidConfiguration;
  if ((int)g.smem > raised[dev].load(std::memory_order_relaxed)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (e != cudaSuccess) return e;
    raised[dev].store((int)g.smem, std::memory_order_relaxed);
  }
  kKernel<<<(unsigned)g.blocks, g.threads, g.smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace
}  // namespace snn
