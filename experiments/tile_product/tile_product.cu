// Variants of the count kernel's 128 x 128 float32 tile product (8 x 8
// outputs a thread, 256 threads, each output one fmaf chain over the
// features), timed alone on Gaussian data: how the operands reach shared
// memory and how many features a stage holds.  The register-staged variants
// are the shipped product itself, the cp.async rings the designs it was
// chosen over.  Built and run by run.py.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../src/repro_torch/kernels/csrc/snn_predicate.cuh"

namespace {

__device__ __forceinline__ void cp4(float* s, const float* g) {
  unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g));
}
__device__ __forceinline__ void cp16(float* s, const float* g) {
  unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// 4-byte cp.async into feature-major stages, a ring of STAGES
template <int STAGES, int KC>
__device__ __forceinline__ void prod_kmajor_cp4(const float* qr, const float* xr, int d, float* smem, float (&acc)[8][8]) {
  constexpr int LD = 132, STQ = KC * LD, ST = 2 * STQ;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4, f = t & 7;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = d / KC;
  auto load = [&](int st, int kc) {
    float* sq = smem + st * ST;
    float* sx = sq + STQ;
#pragma unroll
    for (int kg = 0; kg < KC; kg += 8) {
      const int k = kg + f, kk = kc * KC + k;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = (t >> 3) + 32 * i;
        if (row < 128) {
          const int col = (row & 4) * 16 + 4 * (row >> 3) + (row & 3);
          cp4(sq + k * LD + col, qr + (size_t)row * d + kk);
        } else {
          cp4(sx + k * LD + row - 128, xr + (size_t)(row - 128) * d + kk);
        }
      }
    }
  };
  for (int st = 0; st < STAGES - 1; ++st) { if (st < nk) load(st, st); commit(); }
  for (int kc = 0; kc < nk; ++kc) {
    wait<STAGES - 2>();
    const int st = kc % STAGES;
    __syncthreads();
    if (kc + STAGES - 1 < nk) load((kc + STAGES - 1) % STAGES, kc + STAGES - 1);
    commit();
    const float* sq = smem + st * ST + 4 * ty;
    const float* sx = smem + st * ST + STQ + 4 * tx;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float4 a0 = *(const float4*)(sq + k * LD), a1 = *(const float4*)(sq + k * LD + 64);
      const float4 b0 = *(const float4*)(sx + k * LD), b1 = *(const float4*)(sx + k * LD + 64);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  wait<0>();
  __syncthreads();
}

// Register-staged: the shipped kernels' own product (snn::tile_product of
// snn_predicate.cuh: each thread's 16-byte loads of the next chunk go to
// registers while the FFMAs run on this one, then are stored transposed
// into the other of two feature-major stages), KC features a stage
template <int KC>
__device__ __forceinline__ void prod_shipped(const float* qr, const float* xr, int d, float* smem, float (&acc)[8][8]) {
  snn::Operands op{};
  op.d_pad = d;
  auto qrow = [&](int p) { return qr + (size_t)p * d; };
  auto xrow = [&](int r) { return xr + (size_t)r * d; };
  snn::tile_product<16, 1, KC, false>(op, qrow, 128, xrow, 128, threadIdx.x >> 4, 0, true, smem, acc);
}

// 16-byte cp.async into feature-contiguous rows (36 floats apart, KC = 32),
// a ring of STAGES, read as float4 along the features; rows tx + 16 j, slots
// 8 ty + i, the row operands loaded in two halves
template <int STAGES>
__device__ __forceinline__ void prod_rowmajor_cp16(const float* qr, const float* xr, int d, float* smem, float (&acc)[8][8]) {
  constexpr int KC = 32, LD = 36, STQ = 128 * LD + 4, ST = STQ + 128 * LD;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = d / KC;
  auto load = [&](int st, int kc) {
    float* sq = smem + st * ST;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = t + 256 * u, row = e >> 3, c = e & 7;
      if (row < 128) cp16(sq + row * LD + 4 * (((row >> 3) & 1) + c), qr + (size_t)row * d + kc * KC + 4 * c);
      else cp16(sq + STQ + (row - 128) * LD + 4 * c, xr + (size_t)(row - 128) * d + kc * KC + 4 * c);
    }
  };
  for (int st = 0; st < STAGES - 1; ++st) { if (st < nk) load(st, st); commit(); }
  for (int kc = 0; kc < nk; ++kc) {
    wait<STAGES - 2>();
    const int st = kc % STAGES;
    __syncthreads();
    if (kc + STAGES - 1 < nk) load((kc + STAGES - 1) % STAGES, kc + STAGES - 1);
    commit();
    const float* sq = smem + st * ST + ty * 8 * LD + 4 * (ty & 1);
    const float* sx = smem + st * ST + STQ + tx * LD;
#pragma unroll
    for (int c = 0; c < KC / 4; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = *(const float4*)(sx + 16 * (4 * h + j) * LD + 4 * c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = *(const float4*)(sq + i * LD + 4 * c);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float& o = acc[i][4 * h + j];
            o = fmaf(a.x, b[j].x, o);
            o = fmaf(a.y, b[j].y, o);
            o = fmaf(a.z, b[j].z, o);
            o = fmaf(a.w, b[j].w, o);
          }
        }
      }
    }
  }
  wait<0>();
  __syncthreads();
}

template <int V>
__global__ void __launch_bounds__(256, (V == 7 || V == 8) ? 1 : 2)
prod_kernel(const float* q, const float* x, int m, int d, float* out) {
  extern __shared__ __align__(16) float smem[];
  const int nqt = m / 128;
  const int qt = blockIdx.x % nqt, rt = blockIdx.x / nqt;
  const float* qr = q + (size_t)qt * 128 * d;
  const float* xr = x + (size_t)rt * 128 * d;
  float acc[8][8];
  if (V == 0) prod_kmajor_cp4<2, 32>(qr, xr, d, smem, acc);
  if (V == 1) prod_kmajor_cp4<3, 32>(qr, xr, d, smem, acc);
  if (V == 2) prod_kmajor_cp4<3, 16>(qr, xr, d, smem, acc);
  if (V == 3) prod_rowmajor_cp16<2>(qr, xr, d, smem, acc);
  if (V == 4) prod_rowmajor_cp16<3>(qr, xr, d, smem, acc);
  if (V == 5) prod_shipped<8>(qr, xr, d, smem, acc);
  if (V == 6 || V == 7) prod_shipped<16>(qr, xr, d, smem, acc);
  if (V == 8) prod_shipped<32>(qr, xr, d, smem, acc);
  // keep the products alive: count the (never) huge ones
  float s = 0.f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j] > 1e30f ? 1.f : 0.f;
  if (s != 0.f) atomicAdd(out, s);
}

size_t smem_of(int v) {
  switch (v) {
    case 0: return 2 * 2 * 32 * 132 * 4;
    case 1: return 3 * 2 * 32 * 132 * 4;
    case 2: return 3 * 2 * 16 * 132 * 4;
    case 3: return 2 * (128 * 36 * 2 + 4) * 4;
    case 4: return 3 * (128 * 36 * 2 + 4) * 4;
    case 5: return snn::Tile<16, 1, 8>::smem_bytes(0);
    case 6: case 7: return snn::Tile<16, 1, 16>::smem_bytes(0);
    default: return snn::Tile<16, 1, 32>::smem_bytes(0);
  }
}

template <int V>
int go(const float* q, const float* x, int m, int d, float* out, int blocks,
       void* stream) {
  const size_t sm = smem_of(V);
  if (sm > 48 * 1024)
    cudaFuncSetAttribute(prod_kernel<V>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  prod_kernel<V><<<blocks, 256, sm, (cudaStream_t)stream>>>(q, x, m, d, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Variant v over `blocks` 128 x 128 tiles: query tiles of q (m, d) fastest,
// then row tiles of x (d floats a row); returns the launch's CUDA error.
extern "C" int tile_product(int v, const float* q, const float* x, int m,
                            int d, float* out, int blocks, void* stream) {
  switch (v) {
    case 0: return go<0>(q, x, m, d, out, blocks, stream);
    case 1: return go<1>(q, x, m, d, out, blocks, stream);
    case 2: return go<2>(q, x, m, d, out, blocks, stream);
    case 3: return go<3>(q, x, m, d, out, blocks, stream);
    case 4: return go<4>(q, x, m, d, out, blocks, stream);
    case 5: return go<5>(q, x, m, d, out, blocks, stream);
    case 6: return go<6>(q, x, m, d, out, blocks, stream);
    case 7: return go<7>(q, x, m, d, out, blocks, stream);
    default: return go<8>(q, x, m, d, out, blocks, stream);
  }
}
