// Host emulation of the CUDA runtime pieces the port's kernels use, so that
// tests/test_torch_kernel_emulation.py can compile a kernel source with g++
// and run it on the CPU: one std::thread per CUDA thread, one block at a
// time, __syncthreads and warp-wide steps as std::barriers. Slow (a block
// of 288 threads per head), exact in what it computes, and only as
// faithful as the primitives in warp_prims.h.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
#define __restrict__

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

using std::max;
using std::min;
inline float __expf(float x) { return std::exp(x); }
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

namespace emu {
inline thread_local dim3 tid;
inline dim3 bid, bdim;
inline std::barrier<>* block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
// what each lane of each warp puts on the table for a warp-wide step
struct Slot {
  float f;
  const void* p;
  uint32_t a[4];
  uint32_t b[2];
};
inline Slot slots[32][32];
inline void warp_sync() { warp_bars[tid.x / 32]->arrive_and_wait(); }

// kernel<<<grid, threads>>>(args...), blocks one after another
template <class K, class... A>
void launch(dim3 grid, int threads, K kernel, A... args) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        bid = dim3(x, y, z);
        bdim = dim3(threads);
        std::barrier<> bb(threads);
        block_bar = &bb;
        warp_bars.clear();
        for (int w = 0; w < threads / 32; ++w) warp_bars.emplace_back(new std::barrier<>(32));
        std::vector<std::thread> ts;
        for (int i = 0; i < threads; ++i)
          ts.emplace_back([&, i] {
            tid = dim3(i);
            kernel(args...);
          });
        for (auto& t : ts) t.join();
      }
}
}  // namespace emu

#define threadIdx (emu::tid)
#define blockIdx (emu::bid)
#define blockDim (emu::bdim)

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp() { emu::warp_sync(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu::slots[w][l].f = v;
  emu::warp_sync();
  const float r = emu::slots[w][l ^ o].f;
  emu::warp_sync();
  return r;
}
