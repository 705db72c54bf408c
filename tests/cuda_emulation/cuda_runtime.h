// Host emulation of the CUDA runtime pieces the port's kernels use, so that
// tests/test_torch_kernel_emulation*.py can compile a kernel source with g++
// and run it on the CPU: one std::thread per CUDA thread, __syncthreads and
// warp-wide steps as std::barriers. A plain launch runs one block at a time;
// a cluster launch (emu::launch_cluster) runs the blocks of a cluster
// together, each with its own dynamic shared memory, a barrier over all of
// them for cluster_sync and a sibling's shared memory reached by rank
// (cluster_map in warp_prims.h). Slow (a block of 288 threads per head),
// exact in what it computes, and only as faithful as the primitives in
// warp_prims.h.
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
#define __cluster_dims__(...)
#define __shared__
#define __align__(n)
#define __restrict__
#define __grid_constant__

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
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
// what each lane of each warp puts on the table for a warp-wide step
struct Slot {
  float f;
  const void* p;
  uint32_t a[4];
  uint32_t b[2];
};
// the state of one block; a thread reaches its block's through the
// thread-local pointers below
struct Block {
  explicit Block(int threads) : bar(threads) {
    for (int w = 0; w < threads / 32; ++w) warp_bars.emplace_back(new std::barrier<>(32));
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  Slot slots[32][32];
  std::unique_ptr<float4[]> smem;  // dynamic shared memory (cluster launches)
};
inline thread_local dim3 tid;
inline thread_local dim3 bid;
inline dim3 bdim;
inline dim3 gdim;
inline thread_local Block* blk;
inline thread_local Slot (*slots)[32];
inline thread_local unsigned cluster_rank;
inline thread_local std::barrier<>* cluster_bar;
inline thread_local std::vector<Block*>* cluster_blocks;
inline void warp_sync() { blk->warp_bars[tid.x / 32]->arrive_and_wait(); }

// The threads of the blocks given, blocks[k] as block first + (k, 0, 0)
// and cluster rank k, run together until they all return.
template <class K, class... A>
void run_blocks(std::vector<Block*>& blocks, dim3 first, int threads, K kernel,
                std::barrier<>* cbar, A... args) {
  bdim = dim3(threads);
  std::vector<std::thread> ts;
  for (unsigned k = 0; k < blocks.size(); ++k)
    for (int i = 0; i < threads; ++i)
      ts.emplace_back([&, k, i] {
        tid = dim3(i);
        bid = dim3(first.x + k, first.y, first.z);
        blk = blocks[k];
        slots = blocks[k]->slots;
        cluster_rank = k;
        cluster_bar = cbar;
        cluster_blocks = &blocks;
        kernel(args...);
      });
  for (auto& t : ts) t.join();
}

// kernel<<<grid, threads>>>(args...), blocks one after another
template <class K, class... A>
void launch(dim3 grid, int threads, K kernel, A... args) {
  gdim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        Block block(threads);
        std::vector<Block*> blocks{&block};
        run_blocks(blocks, dim3(x, y, z), threads, kernel, nullptr, args...);
      }
}

// kernel<<<grid, threads, smem_bytes>>>(args...) with __cluster_dims__(size):
// one cluster after another along x, the blocks of each together
template <class K, class... A>
void launch_cluster(int size, dim3 grid, int threads, size_t smem_bytes, K kernel, A... args) {
  for (unsigned c = 0; c < grid.x / size; ++c) {
    std::vector<std::unique_ptr<Block>> owned;
    std::vector<Block*> blocks;
    for (int k = 0; k < size; ++k) {
      owned.emplace_back(new Block(threads));
      owned.back()->smem = std::make_unique<float4[]>(smem_bytes / 16 + 1);
      blocks.push_back(owned.back().get());
    }
    std::barrier<> cbar(size * threads);
    run_blocks(blocks, dim3(c * size), threads, kernel, &cbar, args...);
  }
}

// this block's dynamic shared memory in a cluster launch
template <class T>
T* block_smem() {
  return reinterpret_cast<T*>(blk->smem.get());
}
}  // namespace emu

#define threadIdx (emu::tid)
#define blockIdx (emu::bid)
#define blockDim (emu::bdim)
#define gridDim (emu::gdim)

inline void __syncthreads() { emu::blk->bar.arrive_and_wait(); }
inline void __syncwarp() { emu::warp_sync(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu::slots[w][l].f = v;
  emu::warp_sync();
  const float r = emu::slots[w][l ^ o].f;
  emu::warp_sync();
  return r;
}
inline int __shfl_xor_sync(unsigned, int v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu::slots[w][l].a[0] = static_cast<uint32_t>(v);
  emu::warp_sync();
  const int r = static_cast<int>(emu::slots[w][l ^ o].a[0]);
  emu::warp_sync();
  return r;
}

// fp32 arithmetic rounded to nearest, never contracted (g++ in ISO mode does
// not contract either)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
