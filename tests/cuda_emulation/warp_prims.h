// Host emulation of the inline-PTX primitives of kernels/csrc/mma_bf16.cuh,
// kernels/csrc/mma_tf32.cuh and kernels/csrc/cluster.cuh. A copy of each header with its primitives
// cut out includes this file, whose definitions at global scope the kernels
// then reach. Each warp-wide step puts every lane's operands on the table,
// waits for the warp, and computes this lane's share as the PTX ISA defines
// it.
#pragma once

#include "cuda_bf16.h"
#include "cuda_runtime.h"

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  std::memcpy(dst, src, 16);
}

__device__ __forceinline__ void cp_async_wait_all() {}

__device__ __forceinline__ void cp_async_commit() {}

__device__ __forceinline__ void cp_async_wait_prior() {}

// ---- clusters (cluster.cuh), under emu::launch_cluster ----

__device__ __forceinline__ unsigned cluster_rank() { return emu::cluster_rank; }

__device__ __forceinline__ void cluster_sync() { emu::cluster_bar->arrive_and_wait(); }

// the same offset in the dynamic shared memory of the block of that rank
__device__ __forceinline__ float* cluster_map(float* p, unsigned rank) {
  const char* mine = reinterpret_cast<const char*>(emu::blk->smem.get());
  char* theirs = reinterpret_cast<char*>((*emu::cluster_blocks)[rank]->smem.get());
  return reinterpret_cast<float*>(theirs + (reinterpret_cast<const char*>(p) - mine));
}

// ---- bf16 (mma_bf16.cuh): two waits a step, the table reused ----

inline float emu_lo(uint32_t w) { return __bfloat162float({uint16_t(w & 0xffff)}); }
inline float emu_hi(uint32_t w) { return __bfloat162float({uint16_t(w >> 16)}); }

// ldmatrix .x4: lane i gives row i % 8 of matrix i / 8; lane 4g + t gets
// (row g, cols 2t, 2t+1) of each matrix, or with .trans (rows 2t, 2t+1, col g).
inline void emu_ldmatrix(uint32_t r[4], const __nv_bfloat16* p, bool trans) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  emu::slots[w][lane].p = p;
  emu::warp_sync();
  for (int m = 0; m < 4; ++m) {
    const __nv_bfloat16* a;
    const __nv_bfloat16* b;
    if (!trans) {
      a = static_cast<const __nv_bfloat16*>(emu::slots[w][8 * m + g].p) + 2 * t;
      b = a + 1;
    } else {
      a = static_cast<const __nv_bfloat16*>(emu::slots[w][8 * m + 2 * t].p) + g;
      b = static_cast<const __nv_bfloat16*>(emu::slots[w][8 * m + 2 * t + 1].p) + g;
    }
    r[m] = uint32_t(a->x) | (uint32_t(b->x) << 16);
  }
  emu::warp_sync();
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  emu_ldmatrix(r, p, false);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  emu_ldmatrix(r, p, true);
}

// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, c += a b
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  emu::Slot& mine = emu::slots[w][lane];
  for (int i = 0; i < 4; ++i) mine.a[i] = a[i];
  mine.b[0] = b0;
  mine.b[1] = b1;
  emu::warp_sync();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int gg = l / 4, tt = l % 4;
    const emu::Slot& o = emu::slots[w][l];
    for (int i = 0; i < 4; ++i) {
      const int row = gg + 8 * (i & 1), col = 2 * tt + 8 * (i >> 1);
      A[row][col] = emu_lo(o.a[i]);
      A[row][col + 1] = emu_hi(o.a[i]);
    }
    for (int i = 0; i < 2; ++i) {
      B[2 * tt + 8 * i][gg] = emu_lo(o.b[i]);
      B[2 * tt + 8 * i + 1][gg] = emu_hi(o.b[i]);
    }
  }
  emu::warp_sync();
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = 0.f;
    for (int k = 0; k < 16; ++k) acc += A[row][k] * B[k][col];
    c[e] += acc;
  }
}

// ---- tf32 (mma_tf32.cuh): one wait a step, two tables used in turn ----

namespace emu {
// A lane writes step n + 1's operands into the other table while slower
// lanes may still read step n's; it can come back to this table (step n + 2)
// only after every lane has reached step n + 1, done with step n's.
struct Tf32Slot {
  uint32_t a[4], b[2];
};
inline Tf32Slot tf32_slots[2][32][32];
inline thread_local int tf32_step;
inline float tf32(uint32_t u) {
  u &= 0xffffe000u;  // the tensor cores read the top 19 bits
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
}  // namespace emu

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, c += a b. Fragments,
// lane 4g + t: a[0..3] = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// b[0..1] = (k t, n g), (k t + 4, n g); c[0..3] = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_m16n8k8(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  emu::Tf32Slot(&table)[32] = emu::tf32_slots[emu::tf32_step++ & 1][w];
  for (int i = 0; i < 4; ++i) table[lane].a[i] = a[i];
  for (int i = 0; i < 2; ++i) table[lane].b[i] = b[i];
  emu::warp_sync();
  float A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    const int gg = l / 4, tt = l % 4;
    for (int i = 0; i < 4; ++i) A[gg + 8 * (i & 1)][tt + 4 * (i >> 1)] = emu::tf32(table[l].a[i]);
    for (int i = 0; i < 2; ++i) B[tt + 4 * i][gg] = emu::tf32(table[l].b[i]);
  }
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = 0.f;
    for (int k = 0; k < 8; ++k) acc += A[row][k] * B[k][col];
    c[e] += acc;
  }
}
