// Warp-level bf16 tensor-core building blocks for Hopper (sm_90a), shared by
// attention_fwd_tc.cu and attention_bwd_tc.cu.
//
// Products use mma.sync.m16n8k16 (bf16 inputs, fp32 sums). Fragments, with
// lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major)  a[0] = (row g,     cols 2t, 2t+1)
//                           a[1] = (row g + 8, cols 2t, 2t+1)
//                           a[2] = (row g,     cols 2t+8, 2t+9)
//                           a[3] = (row g + 8, cols 2t+8, 2t+9)
//   B (16 x 8, k x n)       b[0] = (k 2t, 2t+1, col g),  b[1] = (k 2t+8, 2t+9, col g)
//   C (16 x 8, fp32)        c[0], c[1] = (row g, cols 2t, 2t+1)
//                           c[2], c[3] = (row g + 8, cols 2t, 2t+1)
// Two C tiles side by side (16 x 16) are, rounded to bf16 and packed in
// pairs, the A fragment of the next product: that is how P and dS go from
// one product into the next without leaving registers.
//
// Staged tiles live in shared memory row major, tile_stride<dh>() bf16 a row:
// the row's dh values plus 8 of padding, so the 8 rows that one ldmatrix
// phase reads (16 bytes each) start 16 bytes apart modulo 128 and hit 32
// distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

template <int DH>
__host__ __device__ constexpr int tile_stride() { return DH + 8; }

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy, device memory -> shared memory.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Addresses for ldmatrix over a 16 x 16 block at (row r0, col c0) of a
// staged tile with `stride` bf16 per row.
//   a_ptr:  the A fragment of the block (also the B fragments, with .trans,
//           of two n8 tiles when the block is k x n: {r0, r1} and {r2, r3})
//   bt_ptr: B fragments of two n8 tiles when the block is n x k (rows are
//           the n index): {r0, r1} for rows r0..r0+7, {r2, r3} for the next 8
__device__ __forceinline__ const bf16* a_ptr(const bf16* s, int stride, int r0, int c0, int lane) {
  return s + (r0 + (lane & 15)) * stride + c0 + 8 * (lane >> 4);
}

__device__ __forceinline__ const bf16* bt_ptr(const bf16* s, int stride, int r0, int c0, int lane) {
  return s + (r0 + (lane & 7) + 8 * (lane >> 4)) * stride + c0 + 8 * ((lane >> 3) & 1);
}

__device__ __forceinline__ uint32_t pack(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 values times `sc` (a bf16 value held in fp32), rounded to bf16:
// the activation-type product q * scale of the plain version.
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float sc) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  return pack(f.x * sc, f.y * sc);
}

// The A fragment of two C tiles (16 x 16), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// Reductions over the 4 lanes (t = 0..3) that hold one row of a C tile.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Warps per block for nrb 16-row blocks: as few rounds as `max_warps`
// allows, then as few warps as those rounds need.
__host__ __device__ constexpr int warps_for(int nrb, int max_warps) {
  return (nrb + (nrb + max_warps - 1) / max_warps - 1) / ((nrb + max_warps - 1) / max_warps);
}

}  // namespace mma_bf16
