// Warp-level fp32 products on Hopper's tensor cores (sm_90a) with three TF32
// passes, shared by attention_fwd.cu and attention_bwd.cu.
//
// A TF32 value keeps fp32's exponent and the top 10 bits of its mantissa.
// Each fp32 operand x is split once into hi = tf32(x) and lo = tf32(x - hi),
// rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero), so
// hi + lo carries about 22 significant bits, and a product is taken as
// hi*lo' + lo*hi' + hi*hi' (the lo*lo' term, below 2^-22 of the product, is
// dropped). Three mma.sync.m16n8k8 products at the tensor cores' 495 TFLOP/s
// TF32 rate give about 165 effective TFLOP/s against the CUDA cores' 67 for
// fp32 FMA. The rounding is two integer instructions (tf32_rna), the bits
// cvt.rna.tf32.f32 gives a finite value without its NaN handling, since the
// split runs for every operand element.
// The tensor cores sum with truncation, so each 8-deep step sums its three
// products from zero and is then added to the running fp32 sum on the CUDA
// cores, rounded to nearest (mma_steps): a long sum, p v over hundreds of
// keys, sees no truncation at its own magnitude. An mma.sync's result comes
// many cycles after it issues, so mma_steps issues the three passes pass by
// pass over several blocks, which keeps several products in flight.
//
// Fragments of mma.m16n8k8 (tf32 inputs, fp32 sums), lane = 4 g + t:
//   A (16 x 8, row major)  a[0] = (row g, col t)      a[1] = (row g + 8, col t)
//                          a[2] = (row g, col t + 4)  a[3] = (row g + 8, col t + 4)
//   B (8 x 8, k x n)       b[0] = (k t, col g)        b[1] = (k t + 4, col g)
//   C (16 x 8, fp32)       c[0], c[1] = (row g, cols 2t, 2t + 1)
//                          c[2], c[3] = (row g + 8, cols 2t, 2t + 1)
// A C tile is the A fragment of the next product over its 8 columns if the
// contraction index is permuted: logical k = t is column 2t and k = t + 4 is
// column 2t + 1 (c_to_a), with the B operand's rows permuted the same way
// (load_b_kn). That is how P and dS go from one product to the next in
// registers, with no shuffle.
//
// Tiles in shared memory, row major:
//   raw    stride<dh>() = dh + 4 floats a row (16-byte aligned rows for
//          cp.async); fragment loads from it hit 32 distinct banks:
//          (row g, col t) bank 4 g + t.
//   split  split_stride<dh>() = 2 dh + 8 words a row, hi and lo of each
//          value side by side, so one 8-byte load gives both; written once
//          a block from a raw tile (split_rows), then read by every warp
//          (load_b_nk conflict-free, load_b_kn two-way).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tf32 {

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

template <int DH>
__host__ __device__ constexpr int stride() { return DH + 4; }

template <int DH>
__host__ __device__ constexpr int split_stride() { return 2 * DH + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy, device memory -> shared memory.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Waits for every copy issued so far.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c += a b, mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
__device__ __forceinline__ void mma_m16n8k8(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to nearest, ties
// away from zero (half an ulp added to the magnitude); the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi and lo of each of n values.
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// The A fragment of rows r0..r0+15, columns k0..k0+7 of a raw tile, times
// mul, split.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4], const float* x_s,
                                       int r0, int k0, float mul, int lane) {
  const float* p = x_s + (r0 + (lane >> 2)) * stride<DH>() + k0 + (lane & 3);
  const float a[4] = {p[0] * mul, p[8 * stride<DH>()] * mul, p[4] * mul,
                      p[8 * stride<DH>() + 4] * mul};
  split(a, ah, al);
}

// The A fragment (16 x 8, contraction index permuted) of a C tile.
__device__ __forceinline__ void c_to_a(float a[4], const float c[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// The B fragments, hi and lo, of N 8 x 8 blocks of a split tile whose n
// index runs over the tile's rows n0 + 8 i .. n0 + 8 i + 7 (block i) and k
// over its columns k0..k0+7 (k^T of q k^T).
template <int N, int DH>
__device__ __forceinline__ void load_b_nk(uint32_t (&bh)[N][2], uint32_t (&bl)[N][2],
                                          const uint32_t* x_s, int n0, int k0, int lane) {
  const uint32_t* p = x_s + (n0 + (lane >> 2)) * split_stride<DH>() + 2 * (k0 + (lane & 3));
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint2 b0 = *reinterpret_cast<const uint2*>(p + 8 * i * split_stride<DH>());
    const uint2 b1 = *reinterpret_cast<const uint2*>(p + 8 * i * split_stride<DH>() + 8);
    bh[i][0] = b0.x, bl[i][0] = b0.y, bh[i][1] = b1.x, bl[i][1] = b1.y;
  }
}

// The same for N blocks whose k index runs over the tile's rows k0..k0+7, in
// c_to_a's order, and n over its columns n0 + 8 i .. n0 + 8 i + 7 (v of p v).
template <int N, int DH>
__device__ __forceinline__ void load_b_kn(uint32_t (&bh)[N][2], uint32_t (&bl)[N][2],
                                          const uint32_t* x_s, int k0, int n0, int lane) {
  const uint32_t* p = x_s + (k0 + 2 * (lane & 3)) * split_stride<DH>() + 2 * (n0 + (lane >> 2));
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint2 b0 = *reinterpret_cast<const uint2*>(p + 16 * i);
    const uint2 b1 = *reinterpret_cast<const uint2*>(p + 16 * i + split_stride<DH>());
    bh[i][0] = b0.x, bl[i][0] = b0.y, bh[i][1] = b1.x, bl[i][1] = b1.y;
  }
}

// c[n] += A B_n over one 8-deep step for N blocks: each block's three
// products (a_lo b_hi, a_hi b_lo, a_hi b_hi) summed from zero on the tensor
// cores, issued pass by pass over the N blocks, then added to c[n] rounded
// to nearest.
template <int N>
__device__ __forceinline__ void mma_steps(float (*c)[4], const uint32_t ah[4],
                                          const uint32_t al[4], const uint32_t (&bh)[N][2],
                                          const uint32_t (&bl)[N][2]) {
  float d[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[n][i] = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) mma_m16n8k8(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_m16n8k8(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_m16n8k8(d[n], ah, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] += d[n][i];
}

// ROWS rows of a raw tile split into a split tile, each thread its share of
// 4-value chunks (the raw rows past L are zeros, and so are their splits).
template <int ROWS, int DH>
__device__ __forceinline__ void split_rows(uint32_t* dst, const float* src, int tid,
                                           int nthreads) {
  constexpr int CPR = DH / 4;
  for (int idx = tid; idx < ROWS * CPR; idx += nthreads) {
    const int j = idx / CPR;
    const int c = (idx - j * CPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + j * stride<DH>() + c);
    const float v[4] = {x.x, x.y, x.z, x.w};
    uint32_t hi[4], lo[4];
    split(v, hi, lo);
    uint32_t* d = dst + j * split_stride<DH>() + 2 * c;
    *reinterpret_cast<uint4*>(d) = make_uint4(hi[0], lo[0], hi[1], lo[1]);
    *reinterpret_cast<uint4*>(d + 4) = make_uint4(hi[2], lo[2], hi[3], lo[3]);
  }
}

// Rows r0 .. r0 + ROWS - 1 of an (L, *) fp32 array (src at row 0's first
// column, rows src_stride floats apart), DH columns, into a staged tile with
// 16-byte cp.async copies; rows at or past L are zero-filled.
template <int ROWS, int DH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long src_stride,
                                           int r0, int L, int tid, int nthreads) {
  constexpr int CPR = DH / 4;  // 16-byte chunks a row
  for (int idx = tid; idx < ROWS * CPR; idx += nthreads) {
    const int j = idx / CPR;
    const int c = (idx - j * CPR) * 4;
    float* d = dst + j * stride<DH>() + c;
    if (r0 + j < L) {
      cp_async_16(d, src + static_cast<long long>(r0 + j) * src_stride + c);
    } else {
      d[0] = d[1] = d[2] = d[3] = 0.f;
    }
  }
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

// Two adjacent fp32 values of an output row.
__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

}  // namespace mma_tf32
