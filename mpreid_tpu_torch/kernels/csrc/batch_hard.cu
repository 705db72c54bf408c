// Fused batch-hard mining for Hopper (sm_90a): for B rows of D-wide features
// and their int32 labels,
//   d(i, j) = sqrt(max(|f_i|^2 + |f_j|^2 - 2 f_i.f_j, 1e-12))
//   ap[i] = max over j with label j == label i of d(i, j),  p[i] = its argmax
//   an[i] = min over j with label j != label i of d(i, j),  n[i] = its argmin
// Each argmax / argmin takes the first index on a tie (jnp.argmax's rule); a
// row with no negative gets an = +inf and n = 0. The input is fp32 or bf16
// and is read as fp32; all arithmetic is fp32.
//
// Replaces the TPU kernel ops/pallas_kernels.py::_batch_hard_forward (body
// _batch_hard_kernel) of the JAX package, which keeps the B x B matrix in
// VMEM. Here it lives in registers: no distance is written to device memory.
//
// What bounds it on an H100: at the PK batch of the training path (B 64,
// D 768) the work is 6.3 MFLOP (0.094 us at 67 TFLOP/s fp32) and the bytes
// 197 KB (0.059 us at 3.35 TB/s), so the kernel is bound by its launch and
// its one pass over D, not by either rate.
//
// Design: each block owns 32 anchor rows and walks over the batch in
// column tiles of 64; for each tile it stages 32-wide chunks of both row
// sets through shared memory and each of its 256 threads keeps a 2 x 4
// micro-tile of fp32 dot products in registers, and beside them the squared
// norms of its 2 rows and 4 columns, summed in the same order as the dot
// products (so d(i, i) is exactly sqrt(1e-12) and d(i, j) == d(j, i)). The
// formula keeps the JAX order: (sq_i + sq_j) - 2 dot, clamp, sqrt, with no
// contraction into a fused multiply-add. Each thread then folds its
// candidates into a running (max, argmax) and (min, argmin) per row, in
// increasing column order with strict comparisons, so the first index wins
// a tie; the 16 threads that share a row combine their pairs with warp
// shuffles comparing (value, index). No reduction crosses blocks, so any B
// works and every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kRows = 32;      // anchor rows per block
constexpr int kCols = 64;      // columns per tile
constexpr int kChunk = 32;     // D per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTx = 16;        // threads along the columns (share a row)
constexpr int kRm = kRows / (kThreads / kTx);  // rows per thread: 2
constexpr int kCm = kCols / kTx;               // columns per thread: 4
constexpr int kRowPitch = kRows + 4;
constexpr int kColPitch = kCols + 4;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// (v, i) is better than (best, bi) for a max: larger, or equal at a lower index
__device__ __forceinline__ bool better_max(float v, int i, float best, int bi) {
  return v > best || (v == best && i < bi);
}

__device__ __forceinline__ bool better_min(float v, int i, float best, int bi) {
  return v < best || (v == best && i < bi);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
batch_hard_kernel(const T* __restrict__ f, const int* __restrict__ labels,
                  float* __restrict__ ap, float* __restrict__ an, int* __restrict__ p,
                  int* __restrict__ n, int b, int d, long long ld) {
  __shared__ __align__(16) float rs[kChunk][kRowPitch];
  __shared__ __align__(16) float cs[kChunk][kColPitch];
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int row0 = blockIdx.x * kRows;
  const int lk = tid % kChunk;  // loads: consecutive threads, consecutive k
  const int lr = tid / kChunk;  // 8 rows per pass

  int my_label[kRm];
  float best_p[kRm], best_n[kRm];
  int idx_p[kRm], idx_n[kRm];
#pragma unroll
  for (int r = 0; r < kRm; ++r) {
    const int i = row0 + ty * kRm + r;
    my_label[r] = i < b ? labels[i] : 0;
    best_p[r] = -INFINITY;
    idx_p[r] = 0;
    best_n[r] = INFINITY;
    idx_n[r] = 0;
  }

  for (int col0 = 0; col0 < b; col0 += kCols) {
    float acc[kRm][kCm];
    float sqr[kRm], sqc[kCm];
#pragma unroll
    for (int r = 0; r < kRm; ++r) {
      sqr[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kCm; ++c) acc[r][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kCm; ++c) sqc[c] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int k = k0 + lk;
      const bool k_in = k < d;
#pragma unroll
      for (int q = 0; q < kRows / (kThreads / kChunk); ++q) {
        const int r = lr + q * (kThreads / kChunk);
        const int i = row0 + r;
        rs[lk][r] = (k_in && i < b) ? load(f + static_cast<long long>(i) * ld + k) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kCols / (kThreads / kChunk); ++q) {
        const int c = lr + q * (kThreads / kChunk);
        const int j = col0 + c;
        cs[lk][c] = (k_in && j < b) ? load(f + static_cast<long long>(j) * ld + k) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        const float2 a2 = *reinterpret_cast<const float2*>(&rs[kk][ty * kRm]);
        const float4 b4 = *reinterpret_cast<const float4*>(&cs[kk][tx * kCm]);
        const float x[kRm] = {a2.x, a2.y};
        const float y[kCm] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < kRm; ++r) {
          sqr[r] = fmaf(x[r], x[r], sqr[r]);
#pragma unroll
          for (int c = 0; c < kCm; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
        }
#pragma unroll
        for (int c = 0; c < kCm; ++c) sqc[c] = fmaf(y[c], y[c], sqc[c]);
      }
      __syncthreads();
    }

    // this thread's columns in increasing order: strict comparisons keep
    // the first index of a tie
#pragma unroll
    for (int c = 0; c < kCm; ++c) {
      const int j = col0 + tx * kCm + c;
      if (j >= b) continue;
      const int lj = labels[j];
#pragma unroll
      for (int r = 0; r < kRm; ++r) {
        const float d2 = __fsub_rn(__fadd_rn(sqr[r], sqc[c]), __fmul_rn(2.f, acc[r][c]));
        const float dist = __fsqrt_rn(fmaxf(d2, 1e-12f));
        if (lj == my_label[r]) {
          if (dist > best_p[r]) { best_p[r] = dist; idx_p[r] = j; }
        } else {
          if (dist < best_n[r]) { best_n[r] = dist; idx_n[r] = j; }
        }
      }
    }
  }

  // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int r = 0; r < kRm; ++r) {
#pragma unroll
    for (int off = kTx / 2; off > 0; off >>= 1) {
      const float vp = __shfl_xor_sync(0xffffffffu, best_p[r], off);
      const int ip = __shfl_xor_sync(0xffffffffu, idx_p[r], off);
      const float vn = __shfl_xor_sync(0xffffffffu, best_n[r], off);
      const int in = __shfl_xor_sync(0xffffffffu, idx_n[r], off);
      if (better_max(vp, ip, best_p[r], idx_p[r])) { best_p[r] = vp; idx_p[r] = ip; }
      if (better_min(vn, in, best_n[r], idx_n[r])) { best_n[r] = vn; idx_n[r] = in; }
    }
    const int i = row0 + ty * kRm + r;
    if (tx == 0 && i < b) {
      ap[i] = best_p[r];
      p[i] = idx_p[r];
      an[i] = best_n[r];
      n[i] = idx_n[r];
    }
  }
}

}  // namespace

extern "C" {

// f: b rows of d values (fp32, or bf16 when is_bf16), row i at f + i * ld,
// each row contiguous; labels: b int32; ap, an: b fp32; p, n: b int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success); b of 0
// launches nothing.
int mpreid_batch_hard(const void* f, const void* labels, void* ap, void* an, void* p, void* n,
                      int b, int d, long long ld, int is_bf16, void* stream) {
  if (b <= 0) return 0;
  const dim3 grid((b + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* ap_ = static_cast<float*>(ap);
  float* an_ = static_cast<float*>(an);
  int* p_ = static_cast<int*>(p);
  int* n_ = static_cast<int*>(n);
  if (is_bf16) {
    batch_hard_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(f), lab, ap_, an_, p_, n_, b, d, ld);
  } else {
    batch_hard_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(f), lab, ap_, an_, p_, n_, b, d, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
