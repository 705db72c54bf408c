// Pairwise cross "distances" between the rows of two fp32 matrices, for
// Hopper (sm_90a):
//   mpreid_l1_cross:     out[i, j] = sum_k |a[i, k] - b[j, k]|
//   mpreid_minsum_cross: out[i, j] = sum_k min(a[i, k], b[j, k])
// with a (Q, N), b (G, N) and out (Q, G), rows contiguous, any row stride.
//
// Replaces the TPU kernels ops/pallas_kernels.py::l1_cross_pallas (body
// _l1_kernel) and ::minsum_cross_pallas (body _minsum_kernel) of the JAX
// package: the exact Jaccard step of the dense re-ranking (min-sum =
// 1 - L1 / 2, ops/reranking.py) and the exact min-sum of the sparse-V
// re-ranking (ops/reranking_sparse.py).
//
// What bounds it on an H100: operations. Each element pair costs two fp32
// operations (a subtract and an add with |.| as a free source modifier, or
// a min and an add) and no tensor-core instruction computes either, so the
// work runs on the CUDA cores. At the dense Market-1501 shape (3368 x 15913
// rows over N = 19281) that is 2.07e12 operations against 1.70 GB of
// inputs and output: ~1,200 operations per byte, far above the card's
// ~20 fp32 operations per byte of memory rate. Neither operation is a fused
// multiply-add, so the issue rate of one instruction per lane per cycle,
// and not the 67 TFLOP/s counted with FMA as two, is the real ceiling:
// about twice the bound stated by operations over 67 TFLOP/s.
//
// Design: the SIMT SGEMM tile with the operator in place of the FMA. Each
// block owns one 64 x 64 tile of the output and walks over K itself in
// chunks of 32, staging both operands through shared memory K-major (rows
// of 64 + 4 floats: 16-byte aligned, fewer bank conflicts), and each of its 256
// threads keeps a 4 x 4 micro-tile of fp32 sums in registers, reading its
// four a and four b values per k as two 16-byte shared-memory loads. The
// Pallas kernel's sequential K grid axis, which revisits the output block
// in VMEM, becomes the loop inside the block: no atomics, so every run
// gives the same bits. Ragged edges are masked on load (a row or a k past
// the end reads 0, and |0 - 0| = min(0, 0) = 0 adds nothing) and on store,
// so nothing is padded or copied. Offsets are 64-bit: a 4096-row gallery
// chunk at N = 93,820 already holds 384 M elements. 64 x 64 tiles keep the
// path's skinny shapes spread over the card (the 256-row rows oracle makes
// 4 x 64 blocks per 4096-row chunk).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output rows and columns per block
constexpr int kChunk = 32;     // K per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMicro = 4;
constexpr int kPitch = kTile + 4;  // floats per shared row: 16-byte aligned
constexpr int kLoadRows = kThreads / kChunk;  // rows loaded per pass

struct L1Op {
  __device__ __forceinline__ static float step(float acc, float x, float y) {
    return acc + fabsf(x - y);
  }
};

struct MinOp {
  __device__ __forceinline__ static float step(float acc, float x, float y) {
    return acc + fminf(x, y);
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
cross_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
             int q, int g, int n, long long lda, long long ldb, long long ldo) {
  __shared__ __align__(16) float as[kChunk][kPitch];
  __shared__ __align__(16) float bs[kChunk][kPitch];
  const int tid = threadIdx.x;
  const int tx = tid % (kTile / kMicro);
  const int ty = tid / (kTile / kMicro);
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  // loads: consecutive threads take consecutive k of one row (coalesced)
  const int lk = tid % kChunk;
  const int lr = tid / kChunk;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int k = k0 + lk;
    const bool k_in = k < n;
#pragma unroll
    for (int p = 0; p < kTile / kLoadRows; ++p) {
      const int r = lr + p * kLoadRows;
      const int ra = row0 + r;
      const int rb = col0 + r;
      as[lk][r] = (k_in && ra < q) ? a[static_cast<long long>(ra) * lda + k] : 0.f;
      bs[lk][r] = (k_in && rb < g) ? b[static_cast<long long>(rb) * ldb + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * kMicro]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * kMicro]);
      const float x[kMicro] = {av.x, av.y, av.z, av.w};
      const float y[kMicro] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = Op::step(acc[i][j], x[i], y[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = row0 + ty * kMicro + i;
    if (r >= q) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = col0 + tx * kMicro + j;
      if (c < g) out[static_cast<long long>(r) * ldo + c] = acc[i][j];
    }
  }
}

template <class Op>
int launch(const void* a, const void* b, void* out, int q, int g, int n, long long lda,
           long long ldb, long long ldo, void* stream) {
  if (q <= 0 || g <= 0) return 0;
  const dim3 grid((g + kTile - 1) / kTile, (q + kTile - 1) / kTile);
  cross_kernel<Op><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out),
      q, g, n, lda, ldb, ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a: q rows of n fp32 values, row i at a + i * lda; b: g rows, row j at
// b + j * ldb; out: q rows of g fp32 values, row i at out + i * ldo. Every
// row is contiguous. Launches on `stream` and returns cudaGetLastError()
// (0 on success); q or g of 0 launches nothing.
int mpreid_l1_cross(const void* a, const void* b, void* out, int q, int g, int n,
                    long long lda, long long ldb, long long ldo, void* stream) {
  return launch<L1Op>(a, b, out, q, g, n, lda, ldb, ldo, stream);
}

int mpreid_minsum_cross(const void* a, const void* b, void* out, int q, int g, int n,
                        long long lda, long long ldb, long long ldo, void* stream) {
  return launch<MinOp>(a, b, out, q, g, n, lda, ldb, ldo, stream);
}

}  // extern "C"
