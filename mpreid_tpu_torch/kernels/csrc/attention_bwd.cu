// Fused multi-head self-attention backward for Hopper (sm_90a), fp32 on the
// CUDA cores.
//
// Replaces the TPU kernels ops/attention.py::_mha_bwd_kernel (packed
// [q|k|v] columns, launched by _mha_bwd_pallas) and
// ops/attention.py::_mha_bwd_kernel_hm (head-major [q_h|k_h|v_h] columns,
// launched by _mha_bwd_pallas_hm) of the JAX package, for fp32 activations;
// bf16 goes to the tensor-core kernel of attention_bwd_tc.cu. As in the
// forward (attention_fwd.cu), one kernel serves both layouts: the caller
// passes the column offsets of q, k and v for head 0 and the column stride
// from one head to the next; dqkv is written in the same packing.
//
// Math, per (batch b, head h), as in the JAX package, all in fp32. Nothing
// of the forward is saved: the probabilities are recomputed from qkv.
//   p   = softmax((q * scale) k^T + mask)
//   dv  = p^T do
//   dp  = do v^T
//   ds  = p * (dp - rowsum(dp * p))
//   dq  = ds k * scale
//   dk  = ds^T q * scale
// The mask gets no gradient.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32) at the vision shape,
// B 64, L 129, 12 heads x 64: read qkv (76.1 MB) and do (25.4 MB), write
// dqkv (76.1 MB): 177.6 MB, about 53 us; 5 products of 2 L^2 dh per (b, h)
// are 8.2 GFLOP, about 122 us on the CUDA cores. One block owns one (b, h),
// stages that head's Q, K, V and dO in shared memory, keeps the L x L
// probabilities there, and sums dK and dV over every query row itself, so
// it needs neither atomics nor a second pass, and its sums are
// deterministic.
//
// Layout of the work: grid (H, B), block kWarps warps (16 at dh 64, 8 at
// dh 128, so that a row of dh fp32 values fits in a thread's registers).
//   1. P: one query row per warp, lanes stride over the keys.
//   2. dV: one key row j per warp; each lane owns dh / 32 output columns and
//      sums P[i][j] dO[i] over every query row i.
//   3. dS: one query row per warp, lanes stride over the keys for dP and
//      the row sum; dS overwrites P in place; then the warp writes dQ for
//      its row, each lane owning dh / 32 output columns.
//   4. dK: one key row j per warp, summing dS[i][j] Q[i] over i.
// Shared memory per block, in floats:
//   Q, K, V, dO   4 * L * (dh + 1); one pad word per row, so 32 lanes
//                 reading 32 rows at one column hit 32 banks;
//   P / dS        L * L;   dP   kWarps * L (one row per warp).
// Above 48 KB the launcher opts in to dynamic shared memory. The L x L
// matrix bounds the length: the host side refuses every shape that does not
// fit in the 232,448 bytes a block may use (L above 139 at dh 64, 94 at dh
// 128) with an error that says so.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ constexpr int warps_for(int dh) { return dh == 64 ? 16 : 8; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int L, int dh) {
  const size_t l = static_cast<size_t>(L);
  const size_t stride = static_cast<size_t>(dh) + 1;
  return 4 * (4 * l * stride + l * l + static_cast<size_t>(warps_for(dh)) * l);
}

// Dot product of a row held in registers with one staged row (all lanes
// read the same words: a broadcast).
template <int DH>
__device__ __forceinline__ float dot_row(const float* x, const float* row) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) s = fmaf(x[d], row[d], s);
  return s;
}

// acc[c] += a * row[lane + 32 c] over the columns a lane owns.
template <int CW>
__device__ __forceinline__ void axpy_cols(float a, const float* row, int lane, float* acc) {
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = fmaf(a, row[lane + 32 * c], acc[c]);
}

template <int CW>
__device__ __forceinline__ void store_cols(float* dst, int lane, const float* acc, float mul) {
#pragma unroll
  for (int c = 0; c < CW; ++c) dst[lane + 32 * c] = acc[c] * mul;
}

template <int DH>
__global__ void __launch_bounds__(warps_for(DH) * 32)
mha_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
               const float* __restrict__ dout, float* __restrict__ dqkv, int L, int H,
               long long row_stride, int q_base, int k_base, int v_base, int head_stride,
               float scale) {
  constexpr int kWarps = warps_for(DH);
  constexpr int kThreads = kWarps * 32;
  constexpr int SW = DH + 1;   // staged floats per row (one pad word)
  constexpr int CW = DH / 32;  // output columns owned by each lane

  extern __shared__ float smem[];
  const size_t tile = static_cast<size_t>(L) * SW;
  float* q_s = smem;
  float* k_s = q_s + tile;
  float* v_s = k_s + tile;
  float* o_s = v_s + tile;  // dO
  float* p_s = o_s + tile;  // P, then dS
  float* dp_s = p_s + static_cast<size_t>(L) * L;  // one dP row per warp

  const int h = static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y);
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const long long D = static_cast<long long>(H) * DH;
  const float* base = qkv + static_cast<long long>(b) * L * row_stride;
  const float* dbase = dout + static_cast<long long>(b) * L * D + static_cast<long long>(h) * DH;
  float* gbase = dqkv + static_cast<long long>(b) * L * row_stride;
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;

  // Stage Q, K, V and dO of the head: consecutive threads take consecutive
  // columns of a row.
  for (int idx = static_cast<int>(threadIdx.x); idx < L * DH; idx += kThreads) {
    const int j = idx / DH;
    const int w = idx - j * DH;
    const float* row = base + static_cast<long long>(j) * row_stride;
    q_s[j * SW + w] = row[qcol + w];
    k_s[j * SW + w] = row[kcol + w];
    v_s[j * SW + w] = row[vcol + w];
    o_s[j * SW + w] = dbase[static_cast<long long>(j) * D + w];
  }
  __syncthreads();

  // 1. P = softmax((q * scale) k^T + mask), one query row per warp.
  for (int i = warp; i < L; i += kWarps) {
    float q[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = q_s[i * SW + d] * scale;
    float* prow = p_s + static_cast<size_t>(i) * L;
    const float* mrow = mask ? mask + static_cast<long long>(i) * L : nullptr;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < L; j += 32) {
      float s = dot_row<DH>(q, k_s + j * SW);
      if (mrow) s += mrow[j];
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) prow[j] = prow[j] / sum;
  }
  __syncthreads();

  // 2. dV[j] = sum_i P[i][j] dO[i], one key row per warp.
  for (int j = warp; j < L; j += kWarps) {
    float acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = 0.f;
    for (int i = 0; i < L; ++i)
      axpy_cols<CW>(p_s[static_cast<size_t>(i) * L + j], o_s + i * SW, lane, acc);
    store_cols<CW>(gbase + static_cast<long long>(j) * row_stride + vcol, lane, acc, 1.f);
  }
  __syncthreads();  // step 3 overwrites the P that step 2 reads by columns

  // 3. dS = P * (dP - rowsum(dP * P)), dP = dO V^T; dS replaces P; then
  //    dQ[i] = scale * sum_j dS[i][j] K[j].
  float* dpw = dp_s + static_cast<size_t>(warp) * L;
  for (int i = warp; i < L; i += kWarps) {
    float o[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = o_s[i * SW + d];
    float* prow = p_s + static_cast<size_t>(i) * L;
    float part = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float dp = dot_row<DH>(o, v_s + j * SW);
      dpw[j] = dp;
      part += dp * prow[j];
    }
    const float rs = warp_sum(part);
    for (int j = lane; j < L; j += 32) prow[j] = prow[j] * (dpw[j] - rs);
    __syncwarp();  // the whole dS row is read below
    float acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = 0.f;
    for (int j = 0; j < L; ++j) axpy_cols<CW>(prow[j], k_s + j * SW, lane, acc);
    store_cols<CW>(gbase + static_cast<long long>(i) * row_stride + qcol, lane, acc, scale);
    __syncwarp();  // dpw is rewritten for the warp's next row
  }
  __syncthreads();

  // 4. dK[j] = scale * sum_i dS[i][j] Q[i], one key row per warp.
  for (int j = warp; j < L; j += kWarps) {
    float acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = 0.f;
    for (int i = 0; i < L; ++i)
      axpy_cols<CW>(p_s[static_cast<size_t>(i) * L + j], q_s + i * SW, lane, acc);
    store_cols<CW>(gbase + static_cast<long long>(j) * row_stride + kcol, lane, acc, scale);
  }
}

template <int DH>
int launch(const void* qkv, const float* mask, const void* dout, void* dqkv, int B, int L,
           int H, long long row_stride, int q_base, int k_base, int v_base, int head_stride,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, DH);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(H, B);
  mha_bwd_kernel<DH><<<grid, warps_for(DH) * 32, smem, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<const float*>(dout),
      static_cast<float*>(dqkv), L, H, row_stride, q_base, k_base, v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 for an unsupported head width).
size_t mpreid_mha_bwd_smem_bytes(int L, int dh) {
  if (dh != 64 && dh != 128) return 0;
  return smem_bytes(L, dh);
}

size_t mpreid_mha_bwd_max_smem_bytes() { return kMaxSmem; }

// qkv and dqkv (B, L, row_stride) and dout (B, L, H * dh) are contiguous
// fp32; mask is null or a contiguous (L, L) fp32 array. Head h reads q at
// column q_base + h * head_stride, k and v likewise, and writes dq, dk and
// dv at the same columns of dqkv. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mpreid_mha_bwd(const void* qkv, const void* mask, const void* dout, void* dqkv, int B, int L,
                   int H, int dh, long long row_stride, int q_base, int k_base, int v_base,
                   int head_stride, float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch<64>(qkv, m, dout, dqkv, B, L, H, row_stride, q_base, k_base, v_base,
                      head_stride, scale, s);
  if (dh == 128)
    return launch<128>(qkv, m, dout, dqkv, B, L, H, row_stride, q_base, k_base, v_base,
                       head_stride, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
