// Fused multi-head self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels ops/attention.py::_mha_bwd_kernel (packed
// [q|k|v] columns, launched by _mha_bwd_pallas) and
// ops/attention.py::_mha_bwd_kernel_hm (head-major [q_h|k_h|v_h] columns,
// launched by _mha_bwd_pallas_hm) of the JAX package. As in the forward
// (attention_fwd.cu), one kernel serves both layouts: the caller passes the
// column offsets of q, k and v for head 0 and the column stride from one
// head to the next; dqkv is written in the same packing.
//
// Math, per (batch b, head h), as in the JAX package. Nothing of the
// forward is saved: the probabilities are recomputed from qkv.
//   p   = softmax((q * scale) k^T + mask)   fp32, q scaled in the activation
//                                           type (the forward's p, unrounded)
//   dv  = round(p)^T do                     fp32 sums
//   dp  = do v^T                            fp32 sums
//   ds  = p * (dp - rowsum(dp * p))         fp32, with the unrounded p
//   dq  = round(ds) k * scale               fp32 sums, unscaled k
//   dk  = round(ds)^T q * scale             fp32 sums, unscaled q
// round() is rounding to the activation type; every output is written in
// the activation type. The mask gets no gradient.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the main
// path's shape, B 64, L 129, 12 heads x 64, bf16: read qkv (38.0 MB) and do
// (12.7 MB), write dqkv (38.0 MB): 88.8 MB, about 26.5 us; 5 products of
// 2 L^2 dh per (b, h) are 8.2 GFLOP, about 8.3 us at the tensor-core peak.
// So it is bound by bytes, and the design reads each input once and writes
// each output once: one block owns one (b, h), stages that head's Q, K, V
// and dO in shared memory, keeps the L x L probabilities there, and sums dK
// and dV over every query row itself, so it needs neither atomics nor a
// second pass, and its sums are deterministic. The arithmetic runs on the
// CUDA cores in fp32 (no tensor cores yet): simple and right first.
//
// Layout of the work: grid (H, B), block kWarps warps (16 at dh 64, 8 at
// dh 128, so that a row of dh fp32 values fits in a thread's registers).
//   1. P: one query row per warp, lanes stride over the keys.
//   2. dV: one key row j per warp; each lane owns dh / 32 output words and
//      sums round(P[i][j]) dO[i] over every query row i.
//   3. dS: one query row per warp, lanes stride over the keys for dP and
//      the row sum; round(dS) overwrites P in place; then the warp writes
//      dQ for its row, each lane owning dh / 32 output words.
//   4. dK: one key row j per warp, summing round(dS[i][j]) Q[i] over i.
// Shared memory per block, in 32-bit words:
//   Q, K, V, dO   4 * L * (dh * sizeof(T) / 4 + 1); one pad word per row,
//                 so 32 lanes reading 32 rows at one column hit 32 banks;
//   P / dS        L * L fp32;   dP   kWarps * L fp32 (one row per warp).
// At L 129 that is 143 KB (bf16, dh 64), 209 KB (fp32, dh 64) and 205 KB
// (bf16, dh 128), above 48 KB, so the launcher opts in to dynamic shared
// memory. fp32 at dh 128 needs 337 KB at L 129 and does not fit in the
// 232,448 bytes a block may use: the host side refuses every shape that
// does not fit (L above 178, 141, 139 and 94 for bf16 dh 64, bf16 dh 128,
// fp32 dh 64 and fp32 dh 128) with an error that says so. The keys are not
// tiled: no shape of the ported paths needs it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ constexpr int warps_for(int dh) { return dh == 64 ? 16 : 8; }

// Round an fp32 value to the activation type's precision (round to nearest
// even, as PyTorch and XLA cast) and back.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

// Values held in one 32-bit word of a staged row: two bf16 or one fp32.
template <typename T>
__device__ __forceinline__ float2 unpack(uint32_t w) {
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
    return __bfloat1622float2(v);
  } else {
    return make_float2(__uint_as_float(w), 0.f);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack(float2 v) {
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
    return *reinterpret_cast<uint32_t*>(&b);
  } else {
    return __float_as_uint(v.x);
  }
}

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

template <typename T>
__host__ __device__ constexpr int words_per_row(int dh) { return dh * static_cast<int>(sizeof(T)) / 4; }

template <typename T>
size_t smem_bytes(int L, int dh) {
  const size_t l = static_cast<size_t>(L);
  const size_t stride = static_cast<size_t>(words_per_row<T>(dh)) + 1;
  return 4 * (4 * l * stride + l * l + static_cast<size_t>(warps_for(dh)) * l);
}

// One staged row of dh values (all lanes read the same words: a broadcast).
template <typename T, int DH>
__device__ __forceinline__ void load_row(const uint32_t* row, float* x) {
  constexpr int RW = words_per_row<T>(DH);
  constexpr int VPW = sizeof(T) == 2 ? 2 : 1;
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const float2 v = unpack<T>(row[w]);
    x[w * VPW] = v.x;
    if constexpr (VPW == 2) x[w * VPW + 1] = v.y;
  }
}

// Dot product of a row held in registers with one staged row.
template <typename T, int DH>
__device__ __forceinline__ float dot_row(const float* x, const uint32_t* row) {
  constexpr int RW = words_per_row<T>(DH);
  constexpr int VPW = sizeof(T) == 2 ? 2 : 1;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const float2 v = unpack<T>(row[w]);
    s = fmaf(x[w * VPW], v.x, s);
    if constexpr (VPW == 2) s = fmaf(x[w * VPW + 1], v.y, s);
  }
  return s;
}

// acc[c] += a * row[lane + 32 c] over the words a lane owns.
template <typename T, int CW>
__device__ __forceinline__ void axpy_words(float a, const uint32_t* row, int lane, float2* acc) {
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const float2 v = unpack<T>(row[lane + 32 * c]);
    acc[c].x = fmaf(a, v.x, acc[c].x);
    if constexpr (sizeof(T) == 2) acc[c].y = fmaf(a, v.y, acc[c].y);
  }
}

template <typename T, int CW>
__device__ __forceinline__ void store_words(T* dst, int lane, const float2* acc, float mul) {
  uint32_t* out = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
  for (int c = 0; c < CW; ++c)
    out[lane + 32 * c] = pack<T>(make_float2(acc[c].x * mul, acc[c].y * mul));
}

template <typename T, int DH>
__global__ void __launch_bounds__(warps_for(DH) * 32)
mha_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
               const T* __restrict__ dout, T* __restrict__ dqkv, int L, int H,
               long long row_stride, int q_base, int k_base, int v_base, int head_stride,
               float scale) {
  constexpr int kWarps = warps_for(DH);
  constexpr int kThreads = kWarps * 32;
  constexpr int RW = words_per_row<T>(DH);  // data words per row of one head
  constexpr int SW = RW + 1;                // staged words per row (one pad word)
  constexpr int CW = RW / 32;               // output words owned by each lane

  extern __shared__ uint32_t smem[];
  const size_t tile = static_cast<size_t>(L) * SW;
  uint32_t* q_s = smem;
  uint32_t* k_s = q_s + tile;
  uint32_t* v_s = k_s + tile;
  uint32_t* o_s = v_s + tile;  // dO
  float* p_s = reinterpret_cast<float*>(o_s + tile);  // P, then round(dS)
  float* dp_s = p_s + static_cast<size_t>(L) * L;     // one dP row per warp

  const int h = static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y);
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const long long D = static_cast<long long>(H) * DH;
  const T* base = qkv + static_cast<long long>(b) * L * row_stride;
  const T* dbase = dout + static_cast<long long>(b) * L * D + static_cast<long long>(h) * DH;
  T* gbase = dqkv + static_cast<long long>(b) * L * row_stride;
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;

  // Stage Q, K, V and dO of the head: consecutive threads take consecutive
  // words of a row.
  for (int idx = static_cast<int>(threadIdx.x); idx < L * RW; idx += kThreads) {
    const int j = idx / RW;
    const int w = idx - j * RW;
    const T* row = base + static_cast<long long>(j) * row_stride;
    q_s[j * SW + w] = reinterpret_cast<const uint32_t*>(row + qcol)[w];
    k_s[j * SW + w] = reinterpret_cast<const uint32_t*>(row + kcol)[w];
    v_s[j * SW + w] = reinterpret_cast<const uint32_t*>(row + vcol)[w];
    o_s[j * SW + w] = reinterpret_cast<const uint32_t*>(dbase + static_cast<long long>(j) * D)[w];
  }
  __syncthreads();

  // 1. P = softmax((q * scale) k^T + mask) in fp32, one query row per warp.
  const float sc = round_to<T>(scale);
  for (int i = warp; i < L; i += kWarps) {
    float q[DH];
    load_row<T, DH>(q_s + i * SW, q);
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = round_to<T>(q[d] * sc);
    float* prow = p_s + static_cast<size_t>(i) * L;
    const float* mrow = mask ? mask + static_cast<long long>(i) * L : nullptr;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < L; j += 32) {
      float s = dot_row<T, DH>(q, k_s + j * SW);
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

  // 2. dV[j] = sum_i round(P[i][j]) dO[i], one key row per warp.
  for (int j = warp; j < L; j += kWarps) {
    float2 acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = make_float2(0.f, 0.f);
    for (int i = 0; i < L; ++i)
      axpy_words<T, CW>(round_to<T>(p_s[static_cast<size_t>(i) * L + j]), o_s + i * SW, lane, acc);
    store_words<T, CW>(gbase + static_cast<long long>(j) * row_stride + vcol, lane, acc, 1.f);
  }
  __syncthreads();  // step 3 overwrites the P that step 2 reads by columns

  // 3. dS = P * (dP - rowsum(dP * P)), dP = dO V^T; round(dS) replaces P;
  //    then dQ[i] = scale * sum_j round(dS[i][j]) K[j].
  float* dpw = dp_s + static_cast<size_t>(warp) * L;
  for (int i = warp; i < L; i += kWarps) {
    float o[DH];
    load_row<T, DH>(o_s + i * SW, o);
    float* prow = p_s + static_cast<size_t>(i) * L;
    float part = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float dp = dot_row<T, DH>(o, v_s + j * SW);
      dpw[j] = dp;
      part += dp * prow[j];
    }
    const float rs = warp_sum(part);
    for (int j = lane; j < L; j += 32) prow[j] = round_to<T>(prow[j] * (dpw[j] - rs));
    __syncwarp();  // the whole dS row is read below
    float2 acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = make_float2(0.f, 0.f);
    for (int j = 0; j < L; ++j) axpy_words<T, CW>(prow[j], k_s + j * SW, lane, acc);
    store_words<T, CW>(gbase + static_cast<long long>(i) * row_stride + qcol, lane, acc, scale);
    __syncwarp();  // dpw is rewritten for the warp's next row
  }
  __syncthreads();

  // 4. dK[j] = scale * sum_i round(dS[i][j]) Q[i], one key row per warp.
  for (int j = warp; j < L; j += kWarps) {
    float2 acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = make_float2(0.f, 0.f);
    for (int i = 0; i < L; ++i)
      axpy_words<T, CW>(p_s[static_cast<size_t>(i) * L + j], q_s + i * SW, lane, acc);
    store_words<T, CW>(gbase + static_cast<long long>(j) * row_stride + kcol, lane, acc, scale);
  }
}

template <typename T, int DH>
int launch(const void* qkv, const float* mask, const void* dout, void* dqkv, int B, int L,
           int H, long long row_stride, int q_base, int k_base, int v_base, int head_stride,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(L, DH);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_bwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(H, B);
  mha_bwd_kernel<T, DH><<<grid, warps_for(DH) * 32, smem, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<const T*>(dout), static_cast<T*>(dqkv), L,
      H, row_stride, q_base, k_base, v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 for an unsupported head width).
size_t mpreid_mha_bwd_smem_bytes(int is_bf16, int L, int dh) {
  if (dh != 64 && dh != 128) return 0;
  return is_bf16 ? smem_bytes<__nv_bfloat16>(L, dh) : smem_bytes<float>(L, dh);
}

size_t mpreid_mha_bwd_max_smem_bytes() { return kMaxSmem; }

// qkv and dqkv (B, L, row_stride) and dout (B, L, H * dh) are contiguous, of
// one type (bf16 if is_bf16, else fp32); mask is null or a contiguous (L, L)
// fp32 array. Head h reads q at column q_base + h * head_stride, k and v
// likewise, and writes dq, dk and dv at the same columns of dqkv.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int mpreid_mha_bwd(const void* qkv, const void* mask, const void* dout, void* dqkv,
                   int is_bf16, int B, int L, int H, int dh, long long row_stride, int q_base,
                   int k_base, int v_base, int head_stride, float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dh == 64)
      return launch<__nv_bfloat16, 64>(qkv, m, dout, dqkv, B, L, H, row_stride, q_base, k_base,
                                       v_base, head_stride, scale, s);
    if (dh == 128)
      return launch<__nv_bfloat16, 128>(qkv, m, dout, dqkv, B, L, H, row_stride, q_base,
                                        k_base, v_base, head_stride, scale, s);
  } else {
    if (dh == 64)
      return launch<float, 64>(qkv, m, dout, dqkv, B, L, H, row_stride, q_base, k_base, v_base,
                               head_stride, scale, s);
    if (dh == 128)
      return launch<float, 128>(qkv, m, dout, dqkv, B, L, H, row_stride, q_base, k_base,
                                v_base, head_stride, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
