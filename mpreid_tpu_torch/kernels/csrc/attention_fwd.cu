// Fused multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels ops/attention.py::_mha_fwd_kernel (packed
// [q|k|v] columns, launched by _mha_fwd_pallas) and
// ops/attention.py::_mha_fwd_kernel_hm (head-major [q_h|k_h|v_h] columns,
// launched by _mha_fwd_pallas_hm) of the JAX package. One kernel serves
// both layouts: the caller passes the column offsets of q, k and v for head
// 0 and the column stride from one head to the next.
//
// Math, per (batch b, head h), as in the JAX package:
//   s   = (q * scale) k^T      q scaled in the activation type, fp32 sums
//   s  += mask                 optional additive (L, L) fp32 mask; -inf is
//                              allowed as long as no row is fully masked
//   p   = softmax(s)           fp32, then rounded to the activation type
//   out = p v                  fp32 sums, written in the activation type
//
// Bound on an H100 SXM (80 GB, 3.35 TB/s, 989 TFLOP/s bf16 dense) at the
// main path's shape, B 64, L 129, 12 heads x 64, bf16: the kernel must
// read qkv once (38.0 MB) and write out once (12.7 MB), about 15 us of
// memory traffic, against 3.3 GFLOP of arithmetic, about 3.3 us at the
// tensor-core peak. So it is bound by bytes. The design moves no more than
// that: each block stages K_h and V_h in shared memory once and reuses them
// for 32 query rows, so K/V are read from device memory ceil(L/32) times
// per head (L2 absorbs most of it), and the scores and probabilities never
// leave shared memory. The arithmetic runs on the CUDA cores in fp32 (no
// tensor cores yet): simple and right first, fast in a later change.
//
// Layout of the work:
//   grid  (ceil(L / kRows), H, B), block kWarps warps;
//   each warp owns one query row at a time: its lanes stride over the keys
//   for the scores, max and sum are warp-shuffle reductions, and for P.V
//   each lane owns dh / 32 output columns (as 32-bit words of the row).
// Shared memory per block:
//   K_h, V_h   2 * L * (dh * sizeof(T) / 4 + 1) words; one pad word per row,
//              so 32 lanes reading 32 keys at one column hit 32 banks;
//   q rows     kWarps * dh floats;  scores  kWarps * L floats.
// Above 48 KB this needs the dynamic shared-memory opt-in; the host side
// refuses a length that does not fit in the 227 KB a block may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps per block
constexpr int kThreads = kWarps * 32;  // threads per block
constexpr int kRows = 32;              // query rows per block
constexpr size_t kMaxSmem = 232448;    // bytes of shared memory a block may use
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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
  const size_t stride = static_cast<size_t>(words_per_row<T>(dh)) + 1;
  return 4 * (2 * static_cast<size_t>(L) * stride + kWarps * static_cast<size_t>(dh) +
              kWarps * static_cast<size_t>(L));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask, T* __restrict__ out,
               int L, int H, long long row_stride, int q_base, int k_base, int v_base,
               int head_stride, float scale) {
  constexpr int RW = words_per_row<T>(DH);  // data words per row of one head
  constexpr int SW = RW + 1;                // staged words per row (one pad word)
  constexpr int VPW = sizeof(T) == 2 ? 2 : 1;  // values per word
  constexpr int CW = RW / 32;               // output words owned by each lane

  extern __shared__ uint32_t smem[];
  uint32_t* k_s = smem;
  uint32_t* v_s = smem + static_cast<size_t>(L) * SW;
  float* q_s = reinterpret_cast<float*>(smem + 2 * static_cast<size_t>(L) * SW);
  float* p_s = q_s + kWarps * DH;

  const int h = static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const T* base = qkv + static_cast<long long>(b) * L * row_stride;
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;

  // Stage K_h and V_h: consecutive threads take consecutive words of a row.
  for (int idx = static_cast<int>(threadIdx.x); idx < L * RW; idx += kThreads) {
    const int j = idx / RW;
    const int w = idx - j * RW;
    const T* row = base + static_cast<long long>(j) * row_stride;
    k_s[j * SW + w] = reinterpret_cast<const uint32_t*>(row + kcol)[w];
    v_s[j * SW + w] = reinterpret_cast<const uint32_t*>(row + vcol)[w];
  }
  __syncthreads();

  float* qw = q_s + warp * DH;
  float* pw = p_s + warp * L;
  const float sc = round_to<T>(scale);
  const int row0 = static_cast<int>(blockIdx.x) * kRows;
  const int row_end = min(row0 + kRows, L);

  for (int i = row0 + warp; i < row_end; i += kWarps) {
    const T* qrow = base + static_cast<long long>(i) * row_stride + qcol;
    for (int d = lane; d < DH; d += 32) qw[d] = round_to<T>(to_float(qrow[d]) * sc);
    __syncwarp();
    float q[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = qw[d];

    // scores: lane j takes keys j, j + 32, ...
    const float* mrow = mask ? mask + static_cast<long long>(i) * L : nullptr;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < L; j += 32) {
      const uint32_t* kr = k_s + j * SW;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        const float2 kv = unpack<T>(kr[w]);
        s = fmaf(q[w * VPW], kv.x, s);
        if constexpr (VPW == 2) s = fmaf(q[w * VPW + 1], kv.y, s);
      }
      if (mrow) s += mrow[j];
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) pw[j] = round_to<T>(pw[j] / sum);
    __syncwarp();

    // out = p v: lane owns words lane, lane + 32, ... of the output row
    float2 acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = make_float2(0.f, 0.f);
    for (int j = 0; j < L; ++j) {
      const float p = pw[j];
      const uint32_t* vr = v_s + j * SW;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float2 vv = unpack<T>(vr[lane + 32 * c]);
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        if constexpr (VPW == 2) acc[c].y = fmaf(p, vv.y, acc[c].y);
      }
    }
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        out + (static_cast<long long>(b) * L + i) * (static_cast<long long>(H) * DH) + h * DH);
#pragma unroll
    for (int c = 0; c < CW; ++c) orow[lane + 32 * c] = pack<T>(acc[c]);
    __syncwarp();  // qw and pw are rewritten for the warp's next row
  }
}

template <typename T, int DH>
int launch(const void* qkv, const float* mask, void* out, int B, int L, int H,
           long long row_stride, int q_base, int k_base, int v_base, int head_stride,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(L, DH);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  mha_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), L, H, row_stride, q_base,
      k_base, v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 for an unsupported head width).
size_t mpreid_mha_fwd_smem_bytes(int is_bf16, int L, int dh) {
  if (dh != 64 && dh != 128) return 0;
  return is_bf16 ? smem_bytes<__nv_bfloat16>(L, dh) : smem_bytes<float>(L, dh);
}

size_t mpreid_mha_fwd_max_smem_bytes() { return kMaxSmem; }

// qkv (B, L, row_stride) and out (B, L, H * dh) are contiguous, of one type
// (bf16 if is_bf16, else fp32); mask is null or a contiguous (L, L) fp32
// array. Head h reads q at column q_base + h * head_stride, k and v likewise.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int mpreid_mha_fwd(const void* qkv, const void* mask, void* out, int is_bf16, int B, int L,
                   int H, int dh, long long row_stride, int q_base, int k_base, int v_base,
                   int head_stride, float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dh == 64)
      return launch<__nv_bfloat16, 64>(qkv, m, out, B, L, H, row_stride, q_base, k_base,
                                       v_base, head_stride, scale, s);
    if (dh == 128)
      return launch<__nv_bfloat16, 128>(qkv, m, out, B, L, H, row_stride, q_base, k_base,
                                        v_base, head_stride, scale, s);
  } else {
    if (dh == 64)
      return launch<float, 64>(qkv, m, out, B, L, H, row_stride, q_base, k_base, v_base,
                               head_stride, scale, s);
    if (dh == 128)
      return launch<float, 128>(qkv, m, out, B, L, H, row_stride, q_base, k_base, v_base,
                                head_stride, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
