// Fused multi-head self-attention forward for Hopper (sm_90a), fp32 on the
// CUDA cores.
//
// Replaces the TPU kernels ops/attention.py::_mha_fwd_kernel (packed
// [q|k|v] columns, launched by _mha_fwd_pallas) and
// ops/attention.py::_mha_fwd_kernel_hm (head-major [q_h|k_h|v_h] columns,
// launched by _mha_fwd_pallas_hm) of the JAX package, for fp32 activations;
// bf16 goes to the tensor-core kernel of attention_fwd_tc.cu. fp32 stays on
// the CUDA cores because the card-vs-CPU checks hold it to 1e-5, which TF32
// tensor cores cannot meet. One kernel serves both layouts: the caller
// passes the column offsets of q, k and v for head 0 and the column stride
// from one head to the next.
//
// Math, per (batch b, head h), as in the JAX package:
//   s   = (q * scale) k^T      fp32
//   s  += mask                 optional additive (L, L) fp32 mask; -inf is
//                              allowed as long as no row is fully masked
//   p   = softmax(s)           fp32
//   out = p v                  fp32
//
// Bound on an H100 SXM (80 GB, 3.35 TB/s, 67 TFLOP/s fp32) at the vision
// shape, B 64, L 129, 12 heads x 64: read qkv once (76.1 MB) and write out
// once (25.4 MB), about 30 us, against 3.3 GFLOP, about 49 us on the CUDA
// cores: bound by operations. Each block stages K_h and V_h in shared memory
// once and reuses them for 32 query rows, so K/V are read from device
// memory ceil(L/32) times per head (L2 absorbs most of it), and the scores
// and probabilities never leave shared memory.
//
// Layout of the work:
//   grid  (ceil(L / kRows), H, B), block kWarps warps;
//   each warp owns one query row at a time: its lanes stride over the keys
//   for the scores, max and sum are warp-shuffle reductions, and for P.V
//   each lane owns dh / 32 output columns.
// Shared memory per block:
//   K_h, V_h   2 * L * (dh + 1) floats; one pad word per row, so 32 lanes
//              reading 32 keys at one column hit 32 banks;
//   q rows     kWarps * dh floats;  scores  kWarps * L floats.
// Above 48 KB this needs the dynamic shared-memory opt-in; the host side
// refuses a length that does not fit in the 227 KB a block may use (L above
// 417 at dh 64, 214 at dh 128).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps per block
constexpr int kThreads = kWarps * 32;  // threads per block
constexpr int kRows = 32;              // query rows per block
constexpr size_t kMaxSmem = 232448;    // bytes of shared memory a block may use
constexpr size_t kDefaultSmem = 48 * 1024;

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
  const size_t stride = static_cast<size_t>(dh) + 1;
  return 4 * (2 * static_cast<size_t>(L) * stride + kWarps * static_cast<size_t>(dh) +
              kWarps * static_cast<size_t>(L));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
               float* __restrict__ out, int L, int H, long long row_stride, int q_base,
               int k_base, int v_base, int head_stride, float scale) {
  constexpr int SW = DH + 1;   // staged floats per row (one pad word)
  constexpr int CW = DH / 32;  // output columns owned by each lane

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = smem + static_cast<size_t>(L) * SW;
  float* q_s = smem + 2 * static_cast<size_t>(L) * SW;
  float* p_s = q_s + kWarps * DH;

  const int h = static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const float* base = qkv + static_cast<long long>(b) * L * row_stride;
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;

  // Stage K_h and V_h: consecutive threads take consecutive columns of a row.
  for (int idx = static_cast<int>(threadIdx.x); idx < L * DH; idx += kThreads) {
    const int j = idx / DH;
    const int w = idx - j * DH;
    const float* row = base + static_cast<long long>(j) * row_stride;
    k_s[j * SW + w] = row[kcol + w];
    v_s[j * SW + w] = row[vcol + w];
  }
  __syncthreads();

  float* qw = q_s + warp * DH;
  float* pw = p_s + warp * L;
  const int row0 = static_cast<int>(blockIdx.x) * kRows;
  const int row_end = min(row0 + kRows, L);

  for (int i = row0 + warp; i < row_end; i += kWarps) {
    const float* qrow = base + static_cast<long long>(i) * row_stride + qcol;
    for (int d = lane; d < DH; d += 32) qw[d] = qrow[d] * scale;
    __syncwarp();
    float q[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = qw[d];

    // scores: lane j takes keys j, j + 32, ...
    const float* mrow = mask ? mask + static_cast<long long>(i) * L : nullptr;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < L; j += 32) {
      const float* kr = k_s + j * SW;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(q[d], kr[d], s);
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
    for (int j = lane; j < L; j += 32) pw[j] = pw[j] / sum;
    __syncwarp();

    // out = p v: lane owns columns lane, lane + 32, ... of the output row
    float acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = pw[j];
      const float* vr = v_s + j * SW;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[c] = fmaf(p, vr[lane + 32 * c], acc[c]);
    }
    float* orow = out + (static_cast<long long>(b) * L + i) * (static_cast<long long>(H) * DH) + h * DH;
#pragma unroll
    for (int c = 0; c < CW; ++c) orow[lane + 32 * c] = acc[c];
    __syncwarp();  // qw and pw are rewritten for the warp's next row
  }
}

template <int DH>
int launch(const void* qkv, const float* mask, void* out, int B, int L, int H,
           long long row_stride, int q_base, int k_base, int v_base, int head_stride,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, DH);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  mha_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<float*>(out), L, H, row_stride, q_base,
      k_base, v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 for an unsupported head width).
size_t mpreid_mha_fwd_smem_bytes(int L, int dh) {
  if (dh != 64 && dh != 128) return 0;
  return smem_bytes(L, dh);
}

size_t mpreid_mha_fwd_max_smem_bytes() { return kMaxSmem; }

// qkv (B, L, row_stride) and out (B, L, H * dh) are contiguous fp32; mask is
// null or a contiguous (L, L) fp32 array. Head h reads q at column q_base +
// h * head_stride, k and v likewise. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mpreid_mha_fwd(const void* qkv, const void* mask, void* out, int B, int L, int H, int dh,
                   long long row_stride, int q_base, int k_base, int v_base, int head_stride,
                   float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch<64>(qkv, m, out, B, L, H, row_stride, q_base, k_base, v_base, head_stride,
                      scale, s);
  if (dh == 128)
    return launch<128>(qkv, m, out, B, L, H, row_stride, q_base, k_base, v_base, head_stride,
                       scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
