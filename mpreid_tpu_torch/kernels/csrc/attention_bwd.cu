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
// dqkv (76.1 MB): 177.6 MB, about 53 us; the 5 products of 2 L^2 dh per
// (b, h) are 8.2 GFLOP, about 122 us on the CUDA cores: bound by operations.
//
// Design: nothing L x L is kept, so the length is bounded as the forward's
// is, by two staged operands (L 417 at dh 64, 214 at dh 128), not by the
// L x L probabilities (L 139 and 94 before). One block owns one (b, h), so
// every sum is the block's own: no atomics, and the result is the same bits
// on every run. It works in two phases, as attention_bwd_tc.cu does:
//   1. by query rows, with K and V staged: one warp a row, its lanes
//      striding over the keys. The row's logits give its max m and
//      1 / sum l; dP = dO V^T (kept in registers, at most 14 keys a lane)
//      gives delta = rowsum(dP * p); dS replaces the logits in the warp's
//      row buffer, and dQ = scale * dS K, each lane owning dh / 32 columns.
//      m, 1/l and delta (12 bytes a row) go to a scratch array the wrapper
//      allocates: at the longest lengths shared memory has no room for them.
//   2. by key rows, with Q and dO staged in the same shared memory: one
//      warp a key row j, its lanes striding over the query rows. p[i][j] is
//      recomputed from the row statistics, bit for bit as phase 1 had it
//      (the same products in the same order); dV[j] = sum_i p dO[i]; then
//      dS[i][j] = p (dP[i][j] - delta[i]) and dK[j] = scale * sum_i dS Q[i].
// Seven L^2 dh products where the kernel that kept P in shared memory did
// five: the logits and dP are formed in both phases.
// Shared memory per block, in floats:
//   two staged operands   2 * L * (dh + 1); one pad word per row, so 32
//                         lanes reading 32 rows at one column hit 32 banks;
//   row buffers           kWarps * L (logits, p or dS of the warp's row);
//   row staging           kWarps * dh (a row on its way to registers).
// Above 48 KB the launcher opts in to dynamic shared memory.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps per block
constexpr int kThreads = kWarps * 32;  // threads per block
constexpr int kKeysPerLane = 14;       // dP values a lane keeps in phase 1
constexpr int kMaxL = 32 * kKeysPerLane;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use
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

// Bytes of shared memory a block needs; above kMaxSmem for a length the
// kernel does not take.
size_t smem_bytes(int L, int dh) {
  if (L > kMaxL) return kMaxSmem + 1;
  const size_t l = static_cast<size_t>(L);
  const size_t d = static_cast<size_t>(dh);
  return 4 * (2 * l * (d + 1) + kWarps * l + kWarps * d);
}

// Copy a global row of DH floats into the warp's staging buffer (times mul),
// then into registers.
template <int DH>
__device__ __forceinline__ void row_to_regs(const float* src, float mul, float* stage, int lane,
                                            float* regs) {
  for (int d = lane; d < DH; d += 32) stage[d] = src[d] * mul;
  __syncwarp();
#pragma unroll
  for (int d = 0; d < DH; ++d) regs[d] = stage[d];
  __syncwarp();  // the buffer is rewritten for the next row
}

// Dot product of a row held in registers with one staged row.
template <int DH>
__device__ __forceinline__ float dot_row(const float* x, const float* row) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) s = fmaf(x[d], row[d], s);
  return s;
}

// dst[lane + 32 c] = mul * sum_r w[r] * rows[r][lane + 32 c], r < L.
template <int DH>
__device__ __forceinline__ void weighted_rows(const float* w, const float* rows, int L, int lane,
                                              float mul, float* dst) {
  constexpr int SW = DH + 1;
  constexpr int CW = DH / 32;
  float acc[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = 0.f;
  for (int r = 0; r < L; ++r) {
    const float a = w[r];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = fmaf(a, rows[r * SW + lane + 32 * c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < CW; ++c) dst[lane + 32 * c] = acc[c] * mul;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
               const float* __restrict__ dout, float* __restrict__ dqkv,
               float* __restrict__ stats, int L, int H, long long row_stride, int q_base,
               int k_base, int v_base, int head_stride, float scale) {
  constexpr int SW = DH + 1;  // staged floats per row (one pad word)

  extern __shared__ float smem[];
  const size_t tile = static_cast<size_t>(L) * SW;
  float* a_s = smem;         // K, then Q
  float* b_s = smem + tile;  // V, then dO
  float* rowbuf = b_s + tile;
  float* stage = rowbuf + static_cast<size_t>(kWarps) * L;

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
  float* m_g = stats + (static_cast<long long>(b) * H + h) * 3 * L;  // row max
  float* il_g = m_g + L;                                              // 1 / row sum
  float* dl_g = il_g + L;                                             // delta
  float* pw = rowbuf + static_cast<size_t>(warp) * L;
  float* sw = stage + warp * DH;

  // ---- phase 1: stage K and V; one query row per warp
  for (int idx = static_cast<int>(threadIdx.x); idx < L * DH; idx += kThreads) {
    const int j = idx / DH;
    const int w = idx - j * DH;
    const float* row = base + static_cast<long long>(j) * row_stride;
    a_s[j * SW + w] = row[kcol + w];
    b_s[j * SW + w] = row[vcol + w];
  }
  __syncthreads();

  for (int i = warp; i < L; i += kWarps) {
    float x[DH];  // q * scale, then dO
    row_to_regs<DH>(base + static_cast<long long>(i) * row_stride + qcol, scale, sw, lane, x);
    const float* mrow = mask ? mask + static_cast<long long>(i) * L : nullptr;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < L; j += 32) {
      float s = dot_row<DH>(x, a_s + j * SW);
      if (mrow) s += mrow[j];
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) sum += expf(pw[j] - mx);
    const float inv = 1.f / warp_sum(sum);

    row_to_regs<DH>(dbase + static_cast<long long>(i) * D, 1.f, sw, lane, x);
    float dp[kKeysPerLane];
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < L) {
        dp[t] = dot_row<DH>(x, b_s + j * SW);
        part = fmaf(dp[t], expf(pw[j] - mx) * inv, part);
      }
    }
    const float delta = warp_sum(part);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < L) pw[j] = expf(pw[j] - mx) * inv * (dp[t] - delta);
    }
    if (lane == 0) {
      m_g[i] = mx;
      il_g[i] = inv;
      dl_g[i] = delta;
    }
    __syncwarp();  // the whole dS row is read below
    weighted_rows<DH>(pw, a_s, L, lane, scale,
                      gbase + static_cast<long long>(i) * row_stride + qcol);
    __syncwarp();  // pw is rewritten for the warp's next row
  }
  __syncthreads();  // K and V are overwritten; the statistics are written

  // ---- phase 2: stage Q and dO; one key row per warp
  for (int idx = static_cast<int>(threadIdx.x); idx < L * DH; idx += kThreads) {
    const int j = idx / DH;
    const int w = idx - j * DH;
    a_s[j * SW + w] = base[static_cast<long long>(j) * row_stride + qcol + w];
    b_s[j * SW + w] = dbase[static_cast<long long>(j) * D + w];
  }
  __syncthreads();

  for (int j = warp; j < L; j += kWarps) {
    float x[DH];  // k, then v
    row_to_regs<DH>(base + static_cast<long long>(j) * row_stride + kcol, 1.f, sw, lane, x);
    for (int i = lane; i < L; i += 32) {
      // (q * scale) . k with the products and order of phase 1
      const float* qr = a_s + i * SW;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qr[d] * scale, x[d], s);
      if (mask) s += mask[static_cast<long long>(i) * L + j];
      pw[i] = expf(s - m_g[i]) * il_g[i];
    }
    __syncwarp();
    weighted_rows<DH>(pw, b_s, L, lane, 1.f, gbase + static_cast<long long>(j) * row_stride + vcol);

    row_to_regs<DH>(base + static_cast<long long>(j) * row_stride + vcol, 1.f, sw, lane, x);
    for (int i = lane; i < L; i += 32) pw[i] = pw[i] * (dot_row<DH>(x, b_s + i * SW) - dl_g[i]);
    __syncwarp();
    weighted_rows<DH>(pw, a_s, L, lane, scale,
                      gbase + static_cast<long long>(j) * row_stride + kcol);
    __syncwarp();  // pw is rewritten for the warp's next row
  }
}

template <int DH>
int launch(const void* qkv, const float* mask, const void* dout, void* dqkv, void* stats, int B,
           int L, int H, long long row_stride, int q_base, int k_base, int v_base,
           int head_stride, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, DH);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(H, B);
  mha_bwd_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<const float*>(dout),
      static_cast<float*>(dqkv), static_cast<float*>(stats), L, H, row_stride, q_base, k_base,
      v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 for an unsupported head width;
// above mpreid_mha_bwd_max_smem_bytes() for a length the kernel refuses).
size_t mpreid_mha_bwd_smem_bytes(int L, int dh) {
  if (dh != 64 && dh != 128) return 0;
  return smem_bytes(L, dh);
}

size_t mpreid_mha_bwd_max_smem_bytes() { return kMaxSmem; }

// Floats of fp32 scratch the launch needs for the row statistics.
long long mpreid_mha_bwd_scratch_floats(int B, int L, int H) {
  return 3LL * B * H * L;
}

// qkv and dqkv (B, L, row_stride) and dout (B, L, H * dh) are contiguous
// fp32; mask is null or a contiguous (L, L) fp32 array; stats is fp32
// scratch of mpreid_mha_bwd_scratch_floats(B, L, H) floats. Head h reads q
// at column q_base + h * head_stride, k and v likewise, and writes dq, dk
// and dv at the same columns of dqkv. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mpreid_mha_bwd(const void* qkv, const void* mask, const void* dout, void* dqkv, void* stats,
                   int B, int L, int H, int dh, long long row_stride, int q_base, int k_base,
                   int v_base, int head_stride, float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch<64>(qkv, m, dout, dqkv, stats, B, L, H, row_stride, q_base, k_base, v_base,
                      head_stride, scale, s);
  if (dh == 128)
    return launch<128>(qkv, m, dout, dqkv, stats, B, L, H, row_stride, q_base, k_base, v_base,
                       head_stride, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
