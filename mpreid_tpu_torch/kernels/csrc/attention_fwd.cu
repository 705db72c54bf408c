// Fused multi-head self-attention forward for Hopper (sm_90a), fp32
// activations, products on the tensor cores in three TF32 passes
// (mma_tf32.cuh).
//
// Replaces the TPU kernels ops/attention.py::_mha_fwd_kernel (packed
// [q|k|v] columns, launched by _mha_fwd_pallas) and
// ops/attention.py::_mha_fwd_kernel_hm (head-major [q_h|k_h|v_h] columns,
// launched by _mha_fwd_pallas_hm) of the JAX package, for fp32 activations;
// bf16 goes to attention_fwd_tc.cu. One kernel serves both layouts: the
// caller passes the column offsets of q, k and v for head 0 and the column
// stride from one head to the next.
//
// Math, per (batch b, head h), as in the JAX package, all in fp32:
//   s   = (q * scale) k^T
//   s  += mask                 optional additive (L, L) fp32 mask; -inf is
//                              allowed as long as no row is fully masked
//   p   = softmax(s)
//   out = p v
// The split products keep about 22 significant bits of each operand, so the
// result stays within the fp32 route's 1e-5 of the plain version; softmax,
// mask and scaling run in fp32 on the CUDA cores.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32, three passes a product)
// at the vision shape, B 64, L 129, 12 heads x 64: read qkv once (76.1 MB)
// and write out once (25.4 MB), 30.3 us, against 3.3 GFLOP of products, 19.8
// us in three TF32 passes: bound by bytes. At L 257 the products take 78.7
// us: bound by operations.
//
// Design (flash-style, nothing L x L anywhere):
//   grid (ceil(L / 64), H, B), 4 warps a block; each warp owns 16 query
//   rows. At dh 64 the warp keeps their q * scale split in registers; at dh
//   128 q is staged in shared memory and split at each use, which leaves
//   registers for the 16 x 128 output.
//   K and V stream through shared memory in 32-key tiles: 16-byte cp.async
//   copies into a raw tile fly while the warps multiply the previous tile;
//   then the block splits the raw tile once into hi and lo (split_rows), and
//   every warp reads 8-byte (hi, lo) pairs. Keys past L are zero-filled and
//   their scores set to -inf. No loop inside a tile depends on L, so the
//   unrolled products of its 8-key groups interleave on the tensor cores.
//   Online softmax in fp32: the row max grows tile by tile, the running sum
//   and the output are rescaled as it does, and the output is divided by the
//   sum once at the end. p stays in registers from q k^T to p v (c_to_a). exp is __expf
//   (ex2.approx): with the argument's rounding its error stays near 1e-7 of
//   p, far inside the route's 1e-5.
// Shared memory per block, whatever L: the raw K and V tiles, (dh + 4)
// floats a row, and their split, (2 dh + 8) words a row: 51 KB at dh 64,
// 132 KB at dh 128 with q's 64 rows. No length is refused.

#include <math_constants.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows a block
constexpr int kTile = 32;           // keys a tile
constexpr int kGroups = kTile / 8;  // 8-key groups of a tile
constexpr int kChunk = 8;           // 8-column blocks of dh one mma_steps call takes

template <int DH>
size_t smem_bytes() {
  const size_t q = DH == 64 ? 0 : kRows * stride<DH>();
  return (q + 2 * kTile * (stride<DH>() + split_stride<DH>())) * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
               float* __restrict__ out, int L, int H, long long row_stride, int q_base,
               int k_base, int v_base, int head_stride, float scale) {
  constexpr int S = stride<DH>();
  constexpr int SS = split_stride<DH>();
  constexpr int KS = DH / 8;  // 8-deep steps over the head width
  constexpr bool kQInRegs = DH == 64;

  extern __shared__ __align__(16) float smem[];
  float* kr_s = smem;                 // raw K tile [kTile * S]
  float* vr_s = kr_s + kTile * S;     // raw V tile
  uint32_t* k_s = reinterpret_cast<uint32_t*>(vr_s + kTile * S);  // split K [kTile * SS]
  uint32_t* v_s = k_s + kTile * SS;                                // split V
  float* q_s = reinterpret_cast<float*>(v_s + kTile * SS);  // raw q [kRows * S], dh 128

  const int h = static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float* base = qkv + static_cast<long long>(b) * L * row_stride;
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;
  const int i0 = static_cast<int>(blockIdx.x) * kRows;
  const int r0 = i0 + warp * 16;
  const bool active = r0 < L;  // warp-uniform: a warp past L only stages tiles

  auto stage = [&](int tile) {
    const float* rows = base + static_cast<long long>(tile) * kTile * row_stride;
    const int left = L - tile * kTile;
    stage_rows<kTile, DH>(kr_s, rows + kcol, row_stride, 0, left, tid, kThreads);
    stage_rows<kTile, DH>(vr_s, rows + vcol, row_stride, 0, left, tid, kThreads);
  };
  if constexpr (!kQInRegs)
    stage_rows<kRows, DH>(q_s, base + qcol, row_stride, i0, L, tid, kThreads);
  stage(0);

  // at dh 64, q * scale of the warp's rows as split A fragments (zero past L)
  uint32_t qh[kQInRegs ? KS : 1][4], ql[kQInRegs ? KS : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e & 1);
        a[e] = row < L ? base[static_cast<long long>(row) * row_stride + qcol + 8 * ks + t +
                              4 * (e >> 1)] * scale
                       : 0.f;
      }
      split(a, qh[ks], ql[ks]);
    }
  }

  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running row max
  float l[2] = {0.f, 0.f};                      // running row sum, this lane's columns

  const int ntiles = (L + kTile - 1) / kTile;
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is in the raw buffers; the split ones are free
    split_rows<kTile, DH>(k_s, kr_s, tid, kThreads);
    split_rows<kTile, DH>(v_s, vr_s, tid, kThreads);
    __syncthreads();  // the split tile is whole; the raw buffers are free
    if (kt + 1 < ntiles) stage(kt + 1);
    if (!active) continue;

    float s[kGroups][4];
#pragma unroll
    for (int n = 0; n < kGroups; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4], bh[kGroups][2], bl[kGroups][2];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qh[ks][e];
          al[e] = ql[ks][e];
        }
      } else {
        load_a<DH>(ah, al, q_s, warp * 16, 8 * ks, scale, lane);
      }
      load_b_nk<kGroups, DH>(bh, bl, k_s, 0, 8 * ks, lane);
      mma_steps<kGroups>(s, ah, al, bh, bl);
    }

    // mask and padding: element e of group n is (row r0 + g + 8 (e / 2),
    // key kt * kTile + 8 n + 2 t + e % 2)
    if (mask != nullptr || (kt + 1) * kTile > L) {
#pragma unroll
      for (int n = 0; n < kGroups; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt * kTile + 8 * n + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          if (key >= L) {
            s[n][e] = -CUDART_INF_F;
          } else if (mask != nullptr && row < L) {
            s[n][e] += mask[static_cast<long long>(row) * L + key];
          }
        }
    }

    // online softmax: rescale to the new max; s becomes exp(s - max)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < kGroups; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float mn = fmaxf(m[r], quad_max(mx));
      const float ref = mn == -CUDART_INF_F ? 0.f : mn;
      const float alpha = __expf(m[r] - ref);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < kGroups; ++n)
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c) {
          s[n][c] = __expf(s[n][c] - ref);
          l[r] += s[n][c];
        }
    }

    // o += p v, 8 keys a step
#pragma unroll
    for (int kk = 0; kk < kGroups; ++kk) {
      float pa[4];
      uint32_t ph[4], pl[4];
      c_to_a(pa, s[kk]);
      split(pa, ph, pl);
#pragma unroll
      for (int n0 = 0; n0 < KS; n0 += kChunk) {
        uint32_t bh[kChunk][2], bl[kChunk][2];
        load_b_kn<kChunk, DH>(bh, bl, v_s, 8 * kk, 8 * n0, lane);
        mma_steps<kChunk>(o + n0, ph, pl, bh, bl);
      }
    }
  }

  if (!active) return;
  float* obase = out + static_cast<long long>(b) * L * H * DH + static_cast<long long>(h) * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / quad_sum(l[r]);
    const int row = r0 + g + 8 * r;
    if (row >= L) continue;
    float* dst = obase + static_cast<long long>(row) * H * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n) store2(dst + 8 * n, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int DH>
int launch(const void* qkv, const float* mask, void* out, int B, int L, int H,
           long long row_stride, int q_base, int k_base, int v_base, int head_stride,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      mha_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  mha_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<float*>(out), L, H, row_stride, q_base,
      k_base, v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes, whatever L (0 for an unsupported
// head width).
size_t mpreid_mha_fwd_smem_bytes(int L, int dh) {
  (void)L;
  if (dh == 64) return smem_bytes<64>();
  if (dh == 128) return smem_bytes<128>();
  return 0;
}

size_t mpreid_mha_fwd_max_smem_bytes() { return kMaxSmem; }

// qkv (B, L, row_stride) and out (B, L, H * dh) are contiguous fp32, 16-byte
// aligned, with row_stride and the column offsets multiples of 4; mask is
// null or a contiguous (L, L) fp32 array. Head h reads q at column q_base +
// h * head_stride, k and v likewise. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mpreid_mha_fwd(const void* qkv, const void* mask, void* out, int B, int L, int H, int dh,
                   long long row_stride, int q_base, int k_base, int v_base, int head_stride,
                   float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0) return 0;
  if (dh == 64)
    return launch<64>(qkv, m, out, B, L, H, row_stride, q_base, k_base, v_base, head_stride,
                      scale, s);
  if (dh == 128)
    return launch<128>(qkv, m, out, B, L, H, row_stride, q_base, k_base, v_base, head_stride,
                       scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
