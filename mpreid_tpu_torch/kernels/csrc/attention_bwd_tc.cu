// Fused multi-head self-attention backward on Hopper's tensor cores
// (sm_90a), bf16 activations.
//
// Replaces the TPU kernels ops/attention.py::_mha_bwd_kernel (packed
// [q|k|v] columns, launched by _mha_bwd_pallas) and
// ops/attention.py::_mha_bwd_kernel_hm (head-major [q_h|k_h|v_h] columns,
// launched by _mha_bwd_pallas_hm) of the JAX package, for bf16; fp32 keeps
// the CUDA-core kernel of attention_bwd.cu. As in the forward
// (attention_fwd_tc.cu), one kernel serves both layouts and dqkv is written
// in the input's packing.
//
// Math, per (batch b, head h), as in the JAX package. Nothing of the
// forward is saved: the probabilities are recomputed from qkv.
//   p   = softmax(round(q * round(scale)) k^T + mask)   fp32, unrounded
//   dv  = round(p)^T do                     fp32 sums
//   dp  = do v^T                            fp32 sums
//   ds  = p * (dp - rowsum(dp * p))         fp32, with the unrounded p
//   dq  = round(ds) k * scale               fp32 sums, unscaled k
//   dk  = round(ds)^T q * scale             fp32 sums, unscaled q
// Every output is written in bf16. The mask gets no gradient.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the main
// path's shape, B 64, L 129, 12 heads x 64: read qkv (38.0 MB) and do (12.7
// MB), write dqkv (38.0 MB): 88.8 MB, 26.5 us. This kernel does about ten
// L x L x dh products (below), 16.4 GFLOP, 16.6 us at the tensor-core peak:
// still bound by bytes. Design (the FlashAttention-2 backward, with the
// forward's row statistics recomputed because nothing is saved):
//   grid (H, B), one block per head, no atomics, every sum in a fixed order
//   (two launches give the same bits). The block stages the head's Q, K, V
//   and dO in shared memory once (16-byte cp.async; rows L..L16 zero-filled,
//   so padded query rows give dP = 0 and dS = 0 and add nothing to dK, dV).
//   Shared memory grows as O(L): nothing L x L is held anywhere.
//   Phase 1, warps by 16-row query blocks, three sweeps over 16-key blocks:
//     (1) the row max m and sum l of s (1 product);
//     (2) delta = rowsum(dP * p) with the unrounded fp32 p and dP = dO V^T,
//         exactly as the plain version computes it (2 products);
//     (3) dS = p * (dP - delta) rounded to bf16, dQ += dS K (3 products);
//   then dQ * scale is written, and m, 1 / l and delta go to shared memory.
//   Phase 2, after a barrier, warps by 16-row key blocks, sweeping the query
//   rows 16 at a time: S^T = K Qs^T and p from m and 1 / l, dP^T = V dO^T,
//   dS^T, dV += round(p)^T dO, dK += round(dS)^T Q (4 products); then dK *
//   scale and dV are written.
//   Products run on mma.sync.m16n8k16 (bf16 -> fp32) with ldmatrix; P and
//   dS pass from one product to the next in registers. At dh 64 a warp keeps
//   its K and V blocks as A fragments through phase 2; at dh 128 it reloads
//   them, which keeps dK and dV (128 fp32 a thread) in registers.
// Shared memory per block: Q, K, V, dO, 4 * L16 * (dh + 8) bf16 (L16 = L
// rounded up to 16), and m, 1 / l, delta, 3 * L16 fp32: 85 KB at L 129 and
// 160 KB at L 257 (dh 64), 158 KB at L 129 (dh 128). The host side refuses
// a length that does not fit in 227 KB: above L 384 at dh 64, above L 208 at
// dh 128.

#include <math_constants.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int kMaxWarps = 9;  // 16-row blocks in flight per block: L 129 in one round

template <int DH>
size_t smem_bytes(int L) {
  const size_t l16 = static_cast<size_t>(round16(L));
  return 4 * l16 * tile_stride<DH>() * sizeof(bf16) + 3 * l16 * sizeof(float);
}

// c[n] = A X^T over rows kb * 16 + 8 n + (0..7) of the staged tile x_s
// (A holds the warp's 16 rows as fragments, one per k16 step).
template <int DH>
__device__ __forceinline__ void rows_dot(float c[2][4], const uint32_t (&a)[DH / 16][4],
                                         const bf16* x_s, int kb, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t b[4];
    ldmatrix_x4(b, bt_ptr(x_s, tile_stride<DH>(), kb * 16, ks * 16, lane));
    mma(c[0], a[ks], b[0], b[1]);
    mma(c[1], a[ks], b[2], b[3]);
  }
}

// The warp's 16 rows r0.. of a staged tile as A fragments.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const bf16* x_s, int r0,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldmatrix_x4(a[ks], a_ptr(x_s, tile_stride<DH>(), r0, ks * 16, lane));
}

// Each value times `sc`, rounded to bf16 (q * scale as the plain version).
template <int DH>
__device__ __forceinline__ void scale_a(uint32_t (&a)[DH / 16][4], float sc) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[ks][r] = scale_pair(a[ks][r], sc);
}

// acc[n] += A X over the dh columns of rows i0..i0+15 of the staged tile x_s
// (A is 16 x 16 over those rows; the tile is read k x n with .trans).
template <int DH>
__device__ __forceinline__ void acc_rows(float acc[DH / 8][4], const uint32_t a[4],
                                         const bf16* x_s, int i0, int lane) {
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, a_ptr(x_s, tile_stride<DH>(), i0, dp * 16, lane));
    mma(acc[2 * dp], a, b[0], b[1]);
    mma(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// Writes the warp's 16 rows r0.. of acc * mul at column `col` of dqkv.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* gbase, long long row_stride, int col, int r0,
                                           int L, const float acc[DH / 8][4], float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= L) continue;
    bf16* dst = gbase + static_cast<long long>(row) * row_stride + col + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
  }
}

template <int DH>
__global__ void __launch_bounds__(kMaxWarps * 32)
mha_bwd_tc_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                  const bf16* __restrict__ dout, bf16* __restrict__ dqkv, int L, int H,
                  long long row_stride, int q_base, int k_base, int v_base, int head_stride,
                  float scale) {
  constexpr int S = tile_stride<DH>();
  constexpr int KS = DH / 16;
  constexpr int CPR = DH / 8;  // 16-byte chunks per staged row
  constexpr bool kKeepKV = DH == 64;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L16 = round16(L);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + L16 * S;
  bf16* v_s = k_s + L16 * S;
  bf16* o_s = v_s + L16 * S;  // dO
  float* m_s = reinterpret_cast<float*>(o_s + L16 * S);  // row max (0 where all -inf)
  float* il_s = m_s + L16;                               // 1 / row sum
  float* d_s = il_s + L16;                               // delta

  const int h = static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y);
  const long long D = static_cast<long long>(H) * DH;
  const bf16* base = qkv + static_cast<long long>(b) * L * row_stride;
  const bf16* dbase = dout + static_cast<long long>(b) * L * D + static_cast<long long>(h) * DH;
  bf16* gbase = dqkv + static_cast<long long>(b) * L * row_stride;
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;

  for (int idx = static_cast<int>(threadIdx.x); idx < L16 * CPR;
       idx += static_cast<int>(blockDim.x)) {
    const int j = idx / CPR;
    const int c = (idx - j * CPR) * 8;
    const int off = j * S + c;
    if (j < L) {
      const bf16* row = base + static_cast<long long>(j) * row_stride;
      cp_async_16(q_s + off, row + qcol + c);
      cp_async_16(k_s + off, row + kcol + c);
      cp_async_16(v_s + off, row + vcol + c);
      cp_async_16(o_s + off, dbase + static_cast<long long>(j) * D + c);
    } else {
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(q_s + off) = z;
      *reinterpret_cast<uint4*>(k_s + off) = z;
      *reinterpret_cast<uint4*>(v_s + off) = z;
      *reinterpret_cast<uint4*>(o_s + off) = z;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nrb = L16 / 16;
  const int nwarps = static_cast<int>(blockDim.x) >> 5;
  const float sc = __bfloat162float(__float2bfloat16(scale));

  // s of one 16 x 16 block, padded and masked; element c of tile n is
  // (query qrow(c), key key(n, c)) in phase 1.
  auto mask_scores = [&](float s[2][4], int r0, int kb) {
    if (mask == nullptr && kb * 16 + 16 <= L) return;  // no mask, no padded key
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + g + 8 * (c >> 1);
        const int key = kb * 16 + 8 * n + 2 * t + (c & 1);
        if (key >= L) {
          s[n][c] = -CUDART_INF_F;
        } else if (mask != nullptr && row < L) {
          s[n][c] += mask[static_cast<long long>(row) * L + key];
        }
      }
  };

  // ---- phase 1: query blocks -> m, 1 / l, delta, dQ ----
  for (int rb = warp; rb < nrb; rb += nwarps) {
    const int r0 = rb * 16;
    uint32_t qf[KS][4], of[KS][4];
    load_a<DH>(qf, q_s, r0, lane);
    scale_a<DH>(qf, sc);
    load_a<DH>(of, o_s, r0, lane);

    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};
    for (int kb = 0; kb < nrb; ++kb) {
      float s[2][4];
      rows_dot<DH>(s, qf, k_s, kb, lane);
      mask_scores(s, r0, kb);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float cm = quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                        fmaxf(s[1][2 * r], s[1][2 * r + 1])));
        const float mn = fmaxf(m[r], cm);
        const float ref = mn == -CUDART_INF_F ? 0.f : mn;
        l[r] = l[r] * __expf(m[r] - ref) + __expf(s[0][2 * r] - ref) +
               __expf(s[0][2 * r + 1] - ref) + __expf(s[1][2 * r] - ref) +
               __expf(s[1][2 * r + 1] - ref);
        m[r] = mn;
      }
    }
    float ref[2], inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ref[r] = m[r] == -CUDART_INF_F ? 0.f : m[r];
      inv_l[r] = 1.f / quad_sum(l[r]);
    }

    // p and dP of one block, p in s and dP in dp
    auto probs_and_dp = [&](float s[2][4], float dp[2][4], int kb) {
      rows_dot<DH>(s, qf, k_s, kb, lane);
      mask_scores(s, r0, kb);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = __expf(s[n][c] - ref[c >> 1]) * inv_l[c >> 1];
      rows_dot<DH>(dp, of, v_s, kb, lane);
    };

    float delta[2] = {0.f, 0.f};
    for (int kb = 0; kb < nrb; ++kb) {
      float s[2][4], dp[2][4];
      probs_and_dp(s, dp, kb);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) delta[c >> 1] += dp[n][c] * s[n][c];
    }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);

    float dq[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dq[n][c] = 0.f;
    for (int kb = 0; kb < nrb; ++kb) {
      float s[2][4], dp[2][4];
      probs_and_dp(s, dp, kb);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] *= dp[n][c] - delta[c >> 1];
      uint32_t da[4];
      c_to_a(da, s[0], s[1]);
      acc_rows<DH>(dq, da, k_s, kb * 16, lane);
    }
    store_rows<DH>(gbase, row_stride, qcol, r0, L, dq, scale, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_s[r0 + g + 8 * r] = ref[r];
        il_s[r0 + g + 8 * r] = inv_l[r];
        d_s[r0 + g + 8 * r] = delta[r];
      }
    }
  }
  __syncthreads();

  // ---- phase 2: key blocks -> dK, dV ----
  // Element c of tile n is (key j0 + g + 8 (c / 2), query i0 + 8 n + 2 t + c % 2).
  for (int kb = warp; kb < nrb; kb += nwarps) {
    const int j0 = kb * 16;
    uint32_t kf[kKeepKV ? KS : 1][4], vf[kKeepKV ? KS : 1][4];
    if constexpr (kKeepKV) {
      load_a<DH>(kf, k_s, j0, lane);
      load_a<DH>(vf, v_s, j0, lane);
    }
    float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

    for (int qb = 0; qb < nrb; ++qb) {
      const int i0 = qb * 16;
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4], bq[4], bo[4];
        if constexpr (kKeepKV) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ka[r] = kf[ks][r];
            va[r] = vf[ks][r];
          }
        } else {
          ldmatrix_x4(ka, a_ptr(k_s, S, j0, ks * 16, lane));
          ldmatrix_x4(va, a_ptr(v_s, S, j0, ks * 16, lane));
        }
        ldmatrix_x4(bq, bt_ptr(q_s, S, i0, ks * 16, lane));
#pragma unroll
        for (int r = 0; r < 4; ++r) bq[r] = scale_pair(bq[r], sc);
        mma(st[0], ka, bq[0], bq[1]);
        mma(st[1], ka, bq[2], bq[3]);
        ldmatrix_x4(bo, bt_ptr(o_s, S, i0, ks * 16, lane));
        mma(dpt[0], va, bo[0], bo[1]);
        mma(dpt[1], va, bo[2], bo[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = j0 + g + 8 * (c >> 1);
          const int query = i0 + 8 * n + 2 * t + (c & 1);
          float p = 0.f;
          if (key < L && query < L) {
            float s = st[n][c];
            if (mask != nullptr) s += mask[static_cast<long long>(query) * L + key];
            p = __expf(s - m_s[query]) * il_s[query];
          }
          st[n][c] = p;
          dpt[n][c] = p * (dpt[n][c] - d_s[query]);
        }
      uint32_t pa[4], da[4];
      c_to_a(pa, st[0], st[1]);
      c_to_a(da, dpt[0], dpt[1]);
      acc_rows<DH>(dv, pa, o_s, i0, lane);
      acc_rows<DH>(dk, da, q_s, i0, lane);
    }
    store_rows<DH>(gbase, row_stride, kcol, j0, L, dk, scale, lane);
    store_rows<DH>(gbase, row_stride, vcol, j0, L, dv, 1.f, lane);
  }
}

template <int DH>
int launch(const void* qkv, const float* mask, const void* dout, void* dqkv, int B, int L,
           int H, long long row_stride, int q_base, int k_base, int v_base, int head_stride,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(L);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      mha_bwd_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int warps = warps_for(round16(L) / 16, kMaxWarps);
  const dim3 grid(H, B);
  mha_bwd_tc_kernel<DH><<<grid, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), mask, static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), L, H, row_stride, q_base, k_base, v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 for an unsupported head width).
size_t mpreid_mha_bwd_tc_smem_bytes(int L, int dh) {
  if (dh == 64) return smem_bytes<64>(L);
  if (dh == 128) return smem_bytes<128>(L);
  return 0;
}

size_t mpreid_mha_bwd_tc_max_smem_bytes() { return kMaxSmem; }

// qkv and dqkv (B, L, row_stride) and dout (B, L, H * dh) are contiguous
// bf16, 16-byte aligned, with row_stride and the column offsets multiples of
// 8; mask is null or a contiguous (L, L) fp32 array. Head h reads q at
// column q_base + h * head_stride, k and v likewise, and writes dq, dk and dv
// at the same columns of dqkv. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mpreid_mha_bwd_tc(const void* qkv, const void* mask, const void* dout, void* dqkv, int B,
                      int L, int H, int dh, long long row_stride, int q_base, int k_base,
                      int v_base, int head_stride, float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0) return 0;
  if (dh == 64)
    return launch<64>(qkv, m, dout, dqkv, B, L, H, row_stride, q_base, k_base, v_base,
                      head_stride, scale, s);
  if (dh == 128)
    return launch<128>(qkv, m, dout, dqkv, B, L, H, row_stride, q_base, k_base, v_base,
                       head_stride, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
