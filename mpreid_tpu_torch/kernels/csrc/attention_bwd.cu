// Fused multi-head self-attention backward for Hopper (sm_90a), fp32
// activations, products on the tensor cores in three TF32 passes
// (mma_tf32.cuh).
//
// Replaces the TPU kernels ops/attention.py::_mha_bwd_kernel (packed
// [q|k|v] columns, launched by _mha_bwd_pallas) and
// ops/attention.py::_mha_bwd_kernel_hm (head-major [q_h|k_h|v_h] columns,
// launched by _mha_bwd_pallas_hm) of the JAX package, for fp32 activations;
// bf16 goes to attention_bwd_tc.cu. As in the forward (attention_fwd.cu),
// one kernel serves both layouts: the caller passes the column offsets of
// q, k and v for head 0 and the column stride from one head to the next;
// dqkv is written in the same packing.
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
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32, three passes a
// product) at the vision shape, B 64, L 129, 12 heads x 64: read qkv (76.1
// MB) and do (25.4 MB), write dqkv (76.1 MB): 177.6 MB, 53.0 us; the five
// products of 2 L^2 dh per (b, h) are 8.2 GFLOP, 49.6 us in three TF32
// passes: bound by bytes. At L 257 the products take 196.8 us: operations.
//
// Design: two launches, each by tiles of 64 rows (4 warps of 16), the
// FlashAttention-2 backward without atomics, as attention_bwd_tc.cu:
//   1. mha_bwd_rows, by query tiles, with the tile's q and dO staged once
//      (split at each use, q times scale) and K, V streamed: one sweep over
//      the keys, online as the forward's softmax. With e = exp(s - m) for
//      the running row max m, it carries l = sum e, sum e dP (dP = dO V^T)
//      and the dh-vectors sum e dP k and sum e k, each rescaled as m grows
//      (4 products: s, dP and the two sums, which share their k fragments).
//      At the end
//        delta = rowsum(dP * p) = (sum e dP) / l
//        dQ    = scale * (sum e dP k - delta * sum e k) / l
//      which is sum_j p (dP - delta) k. m, 1 / l and delta (12 bytes a row)
//      go to a scratch array the wrapper allocates.
//   2. mha_bwd_keys, by key tiles, with the tile's K and V staged once
//      (split at each use, K times scale) and Q, dO and the rows' statistics
//      streamed: S^T = (K * scale) Q^T and dP^T = V dO^T give p and dS^T
//      from the statistics; dV += p^T dO and dK += dS^T Q (4 products); dK *
//      scale and dV are written.
//   A streamed tile (24 rows at dh 64, 16 at dh 128: the most that leaves
//   no register spilled and two blocks on an SM) lands raw (16-byte
//   cp.async, in flight while the warps multiply the previous tile) and is
//   split once a block into (hi, lo) pairs that every warp reads
//   (mma_tf32.cuh). At dh 128 the output sums take two passes of 64 columns
//   over the streamed tiles, each with dh 64's registers. Eight products
//   where five are needed: s and dP are formed in both launches. Every sum
//   is one warp's, in a fixed order, so two launches give the same bits.
//   Rows past L are zero-filled in the staged tiles and get p = 0; no loop
//   inside a tile depends on L, so the products of its 8-row groups
//   interleave. exp is __expf, as in the forward.
// Shared memory per block, whatever L: two staged 64-row tiles, (dh + 4)
// floats a row, and the streamed pair raw and split, (dh + 4) and (2 dh + 8)
// words a row: 73 KB at dh 64, 116 KB at dh 128. No length is refused.

#include <math_constants.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns
constexpr int kWidth = 64;          // columns of the output sums a pass carries
constexpr int kChunk = 4;           // 8-column blocks one mma_steps call takes

// Rows of a streamed tile.
template <int DH>
__host__ __device__ constexpr int tile() { return DH == 64 ? 24 : 16; }

// Row statistics of one (b, h): m, 1 / l and delta, each L rounded up to 4
// floats, so a streamed tile's statistics start 16 bytes aligned.
__host__ __device__ constexpr long long stats_row(int L) { return (L + 3) & ~3; }

// Shared memory of the larger launch, mha_bwd_keys (its statistics on top).
template <int DH>
size_t smem_bytes() {
  return (2 * kRows * stride<DH>() + 2 * tile<DH>() * (stride<DH>() + split_stride<DH>()) +
          2 * 3 * tile<DH>()) *
         sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
mha_bwd_rows(const float* __restrict__ qkv, const float* __restrict__ mask,
             const float* __restrict__ dout, float* __restrict__ dqkv, float* __restrict__ stats,
             int L, int H, long long row_stride, int q_base, int k_base, int v_base,
             int head_stride, float scale) {
  constexpr int S = stride<DH>();
  constexpr int SS = split_stride<DH>();
  constexpr int KS = DH / 8;      // 8-deep steps over the head width
  constexpr int WS = kWidth / 8;  // 8-column blocks of dQ a pass sums
  constexpr int T = tile<DH>();
  constexpr int G = T / 8;  // 8-key groups of a tile

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // q of the block's rows [kRows * S]
  float* o_s = q_s + kRows * S;   // dO of the block's rows
  float* kr_s = o_s + kRows * S;  // raw K tile [T * S]
  float* vr_s = kr_s + T * S;     // raw V tile
  uint32_t* k_s = reinterpret_cast<uint32_t*>(vr_s + T * S);  // split K [T * SS]
  uint32_t* v_s = k_s + T * SS;                                // split V

  const int h = static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long D = static_cast<long long>(H) * DH;
  const float* base = qkv + static_cast<long long>(b) * L * row_stride;
  const float* dbase = dout + static_cast<long long>(b) * L * D + static_cast<long long>(h) * DH;
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;
  const int i0 = static_cast<int>(blockIdx.x) * kRows;
  const int w0 = warp * 16;  // the warp's first row in q_s and o_s
  const bool active = i0 + w0 < L;
  const int ntiles = (L + T - 1) / T;

  stage_rows<kRows, DH>(q_s, base + qcol, row_stride, i0, L, tid, kThreads);
  stage_rows<kRows, DH>(o_s, dbase, D, i0, L, tid, kThreads);
  auto stage = [&](int tile) {
    const float* rows = base + static_cast<long long>(tile) * T * row_stride;
    const int left = L - tile * T;
    stage_rows<T, DH>(kr_s, rows + kcol, row_stride, 0, left, tid, kThreads);
    stage_rows<T, DH>(vr_s, rows + vcol, row_stride, 0, left, tid, kThreads);
  };

#pragma unroll 1
  for (int pass = 0; pass < DH / kWidth; ++pass) {
    const int c0 = pass * kWidth;   // the pass's first column of dQ
    if (pass > 0) __syncthreads();  // every warp is done with the previous pass's tiles
    stage(0);

    float ek[WS][4], edk[WS][4];  // sum e k and sum e dP k, rescaled as m grows
#pragma unroll
    for (int n = 0; n < WS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ek[n][e] = edk[n][e] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running row max
    float l[2] = {0.f, 0.f}, ed[2] = {0.f, 0.f};  // sum e, sum e dP: this lane's columns

    for (int kt = 0; kt < ntiles; ++kt) {
      cp_async_wait_all();
      __syncthreads();  // the tile is in the raw buffers; the split ones are free
      split_rows<T, DH>(k_s, kr_s, tid, kThreads);
      split_rows<T, DH>(v_s, vr_s, tid, kThreads);
      __syncthreads();  // the split tile is whole; the raw buffers are free
      if (kt + 1 < ntiles) stage(kt + 1);
      if (!active) continue;

      // s = (q * scale) k^T and dP = dO v^T: element e of group n is (row
      // i0 + w0 + g + 8 (e / 2), key kt * T + 8 n + 2 t + e % 2)
      float s[G][4], dp[G][4];
#pragma unroll
      for (int n = 0; n < G; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4], bh[G][2], bl[G][2];
        load_a<DH>(ah, al, q_s, w0, 8 * ks, scale, lane);
        load_b_nk<G, DH>(bh, bl, k_s, 0, 8 * ks, lane);
        mma_steps<G>(s, ah, al, bh, bl);
        load_a<DH>(ah, al, o_s, w0, 8 * ks, 1.f, lane);
        load_b_nk<G, DH>(bh, bl, v_s, 0, 8 * ks, lane);
        mma_steps<G>(dp, ah, al, bh, bl);
      }
      if (mask != nullptr || (kt + 1) * T > L) {
#pragma unroll
        for (int n = 0; n < G; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt * T + 8 * n + 2 * t + (e & 1);
            const int row = i0 + w0 + g + 8 * (e >> 1);
            if (key >= L) {
              s[n][e] = -CUDART_INF_F;
            } else if (mask != nullptr && row < L) {
              s[n][e] += mask[static_cast<long long>(row) * L + key];
            }
          }
      }

      // online: rescale the sums to the new max; s becomes e, dp e dP
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < G; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(mx));
        const float ref = mn == -CUDART_INF_F ? 0.f : mn;
        const float alpha = __expf(m[r] - ref);
        m[r] = mn;
        l[r] *= alpha;
        ed[r] *= alpha;
#pragma unroll
        for (int n = 0; n < WS; ++n)
#pragma unroll
          for (int c = 2 * r; c < 2 * r + 2; ++c) {
            ek[n][c] *= alpha;
            edk[n][c] *= alpha;
          }
#pragma unroll
        for (int n = 0; n < G; ++n)
#pragma unroll
          for (int c = 2 * r; c < 2 * r + 2; ++c) {
            s[n][c] = __expf(s[n][c] - ref);
            dp[n][c] *= s[n][c];
            l[r] += s[n][c];
            ed[r] += dp[n][c];
          }
      }

      // sum e k and sum e dP k over the pass's columns, 8 keys a step
#pragma unroll
      for (int kk = 0; kk < G; ++kk) {
        float x[4];
        uint32_t eh[4], el[4], dh[4], dl[4];
        c_to_a(x, s[kk]);
        split(x, eh, el);
        c_to_a(x, dp[kk]);
        split(x, dh, dl);
#pragma unroll
        for (int n0 = 0; n0 < WS; n0 += kChunk) {
          uint32_t bh[kChunk][2], bl[kChunk][2];
          load_b_kn<kChunk, DH>(bh, bl, k_s, 8 * kk, c0 + 8 * n0, lane);
          mma_steps<kChunk>(ek + n0, eh, el, bh, bl);
          mma_steps<kChunk>(edk + n0, dh, dl, bh, bl);
        }
      }
    }

    if (!active) continue;
    float* st = stats + (static_cast<long long>(b) * H + h) * 3 * stats_row(L);
    float* gbase = dqkv + static_cast<long long>(b) * L * row_stride + qcol + c0 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv_l = 1.f / quad_sum(l[r]);
      const float delta = quad_sum(ed[r]) * inv_l;
      const int row = i0 + w0 + g + 8 * r;
      if (row >= L) continue;
      if (t == 0 && pass == 0) {
        st[row] = m[r] == -CUDART_INF_F ? 0.f : m[r];
        st[stats_row(L) + row] = inv_l;
        st[2 * stats_row(L) + row] = delta;
      }
      const float mul = inv_l * scale;
      float* dst = gbase + static_cast<long long>(row) * row_stride;
#pragma unroll
      for (int n = 0; n < WS; ++n)
        store2(dst + 8 * n, fmaf(-delta, ek[n][2 * r], edk[n][2 * r]) * mul,
               fmaf(-delta, ek[n][2 * r + 1], edk[n][2 * r + 1]) * mul);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
mha_bwd_keys(const float* __restrict__ qkv, const float* __restrict__ mask,
             const float* __restrict__ dout, float* __restrict__ dqkv,
             const float* __restrict__ stats, int L, int H, long long row_stride, int q_base,
             int k_base, int v_base, int head_stride, float scale) {
  constexpr int S = stride<DH>();
  constexpr int SS = split_stride<DH>();
  constexpr int KS = DH / 8;      // 8-deep steps over the head width
  constexpr int WS = kWidth / 8;  // 8-column blocks of dK and dV a pass sums
  constexpr int T = tile<DH>();
  constexpr int G = T / 8;  // 8-query groups of a tile

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;              // k of the block's keys [kRows * S]
  float* v_s = k_s + kRows * S;   // v of the block's keys
  float* qr_s = v_s + kRows * S;  // raw Q tile [T * S]
  float* or_s = qr_s + T * S;     // raw dO tile
  uint32_t* q_s = reinterpret_cast<uint32_t*>(or_s + T * S);  // split Q [T * SS]
  uint32_t* o_s = q_s + T * SS;                                // split dO
  float* st_s = reinterpret_cast<float*>(o_s + T * SS);        // [2][3 * T] m, 1 / l, delta

  const int h = static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long D = static_cast<long long>(H) * DH;
  const float* base = qkv + static_cast<long long>(b) * L * row_stride;
  const float* dbase = dout + static_cast<long long>(b) * L * D + static_cast<long long>(h) * DH;
  const float* st = stats + (static_cast<long long>(b) * H + h) * 3 * stats_row(L);
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;
  const int j0 = static_cast<int>(blockIdx.x) * kRows;
  const int w0 = warp * 16;  // the warp's first key in k_s and v_s
  const bool active = j0 + w0 < L;
  const int ntiles = (L + T - 1) / T;

  stage_rows<kRows, DH>(k_s, base + kcol, row_stride, j0, L, tid, kThreads);
  stage_rows<kRows, DH>(v_s, base + vcol, row_stride, j0, L, tid, kThreads);
  auto stage = [&](int tile) {
    const int r0 = tile * T;
    stage_rows<T, DH>(qr_s, base + qcol, row_stride, r0, L, tid, kThreads);
    stage_rows<T, DH>(or_s, dbase, D, r0, L, tid, kThreads);
    // the statistics in 16-byte chunks, double-buffered: the warps still read
    // the previous tile's; chunks past L stay unread
    float* dst = st_s + (tile & 1) * 3 * T;
    for (int idx = tid; idx < 3 * T / 4; idx += kThreads) {
      const int part = idx / (T / 4);
      const int c = (idx - part * (T / 4)) * 4;
      if (r0 + c < L) cp_async_16(dst + part * T + c, st + part * stats_row(L) + r0 + c);
    }
  };

#pragma unroll 1
  for (int pass = 0; pass < DH / kWidth; ++pass) {
    const int c0 = pass * kWidth;   // the pass's first column of dK and dV
    if (pass > 0) __syncthreads();  // every warp is done with the previous pass's tiles
    stage(0);

    float dk[WS][4], dv[WS][4];
#pragma unroll
    for (int n = 0; n < WS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    for (int qt = 0; qt < ntiles; ++qt) {
      cp_async_wait_all();
      __syncthreads();  // the tile is in the raw buffers; the split ones are free
      split_rows<T, DH>(q_s, qr_s, tid, kThreads);
      split_rows<T, DH>(o_s, or_s, tid, kThreads);
      __syncthreads();  // the split tile is whole; the raw buffers are free
      if (qt + 1 < ntiles) stage(qt + 1);
      if (!active) continue;
      const float* sb = st_s + (qt & 1) * 3 * T;

      // S^T and dP^T: element e of group n is (key j0 + w0 + g + 8 (e / 2),
      // query qt * T + 8 n + 2 t + e % 2)
      float s[G][4], dp[G][4];
#pragma unroll
      for (int n = 0; n < G; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4], bh[G][2], bl[G][2];
        load_a<DH>(ah, al, k_s, w0, 8 * ks, scale, lane);
        load_b_nk<G, DH>(bh, bl, q_s, 0, 8 * ks, lane);
        mma_steps<G>(s, ah, al, bh, bl);
        load_a<DH>(ah, al, v_s, w0, 8 * ks, 1.f, lane);
        load_b_nk<G, DH>(bh, bl, o_s, 0, 8 * ks, lane);
        mma_steps<G>(dp, ah, al, bh, bl);
      }
      const bool inside = j0 + w0 + 16 <= L && (qt + 1) * T <= L;  // warp-uniform
#pragma unroll
      for (int n = 0; n < G; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + w0 + g + 8 * (e >> 1);
          const int c = 8 * n + 2 * t + (e & 1);
          const int query = qt * T + c;
          float p = 0.f, ds = 0.f;
          if (inside || (key < L && query < L)) {
            float x = s[n][e];
            if (mask != nullptr) x += mask[static_cast<long long>(query) * L + key];
            p = __expf(x - sb[c]) * sb[T + c];
            ds = p * (dp[n][e] - sb[2 * T + c]);
          }
          s[n][e] = p;
          dp[n][e] = ds;
        }

      // dV += p^T dO and dK += dS^T Q over the pass's columns, 8 queries a step
#pragma unroll
      for (int kk = 0; kk < G; ++kk) {
        float x[4];
        uint32_t ph[4], pl[4], dh[4], dl[4];
        c_to_a(x, s[kk]);
        split(x, ph, pl);
        c_to_a(x, dp[kk]);
        split(x, dh, dl);
#pragma unroll
        for (int n0 = 0; n0 < WS; n0 += kChunk) {
          uint32_t bh[kChunk][2], bl[kChunk][2];
          load_b_kn<kChunk, DH>(bh, bl, o_s, 8 * kk, c0 + 8 * n0, lane);
          mma_steps<kChunk>(dv + n0, ph, pl, bh, bl);
          load_b_kn<kChunk, DH>(bh, bl, q_s, 8 * kk, c0 + 8 * n0, lane);
          mma_steps<kChunk>(dk + n0, dh, dl, bh, bl);
        }
      }
    }

    if (!active) continue;
    float* gbase = dqkv + static_cast<long long>(b) * L * row_stride + c0 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = j0 + w0 + g + 8 * r;
      if (key >= L) continue;
      float* dst = gbase + static_cast<long long>(key) * row_stride;
#pragma unroll
      for (int n = 0; n < WS; ++n) {
        store2(dst + kcol + 8 * n, dk[n][2 * r] * scale, dk[n][2 * r + 1] * scale);
        store2(dst + vcol + 8 * n, dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

template <int DH>
int launch(const void* qkv, const float* mask, const void* dout, void* dqkv, void* stats, int B,
           int L, int H, long long row_stride, int q_base, int k_base, int v_base,
           int head_stride, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  static const cudaError_t opt_in[2] = {
      cudaFuncSetAttribute(mha_bwd_rows<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)),
      cudaFuncSetAttribute(mha_bwd_keys<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem))};
  for (const cudaError_t e : opt_in)
    if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  const float* x = static_cast<const float*>(qkv);
  const float* d = static_cast<const float*>(dout);
  float* dx = static_cast<float*>(dqkv);
  float* st = static_cast<float*>(stats);
  mha_bwd_rows<DH><<<grid, kThreads, smem, stream>>>(x, mask, d, dx, st, L, H, row_stride,
                                                    q_base, k_base, v_base, head_stride, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mha_bwd_keys<DH><<<grid, kThreads, smem, stream>>>(x, mask, d, dx, st, L, H, row_stride,
                                                    q_base, k_base, v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of either launch needs, in bytes, whatever L (0
// for an unsupported head width).
size_t mpreid_mha_bwd_smem_bytes(int L, int dh) {
  (void)L;
  if (dh == 64) return smem_bytes<64>();
  if (dh == 128) return smem_bytes<128>();
  return 0;
}

size_t mpreid_mha_bwd_max_smem_bytes() { return kMaxSmem; }

// Floats of fp32 scratch the launch needs for the row statistics.
long long mpreid_mha_bwd_scratch_floats(int B, int L, int H) {
  return 3LL * B * H * stats_row(L);
}

// qkv and dqkv (B, L, row_stride) and dout (B, L, H * dh) are contiguous
// fp32, 16-byte aligned, with row_stride and the column offsets multiples of
// 4; mask is null or a contiguous (L, L) fp32 array; stats is 16-byte
// aligned fp32 scratch of mpreid_mha_bwd_scratch_floats(B, L, H) floats.
// Head h reads q at column q_base + h * head_stride, k and v likewise, and
// writes dq, dk and dv at the same columns of dqkv. Launches both kernels on
// `stream` and returns cudaGetLastError() (0 on success).
int mpreid_mha_bwd(const void* qkv, const void* mask, const void* dout, void* dqkv, void* stats,
                   int B, int L, int H, int dh, long long row_stride, int q_base, int k_base,
                   int v_base, int head_stride, float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0) return 0;
  if (dh == 64)
    return launch<64>(qkv, m, dout, dqkv, stats, B, L, H, row_stride, q_base, k_base, v_base,
                      head_stride, scale, s);
  if (dh == 128)
    return launch<128>(qkv, m, dout, dqkv, stats, B, L, H, row_stride, q_base, k_base, v_base,
                       head_stride, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
