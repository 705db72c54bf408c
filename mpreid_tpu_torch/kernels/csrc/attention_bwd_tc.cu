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
//   (two launches give the same bits). While the sequence fits (L16 <=
//   whole_rows<dh>(): 384 at dh 64, 208 at dh 128; L16 = L rounded up to
//   16), the block stages the head's Q, K, V and dO in shared memory once
//   (16-byte cp.async; rows L..L16 zero-filled, so padded query rows give
//   dP = 0 and dS = 0 and add nothing to dK, dV). Nothing L x L is held.
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
// Shared memory per block: Q, K, V, dO, 4 * L16 * (dh + 8) bf16, and m, 1 / l,
// delta, 3 * L16 fp32: 85 KB at L 129 and 160 KB at L 257 (dh 64), 158 KB at
// L 129 (dh 128).
// A longer sequence runs the kernel's chunked instance, whose shared memory
// is the same at every L (223 KB at dh 64, 224 KB at dh 128), so no length
// is refused. Each round of the warps' blocks stages its own 16-row blocks
// (phase 1: their Q and dO rows; phase 2: their K and V rows) in two tiles
// of kMaxWarps * 16 rows, and streams the other side in chunks of
// chunk_rows<dh>() rows (624 at dh 64, 272 at dh 128) through two more
// tiles: phase 1 K and V, each of its three sweeps going over the chunks in
// turn; phase 2 Q, dO and the rows' m, 1 / l and delta. Those statistics go
// from phase 1 to phase 2 through a device scratch of 3 * L16 fp32 per
// (b, h) that the caller gives (mpreid_mha_bwd_tc_scratch_floats), not
// through shared memory, so nothing in shared memory grows with L. The
// 16-key (16-query) blocks go by in the same order as in one chunk, each
// running value (m and l, delta, dQ, dK and dV, all in registers) carried
// from chunk to chunk, so two launches still give the same bits. A sequence
// of one chunk is staged once for every round; a longer one once per sweep
// and round, through a barrier at each chunk.

#include <math_constants.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int kMaxWarps = 9;  // 16-row blocks in flight per block: L 129 in one round
constexpr int kOwnRows = kMaxWarps * 16;  // rows of a round's own blocks (chunked instance)

// The longest L16 whose Q, K, V and dO the block stages whole, and the rows
// of a streamed chunk of the chunked instance. The CPU emulation's tests
// build the source with MPREID_TC_CHUNK_ROWS (a multiple of 16) defined,
// which sets the chunk and sends every length through the chunked instance.
template <int DH>
__host__ __device__ constexpr int whole_rows() {
#ifdef MPREID_TC_CHUNK_ROWS
  return 0;
#else
  return DH == 64 ? 384 : 208;
#endif
}

template <int DH>
__host__ __device__ constexpr int chunk_rows() {
#ifdef MPREID_TC_CHUNK_ROWS
  return MPREID_TC_CHUNK_ROWS;
#else
  return DH == 64 ? 624 : 272;
#endif
}
static_assert(chunk_rows<64>() % 16 == 0 && chunk_rows<128>() % 16 == 0,
              "a chunk is whole 16-row blocks");

// Shared memory of the whole-sequence instance at L16 = l16.
template <int DH>
size_t smem_bytes(int l16) {
  return 4 * static_cast<size_t>(l16) * tile_stride<DH>() * sizeof(bf16) +
         3 * static_cast<size_t>(l16) * sizeof(float);
}

// Shared memory of the chunked instance.
template <int DH>
size_t chunked_smem_bytes() {
  return 2 * static_cast<size_t>(kOwnRows + chunk_rows<DH>()) * tile_stride<DH>() *
             sizeof(bf16) +
         3 * static_cast<size_t>(chunk_rows<DH>()) * sizeof(float);
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

// kChunked: each round stages its own blocks and streams the other side in
// chunks of chunk_rows<DH>() rows, the rows' statistics going
// through `stats`; otherwise Q, K, V and dO are staged whole, once, and
// `stats` is not read.
template <int DH, bool kChunked>
__global__ void __launch_bounds__(kMaxWarps * 32)
mha_bwd_tc_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                  const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                  float* __restrict__ stats, int L, int H, long long row_stride, int q_base,
                  int k_base, int v_base, int head_stride, float scale) {
  constexpr int S = tile_stride<DH>();
  constexpr int KS = DH / 16;
  constexpr int CPR = DH / 8;  // 16-byte chunks per staged row
  constexpr bool kKeepKV = DH == 64;
  constexpr int C = chunk_rows<DH>();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L16 = round16(L);
  // whole: Q, K, V, dO of every row, then m, 1 / l, delta. chunked: two
  // tiles of a round's own rows (phase 1 Q and dO, phase 2 K and V), two
  // tiles of a streamed chunk (phase 1 K and V, phase 2 Q and dO), then the
  // chunk's m, 1 / l, delta
  const int own_rows = kChunked ? kOwnRows : L16;
  const int str_rows = kChunked ? C : L16;
  bf16* t0_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* t1_s = t0_s + own_rows * S;
  bf16* t2_s = t1_s + own_rows * S;
  bf16* t3_s = t2_s + str_rows * S;
  float* m_s = reinterpret_cast<float*>(t3_s + str_rows * S);  // row max (0 where all -inf)
  float* il_s = m_s + str_rows;                                // 1 / row sum
  float* d_s = il_s + str_rows;                                // delta
  bf16* const q_own = t0_s;                    // phase 1: the warps' query rows
  bf16* const o_own = kChunked ? t1_s : t3_s;  //   and their dO rows
  bf16* const k_str = kChunked ? t2_s : t1_s;  // phase 1: the keys
  bf16* const v_str = kChunked ? t3_s : t2_s;
  bf16* const k_own = kChunked ? t0_s : t1_s;  // phase 2: the warps' key rows
  bf16* const v_own = kChunked ? t1_s : t2_s;
  bf16* const q_str = kChunked ? t2_s : t0_s;  // phase 2: the query rows
  bf16* const o_str = t3_s;                    //   and their dO rows

  const int h = static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y);
  const long long D = static_cast<long long>(H) * DH;
  const bf16* base = qkv + static_cast<long long>(b) * L * row_stride;
  const bf16* dbase = dout + static_cast<long long>(b) * L * D + static_cast<long long>(h) * DH;
  bf16* gbase = dqkv + static_cast<long long>(b) * L * row_stride;
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;
  // chunked: this (b, h)'s m, 1 / l and delta, L16 fp32 each
  float* const st_m = stats + (static_cast<long long>(b) * H + h) * 3 * L16;
  float* const st_il = st_m + L16;
  float* const st_d = st_il + L16;

  // rows j0 .. j0 + n - 1 of two tiles, x from column xcol of qkv (or of dO
  // when xcol < 0) and y likewise, into x_s and y_s; rows >= L zero-filled
  auto stage2 = [&](bf16* x_s, int xcol, bf16* y_s, int ycol, int j0, int n) {
    for (int idx = static_cast<int>(threadIdx.x); idx < n * CPR;
         idx += static_cast<int>(blockDim.x)) {
      const int j = idx / CPR;
      const int c = (idx - j * CPR) * 8;
      const int off = j * S + c;
      const long long row = j0 + j;
      if (row < L) {
        cp_async_16(x_s + off, xcol < 0 ? dbase + row * D + c : base + row * row_stride + xcol + c);
        cp_async_16(y_s + off, ycol < 0 ? dbase + row * D + c : base + row * row_stride + ycol + c);
      } else {
        const uint4 z = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(x_s + off) = z;
        *reinterpret_cast<uint4*>(y_s + off) = z;
      }
    }
  };

  if constexpr (!kChunked) {
    for (int idx = static_cast<int>(threadIdx.x); idx < L16 * CPR;
         idx += static_cast<int>(blockDim.x)) {
      const int j = idx / CPR;
      const int c = (idx - j * CPR) * 8;
      const int off = j * S + c;
      if (j < L) {
        const bf16* row = base + static_cast<long long>(j) * row_stride;
        cp_async_16(q_own + off, row + qcol + c);
        cp_async_16(k_str + off, row + kcol + c);
        cp_async_16(v_str + off, row + vcol + c);
        cp_async_16(o_own + off, dbase + static_cast<long long>(j) * D + c);
      } else {
        const uint4 z = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(q_own + off) = z;
        *reinterpret_cast<uint4*>(k_str + off) = z;
        *reinterpret_cast<uint4*>(v_str + off) = z;
        *reinterpret_cast<uint4*>(o_own + off) = z;
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nrb = L16 / 16;
  const int nwarps = static_cast<int>(blockDim.x) >> 5;
  const float sc = __bfloat162float(__float2bfloat16(scale));
  const int cb = kChunked ? C / 16 : nrb;  // 16-row blocks a chunk holds
  const int nchunks = kChunked ? (nrb + cb - 1) / cb : 1;

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

  // The chunked instance's staging; every thread of the block calls these
  // alike, so they may wait at the block's barrier. own(j0): the round's own
  // rows from j0 (phase 1 Q and dO, phase 2 K and V). stream(c, with_v):
  // chunk c of the other side in the streamed tiles (phase 1: K, and V when
  // with_v; phase 2: Q, dO and the statistics).
  int staged = -1;
  bool staged_v = false;
  bool keys_phase = true;  // phase 1
  auto own = [&](int j0) {
    if constexpr (kChunked) {
      __syncthreads();  // every warp is done with the previous round's rows
      const int n = min(nwarps * 16, L16 - j0);
      if (keys_phase)
        stage2(q_own, qcol, o_own, -1, j0, n);
      else
        stage2(k_own, kcol, v_own, vcol, j0, n);
      cp_async_wait_all();
      __syncthreads();
    }
  };
  auto stream = [&](int c, bool with_v) {
    if constexpr (kChunked) {
      with_v = with_v || nchunks == 1;  // one chunk: staged once for every sweep
      if (c == staged && (staged_v || !with_v)) return;
      __syncthreads();  // every warp is done with what the tiles hold
      const int j0 = c * C;
      const int n = min(C, L16 - j0);
      if (keys_phase) {
        if (with_v) {
          stage2(k_str, kcol, v_str, vcol, j0, n);
        } else {
          for (int idx = static_cast<int>(threadIdx.x); idx < n * CPR;
               idx += static_cast<int>(blockDim.x)) {
            const int j = idx / CPR;
            const int cc = (idx - j * CPR) * 8;
            if (j0 + j < L)
              cp_async_16(k_str + j * S + cc,
                          base + static_cast<long long>(j0 + j) * row_stride + kcol + cc);
            else
              *reinterpret_cast<uint4*>(k_str + j * S + cc) = make_uint4(0, 0, 0, 0);
          }
        }
      } else {
        stage2(q_str, qcol, o_str, -1, j0, n);
        // the statistics phase 1 wrote, read back by this block: plain loads
        for (int i = static_cast<int>(threadIdx.x); i < n; i += static_cast<int>(blockDim.x)) {
          m_s[i] = st_m[j0 + i];
          il_s[i] = st_il[j0 + i];
          d_s[i] = st_d[j0 + i];
        }
      }
      cp_async_wait_all();
      __syncthreads();
      staged = c;
      staged_v = with_v;
    }
  };

  // ---- phase 1: query blocks -> m, 1 / l, delta, dQ ----
  // rounds of nwarps query blocks: the whole-sequence instance's warp stops
  // after its last block, every warp of the chunked one goes through every
  // round (a warp past the last block only stages and waits)
  for (int rb = warp, rb0 = 0; kChunked ? rb0 < nrb : rb < nrb; rb += nwarps, rb0 += nwarps) {
    const bool active = !kChunked || rb < nrb;
    const int r0 = rb * 16;
    const int own0 = kChunked ? rb0 * 16 : 0;  // the first row the own tiles hold
    own(rb0 * 16);
    uint32_t qf[KS][4], of[KS][4];
    if (active) {
      load_a<DH>(qf, q_own, r0 - own0, lane);
      scale_a<DH>(qf, sc);
      load_a<DH>(of, o_own, r0 - own0, lane);
    }

    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};
    for (int c = 0; c < nchunks; ++c) {
      stream(c, false);
      const int kb0 = c * cb;
      const int kb1 = active ? min(nrb, kb0 + cb) : kb0;
      for (int kb = kb0; kb < kb1; ++kb) {
        float s[2][4];
        rows_dot<DH>(s, qf, k_str, kb - kb0, lane);
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
    }
    float ref[2], inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ref[r] = m[r] == -CUDART_INF_F ? 0.f : m[r];
      inv_l[r] = 1.f / quad_sum(l[r]);
    }

    // p and dP of block kb (block kb - kb0 of the streamed tiles), p in s
    // and dP in dp
    auto probs_and_dp = [&](float s[2][4], float dp[2][4], int kb, int kb0) {
      rows_dot<DH>(s, qf, k_str, kb - kb0, lane);
      mask_scores(s, r0, kb);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = __expf(s[n][c] - ref[c >> 1]) * inv_l[c >> 1];
      rows_dot<DH>(dp, of, v_str, kb - kb0, lane);
    };

    float delta[2] = {0.f, 0.f};
    for (int c = 0; c < nchunks; ++c) {
      stream(c, true);
      const int kb0 = c * cb;
      const int kb1 = active ? min(nrb, kb0 + cb) : kb0;
      for (int kb = kb0; kb < kb1; ++kb) {
        float s[2][4], dp[2][4];
        probs_and_dp(s, dp, kb, kb0);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) delta[e >> 1] += dp[n][e] * s[n][e];
      }
    }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);

    float dq[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dq[n][c] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      stream(c, true);
      const int kb0 = c * cb;
      const int kb1 = active ? min(nrb, kb0 + cb) : kb0;
      for (int kb = kb0; kb < kb1; ++kb) {
        float s[2][4], dp[2][4];
        probs_and_dp(s, dp, kb, kb0);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - delta[e >> 1];
        uint32_t da[4];
        c_to_a(da, s[0], s[1]);
        acc_rows<DH>(dq, da, k_str, (kb - kb0) * 16, lane);
      }
    }
    if (!active) continue;
    store_rows<DH>(gbase, row_stride, qcol, r0, L, dq, scale, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if constexpr (kChunked) {
          st_m[row] = ref[r];
          st_il[row] = inv_l[r];
          st_d[row] = delta[r];
        } else {
          m_s[row] = ref[r];
          il_s[row] = inv_l[r];
          d_s[row] = delta[r];
        }
      }
    }
  }
  __syncthreads();

  // ---- phase 2: key blocks -> dK, dV ----
  // Element c of tile n is (key j0 + g + 8 (c / 2), query i0 + 8 n + 2 t + c % 2).
  keys_phase = false;
  staged = -1;
  for (int kb = warp, kb0 = 0; kChunked ? kb0 < nrb : kb < nrb; kb += nwarps, kb0 += nwarps) {
    const bool active = !kChunked || kb < nrb;
    const int j0 = kb * 16;
    const int own0 = kChunked ? kb0 * 16 : 0;
    own(kb0 * 16);
    uint32_t kf[kKeepKV ? KS : 1][4], vf[kKeepKV ? KS : 1][4];
    if constexpr (kKeepKV) {
      if (active) {
        load_a<DH>(kf, k_own, j0 - own0, lane);
        load_a<DH>(vf, v_own, j0 - own0, lane);
      }
    }
    float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

    for (int c = 0; c < nchunks; ++c) {
      stream(c, true);
      const int qb0 = c * cb;
      const int qb1 = active ? min(nrb, qb0 + cb) : qb0;
      for (int qb = qb0; qb < qb1; ++qb) {
        const int i0 = qb * 16;
        const int li0 = i0 - qb0 * 16;  // the block's first row in the streamed tiles
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
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
            ldmatrix_x4(ka, a_ptr(k_own, S, j0 - own0, ks * 16, lane));
            ldmatrix_x4(va, a_ptr(v_own, S, j0 - own0, ks * 16, lane));
          }
          ldmatrix_x4(bq, bt_ptr(q_str, S, li0, ks * 16, lane));
#pragma unroll
          for (int r = 0; r < 4; ++r) bq[r] = scale_pair(bq[r], sc);
          mma(st[0], ka, bq[0], bq[1]);
          mma(st[1], ka, bq[2], bq[3]);
          ldmatrix_x4(bo, bt_ptr(o_str, S, li0, ks * 16, lane));
          mma(dpt[0], va, bo[0], bo[1]);
          mma(dpt[1], va, bo[2], bo[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + g + 8 * (e >> 1);
            const int query = i0 + 8 * n + 2 * t + (e & 1);
            const int lq = query - qb0 * 16;  // its row in the streamed statistics
            float p = 0.f;
            if (key < L && query < L) {
              float s = st[n][e];
              if (mask != nullptr) s += mask[static_cast<long long>(query) * L + key];
              p = __expf(s - m_s[lq]) * il_s[lq];
            }
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - d_s[lq]);
          }
        uint32_t pa[4], da[4];
        c_to_a(pa, st[0], st[1]);
        c_to_a(da, dpt[0], dpt[1]);
        acc_rows<DH>(dv, pa, o_str, li0, lane);
        acc_rows<DH>(dk, da, q_str, li0, lane);
      }
    }
    if (!active) continue;
    store_rows<DH>(gbase, row_stride, kcol, j0, L, dk, scale, lane);
    store_rows<DH>(gbase, row_stride, vcol, j0, L, dv, 1.f, lane);
  }
}

template <int DH, bool kChunked>
int launch(const void* qkv, const float* mask, const void* dout, void* dqkv, void* stats, int B,
           int L, int H, long long row_stride, int q_base, int k_base, int v_base,
           int head_stride, float scale, cudaStream_t stream) {
  const size_t smem = kChunked ? chunked_smem_bytes<DH>() : smem_bytes<DH>(round16(L));
  if (smem > kMaxSmem || (kChunked && stats == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      mha_bwd_tc_kernel<DH, kChunked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int warps = warps_for(round16(L) / 16, kMaxWarps);
  const dim3 grid(H, B);
  mha_bwd_tc_kernel<DH, kChunked><<<grid, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), mask, static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), static_cast<float*>(stats), L, H, row_stride, q_base, k_base,
      v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// The whole-sequence instance while Q, K, V and dO fit, the chunked one
// after.
template <int DH>
int dispatch(const void* qkv, const float* mask, const void* dout, void* dqkv, void* stats,
             int B, int L, int H, long long row_stride, int q_base, int k_base, int v_base,
             int head_stride, float scale, cudaStream_t stream) {
  if (round16(L) <= whole_rows<DH>())
    return launch<DH, false>(qkv, mask, dout, dqkv, stats, B, L, H, row_stride, q_base, k_base,
                             v_base, head_stride, scale, stream);
  return launch<DH, true>(qkv, mask, dout, dqkv, stats, B, L, H, row_stride, q_base, k_base,
                          v_base, head_stride, scale, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 for an unsupported head width):
// at most mpreid_mha_bwd_tc_max_smem_bytes() at every L.
size_t mpreid_mha_bwd_tc_smem_bytes(int L, int dh) {
  if (dh == 64)
    return round16(L) <= whole_rows<64>() ? smem_bytes<64>(round16(L))
                                          : chunked_smem_bytes<64>();
  if (dh == 128)
    return round16(L) <= whole_rows<128>() ? smem_bytes<128>(round16(L))
                                           : chunked_smem_bytes<128>();
  return 0;
}

size_t mpreid_mha_bwd_tc_max_smem_bytes() { return kMaxSmem; }

// Floats of fp32 scratch mpreid_mha_bwd_tc at (B, L, H, dh) needs for the
// rows' statistics: 0 where the sequence is staged whole, 3 * L16 per (b, h)
// where it is streamed.
long long mpreid_mha_bwd_tc_scratch_floats(int B, int L, int H, int dh) {
  if (dh != 64 && dh != 128) return 0;
  if (round16(L) <= (dh == 64 ? whole_rows<64>() : whole_rows<128>())) return 0;
  return 3LL * B * H * round16(L);
}

// qkv and dqkv (B, L, row_stride) and dout (B, L, H * dh) are contiguous
// bf16, 16-byte aligned, with row_stride and the column offsets multiples of
// 8; mask is null or a contiguous (L, L) fp32 array; stats is 16-byte
// aligned fp32 scratch of mpreid_mha_bwd_tc_scratch_floats(B, L, H, dh)
// floats (null where that is 0). Head h reads q at column q_base + h *
// head_stride, k and v likewise, and writes dq, dk and dv at the same
// columns of dqkv. Any L. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mpreid_mha_bwd_tc(const void* qkv, const void* mask, const void* dout, void* dqkv,
                      void* stats, int B, int L, int H, int dh, long long row_stride, int q_base,
                      int k_base, int v_base, int head_stride, float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0) return 0;
  if (dh == 64)
    return dispatch<64>(qkv, m, dout, dqkv, stats, B, L, H, row_stride, q_base, k_base, v_base,
                        head_stride, scale, s);
  if (dh == 128)
    return dispatch<128>(qkv, m, dout, dqkv, stats, B, L, H, row_stride, q_base, k_base, v_base,
                         head_stride, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
