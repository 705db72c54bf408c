// Fused multi-head self-attention forward on Hopper's tensor cores (sm_90a),
// bf16 activations.
//
// Replaces the TPU kernels ops/attention.py::_mha_fwd_kernel (packed
// [q|k|v] columns, launched by _mha_fwd_pallas) and
// ops/attention.py::_mha_fwd_kernel_hm (head-major [q_h|k_h|v_h] columns,
// launched by _mha_fwd_pallas_hm) of the JAX package, for bf16; fp32 keeps
// the CUDA-core kernel of attention_fwd.cu. One kernel serves both layouts:
// the caller passes the column offsets of q, k and v for head 0 and the
// column stride from one head to the next.
//
// Math, per (batch b, head h), with the JAX package's rounding order:
//   qs  = round(q * round(scale))   bf16, as the plain version scales q
//   s   = qs k^T (+ mask)           fp32 sums; keys >= L are -inf
//   p   = exp(s - max) / sum        fp32, exactly normalised (no online
//                                   rescaling of the output), then rounded
//   out = round(p) v                fp32 sums, written in bf16
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the main
// path's shape, B 64, L 129, 12 heads x 64: reading qkv once (38.0 MB) and
// writing out once (12.7 MB) takes 15.1 us, the two L x L x dh products
// (3.3 GFLOP) 3.3 us. So it is bound by bytes, and the design reads qkv once
// and keeps everything else on the chip:
//   grid (H, B), one block per head: the block stages that head's K and V
//   in shared memory once (16-byte cp.async, rows L..L16 zero-filled, not
//   loaded), and each warp owns 16 query rows at a time, its scaled Q in
//   registers as A fragments loaded straight from device memory.
//   S = Qs K^T and O = P V run on mma.sync.m16n8k16 (bf16 -> fp32) with
//   ldmatrix (.trans for V). The keys go by in 16-key blocks over two sweeps:
//   the first takes the row max and sum (rescaled as the max grows), the
//   second recomputes S, forms the exactly normalised p, rounds it to bf16
//   and accumulates P V. The extra Q K^T is cheap in a kernel bound by
//   bytes, and holding 16 keys at a time keeps a thread under 100
//   registers, so two blocks share an SM and one block's loads overlap the
//   other's products.
// Shared memory per block: K and V, 2 * rows * (dh + 8) bf16, rows = L16 (L
// rounded up to 16) while L16 <= chunk_rows<dh>() (800 at dh 64, 416 at dh
// 128): 41 KB at L 129 and 78 KB at L 257 (dh 64), 148 KB at L 257 (dh 128).
// A longer sequence goes by chunks of chunk_rows<dh>() keys (the most that
// one block's 227 KB holds): the kernel's chunked instance loops over them
// around each sweep's 16-key blocks, staging K alone for the first sweep and
// K and V for the second, every block of keys in the same order as one
// chunk would take them, so the row max and sum, and the P V sums, carry
// from chunk to chunk and two launches give the same bits. Each round of
// the warps' query blocks streams the chunks again, through a barrier at
// each chunk, and only one block fits on an SM. So shared memory stays under
// 227 KB at every length and no length is refused; lengths that fit run the
// whole-sequence instance, the same loads and products as before chunks.

#include <math_constants.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

// Warps per block (a 16-row block each, in rounds when L needs more) and the
// blocks per SM ptxas sizes registers for: at dh 64 two blocks of 9 warps
// (L 129 in one round) fit at 96 registers a thread with no spills, and run
// the vision shape faster than the same code bounded at 16 warps and one
// block (PERF.md); at dh 128 the output sums take 64 registers, so one.
template <int DH>
__host__ __device__ constexpr int max_warps() { return DH == 64 ? 9 : 8; }

template <int DH>
__host__ __device__ constexpr int min_blocks() { return DH == 64 ? 2 : 1; }

// Keys a chunk holds, the rows of each tile of the chunked instance: the
// most K and V rows that one block's 227 KB take. The CPU emulation's tests
// build the source with MPREID_TC_CHUNK_ROWS (a multiple of 16) defined,
// which sets the chunk and sends every length through the chunked instance.
template <int DH>
__host__ __device__ constexpr int chunk_rows() {
#ifdef MPREID_TC_CHUNK_ROWS
  return MPREID_TC_CHUNK_ROWS;
#else
  return DH == 64 ? 800 : 416;
#endif
}
static_assert(chunk_rows<64>() % 16 == 0 && chunk_rows<128>() % 16 == 0,
              "a chunk is whole 16-row blocks");

// The longest L16 the whole-sequence instance takes: what a chunk holds.
template <int DH>
__host__ __device__ constexpr int whole_rows() {
#ifdef MPREID_TC_CHUNK_ROWS
  return 0;
#else
  return chunk_rows<DH>();
#endif
}

// Shared memory of a block whose tiles hold `rows` keys.
template <int DH>
size_t smem_bytes(int rows) {
  return 2 * static_cast<size_t>(rows) * tile_stride<DH>() * sizeof(bf16);
}

// s[n] = qs K^T over keys kb * 16 + 8 n + (0..7), then the padding and the
// mask: element c of tile n is (row r0 + g + 8 (c / 2), key kb * 16 + 8 n +
// 2 t + c % 2). k_s holds the keys from block kb0 on.
template <int DH>
__device__ __forceinline__ void scores(float s[2][4], const uint32_t (&qf)[DH / 16][4],
                                       const bf16* k_s, int kb, int kb0, int r0, int L,
                                       const float* __restrict__ mask, int lane) {
  constexpr int S = tile_stride<DH>();
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t b[4];
    ldmatrix_x4(b, bt_ptr(k_s, S, (kb - kb0) * 16, ks * 16, lane));
    mma(s[0], qf[ks], b[0], b[1]);
    mma(s[1], qf[ks], b[2], b[3]);
  }
  if (mask == nullptr && kb * 16 + 16 <= L) return;  // no mask, no padded key
  const int g = lane >> 2, t = lane & 3;
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
}

// kChunked: the keys go by in chunks of chunk_rows<DH>() rows, staged once
// per sweep and round; otherwise K and V are staged whole, once.
template <int DH, bool kChunked>
__global__ void __launch_bounds__(max_warps<DH>() * 32, kChunked ? 1 : min_blocks<DH>())
mha_fwd_tc_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                  bf16* __restrict__ out, int L, int H, long long row_stride, int q_base,
                  int k_base, int v_base, int head_stride, float scale) {
  constexpr int S = tile_stride<DH>();
  constexpr int KS = DH / 16;  // k16 steps over the head width
  constexpr int CPR = DH / 8;  // 16-byte chunks per staged row
  constexpr int C = chunk_rows<DH>();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L16 = round16(L);
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + (kChunked ? C : L16) * S;

  const int h = static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y);
  const bf16* base = qkv + static_cast<long long>(b) * L * row_stride;
  const int qcol = q_base + h * head_stride;
  const int kcol = k_base + h * head_stride;
  const int vcol = v_base + h * head_stride;

  // keys j0 .. j0 + n - 1 of K, and of V when with_v, into the tiles; keys
  // >= L zero-filled, not loaded
  auto stage = [&](int j0, int n, bool with_v) {
    for (int idx = static_cast<int>(threadIdx.x); idx < n * CPR;
         idx += static_cast<int>(blockDim.x)) {
      const int j = idx / CPR;
      const int c = (idx - j * CPR) * 8;
      bf16* kd = k_s + j * S + c;
      bf16* vd = v_s + j * S + c;
      if (j0 + j < L) {
        const bf16* row = base + static_cast<long long>(j0 + j) * row_stride;
        cp_async_16(kd, row + kcol + c);
        if (with_v) cp_async_16(vd, row + vcol + c);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        if (with_v) *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_wait_all();
  };
  if constexpr (!kChunked) {
    stage(0, L16, true);
    __syncthreads();
  }

  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nrb = L16 / 16;
  const int nwarps = static_cast<int>(blockDim.x) >> 5;
  const float sc = __bfloat162float(__float2bfloat16(scale));
  const long long D = static_cast<long long>(H) * DH;
  const int cb = kChunked ? C / 16 : nrb;  // key blocks a chunk holds
  const int nchunks = kChunked ? (nrb + cb - 1) / cb : 1;

  // chunk c of K (and of V when with_v) in the tiles; every thread of the
  // block calls it alike, so it may wait at the block's barrier
  int staged = kChunked ? -1 : 0;
  bool staged_v = !kChunked;
  auto ensure = [&](int c, bool with_v) {
    if constexpr (kChunked) {
      with_v = with_v || nchunks == 1;  // one chunk: K and V once, for every sweep
      if (c == staged && (staged_v || !with_v)) return;
      __syncthreads();  // every warp is done with what the tiles hold
      stage(c * C, min(C, L16 - c * C), with_v);
      __syncthreads();
      staged = c;
      staged_v = with_v;
    }
  };

  // rounds of nwarps query blocks: the whole-sequence instance's warp stops
  // after its last block, every warp of the chunked one goes through every
  // round (a warp past the last block only stages and waits)
  for (int rb = warp, rb0 = 0; kChunked ? rb0 < nrb : rb < nrb; rb += nwarps, rb0 += nwarps) {
    const bool active = !kChunked || rb < nrb;
    const int r0 = rb * 16;
    // qs as A fragments, straight from device memory; rows >= L are zero
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + g + 8 * (r & 1);
        const int col = ks * 16 + 2 * t + 8 * (r >> 1);
        uint32_t w = 0;
        if (row < L)
          w = *reinterpret_cast<const uint32_t*>(base + static_cast<long long>(row) * row_stride +
                                                 qcol + col);
        qf[ks][r] = scale_pair(w, sc);
      }

    // sweep 1: row max and sum, the sum rescaled whenever the max grows
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};
    for (int c = 0; c < nchunks; ++c) {
      ensure(c, false);
      const int kb0 = c * cb;
      const int kb1 = active ? min(nrb, kb0 + cb) : kb0;
      for (int kb = kb0; kb < kb1; ++kb) {
        float s[2][4];
        scores<DH>(s, qf, k_s, kb, kb0, r0, L, mask, lane);
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

    // sweep 2: p = exp(s - max) / sum rounded to bf16, O += P V
    float o[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      ensure(c, true);
      const int kb0 = c * cb;
      const int kb1 = active ? min(nrb, kb0 + cb) : kb0;
      for (int kb = kb0; kb < kb1; ++kb) {
        float s[2][4];
        scores<DH>(s, qf, k_s, kb, kb0, r0, L, mask, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = __expf(s[n][e] - ref[e >> 1]) * inv_l[e >> 1];
        uint32_t pa[4];
        c_to_a(pa, s[0], s[1]);
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, a_ptr(v_s, S, (kb - kb0) * 16, dp * 16, lane));
          mma(o[2 * dp], pa, bv[0], bv[1]);
          mma(o[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= L) continue;
      bf16* orow = out + (static_cast<long long>(b) * L + row) * D + h * DH + 2 * t;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack(o[n][2 * r], o[n][2 * r + 1]);
    }
  }
}

template <int DH, bool kChunked>
int launch(const void* qkv, const float* mask, void* out, int B, int L, int H,
           long long row_stride, int q_base, int k_base, int v_base, int head_stride,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(kChunked ? chunk_rows<DH>() : round16(L));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      mha_fwd_tc_kernel<DH, kChunked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int warps = warps_for(round16(L) / 16, max_warps<DH>());
  const dim3 grid(H, B);
  mha_fwd_tc_kernel<DH, kChunked><<<grid, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), mask, static_cast<bf16*>(out), L, H, row_stride, q_base,
      k_base, v_base, head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// The whole-sequence instance while K and V fit, the chunked one after.
template <int DH>
int dispatch(const void* qkv, const float* mask, void* out, int B, int L, int H,
             long long row_stride, int q_base, int k_base, int v_base, int head_stride,
             float scale, cudaStream_t stream) {
  if (round16(L) <= whole_rows<DH>())
    return launch<DH, false>(qkv, mask, out, B, L, H, row_stride, q_base, k_base, v_base,
                             head_stride, scale, stream);
  return launch<DH, true>(qkv, mask, out, B, L, H, row_stride, q_base, k_base, v_base,
                          head_stride, scale, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 for an unsupported head width):
// at most mpreid_mha_fwd_tc_max_smem_bytes() at every L.
size_t mpreid_mha_fwd_tc_smem_bytes(int L, int dh) {
  if (dh == 64)
    return smem_bytes<64>(round16(L) <= whole_rows<64>() ? round16(L) : chunk_rows<64>());
  if (dh == 128)
    return smem_bytes<128>(round16(L) <= whole_rows<128>() ? round16(L) : chunk_rows<128>());
  return 0;
}

size_t mpreid_mha_fwd_tc_max_smem_bytes() { return kMaxSmem; }

// qkv (B, L, row_stride) and out (B, L, H * dh) are contiguous bf16, 16-byte
// aligned, with row_stride and the column offsets multiples of 8; mask is
// null or a contiguous (L, L) fp32 array. Head h reads q at column q_base +
// h * head_stride, k and v likewise. Any L. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int mpreid_mha_fwd_tc(const void* qkv, const void* mask, void* out, int B, int L, int H, int dh,
                      long long row_stride, int q_base, int k_base, int v_base, int head_stride,
                      float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0) return 0;
  if (dh == 64)
    return dispatch<64>(qkv, m, out, B, L, H, row_stride, q_base, k_base, v_base, head_stride,
                        scale, s);
  if (dh == 128)
    return dispatch<128>(qkv, m, out, B, L, H, row_stride, q_base, k_base, v_base, head_stride,
                         scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
