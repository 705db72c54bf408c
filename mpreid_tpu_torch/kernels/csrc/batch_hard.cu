// Fused batch-hard mining for Hopper (sm_90a): for B rows of D-wide features
// and their int32 labels,
//   d(i, j) = sqrt(max(|f_i|^2 + |f_j|^2 - 2 f_i.f_j, 1e-12))
//   ap[i] = max over j with label j == label i of d(i, j),  p[i] = its argmax
//   an[i] = min over j with label j != label i of d(i, j),  n[i] = its argmin
// Each argmax / argmin takes the first index on a tie (jnp.argmax's rule); a
// row with no negative gets an = +inf and n = 0. The input is fp32 or bf16
// and is read as fp32; all arithmetic is fp32.
//
// Replaces the TPU kernel ops/pallas_kernels.py::_batch_hard_forward (body
// _batch_hard_kernel) of the JAX package, which keeps the B x B matrix in
// VMEM. Here no distance is written to device memory.
//
// What bounds it on an H100: at the PK batch of the training path (B 64,
// D 768) the work is 6.3 MFLOP (0.094 us at 67 TFLOP/s fp32) and the bytes
// 197 KB (0.059 us at 3.35 TB/s). Neither rate is the limit: the launch and
// the round trips to memory are. So the design spreads the call over many
// SMs and puts every load in flight at once.
//
// Design: a cluster of kCluster blocks takes R anchor rows; block k of it
// (its rank) takes slice k of D, s = ceil(D / kCluster) rounded up to 4
// floats. At B 64 that is 8 clusters of 8, 64 blocks (a 32-row tile per
// block took 2). A block stages its slice of the anchor rows and of a tile
// of tc columns (batch rows) in shared memory: with fp32 rows 16-byte
// aligned by 16-byte cp.async copies, all issued before the one wait, else
// by plain loads. Where the whole slice of every row does not fit (B above
// 256 or a wide D) the tiles and chunks of D stream through two buffers,
// the next stage's copies in flight while the current one is consumed. Each
// thread keeps items of RG anchor rows x CG columns: fp32 FMA on the CUDA
// cores, k ascending, each column's squared norm beside its dot products in
// the same order (the tensor cores buy nothing at 6.3 MFLOP, and FMA keeps
// d(i, i) exact). After a tile every block writes its partial dot products
// and norms into the shared memory of the block that owns each column (rank
// 0 alone with one tile; else block k owns the k-th eighth of the tile), and
// the cluster meets at a barrier. The owner sums the kCluster partials of
// each column in rank order, forms the distance in the JAX order ((sq_i +
// sq_j) - 2 dot, clamp, sqrt, no contraction into a fused multiply-add) and
// folds it into a running (max, argmax) and (min, argmin) per anchor row
// (warp w takes rows w, w + W, ..., each lane its columns in increasing
// order with strict comparisons). The partial buffers alternate between
// tiles, so one barrier a tile suffices. At the end each warp reduces its
// lanes with shuffles comparing (value, index); with several owners each
// writes its rows' candidates into rank 0's shared memory and after a last
// barrier rank 0 combines them in rank order; rank 0 writes ap, an, p and n.
// No atomics and every sum in a fixed order: every run gives the same bits.
// The anchor norms are summed by the same steps as the column norms, so
// d(i, i) is exactly sqrt(1e-12) and d(i, j) == d(j, i).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "cluster.cuh"

namespace {

using namespace cluster;

constexpr int kCluster = 8;          // blocks per cluster: D split 8 ways
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

// How one call is cut, the same for every block.
struct Plan {
  int rows;     // anchor rows per cluster: W x RW, W warps a block
  int s;        // D per block, a multiple of 4
  int sc;       // D per stage, a multiple of 4, <= s
  int pitch;    // floats per staged row: a multiple of 4 with pitch / 4 odd
  int tc;       // columns per tile, a multiple of kCluster
  int n_tiles;  // ceil(B / tc)
  int n_chunks; // ceil(s / sc)
  int nbuf;     // staging buffers: 1 when one stage holds everything, else 2
  int nparts;   // partial-sum and label buffers: 1 with one tile, else 2
  int owners;   // blocks that own columns: 1 (rank 0) with one tile where it fits, else all
  int vec;      // fp32 rows 16-byte aligned: 16-byte copies
};

// floats of one block's partials for one tile at an owner of tcb = tc /
// owners columns: dots [rows][tcb], column norms [tcb], anchor norms [rows]
__host__ __device__ inline int part_floats(const Plan& pl) {
  const int tcb = pl.tc / pl.owners;
  return pl.rows * tcb + tcb + pl.rows;
}

__host__ __device__ inline int buf_floats(const Plan& pl) { return (pl.rows + pl.tc) * pl.pitch; }

// staging buffers, labels [nparts][tc], partials [nparts][kCluster][...],
// and with several owners candidates [kCluster][rows][4]
__host__ inline size_t smem_bytes(const Plan& pl) {
  const size_t floats = size_t(pl.nbuf) * buf_floats(pl) + size_t(pl.nparts) * pl.tc +
                        size_t(pl.nparts) * kCluster * part_floats(pl) +
                        (pl.owners > 1 ? size_t(kCluster) * pl.rows * 4 : 0);
  return floats * 4;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// (v, i) is better than (best, bi) for a max: larger, or equal at a lower index
__device__ __forceinline__ bool better_max(float v, int i, float best, int bi) {
  return v > best || (v == best && i < bi);
}

__device__ __forceinline__ bool better_min(float v, int i, float best, int bi) {
  return v < best || (v == best && i < bi);
}

// Stage rows row0 .. row0 + rows - 1 (anchors) and t0 .. t0 + tc - 1
// (columns) over D [k0, k0 + w) into dst, zero from w up to the next 4;
// rows past B are left as they are (their results are never read). With
// labels, the tile's column labels go to lab. Commits one copy group.
template <class T>
__device__ __forceinline__ void stage_issue(float* dst, int* lab, const T* __restrict__ f,
                                            const int* __restrict__ labels, int b, long long ld,
                                            const Plan& pl, int row0, int t0, int k0, int w) {
  const int rows = pl.rows + pl.tc;
  const int w4 = (w + 3) & ~3;
  int done = 0;  // [0, done) goes by 16-byte copies
  if constexpr (std::is_same<T, float>::value) {
    if (pl.vec) {
      const int pieces = w / 4;
#pragma unroll 4
      for (int e = threadIdx.x; e < rows * pieces; e += blockDim.x) {
        const int q = e / pieces, c = 4 * (e - q * pieces);
        const int g = q < pl.rows ? row0 + q : t0 + q - pl.rows;
        if (g < b) cp_async_16(dst + q * pl.pitch + c, f + g * ld + k0 + c);
      }
      done = 4 * pieces;
    }
  }
  const int rest = w4 - done;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * rest; e += blockDim.x) {
    const int q = e / rest, c = done + (e - q * rest);
    const int g = q < pl.rows ? row0 + q : t0 + q - pl.rows;
    if (g < b) dst[q * pl.pitch + c] = c < w ? load(f + g * ld + k0 + c) : 0.f;
  }
  if (lab != nullptr) {
    for (int jj = threadIdx.x; jj < pl.tc; jj += blockDim.x) {
      const int j = t0 + jj;
      lab[jj] = j < b ? labels[j] : 0;
    }
  }
  cp_async_commit();
}

// W warps a block, RW anchor rows a warp (W RW a cluster); items of RG
// anchor rows x CG columns (tc / CG apart), M a thread.
template <class T, int W, int RW, int RG, int CG, int M>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(W * 32, 1)
batch_hard_kernel(const T* __restrict__ f, const int* __restrict__ labels,
                  float* __restrict__ ap, float* __restrict__ an, int* __restrict__ p,
                  int* __restrict__ n, int b, int d, long long ld, Plan pl) {
  constexpr int R = W * RW;
  constexpr int kThreads = W * 32;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const unsigned rank = cluster_rank();
  const int row0 = (blockIdx.x / kCluster) * R;
  const int k_begin = rank * pl.s;
  const int tcb = pl.tc / pl.owners;
  const int pf = part_floats(pl);
  float* bufs = smem;
  int* labs = reinterpret_cast<int*>(smem + pl.nbuf * buf_floats(pl));
  float* parts = smem + pl.nbuf * buf_floats(pl) + pl.nparts * pl.tc;
  float* cand = parts + pl.nparts * kCluster * pf;

  // the warp's anchor rows warp + W a and their running candidates over
  // this block's columns
  int my_label[RW];
  float best_p[RW], best_n[RW], sq_i[RW];
  int idx_p[RW], idx_n[RW];
#pragma unroll
  for (int a = 0; a < RW; ++a) {
    const int i = row0 + warp + W * a;
    my_label[a] = i < b ? labels[i] : 0;
    best_p[a] = -INFINITY;
    best_n[a] = INFINITY;
    idx_p[a] = idx_n[a] = 0;
    sq_i[a] = 0.f;
  }

  const int tcg = pl.tc / CG;  // columns of an item lie tcg apart
  const int items = tcg * (R / RG);
  const int n_stages = pl.n_tiles * pl.n_chunks;
  float acc[M][RG][CG], sq[M][CG];
  float sq_a = 0.f;  // thread r < R: anchor r's norm over the slice (tile 0)

  auto issue = [&](int st) {
    const int ti = st / pl.n_chunks, h = st - ti * pl.n_chunks;
    const int k0 = k_begin + h * pl.sc;
    const int w = max(0, min(min(pl.sc, pl.s - h * pl.sc), d - k0));
    stage_issue(bufs + (st % pl.nbuf) * buf_floats(pl),
                h == 0 ? labs + (ti % pl.nparts) * pl.tc : nullptr, f, labels, b, ld, pl, row0,
                ti * pl.tc, k0, w);
  };

  issue(0);
  for (int st = 0; st < n_stages; ++st) {
    const int ti = st / pl.n_chunks, h = st - ti * pl.n_chunks;
    const int t0 = ti * pl.tc;
    const int k0 = k_begin + h * pl.sc;
    const int w4 = (max(0, min(min(pl.sc, pl.s - h * pl.sc), d - k0)) + 3) & ~3;
    if (h == 0) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          sq[m][c] = 0.f;
#pragma unroll
          for (int r = 0; r < RG; ++r) acc[m][r][c] = 0.f;
        }
      }
    }
    if (st + 1 < n_stages) {
      issue(st + 1);
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    const float* src = bufs + (st % pl.nbuf) * buf_floats(pl);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int it = tid + m * kThreads;
      if (it >= items) break;
      const int g = it / tcg, jc = it - g * tcg;
      if (t0 + jc >= b) continue;
      const float* y = src + (R + jc) * pl.pitch;
      const float* x = src + g * RG * pl.pitch;
#pragma unroll 4
      for (int kk = 0; kk < w4; kk += 4) {
        float4 yv[CG];
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          yv[c] = *reinterpret_cast<const float4*>(y + c * tcg * pl.pitch + kk);
          sq[m][c] = fmaf(yv[c].x, yv[c].x, sq[m][c]);
          sq[m][c] = fmaf(yv[c].y, yv[c].y, sq[m][c]);
          sq[m][c] = fmaf(yv[c].z, yv[c].z, sq[m][c]);
          sq[m][c] = fmaf(yv[c].w, yv[c].w, sq[m][c]);
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(x + r * pl.pitch + kk);
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            acc[m][r][c] = fmaf(xv.x, yv[c].x, acc[m][r][c]);
            acc[m][r][c] = fmaf(xv.y, yv[c].y, acc[m][r][c]);
            acc[m][r][c] = fmaf(xv.z, yv[c].z, acc[m][r][c]);
            acc[m][r][c] = fmaf(xv.w, yv[c].w, acc[m][r][c]);
          }
        }
      }
    }
    // the anchors' norms, by the same steps as a column's
    if (ti == 0 && tid < R) {
      const float* x = src + tid * pl.pitch;
      for (int kk = 0; kk < w4; kk += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(x + kk);
        sq_a = fmaf(xv.x, xv.x, sq_a);
        sq_a = fmaf(xv.y, xv.y, sq_a);
        sq_a = fmaf(xv.z, xv.z, sq_a);
        sq_a = fmaf(xv.w, xv.w, sq_a);
      }
    }

    if (h == pl.n_chunks - 1) {
      // this tile's partials into each column owner's buffer, at this rank
      const int par = ti % pl.nparts;
      float* mine = parts + (par * kCluster + rank) * pf;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int it = tid + m * kThreads;
        if (it >= items) break;
        const int g = it / tcg, jc = it - g * tcg;
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          const int jj = jc + c * tcg, owner = jj / tcb, jl = jj - owner * tcb;
          float* dst = cluster_map(mine, owner);
#pragma unroll
          for (int r = 0; r < RG; ++r) dst[(g * RG + r) * tcb + jl] = acc[m][r][c];
          if (g == 0) dst[R * tcb + jl] = sq[m][c];
        }
      }
      if (ti == 0 && tid < R) {
        for (int q = 0; q < pl.owners; ++q) cluster_map(mine, q)[R * tcb + tcb + tid] = sq_a;
      }
      cluster_sync();
      if (rank >= pl.owners) continue;

      // this block's columns of the tile, summed over the ranks in order
      const float* P = parts + par * kCluster * pf;
      const int* lab = labs + par * pl.tc;
      if (ti == 0) {
#pragma unroll
        for (int a = 0; a < RW; ++a) {
          const float* from = P + R * tcb + tcb + warp + W * a;
          for (int q = 0; q < kCluster; ++q) sq_i[a] += from[q * pf];
        }
      }
      for (int jl = lane; jl < tcb; jl += 32) {
        const int jj = rank * tcb + jl, j = t0 + jj;
        if (j >= b) break;
        float sq_j = 0.f;
#pragma unroll
        for (int q = 0; q < kCluster; ++q) sq_j += P[q * pf + R * tcb + jl];
        const int lj = lab[jj];
#pragma unroll
        for (int a = 0; a < RW; ++a) {
          const int r = warp + W * a;
          if (row0 + r >= b) break;
          float dot = 0.f;
#pragma unroll
          for (int q = 0; q < kCluster; ++q) dot += P[q * pf + r * tcb + jl];
          const float d2 = __fsub_rn(__fadd_rn(sq_i[a], sq_j), __fmul_rn(2.f, dot));
          const float dist = __fsqrt_rn(fmaxf(d2, 1e-12f));
          if (lj == my_label[a]) {
            if (dist > best_p[a]) { best_p[a] = dist; idx_p[a] = j; }
          } else {
            if (dist < best_n[a]) { best_n[a] = dist; idx_n[a] = j; }
          }
        }
      }
    }
    __syncthreads();
  }

  // the warp's lanes; with one owner rank 0 then writes, else the cluster's
  // blocks go into rank 0 and it combines them in rank order
  if (rank >= pl.owners) return;
#pragma unroll
  for (int a = 0; a < RW; ++a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float vp = __shfl_xor_sync(0xffffffffu, best_p[a], off);
      const int ip = __shfl_xor_sync(0xffffffffu, idx_p[a], off);
      const float vn = __shfl_xor_sync(0xffffffffu, best_n[a], off);
      const int in = __shfl_xor_sync(0xffffffffu, idx_n[a], off);
      if (better_max(vp, ip, best_p[a], idx_p[a])) { best_p[a] = vp; idx_p[a] = ip; }
      if (better_min(vn, in, best_n[a], idx_n[a])) { best_n[a] = vn; idx_n[a] = in; }
    }
    if (lane == 0 && pl.owners > 1) {
      float* c = cluster_map(cand + (rank * R + warp + W * a) * 4, 0);
      c[0] = best_p[a];
      c[2] = best_n[a];
      reinterpret_cast<int*>(c)[1] = idx_p[a];
      reinterpret_cast<int*>(c)[3] = idx_n[a];
    }
  }
  if (pl.owners > 1) cluster_sync();
  if (rank != 0 || lane != 0) return;
#pragma unroll
  for (int a = 0; a < RW; ++a) {
    const int r = warp + W * a, i = row0 + r;
    if (i >= b) break;
    for (int q = 1; q < pl.owners; ++q) {
      const float* c = cand + (q * R + r) * 4;
      const int* ci = reinterpret_cast<const int*>(c);
      if (better_max(c[0], ci[1], best_p[a], idx_p[a])) { best_p[a] = c[0]; idx_p[a] = ci[1]; }
      if (better_min(c[2], ci[3], best_n[a], idx_n[a])) { best_n[a] = c[2]; idx_n[a] = ci[3]; }
    }
    ap[i] = best_p[a];
    p[i] = idx_p[a];
    an[i] = best_n[a];
    n[i] = idx_n[a];
  }
}

// The launch floor: the kernel's grid, cluster, block, shared memory and
// arguments, no work.
template <class T>
__global__ void __cluster_dims__(kCluster, 1, 1)
empty_kernel(const T* __restrict__, const int* __restrict__, float* __restrict__,
             float* __restrict__, int* __restrict__, int* __restrict__, int, int, long long,
             Plan) {}

__host__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The kernel's shapes, (W, RW, RG, CG, M): warps a block, anchor rows a
// warp, anchor rows and columns an item, items a thread; tiles of
// 32 W M RG CG / (W RW) columns, rounded down to kCluster. By B: 8 anchor
// rows a cluster up to B 64 (8 clusters, 64 blocks at the PK batch), 16 in
// 16 warps above (a 512-column tile), every thread busy. chip_smoke.py's
// phase 3 times both shapes at every timed batch.
constexpr int kShapes[2][5] = {{8, 1, 2, 1, 1}, {16, 1, 8, 2, 1}};

__host__ inline int shape_of(int b) { return b <= 64 ? 0 : 1; }

__host__ inline int pitch_of(int sc) { return sc + ((sc / 4) % 2 == 0 ? 4 : 8); }

// The cut of a call at shape `shape`: tiles of at most max_cols columns,
// stages of at most max_chunk of D. One buffer when one stage holds the
// whole slice of every row; two otherwise, the chunk as wide as fits. One
// owner of the columns (rank 0) with one tile where it fits, else kCluster.
__host__ inline int make_plan(int b, int d, long long ld, const void* f, int is_bf16, int shape,
                              int max_cols, int max_chunk, Plan* pl) {
  const int* sh = kShapes[shape];
  pl->rows = sh[0] * sh[1];
  pl->s = round_up((d + kCluster - 1) / kCluster, 4);
  const int tile = 32 * sh[0] * sh[4] * sh[2] * sh[3] / pl->rows / kCluster * kCluster;
  pl->tc = std::min({tile, round_up(b, kCluster),
                     std::max(kCluster, round_up(max_cols, kCluster))});
  pl->n_tiles = (b + pl->tc - 1) / pl->tc;
  pl->nparts = pl->n_tiles > 1 ? 2 : 1;
  pl->vec = !is_bf16 && reinterpret_cast<uintptr_t>(f) % 16 == 0 && ld % 4 == 0;
  const int cap = std::max(4, std::min(pl->s, max_chunk / 4 * 4));
  for (pl->owners = pl->n_tiles > 1 ? kCluster : 1; pl->owners <= kCluster;
       pl->owners *= kCluster) {
    pl->sc = cap;
    pl->pitch = pitch_of(pl->sc);
    pl->n_chunks = std::max(1, (pl->s + pl->sc - 1) / pl->sc);
    pl->nbuf = 1;
    if (pl->n_tiles == 1 && pl->n_chunks == 1 && smem_bytes(*pl) <= kMaxSmem) return 0;
    pl->nbuf = 2;
    for (; pl->sc >= 4; pl->sc -= 4) {
      pl->pitch = pitch_of(pl->sc);
      if (smem_bytes(*pl) <= kMaxSmem) {
        pl->n_chunks = std::max(1, (pl->s + pl->sc - 1) / pl->sc);
        return 0;
      }
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class T, int W, int RW, int RG, int CG, int M>
int launch(const T* x, const int* lab, float* ap, float* an, int* p, int* n, int b, int d,
           long long ld, const Plan& pl, bool floor, cudaStream_t stream) {
  using Kernel = void (*)(const T*, const int*, float*, float*, int*, int*, int, int,
                         long long, Plan);
  const Kernel kernel = floor ? empty_kernel<T> : batch_hard_kernel<T, W, RW, RG, CG, M>;
  const dim3 grid((b + pl.rows - 1) / pl.rows * kCluster);
  const size_t smem = smem_bytes(pl);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, W * 32, smem, stream>>>(x, lab, ap, an, p, n, b, d, ld, pl);
  return static_cast<int>(cudaGetLastError());
}

// one case a row of kShapes
template <class T>
int dispatch(const void* f, const void* labels, void* ap, void* an, void* p, void* n, int b,
             int d, long long ld, int shape, const Plan& pl, bool floor, void* stream) {
  const T* x = static_cast<const T*>(f);
  const int* lab = static_cast<const int*>(labels);
  float* ap_ = static_cast<float*>(ap);
  float* an_ = static_cast<float*>(an);
  int* p_ = static_cast<int*>(p);
  int* n_ = static_cast<int*>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0:
      return launch<T, 8, 1, 2, 1, 1>(x, lab, ap_, an_, p_, n_, b, d, ld, pl, floor, s);
    default:
      return launch<T, 16, 1, 8, 2, 1>(x, lab, ap_, an_, p_, n_, b, d, ld, pl, floor, s);
  }
}

// shape -1: shape_of(b)
int run(const void* f, const void* labels, void* ap, void* an, void* p, void* n, int b, int d,
        long long ld, int is_bf16, int max_cols, int max_chunk, int shape, bool floor,
        void* stream) {
  if (b <= 0) return 0;
  if (shape < 0 || shape > 1) shape = shape_of(b);
  Plan pl;
  const int rc = make_plan(b, d, ld, f, is_bf16, shape, max_cols, max_chunk, &pl);
  if (rc != 0) return rc;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(f, labels, ap, an, p, n, b, d, ld, shape, pl, floor, stream);
  return dispatch<float>(f, labels, ap, an, p, n, b, d, ld, shape, pl, floor, stream);
}

}  // namespace

extern "C" {

// f: b rows of d values (fp32, or bf16 when is_bf16), row i at f + i * ld,
// each row contiguous; labels: b int32; ap, an: b fp32; p, n: b int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success); b of 0
// launches nothing.
int mpreid_batch_hard(const void* f, const void* labels, void* ap, void* an, void* p, void* n,
                      int b, int d, long long ld, int is_bf16, void* stream) {
  return run(f, labels, ap, an, p, n, b, d, ld, is_bf16, 1 << 30, 1 << 30, -1, false, stream);
}

// mpreid_batch_hard at the kernel shape `shape` (0 or 1, or -1 for B's own),
// with tiles of at most max_cols columns and stages of at most max_chunk of
// D: every shape and the streamed paths at small B and D, for tests.
int mpreid_batch_hard_tiled(const void* f, const void* labels, void* ap, void* an, void* p,
                            void* n, int b, int d, long long ld, int is_bf16, int max_cols,
                            int max_chunk, int shape, void* stream) {
  return run(f, labels, ap, an, p, n, b, d, ld, is_bf16, max_cols, max_chunk, shape, false,
             stream);
}

// An empty kernel launched as mpreid_batch_hard launches its kernel (grid,
// cluster, block, dynamic shared memory, arguments): the floor of a
// launch-bound call.
int mpreid_batch_hard_floor(const void* f, const void* labels, void* ap, void* an, void* p,
                            void* n, int b, int d, long long ld, int is_bf16, void* stream) {
  return run(f, labels, ap, an, p, n, b, d, ld, is_bf16, 1 << 30, 1 << 30, -1, true, stream);
}

// Bytes of dynamic shared memory a block of mpreid_batch_hard takes at
// (b, d), or -1 where no cut fits.
long long mpreid_batch_hard_smem_bytes(int b, int d) {
  Plan pl;
  if (b <= 0 || make_plan(b, d, d, nullptr, 0, shape_of(b), 1 << 30, 1 << 30, &pl) != 0)
    return -1;
  return static_cast<long long>(smem_bytes(pl));
}

}  // extern "C"
