// Fused Adam / AdamW update of one parameter leaf, or of a table of leaves,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/adam_kernel.py::_adam_kernel (launched by
// fused_adam_leaf) of the JAX package. One pass over the leaf: p, m, v and
// g are read once, and p, m and v are written back in place. Per element,
// in fp32 (the solver's per-leaf math, solver/optim.py::Optimizer.update):
//   g  = g + wd * p                          coupled L2 (Adam) only
//   m  = b1 * m + (1 - b1) * g
//   v  = b2 * v + (1 - b2) * (g * g)
//   st = lr * (m / bc1) / (sqrt(v / bc2) + eps)
//   st = st + (lr * wd) * p                  decoupled decay (AdamW) only
//   p  = p - st
// with lr = lr * per-leaf multiplier, bc1 = 1 - b1^t and bc2 = 1 - b2^t
// read from a device array of three fp32 values, [lr, bc1, bc2], as the TPU
// kernel reads them from SMEM: the step's scalars are formed on the device,
// so a CUDA graph that replays the update reads each step's own. lr * wd is
// formed here from lr with one rounded multiply. The step is taken with the
// fresh fp32 moments, and m and v are stored as fp32 or bf16 (rounded to
// nearest even). Each operation is rounded on its own (the _rn intrinsics:
// no fused multiply-add), so the kernel gives the plain PyTorch version's
// bits.
//
// Bound on an H100 SXM (3.35 TB/s): 28 bytes per element with fp32 moments
// (16 read, 12 written), 20 with bf16 moments, and about 15 flops, so it is
// bound by bytes: for c_fc (3072 x 768) 66.1 MB, about 19.7 us. The design
// moves exactly those bytes: each thread takes 8 consecutive elements with
// 16-byte vector loads and stores (two float4 of p, g and fp32 moments, one
// uint4 of 8 bf16 moments), a grid-stride loop covers the leaf, and a scalar
// tail takes the last n % 8 elements. Nothing is padded or copied.
//
// multi_adam_kernel updates a table of leaves in one launch (the solver's
// leaves that do not take the per-leaf kernel: ops/adam.py::adam_leaves).
// Each entry holds a leaf's p, m, v and g, its element count, its weight
// decay and its step scalars (one device array per lr multiplier). The
// table travels in the kernel's parameters (__grid_constant__, up to
// kMaxLeaves entries, under the 32,764 bytes sm_90 takes since CUDA 12.1),
// so a CUDA graph that captured the launch keeps its own copy and a step
// copies nothing to the device; a longer table is cut into the fewest
// launches that hold it. Every leaf is cut into chunks of kChunk elements,
// numbered across the table, one block a chunk (a block finds its leaf by
// binary search over the table), so a leaf of 768 elements is one small
// block and a large leaf is spread over the card. A chunk whose leaf's four
// pointers are 16-byte
// aligned takes the vector loads above, the rest of it the scalar path;
// any other chunk takes the scalar path. Each element goes through
// adam_one, the per-leaf kernel's own function, so both kernels give the
// same bits. Bound at the stage-2a leaf set (161 leaves, 87.5 M elements,
// fp32 moments): 2.45 GB, about 0.73 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr long long kMaxBlocks = 132 * 16;

struct Scalars {
  float b1, omb1, b2, omb2, eps, wd;
  int decoupled;
};

// the step's scalars, read once by every thread from the device array
struct StepScalars {
  float lr, bc1, bc2, lr_wd;
};

__device__ __forceinline__ void adam_one(float& p, float& m, float& v, float g, const Scalars& s,
                                         const StepScalars& t) {
  if (!s.decoupled) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, t.bc2)), s.eps);
  float step = __fdiv_rn(__fmul_rn(t.lr, __fdiv_rn(m, t.bc1)), den);
  if (s.decoupled) step = __fadd_rn(step, __fmul_rn(t.lr_wd, p));
  p = __fsub_rn(p, step);
}

__device__ __forceinline__ void load8(const float* src, float* x) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* x) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&words[k]);
    const float2 f = __bfloat1622float2(h);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* x) {
  uint32_t words[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    words[k] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

template <typename M>
__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, M* __restrict__ m, M* __restrict__ v,
            const float* __restrict__ g, long long n, const float* __restrict__ step_scalars,
            Scalars s) {
  const StepScalars t{step_scalars[0], step_scalars[1], step_scalars[2],
                      __fmul_rn(step_scalars[0], s.wd)};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nvec = n / kVec;
  for (long long i = tid; i < nvec; i += stride) {
    const long long o = i * kVec;
    float pv[kVec], mv[kVec], vv[kVec], gv[kVec];
    load8(p + o, pv);
    load8(m + o, mv);
    load8(v + o, vv);
    load8(g + o, gv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) adam_one(pv[k], mv[k], vv[k], gv[k], s, t);
    store8(p + o, pv);
    store8(m + o, mv);
    store8(v + o, vv);
  }
  for (long long i = nvec * kVec + tid; i < n; i += stride) {
    float pe = p[i], me = to_float(m[i]), ve = to_float(v[i]);
    adam_one(pe, me, ve, g[i], s, t);
    p[i] = pe;
    from_float(me, m + i);
    from_float(ve, v + i);
  }
}

template <typename M>
int launch(void* p, void* m, void* v, const void* g, long long n, const float* step_scalars,
           const Scalars& s, cudaStream_t stream) {
  long long blocks = (n / kVec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adam_kernel<M><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<float*>(p), static_cast<M*>(m), static_cast<M*>(v),
      static_cast<const float*>(g), n, step_scalars, s);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kChunk = kThreads * kVec * 2;  // elements of a chunk
constexpr int kMaxLeaves = 448;             // leaves of a launch's table
constexpr long long kMaxGrid = (1LL << 31) - 1;

template <typename M>
struct Leaf {
  float* p;
  M* m;
  M* v;
  const float* g;
  const float* step_scalars;  // [lr * multiplier, 1 - b1^t, 1 - b2^t]
  long long n;
  long long end;  // chunks of this leaf and of every leaf before it in the table
  float wd;
};

template <typename M>
struct Table {
  Leaf<M> leaf[kMaxLeaves];
  int count;
};

static_assert(sizeof(Table<float>) + sizeof(Scalars) <= 32764,
              "the table must fit in a kernel's parameters");

template <typename M>
__global__ void __launch_bounds__(kThreads)
multi_adam_kernel(const __grid_constant__ Table<M> table, const Scalars common) {
  const long long chunks = table.leaf[table.count - 1].end;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    int l = 0, hi = table.count - 1;  // the first leaf whose chunks end past c
    while (l < hi) {
      const int mid = (l + hi) / 2;
      if (table.leaf[mid].end > c) hi = mid;
      else l = mid + 1;
    }
    const Leaf<M>& leaf = table.leaf[l];
    const long long first = l ? table.leaf[l - 1].end : 0;
    const long long o = (c - first) * kChunk;
    const int count = static_cast<int>(min(static_cast<long long>(kChunk), leaf.n - o));
    float* p = leaf.p + o;
    M* m = leaf.m + o;
    M* v = leaf.v + o;
    const float* g = leaf.g + o;
    Scalars s = common;
    s.wd = leaf.wd;
    const float* ss = leaf.step_scalars;
    const StepScalars t{ss[0], ss[1], ss[2], __fmul_rn(ss[0], leaf.wd)};
    const uintptr_t bits =
        reinterpret_cast<uintptr_t>(leaf.p) | reinterpret_cast<uintptr_t>(leaf.m) |
        reinterpret_cast<uintptr_t>(leaf.v) | reinterpret_cast<uintptr_t>(leaf.g);
    const int nvec = bits % 16 ? 0 : count / kVec;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const int e = i * kVec;
      float pv[kVec], mv[kVec], vv[kVec], gv[kVec];
      load8(p + e, pv);
      load8(m + e, mv);
      load8(v + e, vv);
      load8(g + e, gv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) adam_one(pv[k], mv[k], vv[k], gv[k], s, t);
      store8(p + e, pv);
      store8(m + e, mv);
      store8(v + e, vv);
    }
    for (int i = nvec * kVec + threadIdx.x; i < count; i += kThreads) {
      float pe = p[i], me = to_float(m[i]), ve = to_float(v[i]);
      adam_one(pe, me, ve, g[i], s, t);
      p[i] = pe;
      from_float(me, m + i);
      from_float(ve, v + i);
    }
  }
}

template <typename M>
int launch_table(const Table<M>& table, const Scalars& s, cudaStream_t stream) {
  long long blocks = table.leaf[table.count - 1].end;  // a block a chunk
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  multi_adam_kernel<M><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(table, s);
  return static_cast<int>(cudaGetLastError());
}

// the leaves of positive size, kMaxLeaves a launch
template <typename M>
int launch_leaves(int count, void* const* p, void* const* m, void* const* v,
                  const void* const* g, const void* const* step_scalars, const long long* n,
                  const float* wd, const Scalars& s, cudaStream_t stream, int* launches) {
  Table<M> table;
  table.count = 0;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) continue;
    chunks += (n[i] + kChunk - 1) / kChunk;
    table.leaf[table.count++] = Leaf<M>{
        static_cast<float*>(p[i]), static_cast<M*>(m[i]), static_cast<M*>(v[i]),
        static_cast<const float*>(g[i]), static_cast<const float*>(step_scalars[i]), n[i],
        chunks, wd[i]};
    if (table.count == kMaxLeaves) {
      if (const int rc = launch_table(table, s, stream)) return rc;
      ++*launches;
      table.count = 0;
      chunks = 0;
    }
  }
  if (table.count == 0) return 0;
  if (const int rc = launch_table(table, s, stream)) return rc;
  ++*launches;
  return 0;
}

}  // namespace

extern "C" {

// p and g are contiguous fp32 arrays of n elements; m and v are contiguous
// arrays of n fp32 (moments_bf16 = 0) or bf16 (moments_bf16 = 1) elements;
// all four are 16-byte aligned. p, m and v are updated in place.
// step_scalars is a device array of three fp32 values, [lr * multiplier,
// 1 - b1^t, 1 - b2^t], read when the kernel runs. omb1 and omb2 are 1 - b1
// and 1 - b2, rounded to fp32 by the caller. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mpreid_adam(void* p, void* m, void* v, const void* g, long long n, int moments_bf16,
                const void* step_scalars, float b1, float omb1, float b2, float omb2,
                float eps, float wd, int decoupled, void* stream) {
  if (n <= 0) return 0;
  const Scalars s{b1, omb1, b2, omb2, eps, wd, decoupled};
  const float* t = static_cast<const float*>(step_scalars);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return moments_bf16 ? launch<__nv_bfloat16>(p, m, v, g, n, t, s, st)
                      : launch<float>(p, m, v, g, n, t, s, st);
}

// The same update over `count` leaves in as few launches as hold them
// (kMaxLeaves leaves a launch; leaves of no elements are skipped). Entry i
// is leaf i: p[i], m[i], v[i], g[i] as mpreid_adam's (any alignment of
// their element types), n[i] elements, weight decay wd[i] and its step
// scalars step_scalars[i]; the moments of every leaf are fp32
// (moments_bf16 = 0) or bf16 (1). The other arguments are mpreid_adam's.
// Adds the launches made to *launches and returns cudaGetLastError() (0 on
// success).
int mpreid_adam_leaves(int count, void* const* p, void* const* m, void* const* v,
                       const void* const* g, const void* const* step_scalars, const long long* n,
                       const float* wd, int moments_bf16, float b1, float omb1, float b2,
                       float omb2, float eps, int decoupled, void* stream, int* launches) {
  const Scalars s{b1, omb1, b2, omb2, eps, 0.0f, decoupled};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return moments_bf16
             ? launch_leaves<__nv_bfloat16>(count, p, m, v, g, step_scalars, n, wd, s, st, launches)
             : launch_leaves<float>(count, p, m, v, g, step_scalars, n, wd, s, st, launches);
}

}  // extern "C"
