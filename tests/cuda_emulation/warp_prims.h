// Host emulation of the inline-PTX primitives of kernels/csrc/mma_bf16.cuh,
// spliced into a copy of that header in place of the asm versions. Each
// warp-wide step puts every lane's operands on the table, waits for the
// warp, computes this lane's share as the PTX ISA defines it, and waits
// again before the table is reused.

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  std::memcpy(dst, src, 16);
}

__device__ __forceinline__ void cp_async_wait_all() {}

inline float emu_lo(uint32_t w) { return __bfloat162float({uint16_t(w & 0xffff)}); }
inline float emu_hi(uint32_t w) { return __bfloat162float({uint16_t(w >> 16)}); }

// ldmatrix .x4: lane i gives row i % 8 of matrix i / 8; lane 4g + t gets
// (row g, cols 2t, 2t+1) of each matrix, or with .trans (rows 2t, 2t+1, col g).
inline void emu_ldmatrix(uint32_t r[4], const bf16* p, bool trans) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  emu::slots[w][lane].p = p;
  emu::warp_sync();
  for (int m = 0; m < 4; ++m) {
    const bf16* a;
    const bf16* b;
    if (!trans) {
      a = static_cast<const bf16*>(emu::slots[w][8 * m + g].p) + 2 * t;
      b = a + 1;
    } else {
      a = static_cast<const bf16*>(emu::slots[w][8 * m + 2 * t].p) + g;
      b = static_cast<const bf16*>(emu::slots[w][8 * m + 2 * t + 1].p) + g;
    }
    r[m] = uint32_t(a->x) | (uint32_t(b->x) << 16);
  }
  emu::warp_sync();
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  emu_ldmatrix(r, p, false);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  emu_ldmatrix(r, p, true);
}

// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, c += a b
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  emu::Slot& mine = emu::slots[w][lane];
  for (int i = 0; i < 4; ++i) mine.a[i] = a[i];
  mine.b[0] = b0;
  mine.b[1] = b1;
  emu::warp_sync();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int gg = l / 4, tt = l % 4;
    const emu::Slot& o = emu::slots[w][l];
    for (int i = 0; i < 4; ++i) {
      const int row = gg + 8 * (i & 1), col = 2 * tt + 8 * (i >> 1);
      A[row][col] = emu_lo(o.a[i]);
      A[row][col + 1] = emu_hi(o.a[i]);
    }
    for (int i = 0; i < 2; ++i) {
      B[2 * tt + 8 * i][gg] = emu_lo(o.b[i]);
      B[2 * tt + 8 * i + 1][gg] = emu_hi(o.b[i]);
    }
  }
  emu::warp_sync();
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = 0.f;
    for (int k = 0; k < 16; ++k) acc += A[row][k] * B[k][col];
    c[e] += acc;
  }
}
