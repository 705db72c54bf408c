// Thread-block clusters and asynchronous copies on Hopper (sm_90a), as small
// functions over inline PTX, used by batch_hard.cu.
//
// A cluster is a group of blocks (up to 8 portably) that run at once on
// neighbouring SMs. Each block of it can read and write the shared memory of
// the others (distributed shared memory): cluster_map turns the address of a
// variable in this block's shared memory into the generic address of the
// same variable in the block of the given rank, and plain loads and stores
// through that address reach it. cluster_sync is a barrier over every thread
// of every block of the cluster, with release / acquire semantics: what a
// thread wrote to any block's shared memory before it is visible to every
// thread of the cluster after it. A block's shared memory lives as long as
// the block, so no block may exit while another may still touch it.
//
// cp_async_16 issues a 16-byte copy from device to shared memory that
// completes in the background; cp_async_commit closes a group of such
// copies; cp_async_wait_prior waits for every group but the newest,
// cp_async_wait_all for all of them. The copies of a thread are visible to
// the other threads of the block after the wait and a __syncthreads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cluster {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// This block's rank in its cluster, 0 .. cluster size - 1.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Barrier over every thread of the cluster; orders shared-memory accesses
// across its blocks.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The generic address of *p in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ float* cluster_map(float* p, unsigned rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<float*>(out);
}

// 16-byte asynchronous copy, device memory -> shared memory.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Closes the group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every committed group but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Waits for every committed group.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace cluster
