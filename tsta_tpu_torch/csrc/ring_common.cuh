// The protocol shared by the column-sharded wavefronts (psa_dp.cu,
// psa_dp_traced.cu): D co-resident blocks of one cooperative launch, block
// d owning a shard of columns; per row block, block d publishes an edge
// packet for block d+1 behind a release flag and block d+1 spins on it.
//
// * publish / wait_flag: the producer's __threadfence() and release
//   store, the consumer's acquire load with __nanosleep back-off.  Slots
//   are never reused, so no ack.
// * The watchdog: shard d's longest honest wait is the pipeline's fill,
//   d*T rows of the shards to its left.  A wait past wait_limit_ns, 20 s
//   plus (d+1)*T rows at 10 us + 2 us per column of a strip, is a fault,
//   not a schedule, so the block traps and the launch fails rather than
//   hangs.  A trap is sticky: the process's CUDA context is lost.
// * coresident_limit: a consumer spins on a producer that must be
//   running, so all D blocks must be resident at once; the host side
//   refuses a larger D without launching.
// * publish_system / wait_flag_system: the same protocol at system scope,
//   for a link between launches (the ring across cards and processes,
//   psa_dp.cu's linked build) whose packets and flags lie in mapped host
//   memory: __threadfence_system() and st.release.sys, ld.acquire.sys;
//   the reader then loads the packet words uncached (__ldcv), never
//   through L2.  The watchdog counts a shard's global index over every
//   card to its left.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace tsta {

// The watchdog's budget (ns): a fixed 20 s, and per row the left shards
// may still have to run, a fixed cost and one per column of a strip.
constexpr unsigned long long kWaitBaseNs = 20ull * 1000 * 1000 * 1000;
constexpr unsigned long long kRowNs = 10 * 1000;
constexpr unsigned long long kColNs = 2 * 1000;

// How long shard d may wait on its left neighbour's flag before it traps.
__host__ __device__ inline unsigned long long wait_limit_ns(int d, int T,
                                                            int W) {
  return kWaitBaseNs + (unsigned long long)(d + 1) * T * (kRowNs + W * kColNs);
}

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Make this thread's earlier stores (and, after a barrier, its block's)
// visible to the device, then set *flag.
__device__ __forceinline__ void publish(int32_t* flag) {
  __threadfence();
  st_release(flag, 1);
}

// Spin until *flag is set; trap past limit_ns.
__device__ __forceinline__ void wait_flag(const int32_t* flag,
                                          unsigned long long limit_ns) {
  unsigned ns = 32;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(flag) == 0) {
    __nanosleep(ns);
    if (ns < 256) ns <<= 1;
    if (global_ns() - t0 > limit_ns) __trap();
  }
}

__device__ __forceinline__ int ld_acquire_sys(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.sys.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(int32_t* p, int v) {
  asm volatile("st.release.sys.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// publish() for a reader on another card, in another process or on the
// host: this thread's earlier stores (to host memory too) visible to the
// system, then *flag set.
__device__ __forceinline__ void publish_system(int32_t* flag) {
  __threadfence_system();
  st_release_sys(flag, 1);
}

// wait_flag() on a flag in mapped host memory.
__device__ __forceinline__ void wait_flag_system(
    const int32_t* flag, unsigned long long limit_ns) {
  unsigned ns = 32;
  const unsigned long long t0 = global_ns();
  while (ld_acquire_sys(flag) == 0) {
    __nanosleep(ns);
    if (ns < 256) ns <<= 1;
    if (global_ns() - t0 > limit_ns) __trap();
  }
}

// The max of v over the block's kThreads threads, in every thread.
// s_warp holds kThreads / 32 ints.  Contains two __syncthreads().
template <int kThreads>
__device__ __forceinline__ int block_max(int v, int* s_warp) {
  constexpr int kWarps = kThreads / 32;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = max(v, __shfl_xor_sync(kFull, v, s));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = kNeg;
  for (int w = 0; w < kWarps; ++w) r = max(r, s_warp[w]);
  return r;
}

// The most blocks of `fn` (threads, smem bytes of dynamic shared memory)
// the current card holds resident at once, 0 without cooperative launch;
// a negative value is minus a CUDA error.
template <typename Kernel>
int coresident_limit(Kernel fn, int threads, size_t smem) {
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return -(int)rc;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                     smem);
  if (rc != cudaSuccess) return -(int)rc;
  return coop ? per_sm * sms : 0;
}

}  // namespace tsta
