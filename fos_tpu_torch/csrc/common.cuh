// What the kernel sources share: the tile side, the block size, a warp
// sum, asynchronous copies, the launch record and the launch counters.
// Each .cu file compiles on its own (one nvcc each, linked into one
// library), so everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // sparse tile side; dense column tile
constexpr int kThreads = 256;  // 8 warps per block

// Sum of v over the warp's 32 lanes, the same on every lane; the adds run
// in a fixed butterfly order, so the result repeats bit for bit.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One step of a warp sum of many values at once: lanes with bit h of their
// index keep the upper kHalf of v, the others the lower kHalf, and each
// kept value gets its partner lane's copy added (own value first).  Every
// add is the one warp_sum's step h makes for that value on that lane, so
// after the steps 16, 8, 4, 2 (and 1) each value's total has warp_sum's
// bits; a lane ends holding the values whose index bits match its own.
// N values take N - 1 shuffles down to one a lane where warp_sum takes 5 N.
template <int kHalf>
__device__ __forceinline__ void trade_halves(float* v, int lane, int h) {
  const bool up = lane & h;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? v[i] : v[i + kHalf];
    const float keep = up ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, h);
  }
}

// Asynchronous copies into shared memory.  cp_async16 copies one thread's
// 16 bytes (cp.async); a thread's copies complete at cp_async_wait_all
// after cp_async_commit, or signal an mbarrier (cp_async_arrive).  Bulk
// copies (the tensor memory accelerator) complete on an mbarrier
// (mbar_init: the arrivals a phase takes, one by default): one thread
// declares a phase's bytes with mbar_expect_tx, after a proxy fence (the
// block has read what the copies overwrite), then bulk_copy moves 16-byte
// multiples between 16-byte aligned addresses, and mbar_wait returns once
// the phase of the given parity is complete.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned arrivals = 1) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], %1;\n"
      "fence.mbarrier_init.release.cluster;" ::"r"(smem_addr(bar)),
      "r"(arrivals)
      : "memory");
}

// One arrival on bar's current phase.
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// An arrival on bar's current phase once this thread's cp.async copies
// issued so far have landed (counted among the phase's arrivals).
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A launch record: the int64 slots an entry point reads, in the order its
// comment lists (pointers and sizes, the stream last).  The caller keeps
// one record per bound kernel and rewrites only the per-call slots, so a
// launch is one foreign call with one argument (linalg/_cuda.py).
struct Record {
  const long long* s;
  template <class T>
  T* ptr(int i) const { return reinterpret_cast<T*>(s[i]); }
  int num(int i) const { return static_cast<int>(s[i]); }
  cudaStream_t stream(int i) const {
    return reinterpret_cast<cudaStream_t>(s[i]);
  }
};

// Launches counted on the device.  A CUDA graph replays its kernels without
// calling their wrappers, so the wrappers' host counts (linalg/_cuda.py)
// say only that a kernel was captured; each counted kernel also adds one
// here (thread 0 of block 0), once per launch, replayed or not.  Each
// source file has its own counters and an entry point that reads them.
constexpr int kCounters = 10;
__device__ unsigned long long launch_count[kCounters];

__device__ __forceinline__ void count_launch(int id) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)
    atomicAdd(&launch_count[id], 1ull);
}

// Record: 0 host address of kCounters uint64 that receive the counts,
// 1 nonzero to zero them after reading.  Synchronous (tests, chip_smoke).
inline int read_launch_counts(const long long* s) {
  cudaError_t e = cudaMemcpyFromSymbol(reinterpret_cast<void*>(s[0]),
                                       launch_count, sizeof(launch_count));
  if (e == cudaSuccess && s[1]) {
    const unsigned long long zero[kCounters] = {};
    e = cudaMemcpyToSymbol(launch_count, zero, sizeof(launch_count));
  }
  return (int)e;
}

}  // namespace
