// What the kernel sources share: the tile side, the block size, a warp sum,
// the launch record and the launch counters.  Each .cu file compiles on its own (one nvcc each,
// linked into one library), so everything here has internal linkage.
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
constexpr int kCounters = 4;
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
