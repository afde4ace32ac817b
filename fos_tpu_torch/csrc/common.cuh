// What the kernel sources share: the tile side, the block size, a warp sum
// and the launch record.  Each .cu file compiles on its own (one nvcc each,
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

}  // namespace
