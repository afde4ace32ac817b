// What the kernel sources share: the tile side, the block size and a warp
// sum.  Each .cu file compiles on its own (one nvcc each, linked into one
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

}  // namespace
