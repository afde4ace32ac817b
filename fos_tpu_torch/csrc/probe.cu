// Launch-cost probes for Hopper (sm_90a), plain C interface.  They replace
// the Pallas TPU probes of tools/launch_probe.py:
//   P1 tiny (kernel k):  y = x * 1.0000001 on one (8, 128) f32 tile, grid 1;
//   P2 pref (kernel k3): the same with one scalar-prefetch operand.
//
// What bounds them: nothing the data asks for (8 KB in, 8 KB out); their
// time is the cost of one launch, which is what they exist to measure
// (fos_tpu_torch.tools.launch_probe).  So they are as small as a kernel
// can be: one block of 256 threads, four elements each.
//
// Scalar prefetch has no CUDA counterpart: a block loads its own indices.
// P2's block loads its (8,) int32 operand from device memory into shared
// memory (volatile, so the load is not optimised away) before its body;
// the result does not depend on the operand.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ void scale(const float* __restrict__ x,
                                      float* __restrict__ y, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = x[i] * 1.0000001f;
}

__global__ void __launch_bounds__(kThreads)
probe_tiny(const float* __restrict__ x, float* __restrict__ y, int n) {
  scale(x, y, n);
}

__global__ void __launch_bounds__(kThreads)
probe_prefetch(const int* __restrict__ idx, int nidx,
               const float* __restrict__ x, float* __restrict__ y, int n) {
  __shared__ volatile int pre[kThreads];
  if (threadIdx.x < nidx) pre[threadIdx.x] = idx[threadIdx.x];
  __syncthreads();
  scale(x, y, n);
}

}  // namespace

extern "C" {

// P1.  Record: 0 n, 1 x (n,) f32, 2 y (n,) f32, 3 stream.
int fos_probe_tiny(const long long* slots) {
  const Record a{slots};
  probe_tiny<<<1, kThreads, 0, a.stream(3)>>>(a.ptr<const float>(1),
                                              a.ptr<float>(2), a.num(0));
  return (int)cudaGetLastError();
}

// P2.  Record: 0 n, 1 nidx (<= 256), 2 idx (nidx,) int32, 3 x (n,) f32,
// 4 y (n,) f32, 5 stream.
int fos_probe_prefetch(const long long* slots) {
  const Record a{slots};
  probe_prefetch<<<1, kThreads, 0, a.stream(5)>>>(
      a.ptr<const int>(2), a.num(1), a.ptr<const float>(3), a.ptr<float>(4),
      a.num(0));
  return (int)cudaGetLastError();
}

}  // extern "C"
