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

// P1.  x, y (n,) f32.
int fos_probe_tiny(const float* x, float* y, int n, void* stream) {
  probe_tiny<<<1, kThreads, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

// P2.  idx (nidx,) int32 with nidx <= 256; x, y (n,) f32.
int fos_probe_prefetch(const int* idx, int nidx, const float* x, float* y,
                       int n, void* stream) {
  probe_prefetch<<<1, kThreads, 0, (cudaStream_t)stream>>>(idx, nidx, x, y,
                                                           n);
  return (int)cudaGetLastError();
}

}  // extern "C"
