// Launch-cost probes for Hopper (sm_90a), plain C interface.  They replace
// the Pallas TPU probes of tools/launch_probe.py:
//   P1 probe_tiny, for `tiny` (launch_probe.py:55, kernel k):
//      y = x * 1.0000001 on one (8, 128) f32 tile, grid 1;
//   P2 probe_prefetch, for `pref` (launch_probe.py:68, kernel k3): the same
//      with one (8,) int32 scalar-prefetch operand.
//
// What bounds them: nothing the data asks for.  4 KB in and 4 KB out take
// ~0.0025 us at 3.35 TB/s; what is left is the launch and one round trip to
// memory, and the launch is what they exist to measure
// (fos_tpu_torch.tools.launch_probe).  So a probe's body may cost no more
// than the cheapest elementwise kernel's: one load and one store a thread,
// all of a thread's loads in flight at once.
//
// Design.  One thread per 16-byte vector: a block of 256 threads covers the
// tile with one `float4` load on the read-only path and one `float4` store
// each, with no loop (of 1, 2 and 4 vectors a thread, timed in turns, 1
// was the fastest; PERF.md).  A contiguous tile may start at any 4-byte
// offset, and the last vector may be ragged (n % 4): such a vector is four
// scalar loads, all in flight before the stores.  A longer x launches more
// blocks.
//
// Scalar prefetch has no CUDA counterpart: a block loads its own indices.
// The TPU kernel's index maps ignore the prefetched operand
// (`lambda i, s: (i * 0, i * 0)`), so nothing in P2's body depends on it:
// each thread starts its index load together with its tile load, stores the
// tile, and only then writes the index to shared memory (volatile, so the
// load cannot be dropped).  Nothing reads the index back, so there is no
// barrier, and the index's round trip overlaps the tile's.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float kScale = 1.0000001f;

__device__ __forceinline__ bool aligned16(const void* x, const void* y) {
  return ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
          15) == 0;
}

// Elements 4v .. 4v + 3 of x, those below n (the others 0).
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int v,
                                        int n, bool aligned) {
  const int i = 4 * v;
  if (aligned && i + 4 <= n)
    return __ldg(reinterpret_cast<const float4*>(x) + v);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n) a.x = __ldg(x + i);
  if (i + 1 < n) a.y = __ldg(x + i + 1);
  if (i + 2 < n) a.z = __ldg(x + i + 2);
  if (i + 3 < n) a.w = __ldg(x + i + 3);
  return a;
}

// y[4v .. 4v + 3] = a * kScale, the elements below n: one f32 rounding each.
__device__ __forceinline__ void store4(float* __restrict__ y, int v, int n,
                                       bool aligned, float4 a) {
  a = make_float4(a.x * kScale, a.y * kScale, a.z * kScale, a.w * kScale);
  const int i = 4 * v;
  if (aligned && i + 4 <= n) {
    reinterpret_cast<float4*>(y)[v] = a;
    return;
  }
  if (i < n) y[i] = a.x;
  if (i + 1 < n) y[i + 1] = a.y;
  if (i + 2 < n) y[i + 2] = a.z;
  if (i + 3 < n) y[i + 3] = a.w;
}

__global__ void __launch_bounds__(kThreads)
probe_tiny(const float* __restrict__ x, float* __restrict__ y, int n) {
  const bool aligned = aligned16(x, y);
  const int v = blockIdx.x * kThreads + threadIdx.x;  // this thread's vector
  store4(y, v, n, aligned, load4(x, v, n, aligned));
}

__global__ void __launch_bounds__(kThreads)
probe_prefetch(const int* __restrict__ idx, int nidx,
               const float* __restrict__ x, float* __restrict__ y, int n) {
  __shared__ volatile int pre[kThreads];
  const bool aligned = aligned16(x, y);
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int j = threadIdx.x;
  const int p = j < nidx ? __ldg(idx + j) : 0;
  const float4 a = load4(x, v, n, aligned);
  store4(y, v, n, aligned, a);
  if (j < nidx) pre[j] = p;
}

// One block per kThreads vectors, at least one.
inline int probe_blocks(int n) {
  const int vectors = (n + 3) / 4;
  return vectors > kThreads ? (vectors + kThreads - 1) / kThreads : 1;
}

}  // namespace

extern "C" {

// P1.  Record: 0 n, 1 x (n,) f32, 2 y (n,) f32, 3 stream.
int fos_probe_tiny(const long long* slots) {
  const Record a{slots};
  const int n = a.num(0);
  probe_tiny<<<probe_blocks(n), kThreads, 0, a.stream(3)>>>(
      a.ptr<const float>(1), a.ptr<float>(2), n);
  return (int)cudaGetLastError();
}

// P2.  Record: 0 n, 1 nidx (<= 256), 2 idx (nidx,) int32, 3 x (n,) f32,
// 4 y (n,) f32, 5 stream.
int fos_probe_prefetch(const long long* slots) {
  const Record a{slots};
  const int n = a.num(0);
  probe_prefetch<<<probe_blocks(n), kThreads, 0, a.stream(5)>>>(
      a.ptr<const int>(2), a.num(1), a.ptr<const float>(3), a.ptr<float>(4),
      n);
  return (int)cudaGetLastError();
}

}  // extern "C"
