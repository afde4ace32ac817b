// Single-direction tile-table products y = A x for Hopper (sm_90a), plain C
// interface.  They replace the Pallas TPU kernels
//   K4 fos_tpu/linalg/sparse_ell.py:_band_mv  (_band_mv_kernel), banded table
//   K5 fos_tpu/linalg/sparse_ell.py:_bell_mv  (_bell_mv_kernel), blocked-ELL
// and compute what they compute: f32 inputs, f32 products, f32 sums.  The
// operators run them over the A table for A x (mv) and over the A' table,
// packed the same way, for A' y (rmv); the set-feasibility solve's affine
// projection calls them 2 + 2k times per iteration (k CG iterations).
//
// What bounds them: the bytes of the stored tiles (K5 reads only the slots
// below counts[r]: the ELL A' table's rows are ragged and padded to kmax).
// x and y are 1/S of a row block's tile bytes.
//
// Design.  Unlike the pair (K2, K3), y = A x needs no sum across row
// blocks, so one CUDA block owns one row block: it walks the row block's
// tiles in slot order and writes its 128 outputs once.  No partial buffer,
// no second reduce kernel (the ~8 us fixed cost K2 pays per call), and the
// output repeats bit for bit by construction.  Warp w holds rows
// [16w, 16w + 16) of each tile; lane l loads columns [4l, 4l + 4) of each
// of those rows as one float4, so a warp reads a 512-byte row per load and
// the block keeps a whole 64 KB tile in flight.  Each lane carries its 16
// row partials across all the row block's tiles (fmaf, column order within
// the float4, tiles in slot order) and the warp sums them once at the end.
// With 256 row blocks (the 32768^2 tables) and ~2 resident blocks per SM
// every block is resident at once and each SM keeps 64-128 KB of tile
// loads in flight, more than HBM's latency-bandwidth product asks per SM,
// so the tiles of a row block are not split across blocks.  Simple and
// correct first: TMA, wgmma and persistent blocks are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kRows = kTile / kWarps;  // 16 tile rows per warp
constexpr int kVec = kTile / 4;        // float4s per tile row

struct BandWindow {                    // K4: tiles at columns cs[r] + s
  static constexpr int kCounter = 0;   // launch counter
  const int* cs;
  int S;
  __device__ int count(int) const { return S; }
  __device__ int col(int r, int s) const { return cs[r] + s; }
  __device__ int slots() const { return S; }
};

struct EllSlots {                      // K5: the first counts[r] slots
  static constexpr int kCounter = 1;
  const int* cols;
  const int* counts;
  int kmax;
  __device__ int count(int r) const { return counts[r]; }
  __device__ int col(int r, int s) const { return cols[(size_t)r * kmax + s]; }
  __device__ int slots() const { return kmax; }
};

// Block r: y[r, :] = sum over s < count(r) of blocks[r, s] @ xb[col(r, s)].
template <class Cols>
__global__ void __launch_bounds__(kThreads)
tile_mv(const float* __restrict__ blocks, Cols cols,
        const float* __restrict__ xb, float* __restrict__ y) {
  count_launch(Cols::kCounter);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x;
  const int row0 = warp * kRows;
  const int n = cols.count(r);
  const float4* base = reinterpret_cast<const float4*>(blocks) +
                       (size_t)r * cols.slots() * (kTile * kVec) +
                       (size_t)row0 * kVec + lane;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int s = 0; s < n; ++s) {
    const float4 xv = __ldg(
        reinterpret_cast<const float4*>(xb + (size_t)cols.col(r, s) * kTile) +
        lane);
    const float4* T = base + (size_t)s * (kTile * kVec);
    float4 a[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = __ldg(T + i * kVec);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i] = fmaf(a[i].x, xv.x, acc[i]);
      acc[i] = fmaf(a[i].y, xv.y, acc[i]);
      acc[i] = fmaf(a[i].z, xv.z, acc[i]);
      acc[i] = fmaf(a[i].w, xv.w, acc[i]);
    }
  }
  float out = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float v = warp_sum(acc[i]);
    if (lane == i) out = v;
  }
  if (lane < kRows) y[(size_t)r * kTile + row0 + lane] = out;
}

}  // namespace

extern "C" {

// Device launch counts of K4, K5 (read_launch_counts in common.cuh).
int fos_tile_mv_launch_counts(const long long* slots) {
  return read_launch_counts(slots);
}

// K4.  Record: 0 blocks (nrb, S, 128, 128), 1 cs (nrb,) with cs[r] + S <=
// rows of xb, 2 nrb, 3 S, 4 xb (>= max cs + S, 128), 5 y (nrb, 128),
// 6 stream.
int fos_band_mv(const long long* slots) {
  const Record a{slots};
  const BandWindow win{a.ptr<const int>(1), a.num(3)};
  tile_mv<BandWindow><<<a.num(2), kThreads, 0, a.stream(6)>>>(
      a.ptr<const float>(0), win, a.ptr<const float>(4), a.ptr<float>(5));
  return (int)cudaGetLastError();
}

// K5.  Record: 0 blocks (nrb, kmax, 128, 128), 1 cols (nrb, kmax),
// 2 counts (nrb,): slots at or past counts[r] are padding and are not
// read, 3 nrb, 4 kmax, 5 xb (ncb, 128) with every stored column < ncb,
// 6 y (nrb, 128), 7 stream.
int fos_bell_mv(const long long* slots) {
  const Record a{slots};
  const EllSlots ell{a.ptr<const int>(1), a.ptr<const int>(2), a.num(4)};
  tile_mv<EllSlots><<<a.num(3), kThreads, 0, a.stream(7)>>>(
      a.ptr<const float>(0), ell, a.ptr<const float>(5), a.ptr<float>(6));
  return (int)cudaGetLastError();
}

}  // extern "C"
