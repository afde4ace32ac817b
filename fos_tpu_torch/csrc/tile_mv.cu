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
//
// K4, K5 over lanes (the line search's 31 candidate steps through the
// feasibility projection's CG, which the JAX package runs as a vmap over
// the pallas_call): y_b = A x_b for L lanes, each tile read from memory
// once for all of them.  A warp carries kLaneRows rows of a row block
// through its tiles in slot order with the accumulators of kLaneGroup
// lanes, lane l loading the same float4 columns as tile_mv; the lane
// groups of those rows run in the block's other warps at the same time,
// which read the tile rows again from L1, not from memory.  A row
// block's tasks are dealt to kLaneSplit blocks, so that the long rows of
// a ragged table (the scattered LP's A') do not leave the other SMs idle
// at the end (PERF.md has the times).  Each (lane, row) keeps tile_mv's
// order: the fmaf chain over the slots and the four columns, then the
// warp's butterfly (trade_halves: a task's 64 sums in 62 shuffles), so
// lane b is bit-equal to a single call on x_b.  At L lanes the work is
// 2 L flops per tile entry: past ~40 lanes the f32 rate, not the tiles'
// bytes, bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kRows = kTile / kWarps;  // 16 tile rows per warp
constexpr int kVec = kTile / 4;        // float4s per tile row

struct BandWindow {                    // K4: tiles at columns cs[r] + s
  static constexpr int kCounter = 0;   // launch counter
  static constexpr int kLaneCounter = 2;  // of the lane kernel
  const int* cs;
  int S;
  __device__ int count(int) const { return S; }
  __device__ int col(int r, int s) const { return cs[r] + s; }
  __device__ int slots() const { return S; }
};

struct EllSlots {                      // K5: the first counts[r] slots
  static constexpr int kCounter = 1;
  static constexpr int kLaneCounter = 3;
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

constexpr int kLaneRows = 8;    // rows a warp carries through the slots
constexpr int kLaneGroup = 8;   // lanes those rows are carried for
constexpr int kLaneSums = kLaneRows * kLaneGroup;
constexpr int kLaneSplit = 4;   // blocks a row block's tasks are dealt to
static_assert(kLaneSums == 64, "the trade_halves steps below take 64 sums");

// Blocks (r, 0..kLaneSplit-1): Y[b, r, :] = sum over s < count(r) of
// blocks[r, s] @ X_b[col(r, s)] for every lane b < lanes (lane b's x at
// xb + b ldx, its y at y + b ldy).  A warp's task is kLaneRows rows for
// kLaneGroup lanes; the lane groups of one chunk of rows are consecutive
// tasks, so they run side by side in a block's warps and all but the
// first read the chunk's tile rows from L1.  The tasks of a row block are
// dealt to kLaneSplit blocks, so a long row of a ragged table is spread
// over several SMs; two blocks fit an SM (128 registers).
template <class Cols>
__global__ void __launch_bounds__(kThreads, 2)
tile_mv_lanes(const float* __restrict__ blocks, Cols cols, int lanes,
              const float* __restrict__ xb, long long ldx,
              float* __restrict__ y, long long ldy) {
  count_launch(Cols::kLaneCounter);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x;
  const int n = cols.count(r);
  const float4* base = reinterpret_cast<const float4*>(blocks) +
                       (size_t)r * cols.slots() * (kTile * kVec) + lane;
  const int groups = (lanes + kLaneGroup - 1) / kLaneGroup;
  const int tasks = (kTile / kLaneRows) * groups;
  for (int task = warp + blockIdx.y * kWarps; task < tasks;
       task += kWarps * kLaneSplit) {
    const int i0 = task / groups * kLaneRows, l0 = task % groups * kLaneGroup;
    const int nl = min(kLaneGroup, lanes - l0);
    const float* xl = xb + l0 * ldx + 4 * lane;
    float acc[kLaneSums];  // acc[i * kLaneGroup + b]: row i0 + i, lane l0 + b
#pragma unroll
    for (int k = 0; k < kLaneSums; ++k) acc[k] = 0.f;
    for (int s = 0; s < n; ++s) {
      const float4* T = base + (size_t)s * (kTile * kVec) + (size_t)i0 * kVec;
      const float* xs = xl + (size_t)cols.col(r, s) * kTile;
      float4 a[kLaneRows];
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i) a[i] = __ldg(T + i * kVec);
#pragma unroll
      for (int b = 0; b < kLaneGroup; ++b) {
        const float4 xv =
            b < nl ? __ldg(reinterpret_cast<const float4*>(xs + b * ldx))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i) {
          float& c = acc[i * kLaneGroup + b];
          c = fmaf(a[i].x, xv.x, c);
          c = fmaf(a[i].y, xv.y, c);
          c = fmaf(a[i].z, xv.z, c);
          c = fmaf(a[i].w, xv.w, c);
        }
      }
    }
    // lane l ends with the sums 2l and 2l + 1
    trade_halves<32>(acc, lane, 16);
    trade_halves<16>(acc, lane, 8);
    trade_halves<8>(acc, lane, 4);
    trade_halves<4>(acc, lane, 2);
    trade_halves<2>(acc, lane, 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 2 * lane + j, b = k % kLaneGroup, i = k / kLaneGroup;
      if (b < nl) y[(l0 + b) * ldy + (size_t)r * kTile + i0 + i] = acc[j];
    }
  }
}

}  // namespace

extern "C" {

// Device launch counts of K4, K5 and their lane kernels
// (read_launch_counts in common.cuh).
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

// K4 over L lanes.  Record: 0 blocks, 1 cs, 2 nrb, 3 S (as fos_band_mv),
// 4 L (1..), 5 XB (lane b's xb at XB + b ldx: 16-byte aligned, ldx a
// multiple of 4), 6 ldx, 7 Y (L, nrb, 128), 8 stream.
int fos_band_mv_lanes(const long long* slots) {
  const Record a{slots};
  const BandWindow win{a.ptr<const int>(1), a.num(3)};
  tile_mv_lanes<BandWindow>
      <<<dim3(a.num(2), kLaneSplit), kThreads, 0, a.stream(8)>>>(
      a.ptr<const float>(0), win, a.num(4), a.ptr<const float>(5), slots[6],
      a.ptr<float>(7), (long long)a.num(2) * kTile);
  return (int)cudaGetLastError();
}

// K5 over L lanes.  Record: 0 blocks, 1 cols, 2 counts, 3 nrb, 4 kmax (as
// fos_bell_mv), 5 L, 6 XB, 7 ldx (as fos_band_mv_lanes), 8 Y (L, nrb,
// 128), 9 stream.
int fos_bell_mv_lanes(const long long* slots) {
  const Record a{slots};
  const EllSlots ell{a.ptr<const int>(1), a.ptr<const int>(2), a.num(4)};
  tile_mv_lanes<EllSlots>
      <<<dim3(a.num(3), kLaneSplit), kThreads, 0, a.stream(9)>>>(
      a.ptr<const float>(0), ell, a.num(5), a.ptr<const float>(6), slots[7],
      a.ptr<float>(8), (long long)a.num(3) * kTile);
  return (int)cudaGetLastError();
}

}  // extern "C"
