// Fused (A @ x, A' @ z) pair kernels for Hopper (sm_90a), plain C interface.
//
// Every HSDE outer iteration spends its time in this pair: each CG step of
// the affine projection applies Q twice, and each Q is one (A x, A' z) pair
// plus rank-1 terms.  The three kernels here replace the Pallas TPU kernels
//   K1 fos_tpu/linalg/pallas_kernels.py:fused_matvec  (_fused_kernel), dense A
//   K2 fos_tpu/linalg/sparse_ell.py:_band_mv_pair     (_band_mv_pair_kernel)
//   K3 fos_tpu/linalg/sparse_ell.py:_bell_mv_pair     (_bell_mv_pair_kernel)
// and compute what they compute: f32 inputs, f32 products and f32 sums.
//
// What bounds them on the card: the bytes of A (K1) or of the tile table
// (K2, K3), at about 0.5 flop per byte, so no tensor cores.  Each element
// is read once, coalesced, and reduced both ways while it is in registers:
// along the row for A x, along the column for A' z.  The vectors and the
// partial sums are a few percent of those bytes.  A dense A of up to
// ~40 MB stays in the 50 MB L2 from one call to the next (the 1000^2 LP's
// is 4 MB); there the floor is a chain of dependent L2 round trips and the
// launches, not HBM.
//
// K1, two launches.  The tile kernel: one 256-thread block per 32x128
// tile of A (8 warps x 4 rows; ragged edges masked), so a 1000^2 A gives
// 256 blocks on the 132 SMs and a 4000^2 A 4000; each thread issues its
// 16 loads at once.  Each tile writes its two vectors to partial buffers
// (A_ij x_j for row tile i, A_ij' z_i for column tile j).  A warp's four
// row dots are summed together (rows_sum): 6 shuffles where four
// butterflies take 20, adding the same pairs, so with the same bits.  The
// sum kernel adds each output's partials in an order fixed by the shapes:
// a block takes 32 consecutive outputs, each warp sums one contiguous
// range of their partials (a warp's loads read 32 consecutive floats),
// and the range sums are added in warp order.  It is launched as a
// programmatic dependent of the tile kernel (Hopper's programmatic
// dependent launch): the tile blocks release it as soon as their loads
// are issued and its blocks wait on the device for the tiles' writes, so
// its launch and ramp, which at 1000^2 took as long as its work, overlap
// the tiles.  Taller tiles (64, 128 rows) give fewer partials but fewer
// blocks and more loads per thread; 16-row tiles double the partials; 32
// rows measured fastest at 1000^2 and 4000^2 (PERF.md, Findings).  The
// partial buffers are the caller's; nothing else persists between calls,
// so a call can be captured in a CUDA graph.  A one-launch variant (the
// last block to arrive sums each strip; arrival counters and a release
// fence) measured slower on the H100: the fence and the counters' round
// trips cost more than the kernel boundary they replace.
//
// K1 over lanes (the line search's 31 candidate steps, which the JAX
// package runs as a vmap over the pallas_call): the same tiles, partials
// and sums with a lane axis.  A tile block reads its A tile from memory
// once into registers, as dense_pair_tiles does, and runs every lane's
// vectors through it: it stages the vectors of 32 lanes in shared memory
// with one round of loads (a load per lane per round kept each round
// waiting on memory), and takes 4 lanes per shared-memory round of column
// totals.  The sum is one thread per output of each lane, with no shared
// memory.  Each lane's partials and sums are the single-vector kernels',
// in the same order, so lane b is bit-equal to a single call on lane b's
// vectors.  At B lanes the work is 4 B M N flops over 4 M N bytes of A:
// past ~20 lanes the f32 rate, not A's bytes, bounds it.  A design where
// one warp holds a whole 32x128 tile (no shared-memory exchange per lane)
// took 234 registers and a stack frame and ran slower (PERF.md).
//
// K2, K3 (unchanged design): one CUDA block per stored 128x128 tile;
// each tile writes its two 128-vectors to partial buffers, and a second,
// small kernel sums the partials of each output in a fixed order (over a
// row block's tiles for y1, and over the tiles that land in a column block
// for y2, listed by an inverse table built once on the host).
//
// K2, K3 over lanes (the line search's 31 candidate steps through the
// HSDE projection's CG, a vmap over the pallas_call in the JAX package):
// at L lanes the work is 4 L flops per tile entry over the tile's 4 bytes,
// so past ~20 lanes the f32 rate, not the table's bytes, bounds it, and
// what counts is the instructions issued beside the FMAs.  One block per
// row block walks its tiles in slot order: each tile comes into shared
// memory by bulk copy while the block works on the one before, then into
// registers (16 rows x 8 columns a thread), and every lane's x and z,
// staged in shared memory by cp.async, run through it two lanes a pass.
// A thread holds two of the single kernel's warp lanes, so the row sums'
// first tree level is a local add and the rest 15 shuffles for 16 rows.
// y1's sum over the slots stays on chip; only y2's partials go to memory,
// summed by a programmatic dependent launch.  Lane b keeps every add of a
// single call on lane b's vectors, so it has its bits (the design, in
// full, above tile_pair_lanes).  The first port of the lanes (one block
// per tile, lanes loaded from L2 in the loop, y1 and y2 partials in
// memory) and a block of 256 threads holding 16 x 4 a thread (four warps
// a scheduler, not two) measured slower (PERF.md).

// The TPU kernels' VMEM constants (8-tile slabs, 8-row-block batches, the
// 512x512 dense padding) do not apply here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // 16: K2/K3 tile rows per warp
constexpr int kDenseRows = 4;                 // K1 tile rows per warp
constexpr int kDenseTileRows = kWarps * kDenseRows;

// ---------------------------------------------------------------- K1 -----
// Programmatic dependent launch: a kernel launched by launch_dependent may
// start once every block of the kernel before it on the stream has called
// let_dependents_launch (or exited); wait_for_primary then blocks until
// that kernel has finished and its writes are visible.  Without the launch
// attribute wait_for_primary returns at once.
__device__ __forceinline__ void let_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The warp sums of a warp's four row dots (d[i] on each lane: its columns'
// part of row i); row lane >> 3 ends on the lane.  The first two steps of
// the butterfly trade halves of the rows (trade_halves: at step 16 lanes
// below 16 keep rows 0 and 1, at step 8 one row of the two), then a plain
// butterfly over 8 lanes: 6 shuffles where four butterflies take 20, with
// warp_sum's bits for every row.
__device__ __forceinline__ float rows_sum(float (&d)[kDenseRows], int lane) {
  static_assert(kDenseRows == 4, "rows_sum trades halves twice");
  trade_halves<2>(d, lane, 16);
  trade_halves<1>(d, lane, 8);
#pragma unroll
  for (int h = 4; h > 0; h >>= 1)
    d[0] += __shfl_xor_sync(0xffffffffu, d[0], h);
  return d[0];
}

// A warp's kDenseRows rows of a K1 tile into registers: lane l holds
// columns l + 32k; rows >= nrows and columns >= ncols read as 0.
__device__ __forceinline__ void load_rows(const float* __restrict__ T,
                                          int N, int nrows, int ncols,
                                          int lane,
                                          float (&a)[kDenseRows][4]) {
#pragma unroll
  for (int i = 0; i < kDenseRows; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a[i][k] = i < nrows && lane + 32 * k < ncols
                    ? __ldg(T + (size_t)i * N + lane + 32 * k) : 0.f;
}

// One pair of vectors through a warp's rows: zacc[k] = column (l + 32k)
// times zr over the rows, in row order; returns row lane >> 3 times xr:
// the lane's four columns in column order, summed over the warp.  Both K1
// kernels take their arithmetic from here, so a lane has a single call's
// bits.
__device__ __forceinline__ float rows_pair(const float (&a)[kDenseRows][4],
                                           const float* xr, const float* zr,
                                           int lane, float* zacc) {
  float d[kDenseRows];
#pragma unroll
  for (int k = 0; k < 4; ++k) zacc[k] = 0.f;
#pragma unroll
  for (int i = 0; i < kDenseRows; ++i) {
    d[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d[i] = fmaf(a[i][k], xr[k], d[i]);
      zacc[k] = fmaf(a[i][k], zr[i], zacc[k]);
    }
  }
  return rows_sum(d, lane);
}

// grid (ceil(M / kDenseTileRows), ceil(N / 128)); block (ti, tj) writes
// ypart[tj, rows of ti] = A_ij x1_j and zpart[ti, cols of tj] = A_ij' x2_i
// (part: ypart (ntj, M), then zpart (nti, N)).  Warp w holds rows 4w to
// 4w + 3 of the tile, lane l columns l + 32k; a row's dot is the lane's
// four columns in column order, then summed over the warp; a column's is
// each warp's four rows in row order, then the 8 warps' sums in warp order.
__global__ void __launch_bounds__(kThreads)
dense_pair_tiles(const float* __restrict__ A, int M, int N,
                 const float* __restrict__ x1, const float* __restrict__ x2,
                 float* __restrict__ part) {
  __shared__ float zsh[kWarps][kTile];
  count_launch(0);  // launch counter (K1's tiles; its sum: 3)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ti = blockIdx.x, tj = blockIdx.y;
  const int c0 = tj * kTile;
  const int r0 = ti * kDenseTileRows + warp * kDenseRows;
  const int ncols = min(kTile, N - c0), nrows = min(kDenseRows, M - r0);
  float a[kDenseRows][4], xr[4], zr[kDenseRows], zacc[4];
  load_rows(A + (size_t)r0 * N + c0, N, nrows, ncols, lane, a);
  let_dependents_launch();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    xr[k] = lane + 32 * k < ncols ? x1[c0 + lane + 32 * k] : 0.f;
#pragma unroll
  for (int i = 0; i < kDenseRows; ++i) zr[i] = i < nrows ? x2[r0 + i] : 0.f;
  const float y = rows_pair(a, xr, zr, lane, zacc);
  if ((lane & 7) == 0 && (lane >> 3) < nrows)
    part[(size_t)tj * M + r0 + (lane >> 3)] = y;
#pragma unroll
  for (int k = 0; k < 4; ++k) zsh[warp][lane + 32 * k] = zacc[k];
  __syncthreads();
  if (threadIdx.x < ncols) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += zsh[w][threadIdx.x];
    part[(size_t)gridDim.y * M + (size_t)ti * N + c0 + threadIdx.x] = s;
  }
}

// K1 over lanes: the same tiles, grid, partials (each lane's at lane_part
// further on) and order as dense_pair_tiles, the A tile loaded into
// registers once for every lane.  The block stages the vectors of
// kLaneStage lanes in shared memory with one round of loads, then runs
// them through the tile kLaneRound lanes at a time: each warp's rows for
// each lane as in dense_pair_tiles, then the column totals of the round's
// lanes in warp order (two per thread).
constexpr int kLaneStage = 32;
constexpr int kLaneRound = 4;

__global__ void __launch_bounds__(kThreads)
dense_pair_lane_tiles(const float* __restrict__ A, int M, int N, int lanes,
                      const float* __restrict__ x1, long long ld1,
                      const float* __restrict__ x2, long long ld2,
                      float* __restrict__ part, long long lane_part) {
  __shared__ float xs[kLaneStage][kTile];
  __shared__ __align__(16) float zs[kLaneStage][kDenseTileRows];
  __shared__ float zsh[kLaneRound][kWarps][kTile];
  count_launch(4);  // launch counter (K1 over lanes; its sum: 5)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ti = blockIdx.x, tj = blockIdx.y;
  const int c0 = tj * kTile, rt = ti * kDenseTileRows;
  const int r0 = rt + warp * kDenseRows;
  const int ncols = min(kTile, N - c0), nrows = min(kDenseRows, M - r0);
  const int trows = min(kDenseTileRows, M - rt);
  float a[kDenseRows][4];
  load_rows(A + (size_t)r0 * N + c0, N, nrows, ncols, lane, a);
  let_dependents_launch();
  float* ypart = part + (size_t)tj * M + r0;
  float* zpart = part + (size_t)gridDim.y * M + (size_t)ti * N + c0;
  for (int s0 = 0; s0 < lanes; s0 += kLaneStage) {
    const int ns = min(kLaneStage, lanes - s0);
    if (s0 > 0) __syncthreads();  // every warp is done with the last stage
    constexpr int kXLoads = kLaneStage * kTile / kThreads;           // 16
    constexpr int kZLoads = kLaneStage * kDenseTileRows / kThreads;  // 4
    float v[kXLoads], w[kZLoads];
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int e = threadIdx.x + u * kThreads, q = e / kTile, c = e % kTile;
      v[u] = q < ns && c < ncols ? x1[(s0 + q) * ld1 + c0 + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kZLoads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int q = e / kDenseTileRows, r = e % kDenseTileRows;
      w[u] = q < ns && r < trows ? x2[(s0 + q) * ld2 + rt + r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      xs[e / kTile][e % kTile] = v[u];
    }
#pragma unroll
    for (int u = 0; u < kZLoads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      zs[e / kDenseTileRows][e % kDenseTileRows] = w[u];
    }
    __syncthreads();
    // a round's lanes run unconditionally (a staged lane past the last
    // holds zeros), so their loads and sums can interleave
    for (int q0 = 0; q0 < ns; q0 += kLaneRound) {
#pragma unroll
      for (int p = 0; p < kLaneRound; ++p) {
        const int q = q0 + p;
        const float4 z4 =
            *reinterpret_cast<const float4*>(&zs[q][warp * kDenseRows]);
        const float zr[kDenseRows] = {z4.x, z4.y, z4.z, z4.w};
        float xr[4], zacc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) xr[k] = xs[q][lane + 32 * k];
        const float y = rows_pair(a, xr, zr, lane, zacc);
        if (q < ns && (lane & 7) == 0 && (lane >> 3) < nrows)
          ypart[(s0 + q) * lane_part + (lane >> 3)] = y;
#pragma unroll
        for (int k = 0; k < 4; ++k) zsh[p][warp][lane + 32 * k] = zacc[k];
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kLaneRound * kTile / kThreads; ++u) {
        const int e = threadIdx.x + u * kThreads, p = e / kTile,
                  c = e % kTile;
        if (q0 + p < ns && c < ncols) {
          float s = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < kWarps; ++w8) s += zsh[p][w8][c];
          zpart[(s0 + q0 + p) * lane_part + c] = s;
        }
      }
      __syncthreads();  // before zsh is rewritten
    }
  }
}

// K1's ordered sum: a block sums kSumOutputs consecutive outputs of y
// (blocks [0, yblocks)) or of z (the rest).  Warp w sums the w-th of
// kWarps contiguous ranges of an output's n partials, in index order, up
// to kSumLoads loads in flight (lane l takes output l, so a warp's loads
// read 32 consecutive floats); then the first warp adds the kWarps range
// sums in warp order.  The order depends on n alone, so the bits do.
constexpr int kSumOutputs = 32;
constexpr int kSumLoads = 16;

__global__ void __launch_bounds__(kThreads)
dense_pair_sum(const float* __restrict__ part, int M, int N, int nti,
               int ntj, float* __restrict__ y, float* __restrict__ z,
               int yblocks) {
  __shared__ float ranges[kWarps][kSumOutputs];
  count_launch(3);
  wait_for_primary();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool is_y = blockIdx.x < (unsigned)yblocks;
  const float* __restrict__ p = part + (is_y ? 0 : (size_t)ntj * M);
  const int n = is_y ? ntj : nti, len = is_y ? M : N;
  const int o = (is_y ? blockIdx.x : blockIdx.x - yblocks) * kSumOutputs +
                lane;
  const int per = (n + kWarps - 1) / kWarps;
  const int j0 = min(n, warp * per), j1 = min(n, j0 + per);
  float s = 0.f;
  for (int j = j0; j < j1; j += kSumLoads) {  // once while n <= 128
    float v[kSumLoads];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u)
      v[u] = o < len && j + u < j1 ? p[(size_t)(j + u) * len + o] : 0.f;
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u)
      if (j + u < j1) s += v[u];
  }
  ranges[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && o < len) {
    float total = ranges[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += ranges[w][lane];
    (is_y ? y : z)[o] = total;
  }
}

// K1's ordered sum over lanes: one thread per output of each lane (lane b's
// y, then its z), the same adds as dense_pair_sum's: the kWarps ranges of
// ceil(n / kWarps) partials, each summed from 0 in index order, added in
// range order (an empty range adds 0).  Up to kSumLoads loads in flight.
__global__ void __launch_bounds__(kThreads)
dense_pair_lane_sum(const float* __restrict__ part, long long lane_part,
                    int lanes, int M, int N, int nti, int ntj,
                    float* __restrict__ y, float* __restrict__ z) {
  count_launch(5);
  wait_for_primary();
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)lanes * (M + N)) return;
  const int b = (int)(t / (M + N)), oy = (int)(t % (M + N));
  const bool is_y = oy < M;
  const int o = is_y ? oy : oy - M, n = is_y ? ntj : nti, len = is_y ? M : N;
  const float* __restrict__ p =
      part + b * lane_part + (is_y ? 0 : (size_t)ntj * M) + o;
  const int per = (n + kWarps - 1) / kWarps;
  float s = 0.f, total = 0.f;
  int end = per;  // where the current range ends
  for (int c = 0; c < n; c += kSumLoads) {
    float v[kSumLoads];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u)
      v[u] = c + u < n ? p[(size_t)(c + u) * len] : 0.f;
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      const int j = c + u;
      if (j < n) {
        s += v[u];
        if (j + 1 == end || j + 1 == n) {
          total = end == per ? s : total + s;
          s = 0.f;
          end += per;
        }
      }
    }
  }
  for (int w = (n + per - 1) / per; w < kWarps; ++w) total += 0.f;
  (is_y ? y + (size_t)b * M : z + (size_t)b * N)[o] = total;
}

// Launch kernel k, grid x block, as a programmatic dependent of the kernel
// before it on st.
template <class... Params, class... Args>
cudaError_t launch_dependent(void (*k)(Params...), dim3 grid, int block,
                             cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k, args...);
}

// K1 on `lanes` lanes (lanes == 0: the single-vector kernels, one lane).
int dense_pair_launch(const float* A, int M, int N, int lanes,
                      const float* x1, long long ld1, const float* x2,
                      long long ld2, float* part, float* y, float* z,
                      cudaStream_t st) {
  const int nti = (M + kDenseTileRows - 1) / kDenseTileRows;
  const int ntj = (N + kTile - 1) / kTile;
  const long long lane_part = (long long)ntj * M + (long long)nti * N;
  const int yblocks = (M + kSumOutputs - 1) / kSumOutputs;
  const int zblocks = (N + kSumOutputs - 1) / kSumOutputs;
  cudaError_t e;
  if (lanes == 0) {
    dense_pair_tiles<<<dim3(nti, ntj), kThreads, 0, st>>>(A, M, N, x1, x2,
                                                          part);
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = launch_dependent(dense_pair_sum, dim3(yblocks + zblocks),
                           kThreads, st,
                           (const float*)part, M, N, nti, ntj, y, z,
                           yblocks);
  } else {
    dense_pair_lane_tiles<<<dim3(nti, ntj), kThreads, 0, st>>>(
        A, M, N, lanes, x1, ld1, x2, ld2, part, lane_part);
    e = cudaGetLastError();
    const long long outputs = (long long)lanes * (M + N);
    if (e == cudaSuccess)
      e = launch_dependent(dense_pair_lane_sum,
                           dim3((unsigned)((outputs + kThreads - 1) /
                                           kThreads)),
                           kThreads, st, (const float*)part, lane_part, lanes, M, N,
                           nti, ntj, y, z);
  }
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// ------------------------------------------------------------ K2, K3 -----
// Load a warp's kRows rows of a whole 128-column tile into registers (lane
// l holds columns l + 32k), then reduce them both ways: ydot[i] = row i . x
// on lane i (< kRows), and zacc[k] = column (l + 32k) . z over the warp's
// rows.
template <int kRows>
__device__ __forceinline__ void tile_products(
    const float* __restrict__ T, size_t ld, const float* xr, const float* zr,
    int lane, float& ydot, float* zacc) {
  float a[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) a[i][k] = __ldg(T + i * ld + lane + 32 * k);
#pragma unroll
  for (int k = 0; k < 4; ++k) zacc[k] = 0.f;
  ydot = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float d = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d = fmaf(a[i][k], xr[k], d);
      zacc[k] = fmaf(a[i][k], zr[i], zacc[k]);
    }
    d = warp_sum(d);
    if (lane == i) ydot = d;
  }
}

// Sum the 8 warps' column partials in warp order; thread c < 128 gets
// column c's total.
__device__ __forceinline__ float column_total(float (*zsh)[kTile],
                                              const float* zacc, int warp,
                                              int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k) zsh[warp][lane + 32 * k] = zacc[k];
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < kTile) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += zsh[w][threadIdx.x];
  }
  return s;
}

// One block per stored tile (flat index r * slots + s); slots at or past
// count(r) are padding and exit at once.  Tile (r, s) writes y1part[r, s] =
// T x_{col(r,s)} and y2part[r, s] = T' z_r.
struct BandCols {
  static constexpr int kCounter = 1;  // launch counter (K2)
  static constexpr int kLaneCounter = 6;     // its lane kernel
  static constexpr int kLaneSumCounter = 7;  // and that kernel's sum
  const int* cs;
  int S;
  __device__ int count(int) const { return S; }
  __device__ int col(int r, int s) const { return cs[r] + s; }
  __device__ int slots() const { return S; }
};

struct EllCols {
  static constexpr int kCounter = 2;  // launch counter (K3)
  static constexpr int kLaneCounter = 8;
  static constexpr int kLaneSumCounter = 9;
  const int* cols;
  const int* counts;
  int kmax;
  __device__ int count(int r) const { return counts[r]; }
  __device__ int col(int r, int s) const { return cols[(size_t)r * kmax + s]; }
  __device__ int slots() const { return kmax; }
};

template <class Cols>
__global__ void __launch_bounds__(kThreads)
tile_pair(const float* __restrict__ blocks, Cols cols,
          const float* __restrict__ xb, const float* __restrict__ zb,
          float* __restrict__ y1part, float* __restrict__ y2part) {
  __shared__ float zsh[kWarps][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  count_launch(Cols::kCounter);
  const int nslots = cols.slots();
  const int r = blockIdx.x / nslots, s = blockIdx.x % nslots;
  if (s >= cols.count(r)) return;  // the whole block: no barrier is skipped
  const int row0 = warp * kRowsPerWarp;
  const size_t t = (size_t)blockIdx.x;

  const float* xs = xb + (size_t)cols.col(r, s) * kTile;
  float xr[4], zr[kRowsPerWarp], zacc[4], ydot;
#pragma unroll
  for (int k = 0; k < 4; ++k) xr[k] = xs[lane + 32 * k];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    zr[i] = zb[(size_t)r * kTile + row0 + i];
  tile_products<kRowsPerWarp>(
      blocks + t * (kTile * kTile) + (size_t)row0 * kTile, kTile, xr, zr,
      lane, ydot, zacc);
  if (lane < kRowsPerWarp) y1part[t * kTile + row0 + lane] = ydot;
  const float zc = column_total(zsh, zacc, warp, lane);
  if (threadIdx.x < kTile) y2part[t * kTile + threadIdx.x] = zc;
}

// Blocks [0, nrb): y1[r] = sum over s < count(r) of y1part[r, s], in slot
// order.  Blocks [nrb, nrb + ncb_out): y2[cb] = sum of y2part over the
// slots listed for column block cb in (inv_ptr, inv_idx), in list order.
template <class Cols>
__global__ void tile_pair_sum(Cols cols, int nrb,
                              const float* __restrict__ y1part,
                              float* __restrict__ y1,
                              const float* __restrict__ y2part,
                              const int* __restrict__ inv_ptr,
                              const int* __restrict__ inv_idx,
                              float* __restrict__ y2) {
  const int b = blockIdx.x, c = threadIdx.x;
  float s = 0.f;
  if (b < nrb) {
    const float* p = y1part + (size_t)b * cols.slots() * kTile + c;
    const int n = cols.count(b);
    for (int k = 0; k < n; ++k) s += p[(size_t)k * kTile];
    y1[(size_t)b * kTile + c] = s;
  } else {
    const int cb = b - nrb;
    for (int e = inv_ptr[cb]; e < inv_ptr[cb + 1]; ++e)
      s += y2part[(size_t)inv_idx[e] * kTile + c];
    y2[(size_t)cb * kTile + c] = s;
  }
}

template <class Cols>
int tile_pair_launch(const float* blocks, Cols cols, int nrb, int slots,
                     const int* inv_ptr, const int* inv_idx, int ncb_out,
                     float* part, const float* xb, const float* zb, float* y1,
                     float* y2, cudaStream_t st) {
  float* y1part = part;
  float* y2part = part + (size_t)nrb * slots * kTile;
  tile_pair<Cols><<<nrb * slots, kThreads, 0, st>>>(blocks, cols, xb, zb,
                                                    y1part, y2part);
  tile_pair_sum<Cols><<<nrb + ncb_out, kTile, 0, st>>>(
      cols, nrb, y1part, y1, y2part, inv_ptr, inv_idx, y2);
  return (int)cudaGetLastError();
}

// K2/K3 over lanes.  One block of kLaneThreads threads per row block r
// walks the row block's stored tiles in slot order, and for each tile runs
// every lane's x and z through it:
//
// * the tiles come into shared memory by bulk copies (the tensor memory
//   accelerator, completing on an mbarrier), one tile ahead: a thread
//   copies its part of tile s into registers, and the block asks for tile
//   s + 1 while it runs the lanes through tile s, so a tile's load
//   overlaps the previous tile's arithmetic;
// * the lanes' x tiles and z rows are staged in shared memory by cp.async,
//   kPairRound lanes at a time, one round ahead of the round that reads
//   them; the lane loop reads registers and shared memory only;
// * thread (g, l) (row group g = tid / 16 of 16 rows, l = tid % 16) holds
//   the group's 16 rows at the 8 columns l + 16 k: the columns of two
//   lanes of the single kernel's warp, l and l + 16, so the first level of
//   the single kernel's xor tree (16) is one local add, and the other four
//   (8, 4, 2, 1) trade halves inside the half-warp: 15 shuffles for the
//   group's 16 rows, after which thread (g, l) holds row 16 g + l = tid;
// * two lanes go through the tile per pass (kLanePass), so that one lane's
//   shuffles can issue between the other's FMAs;
// * a row's sum over the slots stays on chip (y1acc), in slot order, and
//   the last slot writes y1; only the column totals leave the SM, one
//   partial per stored tile, kPairRound lanes per shared-memory exchange;
// * the second kernel sums y2's partials over the inverse list, launched
//   as a programmatic dependent of the first.
//
// Shared rows are padded where the two half-warps of a warp (row groups
// 2w and 2w + 1) would meet the same banks: the tile's row groups and the
// column exchange's rows lie 16 floats further apart than their length.
//
// Per lane the arithmetic is tile_pair's: row i's dot is the fmaf chain of
// each single-kernel warp lane (columns l, l + 32, l + 64, l + 96) and its
// xor tree 16, 8, 4, 2, 1; column c's total is the 16-row fmaf chains of
// the 8 row groups added in group order; y1[r] is ((0 + p_0) + p_1) + ...
// in slot order and y2[cb] the inverse list's order.  So lane b is
// bit-equal to a single call on lane b's vectors.
//
// Lane b's x tiles are at xb + b ldx, its z rows at zb + b ldz (16-byte
// aligned, ld a multiple of 4), its y2 partials at part + b lane_part
// (laid out as tile_pair's y2part), its y1 at y1 + b nrb 128.  Any number
// of lanes: kLaneChunk at a time, each chunk walking the slots again.
constexpr int kLaneThreads = kTile;  // 4 warps: 8 row groups of 16 threads
constexpr int kGroupRows = 16;
constexpr int kGroups = kTile / kGroupRows;
constexpr int kGroupCols = kTile / 16;  // the 8 columns a thread holds
constexpr int kLaneChunk = 32;          // lanes whose y1 sums are on chip
constexpr int kPairRound = 4;           // lanes per shared-memory exchange
constexpr int kLanePass = 2;            // lanes through the tile together
constexpr int kTileCopies = 16;         // bulk copies a tile
constexpr int kGroupPad = kGroupRows * kTile + 16;  // a row group in smem
constexpr int kExchangeRow = kTile + 16;

struct LaneStage {
  float tile[kGroups * kGroupPad];          // the next tile, by bulk copy
  float xs[2][kPairRound][kTile];           // a round's x tiles, two rounds
  float zs[2][kPairRound][kTile];           // its z rows
  float y1acc[kLaneChunk][kTile];           // y1's running sum, slot order
  float zsh[kPairRound][kGroups][kExchangeRow];  // column chains of a round
  unsigned long long bar;                   // the tile's mbarrier
};

// Thread 0: bring the tile at src into dst (row group g at g kGroupPad),
// completing on bar's next phase (the block has read dst's last tile: a
// barrier came before).
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          unsigned long long* bar) {
  constexpr unsigned kBytes = kTile * kTile * 4;
  constexpr unsigned kPart = kBytes / kTileCopies;
  constexpr int kPerGroup = kTileCopies / kGroups;
  mbar_expect_tx(bar, kBytes);
#pragma unroll
  for (int j = 0; j < kTileCopies; ++j)
    bulk_copy(dst + j / kPerGroup * kGroupPad + j % kPerGroup * (kPart / 4),
              src + j * (kPart / 4), kPart, bar);
}

// kN lanes through a thread's part of a tile: x from xq + n 128 + 16 k
// (xq: the first lane's x at column l), z from zq + n 128 (the group's 16
// rows).  dot[n]: lane n's dot of row 16 g + l; za[n][k]: lane n's chain
// of column l + 16 k over the group's rows.
template <int kN>
__device__ __forceinline__ void lanes_through_tile(
    const float (&a)[kGroupRows][kGroupCols], const float* xq,
    const float* zq, int l, float (&dot)[kN], float (&za)[kN][kGroupCols]) {
  float x[kN][kGroupCols], d[kN][kGroupRows];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int k = 0; k < kGroupCols; ++k) {
      x[n][k] = xq[n * kTile + 16 * k];
      za[n][k] = 0.f;
    }
#pragma unroll
  for (int i4 = 0; i4 < kGroupRows; i4 += 4) {
    float z[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float4 v = *reinterpret_cast<const float4*>(zq + n * kTile + i4);
      z[n][0] = v.x, z[n][1] = v.y, z[n][2] = v.z, z[n][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i4 + j;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        // the chains of the single kernel's lanes l (even k) and l + 16
        float e = 0.f, o = 0.f;
#pragma unroll
        for (int k = 0; k < kGroupCols; k += 2) {
          e = fmaf(a[i][k], x[n][k], e);
          o = fmaf(a[i][k + 1], x[n][k + 1], o);
        }
        d[n][i] = e + o;  // the tree's level 16
#pragma unroll
        for (int k = 0; k < kGroupCols; ++k)
          za[n][k] = fmaf(a[i][k], z[n][j], za[n][k]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) trade_halves<8>(d[n], l, 8);
#pragma unroll
  for (int n = 0; n < kN; ++n) trade_halves<4>(d[n], l, 4);
#pragma unroll
  for (int n = 0; n < kN; ++n) trade_halves<2>(d[n], l, 2);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    trade_halves<1>(d[n], l, 1);
    dot[n] = d[n][0];
  }
}

// Where a block is in its walk: chunk c0, slot s, round q0.
struct LanePos {
  int c0, s, q0;
};

template <class Cols>
__global__ void __launch_bounds__(kLaneThreads, 2)
tile_pair_lanes(const float* __restrict__ blocks, Cols cols, int lanes,
                const float* __restrict__ xb, long long ldx,
                const float* __restrict__ zb, long long ldz,
                float* __restrict__ y1, float* __restrict__ part,
                long long lane_part) {
  extern __shared__ float4 lane_smem[];
  LaneStage& st = *reinterpret_cast<LaneStage*>(lane_smem);
  count_launch(Cols::kLaneCounter);
  let_dependents_launch();
  const int r = blockIdx.x, tid = threadIdx.x;
  const int g = tid / 16, l = tid % 16;  // this thread's row is tid
  const int nslots = cols.slots(), count = cols.count(r);
  const size_t y1_lane = (size_t)gridDim.x * kTile;
  float* __restrict__ y1r = y1 + (size_t)r * kTile + tid;
  if (count == 0) {  // no stored tile: y1 is the sum of no slots
    for (int q = 0; q < lanes; ++q) y1r[q * y1_lane] = 0.f;
    return;
  }
  const float* __restrict__ tiles = blocks + (size_t)r * nslots * kTile * kTile;
  // stage the x tiles and z rows of the round at p into buffer b
  auto stage = [&](LanePos p, int b) {
    const int n = min(kPairRound, min(kLaneChunk, lanes - p.c0) - p.q0);
    const int q = p.c0 + p.q0;
    const float* xs = xb + q * ldx + (size_t)cols.col(r, p.s) * kTile;
    const float* zs = zb + q * ldz + (size_t)r * kTile;
    for (int u = tid; u < 2 * n * (kTile / 4); u += kLaneThreads) {
      const int z = u >= n * (kTile / 4), v = u - z * n * (kTile / 4);
      const int lane = v / (kTile / 4), j = 4 * (v % (kTile / 4));
      cp_async16(z ? &st.zs[b][lane][j] : &st.xs[b][lane][j],
                 (z ? zs + lane * ldz : xs + lane * ldx) + j);
    }
    cp_async_commit();
  };
  // the round after p, or c0 == lanes past the last
  auto next = [&](LanePos p) {
    if (p.q0 + kPairRound < min(kLaneChunk, lanes - p.c0))
      return LanePos{p.c0, p.s, p.q0 + kPairRound};
    if (p.s + 1 < count) return LanePos{p.c0, p.s + 1, 0};
    return LanePos{p.c0 + kLaneChunk, 0, 0};
  };
  if (tid == 0) {
    mbar_init(&st.bar);
    load_tile(st.tile, tiles, &st.bar);
  }
  stage(LanePos{0, 0, 0}, 0);
  __syncthreads();  // the mbarrier is initialised
  unsigned parity = 0;
  int buf = 0;
  for (LanePos p{0, 0, 0}; p.c0 < lanes;) {
    // the tile of slot p.s into registers, then the next tile asked for
    float a[kGroupRows][kGroupCols];
    mbar_wait(&st.bar, parity);
    parity ^= 1;
    const float* T = st.tile + g * kGroupPad + l;
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i)
#pragma unroll
      for (int k = 0; k < kGroupCols; ++k) a[i][k] = T[i * kTile + 16 * k];
    __syncthreads();  // every thread has its part of the tile
    const int s = p.s, c0 = p.c0, nc = min(kLaneChunk, lanes - c0);
    const size_t t = (size_t)r * nslots + s;
    if (tid == 0 && (s + 1 < count || c0 + kLaneChunk < lanes))
      load_tile(st.tile, tiles + (s + 1 < count ? s + 1 : 0) *
                                     (size_t)(kTile * kTile), &st.bar);
    const bool first = s == 0, last = s + 1 == count;
    for (; p.s == s && p.c0 == c0; p = next(p), buf ^= 1) {
      const int q0 = p.q0;
      cp_async_wait_all();
      // the round's stage has landed everywhere, and every thread is done
      // with the last round's exchange and the other stage buffer
      __syncthreads();
      const LanePos after = next(p);
      if (after.c0 < lanes) stage(after, buf ^ 1);
#pragma unroll 1
      for (int h = 0; h < kPairRound && q0 + h < nc; h += kLanePass) {
        // lanes past nc run on stale data and are not stored
        float dot[kLanePass], za[kLanePass][kGroupCols];
        lanes_through_tile<kLanePass>(a, st.xs[buf][h] + l,
                                      st.zs[buf][h] + g * kGroupRows, l, dot,
                                      za);
#pragma unroll
        for (int n = 0; n < kLanePass; ++n) {
          const int q = q0 + h + n;
          float* acc = &st.y1acc[q][tid];
          const float v = (first ? 0.f : *acc) + dot[n];
          if (!last)
            *acc = v;
          else if (q < nc)
            y1r[(c0 + q) * y1_lane] = v;
#pragma unroll
          for (int k = 0; k < kGroupCols; ++k)
            st.zsh[h + n][g][l + 16 * k] = za[n][k];
        }
      }
      __syncthreads();
      // column tid's totals, the groups in order
#pragma unroll
      for (int h = 0; h < kPairRound; ++h) {
        if (q0 + h < nc) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kGroups; ++w) sum += st.zsh[h][w][tid];
          part[(c0 + q0 + h) * lane_part + t * kTile + tid] = sum;
        }
      }
    }
  }
}

// y2 of lane blockIdx.y: tile_pair_sum's column-block sums over its
// partials at part + lane_part y, into y2 + ncb_out 128 y.  A programmatic
// dependent of tile_pair_lanes: it reads the inverse list before waiting.
template <class Cols>
__global__ void tile_pair_lanes_sum(int ncb_out,
                                    const float* __restrict__ part,
                                    long long lane_part,
                                    const int* __restrict__ inv_ptr,
                                    const int* __restrict__ inv_idx,
                                    float* __restrict__ y2) {
  count_launch(Cols::kLaneSumCounter);
  const int cb = blockIdx.x, c = threadIdx.x;
  const int e0 = inv_ptr[cb], e1 = inv_ptr[cb + 1];
  wait_for_primary();
  const float* __restrict__ y2part = part + blockIdx.y * lane_part + c;
  float s = 0.f;
  for (int e = e0; e < e1; ++e) s += y2part[(size_t)inv_idx[e] * kTile];
  y2[((size_t)blockIdx.y * ncb_out + cb) * kTile + c] = s;
}

// Shared memory of tile_pair_lanes above the 48 KB default, set once (the
// library's loader calls fos_pair_lanes_occupancy, so before any capture).
template <class Cols>
cudaError_t lane_smem_attribute() {
  static const cudaError_t e = cudaFuncSetAttribute(
      tile_pair_lanes<Cols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(LaneStage));
  return e;
}

template <class Cols>
int tile_pair_lanes_launch(const float* blocks, Cols cols, int nrb,
                           int slots, const int* inv_ptr, const int* inv_idx,
                           int ncb_out, int lanes, float* part,
                           const float* xb, long long ldx, const float* zb,
                           long long ldz, float* y1, float* y2,
                           cudaStream_t st) {
  cudaError_t e = lane_smem_attribute<Cols>();
  if (e != cudaSuccess) return (int)e;
  const long long lane_part = (long long)nrb * slots * kTile;
  tile_pair_lanes<Cols><<<nrb, kLaneThreads, sizeof(LaneStage), st>>>(
      blocks, cols, lanes, xb, ldx, zb, ldz, y1, part, lane_part);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    e = launch_dependent(tile_pair_lanes_sum<Cols>, dim3(ncb_out, lanes),
                         kTile, st, ncb_out, (const float*)part, lane_part,
                         inv_ptr, inv_idx, y2);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Resident blocks per SM of a lane kernel (its shared memory set first).
template <class Cols>
int lane_blocks_per_sm(long long* out) {
  cudaError_t e = lane_smem_attribute<Cols>();
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, tile_pair_lanes<Cols>, kLaneThreads, sizeof(LaneStage));
  *out = n;
  return (int)e;
}

}  // namespace

extern "C" {

int fos_tile_side(void) { return kTile; }

int fos_dense_tile_rows(void) { return kDenseTileRows; }

const char* fos_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Device launch counts of K1's tile kernel, K2, K3, K1's sum, K1's lane
// tile kernel and its sum, K2's lane kernel and its sum, K3's lane kernel
// and its sum, in that order (read_launch_counts in common.cuh).
int fos_pair_launch_counts(const long long* slots) {
  return read_launch_counts(slots);
}

// K1.  Record: 0 A (M, N) f32 contiguous, 1 M, 2 N, 3 part (ntj * M +
// nti * N f32: ypart (ntj, M), then zpart (nti, N)), 4 x1 (N,), 5 x2
// (M,), 6 y (M,), 7 z (N,), 8 stream; nti = ceil(M / kDenseTileRows)
// (fos_dense_tile_rows), ntj = ceil(N / 128).
int fos_dense_pair(const long long* slots) {
  const Record a{slots};
  return dense_pair_launch(a.ptr<const float>(0), a.num(1), a.num(2), 0,
                           a.ptr<const float>(4), 0, a.ptr<const float>(5),
                           0, a.ptr<float>(3), a.ptr<float>(6),
                           a.ptr<float>(7), a.stream(8));
}

// K1 over B lanes.  Record: 0 A (M, N) f32 contiguous, 1 M, 2 N, 3 B
// (1..65535), 4 part (B (ntj * M + nti * N) f32: each lane's as K1's),
// 5 X1 (lane b's x1 at X1 + b ld1, N f32), 6 ld1, 7 X2 (lane b's x2 at
// X2 + b ld2, M f32), 8 ld2, 9 Y (B, M), 10 Z (B, N), 11 stream.
int fos_dense_pair_lanes(const long long* slots) {
  const Record a{slots};
  return dense_pair_launch(a.ptr<const float>(0), a.num(1), a.num(2),
                           a.num(3), a.ptr<const float>(5), slots[6],
                           a.ptr<const float>(7), slots[8], a.ptr<float>(4),
                           a.ptr<float>(9), a.ptr<float>(10), a.stream(11));
}

// K2.  Record: 0 blocks (nrb, S, 128, 128), 1 cs (nrb,), 2 nrb, 3 S,
// 4 inv_ptr (ncb_out + 1,), 5 inv_idx (nrb * S,), 6 ncb_out (= ncb + S),
// 7 part (2 * nrb * S * 128 f32), 8 xb (ncb_out, 128), 9 zb (nrb, 128),
// 10 y1 (nrb, 128), 11 y2 (ncb_out, 128), 12 stream.
int fos_band_pair(const long long* slots) {
  const Record a{slots};
  const BandCols cols{a.ptr<const int>(1), a.num(3)};
  return tile_pair_launch(a.ptr<const float>(0), cols, a.num(2), a.num(3),
                          a.ptr<const int>(4), a.ptr<const int>(5), a.num(6),
                          a.ptr<float>(7), a.ptr<const float>(8),
                          a.ptr<const float>(9), a.ptr<float>(10),
                          a.ptr<float>(11), a.stream(12));
}

// K3.  Record: 0 blocks (nrb, kmax, 128, 128), 1 cols (nrb, kmax), 2 counts
// (nrb,): slots past counts[r] are padding and are skipped, 3 nrb, 4 kmax,
// 5 inv_ptr (ncb + 1,) listing stored slots, 6 inv_idx, 7 ncb,
// 8 part (2 * nrb * kmax * 128 f32), 9 xb (ncb, 128), 10 zb (nrb, 128),
// 11 y1 (nrb, 128), 12 y2 (ncb, 128), 13 stream.
int fos_bell_pair(const long long* slots) {
  const Record a{slots};
  const EllCols ell{a.ptr<const int>(1), a.ptr<const int>(2), a.num(4)};
  return tile_pair_launch(a.ptr<const float>(0), ell, a.num(3), a.num(4),
                          a.ptr<const int>(5), a.ptr<const int>(6), a.num(7),
                          a.ptr<float>(8), a.ptr<const float>(9),
                          a.ptr<const float>(10), a.ptr<float>(11),
                          a.ptr<float>(12), a.stream(13));
}

// K2 over L lanes.  Record: 0-6 as fos_band_pair's, 7 L (1..65535),
// 8 part (L * nrb * S * 128 f32: y2's partials; y1's stay on chip), 9 XB
// (lane b's xb, (ncb_out, 128), at XB + b ldx), 10 ldx, 11 ZB (lane b's
// zb, (nrb, 128), at ZB + b ldz), 12 ldz, 13 Y1 (L, nrb, 128), 14 Y2 (L,
// ncb_out, 128), 15 stream.  XB and ZB 16-byte aligned, ldx and ldz
// multiples of 4.
int fos_band_pair_lanes(const long long* slots) {
  const Record a{slots};
  const BandCols cols{a.ptr<const int>(1), a.num(3)};
  return tile_pair_lanes_launch(
      a.ptr<const float>(0), cols, a.num(2), a.num(3), a.ptr<const int>(4),
      a.ptr<const int>(5), a.num(6), a.num(7), a.ptr<float>(8),
      a.ptr<const float>(9), slots[10], a.ptr<const float>(11), slots[12],
      a.ptr<float>(13), a.ptr<float>(14), a.stream(15));
}

// K3 over L lanes.  Record: 0-7 as fos_bell_pair's, 8 L, 9 part (L * nrb
// * kmax * 128 f32), 10 XB, 11 ldx, 12 ZB, 13 ldz (as
// fos_band_pair_lanes), 14 Y1 (L, nrb, 128), 15 Y2 (L, ncb, 128),
// 16 stream.
int fos_bell_pair_lanes(const long long* slots) {
  const Record a{slots};
  const EllCols ell{a.ptr<const int>(1), a.ptr<const int>(2), a.num(4)};
  return tile_pair_lanes_launch(
      a.ptr<const float>(0), ell, a.num(3), a.num(4), a.ptr<const int>(5),
      a.ptr<const int>(6), a.num(7), a.num(8), a.ptr<float>(9),
      a.ptr<const float>(10), slots[11], a.ptr<const float>(12), slots[13],
      a.ptr<float>(14), a.ptr<float>(15), a.stream(16));
}

// Record: 0 host address of 2 int64 that receive the resident blocks per
// SM of K2's and K3's lane kernels.  Sets their shared-memory size first
// (the loader calls it once, before any capture).
int fos_pair_lanes_occupancy(const long long* slots) {
  long long* out = reinterpret_cast<long long*>(slots[0]);
  const int e = lane_blocks_per_sm<BandCols>(out);
  return e ? e : lane_blocks_per_sm<EllCols>(out + 1);
}

}  // extern "C"
