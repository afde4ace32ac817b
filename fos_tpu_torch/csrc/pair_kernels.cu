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
// (A_ij x_j for row tile i, A_ij' z_i for column tile j).  The sum kernel
// adds each output's partials in an order fixed by the shapes: a block
// takes 32 consecutive outputs, each warp sums one contiguous range of
// their partials (a warp's loads read 32 consecutive floats), and the
// range sums are added in warp order.  Taller tiles (64, 128 rows) give
// fewer partials but fewer blocks and more loads per thread; 16-row tiles
// double the partials; 32 rows measured fastest at 1000^2 and 4000^2
// (PERF.md, Findings).  The partial buffers are the operator's,
// allocated once; nothing else persists between calls, so a call can be
// captured in a CUDA graph.  A one-launch variant (the last block to
// arrive sums each strip; arrival counters and a release fence) measured
// slower on the H100: the fence and the counters' round trips cost more
// than the kernel boundary they replace.
//
// K2, K3 (unchanged design): one CUDA block per stored 128x128 tile;
// each tile writes its two 128-vectors to partial buffers, and a second,
// small kernel sums the partials of each output in a fixed order (over a
// row block's tiles for y1, and over the tiles that land in a column block
// for y2, listed by an inverse table built once on the host).
//
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

// -------------------------------------------------------- K1, K2, K3 -----
// Load a warp's kRows rows of a 128-column tile into registers (lane l
// holds columns l + 32k; with kEdge, rows >= nrows and columns >= ncols
// read as 0), then reduce them both ways: ydot[i] = row i . x on lane i
// (< kRows), and zacc[k] = column (l + 32k) . z over the warp's rows.
// K2/K3 tiles are whole (kEdge false: no masks, fewer registers); K1
// masks A's edges.
template <bool kEdge, int kRows>
__device__ __forceinline__ void tile_products(
    const float* __restrict__ T, size_t ld, int nrows, int ncols,
    const float* xr, const float* zr, int lane, float& ydot, float* zacc) {
  float a[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a[i][k] = (!kEdge || (i < nrows && lane + 32 * k < ncols))
                    ? __ldg(T + i * ld + lane + 32 * k) : 0.f;
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

// ---------------------------------------------------------------- K1 -----
// grid (ceil(M / kDenseTileRows), ceil(N / 128)); block (row tile i,
// column tile j) writes ypart[j, rows of i] = A_ij x1_j and zpart[i, cols
// of j] = A_ij' x2_i.
__global__ void __launch_bounds__(kThreads)
dense_pair_tiles(const float* __restrict__ A, int M, int N,
                 const float* __restrict__ x1, const float* __restrict__ x2,
                 float* __restrict__ ypart, float* __restrict__ zpart) {
  __shared__ float zsh[kWarps][kTile];
  count_launch(0);  // launch counter (K1's tiles; its sum: 3)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ti = blockIdx.x, tj = blockIdx.y;
  const int c0 = tj * kTile;
  const int r0 = ti * kDenseTileRows + warp * kDenseRows;
  const int ncols = min(kTile, N - c0), nrows = min(kDenseRows, M - r0);

  float xr[4], zr[kDenseRows], zacc[4], ydot;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    xr[k] = lane + 32 * k < ncols ? x1[c0 + lane + 32 * k] : 0.f;
#pragma unroll
  for (int i = 0; i < kDenseRows; ++i) zr[i] = i < nrows ? x2[r0 + i] : 0.f;
  tile_products<true, kDenseRows>(A + (size_t)r0 * N + c0, (size_t)N, nrows,
                                  ncols, xr, zr, lane, ydot, zacc);
  if (lane < nrows) ypart[(size_t)tj * M + r0 + lane] = ydot;
  const float zc = column_total(zsh, zacc, warp, lane);
  if (threadIdx.x < ncols) zpart[(size_t)ti * N + c0 + threadIdx.x] = zc;
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
dense_pair_sum(const float* __restrict__ ypart, int ny, int M,
               float* __restrict__ y, int yblocks,
               const float* __restrict__ zpart, int nz, int N,
               float* __restrict__ z) {
  __shared__ float ranges[kWarps][kSumOutputs];
  count_launch(3);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool is_y = blockIdx.x < (unsigned)yblocks;
  const float* __restrict__ part = is_y ? ypart : zpart;
  const int n = is_y ? ny : nz, len = is_y ? M : N;
  const int o = (is_y ? blockIdx.x : blockIdx.x - yblocks) * kSumOutputs +
                lane;
  const int per = (n + kWarps - 1) / kWarps;
  const int j0 = min(n, warp * per), j1 = min(n, j0 + per);
  float s = 0.f;
  for (int j = j0; j < j1; j += kSumLoads) {  // once while n <= 128
    float v[kSumLoads];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u)
      v[u] = o < len && j + u < j1 ? part[(size_t)(j + u) * len + o] : 0.f;
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

// ------------------------------------------------------------ K2, K3 -----
// One block per stored tile (flat index r * slots + s); slots at or past
// count(r) are padding and exit at once.  Tile (r, s) writes y1part[r, s] =
// T x_{col(r,s)} and y2part[r, s] = T' z_r.
struct BandCols {
  static constexpr int kCounter = 1;  // launch counter (K2)
  const int* cs;
  int S;
  __device__ int count(int) const { return S; }
  __device__ int col(int r, int s) const { return cs[r] + s; }
  __device__ int slots() const { return S; }
};

struct EllCols {
  static constexpr int kCounter = 2;  // launch counter (K3)
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
  tile_products<false, kRowsPerWarp>(
      blocks + t * (kTile * kTile) + (size_t)row0 * kTile, kTile,
      kRowsPerWarp, kTile, xr, zr, lane, ydot, zacc);
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

}  // namespace

extern "C" {

int fos_tile_side(void) { return kTile; }

int fos_dense_tile_rows(void) { return kDenseTileRows; }

const char* fos_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Device launch counts of K1's tile kernel, K2, K3 and K1's sum, in that
// order (read_launch_counts in common.cuh).
int fos_pair_launch_counts(const long long* slots) {
  return read_launch_counts(slots);
}

// K1.  Record: 0 A (M, N) f32 contiguous, 1 M, 2 N, 3 part (ntj * M +
// nti * N f32: ypart (ntj, M), then zpart (nti, N)), 4 x1 (N,), 5 x2
// (M,), 6 y (M,), 7 z (N,), 8 stream; nti = ceil(M / kDenseTileRows)
// (fos_dense_tile_rows), ntj = ceil(N / 128).
int fos_dense_pair(const long long* slots) {
  const Record a{slots};
  const int M = a.num(1), N = a.num(2);
  const int nti = (M + kDenseTileRows - 1) / kDenseTileRows;
  const int ntj = (N + kTile - 1) / kTile;
  float* ypart = a.ptr<float>(3);
  float* zpart = ypart + (size_t)ntj * M;
  cudaStream_t st = a.stream(8);
  dense_pair_tiles<<<dim3(nti, ntj), kThreads, 0, st>>>(
      a.ptr<const float>(0), M, N, a.ptr<const float>(4),
      a.ptr<const float>(5), ypart, zpart);
  const int yblocks = (M + kSumOutputs - 1) / kSumOutputs;
  const int zblocks = (N + kSumOutputs - 1) / kSumOutputs;
  dense_pair_sum<<<yblocks + zblocks, kThreads, 0, st>>>(
      ypart, ntj, M, a.ptr<float>(6), yblocks, zpart, nti, N,
      a.ptr<float>(7));
  return (int)cudaGetLastError();
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

}  // extern "C"
