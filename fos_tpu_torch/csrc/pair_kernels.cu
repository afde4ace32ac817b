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
// (K2, K3).  Each element of A is read once, with coalesced loads (a warp
// reads 128 contiguous floats of one row at a time), and reduced both ways
// while it is in registers: along the row for A x, along the column for
// A' z.  The vectors and the partial sums are a few percent of those bytes.
//
// One CUDA block per 128x128 tile (K1: a tile of A, ragged edges masked;
// K2, K3: a stored tile of the table), so thousands of blocks keep the
// card's memory system busy.  Cross-block sums are deterministic: a block
// never adds into another block's output.  Each tile writes its two
// 128-vectors (A x and A' z contributions) to partial buffers, and a
// second, small kernel sums the partials of each output in a fixed order
// (K1: over column tiles for y and row tiles for z; K2, K3: over a row
// block's tiles for y1, and over the tiles that land in a column block for
// y2, listed by an inverse table built once on the host).  The same inputs
// give the same bits, run after run.
//
// The TPU kernels' VMEM constants (8-tile slabs, 8-row-block batches, the
// 512x512 dense padding) do not apply here.  Simple and correct first;
// wgmma, TMA and persistent blocks are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // 16

// Load one 128-row tile into registers (lane l holds columns l + 32k of
// the warp's 16 rows; rows >= nrows and columns >= ncols read as 0), then
// reduce it both ways: ydot[i] = row i . x on lane i (< 16), and
// zacc[k] = column (l + 32k) . z over the warp's rows.
__device__ __forceinline__ void tile_products(
    const float* __restrict__ T, size_t ld, int nrows, int ncols,
    const float* xr, const float* zr, int lane, float& ydot, float* zacc) {
  float a[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a[i][k] = (i < nrows && lane + 32 * k < ncols)
                    ? __ldg(T + i * ld + lane + 32 * k) : 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) zacc[k] = 0.f;
  ydot = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
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
// grid (ceil(M / 128), ceil(N / 128)); block (row tile i, column tile j)
// writes ypart[j, rows of i] = A_ij x1_j and zpart[i, cols of j] =
// A_ij' x2_i.
__global__ void __launch_bounds__(kThreads)
dense_pair_tiles(const float* __restrict__ A, int M, int N,
                 const float* __restrict__ x1, const float* __restrict__ x2,
                 float* __restrict__ ypart, float* __restrict__ zpart) {
  __shared__ float zsh[kWarps][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ti = blockIdx.x, tj = blockIdx.y;
  const int c0 = tj * kTile;
  const int r0 = ti * kTile + warp * kRowsPerWarp;
  const int ncols = min(kTile, N - c0), nrows = min(kRowsPerWarp, M - r0);

  float xr[4], zr[kRowsPerWarp], zacc[4], ydot;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    xr[k] = lane + 32 * k < ncols ? x1[c0 + lane + 32 * k] : 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) zr[i] = i < nrows ? x2[r0 + i] : 0.f;
  tile_products(A + (size_t)r0 * N + c0, (size_t)N, nrows, ncols, xr, zr,
                lane, ydot, zacc);
  if (lane < nrows) ypart[(size_t)tj * M + r0 + lane] = ydot;
  const float zc = column_total(zsh, zacc, warp, lane);
  if (threadIdx.x < ncols) zpart[(size_t)ti * N + c0 + threadIdx.x] = zc;
}

// Sum n partial vectors of length len (stride len) in index order; the
// loads are unrolled so that several are in flight at once.
__device__ __forceinline__ float ordered_sum(const float* __restrict__ part,
                                             int n, size_t len, size_t t) {
  float s = 0.f;
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = part[(size_t)(j + u) * len + t];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; j < n; ++j) s += part[(size_t)j * len + t];
  return s;
}

// y[r] = sum_j ypart[j, r] and z[c] = sum_i zpart[i, c], in index order.
__global__ void dense_pair_sum(const float* __restrict__ ypart, int ny, int M,
                               float* __restrict__ y,
                               const float* __restrict__ zpart, int nz, int N,
                               float* __restrict__ z) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < M) y[t] = ordered_sum(ypart, ny, M, t);
  else if (t < M + N) z[t - M] = ordered_sum(zpart, nz, N, t - M);
}

// ------------------------------------------------------------ K2, K3 -----
// One block per stored tile (flat index r * slots + s); slots at or past
// count(r) are padding and exit at once.  Tile (r, s) writes y1part[r, s] =
// T x_{col(r,s)} and y2part[r, s] = T' z_r.
struct BandCols {
  const int* cs;
  int S;
  __device__ int count(int) const { return S; }
  __device__ int col(int r, int s) const { return cs[r] + s; }
  __device__ int slots() const { return S; }
};

struct EllCols {
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
  tile_products(blocks + t * (kTile * kTile) + (size_t)row0 * kTile, kTile,
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

}  // namespace

extern "C" {

int fos_tile_side(void) { return kTile; }

const char* fos_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1.  A (M, N) row-major; ypart (ceil(N/128), M); zpart (ceil(M/128), N).
int fos_dense_pair(const float* A, int M, int N, const float* x1,
                   const float* x2, float* y, float* z, float* ypart,
                   float* zpart, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nti = (M + kTile - 1) / kTile;
  const int ntj = (N + kTile - 1) / kTile;
  dense_pair_tiles<<<dim3(nti, ntj), kThreads, 0, st>>>(A, M, N, x1, x2,
                                                        ypart, zpart);
  const int total = M + N;
  dense_pair_sum<<<(total + 255) / 256, 256, 0, st>>>(ypart, ntj, M, y,
                                                      zpart, nti, N, z);
  return (int)cudaGetLastError();
}

// K2.  blocks (nrb, S, 128, 128); cs (nrb,); xb (ncb_out, 128) with
// ncb_out = ncb + S; zb (nrb, 128); y1 (nrb, 128); y2 (ncb_out, 128);
// y1part, y2part (nrb, S, 128); inv_ptr (ncb_out + 1,); inv_idx (nrb * S,).
int fos_band_pair(const float* blocks, const int* cs, int nrb, int S,
                  const float* xb, const float* zb, float* y1, float* y2,
                  float* y1part, float* y2part, const int* inv_ptr,
                  const int* inv_idx, int ncb_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const BandCols cols{cs, S};
  tile_pair<BandCols><<<nrb * S, kThreads, 0, st>>>(blocks, cols, xb, zb,
                                                    y1part, y2part);
  tile_pair_sum<BandCols><<<nrb + ncb_out, kTile, 0, st>>>(
      cols, nrb, y1part, y1, y2part, inv_ptr, inv_idx, y2);
  return (int)cudaGetLastError();
}

// K3.  blocks (nrb, kmax, 128, 128); cols (nrb, kmax); counts (nrb,):
// slots past counts[r] are padding and are skipped; xb (ncb, 128);
// y1part, y2part (nrb, kmax, 128); inv_ptr (ncb + 1,) lists stored slots.
int fos_bell_pair(const float* blocks, const int* cols, const int* counts,
                  int nrb, int kmax, const float* xb, const float* zb,
                  float* y1, float* y2, float* y1part, float* y2part,
                  const int* inv_ptr, const int* inv_idx, int ncb_out,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const EllCols ell{cols, counts, kmax};
  tile_pair<EllCols><<<nrb * kmax, kThreads, 0, st>>>(blocks, ell, xb, zb,
                                                      y1part, y2part);
  tile_pair_sum<EllCols><<<nrb + ncb_out, kTile, 0, st>>>(
      ell, nrb, y1part, y1, y2part, inv_ptr, inv_idx, y2);
  return (int)cudaGetLastError();
}

}  // extern "C"
