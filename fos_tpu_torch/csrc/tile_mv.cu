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
// the pallas_call): y_b = A x_b for L lanes.  At 31 lanes the work is 62
// flops per tile entry, so the FMAs alone (32 lanes computed) take about
// as long as the tiles' bytes at HBM's rate: the kernel has to stream the
// tiles and issue FMAs at once.  The design (above tile_mv_lanes):
//
// * a task is a quarter of a row block (32 rows) for a chunk of up to 32
//   lanes, all the chunk's lanes in one block: each stored tile row is
//   read from memory once per call (each further chunk of 32 lanes reads
//   it again), by a bulk copy into one SM's shared memory, and every
//   consumer warp reads it from there;
// * a persistent grid of one wave (the card's SMs x the blocks an SM
//   holds) deals the tasks out round by round, odd rounds backwards, and
//   K5's row blocks longest first (the order sparse_ell.lane_task_order
//   gives), so the ragged A' table's long rows do not leave a tail;
// * a producer warp walks its block's tasks' stored slots through a ring
//   of stages (four at 32 lanes a chunk: three items in flight, across
//   task boundaries too; two at 8): a stage holds the task's 32 rows of
//   one tile, by bulk copy (the tensor memory accelerator), and the
//   chunk's 128-float x window of that slot for every lane, by cp.async
//   (512-byte bulk copies, one a lane, were slower), both landing on the
//   stage's full mbarrier; the consumers free a stage on its empty
//   mbarrier, so no block-wide barrier paces them;
// * a consumer thread holds 8 rows x 8 lanes at the float4 columns c and
//   c + 16 (c = its index mod 16): the single kernel's xor tree's first
//   level (16) is a local add and the other four (8, 4, 2, 1) trade
//   halves among 16 threads, 60 shuffles for its 64 sums; a slot's 512
//   FMAs a thread read 32 float4s from shared memory (4 rows x 8 lanes at
//   4 columns read 48: slower on K5, PERF.md);
// * up to 8 lanes take a narrower block (64 consumers, not 256), so one
//   lane costs the FMAs of 8, not of 32.
//
// Each (lane, row) keeps tile_mv's order: the fmaf chain of each of the
// single kernel's warp lanes over the slots and the four columns of its
// float4, then the xor tree 16, 8, 4, 2, 1, so lane b is bit-equal to a
// single call on x_b.  What bounds it (PERF.md): not the tiles' bytes but
// the SM: the FMAs at the rate this register block reaches (under 3/5 of
// the f32 peak, tools/sm_probe.py) and the shared-memory reads beside
// them, which do not overlap; past ~40 lanes the f32 rate alone.

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
  // the lane kernel's row blocks in the order it deals them: all alike
  __device__ int row_of(int rank) const { return rank; }
};

struct EllSlots {                      // K5: the first counts[r] slots
  static constexpr int kCounter = 1;
  static constexpr int kLaneCounter = 3;
  const int* cols;
  const int* counts;
  int kmax;
  const int* order;  // the lane kernel's: row blocks, longest first
  __device__ int count(int r) const { return counts[r]; }
  __device__ int col(int r, int s) const { return cols[(size_t)r * kmax + s]; }
  __device__ int slots() const { return kmax; }
  __device__ int row_of(int rank) const { return order[rank]; }
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

constexpr int kColThreads = 16;  // threads across a tile row
constexpr int kColGroups = kVec / kColThreads;  // float4 columns a thread
constexpr int kSetRows = kColThreads / 2;       // rows a thread carries
constexpr int kSetLanes = 8;     // lanes a thread carries
constexpr int kTaskRows = 32;    // rows a task: a quarter row block
constexpr int kRowSets = kTaskRows / kSetRows;
constexpr int kRowChunks = kTile / kTaskRows;
constexpr int kSetSums = kSetRows * kSetLanes;  // (row, lane) sums a thread
constexpr int kTileFloats = kTaskRows * kTile;  // a task's rows of a tile
constexpr int kCopyFloats = 1024;               // 4 KB a bulk copy
constexpr int kTileCopies = kTileFloats / kCopyFloats;
static_assert(kSetSums == 4 * kColThreads,
              "the row tree leaves 4 sums a thread: a float4 of one lane");
static_assert(32 % kColThreads == 0 && kRowSets % (32 / kColThreads) == 0,
              "a warp's sets are row sets of one lane set");

// The row tree's levels kH, kH / 2, ..., 1 across threads on kN sums a
// thread (trade_halves), after which a thread holds kN / 2kH of them.
template <int kN, int kH>
__device__ __forceinline__ void trade_levels(float* v, int lane) {
  trade_halves<kN / 2>(v, lane, kH);
  if constexpr (kH > 1) trade_levels<kN / 2, kH / 2>(v, lane);
}

// A lane kernel with kSets sets of kSetLanes lanes: a lane set's row sets
// x kColThreads threads each (the consumers), then one producer warp; a
// ring of kStages stages (a task's 32 tile rows and the chunk's x windows
// of one slot each), then each stage's full and empty mbarriers.  One
// block an SM (its registers).
template <int kSets>
struct LaneShape {
  static constexpr int kLanes = kSets * kSetLanes;  // lanes a chunk
  static constexpr int kConsumers = kSets * kRowSets * kColThreads;
  static constexpr int kBlock = kConsumers + 32;
  static constexpr int kStages = kSets == 1 ? 2 : 4;
  static constexpr int kStageFloats = kTileFloats + kLanes * kTile;
  static constexpr int kSmem = kStages * (kStageFloats * 4 + 16);
};

// Y[b, r, :] = sum over s < count(r) of blocks[r, s] @ X_b[col(r, s)] for
// every lane b < lanes (lane b's x at xb + b ldx, its y at y + b ldy).
//
// Tasks: task t is lane chunk t / (nrb kRowChunks), rows 32 (t %
// kRowChunks) on of the row block of rank t / kRowChunks % nrb
// (Cols::row_of: K5's longest rows first).  Block b takes the task of
// each round k: t = k gridDim.x + b, or k gridDim.x + gridDim.x - 1 - b in
// odd rounds, so that a block with long rows in one round has short ones
// in the next.
//
// Consumer (set, c) (c = tid % kColThreads, set = tid / kColThreads: row
// set set % kRowSets, lane set set / kRowSets) holds rows kSetRows (set %
// kRowSets) + i of a task for lanes kSetLanes (set / kRowSets) + j of the
// chunk at float4 columns c + kColThreads g.  The producer warp walks the
// same tasks' stored slots, one stage each: lane 0 copies the tile rows
// by bulk copy, each lane one float4 column of every lane's x window by
// cp.async and signals their landing on the stage's full mbarrier; each
// consumer warp signals the stage's empty mbarrier once it has read it.
template <class Cols, int kSets>
__global__ void __launch_bounds__(LaneShape<kSets>::kBlock, 1)
tile_mv_lanes(const float* __restrict__ blocks, Cols cols, int nrb, int lanes,
              const float* __restrict__ xb, long long ldx,
              float* __restrict__ y, long long ldy) {
  using Shape = LaneShape<kSets>;
  constexpr int kStages = Shape::kStages, kLanes = Shape::kLanes;
  extern __shared__ float4 lane_smem[];
  float* const ring = reinterpret_cast<float*>(lane_smem);
  unsigned long long* const full = reinterpret_cast<unsigned long long*>(
      ring + kStages * Shape::kStageFloats);
  unsigned long long* const empty = full + kStages;
  count_launch(Cols::kLaneCounter);
  const int tid = threadIdx.x, lane = tid & 31;
  const int grid = gridDim.x, nslots = cols.slots();
  const int per_chunk = nrb * kRowChunks;
  const int tasks = (lanes + kLanes - 1) / kLanes * per_chunk;
  auto task = [&](int k) {  // the block's task of round k
    const int b = blockIdx.x;
    return k * grid + (k & 1 ? grid - 1 - b : b);
  };
  auto row_block = [&](int t) {
    return cols.row_of(t % per_chunk / kRowChunks);
  };
  if (tid == 0)
    for (int k = 0; k < kStages; ++k) {
      mbar_init(&full[k], 33);  // lane 0's expect_tx, 32 lanes' cp.async
      mbar_init(&empty[k], Shape::kConsumers / 32);
    }
  __syncthreads();  // the mbarriers are initialised

  if (tid >= Shape::kConsumers) {  // the producer warp
    int k = 0, m = 0;    // the stage, the items issued
    unsigned phase = 0;  // the stage's phase (its empty phase is one less)
    for (int round = 0, t = task(0); t < tasks; t = task(++round)) {
      const int r = row_block(t), n = cols.count(r);
      const int l0 = t / per_chunk * kLanes, nl = min(kLanes, lanes - l0);
      const float* tile = blocks + ((size_t)r * nslots * kTile +
                                    t % kRowChunks * kTaskRows) * kTile;
      const float* x0 = xb + l0 * ldx + 4 * lane;
      for (int s = 0; s < n; ++s, ++m, tile += kTile * kTile) {
        const int col = cols.col(r, s);
        if (m >= kStages) mbar_wait(&empty[k], phase ^ 1);
        float* st = ring + k * Shape::kStageFloats;
        if (lane == 0) {
          mbar_expect_tx(&full[k], kTileFloats * 4);
          for (int u = 0; u < kTileCopies; ++u)
            bulk_copy(st + u * kCopyFloats, tile + u * kCopyFloats,
                      kCopyFloats * 4, &full[k]);
        }
        const float* xs = x0 + (size_t)col * kTile;
        float* xd = st + kTileFloats + 4 * lane;
        for (int j = 0; j < nl; ++j) cp_async16(xd + j * kTile, xs + j * ldx);
        cp_async_arrive(&full[k]);
        if (++k == kStages) k = 0, phase ^= 1;
      }
    }
    cp_async_wait_all();
    return;
  }

  const int c = tid % kColThreads, set = tid / kColThreads;
  const int rs = set % kRowSets, ls = set / kRowSets;
  int k = 0;
  unsigned phase = 0;
  // each task's count, read a task ahead
  int t = task(0), n = t < tasks ? cols.count(row_block(t)) : 0;
  for (int round = 1; t < tasks; ++round) {
    const int t1 = task(round);
    const int n1 = t1 < tasks ? cols.count(row_block(t1)) : 0;
    float acc[kColGroups * kSetSums];  // acc[(g kSetLanes + j) kSetRows + i]
#pragma unroll
    for (int q = 0; q < kColGroups * kSetSums; ++q) acc[q] = 0.f;
    for (int s = 0; s < n; ++s) {
      mbar_wait(&full[k], phase);
      const float* st = ring + k * Shape::kStageFloats;
      const float4* T = reinterpret_cast<const float4*>(st) +
                        rs * kSetRows * kVec + c;
      const float4* X = reinterpret_cast<const float4*>(st + kTileFloats) +
                        ls * kSetLanes * kVec + c;
#pragma unroll
      for (int g = 0; g < kColGroups; ++g) {
        float4 a[kSetRows];
#pragma unroll
        for (int i = 0; i < kSetRows; ++i) a[i] = T[i * kVec + g * kColThreads];
#pragma unroll
        for (int j = 0; j < kSetLanes; ++j) {
          const float4 xv = X[j * kVec + g * kColThreads];
#pragma unroll
          for (int i = 0; i < kSetRows; ++i) {
            float& v = acc[(g * kSetLanes + j) * kSetRows + i];
            v = fmaf(a[i].x, xv.x, v);
            v = fmaf(a[i].y, xv.y, v);
            v = fmaf(a[i].z, xv.z, v);
            v = fmaf(a[i].w, xv.w, v);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[k]);
      if (++k == kStages) k = 0, phase ^= 1;
    }
    // the tree's levels 16 ... kColThreads in the thread (its columns c
    // + kColThreads g, g and g + h paired), then the rest across threads:
    // thread c ends with the sums 4c .. 4c + 3 (one lane, four rows)
#pragma unroll
    for (int h = kColGroups / 2; h >= 1; h /= 2)
#pragma unroll
      for (int g = 0; g < h; ++g)
#pragma unroll
        for (int q = 0; q < kSetSums; ++q)
          acc[g * kSetSums + q] += acc[(g + h) * kSetSums + q];
    trade_levels<kSetSums, kColThreads / 2>(acc, lane);
    const int b = t / per_chunk * kLanes + ls * kSetLanes + 4 * c / kSetRows;
    if (b < lanes)
      *reinterpret_cast<float4*>(y + b * ldy + (size_t)row_block(t) * kTile +
                                 t % kRowChunks * kTaskRows + rs * kSetRows +
                                 4 * c % kSetRows) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    t = t1, n = n1;
  }
}

// Blocks of tile_mv_lanes<Cols, kSets> an SM holds and the card's SMs; the
// kernel's shared memory is set the first time (the library's loader calls
// fos_mv_lanes_occupancy, so before any capture).
template <class Cols, int kSets>
cudaError_t lane_slots(int* per_sm, int* sms) {
  static int bps = 0, n = 0;
  static const cudaError_t e = [] {
    using Shape = LaneShape<kSets>;
    cudaError_t r = cudaFuncSetAttribute(
        tile_mv_lanes<Cols, kSets>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmem);
    int dev = 0;
    if (r == cudaSuccess) r = cudaGetDevice(&dev);
    if (r == cudaSuccess)
      r = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (r == cudaSuccess)
      r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &bps, tile_mv_lanes<Cols, kSets>, Shape::kBlock, Shape::kSmem);
    return r;
  }();
  *per_sm = bps;
  *sms = n;
  return e;
}

// One wave: as many blocks as the card holds, or one a task.
template <class Cols, int kSets>
int mv_lanes_launch(const float* blocks, Cols cols, int nrb, int lanes,
                    const float* xb, long long ldx, float* y,
                    cudaStream_t st) {
  using Shape = LaneShape<kSets>;
  int per_sm = 0, sms = 0;
  const cudaError_t e = lane_slots<Cols, kSets>(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  const long long tasks =
      (long long)((lanes + Shape::kLanes - 1) / Shape::kLanes) * nrb *
      kRowChunks;
  const int grid = (int)(tasks < (long long)per_sm * sms
                             ? tasks
                             : (long long)per_sm * sms);
  tile_mv_lanes<Cols, kSets><<<grid, Shape::kBlock, Shape::kSmem, st>>>(
      blocks, cols, nrb, lanes, xb, ldx, y, (long long)nrb * kTile);
  return (int)cudaGetLastError();
}

// 8 lanes a chunk up to 8 lanes, else 32.
template <class Cols>
int mv_lanes_launch(const float* blocks, Cols cols, int nrb, int lanes,
                    const float* xb, long long ldx, float* y,
                    cudaStream_t st) {
  if (lanes <= kSetLanes)
    return mv_lanes_launch<Cols, 1>(blocks, cols, nrb, lanes, xb, ldx, y, st);
  return mv_lanes_launch<Cols, 4>(blocks, cols, nrb, lanes, xb, ldx, y, st);
}

template <class Cols>
cudaError_t lane_occupancy(long long* out) {
  int per_sm = 0, sms = 0;
  cudaError_t e = lane_slots<Cols, 1>(&per_sm, &sms);
  out[0] = per_sm;
  if (e == cudaSuccess) e = lane_slots<Cols, 4>(&per_sm, &sms);
  out[1] = per_sm;
  return e;
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
  return mv_lanes_launch(a.ptr<const float>(0), win, a.num(2), a.num(4),
                         a.ptr<const float>(5), slots[6], a.ptr<float>(7),
                         a.stream(8));
}

// K5 over L lanes.  Record: 0 blocks, 1 cols, 2 counts, 3 nrb, 4 kmax (as
// fos_bell_mv), 5 order (nrb,): the row blocks by count, longest first
// (sparse_ell.lane_task_order), 6 L, 7 XB, 8 ldx (as fos_band_mv_lanes),
// 9 Y (L, nrb, 128), 10 stream.
int fos_bell_mv_lanes(const long long* slots) {
  const Record a{slots};
  const EllSlots ell{a.ptr<const int>(1), a.ptr<const int>(2), a.num(4),
                     a.ptr<const int>(5)};
  return mv_lanes_launch(a.ptr<const float>(0), ell, a.num(3), a.num(6),
                         a.ptr<const float>(7), slots[8], a.ptr<float>(9),
                         a.stream(10));
}

// Record: 0 host address of 4 int64 that receive the resident blocks per
// SM of K4's lane kernel at 8 and 32 lanes a chunk, then K5's.  Sets
// their shared-memory size first (the loader calls it once, before any
// capture).
int fos_mv_lanes_occupancy(const long long* slots) {
  long long* out = reinterpret_cast<long long*>(slots[0]);
  const cudaError_t e = lane_occupancy<BandWindow>(out);
  return (int)(e != cudaSuccess ? e : lane_occupancy<EllSlots>(out + 2));
}

}  // extern "C"
