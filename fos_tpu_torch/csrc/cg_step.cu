// CG's iteration for Hopper (sm_90a), f32 and f64, plain C interface.
//
// On the TPU, XLA fuses the vector work of one CG iteration into a few
// fusions; no Pallas kernel is replaced here.  The two kernels take the
// place of those fusions:
//   C1 cg_step: the masked update of one CG iteration, `one` of
//      fos_tpu/linalg/cg.py:181-195 (conjugate_gradient_tracked) and
//      :119-131 (conjugate_gradient): Ap = w, p + w or p - w (w the
//      operator's product of p: A(A'p) for I + AA', Q(Qp) for I + Q'Q);
//      den = Ap.p; alpha = rn / den where the system is live and den != 0;
//      x += alpha p, Qx += alpha Qp (tracked), r -= alpha Ap; rn' = r.r;
//      beta = rn' / rn; p = r + beta p, rn, it + live: every vector in
//      place, one launch per iteration.
//   C2 q_rank1: q_mul's rank-1 epilogue (fos_tpu/linalg/hsde_ops.py:77-91),
//      out = [A'z2 + c z3, b z3 - A z1, -c'z1 - b'z2] from the pair's two
//      products, in one launch.
// Both take a lane axis (independent systems, each its own CG scalars):
// the line search's candidate steps, a batched solve's instances, or both
// nested, flattened to L lanes; each vector is one contiguous row per lane
// at a lane stride (rows of a larger tensor will do).  C2's instance data
// (b, c) is shared by all lanes (stride 0) or one row per `per`
// consecutive lanes.
//
// What bounds them: the bytes (C1 reads six vectors of k and writes four,
// C2 reads about three of n + m and writes one) and, at the sizes the
// solver gives them (k = 161 .. 65537), two dependent reductions and a
// launch: a few microseconds, the launch-bound regime of the probes P1/P2.
// So one launch does the whole iteration, the reductions on chip.
//
// Design: the geometry depends on k (C2: n + m) and the dtype only, so a
// lane's bits never depend on the number of lanes, and every sum runs a
// fixed tree (no atomics):
//   kBlock (k <= 8192): one block per lane, 64..1024 threads;
//   kCluster (k <= 2^18): one thread-block cluster of 2..8 blocks of 1024
//      threads per lane; the blocks' totals meet in distributed shared
//      memory after a cluster barrier, summed in rank order by each block;
//   kMulti (larger): 4096 elements per block, the step split at its two
//      reductions into dependent launches (A, the ordered sum of A's
//      partials, B, the sum of B's, C; C2: the products, then the sum).
// A thread's elements are i = start + j * stride, summed in j order with
// fma, then a warp butterfly, then the warps' totals in a second butterfly,
// then (kCluster) the blocks' totals in rank order, all in double (f32 data
// too; the result rounded to the data's type once).  The elementwise
// updates round each multiply and add on its own (__fmul_rn, __fadd_rn),
// as PyTorch's separate kernels do.
//
// Split phases: the same kernel runs A, B or C alone (phases 1, 2, 4),
// writing the lane's complete den, then rn', to `sc`, so that a sharded CG
// can all-reduce them between the launches (linalg/cg_step.py); at world
// size 1 that gives the bits of the fused launch.
//
// Lanes and the group mask: a lane-axis CG tests (rn > tol2) && (it <
// max_iters) once per group of `unroll` iterations and steps only the
// lanes live at the group's start (fos_tpu_torch/linalg/cg.py).  With a
// `go` buffer the first step of a group (first = 1) computes that test per
// lane and stores it, later steps read it, and a lane whose test failed is
// left untouched.  Every step writes `next` = the same test after the step,
// which the eager loop reads instead of computing it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cgrp = cooperative_groups;

enum : int { kBlock = 0, kCluster = 1, kMulti = 2 };
enum : int { kPhaseA = 1, kPhaseB = 2, kPhaseC = 4, kFused = 7 };
enum : int { kCountStep = 0, kCountStepSum = 1, kCountRank1 = 2,
             kCountRank1Sum = 3 };

constexpr long long kBlockMaxK = 8192;
constexpr long long kClusterMaxK = 1 << 18;
constexpr int kClusterThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr int kMultiThreads = 512;
constexpr long long kChunk = kMultiThreads * 8;   // elements per kMulti block
constexpr int kSumThreads = 256;

struct Geometry {
  int kind, threads, parts;   // parts: blocks per lane (the cluster size)
};

// Every sum accumulates in double, f32 data too: each f32 product is then
// exact and the sum's rounding ~1e-16 of its terms, so den, rn' and C2's
// dot are rounded to the data's type once, at the end.
using Acc = double;

Geometry geometry(long long k) {
  if (k <= kBlockMaxK) {
    int t = 64;
    while (t < 1024 && t * 8LL < k) t *= 2;
    return {kBlock, t, 1};
  }
  if (k <= kClusterMaxK) {
    int c = 2;
    while (c < kMaxCluster && (long long)c * kClusterThreads * 8 < k) c *= 2;
    return {kCluster, kClusterThreads, c};
  }
  return {kMulti, kMultiThreads, (int)((k + kChunk - 1) / kChunk)};
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

template <class T>
__device__ __forceinline__ T warp_total(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's total of v, the same bits on every thread.
template <class T>
__device__ T block_total(T v, T* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_total(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T t = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
  t = warp_total(t);
  __syncthreads();   // red is free for the next sum
  return t;
}

// The cluster's total of v: each block's total in its `slot`, then each
// block sums the slots in rank order.  A slot is written once per launch;
// the kernels end with a cluster barrier, so no block leaves while another
// may still read its slots.
template <class T>
__device__ T cluster_total(T v, T* red, T* slot, int blocks) {
  cgrp::cluster_group cl = cgrp::this_cluster();
  const T b = block_total(v, red);
  if (threadIdx.x == 0) *slot = b;
  cl.sync();
  if (threadIdx.x == 0) {
    T t = *cl.map_shared_rank(slot, 0);
    for (int q = 1; q < blocks; ++q) t += *cl.map_shared_rank(slot, q);
    red[0] = t;
  }
  __syncthreads();
  const T t = red[0];
  __syncthreads();
  return t;
}

template <int kGeo, class T>
__device__ __forceinline__ T lane_total(T v, T* red, T* slot, int blocks) {
  if constexpr (kGeo == kCluster) return cluster_total(v, red, slot, blocks);
  return block_total(v, red);
}

// A thread's elements of its lane: start, start + stride, ... below end.
struct Span {
  long long start, stride, end;
};

template <int kGeo>
__device__ __forceinline__ Span span(long long k, int rank, int blocks) {
  if (kGeo == kBlock) return {threadIdx.x, blockDim.x, k};
  if (kGeo == kCluster)
    return {(long long)rank * blockDim.x + threadIdx.x,
            (long long)blocks * blockDim.x, k};
  const long long lo = rank * kChunk;
  return {lo + threadIdx.x, blockDim.x, lo + kChunk < k ? lo + kChunk : k};
}

template <class T>
struct StepArgs {
  long long k;
  int lanes, mode, max_iters, tol2_lanes, parts, first;
  T *p, *r, *x, *qx;        // qx: null for standard CG
  const T *w, *qp;          // qp: the tracked Qp, null for standard CG
  long long sp, sr, sx, sqx, sw, sqp;
  T* rn;
  int* it;
  const T* tol2;
  unsigned char *go, *next; // go: null for one system (no group mask)
  T* sc;                    // 3 lanes: den, rn', rn (the split phases)
  Acc* part;                // lanes * parts (kMulti's partial sums)
};

template <class T>
__device__ __forceinline__ T ap_at(int mode, const T* p, const T* w,
                                   long long i) {
  const T wi = w[i];
  if (mode == 0) return wi;
  return mode == 1 ? add_rn(p[i], wi) : sub_rn(p[i], wi);
}

// C1: `phases` of one CG iteration for every lane (kFused: all three).
template <class T, int kGeo>
__global__ void __launch_bounds__(1024) cg_step(StepArgs<T> a, int phases) {
  __shared__ Acc red[32];
  __shared__ Acc slot[2];
  count_launch(kCountStep);
  const int blocks = a.parts;
  const int lane = kGeo == kBlock ? blockIdx.x : blockIdx.x / blocks;
  const int rank = kGeo == kBlock ? 0 : blockIdx.x % blocks;
  const bool lead = rank == 0 && threadIdx.x == 0;
  const bool split = phases != kFused;
  const long long L = a.lanes;
  const Span s = span<kGeo>(a.k, rank, blocks);
  T* p = a.p + lane * a.sp;
  T* r = a.r + lane * a.sr;
  const T* w = a.w + lane * a.sw;
  const T tol2 = a.tol2[a.tol2_lanes ? lane : 0];
  // rn and it: read before any block of the lane writes them (the fused
  // launch writes them after its last cluster barrier; a C launch of the
  // split phases reads rn from sc)
  const T rn = (phases & (kPhaseA | kPhaseB)) ? a.rn[lane] : a.sc[2 * L + lane];

  bool go = true;
  if (a.go) {
    if (a.first) {
      go = rn > tol2 && a.it[lane] < a.max_iters;
      if (lead) a.go[lane] = go;
    } else {
      go = a.go[lane];
    }
  }
  if (!go) {   // a frozen lane: untouched (every block of it returns here)
    if (kGeo == kMulti && threadIdx.x == 0 && (phases & (kPhaseA | kPhaseB)))
      a.part[lane * blocks + rank] = Acc(0);
    if (lead && split && (phases & kPhaseA)) a.sc[lane] = T(0);
    if (lead && (phases & kPhaseC)) {
      const T rc = a.rn[lane];
      a.next[lane] = rc > tol2 && a.it[lane] < a.max_iters;
    }
    return;
  }

  T den = T(0), rn_new = T(0);
  if (phases & kPhaseA) {
    Acc acc = Acc(0);
    for (long long i = s.start; i < s.end; i += s.stride)
      acc = fma_rn(Acc(ap_at(a.mode, p, w, i)), Acc(p[i]), acc);
    if (kGeo == kMulti) {
      const Acc t = block_total(acc, red);
      if (threadIdx.x == 0) a.part[lane * blocks + rank] = t;
    } else {
      den = T(lane_total<kGeo>(acc, red, &slot[0], blocks));
      if (lead && split) a.sc[lane] = den;
    }
  }
  if (phases & kPhaseB) {
    if (split) den = a.sc[lane];
    const bool live = rn > tol2;
    const bool nz = den != T(0);
    const T alpha = live && nz ? div_rn(rn, den) : T(0);
    T* x = a.x + lane * a.sx;
    T* qx = a.qx ? a.qx + lane * a.sqx : nullptr;
    const T* qp = a.qp ? a.qp + lane * a.sqp : nullptr;
    Acc acc = Acc(0);
    for (long long i = s.start; i < s.end; i += s.stride) {
      const T pi = p[i];
      const T api = ap_at(a.mode, p, w, i);
      x[i] = add_rn(x[i], mul_rn(alpha, pi));
      if (qx) qx[i] = add_rn(qx[i], mul_rn(alpha, qp[i]));
      const T ri = sub_rn(r[i], mul_rn(alpha, api));
      r[i] = ri;
      acc = fma_rn(Acc(ri), Acc(ri), acc);
    }
    if (kGeo == kMulti) {
      const Acc t = block_total(acc, red);
      if (threadIdx.x == 0) a.part[lane * blocks + rank] = t;
      if (lead) a.sc[2 * L + lane] = rn;
    } else {
      rn_new = T(lane_total<kGeo>(acc, red, &slot[1], blocks));
      if (lead && split) {
        a.sc[L + lane] = rn_new;
        a.sc[2 * L + lane] = rn;
      }
    }
  }
  if (phases & kPhaseC) {
    if (split) rn_new = a.sc[L + lane];
    const bool live = rn > tol2;
    const T beta = live ? div_rn(rn_new, rn > T(0) ? rn : T(1)) : T(0);
    if (live)
      for (long long i = s.start; i < s.end; i += s.stride)
        p[i] = add_rn(r[i], mul_rn(beta, p[i]));
    if (lead) {
      const T out = live ? rn_new : rn;
      const int it = a.it[lane] + (live ? 1 : 0);
      a.rn[lane] = out;
      a.it[lane] = it;
      a.next[lane] = out > tol2 && it < a.max_iters;
    }
  }
  if constexpr (kGeo == kCluster) cgrp::this_cluster().sync();
}

// kMulti's dependent sums: out[b * stride] = the sum of lane b's `parts`
// partials, strided over the block's threads in order, then the block's
// tree.
template <class T>
__global__ void __launch_bounds__(kSumThreads)
lane_sums(const Acc* __restrict__ part, int parts, T* out, long long stride,
          int counter) {
  __shared__ Acc red[32];
  count_launch(counter);
  const int lane = blockIdx.x;
  Acc acc = Acc(0);
  for (int q = threadIdx.x; q < parts; q += blockDim.x)
    acc += part[(long long)lane * parts + q];
  const Acc t = block_total(acc, red);
  if (threadIdx.x == 0) out[lane * stride] = T(t);
}

template <class T>
struct Rank1Args {
  int n, m, lanes, per, parts;
  const T *z, *az, *atz, *b, *c;
  long long sz, saz, satz, sb, sc;
  T* out;    // (lanes, n + m + 1), contiguous
  Acc* part;   // lanes * parts (kMulti)
};

// C2: out = [A'z2 + c z3, b z3 - A z1, -[c; b] . z[:n+m]] for every lane.
// The dot's terms are -c_i z1_i, then -b_j z2_j: negation is exact, so they
// are the bits of -[c; b] . z[:n+m] formed from a stored -[c; b].
template <class T, int kGeo>
__global__ void __launch_bounds__(1024) q_rank1(Rank1Args<T> a) {
  __shared__ Acc red[32];
  __shared__ Acc slot[2];
  count_launch(kCountRank1);
  const int blocks = a.parts;
  const int lane = kGeo == kBlock ? blockIdx.x : blockIdx.x / blocks;
  const int rank = kGeo == kBlock ? 0 : blockIdx.x % blocks;
  const int n = a.n;
  const long long K = (long long)n + a.m;
  const Span s = span<kGeo>(K, rank, blocks);
  const long long d = lane / a.per;
  const T* z = a.z + lane * a.sz;
  const T* az = a.az + lane * a.saz;
  const T* atz = a.atz + lane * a.satz;
  const T* b = a.b + d * a.sb;
  const T* c = a.c + d * a.sc;
  T* out = a.out + lane * (K + 1);
  const T z3 = z[K];
  Acc acc = Acc(0);
  for (long long i = s.start; i < s.end; i += s.stride) {
    const T ci = i < n ? c[i] : b[i - n];
    out[i] = i < n ? add_rn(atz[i], mul_rn(ci, z3))
                   : sub_rn(mul_rn(ci, z3), az[i - n]);
    acc = fma_rn(-Acc(ci), Acc(z[i]), acc);
  }
  if (kGeo == kMulti) {
    const Acc t = block_total(acc, red);
    if (threadIdx.x == 0) a.part[lane * blocks + rank] = t;
    return;
  }
  const Acc t = lane_total<kGeo>(acc, red, &slot[0], blocks);
  if (rank == 0 && threadIdx.x == 0) out[K] = T(t);
  if constexpr (kGeo == kCluster) cgrp::this_cluster().sync();
}

template <class... Params, class... Args>
cudaError_t launch(void (*k)(Params...), int grid, const Geometry& g,
                   cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid * (g.kind == kBlock ? 1 : g.parts));
  cfg.blockDim = dim3(g.threads);
  cfg.stream = st;
  if (g.kind == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.parts;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, k, args...);
}

template <class T>
int step_launch(const long long* s) {
  const Record rec{s};
  StepArgs<T> a;
  a.k = s[1];
  a.lanes = rec.num(2);
  a.mode = rec.num(3);
  a.max_iters = rec.num(4);
  a.tol2_lanes = rec.num(5);
  a.p = rec.ptr<T>(6);
  a.sp = s[7];
  a.r = rec.ptr<T>(8);
  a.sr = s[9];
  a.x = rec.ptr<T>(10);
  a.sx = s[11];
  a.qx = rec.ptr<T>(12);
  a.sqx = s[13];
  a.w = rec.ptr<const T>(14);
  a.sw = s[15];
  a.qp = rec.ptr<const T>(16);
  a.sqp = s[17];
  a.rn = rec.ptr<T>(18);
  a.it = rec.ptr<int>(19);
  a.tol2 = rec.ptr<const T>(20);
  a.go = rec.ptr<unsigned char>(21);
  a.next = rec.ptr<unsigned char>(22);
  a.sc = rec.ptr<T>(23);
  a.part = rec.ptr<Acc>(24);
  const int first = rec.num(25), phases = rec.num(26);
  const cudaStream_t st = rec.stream(27);
  const Geometry g = geometry(a.k);
  a.parts = g.parts;
  if (g.kind == kBlock) {
    a.first = first;
    return (int)launch(cg_step<T, kBlock>, a.lanes, g, st, a, phases);
  }
  if (g.kind == kCluster) {
    a.first = first;
    return (int)launch(cg_step<T, kCluster>, a.lanes, g, st, a, phases);
  }
  // kMulti: each phase its own launch, each reduction a launch of its own
  const Geometry sums{kBlock, kSumThreads, 1};
  cudaError_t e = cudaSuccess;
  const int order[3] = {kPhaseA, kPhaseB, kPhaseC};
  for (int ph : order) {
    if (!(phases & ph) || e != cudaSuccess) continue;
    a.first = ph == kPhaseA ? first : 0;
    e = launch(cg_step<T, kMulti>, a.lanes, g, st, a, ph);
    if (e == cudaSuccess && ph != kPhaseC)
      e = launch(lane_sums<T>, a.lanes, sums, st,
                 static_cast<const Acc*>(a.part), g.parts,
                 a.sc + (ph == kPhaseA ? 0 : a.lanes), 1LL,
                 (int)kCountStepSum);
  }
  return (int)e;
}

template <class T>
int rank1_launch(const long long* s) {
  const Record rec{s};
  Rank1Args<T> a;
  a.n = rec.num(1);
  a.m = rec.num(2);
  a.lanes = rec.num(3);
  a.per = rec.num(4);
  a.z = rec.ptr<const T>(5);
  a.sz = s[6];
  a.az = rec.ptr<const T>(7);
  a.saz = s[8];
  a.atz = rec.ptr<const T>(9);
  a.satz = s[10];
  a.b = rec.ptr<const T>(11);
  a.sb = s[12];
  a.c = rec.ptr<const T>(13);
  a.sc = s[14];
  a.out = rec.ptr<T>(15);
  a.part = rec.ptr<Acc>(16);
  const cudaStream_t st = rec.stream(17);
  const long long K = (long long)a.n + a.m;
  const Geometry g = geometry(K);
  a.parts = g.parts;
  if (g.kind == kBlock)
    return (int)launch(q_rank1<T, kBlock>, a.lanes, g, st, a);
  if (g.kind == kCluster)
    return (int)launch(q_rank1<T, kCluster>, a.lanes, g, st, a);
  cudaError_t e = launch(q_rank1<T, kMulti>, a.lanes, g, st, a);
  if (e == cudaSuccess)
    e = launch(lane_sums<T>, a.lanes, Geometry{kBlock, kSumThreads, 1}, st,
               static_cast<const Acc*>(a.part), g.parts, a.out + K, K + 1,
               (int)kCountRank1Sum);
  return (int)e;
}

}  // namespace

extern "C" {

// Device launch counts of cg_step, cg_step's dependent sums (kMulti),
// q_rank1 and q_rank1's dependent sum (read_launch_counts in common.cuh).
int fos_cg_step_launch_counts(const long long* slots) {
  return read_launch_counts(slots);
}

// The geometry of a vector of length k.  Record: 0 k, 1 host address of
// three int64: kind (0 block, 1 cluster, 2 multi), threads a block, blocks
// a lane (the partial sums a lane needs under kMulti).
int fos_cg_geometry(const long long* slots) {
  const Geometry g = geometry(slots[0]);
  long long* out = reinterpret_cast<long long*>(slots[1]);
  out[0] = g.kind;
  out[1] = g.threads;
  out[2] = g.parts;
  return 0;
}

// C1.  Record: 0 dtype (0 f32, 1 f64), 1 k, 2 lanes, 3 mode (0 Ap = w,
// 1 p + w, 2 p - w), 4 max_iters, 5 1 when tol2 has one entry per lane,
// 6 p, 7 its lane stride, 8 r, 9, 10 x, 11, 12 Qx (0: none), 13, 14 w,
// 15, 16 Qp (0: none), 17, 18 rn (lanes), 19 it (lanes, int32), 20 tol2,
// 21 go (lanes, bool) or 0, 22 next (lanes, bool), 23 sc (3 lanes),
// 24 part (lanes * blocks a lane f64, kMulti) or 0, 25 first, 26 phases
// (7: the whole step; 1, 2, 4: A, B, C alone), 27 stream.  Lane strides
// in elements.
int fos_cg_step(const long long* slots) {
  return slots[0] ? step_launch<double>(slots) : step_launch<float>(slots);
}

// C2.  Record: 0 dtype, 1 n, 2 m, 3 lanes, 4 per (lanes per row of the
// instance data), 5 z (lanes, n + m + 1), 6 its lane stride, 7 A z1
// (lanes, m), 8, 9 A'z2 (lanes, n), 10, 11 b, 12 its row stride (0:
// shared), 13 c, 14, 15 out (lanes, n + m + 1) contiguous, 16 part
// (kMulti, f64) or 0, 17 stream.
int fos_q_rank1(const long long* slots) {
  return slots[0] ? rank1_launch<double>(slots) : rank1_launch<float>(slots);
}

}  // extern "C"
