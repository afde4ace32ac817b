// Conditional nodes for the solve's loops under CUDA-graph capture
// (Hopper, sm_90a; CUDA 12.4 or later for conditional nodes inside the
// bodies of other conditional nodes), plain C interface.
//
// The JAX package keeps its loops on the device: CG is a lax.while_loop,
// a chunk's steps a lax.fori_loop, fused_solve's chunks a while_loop
// (fos_tpu/linalg/cg.py, fos_tpu/solvers/engine.py).  The port captures
// the same loops into a CUDA graph (fos_tpu_torch/linalg/control.py): each
// loop becomes a WHILE conditional node, a branch an IF node, whose body
// is captured from the PyTorch code that runs eagerly on the CPU.  No TPU
// kernel is replaced here.
//
// Host entry points (launch records, slots as listed):
//   fos_graph_handle      a conditional handle in the graph that a stream is
//                         capturing into;
//   fos_graph_cond_open   a WHILE or IF node after what the stream has
//                         captured so far, its body then captured on another
//                         stream (cudaStreamBeginCaptureToGraph);
//   fos_graph_cond_close  the end of the body's capture;
//   fos_graph_capture_abort  the end of a capture (a graph's or a body's)
//                         abandoned after an error, never instantiated;
//   fos_stream_create     a stream of the library's own to capture on.
// Condition kernels, one thread each, read device scalars and set the
// handle: the value a WHILE node tests before each pass of its body, or
// the one an IF node tests once.
//   cg_continue     (rn > tol2) && (it < max_iters): CG's stopping test,
//                   the condition of lax.while_loop in fos_tpu/linalg/cg.py;
//   cg_continue_lanes  the same test over a lane axis, true while any lane
//                   is live: CG under the JAX package's vmap (the line
//                   search's candidate steps, a batched solve's instances);
//                   one block, the lanes strided over its threads;
//   count_continue  a counter, reset or advanced, below a limit and,
//                   optionally, a status (one, or one per lane: any lane)
//                   equal to a code: the step loop (j < nsteps) and
//                   fused_solve's chunk loop (status == CONTINUE &&
//                   k < nchunks);
//   flag_continue   a bool PyTorch computed (a branch), or its negation.
// What bounds them: one launch each; they read at most 16 bytes, 12 per
// lane over a lane axis.  A loop
// pays one condition kernel per pass of its body, so CG pays one per group
// of `unroll` iterations, where the eager loop pays a host read.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

template <typename T>
__global__ void cg_continue(cudaGraphConditionalHandle h,
                            const T* __restrict__ rn,
                            const T* __restrict__ tol2,
                            const int* __restrict__ it, int max_iters) {
  count_launch(0);
  cudaGraphSetConditional(h, (*rn > *tol2) && (*it < max_iters) ? 1u : 0u);
}

// tol_stride 0: one tol2 for every lane; 1: one per lane.
template <typename T>
__global__ void cg_continue_lanes(cudaGraphConditionalHandle h,
                                  const T* __restrict__ rn,
                                  const T* __restrict__ tol2,
                                  const int* __restrict__ it, int max_iters,
                                  int lanes, int tol_stride) {
  count_launch(3);
  int live = 0;
  for (int j = threadIdx.x; j < lanes; j += blockDim.x)
    live |= (rn[j] > tol2[j * tol_stride]) && (it[j] < max_iters);
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) cudaGraphSetConditional(h, live ? 1u : 0u);
}

// mode 0: test *k; 1: set *k = 0, then test; 2: add one to *k, then test.
// With a status, also: some of its `lanes` entries equal `want`.
__global__ void count_continue(cudaGraphConditionalHandle h, int* k, int mode,
                               int limit, const int* __restrict__ status,
                               int want, int lanes) {
  count_launch(1);
  int v = *k;
  if (mode == 1) v = 0;
  if (mode == 2) v += 1;
  if (mode != 0) *k = v;
  bool live = v < limit;
  if (status != nullptr && live) {
    bool any = false;
    for (int j = 0; j < lanes && !any; ++j) any = status[j] == want;
    live = any;
  }
  cudaGraphSetConditional(h, live ? 1u : 0u);
}

__global__ void flag_continue(cudaGraphConditionalHandle h,
                              const unsigned char* __restrict__ flag,
                              int negate) {
  count_launch(2);
  cudaGraphSetConditional(h, ((*flag != 0) != (negate != 0)) ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                           deps, nullptr, ndeps);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                           deps, ndeps);
#endif
  if (e != cudaSuccess) return e;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorIllegalState;
}

}  // namespace

extern "C" {

// Device launch counts of cg_continue, count_continue, flag_continue,
// cg_continue_lanes (read_launch_counts in common.cuh).
int fos_graph_launch_counts(const long long* slots) {
  return read_launch_counts(slots);
}

// Record: 0 stream (capturing), 1 host address of a uint64 that receives
// the handle.
int fos_graph_handle(const long long* slots) {
  const Record a{slots};
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t e = capture_info(a.stream(0), &graph, &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (e == cudaSuccess) *a.ptr<unsigned long long>(1) = h;
  return (int)e;
}

// Record: 0 stream (capturing), 1 body stream (idle), 2 handle, 3 kind
// (0 WHILE, 1 IF).  The node depends on everything the stream captured so
// far (the condition kernel last), the stream's next work depends on the
// node, and the body stream captures into the node's body graph.
int fos_graph_cond_open(const long long* slots) {
  const Record a{slots};
  cudaStream_t stream = a.stream(0);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t e = capture_info(stream, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = static_cast<cudaGraphConditionalHandle>(slots[2]);
  p.conditional.type = a.num(3) == 0 ? cudaGraphCondTypeWhile
                                     : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &p);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &p);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      a.stream(1), p.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal);
}

// Record: 0 body stream.  The body graph belongs to its node.
int fos_graph_cond_close(const long long* slots) {
  const Record a{slots};
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(a.stream(0), &body);
}

// Record: 0 stream (capturing).  Ends the capture after an error and
// returns its error (an invalidated capture's), which it also clears from
// the runtime's last error, so that the next launch does not report it.
// What the capture made is left undestroyed: cudaGraphDestroy of a graph
// whose conditional node lost its body's capture segfaults (CUDA 12.8,
// H100), and a failed capture is rare.
int fos_graph_capture_abort(const long long* slots) {
  const Record a{slots};
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaStreamEndCapture(a.stream(0), &graph);
  (void)cudaGetLastError();
  return (int)e;
}

// Record: 0 host address of a cudaStream_t that receives a new
// non-blocking stream on the current device (a capture or body stream).
int fos_stream_create(const long long* slots) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e == cudaSuccess) *reinterpret_cast<cudaStream_t*>(slots[0]) = s;
  return (int)e;
}

// cg_continue.  Record: 0 handle, 1 rn, 2 tol2 (0-dim, f32 or f64), 3 it
// (0-dim int32), 4 max_iters, 5 1 for f64, 6 stream.
int fos_cg_continue(const long long* slots) {
  const Record a{slots};
  auto h = static_cast<cudaGraphConditionalHandle>(slots[0]);
  if (a.num(5))
    cg_continue<double><<<1, 1, 0, a.stream(6)>>>(
        h, a.ptr<const double>(1), a.ptr<const double>(2),
        a.ptr<const int>(3), a.num(4));
  else
    cg_continue<float><<<1, 1, 0, a.stream(6)>>>(
        h, a.ptr<const float>(1), a.ptr<const float>(2), a.ptr<const int>(3),
        a.num(4));
  return (int)cudaGetLastError();
}

// cg_continue_lanes.  Record: 0 handle, 1 rn (lanes), 2 tol2 (lanes, or
// one), 3 it (lanes, int32), 4 max_iters, 5 1 for f64, 6 lanes, 7 1 when
// tol2 has one entry per lane, 8 stream.
int fos_cg_continue_lanes(const long long* slots) {
  const Record a{slots};
  auto h = static_cast<cudaGraphConditionalHandle>(slots[0]);
  if (a.num(5))
    cg_continue_lanes<double><<<1, kThreads, 0, a.stream(8)>>>(
        h, a.ptr<const double>(1), a.ptr<const double>(2),
        a.ptr<const int>(3), a.num(4), a.num(6), a.num(7));
  else
    cg_continue_lanes<float><<<1, kThreads, 0, a.stream(8)>>>(
        h, a.ptr<const float>(1), a.ptr<const float>(2), a.ptr<const int>(3),
        a.num(4), a.num(6), a.num(7));
  return (int)cudaGetLastError();
}

// count_continue.  Record: 0 handle, 1 k (0-dim int32), 2 mode, 3 limit,
// 4 status (int32, `lanes` entries) or 0, 5 the status code wanted,
// 6 lanes, 7 stream.
int fos_count_continue(const long long* slots) {
  const Record a{slots};
  count_continue<<<1, 1, 0, a.stream(7)>>>(
      static_cast<cudaGraphConditionalHandle>(slots[0]), a.ptr<int>(1),
      a.num(2), a.num(3), a.ptr<const int>(4), a.num(5), a.num(6));
  return (int)cudaGetLastError();
}

// flag_continue.  Record: 0 handle, 1 flag (0-dim bool), 2 negate, 3 stream.
int fos_flag_continue(const long long* slots) {
  const Record a{slots};
  flag_continue<<<1, 1, 0, a.stream(3)>>>(
      static_cast<cudaGraphConditionalHandle>(slots[0]),
      a.ptr<const unsigned char>(1), a.num(2));
  return (int)cudaGetLastError();
}

}  // extern "C"
