#!/usr/bin/env python3
"""Drive fos_tpu_torch on one NVIDIA H100 through its hand-written CUDA
kernels, and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

0. the card (``nvidia-smi`` name and power limit, torch/CUDA versions), a
   check that it is sm_90, and the nvcc build of ``fos_tpu_torch/csrc``;
1. each kernel against its plain PyTorch version on the card, at the
   shapes the paths below give it: max error, repeatability, the median
   time of a call (CUDA events, host launch cost included) through the
   route the path takes (the kernel bound to its operator), the device
   time of a call (profiler) of both, the least time the card could take
   (bytes over 3.35 TB/s, f32 operations over 67 TFLOP/s) and, where one
   PyTorch call computes the same function, that call's time.  K1 at the
   two dense shapes and at the tile-counting shapes of the card tests,
   with a 100-call bit repeat in which the device counts each of its two
   kernels (the tile kernel and its ordered sum) once per call, each
   kernel's device time, and a CUDA-graph replay, beside two cuBLAS calls
   (``torch.mv(A, x1)``, ``torch.mv(A.T, x2)``); K1 over lanes at 1000^2
   and two edge shapes for 1, 2 and 31 lanes (each lane bit-equal to a
   single call, one launch of each lane kernel) and, at 31 lanes, its
   time replayed from a graph against 31 single calls' (gated at 1/5)
   beside the lane-batched cuBLAS pair; K2/K3 (the pairs);
   K4/K5 over the A tables (``mv``) and the A' tables (``rmv``), against a
   block-sparse ``torch.sparse_bsr_tensor`` matvec; the SOC/rotated-SOC
   projection run twice on the card (bit-equal) against the CPU;
2. the conic path: the dense 1000x1000 certificate LP through K1
   (``pallas=True``) to Optimal at eps=1e-5, continued to eps=1e-6 for the
   objective gate, 300 iterations at 4000x4000; the block-tridiagonal LP
   with ~1e7 nonzeros (32768x32768) through K2; a scattered block-sparse LP
   (one diagonal and three random tiles per block row) through K3;
3. the set-feasibility path: ``Ax + s = b, x in [0,1]^n, s >= 0`` on the
   same two 32768x32768 tables, through ``AffinePlusLinearProjector`` and
   K4 (banded) / K5 (scattered), to Optimal with a residual gate computed
   in f64 on the host; then the reference's testfeasibility problem (50x100
   dense) with all seven algorithms;
4. the launch probe: P1/P2 bit-equal to their plain versions, each one's
   device time over ``torch.mul``'s on the same tile (calls in turns
   under one profiler, gated at 1.15), then every line of
   ``fos_tpu_torch.tools.launch_probe.main()``, and P1/P2's cost in a
   dependent chain over torch's tiny multiply's (target <= 1.3);
5. ``graphs``: the solve's device loops as CUDA graphs.  The condition
   kernels of ``csrc/graph.cu`` (cg_continue, count_continue,
   flag_continue) against their plain versions, and the cost of one pass
   of a WHILE node; then the dense (K1), banded (K2) and scattered (K3) LPs
   and the banded (K4) and scattered (K5) feasibility solves, each run
   three ways in this process: ``engine._run_eager`` (the plain version:
   CG reads the host once per group), ``engine.run`` (one captured graph per
   chunk, one host read per check) and ``engine.fused_solve`` (one graph,
   run under ``torch.cuda.set_sync_debug_mode("error")``).  Status,
   iterations, CG iterations and the bits of the final iterate are gated
   equal between the routes; then profiled 200-iteration solves of
   both routes (iterations/s; device idle share: the profiler's kernel time
   for the eager route, the CUDA-event spans of the graph replays for the
   graph route; the kernel rows the profiler shows for a graph replay);
6. ``cones``: the PSD projection of one d x d block at d = 512 and 1024
   (tuned and uniform polynomial filters and eigh against a host f64 eigh,
   their times beside the filters' FLOP bounds, gate 1e-5 ||X||_2 on the
   tuned filter) and a probe of whether ``torch.linalg.eigh`` can be
   captured; bench.py's lambda-min SDP at d = 512 (DR iterations/s on the
   graph route; GAPA(0.8, 0.9) to Optimal at eps 1e-5 within 1e-3 of
   lambda_min, gated) and at d = 1024 (printed); the kitchen sink in f64
   (every cone; eigh gated Optimal against scipy SLSQP, poly printed), the
   max-entropy exp problem and the nearest-PSD problem; the exp and power
   projections of 65536 blocks each (us and kernels per projection, error
   against f64 on the host); the phase 2 banded and scattered LPs handed
   to ``solve`` as scipy sparse with ``equilibrate=True`` (host Ruiz
   seconds, K2/K3 device launches gated > 0, Optimal within 1e-3); the
   dense LP with ``DR(direct=True)`` (host QR seconds, K1 launches, phase
   2's gate); then the SDP, the kitchen sink (poly), the equilibrated LPs
   and the direct LP through the three routes, gated equal as in phase 5.
   The SDP cells also run the TPU's own instance (bench.py's
   ``PRNGKey(29)`` draw, ``fos_tpu_torch/tools/data``);
7. ``slice``: refine, the wrappers and the batched solve (a lane axis
   through CG and fused_solve).  ``refine_dense_lp``: the dense LP at
   eps = 1e-5 in f32 through K1, then a 10000-iteration f64 sweep from
   its iterate (gated: 50x closer to the certificate, no K1 launch).
   ``wrappers_dense_lp``: DR, LineSearch, Anderson and Longstep through
   the three routes (gated equal), and K1's device counts over one
   line-search step against the counts its CG passes imply (exact): single
   calls for the real projection, lane calls for the 31 probe lanes.
   ``wrappers_feasibility``: LineSearch(AP) and Longstep(DR) through K4,
   LineSearch(DR) through K5, per probe lane (routes, Optimal, residual).
   ``batched_lp_128`` / ``_1024``: bench.py's batched LPs at a
   12000- / 6000-iteration budget (a floor of Optimal instances gated; the
   instances that stop within 1e-3 of HiGHS), segments and routes equal.
   ``batched_wrappers_lp_128``: the 128 instances under GAPP and the three
   wrappers, continuing DR's batched state at its budget (the line
   search's probes a (128, 31) lane axis through CG; finite guesses,
   objectives within 1e-3 of HiGHS, Optimal floors, graph route equal to
   eager, ``cg_continue_lanes`` launched; two instances continued alone
   printed).
   ``batched_sdp_64``: 64 lambda-min SDPs sharing one stride-0 A.
   Route agreement in phases 5 and 6 runs at a smaller depth where a
   repeated solve would cost minutes (the constants say which);
8. ``diff``: implicit differentiation (``diff_solve``).  K1's derivative
   rules (``DensePairFn``) at 1000^2 and 4000^2 against the plain pair
   under autograd (backward with and without A's cotangent, jvp with and
   without dA, a bit repeat, one K1 call per backward counted on the
   device, the backward's time beside the forward's);
   ``diff_dense_lp_float32`` / ``_float64``: a 1000^2 LP with a known
   optimum where DR reaches its fixed point, f32 through K1 (forward,
   backward, a profiled backward: K1's share of its device time, its host
   syncs) and f64 on the plain pair, the envelope identities gated (1e-3
   and 5e-5, scaled) and the jvp against the vjp;
   ``diff_gaussian_basis_lp``: tests/test_diff.py's LP at 1000^2 through
   K1 with a cut derivative budget, gated on K1's launches and finite
   gradients (DR stops short of its optimum); ``diff_batched_lp``: 64 LPs
   differentiated at once, per-lane gradient gated;
   ``diff_batched_lp_wrapped``: the same batch with the forward under the
   line search and Anderson (every instance Optimal, g_c against x and
   against plain DR's gradient, gated);
9. ``front_end``: the front end (the SCS/MathProgBase interface, the
   modeling DSL, checkpoints and the examples) driving K1-K3 from modeled
   data, f32.  ``front_solve_lp``: phase 2's dense LP through ``solve_lp``
   (K1), gated equal to phase 2's solve in status, iterations and bits,
   then phase 2's continuation and objective gate.
   ``front_load_problem_banded``: phase 2's banded LP as scipy CSR through
   ``load_problem`` with MathProgBase cone lists, routed to BandedBlockOp
   (K2).  ``front_dsl_sparse_lp``: the same LP in the DSL (``A @ x <= b,
   x >= 0``, A scipy CSR), lowered to a 65536 x 32768 CSR that the build
   routes to BlockedEllOp (K3), gated on the certificate and on host f64
   residuals.  ``front_dsl_lasso``: bench.py's 1000x1000 lasso data as
   ``0.5 * sum_squares(A @ x - b) + lam * norm1(x)``, densified on the card
   with ``pallas=True`` (K1), gated against a host FISTA oracle.  A DSL
   cell that stops short of its gates at eps 1e-5 continues to eps 1e-6
   from its iterate (phase 2's continuation) and says so in its line.
   ``front_checkpoint``: 300 GAPA iterations on the dense LP (K1),
   ``save_state``/``load_state`` on the card, resumed to Optimal within
   1e-5 (1 + |f|) of a straight-through solve.  ``front_examples``: the
   ten port examples and ``lasso.main_dsl`` on the card, each asserting its
   own oracle.  Each cell's line gives the lowering, build and solve
   seconds, iterations and it/s, the status and the gate's numbers, the
   operator the build chose and the A shape that reached it, and each
   kernel's device launch count over the cell.  The phase opens with
   ``front_native_packer``: the native tile packer (``fos_tpu_torch/
   native``, gated loaded) against its numpy versions on phase 2's
   32768^2 tables, the pack and both format ratios, host seconds of each,
   tables bit-equal and ratios equal (gated);
10. ``sharding``: one NCCL group of world size 1 in this process.
   ``sharded_ops``: ``RowShardedOp`` over phase 2's banded and scattered
   tables (K2-K5), the dense row and 2D operators over its dense A (K1),
   every product bit-equal to the unsharded operator's.
   ``sharded_banded_lp`` / ``sharded_rows_dense_lp``: phase 2's banded LP
   through ``RowShardedOp`` and its dense LP through
   ``shard_problem_rows``, on the eager route (a sharded form's, by its
   operator's type), gated Optimal and equal in status, iterations and
   bits to phase 5's eager solve of the unsharded form.
   ``sharded_batched_lp_128``: batched_lp_128's instances through
   ``shard_batched_form`` at a cut budget, statuses, iterations and
   objectives equal to the unsharded batch.  ``pipelined_dense_lp``:
   the dense LP with ``cg_variant="pipelined"`` (graph route), Optimal and
   phase 2's continuation and objective gate.  ``nccl_capture_probe``: whether NCCL collectives
   capture into a conditional node's body (printed).

Each kernel counts its launches on the device (``_cuda.
device_launch_counts``), graph replays included: the counts are zeroed
just before each path (2, 3, 4, 6) and read just after it (and after each
of its solves, for that solve's count), and every kernel must have been
launched by its path; these are the ``launches`` of the kernels line
(phase 6's counts of K1-K3, the kernels of its path, are
``launches_cones_path``; phase 7's, of every kernel, ``launches_phase7``,
gated > 0 for K1, K4, K5, and for K1 over lanes and the lane condition
``cg_continue_lanes``, whose path it is and whose ``launches`` it gives;
``launches_batched_wrappers_lp_128``, the part of them that cell made,
gated > 0 for ``cg_continue_lanes``; phase 8's, ``launches_phase8``,
gated > 0 for K1, with ``launches_diff_batched_lp_wrapped`` the wrapped
batch's part; phase 9's,
``launches_phase9``, gated > 0 for K1, K2 and K3; phase 10's,
``launches_phase10``, gated > 0 for K1-K5).  The line
before the kernels line gives each phase's seconds.  The wrappers' host
counts (``_cuda.LAUNCHES``) count the calls that launched or captured a
kernel (``captured_calls``): a replay calls no wrapper.
The line before the last lists the kernels; the last line is the run's
result.  Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

TILE = 128
# |kernel - plain| <= ATOL + RTOL * |plain|: f32 sums taken in another order
RTOL, ATOL = 2e-5, 2e-4
# the card's peaks (NVIDIA H100 SXM data sheet), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Feasibility eps, in units of the affine projection's CG floor (m + n)
# eps_f32 (affine.py).  The test is absolute (||z_k - z_{k-1}|| <= eps) and
# in f32 the consecutive-iterate distance of a converged solve sits at the
# CG floor's scale: run on the CPU in f32 at nrb = 8 and 16 (both packages,
# the same construction) and at nrb = 32-128 (the port), it stayed at or
# below 0.8x the floor from the first check on, so 2x the floor is reached
# by both packages at every size tried; the residual gate below, not eps,
# is what holds the answer to account.
FEAS_EPS_FLOORS = 2.0
FEAS_RESID = 1e-4   # ||A x + s - b||_inf <= FEAS_RESID (1 + ||b||_inf), f64
GATE_EPS = 1e-5
GATE_OBJ = 1e-3
DENSE_N = 1000      # the dense LP (bench.py's main point)
SCALING_N = 4000    # the dense scaling point
NRB = 256           # block rows of the sparse LPs: 32768 x 32768
# K1's tile-counting shapes (tests/test_torch_cuda.py): one row of tiles,
# one column of tiles, tall, wide
K1_EDGE_SHAPES = ((1, 4000), (4000, 1), (5000, 300), (300, 5000))
K1_KERNELS_PER_CALL = 2   # the tile kernel and its ordered sum
K1_REPEATS = 100
# K1 over lanes: the line search's candidate steps (fos_tpu/solvers/
# wrappers.py: 31 alphas), the lane counts held bit-equal to single calls,
# the shapes (phase 1's names) where they are, and the gate, at the dense
# LP's 1000^2, on one lane call's time over that of LINESEARCH_LANES single
# calls (both replayed from graphs)
LINESEARCH_LANES = 31
K1_LANE_COUNTS = (1, 2, LINESEARCH_LANES)
K1_LANE_SHAPES = ("fused_matvec", "fused_matvec_5000x300",
                  "fused_matvec_300x5000")
K1_LANES_OVER_SINGLES = 0.2
LAUNCH_ROUTE_TARGET = 1.3   # P1 per call in a chain / torch's tiny multiply
# P1's and P2's device time over torch.mul's on the same tile, calls in
# turns under one profiler (the design with a loop read 1.37-1.65)
PROBE_OVER_MUL_GATE = 1.15
PROBE_TURNS = 200
# iterations of the same solves at commit 2d6fc2b (on an NVIDIA H100 80GB
# HBM3, 700 W), printed beside this run's: a changed sum order in a pair
# kernel may move CG counts and so these (ROADMAP queue 3)
REFERENCE_ITERS = {"dense_lp": 900, "dense_lp_continued": 4500,
                    "dense_scaling": 300, "banded_lp": 2000,
                    "scattered_lp": 2200}
# the graph phase's profiled solves
PROFILE_ITERS = 200
# condition kernels: passes of a WHILE node timed for its per-pass cost
WHILE_PASSES = 2000
# phase 6 (cones): the PSD blocks' side and seed (bench.py's sdp_single_bench
# draws C from PRNGKey(29); numpy's seed 29 here), the tuned polynomial
# filter's gate against a host f64 eigh (max|P - P*| <= PSD_GATE ||X||_2),
# the d = 512 SDP's objective gate against lambda_min, and the iteration
# budgets of the SDP runs
SDP_SEED = 29
PSD_SIDES = (512, 1024)
PSD_GATE = 1e-5
SDP_GATE = 1e-3
SDP_ROUTE_ITERS = 300
# route agreement at a smaller depth than the solves it repeats, so that
# the whole script stays within its time (phase 7's batched LPs take most
# of it): the kitchen sink's (its eager route runs ~8 it/s; the gated solve
# reaches Optimal at 300 on its own), the equilibrated LPs' and the
# algorithm tier's (most of its algorithms run their whole budget)
KITCHEN_ROUTE_ITERS = 100
EQUILIBRATED_ROUTE_ITERS = 2000
TIER_ROUTE_ITERS = 1000
# (d, quality-run iterations, DR rate iterations, gated on the numpy
# instance)
SDP_CELLS = ((512, 8000, 100, True), (1024, 5000, 50, False))
EXP_POW_BLOCKS = 65536


# ------------------------------------------------------------- problems
def certificate_lp(m, n, seed, dtype=np.float32):
    """Dense LP with a primal-dual certificate: (A, b, c, optimum), in
    ``dtype`` (f32 by default; the certificate is exact for the f64 data).
    The recipe of bench.py's ``make_problem`` (seed 7 at 1000x1000)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    xmask = rng.random(n) < 0.5
    x0 = np.abs(rng.standard_normal(n)) * xmask
    r0 = np.abs(rng.standard_normal(n)) * (~xmask)
    ymask = rng.random(m) < 0.5
    y0 = np.abs(rng.standard_normal(m)) * ymask
    s0 = np.abs(rng.standard_normal(m)) * (~ymask)
    b = A @ x0 + s0
    c = r0 - A.T @ y0
    return A.astype(dtype), b.astype(dtype), c.astype(dtype), float(c @ x0)


def scaling_lp(mn, seed=11):
    """The 4000x4000 scaling point's data (bench.py scaling section):
    A gaussian / sqrt(n), b = A |g|, c = |g'|."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((mn, mn), dtype=np.float32)
         / np.float32(np.sqrt(mn)))
    b = A @ np.abs(rng.standard_normal(mn, dtype=np.float32))
    c = np.abs(rng.standard_normal(mn, dtype=np.float32))
    return A, b, c


def _certificate_vectors(rng, m, n):
    """(x0, y0, s0, r0): complementary nonnegative pairs, f32."""
    x0, y0, s0, r0 = (np.abs(rng.standard_normal(k, dtype=np.float32))
                      for k in (n, m, m, n))
    xmask = rng.random(n) < 0.5
    ymask = rng.random(m) < 0.5
    return x0 * xmask, y0 * ymask, s0 * ~ymask, r0 * ~xmask


def banded_tables(nrb=NRB, seed=17, bs=TILE):
    """Block-tridiagonal A in banded layout (bench.py's banded LP recipe,
    numpy in place of jax.random): blocks (nrb, 3, bs, bs), cs (nrb,), and
    the certificate vectors.  Diagonal tiles carry +2I."""
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0 / np.sqrt(3 * bs))
    blocks = rng.standard_normal((nrb, 3, bs, bs), dtype=np.float32) * scale
    blocks[:, 1] += 2.0 * np.eye(bs, dtype=np.float32)
    # slots (low, diag, up) -> windows [cs, cs + 3): the edge rows shift
    blocks[0] = np.roll(blocks[0], -1, axis=0)
    blocks[0, 2] = 0.0
    blocks[-1] = np.roll(blocks[-1], 1, axis=0)
    blocks[-1, 0] = 0.0
    cs = np.clip(np.arange(nrb) - 1, 0, nrb - 3).astype(np.int32)
    return blocks, cs, _certificate_vectors(rng, nrb * bs, nrb * bs)


def scattered_tables(nrb=NRB, seed=23, extra=3, bs=TILE):
    """Block-sparse A in blocked-ELL layout: per block row the diagonal tile
    (+2I) and ``extra`` tiles at distinct seeded random block columns, so
    the pattern is not banded.  Returns blocks, cols, certificate vectors."""
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0 / np.sqrt((extra + 1) * bs))
    blocks = (rng.standard_normal((nrb, extra + 1, bs, bs), dtype=np.float32)
              * scale)
    blocks[:, 0] += 2.0 * np.eye(bs, dtype=np.float32)
    cols = np.empty((nrb, extra + 1), np.int32)
    cols[:, 0] = np.arange(nrb)
    for i in range(nrb):
        others = rng.choice(nrb - 1, extra, replace=False)
        cols[i, 1:] = others + (others >= i)
    return blocks, cols, _certificate_vectors(rng, nrb * bs, nrb * bs)


def host_tile_mv(blocks, col_of_slot, x):
    """y = A x in f64 on the host from the numpy tiles: blocks (nrb, k, bs,
    bs), col_of_slot (nrb, k) each tile's block column, x (n,).  Padding
    tiles are zeros; x is zero-padded to the columns the tiles reach."""
    bs = blocks.shape[-1]
    ncb = max(int(col_of_slot.max()) + 1, -(-x.shape[0] // bs))
    xb = np.zeros(ncb * bs)
    xb[: x.shape[0]] = x
    xb = xb.reshape(ncb, bs)
    y = np.zeros((blocks.shape[0], bs))
    for k in range(blocks.shape[1]):
        y += np.einsum("rij,rj->ri", blocks[:, k].astype(np.float64),
                       xb[col_of_slot[:, k]])
    return y.reshape(-1)


def feasibility_vectors(m, n, seed=29):
    """(x0, s0): x0 ~ U(0.1, 0.9) inside the box, s0 = max(0, N(0, 0.5)),
    f64, so that b = A x0 + s0 makes {Ax + s = b, x in [0,1]^n, s >= 0}
    feasible by construction."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 0.9, n), np.maximum(0.0, rng.normal(0.0, 0.5, m))


def lp_from_operator(op, vectors, device):
    """(b, c, optimum) with b = A x0 + s0 and c = r0 - A' y0 from one
    ``mv_pair`` call; the optimum c'x0 = -b'y0 is certified by (x0, y0)."""
    import torch

    x0, y0, s0, r0 = (torch.as_tensor(v, device=device) for v in vectors)
    Ax0, ATy0 = op.mv_pair(x0, y0)
    b, c = Ax0 + s0, r0 - ATy0
    return b, c, float(torch.dot(c.double(), x0.double()))


# ----------------------------------------------------------------- timing
def median_ms(fn, reps=30, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profiled(fns, reps):
    """The profiler over ``reps`` rounds (after one) in which each fn of
    ``fns``, a callable or a sequence of them, is called in turn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fns = (fns,) if callable(fns) else tuple(fns)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    return prof


def device_ms(fn, reps=20):
    """Device time of one call (ms): the kernels' own time from the
    profiler's CUDA trace, without the host's launch cost; None when the
    trace holds no device time."""
    total_us = sum(e.self_device_time_total
                   for e in _device_events(_profiled(fn, reps)))
    return total_us / reps / 1e3 if total_us > 0 else None


def graph_us(fn, calls=50, reps=10):
    """Per-call device time (us) of ``calls`` calls of fn captured in one
    CUDA graph and replayed: launch gaps included, host excluded.  Returns
    (us, the outputs of the graph's last call)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * calls), out


def _kernel_name(key):
    """A profiler row's function name, without namespace or arguments."""
    m = re.search(r"\w+(?=[<(])", key)
    return m.group(0) if m else key[:40]


def kernel_breakdown(fn, reps=20):
    """(kernel records per call, device ms per call of each kernel by name,
    the record count of each) from the profiler; memcpy and memset rows are
    not kernels.  Printed only: the profiler has been seen to lose a record
    (39 over 20 calls of K1), so launches are counted on the device."""
    kernels = [e for e in _device_events(_profiled(fn, reps))
               if not e.key.lower().startswith(("memcpy", "memset"))]

    return (sum(e.count for e in kernels) / reps,
            {_kernel_name(e.key): e.self_device_time_total / reps / 1e3
             for e in kernels},
            {_kernel_name(e.key): e.count for e in kernels})


def _device_events(prof):
    """The profiler's device-side rows (kernels, copies, fills): an
    operator's row carries its kernels' time again, so summing every row
    would count device time twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def profile_solve(run, top=6):
    """Wall time, device-busy time and the top kernels of one solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sol = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    events.sort(key=lambda e: -e.self_device_time_total)
    return sol, {"wall_s": wall, "device_busy_s": busy_s,
                 "device_idle_share": 1.0 - busy_s / wall,
                 "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                                  e.count] for e in events[:top]]}


def compare(name, kernel, plain):
    """Kernel vs plain on the same inputs: errors, agreement, times."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    abs_err, rel_err = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float(d.max() / w.abs().max().clamp_min(1e-30)))
        if not bool((d <= ATOL + RTOL * w.abs()).all()):
            raise AssertionError(f"{name}: kernel disagrees with plain "
                                 f"(max abs err {abs_err})")
    again = kernel()
    deterministic = all(torch.equal(a, g) for a, g in zip(again, got))
    return {"max_abs_err": abs_err, "max_rel_err": rel_err,
            "deterministic": deterministic,
            "ms": median_ms(kernel), "plain_ms": median_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed_solve(solve_fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve_fn()
    torch.cuda.synchronize()
    return sol, time.perf_counter() - t0


def bound(nbytes, flops):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the f32 operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tile_bound(stored_tiles, pair, xb, yb):
    """Bound of a tile-table kernel: each stored tile read once, the input
    vectors read once and the outputs written once; 2 (4 for a pair) flops
    per tile entry."""
    entries = stored_tiles * TILE * TILE
    nbytes = 4 * entries + sum(4 * t.numel() for t in (*xb, *yb))
    return bound(nbytes, (4 if pair else 2) * entries)


def _stored(col_of_slot, counts):
    """(row block, slot, column) of each stored tile, columns ascending
    within a row block."""
    k = np.arange(col_of_slot.shape[1])
    r, s = np.nonzero(k[None, :] < counts[:, None])
    c = col_of_slot[r, s]
    order = np.lexsort((c, r))
    return r[order], s[order], c[order]


def library_mv(blocks, col_of_slot, counts, ncols, dev):
    """One PyTorch call computing y = A x over a tile table's stored tiles,
    the yardstick for K4/K5 (timed here, never called by the port): a
    block-sparse ``torch.sparse_bsr_tensor`` matvec (cuSPARSE)."""
    import torch

    r, s, c = _stored(col_of_slot, counts)
    nrb = blocks.shape[0]
    vals = blocks[torch.as_tensor(r, device=dev), torch.as_tensor(s, device=dev)]
    crow = np.zeros(nrb + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=nrb), out=crow[1:])
    bsr = torch.sparse_bsr_tensor(torch.as_tensor(crow, device=dev),
                                  torch.as_tensor(c, device=dev), vals,
                                  (nrb * TILE, ncols * TILE))
    return lambda x: bsr @ x



def k1_lanes(name, A, op, dev):
    """K1 over lanes (``PaddedDenseOp.mv_pair`` on (B, k) vectors: one
    launch of the lane tile kernel and one of its sum) at phase 1's shape
    ``name``: for each of K1_LANE_COUNTS lanes, as rows of a larger state
    (q_mul's slices), lane b bit-equal to the single-vector K1 on lane b's
    vectors and within tolerance of the plain version, one launch of each
    lane kernel counted on the device; then, at LINESEARCH_LANES lanes, its
    time per call replayed from a CUDA graph (bit-equal) against that of
    LINESEARCH_LANES single calls (gated at K1_LANES_OVER_SINGLES at the
    dense LP's 1000^2, printed at the edge shapes), the
    profiler's device times of both, its bound and the lane-batched cuBLAS
    pair.  Returns the LINESEARCH_LANES row."""
    import torch
    from fos_tpu_torch.linalg import _cuda
    from fos_tpu_torch.linalg.dense_pair import fused_matvec_lanes_plain

    M, N = A.shape
    g = np.random.default_rng(M * 7 + N)
    out = {}
    for B in K1_LANE_COUNTS:
        state = torch.as_tensor(g.standard_normal(
            (B, N + M + 1), dtype=np.float32), device=dev)
        X1, X2 = state[:, :N], state[:, N:N + M]
        res = compare(f"{name}_lanes_{B}", lambda: op.mv_pair(X1, X2),
                      lambda: fused_matvec_lanes_plain(A, X1, X2))
        _cuda.device_launch_counts(reset=True)
        Y, Z = op.mv_pair(X1, X2)
        counts = _cuda.device_launch_counts(reset=True)
        singles = [op.mv_pair(X1[b], X2[b]) for b in range(B)]
        res["bit_equal_to_single"] = all(
            torch.equal(Y[b], y) and torch.equal(Z[b], z)
            for b, (y, z) in enumerate(singles))
        res["launches_per_call"] = {
            k: counts[k] for k in ("fused_matvec_lanes",
                                   "fused_matvec_lanes_sum", "fused_matvec",
                                   "fused_matvec_sum")}
        res.update(bound(4 * (M * N + 2 * B * (M + N)), 4 * B * M * N))
        if B == LINESEARCH_LANES:
            # the sum is a programmatic dependent launch: its blocks start
            # while the tiles run and wait, so the profiler's durations
            # overlap; a graph replay's time per call does not
            (res["profiler_kernels_per_call"], res["device_ms_by_kernel"],
             _) = kernel_breakdown(lambda: op.mv_pair(X1, X2))
            res["graph_us"], replayed = graph_us(lambda: op.mv_pair(X1, X2))
            res["graph_bit_equal"] = all(
                torch.equal(a, b) for a, b in zip(replayed, (Y, Z)))
            res["singles_device_ms"] = device_ms(lambda: [
                op.mv_pair(X1[b], X2[b]) for b in range(B)])
            res["singles_graph_us"], _ = graph_us(lambda: [
                op.mv_pair(X1[b], X2[b]) for b in range(B)], calls=10)
            res["lanes_over_singles"] = (res["graph_us"]
                                         / res["singles_graph_us"])
            Xc1, Xc2 = X1.contiguous(), X2.contiguous()
            res["library"] = "torch.matmul(X1, A.T), torch.matmul(X2, A)"
            res["library_ms"] = median_ms(
                lambda: (torch.matmul(Xc1, A.T), torch.matmul(Xc2, A)))
            res["library_device_ms"] = device_ms(
                lambda: (torch.matmul(Xc1, A.T), torch.matmul(Xc2, A)))
            res["share_of_bound"] = res["bound_ms"] * 1e3 / res["graph_us"]
        emit({"phase": "kernel", "name": "fused_matvec_lanes",
              "shape": [B, M, N], **res})
        if (not res["bit_equal_to_single"] or not res["deterministic"]
                or res["launches_per_call"] != {
                    "fused_matvec_lanes": 1, "fused_matvec_lanes_sum": 1,
                    "fused_matvec": 0, "fused_matvec_sum": 0}
                or res.get("graph_bit_equal") is False
                or (name == "fused_matvec"
                    and res.get("lanes_over_singles", 0)
                    > K1_LANES_OVER_SINGLES)):
            raise AssertionError(f"{name} over {B} lanes: {res}")
        out = res
    return out


# ------------------------------------------------------------ graph route
def _if_taken(dev, make_cond):
    """A graph whose IF node the condition ``make_cond()`` sets; its body
    writes 1 to the returned flag."""
    import torch
    from fos_tpu_torch.linalg import control
    from fos_tpu_torch.solvers import graphs

    hit = torch.zeros((), dtype=torch.int32, device=dev)

    def fn(hit):
        control._Captured.if_(hit, make_cond, lambda: hit.fill_(1))
        return (hit,)

    g = graphs.Captured(fn, (hit,))

    def taken():
        return bool(g(hit)[0])   # the arg buffer is zeroed by the copy-in
    return taken


def condition_kernels(dev):
    """Each condition kernel of csrc/graph.cu against its plain version (the
    value ``Condition.plain()`` reads on the host): over a grid of inputs,
    the IF node it sets must take the branch the plain version takes, and
    a counter it resets or advances must end where the plain version's
    does.  ``max_abs_err`` counts the disagreements.  Then the cost of one
    pass of a WHILE node: the condition kernel and the node's relaunch of
    its body (``ms``), against the plain version's host read (``plain_ms``,
    what the eager loop pays per pass)."""
    import itertools

    import torch
    from fos_tpu_torch.linalg import control
    from fos_tpu_torch.solvers import graphs

    f32, i32 = torch.float32, torch.int32
    rn, tol2 = (torch.zeros((), dtype=f32, device=dev) for _ in range(2))
    it, k, status = (torch.zeros((), dtype=i32, device=dev) for _ in range(3))
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    out = {}

    # cg_continue: (rn > tol2) & (it < max_iters), NaN included
    taken = _if_taken(dev, lambda: control.CGContinue(rn, tol2, it, 5))
    bad = 0
    for r, t, i in itertools.product((0.0, 0.5, 1.0, 2.0, math.nan),
                                     (1.0,), (0, 4, 5, 6)):
        rn.fill_(r), tol2.fill_(t), it.fill_(i)
        bad += taken() != control.CGContinue(rn, tol2, it, 5).plain()
    out["cg_continue"] = {"max_abs_err": float(bad)}

    # cg_continue_lanes: any lane live, tol2 shared or one per lane, NaN
    # included, at the lane counts the paths use (one, the line search's
    # 31, a batch of 1024)
    bad = 0
    lrng = np.random.default_rng(0)
    for lanes, shared in itertools.product((1, 31, 1024), (True, False)):
        lrn = torch.zeros(lanes, dtype=f32, device=dev)
        lit = torch.zeros(lanes, dtype=i32, device=dev)
        ltol = torch.ones(() if shared else lanes, dtype=f32, device=dev)
        taken = _if_taken(dev, lambda: control.CGContinueLanes(lrn, ltol, lit,
                                                               5))
        for trial in range(12):
            lrn.copy_(torch.as_tensor(lrng.choice(
                [0.0, 0.5, 2.0, math.nan], lanes).astype(np.float32)))
            lit.copy_(torch.as_tensor(lrng.choice(
                [0, 4, 5, 6], lanes).astype(np.int32)))
            if trial % 3 == 0:
                lrn.fill_(0.5)   # no lane live
            bad += taken() != control.CGContinueLanes(lrn, ltol, lit,
                                                      5).plain()
    out["cg_continue_lanes"] = {"max_abs_err": float(bad)}

    # count_continue: every mode, with and without a status
    bad = 0
    for mode, with_status in itertools.product(
            (control.TEST, control.RESET, control.ADVANCE), (False, True)):
        st_arg = status if with_status else None
        taken = _if_taken(dev, lambda: control.Count(k, mode, 3, st_arg, 0))
        for kv, sv in itertools.product((0, 2, 3), (0, 1)):
            k.fill_(kv), status.fill_(sv)
            got = taken()
            k_got = int(k)
            k.fill_(kv)
            want = control.Count(k, mode, 3, st_arg, 0).plain()
            bad += (got != want) + (k_got != int(k))
    # with one status per lane (a batched solve's chunk loop): any lane
    lstatus = torch.zeros(1024, dtype=i32, device=dev)
    taken = _if_taken(dev, lambda: control.Count(k, control.TEST, 3, lstatus,
                                                 0))
    for kv, live_lanes in itertools.product((0, 2, 3), (0, 1, 1024)):
        lstatus.fill_(1)
        lstatus[:live_lanes].fill_(0)
        k.fill_(kv)
        bad += taken() != control.Count(k, control.TEST, 3, lstatus,
                                        0).plain()
    out["count_continue"] = {"max_abs_err": float(bad)}

    # flag_continue: the flag and its negation
    bad = 0
    for negate in (False, True):
        taken = _if_taken(dev, lambda: control.Flag(flag, negate))
        for v in (False, True):
            flag.fill_(v)
            bad += taken() != control.Flag(flag, negate).plain()
    out["flag_continue"] = {"max_abs_err": float(bad)}

    # one WHILE pass: a loop whose body holds only its condition kernel
    # (count_continue advancing the counter, flag_continue on a flag the
    # body recomputes) or, for cg_continue, CG's counter update
    passes = WHILE_PASSES

    def cg_loop(c):
        return control.while_loop(
            lambda c: control.CGContinue(rn, tol2, c[0], passes),
            lambda c: (c[0] + 1,), c)

    def flag_loop(c):
        return control.while_loop(
            lambda c: control.Flag(c[0] < passes),
            lambda c: (c[0] + 1,), c)

    def count_loop(c):
        return control.fori_loop(passes, lambda _, c: c, c)

    lane_rn = torch.ones(1024, dtype=f32, device=dev)

    def lanes_loop(c):
        return control.while_loop(
            lambda c: control.CGContinueLanes(lane_rn, tol2, c[0], passes),
            lambda c: (c[0] + 1,), c)

    rn.fill_(1.0), tol2.fill_(0.0)
    zero = torch.zeros((), dtype=i32, device=dev)
    lane_it = torch.zeros(1024, dtype=i32, device=dev)
    for name, loop, plain in (
            ("cg_continue", cg_loop,
             lambda: control.CGContinue(rn, tol2, zero, passes).plain()),
            ("count_continue", count_loop,
             lambda: control.Count(k, control.TEST, passes).plain()),
            ("flag_continue", flag_loop,
             lambda: control.Flag(zero < passes).plain()),
            ("cg_continue_lanes", lanes_loop,
             lambda: control.CGContinueLanes(lane_rn, tol2, lane_it,
                                             passes).plain())):
        start = lane_it if name == "cg_continue_lanes" else zero
        g = graphs.Captured(loop, ((start,),))
        res = g((start,))
        if name != "count_continue" and bool((res[0] != passes).any()):
            raise AssertionError(f"{name}: a WHILE loop made {int(res[0])} "
                                 f"passes, expected {passes}")
        out[name].update(
            ms=median_ms(lambda: g((start,)), reps=10) / passes,
            plain_ms=median_ms(plain), library_ms=None,
            **(bound(12 * 1024, 2 * 1024) if name == "cg_continue_lanes"
               else bound(16, 1)))
    bad = [k for k, v in out.items() if v["max_abs_err"]]
    if bad:
        raise AssertionError(f"condition kernels disagree with plain: {bad}")
    return out


@contextlib.contextmanager
def host_syncs():
    """The synchronising calls made inside the block, as PyTorch's sync
    debug mode reports them ("warn": one warning each; the host's reads of
    the device are among them)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        found = []
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(0)
            found.extend(w for w in caught
                         if "synchroniz" in str(w.message).lower()
                         and "prototype" not in str(w.message))


def run_routes(name, make_form, x0_of, eps, max_iters, checki=100,
               alg=None):
    """One solve three ways in this process: the eager chunks (the plain
    version), the graph chunks of ``engine.run`` (twice on one form: the
    first call captures), and ``fused_solve`` (twice: capture, then a
    replay), both fused calls under sync debug mode "error".  Gates equal
    status, iterations, CG iterations and final iterates (bit for bit)
    against the eager route's, and reports the memory each first call's
    capture added to what PyTorch reserves on the card.  ``alg``: DR unless
    given."""
    import torch
    from fos_tpu_torch import DR
    from fos_tpu_torch.solvers import engine

    alg = DR() if alg is None else alg

    def cg_total(state):
        cg = state.s1_state
        return None if cg.total_iters is None else int(cg.total_iters)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def reserved_mib():
        return torch.cuda.memory_reserved() / 2**20

    opts = dict(eps=eps, max_iters=max_iters, checki=checki, verbose=0)
    out = {"phase": "graphs", "path": name, "alg": type(alg).__name__}
    name_of = engine.Status.name
    with host_syncs() as syncs:
        eager, secs = timed(lambda: engine._run_eager(make_form(), alg,
                                                      **opts))
    out["eager"] = {"status": name_of(eager.status), "iters": eager.iters,
                    "host_syncs": len(syncs),
                    "cg_iters": cg_total(eager.state), "seconds": secs,
                    "iters_per_s": eager.iters / secs}
    form = make_form()
    for key in ("graph_first", "graph"):   # the first call captures
        before = reserved_mib()
        with host_syncs() as syncs:
            res, secs = timed(lambda: engine.run(form, alg, **opts))
        out[key] = {"status": name_of(res.status), "iters": res.iters,
                    "reserved_mib_added": reserved_mib() - before,
                    "host_syncs": len(syncs),
                    "cg_iters": cg_total(res.state), "seconds": secs,
                    "iters_per_s": res.iters / secs,
                    "bit_equal": bool(torch.equal(res.guess, eager.guess)),
                    "max_abs_diff": float((res.guess - eager.guess)
                                          .abs().max())}
    form = make_form()
    x0 = x0_of(form)
    for key in ("fused_first", "fused"):
        before = reserved_mib()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fres, secs = timed(lambda: engine.fused_solve(
                alg, form, x0, max_iters=max_iters, eps=eps, checki=checki))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        iters = int(fres.iters)
        # fused_solve's state is the one before getsol's projection
        pre = None if eager.state.s1_state.total_iters is None else (
            cg_total(eager.state) - int(eager.state.s1_state.last_iters))
        out[key] = {"status": name_of(int(fres.status)),
                    "reserved_mib_added": reserved_mib() - before,
                    "iters": iters, "cg_iters_before_getsol":
                        cg_total(fres.state), "eager_cg_iters_before_getsol":
                        pre, "seconds": secs, "iters_per_s": iters / secs,
                    "sync_debug": "error",
                    "bit_equal": bool(torch.equal(fres.guess, eager.guess)),
                    "max_abs_diff": float((fres.guess - eager.guess)
                                          .abs().max())}
    emit(out)
    e = out["eager"]
    for key in ("graph_first", "graph", "fused_first", "fused"):
        r = out[key]
        # a spent budget: run keeps Continue after a check at the last
        # iteration, fused_solve (as JAX's) checks the guess at the end
        spent = e["status"] == "Continue" and e["iters"] == max_iters
        fused = key.startswith("fused")
        if ((r["status"] != e["status"] and not (fused and spent))
                or r["iters"] != e["iters"]):
            raise AssertionError(f"{name}: the {key} route gives {r['status']}"
                                 f" at {r['iters']}, eager {e['status']} at "
                                 f"{e['iters']}")
        cg = ((r["cg_iters_before_getsol"], r["eager_cg_iters_before_getsol"])
              if fused else (r["cg_iters"], e["cg_iters"]))
        if cg[0] != cg[1] or not r["bit_equal"]:
            raise AssertionError(f"{name}: the {key} route's CG iterations "
                                 f"{cg[0]} (eager {cg[1]}), final iterate "
                                 f"bit-equal {r['bit_equal']} (max |d| "
                                 f"{r['max_abs_diff']})")
    return out, eager


def profile_routes(name, make_form, eps):
    """A PROFILE_ITERS-iteration solve on each route.  Eager: the profiler's
    kernel time over the wall time.  Graph (after a first run captures):
    the CUDA-event spans of the replays over the wall time, since the
    profiler's records of a replayed graph fall short of the kernels the
    device ran; then one profiled graph run for the rows it shows.  Each
    profiled run prints the device's launch counts beside its rows."""
    import torch
    from fos_tpu_torch import DR
    from fos_tpu_torch.linalg import _cuda
    from fos_tpu_torch.solvers import engine, graphs

    opts = dict(eps=eps, max_iters=PROFILE_ITERS, verbose=0)
    _cuda.device_launch_counts(reset=True)
    sol, eager = profile_solve(
        lambda: engine._run_eager(make_form(), DR(), **opts))
    eager["device_counts_of_that_run"] = {
        k: v for k, v in _cuda.device_launch_counts(reset=True).items() if v}
    eager["iters_per_s"] = sol.iters / eager["wall_s"]
    form = make_form()
    engine.run(form, DR(), **opts)
    torch.cuda.synchronize()
    with graphs.replay_spans() as spans:
        t0 = time.perf_counter()
        res = engine.run(form, DR(), **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    span_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    _cuda.device_launch_counts(reset=True)
    _, rows = profile_solve(lambda: engine.run(form, DR(), **opts), top=12)
    counted = {k: v for k, v in _cuda.device_launch_counts(reset=True).items()
               if v}
    graph = {"wall_s": wall, "replay_span_s": span_s,
             "device_idle_share": 1.0 - span_s / wall, "replays": len(spans),
             "iters_per_s": res.iters / wall,
             "profiler_rows_of_a_replayed_run": rows["top_kernels"],
             "device_counts_of_that_run": counted}
    emit({"phase": "graphs_profile", "path": name, "iters": res.iters,
          "eager": eager, "graph": graph})
    return eager, graph

# ------------------------------------------------------------- phase 6: cones
class LambdaMinSdpOp:
    """Matrix-free ``A = [svec(I)'; -I_L]`` of bench.py's single-block SDP
    (bench.py:343-375), with ``mv``, ``rmv`` and ``mv_pair``: a dense A
    would hold L^2 ~ 1.7e10 entries at d = 512."""

    def __init__(self, sI):
        self.sI = sI

    @property
    def shape(self):
        L = self.sI.shape[0]
        return (1 + L, L)

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mv(self, x):
        import torch

        return torch.cat([torch.dot(self.sI, x)[None], -x])

    def rmv(self, y):
        return self.sI * y[0] - y[1:]

    def mv_pair(self, x1, x2):
        return self.mv(x1), self.rmv(x2)


def sdp_problem(d, dev, seed=SDP_SEED, instance="numpy"):
    """bench.py's lambda-min SDP, ``min <C, X> s.t. tr X = 1, X psd``, in
    f32: (problem, svec(C), lambda_min(C) from a host f64 eigvalsh).
    ``instance`` "numpy": C made with numpy from ``seed``, scaled as
    bench.py scales it; "tpu": bench.py's own ``PRNGKey(29)`` draw, read
    from the repo's file (``fos_tpu_torch/tools/sdp_instance.py``)."""
    import torch
    from fos_tpu_torch.cones import Cone, ConeSpec, free, svec
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.tools import sdp_instance

    if instance == "tpu":
        C = sdp_instance.load(d)
    else:
        rng = np.random.default_rng(seed)
        C = (rng.standard_normal((d, d), dtype=np.float32)
             / np.float32(np.sqrt(d)))
        C = (C + C.T) / np.float32(2.0)
    L = d * (d + 1) // 2
    sC = svec(torch.as_tensor(C, device=dev))
    op = LambdaMinSdpOp(svec(torch.eye(d, device=dev)))
    bq = torch.zeros(1 + L, device=dev)
    bq[0] = 1.0
    K1 = ConeSpec(((Cone.ZERO, 1), (Cone.PSD, L)))
    prob = conic_problem(op, bq, sC, K1, free(L), device=dev)
    return prob, sC, float(np.linalg.eigvalsh(C.astype(np.float64))[0])


def kitchen_sink_problem():
    """tests/test_kitchen_sink.py's problem (every cone: zero, nonneg, SOC,
    rotated SOC, a 2x2 PSD block, an exp block, a power block), in f64 numpy
    and the port's cone specs: (A, b, c, K1, K2, c_x, p0, n)."""
    from fos_tpu_torch.cones import Cone, ConeSpec

    rng = np.random.default_rng(5)
    n = 5
    c = rng.standard_normal(n)
    p0 = rng.standard_normal(n) * 0.2
    nv = n + 4
    it, iq, iu, iv = n, n + 1, n + 2, n + 3
    rows, bs, blocks, params = [], [], [], []

    def add(r, bb, cone, dim, par=()):
        rows.append(r)
        bs.append(np.asarray(bb, float))
        blocks.append((cone, dim))
        params.append(par)

    r = np.zeros((1, nv)); r[0, :n] = 1.0
    add(r, [1.0], Cone.ZERO, 1)                          # sum(x) = 1
    r = np.zeros((2, nv)); r[0, it] = 1.0; r[1, iq] = 1.0
    add(r, [1.0, 1.0], Cone.ZERO, 2)                     # t = q = 1
    r = np.zeros((n, nv)); r[:, :n] = np.eye(n)
    add(r, np.full(n, 2.0), Cone.NONNEG, n)              # x <= 2
    r = np.zeros((1, nv)); r[0, iu] = 1.0
    add(r, [3.0], Cone.NONNEG, 1)                        # u <= 3
    r = np.zeros((1 + n, nv)); r[1:, :n] = -np.eye(n)
    add(r, np.concatenate([[1.5], -p0]), Cone.SOC, 1 + n)  # ||x - p0|| <= 1.5
    r = np.zeros((2 + n, nv))
    r[0, it] = -1.0; r[1, iq] = -1.0; r[2:, :n] = -np.eye(n)
    add(r, np.zeros(2 + n), Cone.SOC_ROTATED, 2 + n)     # ||x||^2 <= 2tq
    r = np.zeros((3, nv))
    r[0, 0] = -1.0; r[1, 1] = -np.sqrt(2.0); r[2, 2] = -1.0
    add(r, [1.0, 0.0, 1.0], Cone.PSD, 3)                 # [[1+x1,x2],[x2,1+x3]]
    r = np.zeros((3, nv)); r[0, 4] = -1.0; r[2, iu] = -1.0
    add(r, [0.0, 1.0, 0.0], Cone.EXP_PRIMAL, 3)          # u >= exp(x5)
    r = np.zeros((3, nv)); r[0, 0] = -1.0; r[1, 1] = -1.0; r[2, iv] = -1.0
    add(r, [2.0, 2.0, 0.0], Cone.POW_PRIMAL, 3, (0.4,))  # v <= pow mean
    cc = np.zeros(nv)
    cc[:n] = c
    cc[iv] = -0.2
    return (np.vstack(rows), np.concatenate(bs), cc,
            ConeSpec(tuple(blocks), tuple(params)),
            ConeSpec(((Cone.FREE, nv),)), c, p0, n)


def kitchen_sink_oracle(c, p0, n):
    """The kitchen sink's optimum by scipy SLSQP on the host
    (tests/test_kitchen_sink.py:_oracle): the best of five starts."""
    from scipy.optimize import minimize

    cons = [
        {"type": "eq", "fun": lambda w: w.sum() - 1.0},
        {"type": "ineq", "fun": lambda w: 2.0 - w},
        {"type": "ineq", "fun": lambda w: 1.5 - np.linalg.norm(w - p0)},
        {"type": "ineq", "fun": lambda w: 2.0 - w @ w},
        {"type": "ineq", "fun": lambda w: np.linalg.eigvalsh(
            np.array([[1 + w[0], w[1]], [w[1], 1 + w[2]]])).min()},
        {"type": "ineq", "fun": lambda w: 3.0 - np.exp(w[4])},
    ]

    def obj(w):
        return c @ w - 0.2 * (w[0] + 2.0) ** 0.4 * (w[1] + 2.0) ** 0.6

    best = None
    for seed in range(5):
        x0 = np.random.default_rng(seed).standard_normal(n) * 0.1
        res = minimize(obj, x0, constraints=cons, method="SLSQP",
                       options={"maxiter": 2000, "ftol": 1e-14})
        if res.success and (best is None or res.fun < best.fun):
            best = res
    return float(best.fun)


def max_entropy_problem():
    """tests/test_psd_exp_e2e.py:77: max sum(log x) s.t. sum(x) = 1 through
    five exp blocks; the optimum is x_i = 1/5."""
    from fos_tpu_torch.cones import Cone, ConeSpec, free

    k = 5
    nv = 3 * k
    A = np.zeros((4 * k + 1, nv))
    b = np.zeros(4 * k + 1)
    for i in range(k):
        A[3 * i, i] = A[3 * i + 1, k + i] = A[3 * i + 2, 2 * k + i] = -1.0
        A[3 * k + i, k + i] = 1.0
        b[3 * k + i] = 1.0
    A[4 * k, 2 * k:] = 1.0
    b[4 * k] = 1.0
    c = np.zeros(nv)
    c[:k] = -1.0
    return (A, b, c, ConeSpec(((Cone.EXP_PRIMAL, 3 * k), (Cone.ZERO, k + 1))),
            free(nv), k)


def nearest_psd_problem():
    """tests/test_psd_exp_e2e.py:21 (testPSD.jl): the PSD matrix nearest
    to Y, ``min t s.t. (t, v - svec(Y)) in SOC, v psd``; the answer is Y's
    eigenvalue clamp."""
    import torch
    from fos_tpu_torch.cones import Cone, ConeSpec, soc, svec

    ys = np.array([[-0.0064709, -0.22443], [-0.22443, -1.02411]])
    vs = svec(torch.as_tensor(ys)).numpy()
    L, nv = 3, 4
    A = np.zeros((1 + L, nv))
    b = np.zeros(1 + L)
    A[0, 0] = -1.0
    A[1:, 1:] = -np.eye(L)
    b[1:] = -vs
    c = np.zeros(nv)
    c[0] = 1.0
    w, V = np.linalg.eigh(ys)
    return (A, b, c, soc(1 + L),
            ConeSpec(((Cone.FREE, 1), (Cone.PSD, L))),
            (V * np.maximum(w, 0)) @ V.T)


def tile_coo(blocks, col_of_slot):
    """A tile table (nrb, S, 128, 128) with the column block of each slot
    as a scipy COO matrix of its nonzero entries, built on the host."""
    import scipy.sparse as sp

    nrb, S = blocks.shape[:2]
    ii, jj = np.nonzero(np.ones((TILE, TILE), bool))
    r = (np.arange(nrb)[:, None, None] * TILE + ii[None, None, :])
    c = (col_of_slot[:, :, None] * TILE + jj[None, None, :])
    vals = blocks.reshape(nrb, S, TILE * TILE)
    keep = vals != 0
    r = np.broadcast_to(r, vals.shape)[keep]
    ncols = (int(col_of_slot.max()) + 1) * TILE
    return sp.coo_matrix((vals[keep], (r, c[keep])),
                         shape=(nrb * TILE, max(ncols, nrb * TILE)))


def fresh(form):
    """A copy of a built form with no captured graphs of its own (the S1
    projector and the tables are shared): the routes run from the same
    set-up without repeating it."""
    f = copy.copy(form)
    f.__dict__.pop("_graphs", None)
    return f


def psd_projections(dev):
    """psd_projection: one d x d block at d = 512 and 1024 (f32, numpy seed
    29): the tuned and the uniform polynomial filters and eigh against a
    host f64 eigh, their call times (CUDA events) and the filters' FLOP
    bounds; and whether a capture can hold ``torch.linalg.eigh``."""
    import torch
    from fos_tpu_torch.cones.project import psd_project_eigh
    from fos_tpu_torch.cones.psd_poly import (POWER_ITERS,
                                              psd_project_poly)

    for d in PSD_SIDES:
        rng = np.random.default_rng(SDP_SEED)
        C = rng.standard_normal((d, d), dtype=np.float32) / np.float32(
            np.sqrt(d))
        X = (C + C.T) / np.float32(2.0)
        w, V = np.linalg.eigh(X.astype(np.float64))
        ref = (V * np.maximum(w, 0.0)) @ V.T
        norm2 = float(np.abs(w).max())
        Xt = torch.as_tensor(X, device=dev)
        gemv = POWER_ITERS * 2 + 1
        methods = (
            ("poly_tuned", lambda: psd_project_poly(Xt), 9 * 3 + 2 * 2 + 1),
            ("poly_uniform_10_12", lambda: psd_project_poly(
                Xt, quintic_iters=10, cubic_iters=12), 10 * 3 + 12 * 2 + 1),
            ("eigh", lambda: psd_project_eigh(Xt), None))
        out = {"d": d, "norm2": norm2}
        for name, fn, gemms in methods:
            P = fn().double().cpu().numpy()
            res = {"rel_err": float(np.abs(P - ref).max()) / norm2,
                   "ms": median_ms(fn, reps=10, warmup=2)}
            if gemms is not None:
                flops = gemms * 2 * d ** 3 + gemv * 2 * d * d
                res.update(gemms=gemms, gemvs=gemv, flops=flops,
                           **bound(4 * 2 * d * d, flops))
                res["graph_ms"] = graph_us(fn, calls=2, reps=5)[0] / 1e3
                res["share_of_bound"] = res["bound_ms"] / res["graph_ms"]
            out[name] = res
        emit({"phase": "psd_projection", **out})
        if out["poly_tuned"]["rel_err"] > PSD_GATE:
            raise AssertionError(f"psd_projection d={d}: tuned poly error "
                                 f"{out['poly_tuned']['rel_err']} ||X||_2")
    # can torch.linalg.eigh be captured?  In a process of its own: a failed
    # capture is not left behind in this one
    probe = ("import torch\n"
             "x = torch.eye(64, device='cuda') + 0.01 * torch.randn(64, 64, "
             "device='cuda')\nx = x + x.T\ntorch.linalg.eigh(x)\n"
             "torch.cuda.synchronize()\ng = torch.cuda.CUDAGraph()\n"
             "torch.cuda.set_sync_debug_mode('error')\n"
             "try:\n    with torch.cuda.graph(g):\n        torch.linalg.eigh(x)"
             "\n    print('captured')\nexcept Exception as e:\n"
             "    print('refused:', type(e).__name__, str(e)[:300])\n")
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300)
    emit({"phase": "eigh_capture_probe", "rc": res.returncode,
          "stdout": res.stdout.strip()[-400:],
          "stderr": res.stderr.strip()[-400:]})


def sdp_cells(dev):
    """sdp_single_512 and sdp_single_1024, each on the numpy-seed instance
    and on the TPU's own (bench.py's ``PRNGKey(29)`` draw, from the repo's
    file): DR iterations/s on the graph route (fused_solve, eps = 0, timed
    after its capture), then the quality run, GAPA(0.8, 0.9) at eps = 1e-5
    in one fused_solve (bench.py's 1000-iteration segments gave the same
    bits at d = 1024 on both instances, PERF.md).  d = 512 on the numpy
    instance is gated: Optimal and |obj - lambda_min| / |lambda_min| <=
    1e-3; the others are printed, with the final tau and kappa."""
    import torch
    from fos_tpu_torch import DR, GAPA, Status
    from fos_tpu_torch.problems.hsde import HSDEForm
    from fos_tpu_torch.solvers import engine

    for (d, quality_iters, rate_iters, first), instance in (
            (cell, inst) for inst in ("numpy", "tpu") for cell in SDP_CELLS):
        gated = first and instance == "numpy"
        prob, sC, lam = sdp_problem(d, dev, instance=instance)
        L = d * (d + 1) // 2
        form = HSDEForm.build(prob, densify=False)
        x0 = form.initial_value(form.dtype)
        rate = []
        for _ in range(2):   # the first call captures
            res, secs = timed_solve(lambda: engine.fused_solve(
                DR(), form, x0, max_iters=rate_iters, eps=0.0, checki=50))
            rate.append(int(res.iters) / secs)
        res, secs = timed_solve(lambda: engine.fused_solve(
            GAPA(0.8, 0.9), form, x0, max_iters=quality_iters, eps=1e-5,
            checki=100))
        def rel_obj(res):
            g = res.guess.double()
            obj = float(torch.dot(sC.double(), g[:L]) / g[form.l - 1])
            return obj, abs(obj - lam) / abs(lam)

        obj, rel = rel_obj(res)
        tau, kappa = (float(res.guess[k]) for k in (form.l - 1,
                                                    2 * form.l - 1))
        row = {"phase": f"sdp_single_{d}", "instance": instance, "d": d,
               "L": L,
               "psd_method": form.psd_method, "route": form.route,
               "dr_iters_per_s_first_call": rate[0],
               "dr_iters_per_s": rate[1], "quality_alg": "GAPA(0.8, 0.9)",
               "eps": 1e-5, "status": Status.name(int(res.status)),
               "iters": int(res.iters), "seconds": secs,
               "iters_per_s": int(res.iters) / secs, "obj": obj,
               "tau": tau, "kappa": kappa, "lambda_min_f64": lam,
               "rel_obj_err": rel, "gated": gated}
        emit(row)
        if gated and (row["status"] != "Optimal" or rel > SDP_GATE):
            raise AssertionError(f"sdp_single_{d} ({instance}): "
                                 f"{row['status']}, rel obj err {rel}")
        del form, res


def kitchen_sink_cells(dev):
    """kitchen_sink in f64: DR at eps = 1e-8 with psd_method "eigh"
    (gated: Optimal and the objective within the test's 1e-5 (1 + |f|) of
    SLSQP) and with "auto" ("poly" on the card: printed); the max-entropy
    exp problem (gated as its test: Optimal, x within 1e-4 of 1/k) and the
    nearest-PSD problem (gated with eigh as its test, to 1e-7; poly
    printed)."""
    from fos_tpu_torch import DR, solve

    A, b, cc, K1, K2, c, p0, n = kitchen_sink_problem()
    best = kitchen_sink_oracle(c, p0, n)
    rows = {}
    for method in ("eigh", "auto"):
        sol, secs = timed_solve(lambda: solve(
            A, b, cc, K1, K2, alg=DR(), eps=1e-8, max_iters=60000,
            verbose=0, device=dev, psd_method=method))
        x = sol.x.cpu().numpy()
        f = float(c @ x[:n]) - 0.2 * float(x[n + 3])
        row = {"psd_method": method, "route": sol.route,
               "status": sol.status, "iters": sol.iters, "seconds": secs,
               "iters_per_s": sol.iters / secs, "objective": f,
               "slsqp": best, "excess_over_slsqp": f - best,
               "gate": 1e-5 * (1 + abs(best)), "gated": method == "eigh"}
        rows[method] = row
    emit({"phase": "kitchen_sink", "dtype": "float64", "eps": 1e-8, **rows})
    r = rows["eigh"]
    if r["status"] != "Optimal" or r["excess_over_slsqp"] > r["gate"]:
        raise AssertionError(f"kitchen sink (eigh): {r}")
    A, b, c, K1, K2, k = max_entropy_problem()
    sol, secs = timed_solve(lambda: solve(A, b, c, K1, K2, alg=DR(), eps=1e-8,
                                          max_iters=40000, verbose=0,
                                          device=dev))
    x = sol.x.cpu().numpy()
    ent = {"status": sol.status, "iters": sol.iters, "seconds": secs,
           "route": sol.route,
           "max_abs_err_x": float(np.abs(x[2 * k:] - 1.0 / k).max()),
           "max_abs_err_t": float(np.abs(x[:k] - np.log(1.0 / k)).max())}
    emit({"phase": "max_entropy_exp", **ent})
    if (ent["status"] != "Optimal" or ent["max_abs_err_x"] > 1e-4
            or ent["max_abs_err_t"] > 1e-4):
        raise AssertionError(f"max entropy: {ent}")
    A, b, c, K1, K2, Yp = nearest_psd_problem()
    from fos_tpu_torch.cones import smat
    near = {}
    for method in ("eigh", "auto"):
        sol = solve(A, b, c, K1, K2, alg=DR(), eps=1e-9, max_iters=20000,
                    verbose=0, device=dev, psd_method=method)
        Y = smat(sol.x[1:]).cpu().numpy()
        near[method] = {"status": sol.status, "iters": sol.iters,
                        "route": sol.route,
                        "max_abs_err": float(np.abs(Y - Yp).max())}
    emit({"phase": "nearest_psd", **near})
    if near["eigh"]["status"] != "Optimal" or near["eigh"]["max_abs_err"] > 1e-7:
        raise AssertionError(f"nearest PSD (eigh): {near['eigh']}")


def exp_pow_projection(dev):
    """exp_pow_projection: bench.py:615's recipe, K = 65536 blocks of each
    (f32, N(0, 4) entries from numpy seed 31, power exponent 0.3): us per
    projection replayed from a CUDA graph, the kernels one projection
    launches (profiler over an eager call), the eager call's time, and the
    max error against the same function run in f64 on the host."""
    import torch
    from fos_tpu_torch.cones.exp import project_exp
    from fos_tpu_torch.cones.pow import project_pow

    rng = np.random.default_rng(31)
    V = (rng.standard_normal((EXP_POW_BLOCKS, 3)) * 2.0).astype(np.float32)
    Vt = torch.as_tensor(V, device=dev)
    a = torch.full((EXP_POW_BLOCKS,), 0.3, device=dev)
    V64 = torch.as_tensor(V, dtype=torch.float64)
    a64 = a.double().cpu()
    out = {}
    for name, fn, host in (
            ("exp", lambda: project_exp(Vt), lambda: project_exp(V64)),
            ("pow", lambda: project_pow(Vt, a), lambda: project_pow(V64, a64))):
        got = fn().double().cpu()
        ref = host()
        scale = 1.0 + V64.abs().amax(-1, keepdim=True)
        us, _ = graph_us(fn, calls=2, reps=5)
        kernels, _, _ = kernel_breakdown(fn, reps=2)
        out[name] = {"blocks": EXP_POW_BLOCKS,
                     "us_per_projection_graph": us,
                     "kernels_per_projection": kernels,
                     "ms_eager_call": median_ms(fn, reps=5, warmup=1),
                     "max_abs_err_vs_f64_host": float((got - ref).abs().max()),
                     "max_scaled_err": float(((got - ref).abs() / scale).max()),
                     "finite": bool(torch.isfinite(got).all())}
    emit({"phase": "exp_pow_projection", "dtype": "float32", **out})
    if not (out["exp"]["finite"] and out["pow"]["finite"]):
        raise AssertionError(f"exp/pow projection not finite: {out}")


def equilibrated_lps(dev, tables, unscaled_iters):
    """equilibrated_banded_lp / equilibrated_scattered_lp: phase 2's 32768^2
    LPs handed to ``solve`` as scipy sparse with ``equilibrate=True``
    (scaled on the host, then packed into the tile operators): host Ruiz
    seconds, iterations beside the unequilibrated run's, and the device's
    K2/K3 launch counts (gated > 0).  Gate: Optimal at eps = 1e-5 and the
    objective within 1e-3 of the certificate.  Returns the built forms for
    the routes."""
    import torch
    from fos_tpu_torch import DR, nonneg, solve
    from fos_tpu_torch.linalg import _cuda
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    forms = {}
    for phase, (blocks, slots, b, c, opt), key in zip(
            ("equilibrated_banded_lp", "equilibrated_scattered_lp"), tables,
            ("band_mv_pair", "bell_mv_pair")):
        t0 = time.perf_counter()
        A = tile_coo(blocks, slots)
        coo_s = time.perf_counter() - t0
        bh, ch = b.cpu().numpy(), c.cpu().numpy()
        m, n = A.shape
        t0 = time.perf_counter()
        form = HSDEForm.build(conic_problem(A, bh, ch, nonneg(m), nonneg(n),
                                            device=dev),
                              equilibrate=True, densify=False)
        build_s = time.perf_counter() - t0
        _cuda.device_launch_counts(reset=True)
        sol, secs = timed_solve(lambda: solve(
            A, bh, ch, nonneg(m), nonneg(n), alg=DR(), eps=GATE_EPS,
            max_iters=10000, verbose=0, device=dev, equilibrate=True,
            densify=False))
        counts = _cuda.device_launch_counts(reset=True)
        rel = abs(sol.objval - opt) / abs(opt)
        row = {"phase": phase, "shape": [m, n], "nnz": int(A.nnz),
               "operator": type(form.A).__name__,
               "host_coo_seconds": coo_s,
               "host_ruiz_seconds": form.setup_seconds["equilibrate"],
               "build_seconds": build_s, "status": sol.status,
               "iters": sol.iters,
               "iters_unequilibrated": unscaled_iters[phase],
               "seconds": secs, "iters_per_s": sol.iters / secs,
               "obj": sol.objval, "obj_certificate": opt, "rel_obj_err": rel,
               f"{key}_launches": counts[key]}
        emit(row)
        if sol.status != "Optimal" or rel > GATE_OBJ or counts[key] == 0:
            raise AssertionError(f"{phase}: {sol.status}, rel obj err {rel}, "
                                 f"{key} launches {counts[key]}")
        forms[phase] = form
        del A
        torch.cuda.empty_cache()
    return forms


def direct_dense_lp(dev, A1, b1, c1, opt1):
    """direct_dense_lp: phase 2's 1000x1000 LP with DR(direct=True) and
    pallas=True: the host f64 QR's seconds, iterations/s on the graph route
    and K1's device launches (the check's pair and v = Q u); gated as phase
    2 gates the dense LP (Optimal at eps = 1e-5, then continued to 1e-6 for
    the 1e-3 objective gate)."""
    import torch
    from fos_tpu_torch import DR, nonneg, solve
    from fos_tpu_torch.linalg import _cuda
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    N = A1.shape[0]
    f32 = torch.float32
    t0 = time.perf_counter()
    form = HSDEForm.build(conic_problem(A1, b1, c1, nonneg(N), nonneg(N),
                                        device=dev, dtype=f32),
                          direct=True, pallas=True)
    build_s = time.perf_counter() - t0
    _cuda.device_launch_counts(reset=True)
    sol, secs = timed_solve(lambda: solve(
        A1, b1, c1, nonneg(N), nonneg(N), alg=DR(direct=True), eps=GATE_EPS,
        dtype=f32, pallas=True, device=dev, verbose=0))
    k1 = _cuda.device_launch_counts(reset=True)["fused_matvec"]
    cont, csecs = timed_solve(lambda: solve(
        A1, b1, c1, nonneg(N), nonneg(N), alg=DR(direct=True),
        eps=GATE_EPS / 10, max_iters=10000, dtype=f32, pallas=True,
        device=dev, verbose=0, warm_start=sol))
    k1c = _cuda.device_launch_counts(reset=True)["fused_matvec"]
    rel = abs(cont.objval - opt1) / abs(opt1)
    row = {"phase": "direct_dense_lp", "shape": [N, N],
           "factor_shape": list(form.sets.s1.fac.shape),
           "factor_mib": form.sets.s1.fac.numel() * 4 / 2**20,
           "qr_init_seconds": form.setup_seconds["factor"],
           "build_seconds": build_s, "eps": GATE_EPS, "status": sol.status,
           "iters": sol.iters, "seconds": secs,
           "iters_per_s": sol.iters / secs, "rel_obj_err_at_eps": abs(
               sol.objval - opt1) / abs(opt1), "fused_matvec_launches": k1,
           "continued_eps": GATE_EPS / 10, "continued_status": cont.status,
           "continued_iters": cont.iters, "continued_seconds": csecs,
           "continued_iters_per_s": cont.iters / csecs,
           "continued_fused_matvec_launches": k1c, "rel_obj_err": rel}
    emit(row)
    if (sol.status != "Optimal" or cont.status != "Optimal"
            or rel > GATE_OBJ or k1 == 0):
        raise AssertionError(f"direct dense LP: {sol.status}, continued "
                             f"{cont.status}, rel obj err {rel}, K1 {k1}")
    return form


def cones_phase(dev, A1, b1, c1, opt1, lp_tables, unscaled_iters):
    """Phase 6 (this slice's path): the PSD, exp and power cones, Ruiz
    equilibration and the direct mode on the card, then the routes of the
    SDP, the kitchen sink (poly), the equilibrated LPs and the direct LP.
    Returns the device's launch counts over the phase."""
    import torch
    from fos_tpu_torch.linalg import _cuda
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    _cuda.device_launch_counts(reset=True)
    counts = collections.Counter()
    psd_projections(dev)
    sdp_cells(dev)
    kitchen_sink_cells(dev)
    exp_pow_projection(dev)
    counts.update(_cuda.device_launch_counts(reset=True))
    eq_forms = equilibrated_lps(dev, lp_tables, unscaled_iters)
    counts.update(_cuda.device_launch_counts(reset=True))
    direct = direct_dense_lp(dev, A1, b1, c1, opt1)
    counts.update(_cuda.device_launch_counts(reset=True))

    def initial(form):
        return form.initial_value(form.dtype)

    d = SDP_CELLS[0][0]
    prob, _, _ = sdp_problem(d, dev)
    A, b, cc, K1, K2, *_ = kitchen_sink_problem()
    routes = (
        (f"sdp_single_{d}", lambda: HSDEForm.build(prob, densify=False),
         1e-5, SDP_ROUTE_ITERS),
        ("kitchen_sink_poly", lambda: HSDEForm.build(
            conic_problem(A, b, cc, K1, K2, device=dev), psd_method="poly"),
         1e-8, KITCHEN_ROUTE_ITERS),
        *((name, lambda f=f: fresh(f), GATE_EPS, EQUILIBRATED_ROUTE_ITERS)
          for name, f in eq_forms.items()),
        ("direct_dense_lp", lambda: fresh(direct), GATE_EPS, 10000))
    for name, make_form, eps, iters in routes:
        run_routes(name, make_form, initial, eps, iters)
        counts.update(_cuda.device_launch_counts(reset=True))
    del eq_forms, direct
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------ phase 7: slice
# refine_dense_lp: the f64 sweep's budget and eps, and its objective gate:
# at least REFINE_GAIN times closer to the certificate than the f32 stage.
# DR's f64 sweep on this LP gains about a decade of residual per 15000
# iterations: eps 1e-9, or an objective within 1e-6, are out of reach of
# the time this script has (PERF.md, Findings).  20000 iterations (52.1 s)
# gave a gain of 212; 10000 (26.6 s), run since batched_wrappers_lp_128
# came in, gave 4.23e-5 against the f32 stage's 2.44e-3, a gain of 57.8
# (NVIDIA H100 80GB HBM3, 700 W)
REFINE_ITERS = 10000
REFINE_EPS = 1e-9
REFINE_GAIN = 50.0
# wrappers: the conic cells' budget; the feasibility cells' wrapper interval
# and check interval.  In f32 the feasibility test (consecutive iterates
# within eps) passes at the first check, whatever the algorithm (see
# FEAS_EPS_FLOORS), so the answer is what the iterations before it give:
# 100 iterations leave AP and the line search over AP at 4x the residual
# limit on the banded problem, DR within it; a first check at 1000 gives
# every wrapper the iterations it needs (the longstep wrapper with its
# default interval, 100: at 50 it stood 5% over the limit at 500).  The
# conic cells' budget was 5000 until PR 11: DR and the line search stop
# at 900, Anderson at 2100 (Optimal, PR 11's run 1), and Longstep, not
# gated on Optimal, ran all 5000 (39-52 s through its three routes)
WRAPPER_BUDGET = 2500
WRAPPER_FEAS_INTERVAL = 50
WRAPPER_FEAS_CHECKI = 1000
# batched LPs: bench.py:846-873's recipe, B x (64 x 96), numpy seeds, the
# budget of each cell (the loop runs until the slowest instance stops,
# tens of thousands of iterations: PERF.md) and its gate, the least number
# of instances Optimal within the budget.  Both cells run at a smaller
# depth than their whole solves (the 128 instances' took ~137 s to the
# slowest one's 51800 iterations, the 1024's ~283 s to 60000), each gated
# on a floor under what was measured at its budget (NVIDIA H100 80GB
# HBM3, 700 W: 46 of 128 and 239 of 1024 Optimal by 12000), every other
# instance still running; the
# segment length and the budget over which segments are held to the
# single run (a whole second solve of the 1024 instances takes longer than
# this script may); the route-agreement and rate budget; the objective
# gate against host f64 HiGHS, |obj - f*| <= 1e-3 (1 + |f*|).  To make
# room for batched_wrappers_lp_128 the 1024 instances run 6000 iterations
# (35.4 s, 6 Optimal, the first at 4800; 12000 took 65.6 s) and the
# segments are held over 2000 iterations (3000 before)
BATCHED_LP_CELLS = ((128, 13, 12000, 44), (1024, 17, 6000, 5))
BATCHED_LP_SHAPE = (64, 96)
BATCHED_SEGMENT = 1000
BATCHED_SEGMENT_CHECK = 2000
BATCHED_ROUTE_ITERS = 200
BATCHED_LP_GATE = 1e-3
# batched SDP: bench.py:173-229, instances, side, iterations, gate
BATCHED_SDP = (64, 64, 4000)
BATCHED_SDP_GATE = 1e-3
# batched_wrappers_lp_128: batched_lp_128's instances under GAPP and the
# three wrappers (default intervals), continuing DR's batched solve from
# its state at batched_lp_128's budget (its CG schedule at the floor),
# each algorithm's aux fresh.  From scratch no instance is Optimal within
# 1500 iterations under any of the four (DR's first stops at 7000), and
# from DR's iterate alone (``initx``: a fresh CG schedule) none within
# 1000.  One budget for the four solves, chosen from a measured run so
# that the cell fits the script's time (2000 iterations: 1.0-6.6 s a
# solve, the cell 29.9 s); the Optimal floors of the line search and
# Anderson, under what that run gave (45 and 44; GAPP 67, Longstep 117;
# NVIDIA H100 80GB HBM3, 700 W); the route-agreement budget,
# intervals of 20 (the longstep's 20 with 4 saved planes) and Anderson
# non-adaptive, so that each wrapper's extra work happens at least twice
# there (eager costs ~50-65 ms an iteration at 128 instances)
BATCHED_WRAPPER_ITERS = 2000
BATCHED_WRAPPER_MIN_OPTIMAL = {"linesearch": 40, "anderson": 40}
BATCHED_WRAPPER_ROUTE_ITERS = 60


def refine_dense_lp(dev, totals):
    """refine_dense_lp: phase 2's 1000x1000 LP with DR and pallas=True at
    eps = 1e-5 (handed over in f64 and cast to f32: phase 2's data, through
    K1), then ``refine`` in f64 toward eps = 1e-9 on the f64 data for up to
    REFINE_ITERS iterations (the plain products: the kernels take f32
    only).  Gates: the f32 stage Optimal, the sweep in f64 with no K1
    launch, its objective REFINE_GAIN times closer to the certificate than
    the f32 stage's (which stops 2.4e-3 from it).  The sweep's status is
    printed: eps 1e-9 takes DR far longer than REFINE_ITERS here.  The f32
    stage is also run alone first, for its iterations and time."""
    import torch
    from fos_tpu_torch import DR, nonneg, solve

    A1, b1, c1, opt1 = certificate_lp(DENSE_N, DENSE_N, seed=7,
                                      dtype=np.float64)
    N = A1.shape[0]
    kw = dict(alg=DR(), eps=GATE_EPS, dtype=torch.float32, pallas=True,
              device=dev, verbose=0)
    counted(totals)
    first, first_s = timed_solve(lambda: solve(A1, b1, c1, nonneg(N),
                                               nonneg(N), **kw))
    k1_f32 = counted(totals)["fused_matvec"]
    sol, all_s = timed_solve(lambda: solve(
        A1, b1, c1, nonneg(N), nonneg(N), refine=REFINE_ITERS,
        refine_kwargs={"eps": REFINE_EPS}, **kw))
    k1_both = counted(totals)["fused_matvec"]
    sweep_iters, sweep_s = sol.iters - first.iters, all_s - first_s
    rel = abs(sol.objval - opt1) / abs(opt1)
    gate = abs(first.objval - opt1) / abs(opt1) / REFINE_GAIN
    row = {"phase": "refine_dense_lp", "shape": [N, N],
           "f32_eps": GATE_EPS, "f32_status": first.status,
           "f32_iters": first.iters, "f32_seconds": first_s,
           "f32_rel_obj_err": abs(first.objval - opt1) / abs(opt1),
           "refine_eps": REFINE_EPS, "status": sol.status,
           "refine_iters": sweep_iters, "total_iters": sol.iters,
           "refine_seconds": sweep_s,
           "refine_iters_per_s": sweep_iters / max(sweep_s, 1e-9),
           "dtype": str(sol.x.dtype).replace("torch.", ""),
           "obj": sol.objval, "obj_certificate": opt1, "rel_obj_err": rel,
           "rel_obj_gate": gate, "fused_matvec_launches_f32": k1_f32,
           "fused_matvec_launches_f64_sweep": k1_both - k1_f32}
    emit(row)
    if (rel > gate or sol.x.dtype != torch.float64
            or row["fused_matvec_launches_f64_sweep"] != 0
            or first.status != "Optimal"):
        raise AssertionError(f"refine_dense_lp: {row}")


def linesearch_k1_count(form, interval, totals):
    """K1's device counts over one LineSearch(DR) boundary step of the
    dense LP, eager and replayed from a CUDA graph, against the counts the
    step's CG passes imply: single-vector calls for the real projection
    (its pair for r0 plus 2 unroll pairs per pass), and lane calls for the
    31 probe lanes, one call for all of them per product (their r0 pair
    plus 2 unroll pairs per pass, the passes running to the slowest lane:
    ``it_j`` CG iterations take ceil(it_j / unroll) passes).  Those counts
    come from the step's pieces run eagerly first."""
    import torch
    from fos_tpu_torch import DR, LineSearchWrapper
    from fos_tpu_torch.solvers import engine, graphs, wrappers
    from fos_tpu_torch.solvers.base import init_solver_state

    alg = LineSearchWrapper(DR(), lsinterval=interval)
    sets, inner = form.sets, alg.alg
    st = init_solver_state(alg, sets, form.initial_value(form.dtype))
    st = engine._run_steps(alg, form, st, interval - 1, 0)
    unroll = sets.s1.cg_unroll
    tmp2, s1 = inner.relaxed_s1(sets, st.x, st.s1_state, st.aux)
    _, x_new, _ = inner.relaxed_s2(sets, tmp2, st.s2_state, st.aux)
    res = x_new - st.x
    cands = st.x[None] + wrappers.ls_alphas(st.x)[:, None] * res[None]
    _, probes = sets.s1.project(cands, s1)
    lanes = cands.shape[0]
    real_passes = -(-int(s1.last_iters) // unroll)
    probe_iters = probes.last_iters.cpu().numpy()
    probe_passes = int(-(-probe_iters.max() // unroll))
    implied = 1 + 2 * unroll * real_passes
    implied_lanes = 1 + 2 * unroll * probe_passes
    counted(totals)
    eager = alg.step(sets, st, interval - 1)
    n_eager = counted(totals)
    form.prepare(st.x)
    g = graphs.Captured(lambda s: (alg.step(sets, s, None),), (st,))
    counted(totals)
    replayed = g(st)[0]
    n_graph = counted(totals)
    out = {"phase": "linesearch_k1_count", "lsinterval": interval,
           "probe_lanes": lanes, "cg_unroll": unroll,
           "real_cg_iters": int(s1.last_iters),
           "probe_cg_iters_max": int(probe_iters.max()),
           "probe_cg_iters_min": int(probe_iters.min()),
           "k1_implied": implied,
           "k1_eager": n_eager["fused_matvec"],
           "k1_graph": n_graph["fused_matvec"],
           "k1_sum_graph": n_graph["fused_matvec_sum"],
           "k1_lanes_implied": implied_lanes,
           "k1_lanes_eager": n_eager["fused_matvec_lanes"],
           "k1_lanes_graph": n_graph["fused_matvec_lanes"],
           "k1_lanes_sum_graph": n_graph["fused_matvec_lanes_sum"],
           "k1_single_calls_replaced": lanes * implied_lanes,
           "cg_continue_lanes_graph": n_graph["cg_continue_lanes"],
           "bit_equal": bool(torch.equal(replayed.x, eager.x))}
    emit(out)
    if not (implied == out["k1_eager"] == out["k1_graph"]
            == out["k1_sum_graph"]) or not (
                implied_lanes == out["k1_lanes_eager"]
                == out["k1_lanes_graph"] == out["k1_lanes_sum_graph"]) \
            or not out["bit_equal"]:
        raise AssertionError(f"LineSearch boundary step: K1 {out}")
    g.release()


def wrapper_dense_cells(dev, A1, b1, c1, totals):
    """wrappers_dense_lp: DR, LineSearch(DR, 100), Anderson(DR) and
    Longstep(DR, 100, 10) on the dense 1000x1000 LP with pallas=True at
    eps = 1e-5, each through the three routes (gated equal); then K1's
    exact count over one line-search step.  Not gated on Optimal: the
    longstep wrapper's sensitivity to its settings is reference
    behaviour."""
    import torch
    from fos_tpu_torch import (DR, AndersonWrapper, LineSearchWrapper,
                               LongstepWrapper, nonneg)
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    N = A1.shape[0]

    def make():
        return HSDEForm.build(conic_problem(
            A1, b1, c1, nonneg(N), nonneg(N), device=dev,
            dtype=torch.float32), pallas=True)

    algs = (("dr", DR()), ("linesearch", LineSearchWrapper(DR(),
                                                           lsinterval=100)),
            ("anderson", AndersonWrapper(DR())),
            ("longstep", LongstepWrapper(DR(), longinterval=100, nsave=10)))
    rows = {}
    for name, alg in algs:
        out, _ = run_routes(f"wrappers_dense_lp_{name}", make,
                            lambda f: f.initial_value(f.dtype), GATE_EPS,
                            WRAPPER_BUDGET, alg=alg)
        rows[name] = {k: out["graph"][k] for k in ("status", "iters",
                                                   "iters_per_s", "cg_iters")}
        rows[name]["fused_iters_per_s"] = out["fused"]["iters_per_s"]
        rows[name]["eager_iters_per_s"] = out["eager"]["iters_per_s"]
    emit({"phase": "wrappers_dense_lp", "shape": [N, N], "eps": GATE_EPS,
          "budget": WRAPPER_BUDGET, **rows})
    linesearch_k1_count(make(), 100, totals)


def wrapper_feasibility_cells(dev, feas, m, n, totals):
    """wrappers_feasibility: LineSearch(AP) and Longstep(DR) on the banded
    32768^2 feasibility problem (K4 per probe lane), LineSearch(DR) on the
    scattered one (K5), each through the three routes (gated equal) with
    the first check at WRAPPER_FEAS_CHECKI, gated Optimal with the answer
    inside the box, s >= 0, and phase 3's f64 host residual limit."""
    import torch
    from fos_tpu_torch import (AP, DR, AffinePlusLinearProjector, BlockSet,
                               Box, Feasibility, LineSearchWrapper,
                               LongstepWrapper, NonNeg)
    from fos_tpu_torch.problems.feasibility import FeasibilityForm

    eps = FEAS_EPS_FLOORS * (m + n) * float(np.finfo(np.float32).eps)
    k = WRAPPER_FEAS_INTERVAL
    cells = (("linesearch_ap_banded", "band",
              LineSearchWrapper(AP(), lsinterval=k)),
             ("longstep_dr_banded", "band", LongstepWrapper(DR())),
             ("linesearch_dr_scattered", "bell",
              LineSearchWrapper(DR(), lsinterval=k)))
    for name, kind, alg in cells:
        op, blocks_np, slots, b = feas[kind]

        def make():
            S1 = AffinePlusLinearProjector.create(op, b.astype(np.float32),
                                                  0.0, -1, device=dev)
            S2 = BlockSet([(Box(0.0, 1.0), n), (NonNeg(), m)])
            return FeasibilityForm.build(Feasibility(S1, S2, n + m),
                                         device=dev)

        counted(totals)
        out, eager = run_routes(f"wrappers_feasibility_{name}", make,
                                lambda f: f.initial_value(f.dtype), eps,
                                10000, checki=WRAPPER_FEAS_CHECKI, alg=alg)
        key = f"{kind}_mv"
        count = counted(totals)[key]
        z = eager.guess
        inside = (bool((z[:n] >= 0).all()) and bool((z[:n] <= 1).all())
                  and bool((z[n:] >= 0).all()))
        zh = z.double().cpu().numpy()
        resid = float(np.abs(host_tile_mv(blocks_np, slots, zh[:n]) + zh[n:]
                             - b).max())
        gate = FEAS_RESID * (1.0 + float(np.abs(b).max()))
        status = out["eager"]["status"]
        emit({"phase": "wrappers_feasibility", "cell": name,
              "shape": [m, n], "eps": eps, "status": status,
              "iters": out["eager"]["iters"],
              "graph_iters_per_s": out["graph"]["iters_per_s"],
              "inside_box_and_s_nonneg": inside, "resid_inf": resid,
              "resid_gate": gate, f"{key}_launches_three_routes": count})
        if status != "Optimal" or not inside or resid > gate or count == 0:
            raise AssertionError(f"wrappers_feasibility {name}: {status}, "
                                 f"inside {inside}, residual {resid} (gate "
                                 f"{gate}), {key} launches {count}")
        del eager
        torch.cuda.empty_cache()


def batched_lp(B, seed):
    """bench.py:846-873's batched LPs with numpy in place of jax.random:
    A ~ N(0, 1) (B, 64, 96), b = A |g| + |g'|, c = |g''|, f32."""
    rng = np.random.default_rng(seed)
    m, n = BATCHED_LP_SHAPE
    A = rng.standard_normal((B, m, n), dtype=np.float32)
    b = (np.einsum("bmn,bn->bm", A, np.abs(rng.standard_normal(
        (B, n), dtype=np.float32)))
         + np.abs(rng.standard_normal((B, m), dtype=np.float32)))
    c = np.abs(rng.standard_normal((B, n), dtype=np.float32))
    return A, b, c


def batched_lp_cells(dev):
    """batched_lp_128 / batched_lp_1024: DR in one ``solve_batched`` (a
    lane axis through fused_solve, one captured graph) at eps = 1e-5, with
    each cell's budget.  Gates: at least the cell's ``min_optimal``
    instances Optimal (a floor under what was measured at the cell's
    budget), every other one still running, every Optimal objective within 1e-3 (1 + |f*|)
    of a host f64 HiGHS solve; over the first BATCHED_SEGMENT_CHECK
    iterations, 1000-iteration segments give the single run's statuses,
    counts and bits (every instance that no segment boundary stopped); the
    eager and graph routes equal (status, iterations, CG iterations, bits)
    over BATCHED_ROUTE_ITERS iterations.  Prints the aggregate iterations/s
    (instances x iterations / wall) of a BATCHED_ROUTE_ITERS-iteration
    replay that runs every instance, and the memory peak.  Returns the
    first cell's data, HiGHS optima and DR statuses and counts, for
    :func:`batched_wrapper_cell`."""
    import torch
    from scipy.optimize import linprog
    from fos_tpu_torch import DR, build_batched_form, nonneg, solve_batched
    from fos_tpu_torch.parallel import batched

    m, n = BATCHED_LP_SHAPE
    l = m + n + 1
    first = None
    for B, seed, budget, min_optimal in BATCHED_LP_CELLS:
        A, b, c = batched_lp(B, seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device=dev)

        def run(**kw):
            return timed_solve(lambda: solve_batched(
                DR(), form, eps=GATE_EPS, checki=100, unroll=4, **kw))

        res, secs = run(max_iters=budget)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        status = res.status.cpu().numpy()
        iters = res.iters.cpu().numpy()
        g = res.guess.double().cpu().numpy()
        obj = np.einsum("bn,bn->b", c.astype(np.float64),
                        g[:, :n] / g[:, l - 1:l])
        t0 = time.perf_counter()
        ref = np.array([linprog(c[i].astype(np.float64),
                                A_ub=A[i].astype(np.float64),
                                b_ub=b[i].astype(np.float64),
                                bounds=(0, None), method="highs").fun
                        for i in range(B)])
        host_s = time.perf_counter() - t0
        optimal = status == 1
        err = (np.abs(obj - ref) / (1.0 + np.abs(ref)))[optimal]
        whole, _ = run(max_iters=BATCHED_SEGMENT_CHECK)
        seg, _ = run(max_iters=BATCHED_SEGMENT_CHECK,
                     segment_iters=BATCHED_SEGMENT)
        same = seg.iters == whole.iters
        segments = {
            "iters": BATCHED_SEGMENT_CHECK,
            "segment_iters": BATCHED_SEGMENT,
            "statuses": np.bincount(seg.status.cpu().numpy(),
                                    minlength=4).tolist(),
            "status_equal": bool(torch.equal(seg.status, whole.status)),
            "stopped_at_a_boundary": int((~same).sum()),
            "bit_equal": bool(torch.equal(seg.guess[same],
                                          whole.guess[same]))}
        opts = dict(max_iters=BATCHED_ROUTE_ITERS, eps=GATE_EPS, checki=100)
        eager, eager_s = timed_solve(lambda: batched._solve_batched_eager(
            DR(), form, **opts))
        graph, _ = timed_solve(lambda: solve_batched(DR(), form, **opts))
        # the rate: a replay that runs every instance for all its
        # iterations (eps = 0), after the call that captures it
        solve_batched(DR(), form, max_iters=BATCHED_ROUTE_ITERS, eps=0.0)
        _, rate_s = timed_solve(lambda: solve_batched(
            DR(), form, max_iters=BATCHED_ROUTE_ITERS, eps=0.0))
        routes = {
            "iters": BATCHED_ROUTE_ITERS, "eager_seconds": eager_s,
            "status_equal": bool(torch.equal(eager.status, graph.status)),
            "iters_equal": bool(torch.equal(eager.iters, graph.iters)),
            "cg_iters_equal": bool(torch.equal(
                eager.state.s1_state.total_iters,
                graph.state.s1_state.total_iters)),
            "bit_equal": bool(torch.equal(eager.guess, graph.guess))}
        row = {"phase": f"batched_lp_{B}", "instances": B,
               "shape": [m, n], "eps": GATE_EPS, "budget": budget,
               "optimal": int(optimal.sum()), "min_optimal": min_optimal,
               "statuses": np.bincount(status, minlength=4).tolist(),
               "iters_max": int(iters.max()),
               "iters_mean": float(iters.mean()),
               "iters_min": int(iters.min()), "seconds": secs,
               "agg_iters_per_s": B * BATCHED_ROUTE_ITERS / rate_s,
               "iters_per_s": BATCHED_ROUTE_ITERS / rate_s,
               "max_rel_obj_err_vs_highs": (float(err.max()) if err.size
                                            else math.inf),
               "host_highs_seconds": host_s, "segments": segments,
               "routes": routes, "peak_mib": peak, "route": form.route}
        emit(row)
        stopped_ok = (row["optimal"] >= min_optimal
                      and bool(np.isin(status, (0, 1)).all()))
        if (not stopped_ok or row["max_rel_obj_err_vs_highs"]
                > BATCHED_LP_GATE
                or not all(v for k, v in (*segments.items(),
                                          *routes.items())
                           if k.endswith("equal"))):
            raise AssertionError(f"batched_lp_{B}: {row}")
        if first is None:
            first = {"A": A, "b": b, "c": c, "ref": ref, "status": status,
                     "iters": iters, "budget": budget, "state": res.state}
        del form, res, whole, seg, eager, graph
        torch.cuda.empty_cache()
    return first


def _lp_objectives(c, guess, n, l):
    """c'x of each instance's guess, x = u / tau, in f64 on the host."""
    g = guess.double().cpu().numpy()
    return np.einsum("bn,bn->b", c.astype(np.float64),
                     g[:, :n] / g[:, l - 1:l])


def batched_wrapper_cell(dev, lp, totals):
    """batched_wrappers_lp_128: batched_lp_128's instances (its data and
    host f64 HiGHS optima, not solved again) on the graph route under
    GAPP(), LineSearchWrapper(DR()), AndersonWrapper(DR()) and
    LongstepWrapper(DR()), default intervals, BATCHED_WRAPPER_ITERS
    iterations each at eps = 1e-5, continuing DR's batched solve from its
    state at batched_lp_128's budget with the algorithm's aux fresh (the
    batched ``fused_solve`` with ``resume_state``, as each segment of
    ``solve_batched`` calls it).  The line search's 31 probes per instance
    are a (128, 31) lane axis through CG.  Gates: every guess finite;
    every Optimal objective within BATCHED_LP_GATE (1 + |f*|) of HiGHS;
    the line search's and Anderson's Optimal counts at least their floors;
    over BATCHED_WRAPPER_ROUTE_ITERS iterations from the same state
    (intervals of 20, Anderson non-adaptive) the graph route equal to the
    eager route in statuses, iterations and bits, for each algorithm; the
    lane condition kernel launched in the cell.  Printed: each algorithm's
    seconds and aggregate iterations/s; two instances continued alone by
    the single ``fused_solve`` under the line search from their lanes'
    states (one that DR stopped early, one it left running), their status
    and iterations beside their lanes' (f32 sum order moves these: the
    batched products are bmm, the single ones matmul).  Returns the
    device's launch counts over the cell."""
    import torch
    from fos_tpu_torch import (DR, GAPP, AndersonWrapper, LineSearchWrapper,
                               LongstepWrapper, build_batched_form, nonneg)
    from fos_tpu_torch.linalg import control
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm
    from fos_tpu_torch.solvers.engine import _fused_solve_eager, fused_solve

    counted(totals)
    A, b, c, ref = lp["A"], lp["b"], lp["c"], lp["ref"]
    B = A.shape[0]
    m, n = BATCHED_LP_SHAPE
    l = m + n + 1
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device=dev)
    algs = {"gapp": GAPP(), "linesearch": LineSearchWrapper(DR()),
            "anderson": AndersonWrapper(DR()),
            "longstep": LongstepWrapper(DR())}
    short = {"gapp": GAPP(iproj=20),
             "linesearch": LineSearchWrapper(DR(), lsinterval=20),
             "anderson": AndersonWrapper(DR(), adaptive=False),
             "longstep": LongstepWrapper(DR(), longinterval=20, nsave=4)}
    # one that DR stopped early, one still running at its budget
    order = np.argsort(np.where(lp["status"] == 1, lp["iters"], np.inf))
    alone = [int(order[0]), int(np.flatnonzero(lp["status"] == 0)[0])]
    rows, bad = {}, []
    def start(alg):
        """DR's state with the algorithm's fresh aux."""
        return lp["state"]._replace(aux=alg.init_aux(lp["state"].x))

    def solve(fused, alg, f, st, **kw):
        return fused(alg, f, st.x, resume_state=st, eps=GATE_EPS, **kw)

    i0 = lp["state"].i.cpu().numpy()   # DR's counts: the start's
    for name, alg in algs.items():
        res, secs = timed_solve(lambda: solve(
            fused_solve, alg, form, start(alg),
            max_iters=BATCHED_WRAPPER_ITERS, checki=100))
        status = res.status.cpu().numpy()
        iters = res.iters.cpu().numpy()
        finite = bool(torch.isfinite(res.guess).all())
        optimal = status == 1
        obj = _lp_objectives(c, res.guess, n, l)
        err = (np.abs(obj - ref) / (1.0 + np.abs(ref)))[optimal]
        ropts = dict(max_iters=BATCHED_WRAPPER_ROUTE_ITERS, checki=20)
        eager, eager_s = timed_solve(lambda: solve(
            _fused_solve_eager, short[name], form, start(short[name]),
            **ropts))
        graph, _ = timed_solve(lambda: solve(
            fused_solve, short[name], form, start(short[name]), **ropts))
        routes = {
            "status_equal": bool(torch.equal(eager.status, graph.status)),
            "iters_equal": bool(torch.equal(eager.iters, graph.iters)),
            "bit_equal": bool(torch.equal(eager.guess, graph.guess)
                              and torch.equal(eager.state.x, graph.state.x))}
        singles = []
        for i in alone if name == "linesearch" else ():
            f1 = HSDEForm.build(conic_problem(A[i], b[i], c[i], nonneg(m),
                                              nonneg(n), device=dev))
            one = control.tree_map(lambda t: t[i], start(alg))
            r1 = solve(fused_solve, alg, f1, one,
                       max_iters=BATCHED_WRAPPER_ITERS, checki=100)
            singles.append({"instance": i,
                            "dr_batched": [int(lp["status"][i]),
                                           int(lp["iters"][i])],
                            "alone": [int(r1.status), int(r1.iters)],
                            "lane": [int(status[i]), int(iters[i])]})
        rows[name] = {
            "seconds": secs,
            "agg_iters_per_s": float((iters - i0).sum()) / secs,
            "optimal": int(optimal.sum()),
            "min_optimal": BATCHED_WRAPPER_MIN_OPTIMAL.get(name),
            "statuses": np.bincount(status, minlength=4).tolist(),
            "iters_max": int(iters.max()), "iters_min": int(iters.min()),
            "finite": finite,
            "max_rel_obj_err_vs_highs": (float(err.max()) if err.size
                                         else None),
            "routes": {"iters": BATCHED_WRAPPER_ROUTE_ITERS,
                       "eager_seconds": eager_s, **routes},
            **({"alone": singles} if singles else {})}
        if (not finite or (err.size and err.max() > BATCHED_LP_GATE)
                or rows[name]["optimal"] < BATCHED_WRAPPER_MIN_OPTIMAL.get(
                    name, 0)
                or not all(routes.values())):
            bad.append(name)
    got = counted(totals)
    row = {"phase": "batched_wrappers_lp_128", "instances": B,
           "shape": [m, n], "eps": GATE_EPS,
           "budget": BATCHED_WRAPPER_ITERS, **rows,
           "launches": {k: got[k] for k in sorted(got) if got[k]}}
    emit(row)
    if bad or not got["cg_continue_lanes"]:
        raise AssertionError(f"batched_wrappers_lp_128: {bad}: {row}")
    return got


def batched_sdp_cell(dev):
    """batched_sdp_64: bench.py:173-229's 64 lambda-min SDPs of side 64 (C
    from numpy's seed 29), DR in 1000-iteration segments for 4000
    iterations at eps = 1e-5.  A = [svec(I)'; -I_L] is one (2081, 2080)
    matrix that every instance shares: it stays one matrix (a stride-0
    ``expand``) and its products are one matmul for all instances.  Gates:
    every instance Optimal, max |obj - lambda_min| / (1 + |lambda_min|)
    against a host f64 eigvalsh <= 1e-3."""
    import torch
    from fos_tpu_torch import DR, build_batched_form, solve_batched
    from fos_tpu_torch.cones import Cone, ConeSpec, free, svec

    Bs, d, iters = BATCHED_SDP
    L = d * (d + 1) // 2
    rng = np.random.default_rng(SDP_SEED)
    C = rng.standard_normal((Bs, d, d), dtype=np.float32) / np.float32(
        np.sqrt(d))
    C = (C + np.swapaxes(C, -1, -2)) / np.float32(2.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sC = svec(torch.as_tensor(C, device=dev))
    sI = svec(torch.eye(d, device=dev))
    A = torch.cat([sI[None], -torch.eye(L, device=dev)], 0).expand(
        Bs, 1 + L, L)
    bq = torch.zeros(Bs, 1 + L, device=dev)
    bq[:, 0] = 1.0
    form = build_batched_form(A, bq, sC, ConeSpec(((Cone.ZERO, 1),
                                                   (Cone.PSD, L))),
                              free(L), device=dev)
    res, secs = timed_solve(lambda: solve_batched(
        DR(), form, max_iters=iters, eps=1e-5, checki=100, unroll=2,
        segment_iters=1000))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    g = res.guess.double()
    obj = ((sC.double() * g[:, :L]).sum(-1) / g[:, form.l - 1]).cpu().numpy()
    lam = np.linalg.eigvalsh(C.astype(np.float64))[:, 0]
    err = np.abs(obj - lam) / (1.0 + np.abs(lam))
    status = res.status.cpu().numpy()
    it = res.iters.cpu().numpy()
    row = {"phase": "batched_sdp_64", "instances": Bs, "d": d, "L": L,
           "iters_budget": iters, "psd_method": form.psd_method,
           "optimal_frac": float((status == 1).mean()),
           "iters_max": int(it.max()), "iters_mean": float(it.mean()),
           "seconds": secs, "agg_iters_per_s": Bs * int(it.max()) / secs,
           "max_rel_obj_err_vs_eigh": float(err.max()),
           "A_stride0": form.A.stride(0) == 0,
           "A_mib": form.A.untyped_storage().nbytes() / 2**20,
           "A_materialised_mib": Bs * (1 + L) * L * 4 / 2**20,
           "peak_mib": peak}
    emit(row)
    if row["optimal_frac"] != 1.0 or row["max_rel_obj_err_vs_eigh"] > \
            BATCHED_SDP_GATE:
        raise AssertionError(f"batched_sdp_64: {row}")


def counted(totals):
    """The device's launch counts since the last read (which zeroes them),
    added to ``totals``."""
    from fos_tpu_torch.linalg import _cuda

    got = collections.Counter(_cuda.device_launch_counts(reset=True))
    totals.update(got)
    return got


def discard_counts():
    """Zero the device's launch counts without adding them anywhere: the
    launches of a reference run, before the run whose counts are read."""
    from fos_tpu_torch.linalg import _cuda

    _cuda.device_launch_counts(reset=True)


def slice_phase(dev, A1, b1, c1, feas, m, n):
    """Phase 7 (this slice's path): refine, the wrappers and the batched
    solve.  Returns the device's launch counts over the phase."""
    from fos_tpu_torch.linalg import _cuda

    _cuda.device_launch_counts(reset=True)
    totals = collections.Counter()
    refine_dense_lp(dev, totals)
    wrapper_dense_cells(dev, A1, b1, c1, totals)
    wrapper_feasibility_cells(dev, feas, m, n, totals)
    lp128 = batched_lp_cells(dev)
    wrapped = batched_wrapper_cell(dev, lp128, totals)
    batched_sdp_cell(dev)
    counted(totals)
    return totals, wrapped


# ------------------------------------------------------------- phase 8
# diff: K1's derivative rules at the two dense shapes (a K1_DIFF_REPEATS-
# call bit repeat of the backward).  The gated cells use LPs where DR
# reaches its fixed point: tests/test_diff.py's construction (a unique,
# strictly complementary optimum on k columns and k rows) with an
# orthogonal basis block (fos_tpu_torch/tools/lps.py), at full width
# (m, n, k, numpy seed) and in the batch (instances, m, n, k, seed).  The
# construction's own Gaussian basis block is ill-conditioned from 64x96 up,
# and there DR creeps ~1e-3 from the optimum for tens of thousands of
# iterations, in both packages (tests/test_torch_diff_conditioning.py),
# while the adjoint runs to its cap: that LP at 1000^2 runs beside
# the gated cell as the path, with a derivative budget cut to fit the
# script, its errors printed.  The derivative budgets: f32, the
# tolerances f32 reaches (fos_tpu_torch/diff.py's note; at the JAX
# package's damping 1e-10 CGLS drifts along the ray on f32 rounding);
# f64, the JAX package's defaults.  Gates: the envelope identities against
# the construction's optimum, scaled by 1 + ||x0|| + ||y0|| (f32 through
# K1 1e-3, f64 5e-5, the tolerance of tests/test_diff.py), the jvp's c'dx
# within DIFF_JVP_GATE (relative) of <g_b, v>, and each lane's g_c of
# sum(c'x) within DIFF_BATCHED_GATE of its x.
K1_DIFF_REPEATS = 20
DIFF_LP = (1000, 1000, 250, 37)
DIFF_PATH_F32 = dict(eps=1e-5, max_iters=40000, diff_cg_tol=1e-6,
                     diff_cg_maxiter=150, adjoint_tol=1e-5, adjoint_iters=10,
                     adjoint_damping=1e-8)
DIFF_GATED_LP = (1000, 1000, 250, 37)
DIFF_F32 = dict(eps=1e-6, max_iters=40000, diff_cg_tol=1e-6,
                diff_cg_maxiter=500, adjoint_tol=1e-6, adjoint_iters=300,
                adjoint_damping=1e-8)
DIFF_F64 = dict(eps=1e-8, max_iters=40000)
DIFF_GATE_F32 = 1e-3
DIFF_GATE_F64 = 5e-5
DIFF_JVP_GATE = 1e-3
DIFF_BATCHED = (64, 64, 96, 32, 41)
DIFF_BATCHED_GATE = 1e-3
# diff_batched_lp_wrapped: the same batch with the forward under the line
# search (interval 20) and Anderson (memory 5, non-adaptive), so that each
# wrapper acts within DR's few hundred iterations; each gradient within
# DIFF_WRAPPED_GATE of plain DR's (the backward differentiates the inner
# DR's frozen map in both)
DIFF_WRAPPED_GATE = 1e-3


def k1_derivative_rules(dev, shapes):
    """K1's autograd Function (``DensePairFn``) against the plain pair under
    autograd on the card: backward with and without A's cotangent, jvp with
    and without dA (phase 1's ATOL/RTOL), a bit repeat of the backward, the
    device's launches per backward without A's cotangent (one K1 call: one
    launch of each of its two kernels) and the median times of a backward
    and of the forward (CUDA events; the backward alone, on a retained
    graph).  Returns {name: row}."""
    import torch
    import torch.autograd.forward_ad as fwAD
    from fos_tpu_torch.linalg import _cuda
    from fos_tpu_torch.linalg.dense_pair import (PaddedDenseOp,
                                                 fused_matvec_plain)

    rng = np.random.default_rng(43)
    out = {}

    def close(got, want):
        err = 0.0
        for g, w in zip(got, want):
            d = (g - w).abs()
            err = max(err, float(d.max()))
            if not bool((d <= ATOL + RTOL * w.abs()).all()):
                return err, False
        return err, True

    for name, A in shapes:
        At = torch.as_tensor(A, device=dev)
        M, N = At.shape

        def vec(k):
            return torch.as_tensor(rng.standard_normal(k, dtype=np.float32),
                                   device=dev)

        x1, x2, gy, gz, dx1, dx2 = (vec(k) for k in (N, M, M, N, N, M))
        dA = torch.as_tensor(rng.standard_normal((M, N), dtype=np.float32),
                             device=dev)
        row = {}
        for need_A in (False, True):
            Ar = At.detach().requires_grad_(need_A)
            v1, v2 = x1.clone().requires_grad_(), x2.clone().requires_grad_()
            y, z = PaddedDenseOp(Ar).mv_pair(v1, v2)
            ins = (Ar, v1, v2) if need_A else (v1, v2)
            _cuda.device_launch_counts(reset=True)
            got = torch.autograd.grad((y, z), ins, (gy, gz),
                                      retain_graph=True)
            counts = _cuda.device_launch_counts(reset=True)
            want = torch.autograd.grad(fused_matvec_plain(Ar, v1, v2), ins,
                                       (gy, gz))
            key = "backward_with_gA" if need_A else "backward"
            row[f"{key}_max_abs_err"], row[f"{key}_ok"] = close(got, want)
            if not need_A:
                row["launches_per_backward"] = {
                    "dense_pair_tiles": counts["fused_matvec"],
                    "dense_pair_sum": counts["fused_matvec_sum"]}
                row["bit_repeat"] = all(
                    all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(
                        (y, z), ins, (gy, gz), retain_graph=True), got))
                    for _ in range(K1_DIFF_REPEATS))
                row["backward_ms"] = median_ms(lambda: torch.autograd.grad(
                    (y, z), ins, (gy, gz), retain_graph=True))
                row["forward_ms"] = median_ms(
                    lambda: PaddedDenseOp(Ar).mv_pair(v1, v2))
                row["plain_backward_ms"] = median_ms(
                    lambda: torch.autograd.grad(fused_matvec_plain(
                        Ar, v1, v2), ins, (gy, gz)))
        for with_dA in (False, True):
            with fwAD.dual_level():
                Ad = fwAD.make_dual(At, dA) if with_dA else At
                y, z = PaddedDenseOp(Ad).mv_pair(fwAD.make_dual(x1, dx1),
                                                 fwAD.make_dual(x2, dx2))
                got = (fwAD.unpack_dual(y).tangent,
                       fwAD.unpack_dual(z).tangent)
            want = fused_matvec_plain(At, dx1, dx2)
            if with_dA:
                want = tuple(w + e for w, e in zip(
                    want, fused_matvec_plain(dA, x1, x2)))
            key = "jvp_with_dA" if with_dA else "jvp"
            row[f"{key}_max_abs_err"], row[f"{key}_ok"] = close(got, want)
        emit({"phase": "k1_derivative", "name": name, "shape": [M, N],
              **row})
        bad = [k for k, v in row.items() if k.endswith("_ok") and not v]
        if (bad or not row["bit_repeat"]
                or set(row["launches_per_backward"].values()) != {1}):
            raise AssertionError(f"K1's derivative rules at {name}: {row}")
        out[name] = row
        del At, dA
    return out


def _k1_device_share(prof):
    """K1's share of the device time a profile recorded."""
    events = _device_events(prof)
    total = sum(e.self_device_time_total for e in events)
    k1 = sum(e.self_device_time_total for e in events
             if "dense_pair" in e.key)
    return k1 / total if total else None


def _counts(stats):
    """diff_solve's counts (its ``stats``), the slowest lane's, as ints."""
    import torch

    return {key: int(val.max()) if isinstance(val, torch.Tensor) else
            int(val) for key, val in stats.items()}


def _envelope_errors(g, x, y, x0, y0, scale):
    """The envelope identities against the construction's optimum (x0, y0)
    and the solve's distance from it, scaled."""
    gA, gb, gc = (t.double().cpu().numpy() for t in g)
    return {"g_c_err": float(np.abs(gc - x0).max() / scale),
            "g_b_err": float(np.abs(gb + y0).max() / scale),
            "g_A_err": float(np.abs(gA - np.outer(y0, x0)).max() / scale),
            "x_err": float(np.abs(x.detach().double().cpu().numpy()
                                  - x0).max() / scale),
            "y_err": float(np.abs(y.detach().double().cpu().numpy()
                                  - y0).max() / scale)}


def _differentiate(dev, lp, v, dtype, opts, pallas, totals, alg,
                   profiled=False):
    """diff_solve of ``lp`` = (A, b, c, x0, y0) with ``alg``: the forward, the
    reverse gradients of c'x in (A, b, c), then, given a direction ``v``
    in b, ``mode="jvp"`` along it (c'dx against <g_b, v>).  ``profiled``: a
    second backward under the profiler (K1's share of its device time)
    and the sync counter."""
    import torch
    import torch.autograd.forward_ad as fwAD
    from torch.profiler import ProfilerActivity, profile
    from fos_tpu_torch import diff_solve, nonneg

    A, b, c, x0, y0 = lp
    m, n = A.shape
    scale = 1.0 + np.abs(x0).max() + np.abs(y0).max()
    data = [torch.tensor(t, dtype=dtype, device=dev, requires_grad=True)
            for t in (A, b, c)]
    stats = {}
    kw = dict(alg=alg, pallas=pallas, device=dev, stats=stats, **opts)
    (x, y, _), fwd_s = timed_solve(lambda: diff_solve(
        *data, nonneg(m), nonneg(n), **kw))
    fwd = _counts(stats)
    counted(totals)
    g, bwd_s = timed_solve(lambda: torch.autograd.grad(
        torch.dot(data[2], x), data, retain_graph=profiled))
    k1 = counted(totals)
    row = {"dtype": str(dtype).replace("torch.", ""), "pallas": pallas,
           "options": opts, "status": fwd["status"], "iters": fwd["iters"],
           "forward_seconds": fwd_s, "backward_seconds": bwd_s,
           "backward_over_forward": bwd_s / fwd_s,
           **{key: val for key, val in _counts(stats).items()
              if key not in fwd},
           "k1_launches_backward": {"dense_pair_tiles": k1["fused_matvec"],
                                    "dense_pair_sum": k1["fused_matvec_sum"]},
           "finite": all(bool(torch.isfinite(t).all()) for t in g),
           "scale": scale, **_envelope_errors(g, x, y, x0, y0, scale)}
    if profiled:
        # device rows only: the backward launches ~2e5 kernels, and host
        # rows would multiply what the profiler has to sort
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        with host_syncs() as syncs, profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(torch.dot(data[2], x), data)
            torch.cuda.synchronize()
        row["backward_k1_device_share"] = _k1_device_share(prof)
        row["backward_host_syncs"] = len(syncs)
        row["profiled_backward_seconds"] = time.perf_counter() - t0
        counted(totals)
    if v is None:
        return row
    with fwAD.dual_level():
        bd = fwAD.make_dual(data[1].detach(), torch.tensor(
            v, dtype=dtype, device=dev))
        (xj, _, _), jvp_s = timed_solve(lambda: diff_solve(
            data[0].detach(), bd, data[2].detach(), nonneg(m), nonneg(n),
            mode="jvp", **kw))
        dx = fwAD.unpack_dual(xj).tangent
    cdx = float(torch.dot(data[2].detach().double(), dx.double()))
    gbv = float(np.dot(g[1].double().cpu().numpy(), v))
    row.update(jvp_seconds=jvp_s, c_dx=cdx, g_b_v=gbv,
               jvp_rel_err=abs(cdx - gbv) / max(abs(gbv), 1e-30),
               jvp_cgls_iters=_counts(stats)["cgls_iters"])
    counted(totals)
    return row


def diff_gaussian_basis_lp(dev, totals):
    """diff_gaussian_basis_lp: DIFF_LP (tests/test_diff.py's LP at full
    width) in f32 through K1 (``pallas=True``, DR) with the cut derivative
    budget of DIFF_PATH_F32: forward and backward.  Gates: the forward
    Optimal, finite gradients, K1 launched by the backward; the envelope
    errors are printed (DR stops short of this LP's optimum)."""
    import torch
    from fos_tpu_torch import DR
    from fos_tpu_torch.tools.lps import nondegenerate_lp

    m, n, k, seed = DIFF_LP
    lp = nondegenerate_lp(np.random.default_rng(seed), m, n, k)
    row = _differentiate(dev, lp, None, torch.float32, DIFF_PATH_F32, True,
                         totals, DR())
    emit({"phase": "diff_gaussian_basis_lp", "shape": [m, n], "k": k,
          "seed": seed, **row})
    if (row["status"] != 1 or not row["finite"]
            or not row["k1_launches_backward"]["dense_pair_tiles"] > 0):
        raise AssertionError(f"diff_gaussian_basis_lp: {row}")
    return row


def diff_dense_lp(dev, totals):
    """diff_dense_lp_float32 / _float64: DIFF_GATED_LP (the orthogonal-basis
    LP) differentiated on the card with DR, f32 through K1
    (``pallas=True``, with a profiled second backward) and f64 on the
    plain pair, each with its derivative budget (DIFF_F32, DIFF_F64), and
    the jvp along a seeded direction in b.  Gates: the forward Optimal;
    the envelope identities against the construction's optimum,
    max|g_c - x0|, max|g_b + y0|, max|g_A - y0 x0'| <= the dtype's gate
    times (1 + ||x0|| + ||y0||); the jvp's c'dx within DIFF_JVP_GATE of
    <g_b, v>; K1 launched by the f32 backward."""
    import torch
    from fos_tpu_torch import DR
    from fos_tpu_torch.tools.lps import orthogonal_basis_lp

    m, n, k, seed = DIFF_GATED_LP
    rng = np.random.default_rng(seed)
    lp = orthogonal_basis_lp(rng, m, n, k)
    v = rng.standard_normal(m)
    rows = {}
    for dtype, opts, pallas, gate in (
            (torch.float32, DIFF_F32, True, DIFF_GATE_F32),
            (torch.float64, DIFF_F64, False, DIFF_GATE_F64)):
        row = _differentiate(dev, lp, v, dtype, opts, pallas, totals, DR(),
                             profiled=pallas)
        name = f"diff_dense_lp_{row['dtype']}"
        emit({"phase": name, "shape": [m, n], "k": k, "seed": seed,
              "basis": "orthogonal", "gate": gate, **row})
        bad = [key for key in ("g_c_err", "g_b_err", "g_A_err")
               if not row[key] <= gate]
        if row["status"] != 1:
            bad.append("status")
        if not row["jvp_rel_err"] <= DIFF_JVP_GATE:
            bad.append("jvp_rel_err")
        if pallas and not row["k1_launches_backward"]["dense_pair_tiles"]:
            bad.append("k1_launches_backward")
        if bad:
            raise AssertionError(f"{name}: {bad} {row}")
        rows[name] = row
    return rows


def diff_batched_lp(dev):
    """diff_batched_lp: DIFF_BATCHED orthogonal-basis LPs, each its own
    draw, in f32 differentiated at once (the forward through
    solve_batched, the CG and CGLS solves on the lane axis).  Gates: every
    instance Optimal, g_c of sum(c'x) within DIFF_BATCHED_GATE of each
    lane's x."""
    import torch
    from fos_tpu_torch import DR, diff_solve, nonneg
    from fos_tpu_torch.tools.lps import orthogonal_basis_lp

    B, m, n, k, seed = DIFF_BATCHED
    rng = np.random.default_rng(seed)
    draws = [orthogonal_basis_lp(rng, m, n, k) for _ in range(B)]
    A, b, c, x0 = (np.stack([d[i] for d in draws]) for i in range(4))
    f32 = dict(dtype=torch.float32, device=dev)
    At, bt = torch.tensor(A, **f32), torch.tensor(b, **f32)
    ct = torch.tensor(c, **f32).requires_grad_()
    stats = {}
    (x, _, _), fwd_s = timed_solve(lambda: diff_solve(
        At, bt, ct, nonneg(m), nonneg(n), alg=DR(), device=dev,
        stats=stats, **DIFF_F32))
    status = stats["status"].cpu().numpy()
    iters = stats["iters"].cpu().numpy()
    (g,), bwd_s = timed_solve(lambda: torch.autograd.grad((ct * x).sum(),
                                                          ct))
    err = (g - x).detach().abs().amax(-1).cpu().numpy()
    row = {"phase": "diff_batched_lp", "instances": B, "shape": [m, n],
           "k": k, "seed": seed, "basis": "orthogonal", "options": DIFF_F32,
           "statuses": np.bincount(status, minlength=4).tolist(),
           "iters_max": int(iters.max()), "iters_mean": float(iters.mean()),
           "forward_seconds": fwd_s, "backward_seconds": bwd_s,
           **{key: val for key, val in _counts(stats).items()
              if key not in ("status", "iters")},
           "max_abs_g_c_minus_x": float(err.max()),
           "max_abs_x_minus_x0": float(np.abs(
               x.detach().double().cpu().numpy() - x0).max())}
    emit(row)
    if (row["statuses"][1] != B
            or not row["max_abs_g_c_minus_x"] <= DIFF_BATCHED_GATE):
        raise AssertionError(f"diff_batched_lp: {row}")
    return (At, bt, ct), g.detach()


def diff_batched_lp_wrapped(dev, data, g_plain):
    """diff_batched_lp_wrapped: diff_batched_lp's batch (``data``: its A,
    b and c on the card) with the forward under LineSearchWrapper(DR(),
    20) and AndersonWrapper(DR(), memory=5, adaptive=False) through
    ``solve_batched``; the backward differentiates the inner DR's frozen
    map.  Gates, for each: every instance Optimal, g_c of sum(c'x) within
    DIFF_BATCHED_GATE of each lane's x and within DIFF_WRAPPED_GATE of
    plain DR's gradient (``g_plain``).  Prints the forward's iterations
    and both times."""
    import torch
    from fos_tpu_torch import (DR, AndersonWrapper, LineSearchWrapper,
                               diff_solve, nonneg)

    B, m, n, k, seed = DIFF_BATCHED
    At, bt, c = data
    rows, bad = {}, []
    for name, alg in (("linesearch", LineSearchWrapper(DR(), lsinterval=20)),
                      ("anderson", AndersonWrapper(DR(), memory=5,
                                                   adaptive=False))):
        ct = c.detach().clone().requires_grad_()
        stats = {}
        (x, _, _), fwd_s = timed_solve(lambda: diff_solve(
            At, bt, ct, nonneg(m), nonneg(n), alg=alg, device=dev,
            stats=stats, **DIFF_F32))
        status = stats["status"].cpu().numpy()
        iters = stats["iters"].cpu().numpy()
        (g,), bwd_s = timed_solve(lambda: torch.autograd.grad(
            (ct * x).sum(), ct))
        rows[name] = {
            "statuses": np.bincount(status, minlength=4).tolist(),
            "iters_max": int(iters.max()), "iters_mean": float(iters.mean()),
            "forward_seconds": fwd_s, "backward_seconds": bwd_s,
            "max_abs_g_c_minus_x": float((g - x).detach().abs().max()),
            "max_abs_g_minus_plain": float((g - g_plain).abs().max())}
        if (rows[name]["statuses"][1] != B
                or not rows[name]["max_abs_g_c_minus_x"] <= DIFF_BATCHED_GATE
                or not rows[name]["max_abs_g_minus_plain"]
                <= DIFF_WRAPPED_GATE):
            bad.append(name)
    row = {"phase": "diff_batched_lp_wrapped", "instances": B,
           "shape": [m, n], "options": DIFF_F32, **rows}
    emit(row)
    if bad:
        raise AssertionError(f"diff_batched_lp_wrapped: {bad}: {row}")


def diff_phase(dev, A1, A4):
    """Phase 8 (this slice's path): implicit differentiation.  K1's
    derivative rules are held against the plain version first (their
    launches are comparisons, not the path's); the device's counts are
    zeroed before the differentiated solves and read after them."""
    from fos_tpu_torch.linalg import _cuda

    clock = [time.perf_counter()]
    k1 = k1_derivative_rules(dev, (("fused_matvec", A1),
                                   ("fused_matvec_4000", A4)))
    clock.append(time.perf_counter())
    _cuda.device_launch_counts(reset=True)
    totals = collections.Counter()
    diff_dense_lp(dev, totals)
    clock.append(time.perf_counter())
    diff_gaussian_basis_lp(dev, totals)
    clock.append(time.perf_counter())
    data, g_plain = diff_batched_lp(dev)
    clock.append(time.perf_counter())
    counted(totals)
    diff_batched_lp_wrapped(dev, data, g_plain)
    wrapped = counted(totals)
    clock.append(time.perf_counter())
    emit({"phase": "diff_timing", "seconds": dict(zip(
        ("k1_derivative_rules", "diff_dense_lp", "diff_gaussian_basis_lp",
         "diff_batched_lp", "diff_batched_lp_wrapped"),
        np.diff(clock).tolist()))})
    return totals, k1, wrapped


# ------------------------------------------------------------- phase 9
# the front end: the SCS/MathProgBase interface, the modeling DSL,
# checkpoints and the examples, driving K1-K3 from modeled data.
# front_dsl_lasso: bench.py:235-313's SOCP-lasso data (seed 3, m = n = 1000,
# A / sqrt(m), a 10% support, noise 0.01, lam = 0.1 max|A'b|, f32) in the
# form of examples/lasso.py's main_dsl; its oracle, FISTA on the host in f64,
# stops when its objective moves less than LASSO_ORACLE_RTOL relative
LASSO_SHAPE = (1000, 1000)
LASSO_SEED = 3
LASSO_ORACLE_RTOL = 1e-9
FRONT_BUDGET = 20000
# front_dsl_sparse_lp's feasibility gate, in f64 on the host:
# max(Ax - b)+ and max(-x)+ <= FRONT_RESID (1 + ||b||_inf)
FRONT_RESID = 1e-4
# front_checkpoint: GAPA iterations before the checkpoint
CHECKPOINT_ITERS = 300
CHECKPOINT_GATE = 1e-5
# front_examples: the arguments of tests/test_torch_examples.py (sizes for
# the CPU), except sparse_banded, which runs at its default on the card
# (m = 4096, the size the JAX package's example takes off the CPU)
EXAMPLE_ARGS = {
    "batched_scenario_lps": dict(B=2, m=6, n=10),
    "lasso": dict(m=20, n=40),
    "nnls": dict(m=12, n=8),
    "parametric_sweep": dict(steps=2, m=8, n=12),
    "portfolio": dict(n=20, k=3),
    "portfolio_modeling": dict(n=20, k=3, gammas=(1.0, 5.0)),
    "youla": dict(nq=4, nt=10),
}
EXAMPLES = ("batched_scenario_lps", "differentiable_lp", "lasso", "nnls",
            "parametric_sweep", "portfolio", "portfolio_modeling",
            "sdp_min_eigenvalue", "sparse_banded", "youla")


@contextlib.contextmanager
def spied(owner, name):
    """Record every call of ``owner.name`` made inside the block as
    (host seconds to a synchronised card, result, positional arguments);
    the call itself runs unchanged.  A classmethod stays one."""
    import torch

    raw = owner.__dict__[name]
    fn = raw.__func__ if isinstance(raw, classmethod) else raw
    calls = []

    def spy(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, out, args))
        return out

    setattr(owner, name, classmethod(spy) if isinstance(raw, classmethod)
            else spy)
    try:
        yield calls
    finally:
        setattr(owner, name, raw)


def _built(builds):
    """The operator one form build chose, the shape that reached it and
    the build's seconds (the cell's solve builds exactly one form)."""
    if len(builds) != 1:
        raise AssertionError(f"expected one form build, got {len(builds)}")
    secs, form, _ = builds[0]
    return {"operator": type(form.A).__name__,
            "operator_shape": list(form.A.shape), "build_seconds": secs}


def _launches(counts):
    return {k: counts[k] for k in ("fused_matvec", "fused_matvec_sum",
                                   "band_mv_pair", "bell_mv_pair")}


def _solve_row(sol, secs, build):
    """Seconds, iterations and rate of a solve whose form build is in
    ``build`` (the solve's seconds exclude the build's)."""
    solve_s = secs - build["build_seconds"]
    return {"status": sol.status, "iters": sol.iters, "seconds": secs,
            "solve_seconds": solve_s, "iters_per_s": sol.iters / solve_s,
            "obj": sol.objval}


def lasso_data(m, n, seed=LASSO_SEED):
    """bench.py's socp_lasso_bench data (numpy seed 3): A, b in f32 and
    lam = 0.1 max|A'b|."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    xstar = rng.standard_normal(n) * (rng.random(n) < 0.1)
    b = (A @ xstar + 0.01 * rng.standard_normal(m)).astype(np.float32)
    lam = float(0.1 * np.max(np.abs(A.T @ b)))
    return A, b, lam


def lasso_objective(A, b, lam, x):
    return float(0.5 * np.sum((A @ x - b) ** 2) + lam * np.abs(x).sum())


def lasso_oracle(A, b, lam, rtol=LASSO_ORACLE_RTOL, max_iters=200000):
    """min 0.5 ||Ax - b||^2 + lam ||x||_1 on the host in f64: proximal
    gradient (examples/lasso.py's ISTA oracle) accelerated as FISTA, until
    the objective moves less than ``rtol`` relative.  Returns (objective,
    iterations)."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    L = np.linalg.norm(A, 2) ** 2
    x = y = np.zeros(A.shape[1])
    t, f_old = 1.0, math.inf
    for k in range(1, max_iters + 1):
        g = A.T @ (A @ y - b)
        z = y - g / L
        x_new = np.sign(z) * np.maximum(np.abs(z) - lam / L, 0.0)
        t_new = (1.0 + math.sqrt(1.0 + 4.0 * t * t)) / 2.0
        y = x_new + (t - 1.0) / t_new * (x_new - x)
        x, t = x_new, t_new
        f = lasso_objective(A, b, lam, x)
        if abs(f_old - f) <= rtol * abs(f):
            return f, k
        f_old = f
    raise AssertionError(f"lasso oracle: no convergence in {max_iters}")


def front_solve_lp(dev, A1, b1, c1, opt1, dense_ref, totals):
    """front_solve_lp: phase 2's 1000x1000 certificate LP through
    ``solve_lp(c, A_ub=A, b_ub=b, ...)`` with phase 2's options: the same
    form (PaddedDenseOp, K1), so the same status, iterations and final
    iterate bits as phase 2's ``solve``; then phase 2's continuation to eps
    1e-6 and its 1e-3 objective gate."""
    import torch
    from fos_tpu_torch import DR, solve_lp
    from fos_tpu_torch.problems.hsde import HSDEForm

    opts = dict(alg=DR(), dtype=torch.float32, pallas=True, device=dev,
                verbose=0)
    counted(totals)
    with spied(HSDEForm, "build") as builds:
        sol, secs = timed_solve(lambda: solve_lp(c1, A_ub=A1, b_ub=b1,
                                                 eps=GATE_EPS, **opts))
    counts = counted(totals)
    build = _built(builds)
    same = {"status_equal": sol.status == dense_ref.status,
            "iters_equal": sol.iters == dense_ref.iters,
            "bit_equal": bool(torch.equal(sol.raw_z, dense_ref.raw_z))}
    cont, cont_s = timed_solve(lambda: solve_lp(
        c1, A_ub=A1, b_ub=b1, eps=GATE_EPS / 10, max_iters=10000,
        warm_start=sol, **opts))
    cont_counts = counted(totals)
    rel = abs(cont.objval - opt1) / abs(opt1)
    row = {"phase": "front_solve_lp", "shape": list(A1.shape),
           "eps": GATE_EPS, **build, **_solve_row(sol, secs, build),
           "phase2_iters": dense_ref.iters, **same,
           "continued": {"eps": GATE_EPS / 10, "status": cont.status,
                         "iters": cont.iters, "seconds": cont_s,
                         "obj": cont.objval, "obj_certificate": opt1,
                         "rel_obj_err": rel,
                         "fused_matvec_launches": cont_counts["fused_matvec"]},
           "launches": _launches(counts)}
    emit(row)
    if (not all(same.values()) or build["operator"] != "PaddedDenseOp"
            or counts["fused_matvec"] == 0 or cont.status != "Optimal"
            or rel > GATE_OBJ):
        raise AssertionError(f"front_solve_lp: {row}")


def front_load_problem_banded(dev, band, unscaled_iters, totals):
    """front_load_problem_banded: phase 2's 32768^2 block-tridiagonal LP as
    scipy CSR through ``load_problem`` with MathProgBase cone lists, then
    ``solve(problem=...)``: the build routes it to BandedBlockOp (K2).
    Gate: Optimal at eps 1e-5 within 1e-3 of the certificate, K2 launched;
    iterations beside phase 2's."""
    from fos_tpu_torch import DR, load_problem, solve
    from fos_tpu_torch.linalg.sparse_ell import (band_span_ratio,
                                                 bell_storage_ratio)
    from fos_tpu_torch.problems.hsde import HSDEForm

    blocks, slots, b, c, opt = band
    t0 = time.perf_counter()
    A = tile_coo(blocks, slots).tocsr()
    csr_s = time.perf_counter() - t0
    m, n = A.shape
    ratios = {"bell_storage_ratio": bell_storage_ratio(A),
              "band_span_ratio": band_span_ratio(A)}
    t0 = time.perf_counter()
    prob = load_problem(c.cpu().numpy(), A, b.cpu().numpy(),
                        [("NonNeg", range(m))], [("NonNeg", range(n))],
                        device=dev)
    load_s = time.perf_counter() - t0
    counted(totals)
    with spied(HSDEForm, "build") as builds:
        sol, secs = timed_solve(lambda: solve(
            problem=prob, alg=DR(), eps=GATE_EPS, max_iters=10000,
            verbose=0))
    counts = counted(totals)
    build = _built(builds)
    rel = abs(sol.objval - opt) / abs(opt)
    row = {"phase": "front_load_problem_banded", "shape": [m, n],
           "nnz": int(A.nnz), "eps": GATE_EPS, "host_csr_seconds": csr_s,
           "load_problem_seconds": load_s, **ratios, **build,
           **_solve_row(sol, secs, build), "obj_certificate": opt,
           "rel_obj_err": rel, "phase2_iters": unscaled_iters,
           "iters_reference": REFERENCE_ITERS["banded_lp"],
           "launches": _launches(counts)}
    emit(row)
    if (sol.status != "Optimal" or rel > GATE_OBJ
            or build["operator"] != "BandedBlockOp"
            or counts["band_mv_pair"] == 0):
        raise AssertionError(f"front_load_problem_banded: {row}")


def _dsl_solve(prob, dev, totals, measure, **opts):
    """``prob.solve`` with DR in f32 at eps 1e-5 on ``dev``; where f32 DR
    stops short of the cell's gates there, phase 2's continuation: the
    same solve at eps 1e-6 warm-started from its iterate (queue 3, item 2
    of ROADMAP.md).  ``measure(sol)`` returns (the gates' numbers, whether
    they hold).  Returns the rows of the attempts and the lowered data."""
    import torch
    from fos_tpu_torch import DR
    from fos_tpu_torch.interface import conic
    from fos_tpu_torch.problems.hsde import HSDEForm

    rows, warm = [], None
    for eps in (GATE_EPS, GATE_EPS / 10):
        counted(totals)
        with spied(HSDEForm, "build") as builds, \
                spied(conic, "solve_scs") as scs:
            sol, secs = timed_solve(lambda: prob.solve(
                alg=DR(), dtype=torch.float32, eps=eps,
                max_iters=FRONT_BUDGET, verbose=0, device=dev,
                warm_start=warm, **opts))
        counts = counted(totals)
        build = _built(builds)
        gates, ok = measure(sol)
        rows.append({"eps": eps, "lowering_seconds": secs - scs[0][0],
                     **build, **_solve_row(sol, scs[0][0], build),
                     "value": prob.value, **gates, "gates_met": ok,
                     "launches": _launches(counts)})
        if ok:
            break
        warm = sol
    return rows, scs[0][2][0]


def front_dsl_sparse_lp(dev, band, totals):
    """front_dsl_sparse_lp: the same table and certificate in the DSL,
    ``minimize(c @ x)`` subject to ``A @ x <= b, x >= 0``: the lowering
    emits [A; -I] as CSR (65536 x 32768, 8.6 GB dense: over the 4 GiB
    densify limit), whose -I tiles sit far from the band, so the build picks
    BlockedEllOp (K3).  Gates: Optimal; the objective within 1e-3 (1 +
    |f*|) of the certificate; in f64 on the host max(Ax - b)+ and max(-x)+
    <= 1e-4 (1 + ||b||_inf); K3 launched."""
    from fos_tpu_torch import Problem, Variable, minimize
    from fos_tpu_torch.linalg.sparse_ell import (band_span_ratio,
                                                 bell_storage_ratio)

    blocks, slots, b, c, opt = band
    A = tile_coo(blocks, slots).tocsr().astype(np.float64)
    bh = b.cpu().numpy().astype(np.float64)
    ch = c.cpu().numpy().astype(np.float64)
    m, n = A.shape
    x = Variable(n)
    prob = Problem(minimize(ch @ x), [A @ x <= bh, x >= 0])
    resid_gate = FRONT_RESID * (1.0 + float(np.abs(bh).max()))

    def measure(sol):
        xv = np.asarray(x.value, np.float64)
        resid = max(float(np.maximum(A @ xv - bh, 0.0).max()),
                    float(np.maximum(-xv, 0.0).max()))
        err = abs(prob.value - opt) / (1.0 + abs(opt))
        return ({"obj_certificate": opt, "obj_err_scaled": err,
                 "resid": resid, "resid_gate": resid_gate},
                sol.status == "Optimal" and err <= GATE_OBJ
                and resid <= resid_gate)

    rows, data = _dsl_solve(prob, dev, totals, measure)
    row = {"phase": "front_dsl_sparse_lp", "shape": [m, n],
           "emitted_shape": list(data["A"].shape),
           "emitted_nnz": int(data["A"].nnz),
           "bell_storage_ratio": bell_storage_ratio(data["A"]),
           "band_span_ratio": band_span_ratio(data["A"]), **rows[0],
           "continued": rows[1] if len(rows) > 1 else None}
    emit(row)
    if (not rows[-1]["gates_met"] or rows[0]["operator"] != "BlockedEllOp"
            or tuple(data["A"].shape) != (2 * m, n)
            or any(r["launches"]["bell_mv_pair"] == 0 for r in rows)):
        raise AssertionError(f"front_dsl_sparse_lp: {row}")


def front_dsl_lasso(dev, totals):
    """front_dsl_lasso: ``minimize(0.5 * sum_squares(A @ x - b) + lam *
    norm1(x))`` on bench.py's 1000x1000 lasso data: the lowering emits a
    3002 x 2001 CSR (over _DENSIFY_CELLS), the build densifies it on the
    card and ``pallas=True`` gives PaddedDenseOp (K1).  Gates: Optimal, the
    lasso objective at x within 1e-3 (1 + |f*|) of the host FISTA oracle,
    K1 launched."""
    from fos_tpu_torch import Problem, Variable, minimize, norm1, sum_squares

    m, n = LASSO_SHAPE
    A, b, lam = lasso_data(m, n)
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    t0 = time.perf_counter()
    ref, ref_iters = lasso_oracle(A64, b64, lam)
    oracle_s = time.perf_counter() - t0
    x = Variable(n)
    prob = Problem(minimize(0.5 * sum_squares(A @ x - b) + lam * norm1(x)))

    def measure(sol):
        obj = lasso_objective(A64, b64, lam, np.asarray(x.value, np.float64))
        err = abs(obj - ref) / (1.0 + abs(ref))
        return ({"lasso_obj": obj, "oracle_obj": ref,
                 "obj_err_scaled": err},
                sol.status == "Optimal" and err <= GATE_OBJ)

    rows, data = _dsl_solve(prob, dev, totals, measure, pallas=True)
    row = {"phase": "front_dsl_lasso", "shape": [m, n], "lam": lam,
           "emitted_shape": list(data["A"].shape),
           "emitted_sparse": not isinstance(data["A"], np.ndarray),
           "oracle_iters": ref_iters, "oracle_seconds": oracle_s, **rows[0],
           "continued": rows[1] if len(rows) > 1 else None}
    emit(row)
    if (not rows[-1]["gates_met"] or rows[0]["operator"] != "PaddedDenseOp"
            or any(r["launches"]["fused_matvec"] == 0 for r in rows)):
        raise AssertionError(f"front_dsl_lasso: {row}")


def front_checkpoint(dev, A1, b1, c1, totals):
    """front_checkpoint: phase 2's dense LP with GAPA and pallas=True (K1,
    the graph route): CHECKPOINT_ITERS iterations, ``save_state``,
    ``load_state`` into ``init_solver_state``'s template on the card, then
    ``run(resume_state=...)`` to Optimal.  Gate: the resumed objective
    within 1e-5 (1 + |f|) of a straight-through solve (the contract of
    tests/test_checkpoint.py); bit equality printed."""
    import os
    import tempfile

    import torch
    from fos_tpu_torch import GAPA, nonneg
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm, populate_solution
    from fos_tpu_torch.solvers import engine
    from fos_tpu_torch.solvers.base import init_solver_state
    from fos_tpu_torch.utils.checkpoint import _leaves, load_state, save_state

    N = A1.shape[0]
    # GAPA(0.8, 0.9), as phase 6's SDP cells: with its defaults GAPA
    # stalls on this LP in f32 at eps 1e-5 (the JAX package, CPU, f32:
    # Indeterminate at 20000 iterations; with (0.8, 0.9) Optimal at 800)
    form = HSDEForm.build(conic_problem(A1, b1, c1, nonneg(N), nonneg(N),
                                        device=dev, dtype=torch.float32),
                          pallas=True)
    alg = GAPA(0.8, 0.9)
    opts = dict(eps=GATE_EPS, checki=100, verbose=0)
    counted(totals)
    first, first_s = timed_solve(lambda: engine.run(
        form, alg, max_iters=CHECKPOINT_ITERS, **opts))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        t0 = time.perf_counter()
        save_state(path, first.state)
        save_s = time.perf_counter() - t0
        template = init_solver_state(alg, form.sets,
                                     form.initial_value(form.dtype))
        t0 = time.perf_counter()
        restored = load_state(path, template)
        load_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
    leaves_equal = all(
        torch.equal(a, b) and a.device == b.device
        for a, b in zip(_leaves(restored), _leaves(first.state)))
    resumed, resumed_s = timed_solve(lambda: engine.run(
        form, alg, resume_state=restored, max_iters=FRONT_BUDGET, **opts))
    straight, straight_s = timed_solve(lambda: engine.run(
        fresh(form), alg, max_iters=FRONT_BUDGET, **opts))
    counts = counted(totals)

    def objval(res):
        return populate_solution(form, res.guess, res.status,
                                 res.iters).objval

    f_res, f_str = objval(resumed), objval(straight)
    diff = abs(f_res - f_str) / (1.0 + abs(f_str))
    row = {"phase": "front_checkpoint", "shape": [N, N], "alg": repr(alg),
           "eps": GATE_EPS, "checkpoint_iters": CHECKPOINT_ITERS,
           "first_status": first.status, "first_seconds": first_s,
           "save_seconds": save_s, "load_seconds": load_s,
           "file_bytes": file_bytes, "leaves_equal": leaves_equal,
           "resumed": {"status": resumed.status, "iters": resumed.iters,
                       "seconds": resumed_s, "obj": f_res},
           "straight": {"status": straight.status, "iters": straight.iters,
                        "seconds": straight_s, "obj": f_str},
           "obj_diff_scaled": diff,
           "bit_equal": bool(torch.equal(resumed.guess, straight.guess)),
           "operator": type(form.A).__name__, "launches": _launches(counts)}
    emit(row)
    if (resumed.status != 1 or straight.status != 1 or not leaves_equal
            or diff > CHECKPOINT_GATE or counts["fused_matvec"] == 0):
        raise AssertionError(f"front_checkpoint: {row}")


def front_examples(dev, totals):
    """front_examples: the ten examples of fos_tpu_torch/examples through
    ``main(device=dev)``, at EXAMPLE_ARGS, and
    ``lasso.main_dsl``; each asserts its own oracle.  Seconds per
    example."""
    import importlib
    import io

    counted(totals)
    rows = {}
    runs = [(name, "main", EXAMPLE_ARGS.get(name, {})) for name in EXAMPLES]
    runs.append(("lasso", "main_dsl", EXAMPLE_ARGS["lasso"]))
    for name, fn, kwargs in runs:
        mod = importlib.import_module(f"fos_tpu_torch.examples.{name}")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            getattr(mod, fn)(device=dev, **kwargs)
        rows[f"{name}.{fn}"] = {
            "seconds": time.perf_counter() - t0,
            "last_line": out.getvalue().strip().splitlines()[-1]}
    counts = counted(totals)
    emit({"phase": "front_examples", "examples": rows,
          "launches": _launches(counts)})


def front_native_packer(tables):
    """front_native_packer: the native tile packer (``fos_tpu_torch/
    native``) on phase 2's 32768^2 banded and scattered tables as COO:
    the pack (banded layout for the banded table, blocked-ELL for the
    scattered one) and ``band_span_ratio`` / ``bell_storage_ratio``, each
    native and numpy (``FOS_TPU_TORCH_NO_NATIVE``), host seconds beside
    each other.  Gates: the library loaded (else its load error), the
    tables bit-equal, the ratios equal."""
    import os

    from fos_tpu_torch import native
    from fos_tpu_torch.linalg import sparse_ell

    if native.get() is None:
        print(f"native packer: {native.load_error()}", file=sys.stderr)
        raise AssertionError(f"front_native_packer: the native library did "
                             f"not load: {native.load_error()}")

    def both(fn):
        """(native result, seconds, numpy result, seconds)."""
        t0 = time.perf_counter()
        nat = fn()
        t1 = time.perf_counter()
        os.environ["FOS_TPU_TORCH_NO_NATIVE"] = "1"
        try:
            ref = fn()
        finally:
            del os.environ["FOS_TPU_TORCH_NO_NATIVE"]
        return nat, t1 - t0, ref, time.perf_counter() - t1

    for name, (blocks, slots), build in (
            ("banded", tables[0], sparse_ell._build_band_arrays),
            ("scattered", tables[1], sparse_ell._build_ell_arrays)):
        A = tile_coo(blocks, slots)
        m, n = A.shape
        rows, cols = A.row.astype(np.int64), A.col.astype(np.int64)
        vals = A.data.astype(np.float32)
        pack, pack_s, pack_np, pack_np_s = both(
            lambda: build(m, n, rows, cols, vals, TILE, TILE))
        equal = all(np.array_equal(a, b) for a, b in zip(pack, pack_np))
        ratios = {}
        for key, fn in (("band_span_ratio", sparse_ell.band_span_ratio),
                        ("bell_storage_ratio", sparse_ell.bell_storage_ratio)):
            got, secs, ref, ref_s = both(lambda: fn(A))
            ratios[key] = {"native": got, "numpy": ref, "seconds": secs,
                           "numpy_seconds": ref_s, "equal": got == ref}
        row = {"phase": "front_native_packer", "table": name,
               "shape": [m, n], "nnz": int(A.nnz),
               "layout": "band" if name == "banded" else "bell",
               "tile_table": list(pack[0].shape),
               "pack_seconds": pack_s, "numpy_pack_seconds": pack_np_s,
               "bit_equal": equal, **ratios,
               "library": native.library_path().name}
        emit(row)
        if not equal or not all(r["equal"] for r in ratios.values()):
            raise AssertionError(f"front_native_packer: {row}")


def front_end_phase(dev, A1, b1, c1, opt1, dense_ref, band, unscaled_iters,
                    tables):
    """Phase 9 (this slice's path): the front end.  The device's counts are
    zeroed before each cell and read after it; returns their sums."""
    from fos_tpu_torch.linalg import _cuda

    _cuda.device_launch_counts(reset=True)
    totals = collections.Counter()
    clock = [time.perf_counter()]
    cells = (("front_native_packer", lambda: front_native_packer(tables)),
             ("front_solve_lp", lambda: front_solve_lp(
                 dev, A1, b1, c1, opt1, dense_ref, totals)),
             ("front_load_problem_banded", lambda: front_load_problem_banded(
                 dev, band, unscaled_iters, totals)),
             ("front_dsl_sparse_lp", lambda: front_dsl_sparse_lp(
                 dev, band, totals)),
             ("front_dsl_lasso", lambda: front_dsl_lasso(dev, totals)),
             ("front_checkpoint", lambda: front_checkpoint(
                 dev, A1, b1, c1, totals)),
             ("front_examples", lambda: front_examples(dev, totals)))
    for _, cell in cells:
        cell()
        clock.append(time.perf_counter())
    emit({"phase": "front_end_timing", "seconds": dict(zip(
        (name for name, _ in cells), np.diff(clock).tolist()))})
    return totals


# ------------------------------------------------------------- phase 10
# sharding over torch.distributed on one NCCL group of world size 1 (one
# card cannot hold an NCCL group of two ranks; tests/test_torch_sharding.py
# holds the ranks' behaviour over gloo on the CPU).  A sharded form runs
# the eager route (its collectives are host calls), so each solve is held
# to the unsharded solve on the eager route (phase 5's, which runs the
# same forms).  Only the sharded calls' launches are counted: the counts
# are zeroed just before each and read just after, and a reference's are
# discarded.  The batched cell's cut budget: the eager route runs
# batched_lp_128 at 70-100 ms an iteration (PR 11's runs: 6.8 / 10.6 s for
# 100 iterations), five chunks of ten, a vote after each
SHARDED_BATCH_ITERS = 50
SHARDED_BATCH_CHECKI = 10
KERNELS_K1_K5 = ("fused_matvec", "band_mv_pair", "bell_mv_pair", "band_mv",
                 "bell_mv")


def _pairs(v):
    return v if isinstance(v, tuple) else (v,)


def sharded_ops(dev, mesh, ops, A1, totals):
    """sharded_ops: RowShardedOp over phase 2's banded and scattered
    tables (A and A' tables), and the dense row and 2D operators over its
    dense A: every product bit-equal to the unsharded operator's, and each
    sharded product launching the kernel its local table runs (K4/K5 for
    mv/rmv, K2/K3 for mv_pair, K1 for the dense blocks)."""
    import torch
    from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp
    from fos_tpu_torch.parallel import RowShardedOp, make_mesh
    from fos_tpu_torch.parallel.sharding import (Dense2DShardedOp,
                                                 DenseRowShardedOp)

    rng = np.random.default_rng(41)

    def vec(k):
        return torch.as_tensor(rng.standard_normal(k, dtype=np.float32),
                               device=dev)

    A1t = torch.as_tensor(A1, device=dev)
    mesh2 = make_mesh((1, 1), ("model_r", "model_c"), device=dev)
    # the kernel each product must launch on each operator's local table
    tiles = {"banded": {"mv": "band_mv", "rmv": "band_mv",
                        "mv_pair": "band_mv_pair"},
             "scattered": {"mv": "bell_mv", "rmv": "bell_mv",
                           "mv_pair": "bell_mv_pair"}}
    cases = [(name, op, lambda op=op: RowShardedOp.create(op, mesh, "model"),
              tiles[name]) for name, op in ops]
    cases += [("dense_rows", PaddedDenseOp.create(A1t),
               lambda: DenseRowShardedOp.create(A1t, mesh, "model"),
               {"mv_pair": "fused_matvec"}),
              ("dense_2d", PaddedDenseOp.create(A1t),
               lambda: Dense2DShardedOp.create(A1t, mesh2),
               {"mv_pair": "fused_matvec"})]
    for name, op, make, needs in cases:
        t0 = time.perf_counter()
        sh = make()
        torch.cuda.synchronize()
        create_s = time.perf_counter() - t0
        m, n = op.shape
        x, y, z = vec(n), vec(m), vec(m)
        args = {"mv": (x,), "rmv": (y,), "mv_pair": (x, z)}
        got, launches, secs = {}, {}, 0.0
        for k in needs:
            discard_counts()
            t0 = time.perf_counter()
            got[k] = _pairs(getattr(sh, k)(*args[k]))
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            counts = counted(totals)
            launches[k] = {kern: counts[kern] for kern in KERNELS_K1_K5}
        want = {k: _pairs(getattr(op, k)(*args[k])) for k in needs}
        discard_counts()
        equal = {k: all(torch.equal(a, b) for a, b in zip(got[k], want[k]))
                 for k in needs}
        row = {"phase": "sharded_ops", "operator": name,
               "class": type(sh).__name__, "shape": [m, n],
               "route": "cuda kernels per shard, NCCL world size 1",
               "create_seconds": create_s, "seconds": secs,
               "bit_equal": equal, "launches": launches}
        emit(row)
        if not all(equal.values()) or not all(
                launches[k][kern] > 0 for k, kern in needs.items()):
            raise AssertionError(f"sharded_ops: {row}")


def sharded_solve(name, eager, form_s, opt, kernel, totals, **opts):
    """One sharded LP solve (``engine.run``: the eager route, chosen by the
    sharded operator's type) against phase 5's solve of the same LP on the
    eager route (``eager``: its ``run_routes`` result and line): status,
    iterations and bits equal, Optimal within phase 2's objective gate
    where ``opt`` is given, and ``kernel`` launched by the solve."""
    import torch
    from fos_tpu_torch import DR, Status
    from fos_tpu_torch.problems.hsde import populate_solution
    from fos_tpu_torch.solvers import engine

    plain, plain_row = eager
    discard_counts()
    sh, sh_s = timed_solve(lambda: engine.run(form_s, DR(), **opts))
    launches = counted(totals)
    obj = populate_solution(form_s, sh.guess, sh.status, sh.iters).objval
    discard_counts()
    rel = None if opt is None else abs(obj - opt) / abs(opt)
    row = {"phase": name, "route": form_s.route,
           "operator": type(form_s.A).__name__,
           "status": Status.name(sh.status), "iters": sh.iters,
           "seconds": sh_s, "iters_per_s": sh.iters / sh_s, "obj": obj,
           "rel_obj_err": rel,
           "unsharded": {"route": "eager (phase 5)",
                         "status": Status.name(plain.status),
                         "iters": plain.iters,
                         "seconds": plain_row["seconds"]},
           "bit_equal": bool(torch.equal(sh.guess, plain.guess)),
           "launches": {k: launches[k] for k in KERNELS_K1_K5}}
    emit(row)
    if (form_s.route != "eager" or sh.status != Status.OPTIMAL
            or sh.status != plain.status or sh.iters != plain.iters
            or not row["bit_equal"] or (rel is not None and rel > GATE_OBJ)
            or not launches[kernel]):
        raise AssertionError(f"{name}: {row}")


def sharded_batched_lp(dev, mesh, totals):
    """sharded_batched_lp_128: batched_lp_128's instances split over the
    mesh's batch axis (one vote per check, five checks) at a cut budget,
    against the unsharded batch (graph route): statuses, iterations and
    objectives equal.  The split batch's instances are dense (B, m, n)
    stacks in ``torch.bmm``, so it launches none of K1-K5."""
    import torch
    from fos_tpu_torch import DR, build_batched_form, nonneg, solve_batched
    from fos_tpu_torch.parallel import shard_batched_form

    B, seed = BATCHED_LP_CELLS[0][:2]
    A, b, c = batched_lp(B, seed)
    m, n = BATCHED_LP_SHAPE
    l = m + n + 1
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device=dev)
    opts = dict(max_iters=SHARDED_BATCH_ITERS, eps=GATE_EPS,
                checki=SHARDED_BATCH_CHECKI)
    plain, plain_s = timed_solve(lambda: solve_batched(DR(), form, **opts))
    sform = shard_batched_form(form, mesh)
    discard_counts()
    sh, sh_s = timed_solve(lambda: solve_batched(DR(), sform, **opts))
    launches = counted(totals)

    def objectives(res):
        g = res.guess.double().cpu().numpy()
        return np.einsum("bn,bn->b", c.astype(np.float64),
                         g[:, :n] / g[:, l - 1:l])

    row = {"phase": "sharded_batched_lp_128", "instances": B,
           "budget": SHARDED_BATCH_ITERS, "checki": SHARDED_BATCH_CHECKI,
           "route": sform.route,
           "statuses": np.bincount(sh.status.cpu().numpy(),
                                   minlength=4).tolist(),
           "seconds": sh_s,
           "unsharded": {"route": form.route, "seconds": plain_s},
           "status_equal": bool(torch.equal(sh.status, plain.status)),
           "iters_equal": bool(torch.equal(sh.iters, plain.iters)),
           "objectives_equal": bool(np.array_equal(objectives(sh),
                                                   objectives(plain))),
           "bit_equal": bool(torch.equal(sh.guess, plain.guess)),
           "launches": {k: launches[k] for k in KERNELS_K1_K5}}
    emit(row)
    if not (row["status_equal"] and row["iters_equal"]
            and row["objectives_equal"]):
        raise AssertionError(f"sharded_batched_lp_128: {row}")


def pipelined_dense_lp(dev, A1, b1, c1, opt1, totals):
    """pipelined_dense_lp: phase 2's dense LP with ``cg_variant=
    "pipelined"`` (Chronopoulos-Gear CG, K1 through ``pallas=True``) on
    the graph route, to Optimal at eps 1e-5, then phase 2's continuation
    to eps 1e-6 and its objective gate."""
    import torch
    from fos_tpu_torch import DR, nonneg, solve

    n = A1.shape[0]
    kw = dict(alg=DR(), dtype=torch.float32, pallas=True, device=dev,
              verbose=0, cg_variant="pipelined")
    discard_counts()
    sol, secs = timed_solve(lambda: solve(A1, b1, c1, nonneg(n), nonneg(n),
                                          eps=GATE_EPS, **kw))
    cont, cont_s = timed_solve(lambda: solve(
        A1, b1, c1, nonneg(n), nonneg(n), eps=GATE_EPS / 10,
        max_iters=10000, warm_start=sol, **kw))
    launches = counted(totals)
    rel = abs(cont.objval - opt1) / abs(opt1)
    row = {"phase": "pipelined_dense_lp", "route": sol.route,
           "status": sol.status, "iters": sol.iters, "seconds": secs,
           "continued": {"eps": GATE_EPS / 10, "status": cont.status,
                         "iters": cont.iters, "seconds": cont_s},
           "obj": cont.objval, "obj_certificate": opt1, "rel_obj_err": rel,
           "launches": {k: launches[k] for k in KERNELS_K1_K5}}
    emit(row)
    if (sol.status != "Optimal" or cont.status != "Optimal"
            or rel > GATE_OBJ):
        raise AssertionError(f"pipelined_dense_lp: {row}")


def nccl_capture_probe(dev):
    """nccl_capture_probe: whether this group's collectives can be captured
    into the body of one of the port's conditional nodes (a WHILE node of
    five passes, each an all-reduce and an all-gather around a multiply),
    replayed bit-equal to the same passes run eagerly.  A finding for a
    later graph route of sharded forms; no route is chosen by it."""
    import torch
    import torch.distributed as dist
    from fos_tpu_torch.linalg import control
    from fos_tpu_torch.solvers import graphs

    def passes(x):
        y = x * 1.5 + 1.0
        dist.all_reduce(y)
        parts = [torch.empty_like(y)]
        dist.all_gather(parts, y)
        return parts[0] - 0.5

    x0 = torch.arange(4096, dtype=torch.float32, device=dev) / 4096
    want = x0
    for _ in range(5):
        want = passes(want)
    row = {"phase": "nccl_capture_probe", "backend": dist.get_backend(),
           "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    try:
        cap = graphs.Captured(
            lambda x: control.fori_loop(5, lambda k, v: passes(v), x), (x0,))
    except RuntimeError as e:   # the finding: the capture is refused
        row.update(captured_in_conditional_body=False, error=str(e)[:300])
        emit(row)
        return
    try:
        got = cap(x0)
        torch.cuda.synchronize()
        row.update(captured_in_conditional_body=True,
                   bit_equal=bool(torch.equal(got, want)))
    finally:
        cap.release()
    emit(row)
    if not row["bit_equal"]:
        raise AssertionError(f"nccl_capture_probe: {row}")


def sharding_phase(dev, band, ell, lps, A1, b1, c1, opt1, eager):
    """Phase 10 (this slice's path): sharding on one NCCL group of world
    size 1, in this process.  ``lps`` are phase 2's banded LP's (b, c,
    optimum), ``eager`` phase 5's eager solves of the banded and dense LPs
    (``run_routes``' results by path).  Returns the device's launch counts
    over the phase."""
    import os

    import torch
    import torch.distributed as dist
    from fos_tpu_torch import nonneg
    from fos_tpu_torch.linalg import _cuda
    from fos_tpu_torch.parallel import (RowShardedOp, make_mesh,
                                        shard_problem_rows)
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    store = _cuda.BUILD_DIR / f"nccl-store-{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    totals = collections.Counter()
    discard_counts()
    clock = [time.perf_counter()]
    try:
        mesh = make_mesh((1, 1), ("batch", "model"), device=dev)
        emit({"phase": "sharding_group", "backend": dist.get_backend(),
              "world_size": dist.get_world_size(),
              "mesh": {"shape": list(mesh.mesh.shape),
                       "names": list(mesh.mesh_dim_names)}})

        def lp_form(A, b, c, **kw):
            return HSDEForm.build(conic_problem(
                A, b, c, nonneg(A.shape[0]), nonneg(A.shape[1]), device=dev,
                dtype=torch.float32), **kw)

        b_band, c_band, opt_band = lps
        # phase 5's routes: eps, budget and check interval
        opts = dict(eps=GATE_EPS, max_iters=10000, checki=100, verbose=0)
        cells = (
            ("sharded_ops", lambda: sharded_ops(
                dev, mesh, (("banded", band), ("scattered", ell)), A1,
                totals)),
            ("sharded_banded_lp", lambda: sharded_solve(
                "sharded_banded_lp", eager["banded_lp"],
                lp_form(RowShardedOp.create(band, mesh, "model"), b_band,
                        c_band), opt_band, "band_mv_pair", totals, **opts)),
            ("sharded_rows_dense_lp", lambda: sharded_solve(
                "sharded_rows_dense_lp", eager["dense_lp"],
                shard_problem_rows(lp_form(A1, b1, c1, pallas=True), mesh),
                None, "fused_matvec", totals, **opts)),
            ("sharded_batched_lp_128", lambda: sharded_batched_lp(
                dev, mesh, totals)),
            ("pipelined_dense_lp", lambda: pipelined_dense_lp(
                dev, A1, b1, c1, opt1, totals)),
            ("nccl_capture_probe", lambda: nccl_capture_probe(dev)))
        for _, cell in cells:
            cell()
            clock.append(time.perf_counter())
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    emit({"phase": "sharding_timing", "seconds": dict(zip(
        (name for name, _ in cells), np.diff(clock).tolist())),
        "total_seconds": clock[-1] - clock[0]})
    return totals


# ------------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from fos_tpu_torch import (DR, GAP, AP, GAPA, GAPP, FISTA, Dykstra,
                               AffinePlusLinearProjector, AffineSet,
                               BandedBlockOp, BlockSet, BlockedEllOp, Box,
                               Feasibility, NonNeg, Status, nonneg, solve,
                               solve_feasibility)
    from fos_tpu_torch.cones import project
    from fos_tpu_torch.config import require_hopper
    from fos_tpu_torch.interop import cone_spec_from_blocks
    from fos_tpu_torch.linalg import _cuda
    from fos_tpu_torch.linalg.dense_pair import (PaddedDenseOp, fused_matvec,
                                                 fused_matvec_plain)
    from fos_tpu_torch.linalg.sparse_ell import (band_mv, band_mv_pair,
                                                 band_mv_pair_plain,
                                                 band_mv_plain, bell_mv,
                                                 bell_mv_pair,
                                                 bell_mv_pair_plain,
                                                 bell_mv_plain)
    from fos_tpu_torch.tools import launch_probe

    clock = [("phase0", time.perf_counter())]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    require_hopper(dev)
    t0 = time.perf_counter()
    report = _cuda.build()
    _cuda.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "ptxas": [ln.strip() for ln in report.splitlines()
                    if "registers" in ln or "spill" in ln]})
    # conditional nodes are built by csrc/graph.cu: torch's own graph class
    # is searched for a conditional-node capture of its own
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, check=True).stdout.strip()
    emit({"phase": "graph_api", "driver": driver,
          "torch_conditional_capture": [
              n for n in dir(torch.cuda.CUDAGraph)
              if any(w in n for w in ("cond", "while", "if_node"))]})

    # --- the problems (set-up, not counted)
    N1, N4 = DENSE_N, SCALING_N
    A1, b1, c1, opt1 = certificate_lp(N1, N1, seed=7)
    A4, b4, c4 = scaling_lp(N4)
    blk_band, cs, vec_band = banded_tables()
    m = n = blk_band.shape[0] * TILE
    band = BandedBlockOp.from_arrays(blk_band, cs, m, n, transpose_table=True,
                                     device=dev)
    b_band, c_band, opt_band = lp_from_operator(band, vec_band, dev)
    blk_ell, cols, vec_ell = scattered_tables()
    ell = BlockedEllOp.from_arrays(blk_ell, cols, m, n, transpose_table=True,
                                   device=dev)
    b_ell, c_ell, opt_ell = lp_from_operator(ell, vec_ell, dev)
    # the feasibility right-hand sides, b = A x0 + s0 in f64 on the host
    x0f, s0f = feasibility_vectors(m, n)
    band_slots = cs[:, None] + np.arange(blk_band.shape[1])
    feas = {"band": (band, blk_band, band_slots,
                     host_tile_mv(blk_band, band_slots, x0f) + s0f),
            "bell": (ell, blk_ell, cols,
                     host_tile_mv(blk_ell, cols, x0f) + s0f)}

    clock.append(("phase1", time.perf_counter()))
    # --- phase 1: each kernel against its plain version, on the card
    rng = np.random.default_rng(3)

    def vec(k):
        return torch.as_tensor(rng.standard_normal(k, dtype=np.float32),
                               device=dev)

    kernels = {}
    # K1 through the route the conic path takes: PaddedDenseOp.mv_pair, the
    # kernel bound to A when the operator is made
    grng = np.random.default_rng(13)
    k1_shapes = [("fused_matvec", A1), ("fused_matvec_4000", A4)] + [
        (f"fused_matvec_{M}x{N}",
         grng.standard_normal((M, N), dtype=np.float32))
        for M, N in K1_EDGE_SHAPES]
    for name, A in k1_shapes:
        At = torch.as_tensor(A, device=dev)
        op = PaddedDenseOp.create(At)
        x1, x2 = vec(At.shape[1]), vec(At.shape[0])
        res = compare(name, lambda: op.mv_pair(x1, x2),
                      lambda: fused_matvec_plain(At, x1, x2))
        M, N = At.shape
        # the yardstick: two cuBLAS calls, torch.mv(A, x1) and
        # torch.mv(A.T, x2) (no one PyTorch call computes the pair)
        res.update(bound(4 * (M * N + 2 * M + 2 * N), 4 * M * N),
                   library="torch.mv(A, x1), torch.mv(A.T, x2)",
                   library_ms=median_ms(lambda: (torch.mv(At, x1),
                                                 torch.mv(At.T, x2))),
                   library_device_ms=device_ms(lambda: (
                       torch.mv(At, x1), torch.mv(At.T, x2))))
        first = op.mv_pair(x1, x2)
        # the device counts each kernel's launches over the repeat
        _cuda.device_launch_counts(reset=True)
        res["bit_repeat_100"] = all([
            all(torch.equal(a, b) for a, b in zip(op.mv_pair(x1, x2), first))
            for _ in range(K1_REPEATS)])
        counts = _cuda.device_launch_counts(reset=True)
        res["launches_in_repeat"] = {
            "dense_pair_tiles": counts["fused_matvec"],
            "dense_pair_sum": counts["fused_matvec_sum"]}
        res["kernels_per_call"] = sum(
            res["launches_in_repeat"].values()) / K1_REPEATS
        (res["profiler_kernels_per_call"], res["device_ms_by_kernel"],
         res["profiler_records_by_kernel"]) = kernel_breakdown(
            lambda: op.mv_pair(x1, x2))
        res["free_function_ms"] = median_ms(lambda: fused_matvec(At, x1, x2))
        res["tiles"] = list(op._pair.tiles)
        # in a CUDA graph (launch gaps counted): the kernels keep no state
        # between calls, so replays give the same bits
        res["graph_us"], replayed = graph_us(lambda: op.mv_pair(x1, x2))
        res["graph_bit_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(replayed, first))
        emit({"phase": "kernel", "name": name, "shape": [M, N], **res})
        if (set(res["launches_in_repeat"].values()) != {K1_REPEATS}
                or res["kernels_per_call"] != K1_KERNELS_PER_CALL
                or not res["bit_repeat_100"]
                or not res["graph_bit_equal"]):
            raise AssertionError(f"{name}: launches over {K1_REPEATS} calls "
                                 f"{res['launches_in_repeat']}, 100-call "
                                 f"repeat {res['bit_repeat_100']}, graph "
                                 f"replay {res['graph_bit_equal']}")
        if name == "fused_matvec":
            kernels[name] = {"source": "fos_tpu_torch/csrc/pair_kernels.cu",
                             "replaces": "fos_tpu/linalg/pallas_kernels.py:72",
                             "shape": [M, N], **res}
        if name in K1_LANE_SHAPES:
            lanes_res = k1_lanes(name, At, op, dev)
            if name == "fused_matvec":
                kernels["fused_matvec_lanes"] = {
                    "source": "fos_tpu_torch/csrc/pair_kernels.cu",
                    "replaces": "fos_tpu/linalg/pallas_kernels.py:72",
                    "shape": [LINESEARCH_LANES, M, N], **lanes_res}
        del At, op
    # the SOC / rotated-SOC projection: no atomics, so it repeats bit for
    # bit on the card; against the CPU projection in f64 (sums taken in
    # another order: |d| <= 1e-12 + 1e-12 |cpu|)
    srng = np.random.default_rng(31)
    sizes = srng.integers(3, 300, 2000)
    spec = cone_spec_from_blocks([("NONNEG", 1000)] + [
        (("SOC", "SOC_ROTATED")[i % 2], int(d)) for i, d in enumerate(sizes)])
    xs = torch.as_tensor(srng.standard_normal(spec.dim) * 3.0)
    got = project(spec, xs.to(dev))
    again = project(spec, xs.to(dev))
    want = project(spec, xs)
    soc = {"dim": spec.dim, "blocks": len(spec.blocks),
           "bit_equal": bool(torch.equal(got, again)),
           "max_abs_err_vs_cpu": float((got.cpu() - want).abs().max()),
           "ms": median_ms(lambda: project(spec, xs.to(dev)))}
    emit({"phase": "soc_projection", **soc})
    if not soc["bit_equal"] or not bool(
            ((got.cpu() - want).abs() <= 1e-12 + 1e-12 * want.abs()).all()):
        raise AssertionError(f"SOC projection on the card: {soc}")

    # x as mv_pair pads it: band windows need S zero blocks past the end
    nrb, S = band.blocks.shape[:2]
    xb = vec((band._ncb() + S) * TILE).reshape(-1, TILE)
    zb = vec(nrb * TILE).reshape(nrb, TILE)
    xe = xb[: ell._ncb()]
    stored_ell = int(ell.counts.sum())
    # the pairs through their operators' bound kernels (the route mv_pair
    # takes), on inputs padded as mv_pair pads them; the free functions
    # (tables checked per call) are timed beside
    pairs = (
        ("band_mv_pair", band, nrb * S, "fos_tpu/linalg/sparse_ell.py:249",
         lambda: band._pair(xb, zb),
         lambda: band_mv_pair(band.cs, band.blocks, xb, zb,
                              (band.inv_ptr, band.inv_idx)),
         lambda: band_mv_pair_plain(band.cs, band.blocks, xb, zb), (xb, zb)),
        ("bell_mv_pair", ell, stored_ell, "fos_tpu/linalg/sparse_ell.py:333",
         lambda: ell._pair(xe, zb),
         lambda: bell_mv_pair(ell.cols, ell.blocks, xe, zb, ell.counts,
                              (ell.inv_ptr, ell.inv_idx)),
         lambda: bell_mv_pair_plain(ell.cols, ell.blocks, xe, zb), (xe, zb)))
    # the pairs' yardstick: two block-sparse cuSPARSE calls, A x over the A
    # table and A' z over the A' table (z padded as rmv pads it)
    zpad = vec((nrb + band.blocks_t.shape[1]) * TILE)
    zpad[nrb * TILE:] = 0
    yardsticks = {
        "band_mv_pair": (
            library_mv(band.blocks, band.cs.cpu().numpy()[:, None]
                       + np.arange(S), np.full(nrb, S), xb.shape[0], dev),
            library_mv(band.blocks_t, band.cs_t.cpu().numpy()[:, None]
                       + np.arange(band.blocks_t.shape[1]),
                       np.full(band.blocks_t.shape[0],
                               band.blocks_t.shape[1]),
                       zpad.numel() // TILE, dev), xb.reshape(-1), zpad),
        "bell_mv_pair": (
            library_mv(ell.blocks, ell.cols.cpu().numpy(),
                       ell.counts.cpu().numpy(), xe.shape[0], dev),
            library_mv(ell.blocks_t, ell.cols_t.cpu().numpy(),
                       ell.counts_t.cpu().numpy(), nrb, dev),
            xe.reshape(-1), zb.reshape(-1))}
    for name, op, tiles, replaces, kern, free, plain, ins in pairs:
        res = compare(name, kern, plain)
        res["free_function_ms"] = median_ms(free)
        lib_a, lib_t, xl, zl = yardsticks[name]
        res.update(tile_bound(tiles, True, ins, kern()),
                   library="torch.sparse_bsr_tensor @ x, A' table @ z",
                   library_ms=median_ms(lambda: (lib_a(xl), lib_t(zl))),
                   library_device_ms=device_ms(lambda: (lib_a(xl),
                                                        lib_t(zl))))
        emit({"phase": "kernel", "name": name, "table": list(op.blocks.shape),
              "table_mib": op.blocks.numel() * 4 / 2**20, **res})
        kernels[name] = {"source": "fos_tpu_torch/csrc/pair_kernels.cu",
                         "replaces": replaces,
                         "shape": list(op.blocks.shape), **res}
    # K4/K5: mv over the A table, rmv over the A' table, with the padding
    # the operators give their inputs
    yb = vec((nrb + band.blocks_t.shape[1]) * TILE).reshape(-1, TILE)
    ye = yb[:nrb]
    singles = (
        ("band_mv", "mv", band._mv, band.blocks, band.cs, None, xb),
        ("band_mv", "rmv", band._rmv, band.blocks_t, band.cs_t, None, yb),
        ("bell_mv", "mv", ell._mv, ell.blocks, ell.cols, ell.counts, xe),
        ("bell_mv", "rmv", ell._rmv, ell.blocks_t, ell.cols_t, ell.counts_t,
         ye))
    for name, direction, bound_fn, blocks, index, counts, xin in singles:
        kern = lambda: (bound_fn(xin),)  # noqa: E731
        if counts is None:
            free = lambda: band_mv(index, blocks, xin)  # noqa: E731
            plain = lambda: (band_mv_plain(index, blocks, xin),)  # noqa: E731
            slots = index.cpu().numpy()[:, None] + np.arange(blocks.shape[1])
            cnt = np.full(blocks.shape[0], blocks.shape[1])
        else:
            free = lambda: bell_mv(index, blocks, xin, counts)  # noqa: E731
            plain = lambda: (bell_mv_plain(index, blocks, xin),)  # noqa: E731
            slots, cnt = index.cpu().numpy(), counts.cpu().numpy()
        res = compare(f"{name}.{direction}", kern, plain)
        res["free_function_ms"] = median_ms(free)
        res.update(tile_bound(int(cnt.sum()), False, (xin,), kern()))
        lib_fn = library_mv(blocks, slots, cnt, xin.shape[0], dev)
        x_flat = xin.reshape(-1)
        res["library_ms"] = median_ms(lambda: lib_fn(x_flat))
        res["library_device_ms"] = device_ms(lambda: lib_fn(x_flat))
        res["library"] = "torch.sparse_bsr_tensor @ x"
        res["library_max_abs_err"] = float(
            (lib_fn(x_flat) - plain()[0].reshape(-1)).abs().max())
        emit({"phase": "kernel", "name": name, "direction": direction,
              "table": list(blocks.shape), "stored_tiles": int(cnt.sum()),
              "table_mib": blocks.numel() * 4 / 2**20, **res})
        if direction == "mv":
            kernels[name] = {
                "source": "fos_tpu_torch/csrc/tile_mv.cu",
                "replaces": ("fos_tpu/linalg/sparse_ell.py:156"
                             if name == "band_mv"
                             else "fos_tpu/linalg/sparse_ell.py:89"),
                "shape": list(blocks.shape), **res}

    # the condition kernels of the graph route (csrc/graph.cu)
    for name, res in condition_kernels(dev).items():
        emit({"phase": "kernel", "name": name, **res})
        kernels[name] = {"source": "fos_tpu_torch/csrc/graph.cu",
                         "replaces": None, "shape": [], **res}

    clock.append(("phase2", time.perf_counter()))
    # --- phase 2: the conic path, the path K1-K3's launch counts must show
    def launched(totals):
        """The device's launch counts since the last read, added to the
        path's ``totals``."""
        counts = _cuda.device_launch_counts(reset=True)
        totals.update(counts)
        return counts

    _cuda.reset_launch_counts()
    _cuda.device_launch_counts(reset=True)
    conic_counts = collections.Counter()
    f32 = torch.float32

    sol, secs = timed_solve(lambda: solve(
        A1, b1, c1, nonneg(N1), nonneg(N1), alg=DR(), eps=GATE_EPS,
        dtype=f32, pallas=True, device=dev, verbose=0))
    dense_ref = sol     # phase 9's solve_lp is held to this solve's bits
    rel = abs(sol.objval - opt1) / abs(opt1)
    emit({"phase": "dense_lp", "shape": [N1, N1], "eps": GATE_EPS,
          "status": sol.status, "iters": sol.iters, "seconds": secs,
          "iters_per_s": sol.iters / secs, "obj": sol.objval,
          "obj_certificate": opt1, "rel_obj_err": rel,
          "iters_reference": REFERENCE_ITERS.get("dense_lp"),
          "fused_matvec_launches": launched(conic_counts)["fused_matvec"]})
    if sol.status != "Optimal":
        raise AssertionError(f"dense LP at eps={GATE_EPS}: {sol.status}")
    # At eps=1e-5 the check (the reference's normalise-twice residuals)
    # admits a 2.4e-3 objective error on this LP: the JAX package stops at
    # the same objective.  The 1e-3 objective gate is held after a warm-
    # started continuation to eps=1e-6.
    sol, secs = timed_solve(lambda: solve(
        A1, b1, c1, nonneg(N1), nonneg(N1), alg=DR(), eps=GATE_EPS / 10,
        max_iters=10000, dtype=f32, pallas=True, device=dev, verbose=0,
        warm_start=sol))
    rel = abs(sol.objval - opt1) / abs(opt1)
    emit({"phase": "dense_lp_continued", "shape": [N1, N1],
          "eps": GATE_EPS / 10, "status": sol.status, "iters": sol.iters,
          "seconds": secs, "iters_per_s": sol.iters / secs,
          "obj": sol.objval, "obj_certificate": opt1, "rel_obj_err": rel,
          "iters_reference": REFERENCE_ITERS.get("dense_lp_continued"),
          "fused_matvec_launches": launched(conic_counts)["fused_matvec"]})
    if sol.status != "Optimal" or rel > GATE_OBJ:
        raise AssertionError(f"dense LP: {sol.status}, rel obj err {rel}")

    sol, secs = timed_solve(lambda: solve(
        A4, b4, c4, nonneg(N4), nonneg(N4), alg=DR(), eps=GATE_EPS,
        max_iters=300, dtype=f32, pallas=True, device=dev, verbose=0))
    finite = bool(torch.isfinite(sol.raw_z).all()) and bool(np.isfinite(sol.objval))
    emit({"phase": "dense_scaling", "shape": [N4, N4], "status": sol.status,
          "iters": sol.iters, "seconds": secs, "iters_per_s": sol.iters / secs,
          "finite": finite,
          "iters_reference": REFERENCE_ITERS.get("dense_scaling"),
          "fused_matvec_launches": launched(conic_counts)["fused_matvec"]})
    if not finite:
        raise AssertionError("scaling run produced non-finite values")

    lp_iters = {}
    for phase, op, b, c, opt in (("banded_lp", band, b_band, c_band, opt_band),
                                 ("scattered_lp", ell, b_ell, c_ell, opt_ell)):
        key = "band_mv_pair" if phase == "banded_lp" else "bell_mv_pair"
        sol, secs = timed_solve(lambda: solve(
            op, b, c, nonneg(m), nonneg(n), alg=DR(), eps=GATE_EPS,
            max_iters=10000, verbose=0, device=dev))
        rel = abs(sol.objval - opt) / abs(opt)
        emit({"phase": phase, "shape": [m, n], "table": list(op.blocks.shape),
              "status": sol.status, "iters": sol.iters, "seconds": secs,
              "iters_per_s": sol.iters / secs, "obj": sol.objval,
              "obj_certificate": opt, "rel_obj_err": rel,
              "iters_reference": REFERENCE_ITERS.get(phase),
              f"{key}_launches": launched(conic_counts)[key]})
        if sol.status != "Optimal" or rel > GATE_OBJ:
            raise AssertionError(f"{phase}: {sol.status}, rel obj err {rel}")
        lp_iters[f"equilibrated_{phase}"] = sol.iters
    captured = dict(_cuda.LAUNCHES)
    launched(conic_counts)
    for name in ("fused_matvec", "band_mv_pair", "bell_mv_pair"):
        kernels[name]["launches"] = conic_counts[name]
        kernels[name]["captured_calls"] = captured[name]
    # K1 is its tile kernel and its ordered sum: one of each per call
    kernels["fused_matvec"]["sum_launches"] = conic_counts["fused_matvec_sum"]
    tiles, sums = conic_counts["fused_matvec"], conic_counts["fused_matvec_sum"]
    if tiles != sums:
        raise AssertionError(f"K1 on the conic path: {tiles} tile launches, "
                             f"{sums} sum launches")

    clock.append(("phase3", time.perf_counter()))
    # --- phase 3: the set-feasibility path, through K4 and K5
    _cuda.reset_launch_counts()
    feas_counts = collections.Counter()
    eps_f32 = float(np.finfo(np.float32).eps)
    for phase, kind in (("banded_feasibility", "band"),
                        ("scattered_feasibility", "bell")):
        op, blocks_np, slots, b = feas[kind]
        key = f"{kind}_mv"
        S1 = AffinePlusLinearProjector.create(op, b.astype(np.float32), 0.0,
                                              -1, device=dev)
        S2 = BlockSet([(Box(0.0, 1.0), n), (NonNeg(), m)])
        eps = FEAS_EPS_FLOORS * (m + n) * eps_f32
        sol, secs = timed_solve(lambda: solve_feasibility(
            Feasibility(S1, S2, n + m), DR(), eps=eps, max_iters=10000,
            verbose=0, device=dev))
        z = sol.x
        inside = (bool((z[:n] >= 0).all()) and bool((z[:n] <= 1).all())
                  and bool((z[n:] >= 0).all()))
        zh = z.double().cpu().numpy()
        resid = float(np.abs(host_tile_mv(blocks_np, slots, zh[:n]) + zh[n:]
                             - b).max())
        gate = FEAS_RESID * (1.0 + float(np.abs(b).max()))
        cg = sol.state.s1_state
        projections = int(cg.call_idx) - 1
        count = launched(feas_counts)[key]
        emit({"phase": phase, "shape": [m, n], "table": list(op.blocks.shape),
              "table_t": list(op.blocks_t.shape), "eps": eps,
              "status": sol.status, "iters": sol.iters, "seconds": secs,
              "iters_per_s": sol.iters / secs,
              "cg_iters_per_projection": int(cg.total_iters) / projections,
              "inside_box_and_s_nonneg": inside, "resid_inf": resid,
              "resid_gate": gate, f"{key}_launches": count})
        if sol.status != "Optimal" or not inside or resid > gate:
            raise AssertionError(f"{phase}: {sol.status}, inside {inside}, "
                                 f"residual {resid} (gate {gate})")
        if count == 0:
            raise AssertionError(f"{phase} never launched {key}")

    # the reference's testfeasibility problem (bench.py's feasibility tier):
    # every algorithm in f32 at eps=1e-6, reported; in f32 the consecutive-
    # iterate distance of a converged solve sits near eps_f32 ||x|| ~ 1e-6
    # (both packages on the CPU), so the statuses are rounding-determined
    # there, and the gate the reference's tests set (test_feasibility.py:
    # DR, GAPA and GAPP Optimal) is held in f64 at their eps=1e-8
    rngf = np.random.default_rng(2)
    xsol = np.abs(rngf.standard_normal(100))
    Af = rngf.standard_normal((50, 100))
    bf = Af @ xsol
    algs = (("gap", GAP()), ("dr", DR()), ("ap", AP()), ("gapa", GAPA()),
            ("gapp", GAPP()), ("fista", FISTA()), ("dykstra", Dykstra()))
    for dtype, eps, gated in ((np.float32, 1e-6, ()),
                              (np.float64, 1e-8, ("dr", "gapa", "gapp"))):
        A_t, b_t = Af.astype(dtype), bf.astype(dtype)
        prob = Feasibility(AffineSet.create(A_t, b_t, device=dev), NonNeg(),
                           100)
        tier = {}
        for name, alg in algs:
            sol, secs = timed_solve(lambda: solve_feasibility(
                prob, alg, max_iters=5000, checki=100, eps=eps, verbose=0,
                device=dev))
            x = sol.x.double().cpu().numpy()
            tier[name] = {"status": sol.status, "iters": sol.iters,
                          "seconds": secs,
                          "feas_err": float(np.abs(A_t.astype(np.float64) @ x
                                                   - b_t).max())}
        emit({"phase": "algorithm_tier", "dtype": np.dtype(dtype).name,
              "eps": eps, "shape": [50, 100], **tier})
        bad = [k for k in gated if tier[k]["status"] != "Optimal"]
        if bad:
            raise AssertionError(f"algorithm tier ({np.dtype(dtype).name}): "
                                 f"{bad} not Optimal")
    captured = dict(_cuda.LAUNCHES)
    launched(feas_counts)
    for name in ("band_mv", "bell_mv"):
        kernels[name]["launches"] = feas_counts[name]
        kernels[name]["captured_calls"] = captured[name]
    for name in ("cg_continue", "count_continue", "flag_continue"):
        kernels[name]["launches"] = conic_counts[name] + feas_counts[name]

    clock.append(("phase4", time.perf_counter()))
    # --- phase 4: the launch probe, through P1 and P2
    from torch.autograd import DeviceType
    prng = np.random.default_rng(37)

    def tile(offset=0):
        """A random (8, 128) f32 tile ``offset`` floats into its buffer."""
        buf = prng.standard_normal(1024 + offset).astype(np.float32)
        return torch.as_tensor(buf, device=dev)[offset:].view(8, 128)

    xp = tile()
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    for name, run, run_plain, extra in (
            ("probe_tiny", launch_probe.probe_tiny,
             launch_probe.probe_tiny_plain, 0),
            ("probe_prefetch", functools.partial(launch_probe.probe_prefetch,
                                                 idx),
             functools.partial(launch_probe.probe_prefetch_plain, idx), 32)):
        res = compare(name, lambda: (run(xp),), lambda: (run_plain(xp),))
        # bits on tiles that no earlier call has seen, one aligned and one
        # 4 bytes into its buffer, the kernel first: no output block that
        # the allocator hands back can already hold them
        res["bit_equal"] = all(torch.equal(run(x), run_plain(x))
                               for x in (tile(), tile(1)))
        if not res["bit_equal"]:
            raise AssertionError(f"{name} is not bit-equal to its plain version")
        res.update(bound(2 * xp.numel() * 4 + extra, xp.numel()))
        res["library_ms"] = median_ms(lambda: torch.mul(xp, launch_probe.SCALE))
        # device time against torch.mul's on the same tile, in turns
        prof = _profiled((lambda: run(xp),
                          lambda: torch.mul(xp, launch_probe.SCALE)),
                         PROBE_TURNS)
        durations = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
                durations[_kernel_name(e.name)].append(e.device_time_total)
        mine = statistics.median(durations.pop(name))
        mul = statistics.median([d for v in durations.values() for d in v])
        res.update(device_us=mine, mul_device_us=mul,
                   device_over_mul=mine / mul)
        emit({"phase": "kernel", "name": name, "shape": list(xp.shape), **res})
        if res["device_over_mul"] > PROBE_OVER_MUL_GATE:
            raise AssertionError(
                f"{name}: device time {mine:.3f} us is "
                f"{res['device_over_mul']:.3f}x torch.mul's {mul:.3f} us "
                f"(gate {PROBE_OVER_MUL_GATE})")
        kernels[name] = {"source": "fos_tpu_torch/csrc/probe.cu",
                         "replaces": ("tools/launch_probe.py:55"
                                      if name == "probe_tiny"
                                      else "tools/launch_probe.py:68"),
                         "shape": list(xp.shape), **res}
    _cuda.reset_launch_counts()
    rows = launch_probe.main(dev)
    emit({"phase": "launch_probe", "rows": rows})
    chain = {r["probe"]: r["us_per_call"] for r in rows}
    torch_us = chain["torch tiny mul"]
    route = {"torch_tiny_mul_us": torch_us,
             "p1_us": chain["P1 probe_tiny"],
             "p2_us": chain["P2 probe_prefetch"],
             "p1_over_torch": chain["P1 probe_tiny"] / torch_us,
             "p2_over_torch": chain["P2 probe_prefetch"] / torch_us,
             "target": LAUNCH_ROUTE_TARGET}
    emit({"phase": "launch_route", **route,
          "p1_within_target": route["p1_over_torch"] <= LAUNCH_ROUTE_TARGET})
    for name in ("probe_tiny", "probe_prefetch"):
        kernels[name]["launches"] = _cuda.LAUNCHES[name]
    # the lane condition's and K1's lane kernel's path is phase 7's
    # (counted there)
    missing = [k for k, e in kernels.items()
               if k not in ("cg_continue_lanes", "fused_matvec_lanes")
               and (e["launches"] == 0 or e.get("captured_calls") == 0)]
    if missing:
        raise AssertionError(f"kernels never launched by their path: {missing}")

    clock.append(("phase5", time.perf_counter()))
    # --- phase 5: the graph route against the eager route, in one process
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.feasibility import FeasibilityForm
    from fos_tpu_torch.problems.hsde import HSDEForm

    def conic_form(A, b, c, pallas):
        return lambda: HSDEForm.build(conic_problem(
            A, b, c, nonneg(A.shape[0]), nonneg(A.shape[1]), device=dev,
            dtype=f32), pallas=pallas)

    def feas_form(kind):
        op, _, _, b = feas[kind]
        S1 = AffinePlusLinearProjector.create(op, b.astype(np.float32), 0.0,
                                              -1, device=dev)
        S2 = BlockSet([(Box(0.0, 1.0), n), (NonNeg(), m)])
        return lambda: FeasibilityForm.build(Feasibility(S1, S2, n + m),
                                             device=dev)

    def initial(form):
        return form.initial_value(form.dtype)

    eps_feas = FEAS_EPS_FLOORS * (m + n) * eps_f32
    paths = (
        ("dense_lp", conic_form(A1, b1, c1, True), GATE_EPS, 10000),
        ("banded_lp", conic_form(band, b_band, c_band, False), GATE_EPS,
         10000),
        ("scattered_lp", conic_form(ell, b_ell, c_ell, False), GATE_EPS,
         10000),
        ("banded_feasibility", feas_form("band"), eps_feas, 10000),
        ("scattered_feasibility", feas_form("bell"), eps_feas, 10000))
    eager_lps = {}   # phase 10 holds its sharded solves to these
    for name, make_form, eps, iters in paths:
        out, eager = run_routes(name, make_form, initial, eps, iters)
        if name in ("dense_lp", "banded_lp"):
            eager_lps[name] = (eager, out["eager"])
    for name, make_form, eps, _ in paths:
        # eps = 0 keeps the feasibility solves running all PROFILE_ITERS
        profile_routes(name, make_form, eps if "lp" in name else 0.0)
    # the seven-algorithm tier through both routes
    from fos_tpu_torch.solvers import engine
    for dtype, eps in ((np.float32, 1e-6), (np.float64, 1e-8)):
        prob = Feasibility(AffineSet.create(Af.astype(dtype), bf.astype(dtype),
                                            device=dev), NonNeg(), 100)
        tier = {}
        for name, alg in algs:
            routes = {}
            for route, fn in (("eager", engine._run_eager),
                              ("graph", engine.run)):
                form = FeasibilityForm.build(prob, device=dev)
                res, secs = timed_solve(lambda: fn(
                    form, alg, max_iters=TIER_ROUTE_ITERS, checki=100, eps=eps,
                    verbose=0))
                routes[route] = (Status.name(res.status), res.iters, secs,
                                 res.guess)
            (es, ei, et, eg), (gs, gi, gt, gg) = routes["eager"], routes["graph"]
            tier[name] = {"status": [es, gs], "iters": [ei, gi],
                          "seconds": [et, gt],
                          "bit_equal": bool(torch.equal(eg, gg))}
        emit({"phase": "graphs_tier", "dtype": np.dtype(dtype).name,
              "eps": eps, "routes": ["eager", "graph"], **tier})
        bad = [k for k, v in tier.items()
               if v["status"][0] != v["status"][1]
               or v["iters"][0] != v["iters"][1] or not v["bit_equal"]]
        if bad:
            raise AssertionError(f"tier ({np.dtype(dtype).name}): the graph "
                                 f"route differs from the eager route in "
                                 f"{bad}")

    clock.append(("phase6", time.perf_counter()))
    # --- phase 6: the cones, equilibration and the direct mode (this
    # slice's path), with the device's launch counts zeroed before it
    cone_counts = cones_phase(
        dev, A1, b1, c1, opt1,
        ((blk_band, band_slots, b_band, c_band, opt_band),
         (blk_ell, cols, b_ell, c_ell, opt_ell)), lp_iters)
    for name in ("fused_matvec", "band_mv_pair", "bell_mv_pair"):
        kernels[name]["launches_cones_path"] = cone_counts[name]
    if not all(cone_counts[k] for k in ("fused_matvec", "band_mv_pair",
                                        "bell_mv_pair")):
        raise AssertionError(f"phase 6 did not launch K1-K3: {cone_counts}")

    clock.append(("phase7", time.perf_counter()))
    # --- phase 7: refine, the wrappers and the batched solve (this slice's
    # path), with the device's launch counts zeroed before it
    slice_counts, wrapped_counts = slice_phase(dev, A1, b1, c1, feas, m, n)
    for name in kernels:
        kernels[name]["launches_phase7"] = slice_counts[name]
        kernels[name]["launches_batched_wrappers_lp_128"] = wrapped_counts[
            name]
    for name in ("cg_continue_lanes", "fused_matvec_lanes"):
        kernels[name]["launches"] = slice_counts[name]
    kernels["fused_matvec_lanes"]["sum_launches"] = slice_counts[
        "fused_matvec_lanes_sum"]
    if not all(slice_counts[k] for k in ("fused_matvec", "fused_matvec_lanes",
                                         "band_mv", "bell_mv",
                                         "cg_continue_lanes")):
        raise AssertionError(f"phase 7 did not launch K1, K1 over lanes, K4, "
                             f"K5 and the lane condition: "
                             f"{dict(slice_counts)}")
    if slice_counts["fused_matvec_lanes"] != slice_counts[
            "fused_matvec_lanes_sum"]:
        raise AssertionError(f"K1 over lanes on phase 7's path: "
                             f"{dict(slice_counts)}")

    clock.append(("phase8", time.perf_counter()))
    # --- phase 8: implicit differentiation (this slice's path), with the
    # device's launch counts zeroed before it
    diff_counts, k1_rules, diff_wrapped = diff_phase(dev, A1, A4)
    for name in kernels:
        kernels[name]["launches_phase8"] = diff_counts[name]
        kernels[name]["launches_diff_batched_lp_wrapped"] = diff_wrapped[
            name]
    kernels["fused_matvec"]["backward_ms"] = k1_rules["fused_matvec"][
        "backward_ms"]
    if not diff_counts["fused_matvec"]:
        raise AssertionError(f"phase 8 did not launch K1: "
                             f"{dict(diff_counts)}")

    clock.append(("phase9", time.perf_counter()))
    # --- phase 9: the front end (this slice's path), with the device's
    # launch counts zeroed before each of its cells
    front_counts = front_end_phase(
        dev, A1, b1, c1, opt1, dense_ref,
        (blk_band, band_slots, b_band, c_band, opt_band),
        lp_iters["equilibrated_banded_lp"],
        ((blk_band, band_slots), (blk_ell, cols)))
    for name in kernels:
        kernels[name]["launches_phase9"] = front_counts[name]
    if not all(front_counts[k] for k in ("fused_matvec", "band_mv_pair",
                                         "bell_mv_pair")):
        raise AssertionError(f"phase 9 did not launch K1, K2 and K3: "
                             f"{dict(front_counts)}")

    clock.append(("phase10", time.perf_counter()))
    # --- phase 10: sharding (this slice's path) on one NCCL group of world
    # size 1, with the device's launch counts zeroed before it
    shard_counts = sharding_phase(dev, band, ell, (b_band, c_band, opt_band),
                                  A1, b1, c1, opt1, eager_lps)
    for name in kernels:
        kernels[name]["launches_phase10"] = shard_counts[name]
    if not all(shard_counts[k] for k in KERNELS_K1_K5):
        raise AssertionError(f"phase 10 did not launch K1-K5: "
                             f"{dict(shard_counts)}")

    clock.append(("end", time.perf_counter()))
    emit({"phase": "timing", "seconds": {
        name: t1 - t0 for (name, t0), (_, t1) in zip(clock, clock[1:])},
        "total_seconds": clock[-1][1] - clock[0][1]})

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "plain_device_ms", "captured_calls", "sum_launches",
            "shape", "max_rel_err", "deterministic", "launches_cones_path",
            "launches_phase7", "launches_batched_wrappers_lp_128",
            "launches_phase8", "launches_diff_batched_lp_wrapped",
            "launches_phase9", "launches_phase10", "backward_ms",
            "library_device_ms", "graph_us",
            "lanes_over_singles", "device_over_mul")
    emit({"kernels": [{k: e.get(k) for k in keys}
                      for e in ({"name": name, "route": "cuda", **entry}
                                for name, entry in kernels.items())]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
