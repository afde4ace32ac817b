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
   with its kernels per call (the tile kernel and its ordered sum) and
   each one's device time, a 100-call bit repeat and a CUDA-graph replay; K2/K3 (the pairs);
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
4. the launch probe: P1/P2 bit-equal to their plain versions, then every
   line of ``fos_tpu_torch.tools.launch_probe.main()``, and P1/P2's cost
   in a dependent chain over torch's tiny multiply's (target <= 1.3).

The launch counters are zeroed just before each path (2, 3, 4) and read
just after it: every kernel must have been launched by its path (launches
made to compare a kernel with its plain version are not counted).  Then
short profiled solves show the device's busy and idle time and its top
kernels.  The line before the last lists the kernels; the last line is the
run's result.  Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

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
LAUNCH_ROUTE_TARGET = 1.3   # P1 per call in a chain / torch's tiny multiply
# iterations of the same solves at commit b4f7f51 (on an NVIDIA H100 80GB
# HBM3, 700 W), printed beside this run's: a changed sum order in a pair
# kernel may move CG counts and so these (ROADMAP queue 3)
REFERENCE_ITERS = {"dense_lp": 900, "dense_lp_continued": 4200,
                    "dense_scaling": 300, "banded_lp": 2000,
                    "scattered_lp": 2200}


# ------------------------------------------------------------- problems
def certificate_lp(m, n, seed):
    """Dense LP with a primal-dual certificate: (A, b, c, optimum), f32.
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
    f32 = np.float32
    return A.astype(f32), b.astype(f32), c.astype(f32), float(c @ x0)


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


def _profiled(fn, reps):
    """The profiler's device rows over ``reps`` calls of fn (after one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _device_events(prof)


def device_ms(fn, reps=20):
    """Device time of one call (ms): the kernels' own time from the
    profiler's CUDA trace, without the host's launch cost; None when the
    trace holds no device time."""
    total_us = sum(e.self_device_time_total for e in _profiled(fn, reps))
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


def kernel_breakdown(fn, reps=20):
    """(device kernels per call, device ms per call of each kernel by
    name) from the profiler; memcpy and memset rows are not kernels."""
    kernels = [e for e in _profiled(fn, reps)
               if not e.key.lower().startswith(("memcpy", "memset"))]

    def name(key):  # the function's name, without namespace or arguments
        m = re.search(r"\w+(?=[<(])", key)
        return m.group(0) if m else key[:40]

    return (sum(e.count for e in kernels) / reps,
            {name(e.key): e.self_device_time_total / reps / 1e3
             for e in kernels})


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


# ------------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from fos_tpu_torch import (DR, GAP, AP, GAPA, GAPP, FISTA, Dykstra,
                               AffinePlusLinearProjector, AffineSet,
                               BandedBlockOp, BlockSet, BlockedEllOp, Box,
                               Feasibility, NonNeg, nonneg, solve,
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
        res.update(bound(4 * (M * N + 2 * M + 2 * N), 4 * M * N),
                   library_ms=None)
        first = op.mv_pair(x1, x2)
        res["bit_repeat_100"] = all(
            all(torch.equal(a, b) for a, b in zip(op.mv_pair(x1, x2), first))
            for _ in range(K1_REPEATS))
        res["kernels_per_call"], res["device_ms_by_kernel"] = \
            kernel_breakdown(lambda: op.mv_pair(x1, x2))
        res["free_function_ms"] = median_ms(lambda: fused_matvec(At, x1, x2))
        res["tiles"] = list(op._pair.tiles)
        # in a CUDA graph (launch gaps counted): the kernels keep no state
        # between calls, so replays give the same bits
        res["graph_us"], replayed = graph_us(lambda: op.mv_pair(x1, x2))
        res["graph_bit_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(replayed, first))
        emit({"phase": "kernel", "name": name, "shape": [M, N], **res})
        if (res["kernels_per_call"] != K1_KERNELS_PER_CALL
                or not res["bit_repeat_100"]
                or not res["graph_bit_equal"]):
            raise AssertionError(f"{name}: {res['kernels_per_call']} kernels "
                                 f"per call, 100-call repeat "
                                 f"{res['bit_repeat_100']}, graph replay "
                                 f"{res['graph_bit_equal']}")
        if name == "fused_matvec":
            kernels[name] = {"source": "fos_tpu_torch/csrc/pair_kernels.cu",
                             "replaces": "fos_tpu/linalg/pallas_kernels.py:72",
                             "shape": [M, N], **res}
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
    for name, op, tiles, replaces, kern, free, plain, ins in pairs:
        res = compare(name, kern, plain)
        res["free_function_ms"] = median_ms(free)
        res.update(tile_bound(tiles, True, ins, kern()), library_ms=None)
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

    # --- phase 2: the conic path, the path K1-K3's launch counts must show
    _cuda.reset_launch_counts()
    f32 = torch.float32

    sol, secs = timed_solve(lambda: solve(
        A1, b1, c1, nonneg(N1), nonneg(N1), alg=DR(), eps=GATE_EPS,
        dtype=f32, pallas=True, device=dev, verbose=0))
    rel = abs(sol.objval - opt1) / abs(opt1)
    emit({"phase": "dense_lp", "shape": [N1, N1], "eps": GATE_EPS,
          "status": sol.status, "iters": sol.iters, "seconds": secs,
          "iters_per_s": sol.iters / secs, "obj": sol.objval,
          "obj_certificate": opt1, "rel_obj_err": rel,
          "iters_reference": REFERENCE_ITERS.get("dense_lp"),
          "fused_matvec_launches": _cuda.LAUNCHES["fused_matvec"]})
    if sol.status != "Optimal":
        raise AssertionError(f"dense LP at eps={GATE_EPS}: {sol.status}")
    # At eps=1e-5 the check (the reference's normalise-twice residuals)
    # admits a 2.4e-3 objective error on this LP: the JAX package stops at
    # the same objective.  The 1e-3 objective gate is held after a warm-
    # started continuation to eps=1e-6.
    k1_before = _cuda.LAUNCHES["fused_matvec"]
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
          "fused_matvec_launches": _cuda.LAUNCHES["fused_matvec"] - k1_before})
    if sol.status != "Optimal" or rel > GATE_OBJ:
        raise AssertionError(f"dense LP: {sol.status}, rel obj err {rel}")

    k1_before = _cuda.LAUNCHES["fused_matvec"]
    sol, secs = timed_solve(lambda: solve(
        A4, b4, c4, nonneg(N4), nonneg(N4), alg=DR(), eps=GATE_EPS,
        max_iters=300, dtype=f32, pallas=True, device=dev, verbose=0))
    finite = bool(torch.isfinite(sol.raw_z).all()) and bool(np.isfinite(sol.objval))
    emit({"phase": "dense_scaling", "shape": [N4, N4], "status": sol.status,
          "iters": sol.iters, "seconds": secs, "iters_per_s": sol.iters / secs,
          "finite": finite,
          "iters_reference": REFERENCE_ITERS.get("dense_scaling"),
          "fused_matvec_launches":
              _cuda.LAUNCHES["fused_matvec"] - k1_before})
    if not finite:
        raise AssertionError("scaling run produced non-finite values")

    for phase, op, b, c, opt in (("banded_lp", band, b_band, c_band, opt_band),
                                 ("scattered_lp", ell, b_ell, c_ell, opt_ell)):
        key = "band_mv_pair" if phase == "banded_lp" else "bell_mv_pair"
        before = _cuda.LAUNCHES[key]
        sol, secs = timed_solve(lambda: solve(
            op, b, c, nonneg(m), nonneg(n), alg=DR(), eps=GATE_EPS,
            max_iters=10000, verbose=0, device=dev))
        rel = abs(sol.objval - opt) / abs(opt)
        emit({"phase": phase, "shape": [m, n], "table": list(op.blocks.shape),
              "status": sol.status, "iters": sol.iters, "seconds": secs,
              "iters_per_s": sol.iters / secs, "obj": sol.objval,
              "obj_certificate": opt, "rel_obj_err": rel,
              "iters_reference": REFERENCE_ITERS.get(phase),
              f"{key}_launches": _cuda.LAUNCHES[key] - before})
        if sol.status != "Optimal" or rel > GATE_OBJ:
            raise AssertionError(f"{phase}: {sol.status}, rel obj err {rel}")
    launches = dict(_cuda.LAUNCHES)
    for name in ("fused_matvec", "band_mv_pair", "bell_mv_pair"):
        kernels[name]["launches"] = launches[name]

    # --- phase 3: the set-feasibility path, through K4 and K5
    _cuda.reset_launch_counts()
    eps_f32 = float(np.finfo(np.float32).eps)
    for phase, kind in (("banded_feasibility", "band"),
                        ("scattered_feasibility", "bell")):
        op, blocks_np, slots, b = feas[kind]
        key = f"{kind}_mv"
        S1 = AffinePlusLinearProjector.create(op, b.astype(np.float32), 0.0,
                                              -1, device=dev)
        S2 = BlockSet([(Box(0.0, 1.0), n), (NonNeg(), m)])
        eps = FEAS_EPS_FLOORS * (m + n) * eps_f32
        before = _cuda.LAUNCHES[key]
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
        emit({"phase": phase, "shape": [m, n], "table": list(op.blocks.shape),
              "table_t": list(op.blocks_t.shape), "eps": eps,
              "status": sol.status, "iters": sol.iters, "seconds": secs,
              "iters_per_s": sol.iters / secs,
              "cg_iters_per_projection": int(cg.total_iters) / projections,
              "inside_box_and_s_nonneg": inside, "resid_inf": resid,
              "resid_gate": gate, f"{key}_launches": _cuda.LAUNCHES[key] - before})
        if sol.status != "Optimal" or not inside or resid > gate:
            raise AssertionError(f"{phase}: {sol.status}, inside {inside}, "
                                 f"residual {resid} (gate {gate})")
        if _cuda.LAUNCHES[key] == before:
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
    launches = dict(_cuda.LAUNCHES)
    for name in ("band_mv", "bell_mv"):
        kernels[name]["launches"] = launches[name]

    # --- phase 4: the launch probe, through P1 and P2
    xp = torch.ones((8, 128), device=dev) * 1.5
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    for name, kern, plain, extra in (
            ("probe_tiny", lambda: (launch_probe.probe_tiny(xp),),
             lambda: (launch_probe.probe_tiny_plain(xp),), 0),
            ("probe_prefetch", lambda: (launch_probe.probe_prefetch(idx, xp),),
             lambda: (launch_probe.probe_prefetch_plain(idx, xp),), 32)):
        res = compare(name, kern, plain)
        res["bit_equal"] = bool(torch.equal(kern()[0], plain()[0]))
        if not res["bit_equal"]:
            raise AssertionError(f"{name} is not bit-equal to its plain version")
        res.update(bound(2 * xp.numel() * 4 + extra, xp.numel()))
        res["library_ms"] = median_ms(lambda: torch.mul(xp, launch_probe.SCALE))
        emit({"phase": "kernel", "name": name, "shape": list(xp.shape), **res})
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
    missing = [k for k, e in kernels.items() if e["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by their path: {missing}")

    # where the time goes: one short profiled solve of each kind (after the
    # launch counts were read, so these launches are not counted)
    op, _, _, b = feas["band"]
    S1 = AffinePlusLinearProjector.create(op, b.astype(np.float32), 0.0, -1,
                                          device=dev)
    S2 = BlockSet([(Box(0.0, 1.0), n), (NonNeg(), m)])
    for phase, run in (
            ("profile_dense", lambda: solve(
                A1, b1, c1, nonneg(N1), nonneg(N1), alg=DR(), eps=GATE_EPS,
                max_iters=200, dtype=f32, pallas=True, device=dev,
                verbose=0)),
            ("profile_banded", lambda: solve(
                band, b_band, c_band, nonneg(m), nonneg(n), alg=DR(),
                eps=GATE_EPS, max_iters=200, verbose=0, device=dev)),
            ("profile_banded_feasibility", lambda: solve_feasibility(
                Feasibility(S1, S2, n + m), DR(), eps=0.0, max_iters=200,
                verbose=0, device=dev))):
        sol, prof = profile_solve(run)
        emit({"phase": phase, "iters": sol.iters, **prof})

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "plain_device_ms", "shape", "max_rel_err",
            "deterministic")
    emit({"kernels": [{k: e.get(k) for k in keys}
                      for e in ({"name": name, "route": "cuda", **entry}
                                for name, entry in kernels.items())]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
