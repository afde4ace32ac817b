"""CG's iteration in two checkouts, in turns on one card: launches per CG
iteration on the eager route and chip_smoke.py's ``graphs_profile`` rates,
so that the effect of a change to CG's vector work (the step kernel C1,
q_mul's epilogue C2) is read parent against head in one call.

    python3 -m fos_tpu_torch.tools.cg_ab --parent DIR [--rounds R]
                                          [--out FILE]
    python3 -m fos_tpu_torch.tools.cg_ab --rounding kernel,plain[,plain_sum]

Run from the root of a checkout (the head).  DIR is another checkout, whole
(``git archive <commit> | tar -x -C DIR`` into a directory that
``.gitignore`` lists, ``build/``).  Each run is a process of its own in its
checkout (``chip_smoke.py`` and ``fos_tpu_torch`` from there, the kernels
built into that checkout's ``build/``), in the order parent, head, head,
parent per round.  Cells: chip_smoke.py's dense 1000^2 LP (K1), banded
32768^2 LP (K2), banded feasibility problem (K4) and batched_lp_128.

Per cell and run, one line:

* ``launches_per_cg_iter``: the kernels the profiler records over one S1
  projection, eagerly, at two CG budgets (``CG_ITERS``, the tolerance out
  of reach), their difference over the difference of the iterations the
  projections ran: the launches of one CG iteration, the loop's test
  included (one per ``unroll`` iterations; ``memcpy_per_cg_iter`` its host
  reads).  ``kernels_by_name``: the same difference per kernel.
* ``graphs_profile`` (not for the batch): chip_smoke's profiled
  200-iteration solves, the graph route's and the eager route's it/s and
  idle share.

``--rounding VARIANTS`` runs, instead, chip_smoke.py's cells whose
outcome moves with CG's rounding in this checkout, CG's iteration taken
each of these ways (comma-separated), each in a process of its own:

* ``kernel``: the step kernel C1 and C2, as the solve runs them on the
  card;
* ``plain``: CG's plain PyTorch step and q_mul's plain epilogue on the
  card (``cg_step.takes`` patched false), the dots ``torch.dot``: the
  arithmetic of the port before C1 and C2;
* ``plain_sum``: the same with CG's dots ``(a * b).sum()`` (PyTorch's
  other reduction order, same operands).

Cells: phase 3's banded and scattered feasibility problems (DR to
Optimal; the answer's f64 residual ``||A x + s - b||_inf`` and its gate),
phase 2's dense LP and its continuation to eps 1e-6 (iterations, status,
relative objective error) and phase 7's batched_lp_1024 at its budget
(Optimal count, iterations).  One line per variant and cell.

Needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from fos_tpu_torch.tools.k1_ab import emit

#: the cells, as chip_smoke.py's main makes their problems; only functions
#: both checkouts have
CELLS = r"""
import collections
import copy
import json
import re

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from fos_tpu_torch import (AffinePlusLinearProjector, BandedBlockOp, BlockSet,
                           Box, Feasibility, NonNeg, build_batched_form,
                           nonneg)
from fos_tpu_torch.problems.conic import conic_problem
from fos_tpu_torch.problems.feasibility import FeasibilityForm
from fos_tpu_torch.problems.hsde import HSDEForm

CG_ITERS = (4, 12)
dev = torch.device("cuda", 0)
f32 = torch.float32
A1, b1, c1, _ = cs.certificate_lp(cs.DENSE_N, cs.DENSE_N, seed=7)
blk, cols, vec = cs.banded_tables()
m = n = blk.shape[0] * cs.TILE
band = BandedBlockOp.from_arrays(blk, cols, m, n, transpose_table=True,
                                 device=dev)
bb, cb, _ = cs.lp_from_operator(band, vec, dev)
x0f, s0f = cs.feasibility_vectors(m, n)
slots = cols[:, None] + np.arange(blk.shape[1])
bf = cs.host_tile_mv(blk, slots, x0f) + s0f
Ab, bbt, cbt = cs.batched_lp(128, 13)


def conic(A, b, c, pallas):
    return lambda: HSDEForm.build(conic_problem(
        A, b, c, nonneg(A.shape[0]), nonneg(A.shape[1]), device=dev,
        dtype=f32), pallas=pallas)


def feasibility():
    S1 = AffinePlusLinearProjector.create(band, bf.astype(np.float32), 0.0,
                                          -1, device=dev)
    S2 = BlockSet([(Box(0.0, 1.0), n), (NonNeg(), m)])
    return FeasibilityForm.build(Feasibility(S1, S2, n + m), device=dev)


def batched():
    mm, nn = cs.BATCHED_LP_SHAPE
    return build_batched_form(Ab, bbt, cbt, nonneg(mm), nonneg(nn),
                              device=dev)


def kernels(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    by, copies = collections.Counter(), 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.lower().startswith(("memcpy", "memset")):
            copies += 1
            continue
        m_ = re.search(r"\w+(?=[<(])", e.name)
        by[m_.group(0) if m_ else e.name[:40]] += 1
    return out, by, copies


def per_iteration(form):
    proj = form.sets.s1
    rng = np.random.default_rng(5)
    lead = tuple(proj.b.shape[:-1]) if hasattr(proj, "l") else ()
    z = torch.as_tensor(rng.standard_normal(lead + (proj.dim,),
                                            dtype=np.float32), device=dev)
    runs = []
    for k in CG_ITERS:
        if hasattr(proj, "replace"):   # the HSDE projector
            p = proj.replace(cg_max_iters=k, decreasing_accuracy=False,
                             tol_floor=0.0)
            st = p.init_state_from(z)
        else:
            p = copy.copy(proj)
            p.cg_max_iters = k
            st = p.init_state(f32)
        (_, new), by, copies = kernels(lambda: p.project(z, st))
        runs.append((int(new.last_iters.max()), by, copies))
    (i1, by1, c1_), (i2, by2, c2_) = runs
    d = i2 - i1
    diff = {k: (by2[k] - by1[k]) / d for k in set(by1) | set(by2)
            if by2[k] != by1[k]}
    return {"cg_iters": [i1, i2], "unroll": getattr(proj, "cg_unroll",
                                                     getattr(proj,
                                                             "CG_UNROLL",
                                                             None)),
            "launches_per_cg_iter": sum(diff.values()),
            "memcpy_per_cg_iter": (c2_ - c1_) / d,
            "kernels_by_name": dict(sorted(diff.items(),
                                           key=lambda kv: -kv[1]))}


CELLS_ = (("dense_lp", conic(A1, b1, c1, True), cs.GATE_EPS),
          ("banded_lp", conic(band, bb, cb, False), cs.GATE_EPS),
          ("banded_feasibility", feasibility, 0.0),
          ("batched_lp_128", batched, None))
for name, make, eps in CELLS_:
    row = {"cell": name, **per_iteration(make())}
    if eps is not None:
        eager, graph = cs.profile_routes(name, make, eps)
        row["graphs_profile"] = {
            "graph_iters_per_s": graph["iters_per_s"],
            "graph_idle_share": graph["device_idle_share"],
            "eager_iters_per_s": eager["iters_per_s"],
            "eager_idle_share": eager["device_idle_share"]}
    print("CG_AB " + json.dumps(row), flush=True)
"""


#: the cells whose outcome moves with CG's rounding, under one variant
ROUNDING = r"""
import json
import sys

import numpy as np
import torch

import chip_smoke as cs
from fos_tpu_torch import (DR, AffinePlusLinearProjector, BandedBlockOp,
                           BlockedEllOp, BlockSet, Box, Feasibility, NonNeg,
                           build_batched_form, nonneg, solve, solve_batched,
                           solve_feasibility)
from fos_tpu_torch.linalg import cg

variant = sys.argv[1]
if variant in ("plain", "plain_sum"):
    from fos_tpu_torch.linalg import cg_step
    cg_step.takes = lambda t: False
if variant == "plain_sum":
    def vdot(a, b):
        return (a * b).sum(-1)
    cg._dot_fn = lambda compensated, group=None: vdot
dev = torch.device("cuda", 0)


def out(cell, **row):
    print("CG_AB " + json.dumps({"variant": variant, "cell": cell, **row}),
          flush=True)


blk_band, cs_band, _ = cs.banded_tables()
m = n = blk_band.shape[0] * cs.TILE
band = BandedBlockOp.from_arrays(blk_band, cs_band, m, n,
                                 transpose_table=True, device=dev)
blk_ell, cols, _ = cs.scattered_tables()
ell = BlockedEllOp.from_arrays(blk_ell, cols, m, n, transpose_table=True,
                               device=dev)
x0, s0 = cs.feasibility_vectors(m, n)
band_slots = cs_band[:, None] + np.arange(blk_band.shape[1])
eps = cs.FEAS_EPS_FLOORS * (m + n) * float(np.finfo(np.float32).eps)
for name, op, blocks, slots in (("banded_feasibility", band, blk_band,
                                 band_slots),
                                ("scattered_feasibility", ell, blk_ell,
                                 cols)):
    b = cs.host_tile_mv(blocks, slots, x0) + s0
    S1 = AffinePlusLinearProjector.create(op, b.astype(np.float32), 0.0, -1,
                                          device=dev)
    S2 = BlockSet([(Box(0.0, 1.0), n), (NonNeg(), m)])
    sol = solve_feasibility(Feasibility(S1, S2, n + m), DR(), eps=eps,
                            max_iters=10000, verbose=0, device=dev)
    zh = sol.x.double().cpu().numpy()
    resid = float(np.abs(cs.host_tile_mv(blocks, slots, zh[:n]) + zh[n:]
                         - b).max())
    gate = cs.FEAS_RESID * (1.0 + float(np.abs(b).max()))
    out(name, status=sol.status, iters=sol.iters,
        cg_iters=int(sol.state.s1_state.total_iters), resid_inf=resid,
        resid_gate=gate, within=resid <= gate)
del band, ell

A1, b1, c1, opt1 = cs.certificate_lp(cs.DENSE_N, cs.DENSE_N, seed=7)
N = A1.shape[0]
kw = dict(alg=DR(), dtype=torch.float32, pallas=True, device=dev, verbose=0)
sol = solve(A1, b1, c1, nonneg(N), nonneg(N), eps=cs.GATE_EPS, **kw)
out("dense_lp", status=sol.status, iters=sol.iters,
    rel_obj_err=abs(sol.objval - opt1) / abs(opt1))
sol = solve(A1, b1, c1, nonneg(N), nonneg(N), eps=cs.GATE_EPS / 10,
            max_iters=10000, warm_start=sol, **kw)
out("dense_lp_continued", status=sol.status, iters=sol.iters,
    rel_obj_err=abs(sol.objval - opt1) / abs(opt1),
    iters_reference=cs.REFERENCE_ITERS["dense_lp_continued"])

B, seed, budget, floor = cs.BATCHED_LP_CELLS[1]
A, b, c = cs.batched_lp(B, seed)
mm, nn = cs.BATCHED_LP_SHAPE
form = build_batched_form(A, b, c, nonneg(mm), nonneg(nn), device=dev)
res, secs = cs.timed_solve(lambda: solve_batched(
    DR(), form, eps=cs.GATE_EPS, checki=100, unroll=4, max_iters=budget))
status = res.status.cpu().numpy()
out(f"batched_lp_{B}", budget=budget, optimal=int((status == 1).sum()),
    optimal_floor=floor, statuses=np.bincount(status, minlength=4).tolist(),
    seconds=secs)
"""


def run(checkout: Path, source: str = CELLS, *args: str) -> list:
    """The cells of ``source`` in ``checkout``, in a process of their
    own."""
    proc = subprocess.run([sys.executable, "-c", source, *args],
                          cwd=checkout, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cg_ab: {checkout} {' '.join(args)} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return [json.loads(line[6:]) for line in proc.stdout.splitlines()
            if line.startswith("CG_AB ")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout, whole")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--rounding", metavar="VARIANTS",
                    help="kernel,plain,plain_sum (any of them): the "
                         "rounding cells in this checkout instead")
    ap.add_argument("--out", default="build/cg_ab.jsonl")
    args = ap.parse_args(argv)
    if not (args.parent or args.rounding):
        ap.error("give --parent or --rounding")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"card": card}, args.out)
    if args.rounding:
        for variant in args.rounding.split(","):
            for row in run(Path.cwd(), ROUNDING, variant):
                emit(row, args.out)
        return 0
    checkouts = {"parent": Path(args.parent).resolve(),
                 "head": Path.cwd().resolve()}
    for rnd in range(args.rounds):
        for name in ("parent", "head", "head", "parent"):
            for row in run(checkouts[name]):
                emit({"checkout": name, "round": rnd, **row}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
