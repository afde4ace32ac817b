"""The ranks of ``tests/test_torch_sharding.py``: gloo processes that run the
port's sharded operators and solves and write what each rank saw.

Imports torch and numpy only at the top (each rank is a fresh spawned
interpreter; JAX, for the references, stays in the parent).  :func:`main`
runs every case in order on every rank, counting the collectives each one
makes by wrapping ``torch.distributed``'s functions, and pickles the
results per rank into the work directory.
"""

from __future__ import annotations

import collections
import datetime
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_reduce",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
               "all_to_all_single", "broadcast", "send", "recv")


class Counted:
    """Counts of ``torch.distributed`` collectives made inside ``with``."""

    def __enter__(self):
        self.counts = collections.Counter()
        self.raw = {}
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.raw[name] = fn

            def wrap(*a, _fn=fn, _name=name, **k):
                self.counts[_name] += 1
                return _fn(*a, **k)

            setattr(dist, name, wrap)
        return self.counts

    def __exit__(self, *exc):
        for name, fn in self.raw.items():
            setattr(dist, name, fn)


def host(t):
    return t.detach().cpu().numpy().copy()


def _lp_data(inp, dtype=torch.float64):
    A, b, c = (torch.as_tensor(v, dtype=dtype) for v in inp["lp"])
    return A, b, c


# ------------------------------------------------------------------ cases
def sparse_flat(inp):
    """RowShardedOp over the 1x4 mesh's ``model`` axis (block rows 4 ways),
    both layouts: products, repeat, collectives; the non-divisible table;
    a short fused budget against the unsharded operator."""
    import scipy.sparse as sp

    from fos_tpu_torch import DR, nonneg
    from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp, BlockedEllOp
    from fos_tpu_torch.parallel import RowShardedOp, make_mesh
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm
    from fos_tpu_torch.solvers.engine import fused_solve

    mesh = make_mesh((1, 4), ("batch", "model"), device="cpu")
    A = sp.csr_matrix(inp["A"])
    x, y = (torch.as_tensor(v) for v in (inp["x"], inp["y"]))
    out = {}
    for cls in (BandedBlockOp, BlockedEllOp):
        op = cls.create(A, transpose_table=True, device="cpu")
        sh = RowShardedOp.create(op, mesh, "model")
        res = {"local_rows": sh.local.blocks.shape[0]}
        for name, call in (("mv", lambda: sh.mv(x)), ("rmv", lambda: sh.rmv(y)),
                           ("mv_pair", lambda: sh.mv_pair(x, y))):
            with Counted() as counts:
                first = call()
            again = call()
            first = first if isinstance(first, tuple) else (first,)
            again = again if isinstance(again, tuple) else (again,)
            res[name] = [host(v) for v in first]
            res[f"{name}_again"] = [host(v) for v in again]
            res[f"{name}_counts"] = dict(counts)
        res["plain"] = [host(op.mv(x)), host(op.rmv(y)),
                        *map(host, op.mv_pair(x, y))]
        out[cls.__name__] = res
    A5 = sp.diags([np.ones(640)], offsets=[0], format="csr").astype(
        np.float32)
    sh5 = RowShardedOp.create(BandedBlockOp.create(A5, device="cpu"), mesh,
                              "model")
    x5 = torch.as_tensor(inp["x5"])
    out["nondivisible"] = {"mv": host(sh5.mv(x5)),
                           "local_rows": sh5.local.blocks.shape[0]}
    b, c = (torch.as_tensor(v) for v in inp["bc"])
    m, n = A.shape
    op = BandedBlockOp.create(A, device="cpu")
    runs = {}
    for key, opA in (("plain", op), ("sharded",
                                     RowShardedOp.create(op, mesh, "model"))):
        form = HSDEForm.build(conic_problem(opA, b, c, nonneg(m), nonneg(n)))
        r = fused_solve(DR(), form, form.initial_value(form.dtype),
                        max_iters=200, eps=1e-5, checki=100)
        runs[key] = {"status": int(r.status), "p": float(r.check.p),
                     "d": float(r.check.d), "guess": host(r.guess),
                     "route": form.route}
    out["solve"] = runs
    return out


def sparse_hierarchical(inp):
    """RowShardedOp over the ("dcn", "ici") product of a 2x2 mesh."""
    import scipy.sparse as sp

    from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp, BlockedEllOp
    from fos_tpu_torch.parallel import RowShardedOp, make_mesh

    mesh = make_mesh((2, 2), ("dcn", "ici"), device="cpu")
    A = sp.csr_matrix(inp["A"])
    x, y = (torch.as_tensor(v) for v in (inp["x"], inp["y"]))
    out = {}
    for cls in (BandedBlockOp, BlockedEllOp):
        op = cls.create(A, transpose_table=True, device="cpu")
        sh = RowShardedOp.create(op, mesh, ("dcn", "ici"))
        res = {"axis": sh.axis, "plain": [host(op.mv(x)), host(op.rmv(y))]}
        res["mv"], res["rmv"] = host(sh.mv(x)), host(sh.rmv(y))
        with Counted() as counts:
            p = sh.mv_pair(x, y)
        res["mv_pair"] = [host(v) for v in p]
        res["mv_pair_again"] = [host(v) for v in sh.mv_pair(x, y)]
        res["mv_pair_counts"] = dict(counts)
        out[cls.__name__] = res
    return out


def _single(form, max_iters, eps):
    from fos_tpu_torch import DR
    from fos_tpu_torch.solvers.engine import fused_solve

    r = fused_solve(DR(), form, form.initial_value(form.dtype),
                    max_iters=max_iters, eps=eps, checki=100)
    return {"status": int(r.status), "iters": int(r.iters),
            "guess": host(r.guess), "p": float(r.check.p),
            "d": float(r.check.d), "route": form.route}


def _lp_form(A, b, c):
    """A direct-mode form (a host QR in place of CG: one pair an iteration,
    where CG's eager loop makes several, each two collectives)."""
    from fos_tpu_torch import nonneg
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    m, n = A.shape
    return HSDEForm.build(conic_problem(A, b, c, nonneg(m), nonneg(n)),
                          direct=True)


def rows_single(inp):
    """shard_problem_rows over a 1x4 mesh: the solve, the pair's
    collectives and its repeat."""
    from fos_tpu_torch.parallel import make_mesh, shard_problem_rows

    mesh = make_mesh((1, 4), ("batch", "model"), device="cpu")
    A, b, c = _lp_data(inp)
    form = shard_problem_rows(_lp_form(A, b, c), mesh)
    x = torch.as_tensor(inp["x"])
    z = torch.as_tensor(inp["z"])
    with Counted() as counts:
        p = form.A.mv_pair(x, z)
    again = form.A.mv_pair(x, z)
    return {"solve": _single(form, 1500, 1e-6), "pair": list(map(host, p)),
            "pair_again": list(map(host, again)), "pair_counts": dict(counts),
            "block": tuple(form.A.block.A.shape),
            "same_projector_A": form.sets.s1.A is form.A}


def square_rows(inp):
    from fos_tpu_torch.parallel import make_mesh, shard_problem_rows

    mesh = make_mesh((1, 4), ("batch", "model"), device="cpu")
    A, b, c = _lp_data(inp)
    form = shard_problem_rows(_lp_form(A, b, c), mesh)
    return {"solve": _single(form, 1500, 1e-5),
            "block": tuple(form.A.block.A.shape),
            "b": tuple(form.b.shape), "c": tuple(form.c.shape)}


def _2d(inp, max_iters, eps):
    from fos_tpu_torch.parallel import make_mesh, shard_problem_2d

    mesh = make_mesh((2, 2), ("model_r", "model_c"), device="cpu")
    A, b, c = _lp_data(inp)
    A2, b2, c2 = shard_problem_2d(A, b, c, mesh)
    x = torch.as_tensor(inp["x"])
    z = torch.as_tensor(inp["z"])
    with Counted() as counts:
        p = A2.mv_pair(x, z)
    return {"solve": _single(_lp_form(A2, b2, c2), max_iters, eps),
            "pair": list(map(host, p)), "pair_counts": dict(counts),
            "block": tuple(A2.block.A.shape)}


def single_2d(inp):
    return _2d(inp, 3000, 1e-5)


def rows_2d_equal(inp):
    return _2d(inp, 2000, 1e-7)


def _batched(inp, shard):
    from fos_tpu_torch import DR, nonneg
    from fos_tpu_torch.parallel import build_batched_form, solve_batched

    A, b, c = inp["lp"]
    m, n = A.shape[1:]
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device="cpu",
                              direct=True)
    local = shard(form)
    with Counted() as counts:
        r = solve_batched(DR(), local, max_iters=3000, eps=1e-6, checki=100)
    return {"status": host(r.status), "iters": host(r.iters),
            "guess": host(r.guess), "local_instances": local.b.shape[0],
            "route": local.route, "counts": dict(counts)}


def batched_sharded(inp):
    from fos_tpu_torch.parallel import make_mesh, shard_batched_form

    mesh = make_mesh((4, 1), ("batch", "model"), device="cpu")
    return _batched(inp, lambda f: shard_batched_form(f, mesh))


def batched_linesearch(inp):
    """LineSearch(DR) over a batch split one instance a rank, and the whole
    batch solved in this process alone: both results."""
    from fos_tpu_torch import DR, LineSearchWrapper, nonneg
    from fos_tpu_torch.parallel import (build_batched_form, make_mesh,
                                        shard_batched_form, solve_batched)

    A, b, c = inp["lp"]
    m, n = A.shape[1:]
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device="cpu")
    alg = LineSearchWrapper(DR(), lsinterval=20)
    run = dict(max_iters=100, eps=1e-3, checki=50)
    mesh = make_mesh((4, 1), ("batch", "model"), device="cpu")
    out = {}
    for name, f in (("split", shard_batched_form(form, mesh)),
                    ("whole", form)):
        r = solve_batched(alg, f, **run)
        out[name] = {"status": host(r.status), "iters": host(r.iters),
                     "guess": host(r.guess), "x": host(r.state.x),
                     "calls": host(r.state.s1_state.call_idx)}
    return out


def hybrid_rows(inp):
    from fos_tpu_torch.parallel import make_hybrid_mesh, shard_batched_form_rows

    mesh = make_hybrid_mesh(2, 2, device="cpu")
    return _batched(inp, lambda f: shard_batched_form_rows(f, mesh))


def hybrid_validation(inp):
    from fos_tpu_torch import nonneg
    from fos_tpu_torch.parallel import (build_batched_form, make_hybrid_mesh,
                                        make_mesh, shard_batched_form_rows)

    try:
        make_hybrid_mesh(3, 5, device="cpu")
        raised = None
    except ValueError as e:
        raised = str(e)
    A, b, c = inp["lp"]
    form = build_batched_form(A, b, c, nonneg(16), nonneg(16), device="cpu")
    sh = shard_batched_form_rows(form, make_mesh((2, 2), device="cpu"))
    return {"raised": raised, "block": tuple(sh.A.block.shape),
            "b": tuple(sh.b.shape), "c": tuple(sh.c.shape),
            "A_shape": tuple(sh.A.shape)}


def cg_counts(inp):
    """Standard and pipelined CG on a diagonal system whose vectors are
    split 4 ways: all-reduces per iteration, and the gathered solution."""
    from fos_tpu_torch.linalg.cg import (conjugate_gradient,
                                         conjugate_gradient_pipelined,
                                         conjugate_gradient_tracked)
    from fos_tpu_torch.parallel.sharding import gather

    rank, world = dist.get_rank(), dist.get_world_size()
    d = torch.as_tensor(inp["d"]).chunk(world)[rank]
    b = torch.as_tensor(inp["b"]).chunk(world)[rank]
    out = {}
    zero = torch.zeros_like(b)
    for name, run in (
            ("standard", lambda g: conjugate_gradient(
                lambda v: d * v, b, zero, tol=1e-8, max_iters=50, group=g)),
            ("pipelined", lambda g: conjugate_gradient_pipelined(
                lambda v: d * v, b, zero, tol=1e-8, max_iters=50, group=g)),
            # M = I - Q(Q .) with Q = sqrt(1 - d) I: M = d I again
            ("tracked", lambda g: conjugate_gradient_tracked(
                lambda v: torch.sqrt(1.0 - d / 4) * v, b, zero, zero,
                tol=1e-8, max_iters=50, group=g))):
        with Counted() as counts:
            r = run(dist.group.WORLD)
        out[name] = {"iters": int(r.iters), "counts": dict(counts),
                     "x": host(gather(r.x, [dist.group.WORLD]))}
    return out


CASES = {f.__name__: f for f in (
    sparse_flat, sparse_hierarchical, rows_single, square_rows, single_2d,
    rows_2d_equal, batched_sharded, batched_linesearch, hybrid_rows,
    hybrid_validation,
    cg_counts)}


def main(rank, world, workdir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {}
    try:
        for name, case in CASES.items():
            t0 = time.perf_counter()
            try:
                out[name] = case(inputs[name])
            except Exception:  # noqa: BLE001 - reported to the test
                out[name] = {"error": traceback.format_exc()}
                break    # the ranks' collectives no longer line up
            out[name]["seconds"] = time.perf_counter() - t0
    finally:
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


def example(rank, world, workdir, kwargs):
    """``fos_tpu_torch.examples.batched_scenario_lps.main`` on one rank of a
    gloo group (its mesh branch); pickles the rank's result and output."""
    import contextlib
    import io

    from fos_tpu_torch.examples import batched_scenario_lps

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = batched_scenario_lps.main(device="cpu", **kwargs)
        out = {"status": host(res.status), "guess": host(res.guess),
               "printed": buf.getvalue()}
        with open(os.path.join(workdir, f"example{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
