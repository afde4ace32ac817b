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


class Lockstep:
    """What a rank's solve did inside ``with``, for the lockstep check:
    each S1 projection's CG iterations (one per lane), and the numbers of
    checks (chunks) and votes."""

    def __enter__(self):
        from fos_tpu_torch.linalg.affine import HSDEAffineProjector
        from fos_tpu_torch.parallel.sharding import BatchShard
        from fos_tpu_torch.problems.hsde import HSDEForm

        self.rec = {"cg": [], "checks": 0, "votes": 0}
        self.raw = [(HSDEAffineProjector, "project"), (HSDEForm, "check"),
                    (BatchShard, "vote")]
        self.raw = [(cls, name, getattr(cls, name)) for cls, name in self.raw]
        rec = self.rec
        (_, _, project), (_, _, check), (_, _, vote) = self.raw

        def projected(proj, z, cg):
            out, st = project(proj, z, cg)
            rec["cg"].append(tuple(np.atleast_1d(host(st.last_iters))
                                   .reshape(-1).tolist()))
            return out, st

        def checked(form, *a, **k):
            rec["checks"] += 1
            return check(form, *a, **k)

        def voted(shard, status):
            rec["votes"] += 1
            return vote(shard, status)

        HSDEAffineProjector.project = projected
        HSDEForm.check = checked
        BatchShard.vote = voted
        return rec

    def __exit__(self, *exc):
        for cls, name, fn in self.raw:
            setattr(cls, name, fn)


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


def _lane_calls(op, calls, L, rng, dtype):
    """Each of ``calls`` (``mv``, ``rmv``, ``mv_pair``) on ``(L, k)`` lanes
    against a single call per lane: whether every output is bit-equal, the
    largest difference relative to the output's largest entry, the
    collectives of the lane call, and the lane call's outputs."""
    m, n = op.shape
    X, Y, Z = (torch.as_tensor(rng.standard_normal((L, k)).astype(dtype))
               for k in (n, m, m))
    args = {"mv": (X,), "rmv": (Y,), "mv_pair": (X, Z)}
    out = {}
    for name in calls:
        with Counted() as counts:
            got = getattr(op, name)(*args[name])
        got = got if isinstance(got, tuple) else (got,)
        ones = [getattr(op, name)(*(a[j] for a in args[name]))
                for j in range(L)]
        ones = [o if isinstance(o, tuple) else (o,) for o in ones]
        want = [torch.stack([o[i] for o in ones]) for i in range(len(got))]
        out[name] = {
            "bit_equal": [bool(torch.equal(g, w)) for g, w in zip(got, want)],
            "rel_diff": [float((g - w).abs().max() / w.abs().max())
                         for g, w in zip(got, want)],
            "counts": dict(counts), "lanes": [host(g) for g in got]}
    return out


def sharded_lanes(inp):
    """The sharded operators on (L, k) lanes, L = 1, 3, 31: RowShardedOp
    over both layouts on the 1x4 mesh (block rows 4 ways), over the 2x2
    mesh's model axis (2 ways) and over its ("batch", "model") product (4
    ways, hierarchical); DenseRowShardedOp on both meshes;
    Dense2DShardedOp on the 2x2 mesh; and hsde_ops' products of the
    line search's 31 probes, one collective each way."""
    import scipy.sparse as sp

    from fos_tpu_torch.linalg import hsde_ops
    from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp, BlockedEllOp
    from fos_tpu_torch.parallel import RowShardedOp, make_mesh
    from fos_tpu_torch.parallel.sharding import (Dense2DShardedOp,
                                                 DenseRowShardedOp)

    flat = make_mesh((1, 4), ("batch", "model"), device="cpu")
    square = make_mesh((2, 2), ("batch", "model"), device="cpu")
    A = sp.csr_matrix(inp["A"])
    D = torch.as_tensor(inp["dense"])
    ops = []
    for cls in (BandedBlockOp, BlockedEllOp):
        op = cls.create(A, transpose_table=True, device="cpu")
        for mesh, axis, key in ((flat, "model", "flat"),
                                (square, "model", "model2"),
                                (square, ("batch", "model"), "product")):
            ops.append((f"{cls.__name__}_{key}",
                        RowShardedOp.create(op, mesh, axis),
                        ("mv", "rmv", "mv_pair"), np.float32))
    ops += [("DenseRow_flat", DenseRowShardedOp.create(D, flat, "model"),
             ("mv_pair",), np.float64),
            ("DenseRow_model2", DenseRowShardedOp.create(D, square, "model"),
             ("mv_pair",), np.float64),
            ("Dense2D", Dense2DShardedOp.create(D, square,
                                                ("batch", "model")),
             ("mv_pair",), np.float64)]
    out = {}
    rng = np.random.default_rng(inp["seed"])
    for name, op, calls, dtype in ops:
        out[name] = {L: _lane_calls(op, calls, L, rng, dtype)
                     for L in (1, 3, 31)}
    sh = ops[0][1]
    m, n = sh.shape
    X = torch.as_tensor(rng.standard_normal((31, n)).astype(np.float32))
    Z = torch.as_tensor(rng.standard_normal((31, m)).astype(np.float32))
    for name, call in (("hsde_mv_pair", lambda: hsde_ops.mv_pair(sh, X, Z)),
                       ("hsde_mv", lambda: hsde_ops.mv(sh, X)),
                       ("hsde_rmv", lambda: hsde_ops.rmv(sh, Z))):
        with Counted() as counts:
            call()
        out[name] = dict(counts)
    return out


def _lockstep_solve(run):
    """``run()``'s result and this rank's lockstep record, kept apart from
    the result (``per_rank``: the ranks of a split batch differ in it)."""
    with Lockstep() as rec:
        res = run()
    return res, rec


def sparse_linesearch(inp):
    """LineSearch(DR) with CG on a banded LP through RowShardedOp over the
    1x4 mesh: the 31 probes through the local table's lane kernels, one
    gather and one all-reduce a probe pass."""
    import scipy.sparse as sp

    from fos_tpu_torch import DR, LineSearchWrapper, nonneg
    from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp
    from fos_tpu_torch.parallel import RowShardedOp, make_mesh
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm
    from fos_tpu_torch.solvers.engine import fused_solve

    mesh = make_mesh((1, 4), ("batch", "model"), device="cpu")
    A = sp.csr_matrix(inp["A"])
    b, c = (torch.as_tensor(v) for v in inp["bc"])
    m, n = A.shape
    op = RowShardedOp.create(BandedBlockOp.create(A, device="cpu"), mesh,
                             "model")
    form = HSDEForm.build(conic_problem(op, b, c, nonneg(m), nonneg(n)))
    alg = LineSearchWrapper(DR(), lsinterval=inp["lsinterval"])
    r, rec = _lockstep_solve(lambda: fused_solve(
        alg, form, form.initial_value(form.dtype), **inp["run"]))
    return {"status": int(r.status), "iters": int(r.iters),
            "guess": host(r.guess), "route": form.route,
            "calls": int(r.state.s1_state.call_idx), "lockstep": rec}


def hybrid_linesearch(inp):
    """LineSearch(DR) and LineSearch(AP) with CG on the hybrid rows form:
    make_hybrid_mesh(2, 2) (instances over the outer axis, each A's rows
    over the inner: the probes (B, 31, k) through BatchedRowShardedDense)
    and make_hybrid_mesh(4, 1) (one instance a rank, the rows axis one
    rank wide); then each batch solved whole in this process alone."""
    from fos_tpu_torch import AP, DR, LineSearchWrapper, nonneg
    from fos_tpu_torch.parallel import (build_batched_form, make_hybrid_mesh,
                                        shard_batched_form_rows,
                                        solve_batched)

    A, b, c = inp["lp"]
    m, n = A.shape[1:]
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device="cpu")

    def result(r):
        return {"status": host(r.status), "iters": host(r.iters),
                "guess": host(r.guess),
                "calls": host(r.state.s1_state.call_idx)}

    out, per_rank = {}, {}
    meshes = {"2x2": make_hybrid_mesh(2, 2, device="cpu"),
              "4x1": make_hybrid_mesh(4, 1, device="cpu")}
    for key, inner in (("linesearch_dr", DR()), ("linesearch_ap", AP())):
        alg = LineSearchWrapper(inner, lsinterval=inp["lsinterval"])
        out[key] = {}
        for layout in (("2x2", "4x1") if key == "linesearch_dr"
                       else ("2x2",)):
            sh = shard_batched_form_rows(form, meshes[layout])
            r, rec = _lockstep_solve(
                lambda: solve_batched(alg, sh, **inp["run"]))
            out[key][layout] = result(r)
            per_rank[f"{key}_{layout}"] = rec
        out[key]["whole"] = result(solve_batched(alg, form, **inp["run"]))
    out["per_rank"] = {"rank": dist.get_rank(), **per_rank}
    return out


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
    hybrid_validation, cg_counts, sharded_lanes, sparse_linesearch,
    hybrid_linesearch)}


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
