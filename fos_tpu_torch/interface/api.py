"""Public solver API.

    sol = solve(A, b, c, K1=zero(m), K2=nonneg(n), alg=DR(), eps=1e-8)
    sol = solve_feasibility(Feasibility(S1, S2, n), alg=DR(), eps=1e-6)

Options (max_iters / eps / checki / verbose / debug / initx) follow the
FirstOrderSolvers.jl defaults (solverwrapper.jl:4-10); keyword options
passed to ``solve`` override options stored on the algorithm.
"""

from __future__ import annotations

import time

import torch

from fos_tpu_torch.config import as_dtype, as_tensor, default_device
from fos_tpu_torch.cones.spec import ConeSpec
from fos_tpu_torch.problems.conic import ConicProblem, conic_problem
from fos_tpu_torch.problems.hsde import HSDEForm, Solution, populate_solution
from fos_tpu_torch.solvers import engine
from fos_tpu_torch.solvers.base import DR


def solve_feasibility(problem, alg=None, initx=None, *, dtype=None,
                      device=None, **options):
    """Solve ``find x in S1 ∩ S2`` (reference: Feasibility.jl:51-55).

    ``problem`` is a :class:`~fos_tpu_torch.problems.feasibility.
    Feasibility`.  The iterate lives on ``device`` (default: the card; pass
    ``device="cpu"`` for the CPU), where the sets' data must live too, in
    ``dtype`` (default: the dtype of the sets' data).  Keyword options
    override options stored on the algorithm (Feasibility.jl:33-36).
    """
    from fos_tpu_torch.problems.feasibility import (
        Feasibility, FeasibilityForm, populate_feasibility_solution)

    t0 = time.time()
    if not isinstance(problem, Feasibility):
        raise TypeError(f"expected a Feasibility problem, got {type(problem)}")
    if alg is None:
        alg = DR()
    opts = dict(alg.options)
    opts.update(options)
    form = FeasibilityForm.build(problem, as_dtype(dtype),
                                 default_device(device))
    init_duration = time.time() - t0
    if initx is not None:
        initx = as_tensor(initx, form.dtype, form.device)
    res = engine.run(form, alg, initx=initx, init_duration=init_duration, **opts)
    return populate_feasibility_solution(form, res.guess, res.status, res.iters,
                                         res.history, res.state)


def solve(A=None, b=None, c=None, K1: ConeSpec = None, K2: ConeSpec = None,
          alg=None, problem: ConicProblem = None, initx=None, dtype=None,
          warm_start: Solution = None, device=None, **options) -> Solution:
    """Solve ``min c'x s.t. Ax + s = b, s in K1, x in K2`` via the HSDE.

    ``dtype`` casts the problem data (e.g. ``torch.float32``); by default
    the dtype of the inputs is kept.  ``device`` is where the solve runs:
    the card unless given (``device="cpu"`` for the CPU; without a card and
    without ``device`` it raises).  Tensor data moves to it; an operator
    ``A`` must already live there.

    Sparse ``A`` (scipy.sparse) options: ``densify`` and ``sparse_format``,
    as documented at :meth:`HSDEForm.build`.  ``pallas=True`` runs dense A
    through the hand-written fused pair kernel.  ``equilibrate=True`` (with
    ``equilibrate_iters``, default 10) Ruiz-scales the data on the host
    before A is packed; ``alg=DR(direct=True)`` (or another algorithm with
    ``direct=True``) replaces CG by a cached host QR factor;
    ``psd_method`` ("auto": "poly" on the card, "eigh" on the CPU) picks the
    PSD blocks' projection, and "eigh" on the card runs the eager route
    (``Solution.route``).

    ``warm_start`` seeds the iteration from a previous :class:`Solution`
    (sugar for ``initx=prev.raw_z``).

    ``refine=N`` (N > 0) continues an Optimal or unfinished solve for up to
    N more iterations at f64 from its final iterate
    (:func:`_refine_solution`); ``refine_kwargs`` (a dict) overrides
    options of that sweep.
    """
    t0 = time.time()
    if warm_start is not None:
        if initx is not None:
            raise ValueError("pass either warm_start or initx, not both")
        if warm_start.raw_z is None:
            raise ValueError("warm_start solution carries no raw_z iterate")
        initx = warm_start.raw_z
    raw_inputs = (A, b, c, K1, K2)
    if problem is None:
        problem = conic_problem(A, b, c, K1, K2, device=default_device(device),
                                dtype=as_dtype(dtype))
    if alg is None:
        alg = DR()
    opts = dict(alg.options)
    opts.update(options)
    engine.validate_options(opts)
    refine = int(opts.pop("refine", 0))
    refine_kwargs = dict(opts.pop("refine_kwargs", ()) or ())
    equilibrate = bool(opts.pop("equilibrate", False))
    equilibrate_iters = int(opts.pop("equilibrate_iters", 10))
    form = HSDEForm.build(
        problem,
        direct=getattr(alg, "direct", False),
        cg_max_iters=int(opts.pop("cg_max_iters", 1000)),
        cg_tol_floor=opts.pop("cg_tol_floor", None),
        pallas=bool(opts.pop("pallas", False)),
        psd_method=str(opts.pop("psd_method", "auto")),
        cg_variant=str(opts.pop("cg_variant", "standard")),
        cg_unroll=int(opts.pop("cg_unroll", 2)),
        equilibrate=equilibrate,
        equilibrate_iters=equilibrate_iters,
        strict_certificates=bool(opts.pop("strict_certificates", False)),
        densify=opts.pop("densify", "auto"),
        compensated=opts.pop("compensated", "auto"),
        sparse_format=opts.pop("sparse_format", "auto"),
    )
    init_duration = time.time() - t0
    if initx is not None:
        initx = as_tensor(initx, form.dtype, form.device)
    res = engine.run(form, alg, initx=initx, init_duration=init_duration, **opts)
    if refine > 0 and res.status in (engine.Status.CONTINUE,
                                     engine.Status.OPTIMAL):
        return _refine_solution(raw_inputs, problem, alg, res, refine,
                                refine_kwargs, opts, equilibrate,
                                equilibrate_iters)
    return populate_solution(form, res.guess, res.status, res.iters,
                             res.history, raw_z=res.state.x)


def _refine_solution(raw_inputs, problem, alg, res, refine, refine_kwargs,
                     opts, equilibrate=False, equilibrate_iters=10):
    """The f64 refinement sweep: continue the iteration at f64 from the
    solve's final raw iterate, for at most ``refine`` iterations.

    An f32 solve bottoms out at the f32 storage floor (~6e-8 relative on
    the iterate); warm-started at residual ~1e-5, the f64 sweep removes it
    in a few hundred iterations (the reference's all-f64 operating points,
    testDRandGAPA.jl:44-49, eps down to 1e-9).  The form is rebuilt in f64
    on the same device from the data as the caller passed them (before any
    ``dtype`` cast: the f32-rounded problem is another problem, and the
    sweep can stall on it), or from ``problem``'s, with the solve's
    ``equilibrate`` setting, because the iterate lives in the Ruiz-scaled
    coordinates and Ruiz is deterministic in (A, b, c).  The hand kernels
    take f32 only, so the sweep runs the plain products (``pallas`` is not
    carried), uses no compensated reductions (f64 needs none) and takes
    ``cg_max_iters`` and ``psd_method`` from ``refine_kwargs`` only.
    ``refine_kwargs`` override the solve's eps, checki, verbose and debug;
    the iterations of both stages add up in :attr:`Solution.iters`.
    """
    A, b, c, K1, K2 = raw_inputs
    if A is None:   # solve(problem=...): refine from the problem's data
        A, b, c, K1, K2 = (problem.A, problem.b, problem.c, problem.K1,
                           problem.K2)
    f64 = torch.float64
    if hasattr(A, "mv_pair"):
        raise ValueError(
            f"refine rebuilds the form in f64 from array, tensor or "
            f"scipy.sparse data; got the operator {type(A).__name__} (its "
            "kernels take f32 only)")
    device = problem.b.device
    prob64 = conic_problem(A, b, c, K1, K2, device=device, dtype=f64)
    rk = dict(refine_kwargs)
    form64 = HSDEForm.build(
        prob64, direct=getattr(alg, "direct", False),
        cg_max_iters=int(rk.pop("cg_max_iters", 1000)),
        psd_method=str(rk.pop("psd_method", "auto")), compensated=False,
        equilibrate=equilibrate, equilibrate_iters=equilibrate_iters)
    run_opts = {k: v for k, v in opts.items()
                if k in ("eps", "checki", "verbose", "debug")}
    run_opts.update(rk)
    run_opts["max_iters"] = refine
    # warm start from the final raw iterate, the fixed-point object of the
    # iteration, not from the projected guess (solverwrapper.jl:10's initx)
    res64 = engine.run(form64, alg, initx=res.state.x.to(f64), **run_opts)
    return populate_solution(form64, res64.guess, res64.status,
                             res.iters + res64.iters, res64.history,
                             raw_z=res64.state.x)
