"""Public solver API.

    sol = solve(A, b, c, K1=zero(m), K2=nonneg(n), alg=DR(), eps=1e-8)
    sol = solve_feasibility(Feasibility(S1, S2, n), alg=DR(), eps=1e-6)

Options (max_iters / eps / checki / verbose / debug / initx) follow the
FirstOrderSolvers.jl defaults (solverwrapper.jl:4-10); keyword options
passed to ``solve`` override options stored on the algorithm.
"""

from __future__ import annotations

import time

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
    """
    t0 = time.time()
    if warm_start is not None:
        if initx is not None:
            raise ValueError("pass either warm_start or initx, not both")
        if warm_start.raw_z is None:
            raise ValueError("warm_start solution carries no raw_z iterate")
        initx = warm_start.raw_z
    if problem is None:
        problem = conic_problem(A, b, c, K1, K2, device=default_device(device),
                                dtype=as_dtype(dtype))
    if alg is None:
        alg = DR()
    opts = dict(alg.options)
    opts.update(options)
    engine.validate_options(opts)
    if int(opts.pop("refine", 0)) > 0:
        raise NotImplementedError(
            "refine is not ported yet: ROADMAP queue 1, 'refine'")
    opts.pop("refine_kwargs", None)
    form = HSDEForm.build(
        problem,
        direct=getattr(alg, "direct", False),
        cg_max_iters=int(opts.pop("cg_max_iters", 1000)),
        cg_tol_floor=opts.pop("cg_tol_floor", None),
        pallas=bool(opts.pop("pallas", False)),
        psd_method=str(opts.pop("psd_method", "auto")),
        cg_variant=str(opts.pop("cg_variant", "standard")),
        cg_unroll=int(opts.pop("cg_unroll", 2)),
        equilibrate=bool(opts.pop("equilibrate", False)),
        equilibrate_iters=int(opts.pop("equilibrate_iters", 10)),
        strict_certificates=bool(opts.pop("strict_certificates", False)),
        densify=opts.pop("densify", "auto"),
        compensated=opts.pop("compensated", "auto"),
        sparse_format=opts.pop("sparse_format", "auto"),
    )
    init_duration = time.time() - t0
    if initx is not None:
        initx = as_tensor(initx, form.dtype, form.device)
    res = engine.run(form, alg, initx=initx, init_duration=init_duration, **opts)
    return populate_solution(form, res.guess, res.status, res.iters,
                             res.history, raw_z=res.state.x)
