"""CVXPY modeling-layer adapter: the seam between CVXPY and the port.

CVXPY compiles any DCP problem to SCS-format conic data ``(data["A"],
data["b"], data["c"], dims)`` and hands it to a ``ConicSolver`` backend.
This module provides

* :func:`solve_conic_data`, the backend core: it takes CVXPY/SCS-format
  data and dims (a dict or a ConeDims-like object), runs the HSDE solve (on
  the card unless given ``device="cpu"``) and returns a result dict of host
  numpy arrays and the status;
* :func:`make_cvxpy_solver_class` and :func:`register_with_cvxpy`, the
  CVXPY plugin itself, built lazily so that this module imports without
  cvxpy.

The conventions are SCS's, which CVXPY targets: variables are free, all
cone structure lives in the slack ``s = b - Ax``, with rows ordered zero,
nonneg, SOC blocks, PSD blocks (svec, sqrt(2)-scaled off-diagonals), exp
primal, exp dual, power; the PSD svec scaling matches ``Cone.PSD``.
"""

from __future__ import annotations

from typing import Any, Dict

# SCS status -> the solver's Status names
_STATUS_MAP = {
    "Optimal": "optimal",
    "Unbounded": "unbounded",
    "Infeasible": "infeasible",
    "Indeterminate": "indeterminate",
}


def _dims_to_cone_dict(dims: Any) -> Dict:
    """Accept an SCS-style cone dict or a CVXPY ConeDims-like object."""
    if isinstance(dims, dict):
        return {
            "z": dims.get("z", dims.get("f", 0)),
            "l": dims.get("l", 0),
            "q": list(dims.get("q", []) or []),
            "s": list(dims.get("s", []) or []),
            "ep": dims.get("ep", 0),
            "ed": dims.get("ed", 0),
            "p": list(dims.get("p", []) or []),
        }
    # cvxpy.reductions.solvers.conic_solvers ConeDims object
    return {
        "z": getattr(dims, "zero", 0),
        "l": getattr(dims, "nonneg", 0),
        "q": list(getattr(dims, "soc", []) or []),
        "s": list(getattr(dims, "psd", []) or []),
        "ep": getattr(dims, "exp", 0),
        "ed": 0,
        "p": list(getattr(dims, "p3d", []) or []),
    }


def _host(t):
    return t.detach().cpu().numpy()


def solve_conic_data(data: Dict, dims: Any = None, alg=None,
                     **options) -> Dict:
    """Solve CVXPY/SCS-format conic data; returns an SCS-style result dict
    ``{"x", "y", "s", "info": {"status", "status_val", "pobj", "iter"}}``
    whose arrays are host numpy."""
    from fos_tpu_torch.interface.conic import solve_scs

    dims_in = data.get("dims", dims)
    if dims_in is None:
        raise TypeError(
            "solve_conic_data needs cone dims: pass dims= or include "
            "data['dims'] (an SCS-style dict or a CVXPY ConeDims object)")
    cone = _dims_to_cone_dict(dims_in)
    sol = solve_scs({"A": data["A"], "b": data["b"], "c": data["c"]}, cone,
                    alg=alg, **options)
    return {
        "x": _host(sol.x),
        "y": _host(sol.y),
        "s": _host(sol.s),
        "info": {
            "status": _STATUS_MAP.get(sol.status, "indeterminate"),
            "status_val": 1 if sol.status == "Optimal" else 0,
            "pobj": sol.objval,
            "iter": sol.iters,
        },
    }


def make_cvxpy_solver_class():
    """Build the CVXPY ConicSolver subclass (needs cvxpy installed)."""
    import cvxpy.settings as cvx_s
    from cvxpy.reductions.solution import failure_solution
    from cvxpy.reductions.solvers.conic_solvers.scs_conif import SCS

    class FOS_TPU(SCS):
        """CVXPY backend: reuses SCS's problem stuffing (the same data
        convention) and sends solve_via_data to fos_tpu_torch."""

        MIP_CAPABLE = False

        def name(self):
            return "FOS_TPU"

        def import_solver(self):
            import fos_tpu_torch  # noqa: F401

        def solve_via_data(self, data, warm_start, verbose, solver_opts,
                           solver_cache=None):
            opts = dict(solver_opts or {})
            opts.setdefault("verbose", 1 if verbose else 0)
            return solve_conic_data(data, **opts)

        def invert(self, solution, inverse_data):
            status_str = solution["info"]["status"]
            attr = {cvx_s.NUM_ITERS: solution["info"]["iter"]}
            if status_str == "optimal":
                return super().invert(
                    {"x": solution["x"], "y": solution["y"],
                     "s": solution["s"],
                     "info": {"status": "solved",
                              "status_val": 1,
                              "solve_time": 0.0, "setup_time": 0.0,
                              "iter": solution["info"]["iter"],
                              "pobj": solution["info"]["pobj"]}},
                    inverse_data)
            cvx_status = {
                "unbounded": cvx_s.UNBOUNDED,
                "infeasible": cvx_s.INFEASIBLE,
            }.get(status_str, cvx_s.SOLVER_ERROR)
            return failure_solution(cvx_status, attr)

    return FOS_TPU


def register_with_cvxpy():
    """Register FOS_TPU as a cvxpy solver (call once; then
    ``problem.solve(solver="FOS_TPU")``)."""
    import cvxpy
    from cvxpy.reductions.solvers import defines

    cls = make_cvxpy_solver_class()
    inst = cls()
    defines.SOLVER_MAP_CONIC[inst.name()] = inst
    defines.INSTALLED_SOLVERS.append(inst.name())
    cvxpy.FOS_TPU = inst.name()
    return inst.name()
