"""Iteration engine: the chunked solve.

``checki`` iterations run back to back on the device and end in a
residual check, whose scalars come to the host in one transfer; between
chunks the host prints the status-table row, records history, applies the
stall recovery and stops on a terminal status (FirstOrderSolvers.jl
src/solverwrapper.jl:2-41).  The fully fused solve of the JAX package
(``fused_solve``) is ROADMAP queue 1 work.
"""

from __future__ import annotations

import math
import time
from typing import Any, NamedTuple

import torch

from fos_tpu_torch.solvers.base import SolverState, init_solver_state
from fos_tpu_torch.solvers.status import Status


DEFAULT_OPTIONS = dict(max_iters=10000, verbose=1, debug=1, eps=1e-5, checki=100)
"""Reference defaults (solverwrapper.jl:4-9)."""

EXTRA_OPTIONS = frozenset({"check_finite", "profile_dir", "unroll"})
"""Documented non-reference run options (see :func:`run`)."""

# Options consumed by the form/solve layer before reaching run(); accepted
# here so algorithm-stored options (alg.options) can carry them through.
FORM_OPTIONS = frozenset({
    "cg_max_iters", "cg_tol_floor", "cg_variant", "cg_unroll", "pallas",
    "psd_method",
    "equilibrate", "equilibrate_iters", "strict_certificates", "densify",
    "refine", "refine_kwargs", "compensated", "sparse_format",
})


def validate_options(options):
    """Raise on misspelled option names (e.g. 'epsilon', 'max_iter') instead
    of silently solving at the defaults."""
    allowed = set(DEFAULT_OPTIONS) | EXTRA_OPTIONS | FORM_OPTIONS
    unknown = set(options) - allowed
    if unknown:
        raise TypeError(
            f"unknown solver option(s) {sorted(unknown)}; "
            f"valid options: {sorted(allowed)}")


def _refresh_s1(sets, st: SolverState) -> SolverState:
    """Chunk-boundary re-anchor of tracked projector invariants (the HSDE
    S1 projector's v_warm = Q warm): one pair per checki iterations."""
    if hasattr(sets.s1, "refresh_state"):
        return st._replace(s1_state=sets.s1.refresh_state(st.s1_state))
    return st


def _run_steps(alg, form, st: SolverState, nsteps: int,
               i0: int = None) -> SolverState:
    """``nsteps`` steps from ``st``; ``i0`` is the host's count of
    ``st.i`` (read from the device once when not given)."""
    i0 = int(st.i) if i0 is None else i0
    for k in range(nsteps):
        st = alg.step(form.sets, st, i0 + k)
    return st


def _run_chunk(alg, form, st: SolverState, nsteps: int, eps: float, i0: int,
               logged: bool = False):
    """``nsteps`` steps, the chunk-end re-anchor and the check.  With
    ``logged`` the last step, the check iteration (i % checki == 0 in the
    reference), runs as ``step_logged`` and its S1-stage snapshots come
    back with the check; else the snapshots are None."""
    snaps = None
    if logged:
        st = _run_steps(alg, form, st, nsteps - 1, i0)
        st, snaps = alg.step_logged(form.sets, st, i0 + nsteps - 1)
    else:
        st = _run_steps(alg, form, st, nsteps, i0)
    st = _refresh_s1(form.sets, st)
    return st, form.check(st.z_check, eps, prev=st.z_check_prev), snaps


class RunResult(NamedTuple):
    guess: torch.Tensor
    status: int
    iters: int
    history: Any
    state: SolverState


def run(form, alg, *, initx=None, init_duration: float = 0.0,
        resume_state: SolverState = None, **options) -> RunResult:
    """Chunked solve with the reference's check/print/exit semantics.

    Extra options: ``resume_state`` continues from a :class:`SolverState`;
    ``check_finite`` raises FloatingPointError when a check turns
    non-finite.  ``unroll`` is accepted and has no effect (eager mode has
    no loop to unroll); ``profile_dir`` is not ported yet.
    """
    validate_options(options)
    opts = dict(DEFAULT_OPTIONS)
    opts.update(options)
    max_iters = int(opts["max_iters"])
    checki = int(opts["checki"])
    eps = float(opts["eps"])
    verbose = int(opts["verbose"])
    debug = int(opts["debug"])
    check_finite = bool(opts.get("check_finite", False))
    if opts.get("profile_dir"):
        raise NotImplementedError(
            "profile_dir is not ported yet: ROADMAP queue 1, 'Bench for the "
            "port'")

    if resume_state is not None:
        st = resume_state
    else:
        x0 = initx if initx is not None else form.initial_value(form.dtype)
        st = init_solver_state(alg, form.sets, x0)

    from fos_tpu_torch.utils.history import History

    hist = History() if debug > 0 else None
    if verbose > 0:
        print(form.header(init_duration))
    t_init = time.time()

    status_code = Status.CONTINUE
    # a resumed run reports cumulative iteration counts
    i = int(st.i) if resume_state is not None else 0
    i_start = i  # plateau budget anchor: a fresh max_iters applies from here
    checked = False
    # logextra: feasibility runs at debug > 0 record the S1-stage snapshot
    # triple at every check iteration (FeasibilityStatus.jl:19-25)
    log_extra = debug > 0 and getattr(form, "wants_extra", False)
    # stall recovery: tighten the CG floor once when the gap-only signature
    # holds for 3 consecutive checks, or when the plateau test (once per
    # STALL_WINDOW checks) says the budget cannot reach the operating point
    stall_count = 0
    tightened = False
    win_score = math.inf
    ncheck = 0
    W = getattr(form, "STALL_WINDOW", 10)
    nchunks, rem = divmod(max_iters, checki)
    for _ in range(nchunks):
        st, chk, snaps = _run_chunk(alg, form, st, checki, eps, i, log_extra)
        chk = chk.to_host()
        i += checki
        checked = True
        status_code = chk.status
        ncheck += 1
        if (not tightened and status_code == Status.CONTINUE
                and hasattr(form, "gap_stalled")):
            fire = False
            if form.gap_stalled(chk, eps):
                stall_count += 1
                fire = stall_count >= 3
            else:
                stall_count = 0
            if (not fire and hasattr(form, "plateau_stalled")
                    and ncheck % W == 0):
                remaining = max((i_start + max_iters - i) // checki, 1)
                fire, win_score = form.plateau_stalled(chk, eps, win_score,
                                                       remaining)
            if fire:
                new_form = form.tighten_cg()
                tightened = True
                if new_form is not None:
                    form = new_form
                    if verbose > 0:
                        print(f"Residual progress stalled at i={i}: "
                              f"tightening CG tolerance floor")
        else:
            stall_count = 0
        t_elapsed = time.time() - t_init
        form.record(hist, st, chk, i, t_elapsed, debug, extra=snaps)
        if verbose > 0:
            print(form.row(st, chk, i, t_elapsed))
            if status_code == Status.OPTIMAL:
                print(f"Found solution i={i}")
        if check_finite and not all(math.isfinite(v) for v in chk[1:]):
            raise FloatingPointError(
                f"non-finite convergence-check values at iteration {i}: "
                f"{dict(zip(chk._fields[1:], chk[1:]))}")
        if status_code != Status.CONTINUE:
            break
    else:
        if rem > 0:
            st = _run_steps(alg, form, st, rem, i)
            i += rem
            checked = False

    guess, st = alg.getsol(form.sets, st)
    if status_code == Status.CONTINUE and not checked:
        # the loop ended without a check at the final iteration: check the
        # solution guess (solverwrapper.jl:32-34, override=true)
        chk = form.check(guess, eps, prev=st.z_check).to_host()
        status_code = chk.status
        t_elapsed = time.time() - t_init
        form.record(hist, st, chk, i, t_elapsed, debug)
        if verbose > 0:
            print(form.row(st, chk, i, t_elapsed))
            if status_code == Status.OPTIMAL:
                print(f"Found solution i={i}")

    if verbose > 0:
        print("Time for iterations: ")
        print(f"{time.time() - t_init} s")
    return RunResult(guess=guess, status=status_code, iters=i, history=hist,
                     state=st)
