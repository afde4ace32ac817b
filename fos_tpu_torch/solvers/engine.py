"""Iteration engine: the chunked solve and the fused solve.

``run``: ``checki`` iterations run back to back on the device and end in a
residual check; between chunks the host prints the status-table row,
records history, applies the stall recovery and stops on a terminal
status (FirstOrderSolvers.jl src/solverwrapper.jl:2-41).  On the card each
chunk is one replay of a captured CUDA graph (:mod:`fos_tpu_torch.solvers.
graphs`): its steps, CG's data-dependent stops included, run as
conditional nodes, and the host reads one packed buffer per chunk (the
check, the status table's cg column and, for feasibility runs, the
logextra snapshots).  :func:`_run_eager` runs the same chunks eagerly, the
plain version: CG then reads the host once per group of iterations.

``fused_solve``: the whole solve with no host read, as the JAX package's
``lax.while_loop`` over chunks: on the card one captured graph (a WHILE
node over the chunks), on the CPU the same code eagerly.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from fos_tpu_torch.linalg import control, lanes
from fos_tpu_torch.linalg.cg import CGState
from fos_tpu_torch.solvers import graphs
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
    """``nsteps`` steps from ``st``; ``i0`` is the host's count of ``st.i``
    (read from the device once when not given, eagerly).  Captured, the
    steps are a loop on the device and get no host count."""
    if i0 is None and not control.capturing(st.x):
        i0 = int(st.i)
    return control.fori_loop(
        nsteps, lambda k, s: alg.step(form.sets, s,
                                      None if k is None else i0 + k), st)


def _run_chunk(alg, form, st: SolverState, nsteps: int, eps: float,
               i0: int = None, logged: bool = False):
    """``nsteps`` steps, the chunk-end re-anchor and the check.  With
    ``logged`` the last step, the check iteration (i % checki == 0 in the
    reference), runs as ``step_logged`` and its S1-stage snapshots come
    back with the check; else the snapshots are None."""
    snaps = None
    if logged:
        st = _run_steps(alg, form, st, nsteps - 1, i0)
        st, snaps = alg.step_logged(form.sets, st,
                                    None if i0 is None else i0 + nsteps - 1)
    else:
        st = _run_steps(alg, form, st, nsteps, i0)
    st = _refresh_s1(form.sets, st)
    return st, form.check(st.z_check, eps, prev=st.z_check_prev), snaps


# ------------------------------------------------- one transfer per check
def _last_iters(st: SolverState):
    """The S1 projection's last CG count (the status table's cg column), or
    None for a set without a CG state."""
    s1 = st.s1_state
    return s1.last_iters if isinstance(s1, CGState) else None


def _report_parts(chk, st, snaps):
    parts = list(chk)
    cg = _last_iters(st)
    return parts + [p for p in (cg, snaps) if p is not None]


def _pack(chk, st, snaps) -> torch.Tensor:
    """The check, the cg column and the snapshots as one byte buffer, so
    that the host reads them in one transfer."""
    return torch.cat([p.reshape(-1).view(torch.uint8)
                      for p in _report_parts(chk, st, snaps)])


_NP = {torch.float32: np.float32, torch.float64: np.float64,
       torch.int32: np.int32, torch.bool: np.bool_}


def _to_host(packed, chk, st, snaps):
    """(check with host values, cg count or None, snapshots as numpy or
    None), from one transfer of ``packed`` (:func:`_pack`)."""
    buf = packed.cpu().numpy()
    vals, off = [], 0
    for t in _report_parts(chk, st, snaps):
        dt = np.dtype(_NP[t.dtype])
        vals.append(np.frombuffer(buf, dt, t.numel(), off).reshape(t.shape))
        off += t.numel() * dt.itemsize
    n = len(chk)
    host = type(chk)(int(vals[0]), *(float(v) for v in vals[1:n]))
    cg = int(vals[n]) if _last_iters(st) is not None else None
    return host, cg, (vals[-1] if snaps is not None else None)


# ---------------------------------------------- the chunk functions, graphed
def _chunk(alg, form, st, nsteps, eps, i0, logged):
    st, chk, snaps = _run_chunk(alg, form, st, nsteps, eps, i0, logged)
    return st, chk, snaps, _pack(chk, st, snaps)


def _final(alg, form, st, eps, check):
    """``getsol`` and, with ``check``, the forced check of its guess."""
    guess, st = alg.getsol(form.sets, st)
    if not check:
        return guess, st
    chk = form.check(guess, eps, prev=st.z_check)
    return guess, st, chk, _pack(chk, st, None)


def _graph(form, key, fn, args, inplace=False):
    """The graph of ``fn`` kept on ``form`` for ``key`` and the signature
    of ``args`` (captured the first time, after the form has copied what
    it copies from the host on first use)."""
    def make():
        if hasattr(form, "prepare"):
            form.prepare(control.tree_leaves(args)[0])
        return graphs.Captured(fn, args, inplace=inplace)

    return graphs.cached(form, (*key, graphs.signature(args)), make)


class _Chunks:
    """How :func:`_run` runs its chunks: captured graphs on the card
    (``graph``), else eagerly (the plain version)."""

    def __init__(self, alg, eps, graph):
        self.alg, self.eps, self.graph = alg, eps, graph

    def chunk(self, form, st, nsteps, i0, logged):
        alg, eps = self.alg, self.eps
        if not self.graph:
            return _chunk(alg, form, st, nsteps, eps, i0, logged)
        return _graph(form, ("chunk", alg, nsteps, eps, logged),
                      lambda s: _chunk(alg, form, s, nsteps, eps, None,
                                       logged), (st,), inplace=True)(st)

    def steps(self, form, st, nsteps, i0):
        if not self.graph:
            return _run_steps(self.alg, form, st, nsteps, i0)
        alg = self.alg
        return _graph(form, ("steps", alg, nsteps),
                      lambda s: (_run_steps(alg, form, s, nsteps),), (st,),
                      inplace=True)(st)[0]

    def final(self, form, st, check):
        alg, eps = self.alg, self.eps
        if not self.graph:
            return _final(alg, form, st, eps, check)
        out = _graph(form, ("final", alg, eps, check),
                     lambda s: _final(alg, form, s, eps, check), (st,))(st)
        # the graph's outputs are overwritten by its next replay
        return control.tree_map(torch.clone, out)


class RunResult(NamedTuple):
    guess: torch.Tensor
    status: int
    iters: int
    history: Any
    state: SolverState


def run(form, alg, *, initx=None, init_duration: float = 0.0,
        resume_state: SolverState = None, **options) -> RunResult:
    """Chunked solve with the reference's check/print/exit semantics.

    On the card every chunk is a captured CUDA graph and the host reads one
    transfer per check (unless the form's ``graph_route`` is False: then
    the chunks run eagerly); a capture that fails raises.  Extra options:
    ``resume_state`` continues from a :class:`SolverState`;
    ``check_finite`` raises FloatingPointError when a check turns
    non-finite; ``profile_dir`` writes a ``torch.profiler`` trace of the
    iteration loop into that directory (``trace.json``).  ``unroll`` is
    accepted and has no effect (the JAX package's loop unrolling).
    """
    return _run(form, alg, False, initx, init_duration, resume_state,
                options)


def _run_eager(form, alg, *, initx=None, init_duration: float = 0.0,
               resume_state: SolverState = None, **options) -> RunResult:
    """:func:`run` with every chunk run eagerly: the plain version of the
    graph route, which on the card reads the host inside CG.  Tests and
    ``chip_smoke.py`` compare the two; no solve path calls it."""
    return _run(form, alg, True, initx, init_duration, resume_state, options)


def _run(form, alg, eager, initx, init_duration, resume_state, options):
    validate_options(options)
    opts = dict(DEFAULT_OPTIONS)
    opts.update(options)
    max_iters = int(opts["max_iters"])
    checki = int(opts["checki"])
    eps = float(opts["eps"])
    verbose = int(opts["verbose"])
    debug = int(opts["debug"])
    check_finite = bool(opts.get("check_finite", False))
    profile_dir = opts.get("profile_dir")

    if resume_state is not None:
        st = resume_state
    else:
        x0 = initx if initx is not None else form.initial_value(form.dtype)
        st = init_solver_state(alg, form.sets, x0)
    chunks = _Chunks(alg, eps, graph=st.x.is_cuda and not eager
                     and _graphable(form))
    prof = _start_profile(profile_dir, st.x)
    try:
        res = _iterate(form, alg, chunks, st, resume_state is not None,
                       max_iters, checki, eps, verbose, debug, check_finite,
                       init_duration)
    finally:
        _stop_profile(prof, profile_dir, st.x)
    return res


def _graphable(form) -> bool:
    """A form that cannot be captured (``graph_route`` False: PSD blocks
    projected by eigh) runs eagerly on the card too, a choice made when the
    form was built."""
    return getattr(form, "graph_route", True)


def _start_profile(profile_dir, like):
    if not profile_dir:
        return None
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if like.is_cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, profile_dir, like):
    if prof is None:
        return
    if like.is_cuda:
        torch.cuda.synchronize(like.device)
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _iterate(form, alg, chunks, st, resumed, max_iters, checki, eps, verbose,
             debug, check_finite, init_duration) -> RunResult:
    from fos_tpu_torch.utils.history import History

    hist = History() if debug > 0 else None
    if verbose > 0:
        print(form.header(init_duration))
    t_init = time.time()

    status_code = Status.CONTINUE
    # a resumed run reports cumulative iteration counts
    i = int(st.i) if resumed else 0
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
        st, chk, snaps, packed = chunks.chunk(form, st, checki, i, log_extra)
        chk, cgiter, snaps = _to_host(packed, chk, st, snaps)
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
                    # the JAX package re-traces its chunk here; the old
                    # form's graphs are freed and the new form captures anew
                    graphs.release(form)
                    form = new_form
                    if verbose > 0:
                        print(f"Residual progress stalled at i={i}: "
                              f"tightening CG tolerance floor")
        else:
            stall_count = 0
        t_elapsed = time.time() - t_init
        form.record(hist, st, chk, i, t_elapsed, debug, extra=snaps,
                    cgiter=cgiter)
        if verbose > 0:
            print(form.row(st, chk, i, t_elapsed, cgiter=cgiter))
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
            st = chunks.steps(form, st, rem, i)
            i += rem
            checked = False

    if status_code == Status.CONTINUE and not checked:
        # the loop ended without a check at the final iteration: check the
        # solution guess (solverwrapper.jl:32-34, override=true)
        guess, st, chk, packed = chunks.final(form, st, check=True)
        chk, cgiter, _ = _to_host(packed, chk, st, None)
        status_code = chk.status
        t_elapsed = time.time() - t_init
        form.record(hist, st, chk, i, t_elapsed, debug, cgiter=cgiter)
        if verbose > 0:
            print(form.row(st, chk, i, t_elapsed, cgiter=cgiter))
            if status_code == Status.OPTIMAL:
                print(f"Found solution i={i}")
    else:
        guess, st = chunks.final(form, st, check=False)

    if verbose > 0:
        print("Time for iterations: ")
        print(f"{time.time() - t_init} s")
    return RunResult(guess=guess, status=status_code, iters=i, history=hist,
                     state=st)


# ---------------------------------------------------------- fused solve
class FusedResult(NamedTuple):
    """Result of a solve with no host read (:func:`fused_solve`)."""

    guess: torch.Tensor
    status: torch.Tensor     # int32
    iters: torch.Tensor      # int32
    check: Any               # final form-check scalars
    state: SolverState
    hist: torch.Tensor       # (max_checks, nfields) residual history or (0, 0)


def fused_solve(alg, form, x0, *, max_iters: int = 10000, eps: float = 1e-5,
                checki: int = 100, record_history: bool = False,
                unroll: int = 1, resume_state: SolverState = None,
                budget_iters: int = None) -> FusedResult:
    """The entire solve with no host read: a loop over check-interval
    chunks, on the card one captured CUDA graph (a WHILE node over the
    chunks, each chunk's steps and CG's stops nested inside), on the CPU
    the same code eagerly (the JAX package's ``lax.while_loop``).

    Once the status leaves :Continue the state freezes, and history rows
    are written only while it continues, so the history stops at the
    termination row.  The trailing ``max_iters % checki`` iterations run
    as one partial chunk after the loop (the reference runs all
    max_iters, solverwrapper.jl:20-41), then the forced final check on the
    solution guess (solverwrapper.jl:32-34).

    Stall recovery runs on the device: the CG tolerance floor travels as
    ``CGState.floor`` and tightens to ``sqrt(2l) eps`` after three
    consecutive gap-stalled checks or when the budget-aware plateau test
    fires (once per ``STALL_WINDOW`` checks, its baseline carried in
    ``CGState.win_score``).  ``resume_state`` (a previous result's
    ``state``) continues the trajectory exactly; the plateau test's budget
    is ``budget_iters``, by default this call's ``max_iters`` plus the
    iterations already done (added on the device).  ``unroll`` is accepted
    for the JAX package's signature and has no effect.

    An ``x0`` of shape ``(B, dim)`` on a batched form solves B instances at
    once (the JAX package's ``vmap`` of this function): status, iteration
    count, recovery and history are per lane, each lane's state freezes
    when its status leaves :Continue, and the chunk loop runs while any
    lane continues.
    """
    return _fused_solve(alg, form, x0, False, max_iters=max_iters, eps=eps,
                        checki=checki, record_history=record_history,
                        resume_state=resume_state, budget_iters=budget_iters)


def _fused_solve_eager(alg, form, x0, **kw) -> FusedResult:
    """:func:`fused_solve` with its loops run eagerly on the card (the plain
    version of the captured graph, which reads the host once per loop
    pass).  Tests and ``chip_smoke.py`` compare the two; no solve path
    calls it."""
    kw.pop("unroll", None)
    return _fused_solve(alg, form, x0, True, **kw)


def _fused_solve(alg, form, x0, eager, *, max_iters=10000, eps=1e-5,
                 checki=100, record_history=False, resume_state=None,
                 budget_iters=None) -> FusedResult:
    nchunks, rem = divmod(max_iters, checki)
    floors = (form.fused_cg_floors()
              if hasattr(form, "fused_cg_floors") else None)
    if resume_state is not None:
        st0 = resume_state
        x0 = st0.x
    else:
        st0 = init_solver_state(alg, form.sets, x0)
    recovery = (floors is not None and isinstance(st0.s1_state, CGState)
                and hasattr(form, "gap_stalled_traced"))
    if recovery and resume_state is None:
        lane = lanes.lane_shape(x0)
        st0 = st0._replace(s1_state=st0.s1_state._replace(
            floor=torch.full(lane, floors[0], dtype=x0.dtype,
                             device=x0.device),
            win_score=torch.full(lane, math.inf, dtype=x0.dtype,
                                 device=x0.device)))
    i32 = dict(dtype=torch.int32, device=x0.device)
    if budget_iters is not None:
        budget = torch.full((), int(budget_iters), **i32)
    elif resume_state is not None:
        budget = st0.i.to(torch.int32) + max_iters   # no host read
    else:
        budget = torch.full((), max_iters, **i32)
    plateau = (recovery and hasattr(form, "plateau_stalled_traced")
               and getattr(st0.s1_state, "win_score", None) is not None)

    def solve(st0, budget):
        return _fused(alg, form, st0, budget, nchunks=nchunks, rem=rem,
                      checki=checki, eps=eps, record_history=record_history,
                      tight_floor=floors[1] if recovery else None,
                      plateau=plateau)

    if eager or not (st0.x.is_cuda and _graphable(form)):
        return solve(st0, budget)
    g = _graph(form, ("fused", alg, max_iters, eps, checki, record_history,
                      recovery, plateau), solve, (st0, budget))
    # the graph's outputs are overwritten by its next replay
    return control.tree_map(torch.clone, g(st0, budget))


def _fused(alg, form, st0, budget, *, nchunks, rem, checki, eps,
           record_history, tight_floor, plateau) -> FusedResult:
    """The body of :func:`fused_solve` (captured whole on the card)."""
    dtype, dev = st0.x.dtype, st0.x.device
    lane = lanes.lane_shape(st0.x)
    ncols = len(form.CHECK._fields)
    hist0 = (torch.zeros(lane + (nchunks + (1 if rem else 0), ncols),
                         dtype=dtype, device=dev) if record_history
             else torch.zeros((0, 0), dtype=dtype, device=dev))
    W = getattr(form, "STALL_WINDOW", 10)

    def run_chunk(st, status, k, hist, stall, nsteps):
        """One nsteps-iteration chunk and its check, masked by the freeze
        flag; ``k`` (a tensor or int) is the chunk's history row."""
        st_new = control.fori_loop(
            nsteps, lambda _, s: alg.step(form.sets, s, None), st)
        st_new = _refresh_s1(form.sets, st_new)
        chk = form.check(st_new.z_check, eps, prev=st_new.z_check_prev)
        cont = status == Status.CONTINUE   # freeze once terminated
        if record_history:
            row = torch.stack([v.to(dtype) for v in chk], -1)
            at = (torch.arange(hist.shape[-2], device=dev) == k)[:, None]
            hist = torch.where(at & lanes.per_lane(cont, hist),
                               row[..., None, :], hist)
        st = control.tree_map(lambda new, old: lanes.select(cont, new, old),
                              st_new, st)
        status = torch.where(cont, chk.status, status)
        if tight_floor is not None:
            # the gap-only signature: three consecutive stalled checks
            gap_now = cont & form.gap_stalled_traced(chk, eps)
            stall = torch.where(gap_now, stall + 1, torch.zeros_like(stall))
            fire = stall >= 3
            if plateau:
                # once per W checks, anchored on the true iteration count
                # and the state-carried baseline (resumed segments keep it)
                ck = st.i // checki
                at_win = (ck % W) == 0
                remaining = torch.clamp_min(budget // checki - ck, 1)
                p_stalled, score = form.plateau_stalled_traced(
                    chk, eps, st.s1_state.win_score, remaining)
                fire = fire | (cont & at_win & p_stalled)
                new_win = torch.where(cont & at_win, score,
                                      st.s1_state.win_score)
                st = st._replace(
                    s1_state=st.s1_state._replace(win_score=new_win))
            cur = st.s1_state.floor
            newf = torch.where(fire & (cur > tight_floor),
                               torch.full_like(cur, tight_floor), cur)
            st = st._replace(s1_state=st.s1_state._replace(floor=newf))
        return st, status, hist, stall

    def chunk_body(carry):
        st, status, k, hist, stall = carry
        st, status, hist, stall = run_chunk(st, status, k, hist, stall, checki)
        return st, status, k + 1, hist, stall

    i32 = dict(dtype=torch.int32, device=dev)
    carry = (st0, torch.full(lane, Status.CONTINUE, **i32),
             torch.zeros((), **i32), hist0, torch.zeros(lane, **i32))
    # a batch split over ranks runs its chunks while any rank's instance
    # continues: one vote per check (``status`` unchanged for a form that
    # is not split)
    st, status, k, hist, stall = control.while_loop(
        lambda c: control.Count(c[2], control.TEST, nchunks,
                                form.vote(c[1]), Status.CONTINUE),
        chunk_body, carry)
    if rem:
        # the exact budget: the trailing max_iters % checki iterations
        # (masked out if already terminated)
        st, status, hist, stall = run_chunk(st, status, nchunks, hist, stall,
                                            rem)
    # getsol's own projection (warm start overwritten, call_idx bumped) must
    # not leak into the returned state, or a resumed segment's first
    # projection diverges from the unsegmented trajectory
    guess, _ = alg.getsol(form.sets, st)
    chk = form.check(guess, eps, prev=st.z_check)
    status = torch.where(status == Status.CONTINUE, chk.status, status)
    return FusedResult(guess=guess, status=status, iters=st.i, check=chk,
                       state=st, hist=hist)
