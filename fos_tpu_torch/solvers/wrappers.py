"""Wrapper algorithms: line search, Anderson acceleration and longstep.

The port of ``fos_tpu.solvers.wrappers`` (FirstOrderSolvers.jl
src/wrappers/linesearch.jl, longstep.jl, saveplanes.jl).  A wrapper holds
an inner algorithm and delegates to it, adding work at some steps; it is an
ordinary :class:`Algorithm`, so ``run``, the graph route and
``fused_solve`` drive it as they drive the others.

* The line search evaluates its 31 candidate steps as one lane axis
  (:mod:`fos_tpu_torch.linalg.lanes`; the JAX package's ``vmap``): one
  S1 projection of ``(31, dim)`` points, CG stopping per lane, and one S2
  projection.
* The longstep plane projection solves the tiny dual of the
  plane-intersection QP with a fixed number of FISTA steps, a loop on the
  device.
* Anderson acceleration solves its k x k system by Gaussian elimination
  with partial pivoting written out in tensor operations
  (:func:`_solve_small`): ``torch.linalg.solve_ex(check_errors=False)``
  synchronises with the host on the card, so a CUDA graph cannot hold
  it.

Which step does the extra work follows the host's iteration count when the
engine passes one; inside a CUDA graph and in ``fused_solve`` it follows the
device's ``st.i`` through :func:`control.cond` (IF nodes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from fos_tpu_torch.linalg import control, lanes
from fos_tpu_torch.linalg.cg import CGState
from fos_tpu_torch.solvers.base import Algorithm, PlaneBuf, SolverState

#: the line search's step sizes: 0.1 * 1.8^k, k = 1..31 (linesearch.jl:54)
LS_GRID = 31


def _advance_cg_calls(state, k: int):
    """Advance a CG-backed set state's call counter by ``k`` probe calls
    (no-op for stateless sets)."""
    if isinstance(state, CGState):
        return state._replace(call_idx=state.call_idx + k)
    return state


def ls_alphas(like):
    """The line search's step sizes ``0.1 * 1.8^k``, k = 1..31, in
    ``like``'s dtype on its device (made there: no copy from the host)."""
    k = torch.arange(1, LS_GRID + 1, dtype=like.dtype, device=like.device)
    return 0.1 * torch.full_like(k, 1.8) ** k


def _branch(i, every: int, st, extra, plain):
    """``extra(st)`` at the steps ``(i + 1) % every == 0``, else
    ``plain(st)``: on the host's count ``i`` when given, else on the
    device's ``st.i`` (two IF nodes under capture)."""
    if i is None:
        return control.cond((lanes.common_count(st.i) + 1) % every == 0,
                            extra, plain, st)
    return extra(st) if (i + 1) % every == 0 else plain(st)


@dataclass(frozen=True)
class LineSearchWrapper(Algorithm):
    """Every ``lsinterval`` iterations: take one T = S2∘S1 step, set
    ``res = T(x) - x``, and grid-search ``alpha in 0.1*1.8^k, k=1..31``
    minimising the fixed-point residual ``||T(x + alpha res) - (x + alpha
    res)||`` (linesearch.jl:36-75)."""

    alg: Algorithm = None
    lsinterval: int = 100
    options: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if not self.alg.support_linesearch:
            raise ValueError(f"Algorithm {type(self.alg).__name__} does not "
                             "support line search")

    def init_aux(self, x0):
        return self.alg.init_aux(x0)

    def coeffs(self, aux):
        return self.alg.coeffs(aux)

    def step(self, sets, st: SolverState, i=None) -> SolverState:
        return _branch(i, self.lsinterval, st,
                       lambda s: self._ls_step(sets, s),
                       lambda s: self.alg.step(sets, s, i))

    def _ls_step(self, sets, st):
        inner = self.alg
        x_prev = st.x
        tmp2, s1_state = inner.relaxed_s1(sets, st.x, st.s1_state, st.aux)
        z, x_new, s2_state = inner.relaxed_s2(sets, tmp2, st.s2_state, st.aux)
        res = x_new - x_prev
        alphas = ls_alphas(st.x)
        cands = x_prev[None, :] + alphas[:, None] * res[None, :]
        s1 = sets.s1
        if (getattr(s1, "projection_is_affine", False)
                and getattr(s1, "direct", False)):
            # the relaxed S1 map is affine, so the 31 probe projections
            # collapse to one or two: relaxed_s1(x + a res) = tmp2 +
            # a (relaxed_s1(res) - relaxed_s1(0)) (gap.jl:42-51's constinit
            # role); offset-free sets skip the zero term.  Direct mode only:
            # with CG the identity holds to cg_tol, which the extrapolation
            # multiplies by alpha (up to 8e6), as the JAX package found
            s1_res, _ = inner.relaxed_s1(sets, res, s1_state, st.aux)
            if getattr(s1, "projection_offset_free", False):
                dirn = s1_res
            else:
                s1_zero, _ = inner.relaxed_s1(sets, torch.zeros_like(res),
                                              s1_state, st.aux)
                dirn = s1_res - s1_zero
            y1c = tmp2[None, :] + alphas[:, None] * dirn[None, :]
        else:
            # the probes share the step's warm start, read only, and their
            # states are dropped (NoStatus probes, linesearch.jl:58-63)
            y1c, _ = inner.relaxed_s1(sets, cands, s1_state, st.aux)
        _, Tx, _ = inner.relaxed_s2(sets, y1c, s2_state, st.aux)
        testres = torch.linalg.vector_norm(Tx - cands, dim=-1)
        # gather, not indexing with a device scalar (which may read it)
        best = alphas.gather(0, torch.argmin(testres).reshape(1))
        x_ls = x_prev + best * res
        # the reference's prox! counts its probe calls too
        # (affinepluslinear.jl:113 under NoStatus), so the decreasing-
        # accuracy schedule sees all 31; the warm start stays the real
        # step's
        s1_state = _advance_cg_calls(s1_state, LS_GRID)
        s2_state = _advance_cg_calls(s2_state, LS_GRID)
        return st._replace(x=x_ls, i=st.i + 1, z_check=z,
                           z_check_prev=st.z_check, s1_state=s1_state,
                           s2_state=s2_state)

    def getsol(self, sets, st):
        return self.alg.getsol(sets, st)


def _solve_small(M, rhs):
    """Solve ``M w = rhs`` for a small k x k ``M``: Gaussian elimination
    with partial pivoting (LAPACK getrf's choice of pivot), unrolled over
    the k columns in tensor operations, so nothing is read on the host and
    a CUDA graph can hold it."""
    k = M.shape[0]
    rows = torch.arange(k, device=M.device)
    Ab = torch.cat([M, rhs[:, None]], 1)
    for j in range(k):
        # the row at or below j with the largest |entry| in column j
        mag = torch.where(rows >= j, Ab[:, j].abs(), -1.0)
        p = torch.argmax(mag)
        perm = torch.where(rows == j, p, torch.where(rows == p, j, rows))
        Ab = Ab.index_select(0, perm)
        f = torch.where(rows > j, Ab[:, j] / Ab[j, j], 0.0)
        Ab = Ab - f[:, None] * Ab[j][None, :]
    w = torch.zeros(k, dtype=M.dtype, device=M.device)
    for j in range(k - 1, -1, -1):
        w[j] = (Ab[j, k] - torch.dot(Ab[j, :k], w)) / Ab[j, j]
    return w


def _project_on_planes(x, A, b, nsave: int, iters: int = 400):
    """Project x onto ``{y : A_eq y = b_eq} ∩ {y : C y <= d}``: rows
    ``[0, nsave]`` of (A, b) are equalities, the rest inequalities
    (saveplanes.jl).  Solved in the r-dimensional dual ``min 1/2 th'G th -
    th'g0 s.t. th_ineq >= 0`` with ``y = x - A' th`` by ``iters`` FISTA
    steps, a loop on the device (r = 2 (nsave + 1))."""
    r = A.shape[0]
    G = torch.matmul(A, A.T)
    g0 = torch.matmul(A, x) - b
    # Lipschitz bound: trace(G) >= lambda_max(G); zero planes guarded
    L = torch.clamp_min(torch.trace(G), 1e-30)
    ineq = torch.arange(r, device=x.device) > nsave

    def body(_, carry):
        th, th_prev, t = carry
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t ** 2)) / 2.0
        w = th + ((t - 1.0) / t_new) * (th - th_prev)
        th_next = w - (torch.matmul(G, w) - g0) / L
        # equality multipliers free, inequality multipliers >= 0
        th_next = torch.where(ineq, torch.clamp_min(th_next, 0.0), th_next)
        return th_next, th, t_new

    th0 = torch.zeros(r, dtype=x.dtype, device=x.device)
    th, _, _ = control.fori_loop(
        iters, body,
        (th0, th0.clone(), torch.ones((), dtype=x.dtype, device=x.device)))
    return x - torch.matmul(A.T, th)


@dataclass(frozen=True)
class AndersonWrapper(Algorithm):
    """Anderson acceleration (type II) of the wrapped algorithm's
    fixed-point iteration (what SCS >= 3.0 ships; the reference has none).

    A ring of the last ``memory`` pairs (x_j, f_j = step(x_j) - x_j); the
    iterate becomes the residual-minimising affine combination ``sum a_j
    (x_j + f_j)``, ``sum a_j = 1``, from the regularised k x k Gram system.
    If the step residual grew by more than ``safeguard`` the memory is
    flushed and the plain step taken.  With ``adaptive`` the acceleration
    engages only once the plain iteration stalls (its residual has not
    fallen by ``stall_decay`` over ``stall_window`` steps).  All of it is
    masked arithmetic on the device.
    """

    alg: Algorithm = None
    memory: int = 10
    reg: float = 1e-10
    safeguard: float = 2.0
    adaptive: bool = True
    stall_window: int = 30
    stall_decay: float = 0.9
    options: Tuple[Tuple[str, Any], ...] = ()

    def init_aux(self, x0):
        k, dim = self.memory, x0.shape[-1]
        f = dict(dtype=x0.dtype, device=x0.device)
        i32 = dict(dtype=torch.int32, device=x0.device)
        return (
            self.alg.init_aux(x0),
            torch.zeros((k, dim), **f),                       # X ring
            torch.zeros((k, dim), **f),                       # F ring
            torch.zeros((), **i32),                           # pairs since flush
            torch.full((), float("inf"), **f),                # last residual
            torch.full((self.stall_window,), float("inf"), **f),  # its history
            torch.full((), not self.adaptive, dtype=torch.bool,
                       device=x0.device),                     # engaged
            torch.zeros((), **i32),                           # steps taken
        )

    def coeffs(self, aux):
        return self.alg.coeffs(aux[0])

    def step(self, sets, st: SolverState, i=None) -> SolverState:
        inner_aux, Xb, Fb, count, prev_fn, fnbuf, engaged, tstep = st.aux
        k, W = self.memory, self.stall_window
        dtype, dev = st.x.dtype, st.x.device

        st2 = self.alg.step(sets, st._replace(aux=inner_aux), i)
        x_plain = st2.x
        f = x_plain - st.x
        fn = torch.linalg.vector_norm(f)

        # engage once the plain iteration stalls, with a flushed memory
        at = (tstep % W).reshape(1).long()
        oldest = fnbuf.index_select(0, at)[0]
        stalled = (tstep >= W) & (fn > self.stall_decay * oldest)
        newly_engaged = stalled & ~engaged
        engaged = engaged | stalled
        fnbuf = fnbuf.index_copy(0, at, fn.reshape(1))
        tstep = tstep + 1

        # safeguard: the residual grew too much -> flush, plain step
        reset = (fn > self.safeguard * prev_fn) | newly_engaged
        count = torch.where(reset, torch.zeros_like(count), count)
        slot = (count % k).reshape(1).long()
        Xb = Xb.index_copy(0, slot, st.x[None])
        Fb = Fb.index_copy(0, slot, f[None])
        count = count + 1

        # the Gram system at unit trace (alpha is scale-invariant), with a
        # dtype-relative ridge and the unfilled slots masked out by a large
        # diagonal (which also keeps the pivots safe)
        filled = torch.arange(k, device=dev) < count
        M = torch.matmul(Fb, Fb.T)
        M = M / torch.clamp_min(torch.trace(M), 1e-30)
        reg = max(self.reg, 100.0 * torch.finfo(dtype).eps)
        eye = torch.eye(k, dtype=dtype, device=dev)
        M = M + reg * eye
        M = M + torch.where(filled, 0.0, 1e30).to(dtype) * eye
        w = _solve_small(M, torch.ones(k, dtype=dtype, device=dev))
        x_aa = torch.matmul(w / w.sum(), Xb + Fb)

        # accelerate once engaged, with >= 2 pairs, while the solve is finite
        use_aa = engaged & (count >= 2) & torch.isfinite(x_aa).all()
        x_new = torch.where(use_aa, x_aa, x_plain)
        return st2._replace(
            x=x_new, aux=(st2.aux, Xb, Fb, count, fn, fnbuf, engaged, tstep))

    def getsol(self, sets, st):
        guess, inner = self.alg.getsol(sets, st._replace(aux=st.aux[0]))
        return guess, inner._replace(aux=(inner.aux, *st.aux[1:]))


@dataclass(frozen=True)
class LongstepWrapper(Algorithm):
    """During the ``nsave + 1`` iterations before each ``longinterval``
    boundary, record the supporting hyperplanes of every projection; at
    the boundary replace x by its projection onto their intersection
    (longstep.jl:43-60)."""

    alg: Algorithm = None
    longinterval: int = 100
    nsave: int = 10
    qp_iters: int = 400
    options: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if not self.alg.support_longstep:
            raise ValueError(f"Algorithm {type(self.alg).__name__} does not "
                             "support longstep")

    def init_aux(self, x0):
        rows = 2 * (self.nsave + 1)
        planes = PlaneBuf(
            A=torch.zeros((rows, x0.shape[-1]), dtype=x0.dtype,
                          device=x0.device),
            b=torch.zeros(rows, dtype=x0.dtype, device=x0.device),
            slot=torch.full((), -1, dtype=torch.int32, device=x0.device))
        return (self.alg.init_aux(x0), planes)

    def coeffs(self, aux):
        return self.alg.coeffs(aux[0])

    def _slot(self, i):
        # savepos = (i-1) % longinterval - longinterval + nsave + 2 for the
        # 1-based iteration i about to run (longstep.jl:46), minus one
        return (i % self.longinterval) - self.longinterval + self.nsave + 1

    def step(self, sets, st: SolverState, i=None) -> SolverState:
        inner_aux, planes = st.aux
        if i is None:
            slot = self._slot(st.i)
        else:
            slot = torch.full((), self._slot(i), dtype=torch.int32,
                              device=st.x.device)
        inner, planes = self.alg.step_capture(
            sets, st._replace(aux=inner_aux), planes._replace(slot=slot))

        def longstep(x):
            return _project_on_planes(x, planes.A, planes.b, self.nsave,
                                      self.qp_iters)

        if i is None:
            x_new = control.cond(slot == self.nsave, longstep, lambda x: x,
                                 inner.x)
        else:
            x_new = (longstep(inner.x) if self._slot(i) == self.nsave
                     else inner.x)
        return inner._replace(x=x_new, aux=(inner.aux, planes))

    def getsol(self, sets, st):
        inner_aux, planes = st.aux
        guess, inner = self.alg.getsol(sets, st._replace(aux=inner_aux))
        return guess, inner._replace(aux=(inner.aux, planes))
