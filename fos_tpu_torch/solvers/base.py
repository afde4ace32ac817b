"""Solver core: the state, the set protocol and the GAP algorithm family.

An algorithm is a frozen config dataclass whose ``step`` maps a
:class:`SolverState` to the next one.  Every algorithm sees two projectable
sets S1 and S2: an object with ``init_state(dtype)`` (or
``init_state_from(x0)``) and ``project(x, state) -> (y, state)``.  The
post-S2-projection point of each step is kept as ``z_check``, the point the
convergence check runs on (FirstOrderSolvers.jl src/solvers/gap.jl:53-59).

Ported: GAP and its two named cases DR = GAP(0.5, 2, 2) and AP =
GAP(1, 1, 1), GAPA, GAPP, FISTA and Dykstra.  ``step(sets, st, i)`` gets
``i``, the host's count of the steps already taken (``st.i`` without a
device read), or None inside a CUDA graph and in ``fused_solve``, where
the steps loop on the device; GAPP and the wrappers
(:mod:`fos_tpu_torch.solvers.wrappers`) branch on it, on the device's
``st.i`` when ``i`` is None.  The wrappers' hooks live here: the relaxed
S1/S2 maps of the line search, the capability traits, and
``step_capture``, a step that records its supporting hyperplanes in a
:class:`PlaneBuf` for the longstep wrapper.

A state may carry a lane axis (a batched solve's instances): ``x`` of
shape ``(B, dim)``, ``i`` and the per-algorithm scalars ``(B,)``; the GAP
family, GAPA, FISTA and Dykstra step every lane at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from fos_tpu_torch.cones.spec import ConeSpec
from fos_tpu_torch.cones.project import prepare as cone_prepare
from fos_tpu_torch.cones.project import project as cone_project
from fos_tpu_torch.linalg import control, lanes


class SolverState(NamedTuple):
    x: torch.Tensor
    i: torch.Tensor             # int32 iteration counter
    z_check: torch.Tensor       # post-S2-projection point of the latest step
    z_check_prev: torch.Tensor  # same, one step earlier
    s1_state: Any
    s2_state: Any
    aux: Any                    # per-algorithm carry


class PlaneBuf(NamedTuple):
    """Supporting-hyperplane capture rows for the longstep wrapper.

    Rows ``[0, nsave]`` hold equality planes (from S1 projections), rows
    ``[nsave + 1, 2 nsave + 1]`` inequality planes (from S2 projections),
    the intended layout of the reference's ``SavedPlanes``
    (longstep.jl:68-101, saveplanes.jl:13-60).  ``slot`` (int32, on the
    device) is the 0-based window position; negative means no capture.
    """

    A: torch.Tensor      # (rows, dim)
    b: torch.Tensor      # (rows,)
    slot: torch.Tensor   # int32


def _plane_row(planes: PlaneBuf, row, x, y) -> PlaneBuf:
    """Write the plane {w : <x-y, w> = <x-y, y>} into ``row`` when the
    capture is active, as a masked write on the device (no host read)."""
    a = x - y
    bval = torch.dot(a, y)
    write = planes.slot >= 0
    at = torch.clamp(row, 0, planes.A.shape[0] - 1).reshape(1).long()
    A = planes.A.index_copy(0, at, torch.where(
        write, a, planes.A.index_select(0, at)[0])[None])
    b = planes.b.index_copy(0, at, torch.where(
        write, bval, planes.b.index_select(0, at)[0]).reshape(1))
    return planes._replace(A=A, b=b)


def capture_eq(planes, x, y):
    """Record an S1 (equality) supporting plane (longstep.jl:71-84)."""
    if planes is None:
        return None
    return _plane_row(planes, planes.slot, x, y)


def capture_ineq(planes, x, y):
    """Record an S2 (inequality) supporting plane (longstep.jl:87-101)."""
    if planes is None:
        return None
    return _plane_row(planes, planes.A.shape[0] // 2 + planes.slot, x, y)


class ConeSet:
    """Stateless projectable set backed by a compiled cone projector;
    ``psd_method`` ("auto", "eigh" or "poly") picks the PSD blocks'
    projection, "auto" by the device of the projected vector."""

    def __init__(self, spec: ConeSpec, psd_method: str = "auto"):
        self.spec = spec
        self.psd_method = psd_method

    def init_state(self, dtype):
        return ()

    def prepare(self, like):
        """Copy the projection's tables to ``like``'s device before a CUDA
        graph is captured (:func:`fos_tpu_torch.cones.project.prepare`)."""
        cone_prepare(self.spec, like, self.psd_method)

    def project(self, x, state):
        return cone_project(self.spec, x, self.psd_method), state


class TwoSets:
    """The (S1, S2) pair handed to every algorithm."""

    def __init__(self, s1, s2):
        self.s1 = s1
        self.s2 = s2


def init_solver_state(alg, sets: TwoSets, x0) -> SolverState:
    # a set may seed its state from the initial iterate (init_state_from):
    # the HSDE S1 projector pre-pays Q @ u0 there
    def init(s):
        if hasattr(s, "init_state_from"):
            return s.init_state_from(x0)
        return s.init_state(x0.dtype)

    return SolverState(
        x=x0,
        i=torch.zeros(lanes.lane_shape(x0), dtype=torch.int32,
                      device=x0.device),
        z_check=x0,
        z_check_prev=x0,
        s1_state=init(sets.s1),
        s2_state=init(sets.s2),
        aux=alg.init_aux(x0),
    )


@dataclass(frozen=True)
class Algorithm:
    """Base config; subclasses are frozen and hashable."""

    def init_aux(self, x0):
        return ()

    def coeffs(self, aux) -> Tuple[Any, Any]:
        raise NotImplementedError

    # --- the S1!/S2! split used by the GAP steps and the wrappers
    # (the reference's line-search protocol, defaults.jl:8-21)
    def relaxed_s1(self, sets: TwoSets, x, s1_state, aux):
        a1, _ = self.coeffs(aux)
        y, s1_state = sets.s1.project(x, s1_state)
        return _relax(a1, y, x), s1_state

    def relaxed_s2(self, sets: TwoSets, x, s2_state, aux):
        """(prox point, relaxed point, state); the prox point is the
        convergence-check point (gap.jl:53-59)."""
        _, a2 = self.coeffs(aux)
        y, s2_state = sets.s2.project(x, s2_state)
        return y, _relax(a2, y, x), s2_state

    def step(self, sets: TwoSets, st: SolverState, i: int = None) -> SolverState:
        raise NotImplementedError

    def step_logged(self, sets: TwoSets, st: SolverState, i: int = None):
        """Step plus the ``logextra`` snapshots: the (x, P_S1 x, relaxed)
        triple the reference records at check iterations of feasibility
        problems (FeasibilityStatus.jl:19-25; only GAP's and GAPA's S1!
        record it, gap.jl:44-49, gapa.jl:63-68).  Others return None."""
        return self.step(sets, st, i), None

    def getsol(self, sets: TwoSets, st: SolverState):
        """Final solution guess ``P_S2(P_S1(x))`` (gap.jl:82-87)."""
        y1, s1_state = sets.s1.project(st.x, st.s1_state)
        y2, s2_state = sets.s2.project(y1, st.s2_state)
        return y2, st._replace(s1_state=s1_state, s2_state=s2_state)

    # --- capability traits (defaults.jl:2-30)
    @property
    def support_linesearch(self) -> bool:
        return False

    @property
    def support_longstep(self) -> bool:
        return False


def _relax(a, y, x):
    """``a y + (1 - a) x``; ``a`` a number, or a tensor with one value per
    lane."""
    a = lanes.per_lane(a, y)
    return a * y + (1.0 - a) * x


def _advance(st, x, z, s1_state, s2_state, **aux):
    """The state after one step: ``z`` is the step's post-S2 point."""
    return st._replace(x=x, i=st.i + 1, z_check=z, z_check_prev=st.z_check,
                       s1_state=s1_state, s2_state=s2_state, **aux)


def _gap_like_step(alg, sets, st, snap=False, planes=None):
    """The shared two-relaxed-projections step (gap.jl:61-80); returns the
    new state, the two relaxed points, with ``snap`` the S1-stage
    snapshots, and ``planes`` with the step's supporting planes recorded
    (None stays None)."""
    alpha = alg.alpha
    a1, a2 = alg.coeffs(st.aux)
    y1, s1_state = sets.s1.project(st.x, st.s1_state)
    planes = capture_eq(planes, st.x, y1)
    tmp1 = _relax(a1, y1, st.x)
    z, s2_state = sets.s2.project(tmp1, st.s2_state)
    planes = capture_ineq(planes, tmp1, z)
    tmp2 = _relax(a2, z, tmp1)
    x_new = alpha * tmp2 + (1.0 - alpha) * st.x
    snaps = torch.stack([st.x, y1, tmp1]) if snap else None
    return (_advance(st, x_new, z, s1_state, s2_state), tmp1, tmp2, snaps,
            planes)


@dataclass(frozen=True)
class GAP(Algorithm):
    """Generalized Alternating Projections (gap.jl:6-92).

    ``x+ = (1-alpha) x + alpha * relax_{a2}(P_S2( relax_{a1}(P_S1(x)) ))``.
    """

    alpha: float = 0.8
    alpha1: float = 1.8
    alpha2: float = 1.8
    direct: bool = False
    options: Tuple[Tuple[str, Any], ...] = ()

    def coeffs(self, aux):
        return self.alpha1, self.alpha2

    def step(self, sets, st, i=None):
        return _gap_like_step(self, sets, st)[0]

    def step_logged(self, sets, st, i=None):
        st, _, _, snaps, _ = _gap_like_step(self, sets, st, snap=True)
        return st, snaps

    def step_capture(self, sets, st, planes):
        st, _, _, _, planes = _gap_like_step(self, sets, st, planes=planes)
        return st, planes

    @property
    def support_linesearch(self):
        return True

    @property
    def support_longstep(self):
        return True


def DR(alpha: float = 0.5, *, direct: bool = False, **kwargs) -> GAP:
    """Douglas-Rachford = GAP(alpha, 2, 2) (solvers.jl:10)."""
    return GAP(alpha, 2.0, 2.0, direct, tuple(kwargs.items()))


def AP(alpha: float = 1.0, *, direct: bool = False, **kwargs) -> GAP:
    """Alternating Projections = GAP(alpha, 1, 1) (solvers.jl:11)."""
    return GAP(alpha, 1.0, 1.0, direct, tuple(kwargs.items()))


@dataclass(frozen=True)
class GAPA(Algorithm):
    """Adaptive GAP (gapa.jl): alpha1 = alpha2 = a12, carried in ``aux`` and
    adapted from an estimate of the Friedrichs angle between the sets
    (gapa.jl:80-105): ``scl = |<tmp2-tmp1, tmp1-x>| / (||tmp2-tmp1||
    ||tmp1-x||)`` (NaN -> 0, then clamped to [0, 1]),
    ``aopt = 2/(1+sqrt(1-scl^2))``, ``a12 = (1-beta) aopt + 2 beta``.
    """

    alpha: float = 1.0
    beta: float = 0.0
    direct: bool = False
    options: Tuple[Tuple[str, Any], ...] = ()

    def init_aux(self, x0):
        return torch.full(lanes.lane_shape(x0), 2.0, dtype=x0.dtype,
                          device=x0.device)

    def coeffs(self, aux):
        return aux, aux

    def step(self, sets, st, i=None):
        return self._step(sets, st)[0]

    def step_logged(self, sets, st, i=None):
        st, snaps, _ = self._step(sets, st, snap=True)
        return st, snaps

    def step_capture(self, sets, st, planes):
        st, _, planes = self._step(sets, st, planes=planes)
        return st, planes

    @property
    def support_linesearch(self):
        return True

    @property
    def support_longstep(self):
        return True

    def _step(self, sets, st, snap=False, planes=None):
        st2, tmp1, tmp2, snaps, planes = _gap_like_step(
            self, sets, st, snap=snap, planes=planes)
        d1 = tmp2 - tmp1
        d2 = tmp1 - st.x
        num = torch.abs(lanes.vdot(d1, d2))
        den = torch.sqrt(lanes.vdot(d1, d1) * lanes.vdot(d2, d2))
        scl = num / den
        # 0/0 when the step stands still: NaN -> 0 first, then the clip
        scl = torch.where(torch.isnan(scl), 0.0, torch.clamp(scl, 0.0, 1.0))
        aopt = 2.0 / (1.0 + torch.sqrt(1.0 - scl ** 2))
        a12 = (1.0 - self.beta) * aopt + 2.0 * self.beta
        return st2._replace(aux=a12.to(st.x.dtype)), snaps, planes


@dataclass(frozen=True)
class GAPP(Algorithm):
    """Projected GAP (Fält & Giselsson 2016; gapproj.jl).

    Every ``iproj``-th step computes the residual direction ``res =
    P_S1(P_S2(P_S1 x)) - P_S1(x)`` and steps to ``tmp1 + a* res``, ``a*``
    minimising the S2 fixed-point residual over ``a = 2^k, k = 0..20`` (one
    batched S2 projection); the other steps are GAP's.  Which step is which
    follows the host's iteration count, so the choice costs no device read;
    without one (``i`` None: a captured or fused step) it follows the
    device's ``st.i``, through :func:`control.cond` (two IF nodes in a
    graph).
    """

    alpha: float = 0.8
    alpha1: float = 1.8
    alpha2: float = 1.8
    iproj: int = 100
    direct: bool = True
    options: Tuple[Tuple[str, Any], ...] = ()

    def coeffs(self, aux):
        return self.alpha1, self.alpha2

    def step(self, sets, st, i=None):
        if i is None:
            return control.cond(
                (lanes.common_count(st.i) + 1) % self.iproj == 0,
                lambda s: self._projected_step(sets, s),
                lambda s: _gap_like_step(self, sets, s)[0], st)
        if (i + 1) % self.iproj != 0:
            return _gap_like_step(self, sets, st)[0]
        return self._projected_step(sets, st)

    def _projected_step(self, sets, st):
        a2 = self.alpha2
        tmp1, s1_state = sets.s1.project(st.x, st.s1_state)
        tmp2, s2_state = sets.s2.project(tmp1, st.s2_state)
        p1, s1_state = sets.s1.project(tmp2, s1_state)
        res = p1 - tmp1
        alphas = 2.0 ** torch.arange(21, dtype=st.x.dtype, device=st.x.device)
        cands = tmp1[None, :] + alphas[:, None] * res[None, :]
        projs, _ = sets.s2.project(cands, s2_state)
        norms = torch.linalg.vector_norm(projs - cands, dim=-1)
        # gather, not indexing with a device scalar (which may read it)
        t1 = tmp1 + alphas.gather(0, torch.argmin(norms).reshape(1)) * res
        z, s2_state = sets.s2.project(t1, s2_state)
        x_new = a2 * z + (1.0 - a2) * t1
        return _advance(st, x_new, z, s1_state, s2_state)


@dataclass(frozen=True)
class FISTA(Algorithm):
    """FISTA-accelerated alternating projections (fista.jl).

    aux = (t, y, x_old); ``t+ = (1+sqrt(1+4 t^2))/2``,
    ``y = x + ((t-1)/t+) (x - x_old)``.
    """

    alpha: float = 1.0
    direct: bool = False
    options: Tuple[Tuple[str, Any], ...] = ()

    def init_aux(self, x0):
        # y starts at x0 (the reference's i == 1 special case, fista.jl:35-37)
        return (torch.full(lanes.lane_shape(x0), 1.0, dtype=x0.dtype,
                           device=x0.device), x0, torch.zeros_like(x0))

    def coeffs(self, aux):
        return self.alpha, 1.0

    def step(self, sets, st, i=None):
        return self.step_capture(sets, st, None)[0]

    def step_capture(self, sets, st, planes):
        t, y, _ = st.aux
        y1, s1_state = sets.s1.project(y, st.s1_state)
        planes = capture_eq(planes, y, y1)
        tmp1 = self.alpha * y1 + (1.0 - self.alpha) * y
        x_new, s2_state = sets.s2.project(tmp1, st.s2_state)
        planes = capture_ineq(planes, tmp1, x_new)
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t ** 2)) / 2.0
        y_new = x_new + lanes.per_lane((t - 1.0) / t_new, x_new) * (
            x_new - st.x)
        return _advance(st, x_new, x_new, s1_state, s2_state,
                        aux=(t_new, y_new, st.x)), planes

    @property
    def support_longstep(self):
        return True


@dataclass(frozen=True)
class Dykstra(Algorithm):
    """Boyle-Dykstra alternating projections with correction vectors
    (dykstra.jl:26-37): ``y = P_S1(x+p); p += x-y; x = P_S2(y+q); q += y-x``.
    """

    direct: bool = False
    options: Tuple[Tuple[str, Any], ...] = ()

    def init_aux(self, x0):
        return (torch.zeros_like(x0), torch.zeros_like(x0))

    def coeffs(self, aux):
        return 1.0, 1.0

    def step(self, sets, st, i=None):
        return self.step_capture(sets, st, None)[0]

    def step_capture(self, sets, st, planes):
        p, q = st.aux
        xp = st.x + p
        y, s1_state = sets.s1.project(xp, st.s1_state)
        planes = capture_eq(planes, xp, y)
        yq = y + q
        x_new, s2_state = sets.s2.project(yq, st.s2_state)
        planes = capture_ineq(planes, yq, x_new)
        return _advance(st, x_new, x_new, s1_state, s2_state,
                        aux=(xp - y, yq - x_new)), planes

    @property
    def support_longstep(self):
        return True
