"""Solver core: the state, the set protocol and the GAP algorithm family.

An algorithm is a frozen config dataclass whose ``step`` maps a
:class:`SolverState` to the next one.  Every algorithm sees two projectable
sets S1 and S2: an object with ``init_state(dtype)`` (or
``init_state_from(x0)``) and ``project(x, state) -> (y, state)``.  The
post-S2-projection point of each step is kept as ``z_check``, the point the
convergence check runs on (FirstOrderSolvers.jl src/solvers/gap.jl:53-59).

Ported so far: GAP and its two named cases DR = GAP(0.5, 2, 2) and
AP = GAP(1, 1, 1).  GAPA, GAPP, FISTA, Dykstra and the wrappers' plane
capture are ROADMAP queue 1, "The other algorithms".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from fos_tpu_torch.cones.spec import ConeSpec
from fos_tpu_torch.cones.project import project as cone_project


class SolverState(NamedTuple):
    x: torch.Tensor
    i: torch.Tensor             # int32 iteration counter
    z_check: torch.Tensor       # post-S2-projection point of the latest step
    z_check_prev: torch.Tensor  # same, one step earlier
    s1_state: Any
    s2_state: Any
    aux: Any                    # per-algorithm carry


class ConeSet:
    """Stateless projectable set backed by a compiled cone projector."""

    def __init__(self, spec: ConeSpec):
        self.spec = spec

    def init_state(self, dtype):
        return ()

    def project(self, x, state):
        return cone_project(self.spec, x), state


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
        i=torch.zeros((), dtype=torch.int32, device=x0.device),
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

    def step(self, sets: TwoSets, st: SolverState) -> SolverState:
        raise NotImplementedError

    def getsol(self, sets: TwoSets, st: SolverState):
        """Final solution guess ``P_S2(P_S1(x))`` (gap.jl:82-87)."""
        y1, s1_state = sets.s1.project(st.x, st.s1_state)
        y2, s2_state = sets.s2.project(y1, st.s2_state)
        return y2, st._replace(s1_state=s1_state, s2_state=s2_state)


def _gap_like_step(alg, sets, st):
    """The shared two-relaxed-projections step (gap.jl:61-80)."""
    alpha = alg.alpha
    a1, a2 = alg.coeffs(st.aux)
    y1, s1_state = sets.s1.project(st.x, st.s1_state)
    tmp1 = a1 * y1 + (1.0 - a1) * st.x
    z, s2_state = sets.s2.project(tmp1, st.s2_state)
    tmp2 = a2 * z + (1.0 - a2) * tmp1
    x_new = alpha * tmp2 + (1.0 - alpha) * st.x
    return st._replace(
        x=x_new,
        i=st.i + 1,
        z_check=z,
        z_check_prev=st.z_check,
        s1_state=s1_state,
        s2_state=s2_state,
    )


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

    def step(self, sets, st):
        return _gap_like_step(self, sets, st)


def DR(alpha: float = 0.5, *, direct: bool = False, **kwargs) -> GAP:
    """Douglas-Rachford = GAP(alpha, 2, 2) (solvers.jl:10)."""
    return GAP(alpha, 2.0, 2.0, direct, tuple(kwargs.items()))


def AP(alpha: float = 1.0, *, direct: bool = False, **kwargs) -> GAP:
    """Alternating Projections = GAP(alpha, 1, 1) (solvers.jl:11)."""
    return GAP(alpha, 1.0, 1.0, direct, tuple(kwargs.items()))
