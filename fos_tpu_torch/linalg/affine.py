"""The HSDE affine projector (the S1 set of the conic solve).

Projection onto ``{(u, v) : Q u = v}`` by warm-started CG on the SPD system
``(I + Q'Q) u = u0 - Q v0`` with the decreasing-accuracy tolerance of
FirstOrderSolvers.jl (affinepluslinear.jl:83-126, HSDEAffine.jl:105-126),
tracking ``v = Q u`` through the CG recurrence.  The direct (QR) back end
is not ported yet (ROADMAP, queue 1 "Direct mode").
"""

from __future__ import annotations

import torch

from fos_tpu_torch.config import eps_of
from fos_tpu_torch.linalg import hsde_ops
from fos_tpu_torch.linalg.cg import (CGState, conjugate_gradient_tracked,
                                     decreasing_tolerance)


def _default_floor(size: int, dtype) -> float:
    """CG absolute-tolerance floor: FirstOrderSolvers.jl's ``size*eps``
    (affinepluslinear.jl:108).  Loose at f32 and large size; the engine's
    stall recovery tightens it per problem (HSDEForm.tighten_cg)."""
    return size * eps_of(dtype)


class HSDEAffineProjector:
    """Projection onto ``{(u, v) : Q u = v}`` for the HSDE operator Q."""

    def __init__(self, A, b, c, *, decreasing_accuracy=True, cg_max_iters=1000,
                 tol_floor=None, cg_unroll=2, compensated=False):
        self.A = A
        self.b = b
        self.c = c
        self.direct = False
        self.decreasing_accuracy = decreasing_accuracy
        self.cg_max_iters = cg_max_iters
        self.tol_floor = tol_floor
        self.cg_unroll = cg_unroll
        self.compensated = compensated
        self._neg_cb = -torch.cat([c, b])

    @classmethod
    def create(cls, A, b, c, *, direct=False, decreasing_accuracy=True,
               cg_max_iters=1000, tol_floor=None, cg_variant="standard",
               cg_unroll=2, compensated=False):
        if direct:
            raise NotImplementedError(
                "direct=True (QR) is not ported yet: ROADMAP queue 1, "
                "'Direct mode'")
        if cg_variant != "standard":
            raise NotImplementedError(
                f"cg_variant={cg_variant!r} is not ported yet: ROADMAP queue "
                "1, 'Sharding' (pipelined CG)")
        return cls(A, b, c, decreasing_accuracy=decreasing_accuracy,
                   cg_max_iters=cg_max_iters, tol_floor=tol_floor,
                   cg_unroll=cg_unroll, compensated=compensated)

    def replace(self, **changes) -> "HSDEAffineProjector":
        """A copy with some settings changed (every field is carried)."""
        kw = dict(decreasing_accuracy=self.decreasing_accuracy,
                  cg_max_iters=self.cg_max_iters, tol_floor=self.tol_floor,
                  cg_unroll=self.cg_unroll, compensated=self.compensated)
        kw.update(changes)
        return HSDEAffineProjector(self.A, self.b, self.c, **kw)

    @property
    def l(self) -> int:
        return self.b.shape[0] + self.c.shape[0] + 1

    @property
    def dim(self) -> int:
        return 2 * self.l

    def _q(self, u):
        return hsde_ops.q_mul(self.A, self.b, self.c, u, self._neg_cb)

    def init_state(self, dtype) -> CGState:
        return CGState.create(self.l, dtype, self.b.device)

    def init_state_from(self, z0) -> CGState:
        """Warm start seeded from the initial iterate: ``warm = u0`` and
        ``v_warm = Q u0``, one pair paid once so that every projection
        forms its CG residual with a single pair."""
        u0 = z0[: self.l]
        return CGState.create(self.l, z0.dtype, z0.device)._replace(
            warm=u0, v_warm=self._q(u0),
            initialized=torch.tensor(True, device=z0.device))

    def refresh_state(self, cg: CGState) -> CGState:
        """Re-anchor the tracked invariant ``v_warm = Q warm`` with one fresh
        pair.  The ``Qx += alpha * Qp`` track random-walks by rounding across
        outer iterations, which at tight eps in f32 displaces the DR fixed
        point enough to stall; the engine calls this once per check chunk."""
        if cg.v_warm is None:
            return cg
        return cg._replace(v_warm=self._q(cg.warm))

    def project(self, z, cg: CGState):
        if cg.v_warm is None:
            raise ValueError(
                "CGState without v_warm: seed it with init_state_from")
        l = self.l
        u0 = z[:l]
        v0 = z[l:]
        # one pair for the initial residual, by skew-symmetry:
        #   r0 = u0 - Q v0 - warm - Q'(Q warm) = u0 - Q(v0 - v_warm) - warm
        warm = cg.warm
        r0 = u0 - self._q(v0 - cg.v_warm) - warm
        if cg.floor is not None:
            floor = cg.floor
        elif self.tol_floor is not None:
            floor = self.tol_floor
        else:
            floor = _default_floor(2 * l, z.dtype)  # KKT size = 2l
        if self.decreasing_accuracy:
            tol = decreasing_tolerance(cg.call_idx, floor, z.dtype)
        else:
            tol = (floor.to(z.dtype) if isinstance(floor, torch.Tensor)
                   else torch.full((), floor, dtype=z.dtype, device=z.device))
        res = conjugate_gradient_tracked(
            self._q, r0, warm, cg.v_warm, tol=tol, max_iters=self.cg_max_iters,
            unroll=self.cg_unroll, compensated=self.compensated)
        total = None if cg.total_iters is None else cg.total_iters + res.iters
        new_cg = cg._replace(warm=res.x, v_warm=res.Qx,
                             initialized=torch.ones_like(cg.initialized),
                             call_idx=cg.call_idx + 1, last_iters=res.iters,
                             total_iters=total)
        return torch.cat([res.x, res.Qx]), new_cg
