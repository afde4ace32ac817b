"""Conjugate gradients, warm-started, with the solver's masking semantics.

The JAX package runs CG as a ``lax.while_loop``; here the loop is
:func:`fos_tpu_torch.linalg.control.while_loop` over groups of ``unroll``
iterations.  Inside a group every step is masked by ``live = rn > tol^2``
exactly as in the reference (a finished solve takes zero steps), so the
iterates and the iteration count match it.  Eagerly the stopping test
``(rn > tol^2) & (it < max_iters)`` reads ``rn`` on the host once per group
(the plain version); inside a CUDA graph it is the ``cg_continue`` kernel
setting a WHILE node's condition on the device, and the group is the
node's body.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from fos_tpu_torch.linalg import control


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor     # int32 scalar
    rnorm: torch.Tensor


class CGState(NamedTuple):
    """Warm-start state carried between projections.

    ``call_idx`` counts projections and drives the decreasing-accuracy
    tolerance; ``last_iters`` is the ``cg`` column of the status table.
    ``floor`` optionally overrides the projector's tolerance floor and
    ``win_score`` carries the plateau-recovery baseline; ``total_iters``
    accumulates CG iterations over all calls; ``v_warm`` is ``Q @ warm``,
    carried so the next projection forms its residual with one pair (see
    :class:`fos_tpu_torch.linalg.affine.HSDEAffineProjector`).
    """

    warm: torch.Tensor
    initialized: torch.Tensor   # bool scalar
    call_idx: torch.Tensor      # int32, starts at 1
    last_iters: torch.Tensor    # int32
    floor: Any = None
    win_score: Any = None
    total_iters: Any = None
    v_warm: Any = None

    @staticmethod
    def create(size: int, dtype, device=None) -> "CGState":
        # fills on the device, no copies from the host
        i32 = dict(dtype=torch.int32, device=device)
        return CGState(
            warm=torch.zeros(size, dtype=dtype, device=device),
            initialized=torch.zeros((), dtype=torch.bool, device=device),
            call_idx=torch.ones((), **i32),
            last_iters=torch.zeros((), **i32),
            total_iters=torch.zeros((), **i32),
        )


def _dot_fn(compensated: bool):
    if compensated:
        from fos_tpu_torch.linalg.compensated import cdot

        return cdot
    return torch.dot


def _cg_step(dot, Ap, p, x, r, rn, it, tol2):
    """The masked CG update shared by both variants; returns
    (alpha, x, r, p, rn, it)."""
    live = rn > tol2
    den = dot(Ap, p)
    nz = den != 0
    alpha = torch.where(live & nz, rn / torch.where(nz, den, 1.0), 0.0)
    x = x + alpha * p
    r = r - alpha * Ap
    rn_new = dot(r, r)
    beta = torch.where(live, rn_new / torch.where(rn > 0, rn, 1.0), 0.0)
    p = torch.where(live, r + beta * p, p)
    return alpha, x, r, p, torch.where(live, rn_new, rn), it + live


def _tol2(tol, like):
    """tol^2 in ``like``'s dtype on its device, made there (a fill, not a
    copy from the host, so that it can be captured)."""
    if isinstance(tol, torch.Tensor):
        return tol.to(like.dtype) ** 2
    return torch.full((), tol, dtype=like.dtype, device=like.device) ** 2


def conjugate_gradient(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    tol,
    max_iters: int,
    unroll: int = 1,
    compensated: bool = False,
) -> CGResult:
    """Solve ``matvec(x) == b`` from warm start ``x0`` to an absolute
    tolerance on ``||r||``; ``compensated`` takes the two dots of each
    iteration in float-float arithmetic."""
    dot = _dot_fn(compensated)
    r = b - matvec(x0)
    rn = dot(r, r)
    tol2 = _tol2(tol, b)
    it = torch.zeros((), dtype=torch.int32, device=b.device)

    def group(c):
        x, r, p, rn, it = c
        for _ in range(unroll):
            Ap = matvec(p)
            _, x, r, p, rn, it = _cg_step(dot, Ap, p, x, r, rn, it, tol2)
        return x, r, p, rn, it

    x, r, p, rn, it = control.while_loop(
        lambda c: control.CGContinue(c[3], tol2, c[4], max_iters), group,
        (x0, r, r, rn, it))
    return CGResult(x=x, iters=it, rnorm=torch.sqrt(rn))


class CGTrackedResult(NamedTuple):
    x: torch.Tensor
    Qx: torch.Tensor        # Q @ x, tracked through the recurrence
    iters: torch.Tensor
    rnorm: torch.Tensor


def conjugate_gradient_tracked(
    q_fn: Callable[[torch.Tensor], torch.Tensor],
    r0: torch.Tensor,
    x0: torch.Tensor,
    Qx0: torch.Tensor,
    *,
    tol,
    max_iters: int,
    unroll: int = 1,
    compensated: bool = False,
) -> CGTrackedResult:
    """CG on the HSDE normal operator ``M = I + Q'Q`` that tracks ``Q x``.

    The caller supplies the initial residual ``r0 = rhs - M(x0)`` and
    ``Qx0 = Q @ x0``.  Each iteration computes ``Qp`` once and uses it for
    both ``M p = p - Q(Q p)`` and ``Qx += alpha * Qp``, so the final
    ``v = Q u`` costs no extra product.
    """
    dot = _dot_fn(compensated)
    rn = dot(r0, r0)
    tol2 = _tol2(tol, r0)
    it = torch.zeros((), dtype=torch.int32, device=r0.device)

    def group(c):
        x, Qx, r, p, rn, it = c
        for _ in range(unroll):
            Qp = q_fn(p)
            Ap = p - q_fn(Qp)
            alpha, x, r, p_new, rn, it = _cg_step(dot, Ap, p, x, r, rn, it,
                                                  tol2)
            Qx = Qx + alpha * Qp
            p = p_new
        return x, Qx, r, p, rn, it

    x, Qx, r, p, rn, it = control.while_loop(
        lambda c: control.CGContinue(c[4], tol2, c[5], max_iters), group,
        (x0, Qx0, r0, r0, rn, it))
    return CGTrackedResult(x=x, Qx=Qx, iters=it, rnorm=torch.sqrt(rn))


def decreasing_tolerance(call_idx, floor, dtype):
    """The decreasing-accuracy schedule ``max(0.2^sqrt(i), floor)``
    (FirstOrderSolvers.jl affinepluslinear.jl:108-112)."""
    i = call_idx.to(dtype)
    tol = torch.full_like(i, 0.2) ** torch.sqrt(i)
    if isinstance(floor, torch.Tensor):
        return torch.maximum(tol, floor.to(dtype))
    return torch.clamp_min(tol, floor)  # a Python float: no host copy
