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

Both solvers take a lane axis: right-hand sides of shape ``(B, k)`` are B
independent systems (the JAX package's ``vmap`` of CG), whose ``rn``,
``alpha``, ``beta`` and counts are per lane.  Each lane stops on its own
``(rn > tol^2) & (it < max_iters)``, tested at the start of each group as a
vmapped ``lax.while_loop`` tests it: a group's result is kept only for the
lanes that were live when it began, so lane j ends where a solve of lane j
alone ends.  The loop runs while any lane is live (``cg_continue_lanes`` on
the card).

``group`` (a ``torch.distributed`` process group): the vectors are shards
of longer ones, one per rank, and every dot product is summed over the
group with one all-reduce, so each rank computes the same scalars and
takes the same steps.  Standard CG makes 1 + 2 all-reduces per iteration,
the pipelined variant 1 + 1 (in the JAX package GSPMD inserted these
collectives for sharded vectors).

On the card (CUDA tensors) standard and tracked CG run each iteration's
vector work as one launch of the hand-written step kernel C1
(:class:`fos_tpu_torch.linalg.cg_step.CGStep`), which updates the loop's
own tensors in place (``control.while_loop(in_place=True)``): the
operator's product of ``p`` is the only other work of an iteration.  An
operator given as :class:`PlusProduct` (``v + w(v)`` or ``v - w(v)``)
hands the kernel ``w(p)`` and the kernel forms ``Ap``.  A lane-axis solve
keeps its group mask inside the kernel (frozen lanes untouched), and the
eager loop reads the kernel's stopping flag instead of computing the test.
With ``group`` the step runs split at its two reductions, an all-reduce
between the launches.  ``compensated`` CG (its error-free dots) and the
pipelined variant stay on the PyTorch route below on every device;
:func:`_cg_step` and the tracked update are the plain versions the CPU
runs.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from fos_tpu_torch.linalg import cg_step, control, lanes


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
    def create(size: int, dtype, device=None, lanes=()) -> "CGState":
        """A fresh state; ``lanes`` (e.g. ``(B,)``) gives every field a
        leading lane axis (a batched solve's per-instance states)."""
        # fills on the device, no copies from the host
        lanes = tuple(lanes)
        i32 = dict(dtype=torch.int32, device=device)
        return CGState(
            warm=torch.zeros(lanes + (size,), dtype=dtype, device=device),
            initialized=torch.zeros(lanes, dtype=torch.bool, device=device),
            call_idx=torch.ones(lanes, **i32),
            last_iters=torch.zeros(lanes, **i32),
            total_iters=torch.zeros(lanes, **i32),
        )


def _dot_fn(compensated: bool, group=None):
    if compensated:
        if group is not None:
            raise ValueError("compensated CG dots take no process group")
        from fos_tpu_torch.linalg.compensated import cdot

        return cdot
    if group is None:
        return lanes.vdot
    return lambda a, b: _summed(lanes.vdot(a, b), group)


def _summed(t, group):
    """``t`` summed over the ranks of ``group``: one all-reduce."""
    dist.all_reduce(t, group=group)
    return t


def _cg_step(dot, Ap, p, x, r, rn, it, tol2):
    """The masked CG update shared by both variants; returns
    (alpha, x, r, p, rn, it), ``alpha`` per lane."""
    live = rn > tol2
    den = dot(Ap, p)
    nz = den != 0
    alpha = torch.where(live & nz, rn / torch.where(nz, den, 1.0), 0.0)
    a = lanes.per_lane(alpha, p)
    x = x + a * p
    r = r - a * Ap
    rn_new = dot(r, r)
    beta = torch.where(live, rn_new / torch.where(rn > 0, rn, 1.0), 0.0)
    p = torch.where(lanes.per_lane(live, p),
                    r + lanes.per_lane(beta, p) * p, p)
    return alpha, x, r, p, torch.where(live, rn_new, rn), it + live


class PlusProduct(NamedTuple):
    """The operator ``v + w(v)`` (``sign`` 1) or ``v - w(v)`` (``sign``
    -1) for a product ``w``: ``I + AA'`` (the feasibility S1), ``I +
    Q'Q`` (``diff``'s normal solve).  Called, it is the plain operator; on
    the card CG hands ``w(p)`` to the step kernel, which forms ``Ap``."""

    w: Callable[[torch.Tensor], torch.Tensor]
    sign: int = 1

    def __call__(self, v):
        return v + self.w(v) if self.sign > 0 else v - self.w(v)


def _on_card(t, compensated: bool) -> bool:
    """Whether CG takes the step kernel: vectors it takes (CUDA), plain
    dots."""
    return cg_step.takes(t) and not compensated


def _owned(v, like):
    """A contiguous copy of ``v`` with ``like``'s lane axes: a carried
    tensor the step kernel may update in place."""
    return v.expand(like.shape).clone(memory_format=torch.contiguous_format)


def _card_loop(step, products, carry, rn_at, it_at, tol2, max_iters, unroll):
    """CG's loop on the card: each iteration the operator's products of
    the carry (``products``) and one launch of ``step``, the carry updated
    in place; the eager loop tests the step's flag."""
    cond = (control.CGContinue if carry[rn_at].dim() == 0
            else control.CGContinueLanes)

    def body(c):
        for j in range(unroll):
            step(*map(cg_step.unit_rows, products(c)), first=j == 0)
        return c

    return control.while_loop(
        lambda c: cond(c[rn_at], tol2, c[it_at], max_iters, step.next),
        body, carry, in_place=True)


def step_plain(x, r, p, rn, it, tol2, w, mode=cg_step.AP_IS_W, Qx=None,
               Qp=None, go=None):
    """C1's plain version on C1's operands: ``Ap`` from ``p`` and the
    product ``w`` by ``mode``, :func:`_cg_step`, the tracked update of
    ``Qx`` (when given) and, with ``go`` (a lane-axis solve's group mask),
    the lanes that failed the group's test kept as they were; returns new
    ``(x, Qx, r, p, rn, it)``."""
    Ap = (w if mode == cg_step.AP_IS_W
          else p + w if mode == cg_step.P_PLUS_W else p - w)
    alpha, x1, r1, p1, rn1, it1 = _cg_step(lanes.vdot, Ap, p, x, r, rn, it,
                                           tol2)
    Qx1 = None if Qx is None else Qx + lanes.per_lane(alpha, Qp) * Qp
    new = (x1, Qx1, r1, p1, rn1, it1)
    if go is None:
        return new
    return tuple(None if a is None else lanes.select(go, a, b)
                 for a, b in zip(new, (x, Qx, r, p, rn, it)))


def _loop(group, carry, rn_at, it_at, tol2, max_iters):
    """CG's outer loop over groups: one system stops on its test; with
    lanes a group's result is kept for the lanes live at its start, and the
    loop runs while any lane is live."""
    if carry[0].dim() == 1:
        return control.while_loop(
            lambda c: control.CGContinue(c[rn_at], tol2, c[it_at], max_iters),
            group, carry)

    def lane_group(c):
        go = (c[rn_at] > tol2) & (c[it_at] < max_iters)
        return tuple(lanes.select(go, new, old)
                     for new, old in zip(group(c), c))

    return control.while_loop(
        lambda c: control.CGContinueLanes(c[rn_at], tol2, c[it_at],
                                          max_iters),
        lane_group, carry)


def _like_lanes(v, like):
    """``v`` with ``like``'s lane axes: a shared warm start copied to every
    lane of a lane-axis solve."""
    if v.shape == like.shape:
        return v
    return v.expand(like.shape).contiguous()


def _tol2(tol, like):
    """tol^2 in ``like``'s dtype on its device, made there (a fill, not a
    copy from the host, so that it can be captured); a tensor ``tol`` may
    hold one tolerance per lane, or one per instance for an instance's
    candidate lanes (``(B, 1)`` against ``(B, P)``), which is spread over
    the candidates here, once, so that the lane condition reads one
    tolerance per lane."""
    if isinstance(tol, torch.Tensor):
        tol2 = tol.to(like.dtype) ** 2
        lane = lanes.lane_shape(like)
        if tol2.dim() > 0 and tuple(tol2.shape) != lane:
            tol2 = tol2.expand(lane).contiguous()
        return tol2
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
    group=None,
) -> CGResult:
    """Solve ``matvec(x) == b`` from warm start ``x0`` to an absolute
    tolerance on ``||r||``; ``compensated`` takes the two dots of each
    iteration in float-float arithmetic; ``group`` sums the dots over the
    ranks that hold the vectors' shards (module docstring)."""
    dot = _dot_fn(compensated, group)
    r = b - matvec(x0)
    rn = dot(r, r)
    tol2 = _tol2(tol, b)
    it = torch.zeros(rn.shape, dtype=torch.int32, device=b.device)
    if _on_card(r, compensated):
        w, mode = matvec, cg_step.AP_IS_W
        if isinstance(matvec, PlusProduct):
            w = matvec.w
            mode = cg_step.P_PLUS_W if matvec.sign > 0 else cg_step.P_MINUS_W
        carry = (_owned(x0, r), _owned(r, r), _owned(r, r), rn, it)
        step = cg_step.CGStep(*carry[:3], rn, it, tol2, max_iters, mode=mode,
                              group=group)
        x, _, _, rn, it = _card_loop(step, lambda c: (w(c[2]),), carry, 3, 4,
                                     tol2, max_iters, unroll)
        return CGResult(x=x, iters=it, rnorm=torch.sqrt(rn))
    x0 = _like_lanes(x0, r)

    def group(c):
        x, r, p, rn, it = c
        for _ in range(unroll):
            Ap = matvec(p)
            _, x, r, p, rn, it = _cg_step(dot, Ap, p, x, r, rn, it, tol2)
        return x, r, p, rn, it

    x, r, p, rn, it = _loop(group, (x0, r, r, rn, it), 3, 4, tol2, max_iters)
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
    group=None,
) -> CGTrackedResult:
    """CG on the HSDE normal operator ``M = I + Q'Q`` that tracks ``Q x``.

    The caller supplies the initial residual ``r0 = rhs - M(x0)`` and
    ``Qx0 = Q @ x0``.  Each iteration computes ``Qp`` once and uses it for
    both ``M p = p - Q(Q p)`` and ``Qx += alpha * Qp``, so the final
    ``v = Q u`` costs no extra product.  ``group`` as for
    :func:`conjugate_gradient`.
    """
    dot = _dot_fn(compensated, group)
    rn = dot(r0, r0)
    tol2 = _tol2(tol, r0)
    it = torch.zeros(rn.shape, dtype=torch.int32, device=r0.device)
    if _on_card(r0, compensated):
        carry = (_owned(x0, r0), _owned(Qx0, r0), _owned(r0, r0),
                 _owned(r0, r0), rn, it)
        x, Qx, r, p = carry[:4]
        step = cg_step.CGStep(x, r, p, rn, it, tol2, max_iters, Qx=Qx,
                              mode=cg_step.P_MINUS_W, group=group)

        def products(c):
            Qp = q_fn(c[3])
            return q_fn(Qp), Qp

        x, Qx, _, _, rn, it = _card_loop(step, products, carry, 4, 5, tol2,
                                         max_iters, unroll)
        return CGTrackedResult(x=x, Qx=Qx, iters=it, rnorm=torch.sqrt(rn))

    def group(c):
        x, Qx, r, p, rn, it = c
        for _ in range(unroll):
            Qp = q_fn(p)
            Ap = p - q_fn(Qp)
            alpha, x, r, p_new, rn, it = _cg_step(dot, Ap, p, x, r, rn, it,
                                                  tol2)
            Qx = Qx + lanes.per_lane(alpha, Qp) * Qp
            p = p_new
        return x, Qx, r, p, rn, it

    x, Qx, r, p, rn, it = _loop(
        group, (_like_lanes(x0, r0), _like_lanes(Qx0, r0), r0, r0, rn, it),
        4, 5, tol2, max_iters)
    return CGTrackedResult(x=x, Qx=Qx, iters=it, rnorm=torch.sqrt(rn))


def conjugate_gradient_pipelined(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    tol,
    max_iters: int,
    group=None,
) -> CGResult:
    """Chronopoulos-Gear CG: one product and ONE reduction per iteration.

    The two dot products of standard CG become one stacked reduction of
    ``(r.r, r.Ar)`` per iteration, which halves the collectives when the
    vectors are sharded (``group``; PAPERS.md, "Communication-reduced
    Conjugate Gradient Variants").  The same iterates as standard CG in
    exact arithmetic, slightly less stable in floating point (the alpha
    recurrence).  It stops on ``(gamma > tol^2) & (it < max_iters)``; with
    lanes each lane stops on its own, as under the JAX package's ``vmap``.
    """
    def dots(r, w):
        gd = torch.stack([lanes.vdot(r, r), lanes.vdot(r, w)])
        return gd if group is None else _summed(gd, group)

    r0 = b - matvec(x0)
    x0 = _like_lanes(x0, r0)
    w0 = matvec(r0)
    gamma0, delta0 = dots(r0, w0)
    tol2 = _tol2(tol, b)
    alpha0 = torch.where(delta0 != 0, gamma0 / delta0, 0.0)
    it = torch.zeros(gamma0.shape, dtype=torch.int32, device=b.device)

    def group_step(c):
        x, r, w, p, s, gamma, alpha, beta, it = c
        p = r + lanes.per_lane(beta, p) * p
        s = w + lanes.per_lane(beta, s) * s
        x = x + lanes.per_lane(alpha, p) * p
        r = r - lanes.per_lane(alpha, s) * s
        w = matvec(r)
        gamma_new, delta_new = dots(r, w)
        beta_new = gamma_new / gamma
        denom = delta_new - beta_new * gamma_new / alpha
        alpha_new = torch.where(denom != 0, gamma_new / denom, 0.0)
        return x, r, w, p, s, gamma_new, alpha_new, beta_new, it + 1

    zero = torch.zeros_like(r0)
    carry = (x0, r0, w0, zero, zero, gamma0, alpha0,
             torch.zeros_like(gamma0), it)
    x, r, _, _, _, gamma, _, _, it = _loop(group_step, carry, 5, 8, tol2,
                                           max_iters)
    return CGResult(x=x, iters=it, rnorm=torch.sqrt(gamma))


def decreasing_tolerance(call_idx, floor, dtype):
    """The decreasing-accuracy schedule ``max(0.2^sqrt(i), floor)``
    (FirstOrderSolvers.jl affinepluslinear.jl:108-112)."""
    i = call_idx.to(dtype)
    tol = torch.full_like(i, 0.2) ** torch.sqrt(i)
    if isinstance(floor, torch.Tensor):
        return torch.maximum(tol, floor.to(dtype))
    return torch.clamp_min(tol, floor)  # a Python float: no host copy
