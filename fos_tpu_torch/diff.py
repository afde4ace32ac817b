"""Differentiable conic solves: implicit differentiation through the DR/GAP
fixed point.  The port of ``fos_tpu.diff``.

Gradients of any scalar function of the solution ``(x, y, s)`` with respect
to the problem data ``(A, b, c)`` (the role diffcp plays for SCS):

* forward: the ordinary fused solve (:func:`~fos_tpu_torch.solvers.engine.
  fused_solve`, on the card one CUDA graph) to the fixed point ``z* =
  T(z*)`` of the one-iteration map T (two relaxed projections), on data
  cut from autograd: a graph capture must not see tensors that need grad;
* backward (``mode="vjp"``): the adjoint of the ray-normalised map S
  (below) solved by CGLS, then the data cotangents ``vjp_theta(S)(w)``;
* forward mode (``mode="jvp"``): the tangent system ``(I - dS/dz) dz =
  (dS/dtheta) dtheta`` solved the same way.

The step is re-expressed differentiably with its relaxation coefficients
frozen at their converged values (GAPA's adaptive ``a12`` read from the
final state and cut from autograd): its inner SPD solve ``(I + Q'Q) u = r``
is :class:`NormalSolve`, CG differentiated implicitly (never unrolled), and
its cone projection is differentiated through plain autograd (the PSD
blocks' eigh projection through its divided-difference rule,
:class:`~fos_tpu_torch.cones.project.PsdEighFn`).  Wrappers (LineSearch,
Anderson, Longstep) keep the inner map's fixed points, so a wrapped solve is
differentiated through the inner algorithm's map.

``J = dS/dz`` is applied through reverse mode alone: ``J' w`` is one
backward pass through a graph of S built once at ``z*``, and ``J w`` is the
backward pass of that VJP taken in its cotangent (the transpose of a linear
map), so the same code serves both modes.  Forward-mode AD cannot be used
there: the tangent solve runs inside an ``autograd.Function``'s ``jvp``,
where PyTorch refuses a nested forward-mode level.  Every custom Function
on the way (K1's :class:`~fos_tpu_torch.linalg.dense_pair.DensePairFn`,
:class:`NormalSolve`, ``PsdEighFn``) also has a ``jvp``, which the
solution recovery runs under a caller's ``torch.autograd.forward_ad``.

Dense A with ``pallas=True`` runs every ``(A x, A' z)`` pair of the forward
solve and of the derivatives through the hand-written kernel K1 (on the
card: f32, contiguous); the JAX package differentiates plain XLA products
instead.  A sparse A (a torch sparse COO tensor, or ``(values, indices,
shape)``) gets gradients on its stored values, as the JAX package's BCOO
convention.  A leading batch axis (A ``(B, m, n)``, b ``(B, m)``, c ``(B,
n)``) differentiates B independent solves at once (the JAX package's
``vmap`` of ``grad``): the forward through
:func:`~fos_tpu_torch.parallel.batched.solve_batched` (a wrapped algorithm
there too), the CG and CGLS solves with a lane axis.

The forward honours the (inner) algorithm's ``direct`` flag, as ``solve``
does: the host QR factor in place of CG for the affine projection.  The
fixed point is the same map's; in f32 it is reached more exactly than by
CG, whose projections stop at its tolerance floor.

The options keep the JAX package's names and defaults, which are f64's.
In f32 pass tolerances f32 can reach (``diff_cg_tol`` ~1e-6,
``adjoint_tol`` ~1e-6) and ``adjoint_damping=1e-8``: at 1e-10 the CGLS
recurrence drifts along the ray on f32 rounding once its tolerance is
tight (measured on the test LP of ``tests/test_torch_diff.py``).

Oracles (LP duality, the envelope theorem at a nondegenerate optimum):
``d(c'x*)/dc = x*``, ``d(c'x*)/db = -y*``, ``d(c'x*)/dA = y* x*'``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fos_tpu_torch.config import as_tensor, default_device
from fos_tpu_torch.cones.project import project as cone_project
from fos_tpu_torch.cones.spec import ConeSpec
from fos_tpu_torch.linalg import hsde_ops, lanes
from fos_tpu_torch.linalg.cg import conjugate_gradient
from fos_tpu_torch.problems.hsde import hsde_cone_spec
from fos_tpu_torch.solvers.base import GAP, GAPA, _relax

#: options of :func:`diff_solve` and their defaults (the JAX package's):
#: the forward solve's ``eps``/``max_iters``/``checki``/``cg_tol_floor``;
#: the implicit CG's relative tolerance and budget (``diff_cg_*``, also
#: the solution recovery's); the CGLS adjoint's absolute tolerance,
#: budget and Tikhonov damping; ``pallas`` (dense A through K1)
OPTIONS = {"eps": 1e-8, "max_iters": 10000, "checki": 100,
           "cg_tol_floor": None, "diff_cg_tol": 1e-10,
           "diff_cg_maxiter": 500, "adjoint_tol": 1e-10,
           "adjoint_iters": 1000, "adjoint_damping": 1e-10,
           "pallas": False}

def _unwrap(alg):
    """Innermost algorithm of a wrapper chain (wrappers carry ``.alg``)."""
    while getattr(alg, "alg", None) is not None:
        alg = alg.alg
    return alg


class _Coo:
    """A sparse A as its stored values at fixed (row, col) positions.  The
    products gather and scatter (``index_add``) the values, so autograd
    reaches them in both modes."""

    def __init__(self, values, rows, cols, shape):
        self.values, self.rows, self.cols = values, rows, cols
        self.shape = tuple(shape)

    def mv(self, x):
        out = x.new_zeros(x.shape[:-1] + (self.shape[0],))
        return out.index_add(-1, self.rows, self.values * x[..., self.cols])

    def rmv(self, y):
        out = y.new_zeros(y.shape[:-1] + (self.shape[1],))
        return out.index_add(-1, self.cols, self.values * y[..., self.rows])


class _Data:
    """How ``theta = (a, b, c)`` make the HSDE matrix Q: ``a`` is the dense
    A (``(m, n)``, or ``(B, m, n)`` for a batch) or a sparse A's stored
    values (``indices`` given).  Also the implicit CG's settings and
    counts."""

    def __init__(self, m, n, indices=None, pallas=False, cg_tol=1e-10,
                 cg_maxiter=500):
        self.m, self.n = m, n
        self.indices = indices
        self.pallas = pallas
        self.cg_tol, self.cg_maxiter = cg_tol, cg_maxiter
        self.solves = self.iters = 0
        self._ops = {}

    @property
    def l(self) -> int:
        return self.n + self.m + 1

    def op(self, a):
        """The A that :func:`hsde_ops.q_mul` takes, made once for each
        tensor ``a`` (K1 binds its matrix when the op is made; the last
        few are kept: a data tangent alternates with the data)."""
        kept = self._ops.get(id(a))
        if kept is not None and kept[0] is a:
            return kept[1]
        if self.indices is not None:
            op = _Coo(a, self.indices[0], self.indices[1], (self.m, self.n))
        elif self.pallas:
            from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp

            op = PaddedDenseOp(a)
        else:
            op = a
        if len(self._ops) >= 4:
            self._ops.clear()
        self._ops[id(a)] = (a, op)
        return op

    def matrix(self, a):
        """A for the forward solve: the dense tensor, or a sparse COO
        tensor."""
        if self.indices is None:
            return a
        return torch.sparse_coo_tensor(self.indices, a, (self.m, self.n))

    def q(self, theta, v):
        a, b, c = theta
        return hsde_ops.q_mul(self.op(a), b, c, v)

    def normal(self, theta, u):
        """(I + Q'Q) u."""
        return u - self.q(theta, self.q(theta, u))

    def dnormal(self, theta, dtheta, u):
        """The derivative of (I + Q'Q) u along ``dtheta`` (Q is linear in
        theta): ``-(dQ (Q u) + Q (dQ u))``."""
        return -(self.q(dtheta, self.q(theta, u))
                 + self.q(theta, self.q(dtheta, u)))

    def solve(self, theta, r):
        """(I + Q'Q)^-1 r by CG from zero, to ``cg_tol`` relative to
        ``||r||`` (the tolerance of ``jax.scipy.sparse.linalg.cg``), one
        system per lane; autograd never sees the iterations."""
        with torch.no_grad():
            res = conjugate_gradient(
                lambda t: self.normal(theta, t), r, torch.zeros_like(r),
                tol=self.cg_tol * lanes.vnorm(r), max_iters=self.cg_maxiter)
        self.solves += 1
        self.iters = self.iters + lanes.common_count(res.iters)
        return res.x


class NormalSolve(torch.autograd.Function):
    """``u = (I + Q'Q)^-1 r`` by CG, differentiated implicitly (the
    counterpart of ``jax.scipy.sparse.linalg.cg`` under
    ``custom_linear_solve``).  ``apply(r, known, data, a, b, c)``: ``known``
    (or None) is the solution when the caller already has it (the same r
    and theta), so the forward skips its CG.

    Reverse: ``lam = M^-1 g`` (one more CG: M is symmetric) is r's
    cotangent, and theta's is ``-vjp_theta(M_theta u)(lam)``, taken by
    autograd of the matvec.  Forward: ``du = M^-1 (dr - dM u)``.  Both go
    through this Function again, so they can be differentiated once
    more."""

    @staticmethod
    def forward(r, known, data, a, b, c):
        if known is not None:
            return known.clone()
        return data.solve((a, b, c), r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, data, a, b, c = inputs
        ctx.data = data
        ctx.save_for_backward(output, a, b, c)
        ctx.save_for_forward(output, a, b, c)

    @staticmethod
    def backward(ctx, g):
        u, *theta = ctx.saved_tensors
        create = torch.is_grad_enabled()
        lam = NormalSolve.apply(g, None, ctx.data,
                                *(t.detach() for t in theta))
        need = ctx.needs_input_grad[3:]
        grads = [None] * 3
        if any(need):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(k)
                          for t, k in zip(theta, need)]
                Mu = ctx.data.normal(leaves, u.detach())
                got = iter(torch.autograd.grad(
                    Mu, [t for t in leaves if t.requires_grad], -lam,
                    create_graph=create, allow_unused=True))
            grads = [next(got) if k else None for k in need]
        return (lam, None, None, *grads)

    @staticmethod
    def jvp(ctx, dr, _dknown, _ddata, da, db, dc):
        u, *theta = ctx.saved_tensors
        rhs = torch.zeros_like(u) if dr is None else dr
        dtheta = (da, db, dc)
        if any(d is not None for d in dtheta):
            dtheta = tuple(torch.zeros_like(t) if d is None else d
                           for t, d in zip(theta, dtheta))
            rhs = rhs - ctx.data.dnormal(theta, dtheta, u)
        return ctx.data.solve(theta, rhs)


class _Linearized:
    """The derivative ``J`` of ``S`` in z at ``z*`` (theta held fixed),
    applied by reverse mode alone: one graph of S built at ``z*`` gives
    ``J' w`` by a backward pass, and the graph of that VJP, built once with
    a placeholder cotangent ``v``, gives ``J w = d<J' v, w>/dv`` by a
    backward pass in ``v``."""

    def __init__(self, S, zstar):
        with torch.enable_grad():
            self.z = zstar.detach().requires_grad_()
            self.t = S(self.z)
            self.v = torch.zeros_like(self.t, requires_grad=True)
            (self.g,) = torch.autograd.grad(self.t, self.z, self.v,
                                            create_graph=True)

    def jt(self, w):
        return torch.autograd.grad(self.t, self.z, w, retain_graph=True)[0]

    def j(self, w):
        (jw,) = torch.autograd.grad(self.g, self.v, w, retain_graph=True,
                                    allow_unused=True)
        return torch.zeros_like(w) if jw is None else jw


class _Call:
    """One differentiable solve: the problem's structure, the algorithm and
    the options, and after the forward the frozen coefficients and the
    implicit solution of the last map (reused as ``known``)."""

    def __init__(self, K1, K2, alg, psd_method, data, opts, batched, stats):
        self.K1, self.K2, self.alg = K1, K2, alg
        self.spec = hsde_cone_spec(K1, K2)
        self.psd_method = psd_method
        self.data = data
        self.opts = opts
        self.batched = batched
        self.stats = stats
        self.coeffs = None

    def forward(self, a, b, c):
        """The fused solve to z*; freezes (alpha, a1, a2)."""
        from fos_tpu_torch.parallel.batched import (build_batched_form,
                                                    solve_batched)
        from fos_tpu_torch.problems.conic import ConicProblem
        from fos_tpu_torch.problems.hsde import HSDEForm
        from fos_tpu_torch.solvers.engine import fused_solve

        o = self.opts
        run = dict(max_iters=int(o["max_iters"]), eps=float(o["eps"]),
                   checki=int(o["checki"]))
        A = self.data.matrix(a)
        # the affine projection of the forward: CG, or the host QR factor
        # when the (inner) algorithm asks for it, as in ``solve``; the
        # derivative's map is the same either way
        direct = bool(getattr(_unwrap(self.alg), "direct", False))
        if self.batched:
            form = build_batched_form(A, b, c, self.K1, self.K2,
                                      direct=direct, device=b.device,
                                      psd_method=self.psd_method,
                                      cg_tol_floor=o["cg_tol_floor"])
            res = solve_batched(self.alg, form, **run)
        else:
            form = HSDEForm.build(
                ConicProblem(A, b, c, self.K1, self.K2), direct=direct,
                psd_method=self.psd_method, cg_tol_floor=o["cg_tol_floor"],
                compensated=False, pallas=bool(o["pallas"]))
            res = fused_solve(self.alg, form, form.initial_value(b.dtype),
                              **run)
        a1, a2 = self.alg.coeffs(res.state.aux)  # wrappers delegate
        # the converged coefficients are constants of the frozen map
        a1, a2 = (v.detach() if isinstance(v, torch.Tensor) else v
                  for v in (a1, a2))
        self.coeffs = (_unwrap(self.alg).alpha, a1, a2)
        self.stats.update(status=res.status, iters=res.iters)
        return res.state.x

    def S(self, theta, zstar, known=None):
        """The ray-normalised map ``S(z) = T(z) ||z*|| / ||T(z)||`` at data
        ``theta``, as a function of z; ``self.u`` keeps the implicit
        solution of its last evaluation.  T is positively homogeneous, so
        dT/dz has the eigenvalue 1 along the solution ray; S has the same
        fixed point and gradients with that eigenvalue deflated to 0."""
        alpha, a1, a2 = self.coeffs
        data, l = self.data, self.data.l
        nrm = lanes.vnorm(zstar)

        def S(z):
            rhs = z[..., :l] - data.q(theta, z[..., l:])
            u = NormalSolve.apply(rhs, known, data, *theta)
            self.u = u.detach()
            y1 = torch.cat([u, data.q(theta, u)], -1)
            tmp1 = _relax(a1, y1, z)
            zc = cone_project(self.spec, tmp1, self.psd_method)
            t = alpha * _relax(a2, zc, tmp1) + (1.0 - alpha) * z
            return t * lanes.per_lane(nrm / lanes.vnorm(t), t)

        return S

    def _least_squares(self, op, opT, rhs):
        """CGLS on the normal equations ``op' op w + lam w = op' rhs`` (op
        = I - J or its transpose): least squares projects out directions
        the solution map is insensitive to, and the Tikhonov damping keeps
        CG out of the ray's null space (the JAX package's measured
        failure: undamped, ||w|| ~ 1e13 on rounding noise)."""
        o = self.opts
        lam = float(o["adjoint_damping"])
        res = conjugate_gradient(
            lambda w: opT(op(w)) + lam * w, opT(rhs), torch.zeros_like(rhs),
            tol=float(o["adjoint_tol"]), max_iters=int(o["adjoint_iters"]))
        self.stats["cgls_iters"] = lanes.common_count(res.iters)
        return res.x

    def _counted(self, fn):
        self.data.solves, self.data.iters = 0, 0
        out = fn()
        self.stats.update(inner_cg_solves=self.data.solves,
                          inner_cg_iters=self.data.iters)
        return out

    def adjoint(self, theta, zstar, zbar, need):
        """The data cotangents for ``zbar`` (``need``: which of a, b, c)."""
        return self._counted(lambda: self._adjoint(theta, zstar, zbar, need))

    def _adjoint(self, theta, zstar, zbar, need):
        plain = tuple(t.detach() for t in theta)
        lin = _Linearized(self.S(plain, zstar), zstar)
        known = self.u
        # (I - J') w = zbar in the least-squares sense
        w = self._least_squares(lambda v: v - lin.jt(v),
                                lambda v: v - lin.j(v), zbar)
        # vjp_theta, once
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(k) for t, k in zip(theta, need)]
            t = self.S(leaves, zstar, known)(zstar.detach())
            want = [v for v in leaves if v.requires_grad]
            got = iter(torch.autograd.grad(t, want, w, allow_unused=True))
        return tuple(_zero_if_none(next(got), v) if k else None
                     for k, v in zip(need, leaves))

    def tangent(self, theta, zstar, dtheta):
        """dz for the data tangents ``dtheta`` (None where absent)."""
        return self._counted(lambda: self._tangent(theta, zstar, dtheta))

    def _tangent(self, theta, zstar, dtheta):
        plain = tuple(t.detach() for t in theta)
        lin = _Linearized(self.S(plain, zstar), zstar)
        known = self.u
        # rhs = (dS/dtheta) dtheta: the transpose of theta's VJP
        has = [d is not None for d in dtheta]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(k) for t, k in zip(theta, has)]
            t = self.S(leaves, zstar, known)(zstar.detach())
            v = torch.zeros_like(t, requires_grad=True)
            want = [x for x in leaves if x.requires_grad]
            g = torch.autograd.grad(t, want, v, create_graph=True,
                                    allow_unused=True)
            pairs = [(gi, d) for gi, d in zip(g, (d for d in dtheta
                                                  if d is not None))
                     if gi is not None]
            rhs = None
            if pairs:
                (rhs,) = torch.autograd.grad([gi for gi, _ in pairs], v,
                                             [d for _, d in pairs],
                                             allow_unused=True)
        rhs = torch.zeros_like(zstar) if rhs is None else rhs.detach()
        # (I - J) dz = rhs in the least-squares sense
        return self._least_squares(lambda v: v - lin.j(v),
                                   lambda v: v - lin.jt(v), rhs)


def _zero_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


class _FixedPoint(torch.autograd.Function):
    """The raw fixed point z* of the HSDE iteration, a function of (a, b,
    c); the subclasses carry the derivative rule of each mode."""

    @staticmethod
    def forward(a, b, c, call):
        return call.forward(a, b, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, c, call = inputs
        ctx.call = call
        ctx.save_for_backward(a, b, c, output)
        ctx.save_for_forward(a, b, c, output)


class _FixedPointVJP(_FixedPoint):
    """Reverse mode (the JAX package's custom VJP)."""

    @staticmethod
    def backward(ctx, zbar):
        a, b, c, zstar = ctx.saved_tensors
        return (*ctx.call.adjoint((a, b, c), zstar, zbar,
                                  ctx.needs_input_grad[:3]), None)


class _FixedPointJVP(_FixedPoint):
    """Forward mode (the JAX package's custom JVP)."""

    @staticmethod
    def jvp(ctx, da, db, dc, _):
        a, b, c, zstar = ctx.saved_tensors
        return ctx.call.tangent((a, b, c), zstar, (da, db, dc))


def _on(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return as_tensor(v, device=device)


def _problem_data(A, device):
    """(the differentiable tensor of A, its indices or None, (m, n))."""
    if isinstance(A, tuple):
        values, indices, shape = A
        return (_on(values, device), _on(indices, device).long(),
                tuple(shape))
    if isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo:
        A = A.coalesce()
        return (A.values().to(device), A.indices().to(device),
                tuple(A.shape))
    a = _on(A, device)
    return a, None, tuple(a.shape[-2:])


def diff_solve(A, b, c, K1: ConeSpec, K2: ConeSpec, alg=None,
               psd_method: str = "eigh", mode: str = "vjp", *, device=None,
               stats: dict = None, **opts) -> Tuple[torch.Tensor, ...]:
    """Differentiable solve: ``(x, y, s)`` as functions of ``(A, b, c)``.

    ``mode="vjp"`` (default) supports ``torch.autograd.grad`` /
    ``.backward()``; ``mode="jvp"`` supports ``torch.autograd.
    forward_ad`` (parameter sensitivities: many outputs, few inputs).  A
    may be dense (a tensor or an array), a torch sparse COO tensor or
    ``(values, indices, shape)`` (gradients on the stored values), or
    carry a leading batch axis with b and c (dense only).  The algorithm
    may be GAP-family (GAP/DR/AP) or GAPA, plain or wrapped (LineSearch/
    Longstep/Anderson, in a batch too).  ``device``: where the solve runs,
    the card unless given (``device="cpu"`` for the CPU); tensors move
    there (differentiably).  ``opts``: see :data:`OPTIONS` (and the
    module's note on f32).  The solve must reach its fixed point:
    gradients of an unconverged iterate are not meaningful, and near one
    the adjoint solve is ill-conditioned.

    ``stats`` (a dict the caller owns) receives the counts, as tensors on
    the solve's device (the slowest lane's with a batch axis): the
    forward's ``status`` and ``iters``, and after a derivative solve its
    ``cgls_iters`` and the implicit CG's ``inner_cg_solves`` and
    ``inner_cg_iters``.
    """
    alg = alg if alg is not None else GAP(0.5, 2.0, 2.0)  # DR
    if not isinstance(_unwrap(alg), (GAP, GAPA)):
        raise ValueError(
            "diff_solve supports GAP/DR/AP and GAPA (optionally under "
            "LineSearch/Longstep/Anderson wrappers); got "
            f"{type(_unwrap(alg)).__name__}")
    if mode not in ("vjp", "jvp"):
        raise ValueError(f"mode must be 'vjp' or 'jvp', got {mode!r}")
    unknown = sorted(set(opts) - set(OPTIONS))
    if unknown:
        raise TypeError(f"diff_solve: unknown options {unknown}")
    o = {**OPTIONS, **opts}
    dev = default_device(device)
    a, indices, (m, n) = _problem_data(A, dev)
    b, c = _on(b, dev), _on(c, dev)
    batched = b.dim() == 2
    if batched and (indices is not None or o["pallas"]):
        raise ValueError("a batched diff_solve takes a dense (B, m, n) A "
                         "without pallas")
    data = _Data(m, n, indices, bool(o["pallas"]), float(o["diff_cg_tol"]),
                 int(o["diff_cg_maxiter"]))
    call = _Call(K1, K2, alg, psd_method, data, o, batched,
                 {} if stats is None else stats)
    fp = _FixedPointVJP if mode == "vjp" else _FixedPointJVP
    zstar = fp.apply(a, b, c, call)
    # solution recovery (differentiable): one more projection pass, / tau
    theta, l = (a, b, c), data.l
    u = NormalSolve.apply(zstar[..., :l] - data.q(theta, zstar[..., l:]),
                          None, data, *theta)
    guess = cone_project(call.spec, torch.cat([u, data.q(theta, u)], -1),
                         psd_method)
    tau = guess[..., l - 1: l]
    return (guess[..., :n] / tau, guess[..., n: l - 1] / tau,
            guess[..., l + n: 2 * l - 1] / tau)
