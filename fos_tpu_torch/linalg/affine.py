"""Affine-subspace projectors (the S1 sets of the solvers).

* :class:`HSDEAffineProjector`, the conic solve's S1: projection onto
  ``{(u, v) : Q u = v}`` by warm-started CG on the SPD system
  ``(I + Q'Q) u = u0 - Q v0`` with the decreasing-accuracy tolerance of
  FirstOrderSolvers.jl (affinepluslinear.jl:83-126, HSDEAffine.jl:105-126),
  tracking ``v = Q u`` through the CG recurrence; or, in direct mode, by
  one GEMV with a cached factor of ``QR([I; Q])`` computed once on the
  host in f64 (FirstOrderSolvers.jl's ``IndAffine([Q -I])``, HSDE.jl:15).
* :class:`AffinePlusLinearProjector`, an S1 set of the set-feasibility
  solve: the prox of ``q'x + ind(Ax - beta z = b)``, by CG on ``I + AA'``
  (indirect) or by a cached host QR (direct, :func:`_ls_projection_fac`).

Both project a lane axis (:mod:`fos_tpu_torch.linalg.lanes`): points
``(B, dim)`` against one state (the line search's candidate steps, which
share the step's warm start) or against a state with the same lane axis
(a batched solve); CG then runs per lane.  The HSDE projector also takes
each instance's candidates, ``(B, P, dim)`` against a state with the lanes
``(B,)`` (a batched line search): the candidates share their instance's
warm start, and the state returned has the lanes ``(B, P)``.
"""

from __future__ import annotations

import numpy as np
import torch

from fos_tpu_torch.config import as_dtype, as_tensor, default_device, eps_of
from fos_tpu_torch.linalg import hsde_ops, lanes
from fos_tpu_torch.linalg.cg import (CGState, PlusProduct,
                                     conjugate_gradient,
                                     conjugate_gradient_pipelined,
                                     conjugate_gradient_tracked,
                                     decreasing_tolerance)


def _ls_projection_fac(Mtop, *, eye_first, dtype=None, device=None):
    """Cached least-squares map ``P = Q_f R^{-T}`` of ``QR([I; Mtop])``
    (``eye_first=True``), ``QR([Mtop; I])`` (``eye_first=False``), or
    ``QR(Mtop)`` with no identity stack (``eye_first=None``); ``Mtop`` may
    carry a leading batch axis.

    The reference pays one host QR at load time (HSDE.jl:15 via
    ProximalOperators' ``IndAffine``); so does this: scipy's QR in f64 on
    the host (representation error only), cast once to ``dtype`` (default:
    ``Mtop``'s) and moved to ``device`` (default: ``Mtop``'s, the CPU for
    numpy).  QR touches cond(M) once where a Cholesky of the normal matrix
    would square it.  P is dense, (rows + k, k): direct mode is for problems
    whose dense factor fits; a 32768x32768 sparse A runs indirect.
    """
    import scipy.linalg

    if isinstance(Mtop, torch.Tensor):
        dtype = dtype or Mtop.dtype
        device = device or Mtop.device
        Mh = Mtop.detach().cpu().numpy().astype(np.float64)
    else:
        Mh = np.asarray(Mtop, dtype=None)
        dtype = dtype or as_dtype(Mh.dtype)
        Mh = Mh.astype(np.float64)
    batched = Mh.ndim == 3
    if not batched:
        Mh = Mh[None]
    k = Mh.shape[-1]
    eye = np.eye(k)
    out = np.empty((Mh.shape[0], Mh.shape[1] + (0 if eye_first is None else k),
                    k))
    for i in range(Mh.shape[0]):
        if eye_first is None:
            M = Mh[i]
        else:
            M = np.zeros((Mh.shape[1] + k, k))
            sl = slice(0, k) if eye_first else slice(Mh.shape[1], None)
            np.fill_diagonal(M[sl], 1.0)
            M[slice(k, None) if eye_first else slice(0, Mh.shape[1])] = Mh[i]
        Qf, R = scipy.linalg.qr(M, mode="economic", check_finite=False,
                                overwrite_a=eye_first is not None)
        out[i] = Qf @ scipy.linalg.solve_triangular(R.T, eye, lower=True,
                                                    check_finite=False)
    if not batched:
        out = out[0]
    return torch.from_numpy(out).to(dtype=dtype, device=device)


def _host_q_dense_f64(A, b, c):
    """Q materialised on the host in f64 (as :func:`hsde_ops.q_dense`), from
    a dense tensor, a torch sparse COO tensor, or an operator with
    ``todense`` (:class:`PaddedDenseOp`, the tile operators)."""
    if hasattr(A, "todense"):
        A = A.todense()
    if isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo:
        A = A.to_dense()

    def host(t):
        return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t)).astype(np.float64)

    Ah, bh, ch = host(A), host(b), host(c)
    m, n = Ah.shape
    l = m + n + 1
    Q = np.zeros((l, l))
    Q[:n, n:n + m] = Ah.T
    Q[:n, -1] = ch
    Q[n:n + m, :n] = -Ah
    Q[n:n + m, -1] = bh
    Q[-1, :n] = -ch
    Q[-1, n:n + m] = -bh
    return Q


def _default_floor(size: int, dtype) -> float:
    """CG absolute-tolerance floor: FirstOrderSolvers.jl's ``size*eps``
    (affinepluslinear.jl:108).  Loose at f32 and large size; the engine's
    stall recovery tightens it per problem (HSDEForm.tighten_cg)."""
    return size * eps_of(dtype)


class HSDEAffineProjector:
    """Projection onto ``{(u, v) : Q u = v}`` for the HSDE operator Q.

    Indirect (default): warm-started CG on ``(I + Q'Q) u = u0 - Q v0``.
    Direct (``fac`` given): ``u = P' z`` with ``P = Q_f R^{-T}`` of
    ``QR([I; Q])``, (2l, l), then ``v = Q u``; the CG state is carried with
    ``last_iters = 0``.  ``A``, ``b``, ``c`` (and ``fac``) may carry a
    leading instance axis (:mod:`fos_tpu_torch.parallel.batched`).
    """

    #: the projection map is linear in z (the line search's probe cache):
    #: the HSDE set {(u, v): Qu = v} is a subspace
    projection_is_affine = True
    projection_offset_free = True

    def __init__(self, A, b, c, fac=None, *, decreasing_accuracy=True,
                 cg_max_iters=1000, tol_floor=None, cg_unroll=2,
                 compensated=False, cg_variant="standard"):
        if cg_variant not in ("standard", "pipelined"):
            raise ValueError(f"cg_variant must be 'standard' or 'pipelined', "
                             f"got {cg_variant!r}")
        self.A = A
        self.b = b
        self.c = c
        self.fac = fac
        self.direct = fac is not None
        self.decreasing_accuracy = decreasing_accuracy
        self.cg_max_iters = cg_max_iters
        self.tol_floor = tol_floor
        self.cg_unroll = cg_unroll
        self.compensated = compensated
        self.cg_variant = cg_variant
        self._neg_cb = -torch.cat([c, b], -1)

    @classmethod
    def create(cls, A, b, c, *, direct=False, decreasing_accuracy=True,
               cg_max_iters=1000, tol_floor=None, cg_variant="standard",
               cg_unroll=2, compensated=False):
        fac = None
        if direct:
            # u = argmin ||[I; Q] u - z||^2: QR of [I; Q] touches cond(Q)
            # once (a Cholesky of I + Q'Q would square it); Q is built and
            # factored on the host in f64, then cast once
            fac = _ls_projection_fac(_host_q_dense_f64(A, b, c),
                                     eye_first=True, dtype=b.dtype,
                                     device=b.device)
        return cls(A, b, c, fac, decreasing_accuracy=decreasing_accuracy,
                   cg_max_iters=cg_max_iters, tol_floor=tol_floor,
                   cg_unroll=cg_unroll, compensated=compensated,
                   cg_variant=cg_variant)

    def replace(self, **changes) -> "HSDEAffineProjector":
        """A copy with some fields changed (every field is carried)."""
        kw = dict(A=self.A, b=self.b, c=self.c, fac=self.fac, decreasing_accuracy=self.decreasing_accuracy,
                  cg_max_iters=self.cg_max_iters, tol_floor=self.tol_floor,
                  cg_unroll=self.cg_unroll, compensated=self.compensated,
                  cg_variant=self.cg_variant)
        kw.update(changes)
        return HSDEAffineProjector(**kw)

    @property
    def l(self) -> int:
        return self.b.shape[-1] + self.c.shape[-1] + 1

    @property
    def dim(self) -> int:
        return 2 * self.l

    def _q(self, u):
        return hsde_ops.q_mul(self.A, self.b, self.c, u, self._neg_cb)

    def init_state(self, dtype) -> CGState:
        return CGState.create(self.l, dtype, self.b.device,
                              self.b.shape[:-1])

    def init_state_from(self, z0) -> CGState:
        """Warm start seeded from the initial iterate: ``warm = u0`` and
        ``v_warm = Q u0``, one pair paid once so that every projection
        forms its CG residual with a single pair.  Direct mode and the
        pipelined variant read no ``v_warm`` and keep the plain state.  The
        state takes ``z0``'s lanes."""
        state = CGState.create(self.l, z0.dtype, z0.device,
                               lanes.lane_shape(z0))
        if self.direct or self.cg_variant == "pipelined":
            return state
        u0 = z0[..., : self.l]
        return state._replace(warm=u0, v_warm=self._q(u0),
                              initialized=torch.ones_like(state.initialized))

    def _fac_t(self, z):
        """P' z (direct mode), per lane."""
        if z.dim() == 1:
            return torch.matmul(self.fac.T, z)
        if self.fac.dim() == 3:
            return torch.bmm(z[:, None, :], self.fac)[:, 0]
        return torch.matmul(z, self.fac)

    def refresh_state(self, cg: CGState) -> CGState:
        """Re-anchor the tracked invariant ``v_warm = Q warm`` with one fresh
        pair.  The ``Qx += alpha * Qp`` track random-walks by rounding across
        outer iterations, which at tight eps in f32 displaces the DR fixed
        point enough to stall; the engine calls this once per check chunk."""
        if cg.v_warm is None:
            return cg
        return cg._replace(v_warm=self._q(cg.warm))

    def project(self, z, cg: CGState):
        cg = _lead_state(cg, z)
        if self.direct:
            # one full-f32 GEMV (TF32 is off, fos_tpu_torch.config)
            u = self._fac_t(z)
            new_cg = cg._replace(call_idx=cg.call_idx + 1,
                                 last_iters=torch.zeros_like(cg.last_iters))
            return torch.cat([u, self._q(u)], -1), new_cg
        if self.cg_variant == "pipelined":
            return self._project_pipelined(z, cg)
        if cg.v_warm is None:
            raise ValueError(
                "CGState without v_warm: seed it with init_state_from")
        l = self.l
        u0 = z[..., :l]
        v0 = z[..., l:]
        tol = self._tol(cg, z)
        # one pair for the initial residual, by skew-symmetry:
        #   r0 = u0 - Q v0 - warm - Q'(Q warm) = u0 - Q(v0 - v_warm) - warm
        warm = cg.warm
        r0 = u0 - self._q(v0 - cg.v_warm) - warm
        res = conjugate_gradient_tracked(
            self._q, r0, warm, cg.v_warm, tol=tol, max_iters=self.cg_max_iters,
            unroll=self.cg_unroll, compensated=self.compensated)
        total = None if cg.total_iters is None else cg.total_iters + res.iters
        new_cg = cg._replace(warm=res.x, v_warm=res.Qx,
                             initialized=torch.ones_like(cg.initialized),
                             call_idx=cg.call_idx + 1, last_iters=res.iters,
                             total_iters=total)
        return torch.cat([res.x, res.Qx], -1), new_cg

    def _tol(self, cg: CGState, z):
        """This projection's CG tolerance: the state's floor, else the
        projector's, else ``2l eps``, loosened by the decreasing-accuracy
        schedule."""
        if cg.floor is not None:
            floor = cg.floor
        elif self.tol_floor is not None:
            floor = self.tol_floor
        else:
            floor = _default_floor(2 * self.l, z.dtype)  # KKT size = 2l
        if self.decreasing_accuracy:
            return decreasing_tolerance(cg.call_idx, floor, z.dtype)
        return (floor.to(z.dtype) if isinstance(floor, torch.Tensor)
                else torch.full((), floor, dtype=z.dtype, device=z.device))

    def _project_pipelined(self, z, cg: CGState):
        """Chronopoulos-Gear CG on ``(I + Q'Q) u = u0 - Q v0`` from the
        previous solution (``u0`` on the first call), then ``v = Q u``: the
        JAX package's pipelined path, which tracks no ``Q u``."""
        l = self.l
        u0 = z[..., :l]
        rhs = u0 - self._q(z[..., l:])
        warm = lanes.select(cg.initialized, cg.warm, u0)
        res = conjugate_gradient_pipelined(
            lambda u: hsde_ops.hsde_normal_mul(self.A, self.b, self.c, u),
            rhs, warm, tol=self._tol(cg, z), max_iters=self.cg_max_iters)
        total = None if cg.total_iters is None else cg.total_iters + res.iters
        new_cg = cg._replace(warm=res.x,
                             initialized=torch.ones_like(cg.initialized),
                             call_idx=cg.call_idx + 1, last_iters=res.iters,
                             total_iters=total)
        return torch.cat([res.x, self._q(res.x)], -1), new_cg


def _lead_state(cg: CGState, z) -> CGState:
    """``cg`` broadcast against points with more lane axes than it has:
    an instance's state against its candidates (:func:`lanes.lead`)."""
    return CGState(*(lanes.lead(v, z, vector=k in ("warm", "v_warm"))
                     for k, v in cg._asdict().items()))


def _matrix(A, device):
    """A as the projector keeps it: an operator (``mv``/``rmv``) as it is,
    array data as a tensor on ``device``."""
    if hasattr(A, "mv") and hasattr(A, "rmv"):
        return A
    return as_tensor(A, device=device)


def _dense(A):
    if hasattr(A, "todense"):
        A = A.todense()
    if isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo:
        A = A.to_dense()
    return A


class AffinePlusLinearProjector:
    """Prox of ``f([x; z]) = q'x + ind(Ax - beta*z = b)`` with ``beta = ±1``
    (affinepluslinear.jl:58-126).

    Solved through the m x m SPD system ``(I + AA') lam = A(x1 - q) -
    beta*x2 - b``, then ``y1 = x1 - q - A'lam`` and ``y2 = x2 + beta*lam``.
    Indirect mode runs warm-started CG on ``I + AA'`` (:func:`hsde_ops.
    kkt_normal_mul`: one ``rmv`` and one ``mv`` per iteration, the tile
    kernels K4/K5 on a tile operator built with ``transpose_table=True``),
    to the absolute tolerance ``(m + n) eps`` (``decreasing_accuracy``
    starts looser).  Direct mode applies a cached ``P`` of ``QR([A'; I])``.
    """

    #: the projection map is affine (offset from b and q)
    projection_is_affine = True
    projection_offset_free = False

    #: CG iterations per host check of the stopping test; masked steps past
    #: convergence change nothing, so iterates and counts are unroll=1's
    CG_UNROLL = 2

    def __init__(self, A, b, q, beta: int, fac=None, *, direct=False,
                 decreasing_accuracy=False, cg_max_iters=1000):
        if beta not in (1, -1):
            raise ValueError(f"beta must be 1 or -1, got {beta}")
        self.A = A
        self.b = b
        self.q = q
        self.beta = beta
        self.fac = fac  # (n+m, m) P = Q_f R^{-T} of QR([A'; I]) (direct mode)
        self.direct = direct
        self.decreasing_accuracy = decreasing_accuracy
        self.cg_max_iters = cg_max_iters

    @classmethod
    def create(cls, A, b, q, beta, *, direct=False, decreasing_accuracy=False,
               cg_max_iters=1000, device=None):
        """``A``: an operator (a tile operator; it must live on ``device``)
        or array data (a dense or torch sparse COO tensor, a numpy array);
        ``b`` (m,); ``q`` (n,) or a scalar, broadcast to (n,).  The data keep their dtype and move to
        ``device`` (default: the card).  ``direct`` factors ``[A'; I]`` on
        the host (dense A only in practice)."""
        device = default_device(device)
        A = _matrix(A, device)
        b = as_tensor(b, device=device)
        n = A.shape[1]
        q = (torch.full((n,), float(q), dtype=b.dtype, device=device)
             if np.ndim(q) == 0 else as_tensor(q, b.dtype, device))
        fac = None
        if direct:
            # lam = argmin ||[A'; I] lam - [x1-q; -(beta x2 + b)]||^2
            fac = _ls_projection_fac(_dense(A).T, eye_first=False,
                                     dtype=b.dtype, device=device)
        return cls(A, b, q, beta, fac, direct=direct,
                   decreasing_accuracy=decreasing_accuracy,
                   cg_max_iters=cg_max_iters)

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def dim(self) -> int:
        return self.m + self.n

    @property
    def dtype(self):
        return self.b.dtype

    def init_cg_state(self, dtype) -> CGState:
        return CGState.create(self.m, dtype, self.b.device)

    init_state = init_cg_state  # set protocol

    def project(self, x, cg: CGState):
        n = self.n
        x1 = x[..., :n]
        x2 = x[..., n:]
        if self.direct:
            zls = torch.cat([x1 - self.q, -(self.beta * x2 + self.b)], -1)
            lam = (torch.matmul(self.fac.T, zls) if zls.dim() == 1
                   else torch.matmul(zls, self.fac))
            new_cg = cg._replace(call_idx=cg.call_idx + 1,
                                 last_iters=torch.zeros_like(cg.last_iters))
        else:
            rhs = hsde_ops.mv(self.A, x1 - self.q) - self.beta * x2 - self.b
            warm = torch.where(cg.initialized, cg.warm, torch.zeros_like(rhs))
            floor = (self.m + self.n) * eps_of(x.dtype)
            if self.decreasing_accuracy:
                tol = decreasing_tolerance(cg.call_idx, floor, x.dtype)
            else:
                tol = floor
            # I + AA' (hsde_ops.kkt_normal_mul), its product A(A'lam)
            # handed to CG's step kernel on the card
            res = conjugate_gradient(
                PlusProduct(lambda lam: hsde_ops.mv(
                    self.A, hsde_ops.rmv(self.A, lam))), rhs, warm,
                tol=tol, max_iters=self.cg_max_iters, unroll=self.CG_UNROLL)
            lam = res.x
            total = (None if cg.total_iters is None
                     else cg.total_iters + res.iters)
            new_cg = cg._replace(warm=lam,
                                 initialized=torch.ones_like(cg.initialized),
                                 call_idx=cg.call_idx + 1,
                                 last_iters=res.iters, total_iters=total)
        y1 = x1 - self.q - hsde_ops.rmv(self.A, lam)
        y2 = x2 + self.beta * lam
        return torch.cat([y1, y2], -1), new_cg
