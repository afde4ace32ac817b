"""Projectable-set library for the set-feasibility solve.

The port of ``fos_tpu.sets``: replacements for the ProximalOperators sets
the reference leans on (``IndAffine``, ``IndBox``, ``IndPoint``,
``IndBallL2``, ``IndHalfspace``), cone sets through
:class:`fos_tpu_torch.solvers.base.ConeSet`, products of sets and arbitrary
user projections.

Every set follows the solver's set protocol, ``init_state(dtype)`` and
``project(x, state) -> (y, state)``; stateless sets carry ``()``.  Every
projection takes leading batch dimensions (GAPP projects its 21 candidate
steps at once).  Array data (bounds, points, matrices) become tensors on
``device`` (default: the card) and keep their dtype; a projection casts
them to the dtype of ``x``.  Scalar data stay Python numbers and need no
device.
"""

from __future__ import annotations

import numpy as np
import torch

from fos_tpu_torch.config import as_tensor, default_device
from fos_tpu_torch.linalg.cg import CGState, conjugate_gradient
from fos_tpu_torch.solvers.base import ConeSet  # noqa: F401  (re-exported)


def _data(v, device):
    """A Python float for a scalar, else a tensor on ``device``."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        return v.to(default_device(device))
    if np.ndim(v) == 0:
        return float(v)
    return as_tensor(v, device=default_device(device))


def _like(v, x):
    """A scalar or tensor datum as a tensor of ``x``'s dtype and device."""
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


class _StatelessSet:
    def init_state(self, dtype):
        return ()


class AffineSet(_StatelessSet):
    """{x : Ax = b} (``IndAffine``).

    Direct mode caches ``P = A'(AA')^{-1}`` as ``Q R^{-T}`` of a host f64
    QR of A' (:func:`fos_tpu_torch.linalg.affine._ls_projection_fac`), so a
    projection is ``y = x - P(Ax - b)``; indirect mode solves
    ``(AA') mu = Ax - b`` by warm-started CG to ``m eps``.  A is dense.
    """

    projection_is_affine = True
    projection_offset_free = False

    def __init__(self, A, b, P=None, *, direct=True, cg_max_iters=1000):
        self.A = A
        self.b = b
        self.P = P
        self.direct = direct
        self.cg_max_iters = cg_max_iters

    @classmethod
    def create(cls, A, b, *, direct=True, cg_max_iters=1000, device=None):
        device = default_device(device)
        if hasattr(A, "toarray"):
            A = A.toarray()
        A = as_tensor(A, device=device)
        b = as_tensor(b, device=device)
        P = None
        if direct:
            from fos_tpu_torch.linalg.affine import _ls_projection_fac

            P = _ls_projection_fac(A.T, eye_first=None)
        return cls(A, b, P, direct=direct, cg_max_iters=cg_max_iters)

    @property
    def dtype(self):
        return self.b.dtype

    def init_state(self, dtype):
        if self.direct:
            return ()
        return CGState.create(self.b.shape[0], dtype, self.b.device)

    def project(self, x, state):
        if x.dim() > 1 and not self.direct:
            # a batch of candidates: one CG solve per row, all from the
            # same warm start, which is left as it was
            return torch.stack([self.project(xi, state)[0] for xi in x]), state
        A = self.A
        resid = (x @ A.T if x.dim() > 1 else torch.matmul(A, x)) - self.b
        if self.direct:
            return (x - resid @ self.P.T if x.dim() > 1
                    else x - torch.matmul(self.P, resid)), state
        warm = torch.where(state.initialized, state.warm,
                           torch.zeros_like(resid))
        floor = self.b.shape[0] * float(torch.finfo(x.dtype).eps)
        res = conjugate_gradient(lambda mu: torch.matmul(A, torch.matmul(A.T, mu)),
                                 resid, warm, tol=floor,
                                 max_iters=self.cg_max_iters)
        y = x - torch.matmul(A.T, res.x)
        return y, CGState(res.x, torch.ones_like(state.initialized),
                          state.call_idx + 1, res.iters)


class Box(_StatelessSet):
    """{x : lo <= x <= hi} (``IndBox``).  Scalars broadcast."""

    def __init__(self, lo, hi, *, device=None):
        self.lo = _data(lo, device)
        self.hi = _data(hi, device)

    def project(self, x, state):
        if isinstance(self.lo, float) and isinstance(self.hi, float):
            return torch.clamp(x, self.lo, self.hi), state
        return torch.minimum(torch.maximum(x, _like(self.lo, x)),
                             _like(self.hi, x)), state


def NonNeg():
    """{x : x >= 0} (``IndNonnegative``)."""
    return Box(0.0, np.inf)


def NonPos():
    return Box(-np.inf, 0.0)


class Point(_StatelessSet):
    """{p} (``IndPoint``)."""

    def __init__(self, p, *, device=None):
        self.p = _data(p, device)

    def project(self, x, state):
        return torch.broadcast_to(_like(self.p, x), x.shape), state


class Halfspace(_StatelessSet):
    """{x : <a, x> <= beta} (``IndHalfspace``); the dot and the denominator
    are full-precision products (TF32 is off, ``fos_tpu_torch.config``)."""

    def __init__(self, a, beta, *, device=None):
        self.a = as_tensor(a, device=default_device(device))
        self.beta = float(beta)

    def project(self, x, state):
        a = _like(self.a, x)
        viol = torch.clamp_min((torch.matmul(x, a) - self.beta)
                               / torch.dot(a, a), 0.0)
        return (x - viol[..., None] * a if x.dim() > 1
                else x - viol * a), state


class Ball(_StatelessSet):
    """{x : ||x - center|| <= radius} (``IndBallL2``)."""

    def __init__(self, radius, center=None, *, device=None):
        self.radius = float(radius)
        self.center = None if center is None else _data(center, device)

    def project(self, x, state):
        center = None if self.center is None else _like(self.center, x)
        d = x if center is None else x - center
        nrm = torch.linalg.vector_norm(d, dim=-1, keepdim=x.dim() > 1)
        scale = torch.where(nrm > self.radius,
                            self.radius / torch.where(nrm > 0, nrm, 1.0), 1.0)
        y = d * scale
        return (y if center is None else y + center), state


class BlockSet:
    """Product of sets over contiguous index ranges (the role of
    ProximalOperators' ``SlicedSeparableSum``):
    ``BlockSet([(set1, d1), (set2, d2), ...])`` projects ``x[..., :d1]``
    with set1, the next ``d2`` entries with set2, and so on.  Member states
    travel as a tuple."""

    def __init__(self, blocks):
        self.sets = tuple(s for s, _ in blocks)
        self.dims = tuple(int(d) for _, d in blocks)

    @property
    def dim(self):
        return sum(self.dims)

    def init_state(self, dtype):
        return tuple(s.init_state(dtype) for s in self.sets)

    def project(self, x, state):
        outs, new_state = [], []
        off = 0
        for s, d, st in zip(self.sets, self.dims, state):
            y, st2 = s.project(x[..., off:off + d], st)
            outs.append(y)
            new_state.append(st2)
            off += d
        return torch.cat(outs, dim=-1), tuple(new_state)


class FunctionSet(_StatelessSet):
    """An arbitrary projection ``fn(x) -> y``."""

    def __init__(self, fn):
        self.fn = fn

    def project(self, x, state):
        return self.fn(x), state
