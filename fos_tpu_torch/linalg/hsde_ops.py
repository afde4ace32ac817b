"""Matrix-free operators for the homogeneous self-dual embedding.

The HSDE matrix

    Q = [ 0    A'   c ]
        [-A    0    b ]
        [-c'  -b'   0 ]

is skew-symmetric (Q' = -Q); one application costs one ``(A x, A' z)``
pair and rank-1 ``b``/``c`` terms.  The affine projection solves the SPD
system ``(I + Q'Q) u = u0 - Q v0`` and sets ``v = Q u`` (see
:mod:`fos_tpu_torch.linalg.affine`).

The set-feasibility solve's affine projection applies ``I + AA'``
instead (:func:`kkt_normal_mul`), through single products.

``A`` is duck-typed: an operator with ``mv_pair`` (the hand-written pair
kernels: :class:`~fos_tpu_torch.linalg.dense_pair.PaddedDenseOp`,
:class:`~fos_tpu_torch.linalg.sparse_ell.BandedBlockOp`,
:class:`~fos_tpu_torch.linalg.sparse_ell.BlockedEllOp`), a torch sparse
COO tensor, or a dense tensor, whose products go to ``torch.matmul`` at
full f32 (``fos_tpu_torch.config`` turns TF32 off).

Every product takes a lane axis (:mod:`fos_tpu_torch.linalg.lanes`):
vectors ``(B, k)`` against one A are B products: one call of an
operator whose pair takes lanes (``pair_lanes``: K1's lane kernel, one
pass over A for every lane, as the JAX package's ``vmap`` over a
``pallas_call`` is one call with a lane axis in its grid), an operator's
hand kernel once per lane otherwise (K2-K5), or one ``torch.matmul`` for
a tensor; a batched A ``(B, m, n)`` (a batched solve's instances) takes
``torch.bmm``, or one ``torch.matmul`` when its instances share one
matrix through a stride-0 batch axis (``expand``).  Each instance's
candidate points ``(B, P, k)`` (a batched line search's probes) take one
``torch.matmul`` against the stacked A, or one over all ``B P`` rows for
a shared A; ``b`` and ``c`` broadcast against them
(:func:`~fos_tpu_torch.linalg.lanes.lead`).
"""

from __future__ import annotations

import torch

import fos_tpu_torch.config  # noqa: F401  (pins full-f32 matmuls)
from fos_tpu_torch.linalg import lanes


def _is_sparse(A) -> bool:
    return isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo


def _per_lane(fn, *xs):
    """An operator's single-vector product applied lane by lane."""
    return torch.stack([fn(*v) for v in zip(*xs)])


def _lanes_mv(A, x, transpose):
    """A @ x (or A' @ x) for vectors with a lane axis."""
    if not isinstance(A, torch.Tensor):   # an operator
        return _per_lane(A.rmv if transpose else A.mv, x)
    if _is_sparse(A):
        At = A.t() if transpose else A
        return torch.sparse.mm(At, x.T).T
    if A.dim() == 3:   # one matrix per instance
        if A.stride(0) == 0:   # one matrix shared by every instance
            A0 = A[0]
            return torch.matmul(x, A0 if transpose else A0.T)
        if x.dim() > 2:   # each instance's candidates (B, P, k)
            return torch.matmul(x, A if transpose else A.transpose(1, 2))
        At = A.transpose(1, 2) if transpose else A
        return torch.bmm(At, x[..., None])[..., 0]
    return torch.matmul(x, A if transpose else A.T)


def mv(A, x):
    """A @ x for a dense tensor, a sparse COO tensor or an operator."""
    if x.dim() > 1:
        return _lanes_mv(A, x, False)
    if hasattr(A, "mv"):
        return A.mv(x)
    if _is_sparse(A):
        return torch.mv(A, x)
    return torch.matmul(A, x)


def rmv(A, y):
    """A' @ y for a dense tensor, a sparse COO tensor or an operator."""
    if y.dim() > 1:
        return _lanes_mv(A, y, True)
    if hasattr(A, "rmv"):
        return A.rmv(y)
    if _is_sparse(A):
        return torch.mv(A.t(), y)
    return torch.matmul(A.T, y)


def mv_pair(A, x1, x2):
    """(A @ x1, A' @ x2); one pass over A where the operator has a fused
    pair kernel (once per lane, unless its pair takes the lanes)."""
    if hasattr(A, "mv_pair"):
        if x1.dim() > 1 and not getattr(A, "pair_lanes", False):
            return lanes.lane_by_lane(A.mv_pair, x1, x2)
        return A.mv_pair(x1, x2)
    return mv(A, x1), rmv(A, x2)


def q_mul(A, b, c, z, neg_cb=None):
    """Q @ z, matrix-free: one (A x, A' z) pair plus rank-1 terms; ``z``
    may carry a lane axis, and ``A``, ``b``, ``c`` too (a batched form).

    ``neg_cb`` is ``-cat([c, b])``, which a caller applying Q many times
    precomputes: the last entry ``-c'z1 - b'z2`` is then one dot product.
    """
    n = c.shape[-1]
    m = b.shape[-1]
    z1 = z[..., :n]
    z2 = z[..., n: n + m]
    z3 = lanes.per_lane(z[..., n + m], z1)
    Az1, ATz2 = mv_pair(A, z1, z2)
    if neg_cb is None:
        neg_cb = -torch.cat([c, b], -1)
    b, c, neg_cb = (lanes.lead(v, z) for v in (b, c, neg_cb))
    y3 = lanes.vdot(neg_cb, z[..., : n + m])
    return torch.cat([ATz2 + c * z3, b * z3 - Az1, y3[..., None]], -1)


def q_dense(A, b, c):
    """Materialise Q (test oracles)."""
    if hasattr(A, "todense"):
        A = A.todense()
    elif _is_sparse(A):
        A = A.to_dense()
    n = c.shape[0]
    m = b.shape[0]
    zeros = lambda r, k: A.new_zeros((r, k))  # noqa: E731
    top = torch.cat([zeros(n, n), A.T, c[:, None]], dim=1)
    mid = torch.cat([-A, zeros(m, m), b[:, None]], dim=1)
    bot = torch.cat([-c[None, :], -b[None, :], zeros(1, 1)], dim=1)
    return torch.cat([top, mid, bot], dim=0)


def hsde_normal_mul(A, b, c, u):
    """(I + Q'Q) u = u - Q(Q u), using the skew-symmetry of Q."""
    return u - q_mul(A, b, c, q_mul(A, b, c, u))


def kkt_normal_mul(A, lam):
    """(I + A A') lam: the SPD reduction of the ``[I A'; A -I]`` KKT
    operator (affinepluslinear.jl:4-52), as ``mv(A, rmv(A, lam))`` -- on a
    tile operator the single-product kernels K4/K5, not the pair."""
    return lam + mv(A, rmv(A, lam))
