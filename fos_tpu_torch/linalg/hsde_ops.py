"""Matrix-free operators for the homogeneous self-dual embedding.

The HSDE matrix

    Q = [ 0    A'   c ]
        [-A    0    b ]
        [-c'  -b'   0 ]

is skew-symmetric (Q' = -Q); one application costs one ``(A x, A' z)``
pair and rank-1 ``b``/``c`` terms.  The affine projection solves the SPD
system ``(I + Q'Q) u = u0 - Q v0`` and sets ``v = Q u`` (see
:mod:`fos_tpu_torch.linalg.affine`).

``A`` is duck-typed: an operator with ``mv_pair`` (the hand-written pair
kernels: :class:`~fos_tpu_torch.linalg.dense_pair.PaddedDenseOp`,
:class:`~fos_tpu_torch.linalg.sparse_ell.BandedBlockOp`,
:class:`~fos_tpu_torch.linalg.sparse_ell.BlockedEllOp`), a torch sparse
COO tensor, or a dense tensor, whose products go to ``torch.matmul`` at
full f32 (``fos_tpu_torch.config`` turns TF32 off).
"""

from __future__ import annotations

import torch

import fos_tpu_torch.config  # noqa: F401  (pins full-f32 matmuls)


def _is_sparse(A) -> bool:
    return isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo


def mv(A, x):
    """A @ x for a dense tensor, a sparse COO tensor or an operator."""
    if hasattr(A, "mv"):
        return A.mv(x)
    if _is_sparse(A):
        return torch.mv(A, x)
    return torch.matmul(A, x)


def rmv(A, y):
    """A' @ y for a dense tensor, a sparse COO tensor or an operator."""
    if hasattr(A, "rmv"):
        return A.rmv(y)
    if _is_sparse(A):
        return torch.mv(A.t(), y)
    return torch.matmul(A.T, y)


def mv_pair(A, x1, x2):
    """(A @ x1, A' @ x2); one pass over A where the operator has a fused
    pair kernel."""
    if hasattr(A, "mv_pair"):
        return A.mv_pair(x1, x2)
    return mv(A, x1), rmv(A, x2)


def q_mul(A, b, c, z, neg_cb=None):
    """Q @ z, matrix-free: one (A x, A' z) pair plus rank-1 terms.

    ``neg_cb`` is ``-cat([c, b])``, which a caller applying Q many times
    precomputes: the last entry ``-c'z1 - b'z2`` is then one dot product.
    """
    n = c.shape[0]
    m = b.shape[0]
    z1 = z[:n]
    z2 = z[n: n + m]
    z3 = z[n + m]
    Az1, ATz2 = mv_pair(A, z1, z2)
    if neg_cb is None:
        neg_cb = -torch.cat([c, b])
    y3 = torch.dot(neg_cb, z[: n + m])
    return torch.cat([ATz2 + c * z3, b * z3 - Az1, y3[None]])


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
