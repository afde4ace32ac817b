"""The lane axis: independent solves or candidates stacked on a leading axis.

The JAX package gets a lane axis from ``jax.vmap``: the line search's 31
candidate steps and the batched solve's instances.  The port writes it by
hand.  A vector with lanes has shape ``(B, k)``; a per-lane scalar (a dot
product, CG's residual, a status) has shape ``(B,)``.  Without lanes the
same code sees ``(k,)`` and 0-dim tensors, and runs exactly the operations
it ran before the lane axis existed (``torch.dot``, ``torch.linalg.norm``),
so single solves keep their bits.

Lanes may nest: a batched solve's line search (or GAPP) evaluates P
candidate points per instance, ``(B, P, k)``, against instance data and
states with the lanes ``(B,)``.  The instance axes always lead;
:func:`lead` inserts the unit axes that let an instance's vector or scalar
broadcast against its candidates.
"""

from __future__ import annotations

import torch


def vdot(a, b):
    """Dot product over the last axis: ``torch.dot`` for two vectors, else
    one per lane (the operands broadcast over the leading axis)."""
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return (a * b).sum(-1)


def vnorm(v):
    """2-norm over the last axis (one per lane)."""
    if v.dim() == 1:
        return torch.linalg.norm(v)
    return torch.linalg.vector_norm(v, dim=-1)


def per_lane(t, like):
    """A per-lane scalar ``t`` (shape ``(B,)``) shaped to broadcast against
    ``like`` (shape ``(B, ...)``); a 0-dim tensor or a Python number is
    returned as it is."""
    if not isinstance(t, torch.Tensor) or t.dim() == 0:
        return t
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def select(mask, new, old):
    """``new`` where the per-lane ``mask`` holds, else ``old``."""
    return torch.where(per_lane(mask, new), new, old)


def lead(t, like, vector: bool = True):
    """``t`` with unit axes after its lane axes, so that it broadcasts
    against ``like``, a vector whose lane axes ``t``'s lanes lead: an
    instance's vector ``(B, k)`` (``vector``) or per-lane scalar ``(B,)``
    against the instance's candidates ``(B, P, k)``.  A tensor without
    lanes, or one with all of ``like``'s, is returned as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    cut = t.dim() - 1 if vector else t.dim()
    extra = like.dim() - 1 - cut
    if cut <= 0 or extra <= 0:
        return t
    return t.reshape(t.shape[:cut] + (1,) * extra + t.shape[cut:])


def matvec(A, x):
    """``A @ x`` per lane: ``A`` ``(..., r, k)``, ``x`` ``(..., k)``."""
    if x.dim() == 1:
        return torch.matmul(A, x)
    return torch.matmul(A, x[..., None])[..., 0]


def vecmat(w, X):
    """``w @ X`` per lane: ``w`` ``(..., r)``, ``X`` ``(..., r, k)``."""
    if w.dim() == 1:
        return torch.matmul(w, X)
    return torch.matmul(w[..., None, :], X)[..., 0, :]


def trace(M):
    """The trace of each lane's square matrix ``(..., k, k)``."""
    if M.dim() == 2:
        return torch.trace(M)
    return M.diagonal(0, -2, -1).sum(-1)


def lane_by_lane(pair, X1, X2):
    """``pair(u, v)`` on each lane of X1 and X2, the two outputs stacked:
    a pair product over lanes where the product takes one vector each."""
    ys, zs = zip(*(pair(u, v) for u, v in zip(X1, X2)))
    return torch.stack(ys), torch.stack(zs)


def lane_shape(x) -> tuple:
    """The lane axes of a vector: ``()`` for one vector, ``(B,)`` for B."""
    return tuple(x.shape[:-1])


def common_count(i):
    """The iteration count shared by the lanes that still run: a batched
    solve's lanes step together until they freeze, and a frozen lane's count
    stops, so the largest count is the running lanes' (a 0-dim count is
    returned as it is).  The steps that branch on the count (GAPP, the
    wrappers) branch once for the whole batch on this count, where the JAX
    package's ``vmap`` selects per instance; the two agree on every running
    lane, and a frozen lane's step is discarded by the chunk's mask (in a
    segmented solve, by the merge of the segments)."""
    return i if i.dim() == 0 else i.amax()
