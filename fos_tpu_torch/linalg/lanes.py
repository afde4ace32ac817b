"""The lane axis: independent solves or candidates stacked on a leading axis.

The JAX package gets a lane axis from ``jax.vmap``: the line search's 31
candidate steps and the batched solve's instances.  The port writes it by
hand.  A vector with lanes has shape ``(B, k)``; a per-lane scalar (a dot
product, CG's residual, a status) has shape ``(B,)``.  Without lanes the
same code sees ``(k,)`` and 0-dim tensors, and runs exactly the operations
it ran before the lane axis existed (``torch.dot``, ``torch.linalg.norm``),
so single solves keep their bits.
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
    returned as it is)."""
    return i if i.dim() == 0 else i.amax()
