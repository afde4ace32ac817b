"""Carry data and state across from the JAX package, as numpy arrays.

Tests use these helpers to make both packages compute the same thing: a
cone spec from ``(Cone.name, dim)`` pairs, a tile operator from the tables
of a JAX tile operator, and a solver state from the leaves of a JAX
``SolverState`` (run N steps in JAX, continue in the port).  Nothing here
imports jax: the caller converts with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from fos_tpu_torch.cones.spec import Cone, ConeSpec
from fos_tpu_torch.linalg.cg import CGState
from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp, BlockedEllOp
from fos_tpu_torch.solvers.base import SolverState


def cone_spec_from_blocks(blocks, params=()) -> ConeSpec:
    """``blocks``: ``(name, dim)`` pairs, ``name`` a :class:`Cone` member
    name (``"NONNEG"``) or value (``"nonneg"``)."""
    def cone(name):
        return Cone[name] if name in Cone.__members__ else Cone(name)

    return ConeSpec(tuple((cone(str(name)), int(d)) for name, d in blocks),
                    tuple(tuple(p) for p in params))


def tile_op_from_numpy(kind: str, blocks, index, m: int, n: int, device=None):
    """A port tile operator from a JAX op's tables:
    ``np.asarray(op.blocks)`` and ``np.asarray(op.cs)`` (kind "band") or
    ``np.asarray(op.cols)`` (kind "bell")."""
    if kind == "band":
        return BandedBlockOp.from_arrays(blocks, index, m, n, device=device)
    if kind == "bell":
        return BlockedEllOp.from_arrays(blocks, index, m, n, device=device)
    raise ValueError(f"kind must be 'band' or 'bell', got {kind!r}")


def _t(a, device, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a)).to(device)
    return t if dtype is None else t.to(dtype)


def solver_state_from_numpy(*, x, i, z_check, z_check_prev, s1_state,
                            device=None, aux=()) -> SolverState:
    """A port :class:`SolverState` (HSDE S1 state as a :class:`CGState`,
    stateless S2) from numpy leaves.  ``s1_state`` maps CGState field names
    to arrays; absent or None fields stay None."""
    i32 = torch.int32
    cg = CGState(
        warm=_t(s1_state["warm"], device),
        initialized=_t(s1_state["initialized"], device, torch.bool),
        call_idx=_t(s1_state["call_idx"], device, i32),
        last_iters=_t(s1_state["last_iters"], device, i32),
        floor=_t(s1_state.get("floor"), device),
        win_score=_t(s1_state.get("win_score"), device),
        total_iters=_t(s1_state.get("total_iters"), device, i32),
        v_warm=_t(s1_state.get("v_warm"), device),
    )
    return SolverState(x=_t(x, device), i=_t(i, device, i32),
                       z_check=_t(z_check, device),
                       z_check_prev=_t(z_check_prev, device),
                       s1_state=cg, s2_state=(), aux=aux)
