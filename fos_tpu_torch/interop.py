"""Carry data and state across from the JAX package, as numpy arrays.

Tests use these helpers to make both packages compute the same thing: a
cone spec from ``(Cone.name, dim)`` pairs, a dense or tile operator from
the arrays of a JAX operator, a conic form's equilibration weights and
direct-mode factor (:func:`carry_form_arrays`), and a solver state from the
leaves of a JAX ``SolverState`` (run N steps in JAX, continue in the port),
or from the whole state (:func:`solver_state_from_tree`: a JAX
``FusedResult.state`` with its recovery floor and plateau baseline; a form
with PSD, exponential or power blocks has a stateless S2, ``()``).  Nothing here imports jax:
arrays are converted with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from fos_tpu_torch.config import default_device
from fos_tpu_torch.cones.spec import Cone, ConeSpec
from fos_tpu_torch.linalg.cg import CGState
from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp
from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp, BlockedEllOp
from fos_tpu_torch.solvers.base import SolverState


def cone_spec_from_blocks(blocks, params=()) -> ConeSpec:
    """``blocks``: ``(name, dim)`` pairs, ``name`` a :class:`Cone` member
    name (``"NONNEG"``) or value (``"nonneg"``)."""
    def cone(name):
        return Cone[name] if name in Cone.__members__ else Cone(name)

    return ConeSpec(tuple((cone(str(name)), int(d)) for name, d in blocks),
                    tuple(tuple(p) for p in params))


def dense_op_from_numpy(A_pad, m: int, n: int, device=None) -> PaddedDenseOp:
    """A port :class:`PaddedDenseOp` from a JAX op's padded matrix
    ``np.asarray(op.A_pad)`` and its ``op.m``, ``op.n``: the (m, n) corner
    holds A."""
    A = np.ascontiguousarray(np.asarray(A_pad)[:m, :n])
    return PaddedDenseOp.create(torch.from_numpy(A).to(default_device(device)))


def tile_op_from_numpy(kind: str, blocks, index, m: int, n: int, device=None,
                       *, blocks_t=None, index_t=None):
    """A port tile operator from a JAX op's tables:
    ``np.asarray(op.blocks)`` and ``np.asarray(op.cs)`` (kind "band") or
    ``np.asarray(op.cols)`` (kind "bell"), and optionally its A' tables
    ``op.blocks_t`` with ``op.cs_t`` / ``op.cols_t`` (for ``rmv``)."""
    if kind == "band":
        return BandedBlockOp.from_arrays(blocks, index, m, n,
                                         blocks_t=blocks_t, cs_t=index_t,
                                         device=device)
    if kind == "bell":
        return BlockedEllOp.from_arrays(blocks, index, m, n,
                                        blocks_t=blocks_t, cols_t=index_t,
                                        device=device)
    raise ValueError(f"kind must be 'band' or 'bell', got {kind!r}")


def carry_form_arrays(form, *, dinv=None, einv=None, fac=None):
    """Give a port :class:`~fos_tpu_torch.problems.hsde.HSDEForm`, in place,
    a JAX form's equilibration weights (``np.asarray(jform.dinv)``,
    ``np.asarray(jform.einv)``) and direct-mode factor
    (``np.asarray(jform.sets.s1.fac)``), in the form's dtype and on its
    device, so that both packages iterate with the same arrays.  Returns the
    form."""
    dev, dt = form.device, form.dtype
    if dinv is not None:
        form.dinv = _t(dinv, dev, dt)
    if einv is not None:
        form.einv = _t(einv, dev, dt)
    if fac is not None:
        form.sets.s1 = form.sets.s1.replace(fac=_t(fac, dev, dt))
    return form


def _t(a, device, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _leaves(a, device):
    """numpy arrays (alone or in tuples) as tensors on ``device``."""
    if isinstance(a, (tuple, list)):
        return tuple(_leaves(v, device) for v in a)
    return _t(a, device)


def _cg_state(s, device):
    """A :class:`CGState` from a dict of CGState field names to arrays
    (absent or None fields stay None); anything else (a direct-mode set's
    ``()``, a tuple of member states) converts leaf by leaf."""
    if not isinstance(s, dict):
        return tuple(_cg_state(v, device) for v in s)
    i32 = torch.int32
    return CGState(
        warm=_t(s["warm"], device),
        initialized=_t(s["initialized"], device, torch.bool),
        call_idx=_t(s["call_idx"], device, i32),
        last_iters=_t(s["last_iters"], device, i32),
        floor=_t(s.get("floor"), device),
        win_score=_t(s.get("win_score"), device),
        total_iters=_t(s.get("total_iters"), device, i32),
        v_warm=_t(s.get("v_warm"), device),
    )


def solver_state_from_numpy(*, x, i, z_check, z_check_prev, s1_state,
                            s2_state=(), device=None, aux=()) -> SolverState:
    """A port :class:`SolverState` from numpy leaves.  A set state is a dict
    of CGState field names to arrays (``v_warm`` only for the HSDE
    projector), ``()`` for a stateless set, or a tuple of those (a
    BlockSet's members); ``aux`` is an array or a tuple of arrays (GAPA's
    a12, FISTA's (t, y, x_old), Dykstra's (p, q))."""
    return SolverState(x=_t(x, device), i=_t(i, device, torch.int32),
                       z_check=_t(z_check, device),
                       z_check_prev=_t(z_check_prev, device),
                       s1_state=_cg_state(s1_state, device),
                       s2_state=_cg_state(s2_state, device),
                       aux=_leaves(aux, device))


def _host_leaves(s):
    """A set state as :func:`solver_state_from_numpy` takes it: a CGState
    (anything with a ``warm`` field) as a dict of its fields, tuples leaf by
    leaf."""
    if hasattr(s, "_fields") and "warm" in s._fields:
        return {k: (None if v is None else np.asarray(v))
                for k, v in s._asdict().items()}
    if isinstance(s, (tuple, list)):
        return tuple(_host_leaves(v) for v in s)
    return np.asarray(s)


def solver_state_from_tree(state, device=None) -> SolverState:
    """A port :class:`SolverState` from a whole solver state of the JAX
    package (``run``'s or ``FusedResult.state``: x, i, z_check,
    z_check_prev, the sets' states and the algorithm's aux), every leaf
    read with ``np.asarray``."""
    aux = state.aux
    aux = (tuple(np.asarray(a) for a in aux) if isinstance(aux, (tuple, list))
           else np.asarray(aux))
    return solver_state_from_numpy(
        x=np.asarray(state.x), i=np.asarray(state.i),
        z_check=np.asarray(state.z_check),
        z_check_prev=np.asarray(state.z_check_prev),
        s1_state=_host_leaves(state.s1_state),
        s2_state=_host_leaves(state.s2_state), aux=aux, device=device)
