"""Solver-state checkpoint and resume.

The whole solver state (the iterate, the CG warm start and call counter,
the algorithm's carry such as GAPA's a12, FISTA's momentum or Dykstra's
corrections, the iteration counter) is one tree of NamedTuples, tuples and
tensors, so resuming after a preemption is: save the tree's leaves to an
``.npz``, then rebuild them against a template state of the same (problem,
algorithm), e.g. ``init_solver_state(alg, form.sets, x0)``.

The file format is the JAX package's (``fos_tpu.utils.checkpoint``): one
array per leaf under the keys ``leaf_0``, ``leaf_1``, ..., in the order of
``jax.tree_util.tree_leaves``: the fields of each NamedTuple in their
order, tuples and lists in theirs, ``None`` holding no leaf.  The port's
``SolverState`` and ``CGState`` have the JAX package's fields in the same
order, so a checkpoint either package writes loads into the other's
template of the same (problem, algorithm).
"""

from __future__ import annotations

import numpy as np
import torch


def _is_node(t) -> bool:
    return isinstance(t, (tuple, list))


def _leaves(tree):
    """The leaves of ``tree`` in the JAX package's order (None holds none)."""
    if tree is None:
        return []
    if _is_node(tree):
        return [leaf for child in tree for leaf in _leaves(child)]
    return [tree]


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in order."""
    if template is None:
        return None
    if _is_node(template):
        children = [_rebuild(child, leaves) for child in template]
        if hasattr(template, "_fields"):      # a NamedTuple
            return type(template)(*children)
        return type(template)(children)
    return next(leaves)


def save_state(path: str, state) -> None:
    """Write every leaf (a tensor) of ``state`` to ``path`` (an ``.npz``)."""
    np.savez(path, **{f"leaf_{i}": leaf.detach().cpu().numpy()
                      for i, leaf in enumerate(_leaves(state))})


def load_state(path: str, template):
    """Rebuild a state from ``path`` with ``template``'s structure, each
    leaf on its template leaf's device and in its dtype.

    ``template`` must come from the same problem and algorithm (e.g.
    ``init_solver_state(alg, form.sets, x0)``); a leaf count or a leaf
    shape that differs raises ``ValueError``.
    """
    with np.load(path) as data:
        leaves_t = _leaves(template)
        if len(data.files) != len(leaves_t):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, template has "
                f"{len(leaves_t)}")
        leaves = []
        for i, t in enumerate(leaves_t):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(t.shape):
                raise ValueError(
                    f"leaf {i} shape {arr.shape} != template {tuple(t.shape)}")
            leaves.append(torch.from_numpy(np.array(arr)).to(
                device=t.device, dtype=t.dtype))
    return _rebuild(template, iter(leaves))
