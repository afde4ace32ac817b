"""Batched solving of independent problem instances.

The port of ``fos_tpu.parallel.batched``.  B instances that share their
shapes and cone structure are stacked on a leading axis and solved at once
by :func:`fos_tpu_torch.solvers.engine.fused_solve`, whose lane axis is the
JAX package's ``vmap`` of it: each instance stops and freezes at its own
status, and the loop runs until the slowest has finished.  The products
are ``torch.bmm`` over the stacked A (plain XLA under ``vmap`` in the JAX
package, which passes no ``pallas`` flag here), or one ``torch.matmul``
when the instances share one A through a stride-0 batch axis.
"""

from __future__ import annotations

import numpy as np
import torch

from fos_tpu_torch.config import as_tensor, default_device
from fos_tpu_torch.cones.project import resolve_psd_method
from fos_tpu_torch.cones.spec import ConeSpec
from fos_tpu_torch.linalg.affine import (HSDEAffineProjector,
                                         _host_q_dense_f64,
                                         _ls_projection_fac)
from fos_tpu_torch.problems.hsde import HSDEForm, hsde_cone_spec
from fos_tpu_torch.solvers import engine
from fos_tpu_torch.solvers.base import GAPP, ConeSet, TwoSets


def _batched(v, device):
    """A tensor on ``device``: a tensor keeps its strides (a stride-0
    ``expand`` stays one matrix in memory), other data are copied."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device)
    return as_tensor(v, device=device)


def build_batched_form(A, b, c, K1: ConeSpec, K2: ConeSpec, *, direct=False,
                       cg_max_iters: int = 1000, device=None,
                       psd_method: str = "auto",
                       cg_tol_floor: float = None) -> HSDEForm:
    """A ``(B, m, n)``, b ``(B, m)``, c ``(B, n)``: one :class:`HSDEForm`
    whose arrays carry a leading instance axis.  A dense A; a tensor A
    expanded from one ``(m, n)`` matrix (``A0.expand(B, m, n)``) stays that
    one matrix in memory, and its products are one ``torch.matmul`` for
    all instances.  ``direct`` factors ``[I; Q_i]`` of every instance on
    the host in f64 (a ``(B, 2l, l)`` factor).  The data keep their dtype
    and live on ``device`` (default: the card).  ``psd_method`` and
    ``cg_tol_floor`` as for :meth:`HSDEForm.build`."""
    device = default_device(device)
    A, b, c = (_batched(v, device) for v in (A, b, c))
    if A.dim() != 3 or b.dim() != 2 or c.dim() != 2:
        raise ValueError(f"expected A (B, m, n), b (B, m), c (B, n); got "
                         f"{tuple(A.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    B, m, n = A.shape
    if K1.dim != m or K2.dim != n:
        raise ValueError("cone specs must cover (m, n)")
    fac = None
    if direct:
        # the same host QR as HSDEAffineProjector.create, per instance
        Q = np.stack([_host_q_dense_f64(A[i], b[i], c[i]) for i in range(B)])
        fac = _ls_projection_fac(Q, eye_first=True, dtype=b.dtype,
                                 device=device)
    s1 = HSDEAffineProjector(A, b, c, fac, decreasing_accuracy=not direct,
                             cg_max_iters=cg_max_iters, tol_floor=cg_tol_floor)
    s2 = ConeSet(hsde_cone_spec(K1, K2), resolve_psd_method(psd_method, device))
    # compensated check reductions for f32 batches, as the single build
    norms = (torch.linalg.vector_norm(v, dim=-1) for v in (b, c))
    return HSDEForm(TwoSets(s1, s2), A, b, c, *norms, n, m,
                    compensated=b.dtype == torch.float32)


def form_initial_value(form: HSDEForm):
    """One instance's starting point: tau = kappa = 1, everything else 0."""
    l = form.l
    z = torch.zeros(2 * l, dtype=form.dtype, device=form.device)
    z[l - 1].fill_(1.0)
    z[2 * l - 1].fill_(1.0)
    return z


def _instances(form) -> int:
    return form.b.shape[0]


def _start(form, initx):
    B, l = _instances(form), form.l
    if initx is None:
        return form_initial_value(form).expand(B, 2 * l).clone()
    x0 = as_tensor(initx, form.dtype, form.device)
    if tuple(x0.shape) != (B, 2 * l):
        raise ValueError(f"initx must be (B, 2l) = {(B, 2 * l)}, got "
                         f"{tuple(x0.shape)}")
    return x0


def solve_batched(alg, form: HSDEForm, *, max_iters: int = 10000,
                  eps: float = 1e-5, checki: int = 100,
                  record_history: bool = False, unroll: int = 1,
                  initx=None, segment_iters: int = None,
                  budget_iters: int = None) -> engine.FusedResult:
    """Solve every instance of a batched form (:func:`build_batched_form`)
    in one :func:`fused_solve` with a lane axis.

    ``initx``: ``(B, 2l)`` warm starts (e.g. a previous batch's
    ``result.state.x``).  ``segment_iters`` splits the budget into
    segments of at most this many iterations, each resumed from the
    previous one's full state, so the trajectory (iterates, CG schedule,
    warm starts, recovery) continues through the boundaries; each segment
    ends with the engine's forced guess check, which can end an instance at
    a boundary.  An instance's status is the first non-Continue status it
    reached, its iteration count carries in ``state.i``, and with
    ``record_history`` the segments' rows are concatenated (an instance
    that finished in an earlier segment gets zero rows).
    ``budget_iters``: the plateau recovery's budget (default: the whole
    ``max_iters``).  ``unroll`` is accepted and has no effect.

    The algorithm steps every instance at once: the GAP family (GAP, DR,
    AP), GAPA, FISTA and Dykstra.  GAPP and the wrappers, whose steps
    branch per instance, are refused.
    """
    return _solve_batched(engine.fused_solve, alg, form, max_iters=max_iters,
                          eps=eps, checki=checki,
                          record_history=record_history, initx=initx,
                          segment_iters=segment_iters,
                          budget_iters=budget_iters)


def _solve_batched_eager(alg, form, **kw) -> engine.FusedResult:
    """:func:`solve_batched` with the fused loops run eagerly on the card
    (the plain version of the captured route; tests and chip_smoke.py)."""
    kw.pop("unroll", None)
    return _solve_batched(engine._fused_solve_eager, alg, form, **kw)


def _solve_batched(fused, alg, form, *, max_iters=10000, eps=1e-5,
                   checki=100, record_history=False, initx=None,
                   segment_iters=None, budget_iters=None):
    from fos_tpu_torch.solvers.wrappers import (AndersonWrapper,
                                                LineSearchWrapper,
                                                LongstepWrapper)

    if isinstance(alg, (GAPP, LineSearchWrapper, AndersonWrapper,
                        LongstepWrapper)):
        raise NotImplementedError(
            f"{type(alg).__name__} in a batched solve is not ported: its "
            "steps branch per instance (ROADMAP)")
    x0 = _start(form, initx)
    opts = dict(eps=eps, checki=checki, record_history=record_history)
    if segment_iters is None or segment_iters >= max_iters:
        return fused(alg, form, x0, max_iters=max_iters,
                     budget_iters=budget_iters, **opts)
    budget = max_iters if budget_iters is None else budget_iters
    merged = done = state = None
    hists = []
    remaining = max_iters
    while remaining > 0:
        seg = min(segment_iters, remaining)
        remaining -= seg
        res = fused(alg, form, x0, max_iters=seg, resume_state=state,
                    budget_iters=budget, **opts)
        if record_history:
            # instances that finished in an earlier segment ran again from
            # their frozen iterates: their rows are not theirs, zero them
            h = res.hist
            if done is not None:
                h = torch.where(done[:, None, None], torch.zeros_like(h), h)
            hists.append(h)
        res = res._replace(hist=None)
        if merged is None:
            merged, done = res, res.status != 0
        else:
            keep = done   # a finished instance keeps its result
            merged = _merge(keep, merged, res)
            done = done | (res.status != 0)
            merged = merged._replace(status=torch.where(
                done, merged.status, torch.zeros_like(merged.status)))
        state = merged.state
        if bool(done.all()):
            break
    # state.i carries the true count: a resumed segment keeps counting
    merged = merged._replace(iters=merged.state.i)
    hist = (torch.cat(hists, dim=1) if record_history
            else torch.zeros((0, 0), dtype=form.dtype, device=form.device))
    return merged._replace(hist=hist)


def _merge(keep, old, new):
    """``old`` where ``keep`` (one flag per instance), else ``new``, over
    every tensor of a result; a field that is not per instance stays
    ``old``'s."""
    B = keep.shape[0]

    def pick(o, n):
        if n is None or n.dim() == 0 or n.shape[0] != B:
            return o
        return torch.where(keep.reshape((B,) + (1,) * (n.dim() - 1)), o, n)

    def walk(o, n):
        if isinstance(n, torch.Tensor) or n is None:
            return pick(o, n)
        vals = [walk(a, c) for a, c in zip(o, n)]
        return type(n)(*vals) if hasattr(n, "_fields") else tuple(vals)

    return walk(old, new)
