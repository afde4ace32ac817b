"""Fused cone-product projection.

A :class:`ConeSpec` is compiled once into a plan of index arrays, and the
projection runs as one pass over the whole vector:

* all elementwise cones (Free/Zero/NonNeg/NonPos) are one clamp against
  precomputed lower/upper bound vectors;
* all SOC blocks, of any sizes, are projected together instead of in a
  loop over blocks: each block's tail norm is a row sum over a padded
  table of its tail positions, one table per power-of-two tail width
  (built once with the plan, so padding at most doubles the entries);
* rotated-SOC blocks fold into the SOC pass through the orthogonal rotation
  ``H = [[1, 1], [1, -1]] / sqrt(2)`` of their first two entries;
* PSD blocks, in the scaled svec layout (ProximalOperators'
  ``IndPSD(scaling=true)``), are bucketed by side and projected as one
  batch per bucket, by ``eigh`` or by the matrix-product filter of
  :mod:`fos_tpu_torch.cones.psd_poly` (``psd_method``); when there are
  more than two sides, sides sharing a power-of-two ceiling are zero-padded
  into one batch (projection commutes with zero-padding);
* exponential and power blocks are gathered into one (k, 3) batch per cone
  family, primal and dual together (a dual block is projected by Moreau,
  ``v + P_K(-v)``), so each family's fixed-step root finder runs once per
  projection (:mod:`fos_tpu_torch.cones.exp`, :mod:`fos_tpu_torch.cones.
  pow`).

Every sum is a plain reduction along an axis and every gather and scatter
has fixed, distinct targets (no atomics), so a projection repeats bit for
bit on the card as on the CPU.  The tables are numpy arrays made with the
plan and copied to a device once, before any CUDA graph capture
(:func:`prepare`).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from fos_tpu_torch.cones import exp as exp_cone
from fos_tpu_torch.cones import pow as pow_cone
from fos_tpu_torch.cones.spec import Cone, ConeSpec, psd_side_from_len
from fos_tpu_torch.utils.autograd import differentiated

_SQRT2 = math.sqrt(2.0)

_ELEMENTWISE_BOUNDS = {
    Cone.FREE: (-np.inf, np.inf),
    Cone.ZERO: (0.0, 0.0),
    Cone.NONNEG: (0.0, np.inf),
    Cone.NONPOS: (-np.inf, 0.0),
}

PSD_METHODS = ("eigh", "poly")


def _svec_index(side: int):
    """(rows, cols) of the svec layout: the lower triangle stacked by
    columns."""
    rows = np.concatenate([np.arange(j, side) for j in range(side)])
    cols = np.concatenate([np.full(side - j, j) for j in range(side)])
    return rows, cols


def _psd_group(S: int, entries):
    """The tables of one PSD bucket of padded side ``S``: ``entries`` lists
    (side, block offsets).  ``gather`` (nb, LS+1) reads each block's svec
    entries from x, padded with zero slots (-1); ``build`` (nb, S, S)
    indexes those padded vectors (a padded side's extra rows and columns
    read a zero slot); ``take`` / ``put`` move the real svec entries of
    every block out of the projected matrices and into the vector."""
    LS = S * (S + 1) // 2
    gather, build, take, put, offdiag = [], [], [], [], []
    k = 0
    for side, offs in entries:
        L = side * (side + 1) // 2
        rows, cols = _svec_index(side)
        pos = np.full((S, S), LS, dtype=np.int64)
        pos[rows, cols] = np.arange(L)
        pos[cols, rows] = np.arange(L)
        for o in offs:
            gather.append(np.concatenate([np.arange(o, o + L),
                                          np.full(LS + 1 - L, -1)]))
            build.append(pos + k * (LS + 1))
            take.append(k * S * S + rows * S + cols)
            put.append(np.arange(o, o + L))
            offdiag.append(rows != cols)
            k += 1
    return {"side": S, "nb": k, "gather": np.stack(gather),
            "build": np.stack(build), "take": np.concatenate(take),
            "put": np.concatenate(put), "offdiag": np.concatenate(offdiag)}


def _build_plan(blocks: Tuple[Tuple[Cone, int], ...],
                params: Tuple[Tuple[float, ...], ...] = ()):
    """Precompute (as numpy arrays) the index arrays for the fused pass."""
    if params == ():
        if any(cone in (Cone.POW_PRIMAL, Cone.POW_DUAL) for cone, _ in blocks):
            raise ValueError(
                "power-cone blocks need per-block alpha params; an empty "
                "params tuple would project POW slices as free")
        params = tuple(() for _ in blocks)
    dim = sum(d for _, d in blocks)
    lo = np.full(dim, -np.inf)
    hi = np.full(dim, np.inf)
    soc_idx, soc_seg, soc_head, rot_pq = [], [], [], []
    psd_groups = {}
    exp_rows, pow_rows = [], []   # (start, dual) and (start, alpha, dual)
    off = 0
    seg = 0
    for (cone, d), par in zip(blocks, params):
        if cone in _ELEMENTWISE_BOUNDS:
            lo[off:off + d], hi[off:off + d] = _ELEMENTWISE_BOUNDS[cone]
        elif cone in (Cone.SOC, Cone.SOC_ROTATED):
            if cone is Cone.SOC_ROTATED:
                rot_pq.append((off, off + 1))
            soc_idx.append(np.arange(off, off + d))
            soc_seg.append(np.full(d, seg))
            head = np.zeros(d, dtype=bool)
            head[0] = True
            soc_head.append(head)
            seg += 1
        elif cone is Cone.PSD:
            psd_groups.setdefault(psd_side_from_len(d), []).append(off)
        elif cone in (Cone.EXP_PRIMAL, Cone.EXP_DUAL):
            exp_rows += [(s, cone is Cone.EXP_DUAL)
                         for s in range(off, off + d, 3)]
        elif cone in (Cone.POW_PRIMAL, Cone.POW_DUAL):
            pow_rows += [(s, a, cone is Cone.POW_DUAL)
                         for s, a in zip(range(off, off + d, 3), par)]
        else:  # pragma: no cover
            raise NotImplementedError(cone)
        off += d
    plan = {"dim": dim, "lo": lo, "hi": hi,
            "clip": bool(np.isfinite(lo).any() or np.isfinite(hi).any()),
            "soc": None, "psd": [], "exp": None, "pow": None}
    if soc_idx:
        idx = np.concatenate(soc_idx)
        lookup = {e: i for i, e in enumerate(idx)}
        # positions (within the SOC value vector) of each rotated pair
        rot_pos = np.array([lookup[x] for pq in rot_pq for x in pq],
                           dtype=np.int64)
        head = np.concatenate(soc_head)
        plan["soc"] = {
            "idx": idx,
            "seg": np.concatenate(soc_seg),
            "head": head,
            "head_pos": np.flatnonzero(head),
            "tails": _tail_tables(np.flatnonzero(head), idx.size),
            "nseg": seg,
            "rot_pos": rot_pos,
        }
    # more than two sides: pad the sides sharing a power-of-two ceiling
    # into one batch (at most ~4x the flops on the smaller blocks, for one
    # batched projection per bucket)
    if len(psd_groups) > 2:
        buckets = {}
        for side, offs in sorted(psd_groups.items()):
            key = 1 << (side - 1).bit_length()
            buckets.setdefault(key, []).append((side, offs))
        grouped = [(max(s for s, _ in entries), entries)
                   for _, entries in sorted(buckets.items())]
    else:
        grouped = [(side, [(side, offs)])
                   for side, offs in sorted(psd_groups.items())]
    plan["psd"] = [_psd_group(S, entries) for S, entries in grouped]
    plan["writes"] = bool(soc_idx or psd_groups or exp_rows or pow_rows)
    if exp_rows:
        starts = np.array([s for s, _ in exp_rows])
        plan["exp"] = {"idx": starts[:, None] + np.arange(3),
                       "dual": np.array([du for _, du in exp_rows])}
    if pow_rows:
        starts = np.array([s for s, _, _ in pow_rows])
        plan["pow"] = {"idx": starts[:, None] + np.arange(3),
                       "alpha": np.array([a for _, a, _ in pow_rows]),
                       "dual": np.array([du for _, _, du in pow_rows])}
    return plan


def _tail_tables(head_pos, size):
    """The SOC blocks' tail positions (within the SOC value vector of
    ``size`` entries, blocks back to back from ``head_pos``), as (segment
    ids (k,), positions (k, w)) per power-of-two tail width w; padding
    points at ``size``, a zero appended to the values."""
    ends = np.append(head_pos[1:], size)
    lengths = ends - head_pos - 1
    widths = 1 << np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64)
    tables = []
    for w in np.unique(widths):
        segs = np.flatnonzero(widths == w)
        pos = head_pos[segs, None] + 1 + np.arange(w)
        pos[np.arange(w) >= lengths[segs, None]] = size
        tables.append((segs, pos))
    return tables


def _soc_project_flat(vals, seg, head, head_pos, tails, nseg):
    """Project concatenated SOC blocks described by segment ids; ``vals`` is
    (..., N) and the blocks run along the last axis.  ``tails`` are the
    plan's padded tail tables (:func:`_tail_tables`), as tensors.

    SOC(t, x): if ||x|| <= t identity; if ||x|| <= -t zero; else
    ((t+||x||)/2) * (1, x/||x||).
    """
    v = torch.movedim(vals, -1, 0)  # (N, ...batch)
    head_b = head.reshape((head.shape[0],) + (1,) * (v.ndim - 1))
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    one = torch.ones((), dtype=v.dtype, device=v.device)
    tail = torch.where(head_b, zero, v)
    t = v[head_pos]
    padded = torch.cat([v, v.new_zeros((1,) + v.shape[1:])])
    nx2 = v.new_empty((nseg,) + v.shape[1:])
    for segs, pos in tails:
        x = padded[pos]
        nx2[segs] = (x * x).sum(1)
    nx = torch.sqrt(nx2)

    ident = nx <= t
    to_zero = nx <= -t
    c = 0.5 * (t + nx)
    nx_safe = torch.where(nx > 0, nx, one)
    scale_tail = torch.where(ident, one, torch.where(to_zero, zero, c / nx_safe))
    t_out = torch.where(ident, t, torch.where(to_zero, zero, c))
    out = torch.where(head_b, t_out[seg], tail * scale_tail[seg])
    return torch.movedim(out, 0, -1)


def _rotate(vals, pos):
    """Apply H to the (p, q) pairs at ``pos`` (interleaved p0, q0, p1, ...)
    along the last axis; H is involutive."""
    p = vals[..., pos[0::2]]
    q = vals[..., pos[1::2]]
    out = vals.clone()
    out[..., pos[0::2]] = (p + q) / _SQRT2
    out[..., pos[1::2]] = (p - q) / _SQRT2
    return out


def _eigh_project(X):
    w, V = torch.linalg.eigh(X)
    return torch.matmul(V * torch.clamp_min(w, 0.0)[..., None, :], V.mT), w, V


def _divided_differences(w):
    """The Daleckii-Krein matrix ``K_ij = (f(w_i) - f(w_j)) / (w_i - w_j)``
    of ``f = max(., 0)``, with the symmetric subgradient ``(step(w_i) +
    step(w_j)) / 2`` where two eigenvalues are equal to within ``100 eps
    max(max|w|, 1)`` (a repeated eigenvalue, where eigh's own derivative
    divides by zero)."""
    f = torch.clamp_min(w, 0.0)
    den = w[..., :, None] - w[..., None, :]
    scale = torch.amax(torch.abs(w), dim=-1, keepdim=True)[..., None]
    tiny = 100.0 * torch.finfo(w.dtype).eps
    same = torch.abs(den) <= tiny * torch.clamp_min(scale, 1.0)
    step = (w > 0.0).to(w.dtype)
    avg = 0.5 * (step[..., :, None] + step[..., None, :])
    num = f[..., :, None] - f[..., None, :]
    return torch.where(same, avg, num / torch.where(same, 1.0, den))


def _dk_apply(w, V, E):
    """``V (K o (V' E V)) V'``: the projection's derivative along E, and
    (K is symmetric) its adjoint."""
    Et = torch.matmul(torch.matmul(V.mT, E), V)
    return torch.matmul(torch.matmul(V, _divided_differences(w) * Et), V.mT)


class PsdEighFn(torch.autograd.Function):
    """The eigh projection with a degeneracy-safe derivative (the port of
    the JAX package's ``custom_jvp`` on ``psd_project_eigh``): ``DP(X)[E] =
    V (K o (V' E V)) V'`` with the divided differences of
    :func:`_divided_differences`.  JAX transposes the JVP; here the backward
    is the same map applied to the symmetrised cotangent.  Returns ``(P, w,
    V)``; only P is differentiable."""

    @staticmethod
    def forward(X):
        return _eigh_project(X)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, w, V = output
        ctx.mark_non_differentiable(w, V)
        ctx.save_for_backward(w, V)
        ctx.save_for_forward(w, V)

    @staticmethod
    def backward(ctx, G, _gw, _gV):
        w, V = ctx.saved_tensors
        return _dk_apply(w, V, 0.5 * (G + G.mT))

    @staticmethod
    def jvp(ctx, E):
        w, V = ctx.saved_tensors
        return _dk_apply(w, V, E), None, None


def psd_project_eigh(X):
    """Project symmetric ``X`` (..., d, d) onto the PSD cone by an
    eigendecomposition: ``V max(w, 0) V'``.  Under autograd (a gradient or
    a forward-mode tangent) it goes through :class:`PsdEighFn`, whose
    derivative stays finite at repeated eigenvalues; otherwise the same
    arithmetic runs directly."""
    if differentiated(X):
        return PsdEighFn.apply(X)[0]
    return _eigh_project(X)[0]


def _psd_project(X, psd_method):
    if psd_method == "poly":
        from fos_tpu_torch.cones.psd_poly import psd_project_poly

        return psd_project_poly(X)
    return psd_project_eigh(X)


def _psd_project_group(x, y, grp, t, psd_method):
    """Project every block of one PSD bucket as one batch and write the
    results into ``y`` (in place).  ``t`` holds the bucket's tables as
    tensors.  The matrices are built by one gather from the blocks' svec
    vectors, padded with a zero slot (a padded side's extra rows and
    columns are zero), and the projected svec entries are read back by one
    gather and written by one scatter with distinct targets."""
    S, nb = grp["side"], grp["nb"]
    tri = x[..., t["gather"]]                          # (..., nb, LS+1)
    tri = torch.where(t["gather"] >= 0, tri, torch.zeros_like(tri))
    flat = tri.reshape(*tri.shape[:-2], -1)
    X = flat[..., t["build"]] * t["unscale"]           # (..., nb, S, S)
    Xp = _psd_project(X, psd_method)
    out = Xp.reshape(*Xp.shape[:-3], nb * S * S)[..., t["take"]]
    y[..., t["put"]] = out * t["rescale"]


class _Projector:
    """A compiled projection: the numpy plan plus its tensors, made once for
    each (device, dtype) the projection is called with."""

    def __init__(self, blocks, psd_method, params):
        self.plan = _build_plan(tuple(blocks), tuple(params))
        self.psd_method = psd_method
        self._tensors = {}

    def _on(self, device, dtype):
        key = (device, dtype)
        t = self._tensors.get(key)
        if t is None:
            t = self._make(device, dtype)
            self._tensors[key] = t
        return t

    def _make(self, device, dtype):
        plan = self.plan

        def tt(a, dt=None):
            return torch.as_tensor(a, device=device, dtype=dt)

        t = {"lo": tt(plan["lo"], dtype), "hi": tt(plan["hi"], dtype)}
        soc = plan["soc"]
        if soc is not None:
            for k in ("idx", "seg", "head", "head_pos", "rot_pos"):
                t[k] = tt(soc[k])
            t["tails"] = [tuple(tt(a) for a in table)
                          for table in soc["tails"]]
        t["psd"] = []
        for grp in plan["psd"]:
            S = grp["side"]
            ii, jj = np.indices((S, S))
            # the off-diagonal svec entries carry sqrt(2); the scale factors
            # are rounded to the dtype first, as in the JAX package
            unscale = tt(np.where(ii != jj, 1.0 / _SQRT2, 1.0), dtype)
            unscale_svec = tt(np.where(grp["offdiag"], 1.0 / _SQRT2, 1.0),
                              dtype)
            t["psd"].append({k: tt(grp[k]) for k in
                             ("gather", "build", "take", "put")}
                            | {"unscale": unscale,
                               "rescale": 1.0 / unscale_svec})
        if plan["exp"] is not None:
            t["exp_idx"] = tt(plan["exp"]["idx"])
            t["exp_dual"] = tt(plan["exp"]["dual"])[:, None]
        if plan["pow"] is not None:
            t["pow_idx"] = tt(plan["pow"]["idx"])
            t["pow_dual"] = tt(plan["pow"]["dual"])[:, None]
            t["pow_alpha"] = tt(plan["pow"]["alpha"], dtype)
        return t

    def __call__(self, x):
        plan = self.plan
        if x.shape[-1] != plan["dim"]:
            raise ValueError(
                f"expected trailing dim {plan['dim']}, got {tuple(x.shape)}")
        t = self._on(x.device, x.dtype)
        y = torch.clamp(x, t["lo"], t["hi"]) if plan["clip"] else x
        if y is x and plan["writes"]:
            y = x.clone()
        soc = plan["soc"]
        if soc is not None:
            vals = x[..., t["idx"]]
            rot = soc["rot_pos"].size > 0
            if rot:
                vals = _rotate(vals, t["rot_pos"])
            out = _soc_project_flat(vals, t["seg"], t["head"], t["head_pos"],
                                    t["tails"], soc["nseg"])
            if rot:
                out = _rotate(out, t["rot_pos"])
            y[..., t["idx"]] = out
        for grp, tg in zip(plan["psd"], t["psd"]):
            _psd_project_group(x, y, grp, tg, self.psd_method)
        if plan["exp"] is not None:
            v = x[..., t["exp_idx"]]                    # (..., k, 3)
            dual = t["exp_dual"]
            p = exp_cone.project_exp(torch.where(dual, -v, v))
            y[..., t["exp_idx"]] = torch.where(dual, v + p, p)
        if plan["pow"] is not None:
            v = x[..., t["pow_idx"]]
            dual = t["pow_dual"]
            p = pow_cone.project_pow(torch.where(dual, -v, v), t["pow_alpha"])
            y[..., t["pow_idx"]] = torch.where(dual, v + p, p)
        return y


@functools.lru_cache(maxsize=None)
def make_projector(blocks: Tuple[Tuple[Cone, int], ...],
                   psd_method: str = "eigh",
                   params: Tuple[Tuple[float, ...], ...] = ()) -> _Projector:
    """Compile a fused projection function for a product of cones (cached
    per (blocks, psd_method, params): a spec is compiled once per process).
    ``psd_method`` is "eigh" or "poly"; ``params`` carries the POW blocks'
    exponents, aligned as in :class:`ConeSpec`."""
    return _Projector(blocks, psd_method, params)


def resolve_psd_method(psd_method: str, device) -> str:
    """"auto" is "poly" (matrix products only, capturable) on a CUDA device
    and "eigh" on the CPU, as the JAX package picks "poly" on accelerators
    and "eigh" on the CPU."""
    if psd_method == "auto":
        return "poly" if torch.device(device).type == "cuda" else "eigh"
    if psd_method not in PSD_METHODS:
        raise ValueError(f"psd_method must be 'auto', 'eigh' or 'poly', got "
                         f"{psd_method!r}")
    return psd_method


def _for(spec: ConeSpec, psd_method, device) -> _Projector:
    return make_projector(spec.blocks, resolve_psd_method(psd_method, device),
                          spec.params)


def project(spec: ConeSpec, x, psd_method: str = "auto"):
    """Project ``x`` onto the cone product described by ``spec``."""
    return _for(spec, psd_method, x.device)(x)


def project_dual(spec: ConeSpec, x, psd_method: str = "auto"):
    """Project ``x`` onto the dual cone product (duality is resolved on the
    spec: every cone has a closed-form dual)."""
    return project(spec.dual(), x, psd_method)


def prepare(spec: ConeSpec, like, psd_method: str = "auto") -> None:
    """Make the projection's tensors for ``like``'s device and dtype now:
    they are copied from the host, which a CUDA graph capture forbids."""
    _for(spec, psd_method, like.device)._on(like.device, like.dtype)


def svec(X, scaled: bool = True):
    """The svec vector (..., d(d+1)/2) of symmetric ``X`` (..., d, d): the
    lower triangle stacked by columns, off-diagonals times sqrt(2) when
    ``scaled`` (so that ||svec(X)|| = ||X||_F)."""
    rows, cols = _svec_index(X.shape[-1])
    v = X[..., rows, cols]
    if scaled:
        scale = np.where(rows != cols, _SQRT2, 1.0)
        v = v * torch.as_tensor(scale, dtype=X.dtype, device=X.device)
    return v


def smat(v, scaled: bool = True):
    """The inverse of :func:`svec`."""
    d = psd_side_from_len(v.shape[-1])
    rows, cols = _svec_index(d)
    tri = v
    if scaled:
        scale = np.where(rows != cols, 1.0 / _SQRT2, 1.0)
        tri = v * torch.as_tensor(scale, dtype=v.dtype, device=v.device)
    X = v.new_zeros((*v.shape[:-1], d, d))
    X[..., rows, cols] = tri
    X[..., cols, rows] = tri
    return X
