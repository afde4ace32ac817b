"""Fused cone-product projection (LP and SOCP cones).

A :class:`ConeSpec` is compiled once into a plan of index arrays, and the
projection runs as one pass over the whole vector:

* all elementwise cones (Free/Zero/NonNeg/NonPos) are one clamp against
  precomputed lower/upper bound vectors;
* all SOC blocks, of any sizes, are projected together instead of in a
  loop over blocks: each block's tail norm is a row sum over a padded
  table of its tail positions, one table per power-of-two tail width
  (built once with the plan, so padding at most doubles the entries);
* rotated-SOC blocks fold into the SOC pass through the orthogonal rotation
  ``H = [[1, 1], [1, -1]] / sqrt(2)`` of their first two entries.

PSD, exponential and power cones are not ported yet (ROADMAP queue 1, "The
other cones"): a spec holding one raises when its plan is built, rather than
projecting those entries as free.

Every sum is a plain reduction along an axis (no atomics), so the
projection repeats bit for bit on the card as on the CPU.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from fos_tpu_torch.cones.spec import Cone, ConeSpec

_SQRT2 = math.sqrt(2.0)

_ELEMENTWISE_BOUNDS = {
    Cone.FREE: (-np.inf, np.inf),
    Cone.ZERO: (0.0, 0.0),
    Cone.NONNEG: (0.0, np.inf),
    Cone.NONPOS: (-np.inf, 0.0),
}


def _build_plan(blocks: Tuple[Tuple[Cone, int], ...]):
    """Precompute (as numpy arrays) the index arrays for the fused pass."""
    dim = sum(d for _, d in blocks)
    lo = np.full(dim, -np.inf)
    hi = np.full(dim, np.inf)
    soc_idx, soc_seg, soc_head, rot_pq = [], [], [], []
    off = 0
    seg = 0
    for cone, d in blocks:
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
        else:
            raise NotImplementedError(
                f"{cone} cones are not ported yet: ROADMAP queue 1, 'The "
                "other cones'")
        off += d
    plan = {"dim": dim, "lo": lo, "hi": hi,
            "clip": bool(np.isfinite(lo).any() or np.isfinite(hi).any()),
            "soc": None}
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


class _Projector:
    """A compiled projection: the numpy plan plus its tensors, made once for
    each (device, dtype) the projection is called with."""

    def __init__(self, blocks):
        self.plan = _build_plan(tuple(blocks))
        self._tensors = {}

    def _on(self, device, dtype):
        key = (device, dtype)
        t = self._tensors.get(key)
        if t is None:
            plan = self.plan
            t = {"lo": torch.as_tensor(plan["lo"], dtype=dtype, device=device),
                 "hi": torch.as_tensor(plan["hi"], dtype=dtype, device=device)}
            soc = plan["soc"]
            if soc is not None:
                for k in ("idx", "seg", "head", "head_pos", "rot_pos"):
                    t[k] = torch.as_tensor(soc[k], device=device)
                t["tails"] = [tuple(torch.as_tensor(a, device=device)
                                    for a in table) for table in soc["tails"]]
            self._tensors[key] = t
        return t

    def __call__(self, x):
        plan = self.plan
        if x.shape[-1] != plan["dim"]:
            raise ValueError(
                f"expected trailing dim {plan['dim']}, got {tuple(x.shape)}")
        t = self._on(x.device, x.dtype)
        y = torch.clamp(x, t["lo"], t["hi"]) if plan["clip"] else x
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
            y = y.clone() if y is x else y
            y[..., t["idx"]] = out
        return y


@functools.lru_cache(maxsize=None)
def make_projector(blocks: Tuple[Tuple[Cone, int], ...]) -> _Projector:
    """Compile a fused projection function for a product of cones (cached
    per block tuple: a spec is compiled once per process)."""
    return _Projector(blocks)


def project(spec: ConeSpec, x):
    """Project ``x`` onto the cone product described by ``spec``."""
    return make_projector(spec.blocks)(x)


def prepare(spec: ConeSpec, like) -> None:
    """Make the projection's tensors for ``like``'s device and dtype now:
    they are copied from the host, which a CUDA graph capture forbids."""
    make_projector(spec.blocks)._on(like.device, like.dtype)


def project_dual(spec: ConeSpec, x):
    """Project ``x`` onto the dual cone product (duality is resolved on the
    spec: every ported cone has a closed-form dual)."""
    return make_projector(spec.dual().blocks)(x)
