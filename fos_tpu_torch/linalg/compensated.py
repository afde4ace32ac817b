"""Compensated (float-float) reductions for the f32 path.

Plain f32 dot products and norms carry O(n*eps) ~ 1e-4 relative error at
the solver's vector lengths.  These routines recover ~f64-quality
reductions in f32 arithmetic alone:

* products are split exactly with Dekker's algorithm (TwoProd), so each
  ``x_i*y_i`` becomes an exact hi+lo pair;
* the sum is a binary-tree reduction in float-float arithmetic, one
  vectorised TwoSum per level.

The transforms need IEEE-exact add/sub/mul with no fused multiply-add.
Eager PyTorch runs each of these operations as its own kernel, so nothing
contracts ``a*b - p`` into an FMA; a CUDA port of this code would have to
use ``__fmul_rn``/``__fadd_rn``, because nvcc contracts by default.
"""

from __future__ import annotations

import torch


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (branch-free, 6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    """Dekker split into hi/lo halves of the mantissa (exact)."""
    # f32: 24-bit mantissa -> split constant 2^12 + 1; f64: 2^27 + 1.
    const = 4097.0 if a.dtype == torch.float32 else 134217729.0
    c = const * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProd: p + err == a * b exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _ff_tree_sum_ff(hi, lo):
    """Sum a vector of float-float (hi, lo) pairs by binary-tree reduction,
    carrying the low parts; returns a normalised scalar (hi, lo) pair."""
    n = hi.shape[0]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        pad = hi.new_zeros(p - n)
        hi = torch.cat([hi, pad])
        lo = torch.cat([lo, pad])
    while p > 1:
        h = p // 2
        s, e = _two_sum(hi[:h], hi[h:])
        lo = lo[:h] + lo[h:] + e
        hi = s
        p = h
    return _two_sum(hi[0], lo[0])


def cdot_ff(x, y):
    """Compensated dot product as a float-float (hi, lo) scalar pair: for a
    caller that differences two near-equal dots (the HSDE gap
    ``|c'x + b'y|``) without losing the low-order half."""
    p, e = _two_prod(x, y)
    return _ff_tree_sum_ff(p, e)


def cdot(x, y):
    """Compensated dot product, rounded to one value of the input dtype."""
    hi, lo = cdot_ff(x, y)
    return hi + lo


def cnorm(x):
    """Compensated 2-norm via the compensated sum of exact squares."""
    return torch.sqrt(cdot(x, x))


def ff_add(a, b):
    """Add two float-float scalar pairs (normalised result)."""
    s, e = _two_sum(a[0], b[0])
    e = e + a[1] + b[1]
    return _two_sum(s, e)
