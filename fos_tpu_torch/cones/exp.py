"""Projection onto the exponential cone, vectorised over blocks.

    Kexp  = cl{ (x,y,z) : y > 0, y exp(x/y) <= z }
    Kexp* = cl{ (u,v,w) : u < 0, -u exp(v/u) <= e w } U {(0,v,w): v,w >= 0}

(MathProgBase / SCS ordering.)  A point in neither Kexp nor its polar
projects onto the boundary point ``(rho x2, x2, x2 e^rho)``, where rho is
the root of the univariate function

    h(rho) = ((rho-1) r + s) e^rho + (rho s - r) e^(-rho) - (rho^2-rho+1) t

(H. Friberg, "Projection onto the exponential cone: a univariate root-
finding problem", 2021, as in SCS), bracketed from the positivity of x2
and of the multiplier.  The root finder runs a fixed number of steps (64
bracket expansions, 96 bisections, 8 clamped Newton steps) on every block
at once: no data-dependent trip count and no host read, so it can be
captured in a CUDA graph.  Every branch is a ``torch.where``; the JAX
package's ``vmap`` over scalars becomes elementwise tensor arithmetic over
the block axis (any leading axes broadcast).  A port of
``fos_tpu.cones.exp``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EXPANSION_ITERS = 64
_BISECTION_ITERS = 96
_NEWTON_ITERS = 8


def _h_and_grad(rho, r, s, t):
    """h(rho) and h'(rho) (the raw function: Newton's polish)."""
    rm1 = rho - 1.0
    er, emr = torch.exp(rho), torch.exp(-rho)
    quad = rho * rm1 + 1.0
    h = (rm1 * r + s) * er + (rho * s - r) * emr - quad * t
    g = (rho * r + s) * er + (r - rm1 * s) * emr - (2.0 * rho - 1.0) * t
    return h, g


def _h_sign(rho, r, s, t):
    """h(rho) times exp(-|rho|): the same sign, and never overflows (a root
    where exp(rho) overflows would make the raw h evaluate 0 * inf).  ``rho``
    may carry a leading axis more than r, s, t (both bracket ends at once)."""
    pos = rho >= 0
    e1 = torch.exp(-torch.abs(rho))
    rm1 = rho - 1.0
    quad = rho * rm1 + 1.0
    a = rm1 * r + s
    b = rho * s - r
    # quad * (t * e1), not (quad * t) * e1: the latter overflows to inf
    # before an underflowed e1 = 0 multiplies in (inf * 0 = NaN at
    # rho ~ 1e30 brackets with |t| ~ 1e30)
    qte = quad * (t * e1)
    # rho >= 0: a + b e1^2 - qte; rho < 0: a e1^2 + b - qte
    return (torch.where(pos, a, b) + torch.where(pos, b, a) * (e1 * e1)
            - qte)


def _in_primal(r, s, t):
    """s exp(r/s) <= t, tested in log space (log s + r/s <= log t) so that
    extreme magnitudes classify exactly."""
    s_safe = torch.where(s > 0, s, 1.0)
    t_safe = torch.where(t > 0, t, 1.0)
    interior = ((s > 0) & (t > 0)
                & (torch.log(s_safe) + r / s_safe <= torch.log(t_safe)))
    boundary = (s == 0) & (r <= 0) & (t >= 0)
    return interior | boundary


def _in_polar(r, s, t):
    """v0 in polar(Kexp), i.e. -v0 in Kexp*:
    log(-u) + v/u <= 1 + log(w) with (u, v, w) = -v0."""
    u, v, w = -r, -s, -t
    nu_safe = torch.where(u < 0, -u, 1.0)
    w_safe = torch.where(w > 0, w, 1.0)
    interior = (u < 0) & (w > 0) & (
        torch.log(nu_safe) + v / torch.where(u < 0, u, -1.0)
        <= 1.0 + torch.log(w_safe))
    boundary = (u == 0) & (v >= 0) & (w >= 0)
    return interior | boundary


def _rho_cap(dtype) -> float:
    """Bracket cap: beyond it quad ~ rho^2 overflows (f32) and exp(+-rho)
    has long over/underflowed, so the root sits on the x2 = 0 edge."""
    return 1e150 if dtype == torch.float64 else 1e9


def _hard_case_root(r, s, t):
    """Root of h on the interval where x2 > 0 and the multiplier mu > 0:
    ``(rho-1) r + s > 0`` and ``r - rho s > 0``.

    The bracket ends travel stacked as one (2, ...) tensor through the
    expansion (one evaluation of h for both ends), and only the signs of h
    at the ends are carried: the arithmetic is the JAX package's, in fewer
    kernels."""
    inf = math.inf
    lb1 = torch.where(r > 0, 1.0 - s / torch.where(r > 0, r, 1.0), -inf)
    ub1 = torch.where(r < 0, 1.0 - s / torch.where(r < 0, r, 1.0), inf)
    lb2 = torch.where(s < 0, r / torch.where(s < 0, s, 1.0), -inf)
    ub2 = torch.where(s > 0, r / torch.where(s > 0, s, 1.0), inf)
    cap = _rho_cap(r.dtype)
    lb_raw = torch.maximum(lb1, lb2)
    ub_raw = torch.minimum(ub1, ub2)
    lb = torch.clamp(lb_raw, -cap, cap)
    ub = torch.clamp(ub_raw, -cap, cap)
    lb_finite = torch.isfinite(lb_raw)
    ub_finite = torch.isfinite(ub_raw)
    lo = torch.where(lb_finite, lb, torch.where(ub_finite, ub - 1.0, -1.0))
    hi = torch.where(ub_finite, ub, torch.where(lb_finite, lb + 1.0, 1.0))

    # expand the unbounded end(s) geometrically until a sign change is
    # bracketed; finite feasibility ends stay where they are.  Row 0 is the
    # low end (moves down, clamped at -cap), row 1 the high end (up, cap).
    ends = torch.stack([lo, hi])
    grow = torch.stack([~lb_finite, ~ub_finite])
    sgn = torch.sign(_h_sign(ends, r, s, t))
    one = torch.ones_like(r)
    down_up = torch.stack([-one, one])
    width = 1.0
    for _ in range(_EXPANSION_ITERS):
        no_bracket = sgn[0] == sgn[1]
        moved = torch.clamp(ends + down_up * width, -cap, cap)
        ends = torch.where(no_bracket & grow, moved, ends)
        sgn = torch.where(no_bracket, torch.sign(_h_sign(ends, r, s, t)), sgn)
        width *= 2.0
    lo, hi = ends[0], ends[1]
    s_lo = sgn[0]

    # bisection, keeping sign(h(lo)) != sign(h(hi))
    for _ in range(_BISECTION_ITERS):
        mid = 0.5 * (lo + hi)
        s_mid = torch.sign(_h_sign(mid, r, s, t))
        go_right = s_mid == s_lo
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
        s_lo = torch.where(go_right, s_mid, s_lo)
    rho = 0.5 * (lo + hi)

    # Newton polish, clamped to the bracket
    for _ in range(_NEWTON_ITERS):
        h, g = _h_and_grad(rho, r, s, t)
        new = torch.minimum(torch.maximum(
            rho - h / torch.where(g != 0, g, 1.0), lo), hi)
        rho = torch.where(torch.isfinite(new), new, rho)
    return rho


def _fused_mul_add(a, b, c):
    """a b + c rounded once, as a fused multiply-add: Dekker's exact product
    (Veltkamp splitting) adds the product's rounding error back, so that a
    cancelling sum keeps its sign and size.  Where the split overflows, the
    plain value is kept."""
    p = a * b
    split = 134217729.0 if a.dtype == torch.float64 else 4097.0

    def halves(x):
        big = split * x
        hi = big - (big - x)
        return hi, x - hi

    ah, al = halves(a)
    bh, bl = halves(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    fused = (p + c) + err
    return torch.where(torch.isfinite(err), fused, p + c)


def project_exp(v):
    """Project ``v`` (..., 3), blocks ``(r, s, t)`` along the last axis,
    onto Kexp."""
    r, s, t = v[..., 0], v[..., 1], v[..., 2]
    in_primal = _in_primal(r, s, t)
    in_polar = _in_polar(r, s, t)
    special = (r <= 0) & (s <= 0)
    # the hard case runs on every block; where it does not apply it sees a
    # safe dummy input, so no NaN reaches the where() below
    hard = ~(in_primal | in_polar | special)
    rh = torch.where(hard, r, 0.0)
    sh = torch.where(hard, s, 1.0)
    th = torch.where(hard, t, -1.0)
    rho = _hard_case_root(rh, sh, th)
    quad = rho * (rho - 1.0) + 1.0
    # x2 = ((rho - 1) r + s) / quad and z = x2 e^rho (the JAX package's
    # formula), or, by the multiplier's stationarity, z = t + mu with
    # mu = (r - rho s) e^(-rho) / quad; the two agree at the root.  Near the
    # x2 = 0 edge (r -> 0+, s < 0: the root sits on the bracket end
    # 1 - s/r) the numerator of x2 cancels to rounding noise, which e^rho
    # then multiplies (z came out 0, or 1e172 in f64).  Where that
    # cancellation costs more than 1e-6 of z and t + mu is better
    # conditioned, z = t + mu (its e^(-rho) underflows to the right limit)
    # and x2 = z e^(-rho) keeps the point on the cone's boundary: p ->
    # (0, 0, max(t, 0)).  The JAX package switches only where e^rho
    # overflows; below that its result in this regime turns on how its
    # compiler rounds the numerator.
    num = _fused_mul_add(rho - 1.0, rh, sh)
    log_max = _log_max(v.dtype)
    mu = (rh - rho * sh) * torch.exp(-torch.abs(rho)) / quad
    z_mu = torch.clamp_min(th + mu, 0.0)
    eps = float(torch.finfo(v.dtype).eps)
    # error bounds of the two, relative: eps times the cancellation factor
    err_x2 = eps * (torch.abs((rho - 1.0) * rh) + torch.abs(sh)) / torch.abs(
        num)
    err_mu = eps * (torch.abs(th) + torch.abs(mu)) / torch.abs(th + mu)
    by_mu = ((rho > log_max) | ~(num > 0)
             | ((err_x2 > 1e-6) & (err_mu < err_x2)))
    x2 = torch.where(by_mu & (rho > 0),
                     z_mu * torch.exp(-torch.clamp_min(rho, 0.0)),
                     torch.clamp_min(num / quad, 0.0))
    z_hard = torch.where(by_mu, z_mu,
                         x2 * torch.exp(torch.clamp_max(rho, log_max)))
    p_hard = torch.stack([rho * x2, x2, z_hard], dim=-1)
    p_special = torch.stack([r, torch.zeros_like(s), torch.clamp_min(t, 0.0)],
                            dim=-1)
    return torch.where(in_primal[..., None], v,
                       torch.where(in_polar[..., None], torch.zeros_like(v),
                                   torch.where(special[..., None], p_special,
                                               p_hard)))


def project_exp_dual(v):
    """Project onto Kexp* by Moreau: P_{K*}(v) = v + P_K(-v)."""
    return v + project_exp(-v)


def _log_max(dtype) -> float:
    """0.98 log(max finite) computed in ``dtype``, as the JAX package does."""
    f = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return float(f(0.98) * np.log(np.finfo(f).max))
