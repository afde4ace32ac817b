"""Projection onto the 3D power cone, vectorised over blocks.

    Kpow(a)  = { (x,y,z) : x >= 0, y >= 0, x^a y^(1-a) >= |z| }
    Kpow*(a) = { (u,v,w) : u >= 0, v >= 0, (u/a)^a (v/(1-a))^(1-a) >= |w| }

(SCS ordering, exponent a in (0, 1).)  A point in neither Kpow nor the
polar ``-Kpow*`` projects onto ``(x(r), y(r), sign(z) r)`` where r is the
root on (0, |z0|) of

    x(r) = (x0 + sqrt(x0^2 + 4 a r (|z0|-r))) / 2
    y(r) = (y0 + sqrt(y0^2 + 4 (1-a) r (|z0|-r))) / 2
    f(r) = x(r)^a y(r)^(1-a) - r,

positive left of the root and negative right of it (SCS's
``proj_power_cone``).  A fixed 96 bisection steps and 6 clamped Newton
steps run on every block at once (no data-dependent trip count, no host
read); the sign test runs in log space so that extreme magnitudes
classify exactly.  The exponents are a tensor, one per block.  A port of
``fos_tpu.cones.pow``.
"""

from __future__ import annotations

import torch

_BISECTION_ITERS = 96
_NEWTON_ITERS = 6


def _log_member(x, y, az, wx, wy, a):
    """(x/wx)^a (y/wy)^(1-a) >= az with x, y >= 0, in log space; ``wx = wy
    = 1`` tests Kpow(a), ``wx = a, wy = 1-a`` tests Kpow*(a)."""
    x_safe = torch.where(x > 0, x, 1.0)
    y_safe = torch.where(y > 0, y, 1.0)
    az_safe = torch.where(az > 0, az, 1.0)
    lhs = (a * (torch.log(x_safe) - torch.log(wx))
           + (1.0 - a) * (torch.log(y_safe) - torch.log(wy)))
    strict = (x > 0) & (y > 0) & (lhs >= torch.log(az_safe))
    return (x >= 0) & (y >= 0) & ((az <= 0) | strict)


class _Root:
    """The hard case's loop invariants.  x(r) and y(r) are computed
    together, stacked along a leading axis of 2: row 0 is x (start x0,
    weight a), row 1 is y (start y0, weight 1-a)."""

    def __init__(self, x0, y0, az, a):
        self.az = az
        self.w = torch.stack([a, 1.0 - a])           # (2, ...)
        self.start = torch.stack([x0, y0])
        self.start_sq = self.start * self.start
        self.start_pos = self.start > 0

    def xy(self, r):
        """(x(r), y(r)) stacked: (x0 + sqrt(x0^2 + 4 s)) / 2 with s =
        w r (az - r), in the conjugate form 2 s / (sqrt(...) - x0) for
        x0 <= 0 (no cancellation when 4 s << x0^2)."""
        s = self.w * (r * (self.az - r))
        disc = torch.sqrt(self.start_sq + 4.0 * s)
        direct = 0.5 * (self.start + disc)
        denom = disc - self.start
        ok = denom > 0
        conj = torch.where(ok, 2.0 * s / torch.where(ok, denom, 1.0), 0.0)
        return torch.where(self.start_pos, direct, conj)

    def f_log(self, r, xy=None):
        """a log x(r) + (1-a) log y(r) - log r: the sign of f(r), overflow-
        safe."""
        xy = self.xy(r) if xy is None else xy
        lxy = self.w * torch.log(torch.where(xy > 0, xy, 1e-30))
        return (lxy[0] + lxy[1]) - torch.log(torch.where(r > 0, r, 1e-30))

    def f_log_grad(self, r, xy):
        d = self.az - 2.0 * r
        q = self.start_sq + 4.0 * self.w * r * (self.az - r)
        dxy = self.w * d / torch.sqrt(torch.where(q > 0, q, 1.0))
        t = self.w * dxy / torch.where(xy > 0, xy, 1e-30)
        return (t[0] + t[1]) - 1.0 / torch.where(r > 0, r, 1e-30)


def _hard_case_r(x0, y0, az, a):
    """Root of f on (0, az): bisection, then Newton clamped to the
    bracket."""
    root = _Root(x0, y0, az, a)
    lo = torch.zeros_like(az)
    hi = az
    for _ in range(_BISECTION_ITERS):
        mid = 0.5 * (lo + hi)
        pos = root.f_log(mid) > 0
        lo = torch.where(pos, mid, lo)
        hi = torch.where(pos, hi, mid)
    r = 0.5 * (lo + hi)
    for _ in range(_NEWTON_ITERS):
        xy = root.xy(r)
        g = root.f_log_grad(r, xy)
        step = root.f_log(r, xy) / torch.where(g != 0, g, 1.0)
        new = torch.minimum(torch.maximum(r - step, lo), hi)
        r = torch.where(torch.isfinite(new), new, r)
    return r, root


def project_pow(v, a):
    """Project ``v`` (..., k, 3) onto Kpow(a) block by block; ``a`` (k,) is
    each block's exponent (broadcast over leading axes)."""
    x0, y0, z0 = v[..., 0], v[..., 1], v[..., 2]
    a = a.to(v.dtype).expand_as(x0)
    az = torch.abs(z0)
    one = torch.ones_like(a)
    in_primal = _log_member(x0, y0, az, one, one, a)
    # polar(Kpow(a)) = -Kpow*(a)
    in_polar = _log_member(-x0, -y0, az, a, 1.0 - a, a)
    degenerate = az <= 0  # z = 0: the orthant clip
    hard = ~(in_primal | in_polar | degenerate)
    # safe dummies keep the root finder free of NaN where it does not apply
    xh = torch.where(hard, x0, -1.0)
    yh = torch.where(hard, y0, -1.0)
    azh = torch.where(hard, az, 1.0)
    r, root = _hard_case_r(xh, yh, azh, a)
    xr, yr = root.xy(r)
    p_hard = torch.stack([xr, yr, torch.sign(z0) * r], dim=-1)
    p_clip = torch.stack([torch.clamp_min(x0, 0.0), torch.clamp_min(y0, 0.0),
                          torch.zeros_like(z0)], dim=-1)
    return torch.where(in_primal[..., None], v,
                       torch.where(in_polar[..., None], torch.zeros_like(v),
                                   torch.where(degenerate[..., None], p_clip,
                                               p_hard)))


def project_pow_dual(v, a):
    """Project onto Kpow*(a) by Moreau: P_{K*}(v) = v + P_K(-v)."""
    return v + project_pow(-v, a)
