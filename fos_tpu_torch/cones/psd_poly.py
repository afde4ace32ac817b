"""Factorization-free PSD projection by polynomial filtering.

    P_{S+}(X) = (X + |X|) / 2,     |X| = X sign(X)

with ``sign`` approximated by a matrix polynomial: X is scaled so that its
spectrum lies in [-1, 1], then a fixed schedule of quintic Newton-Schulz
steps (``z <- a z + b z^3 + c z^5``, which expands small |z| fast while
keeping |z| <= 1) and cubic polishing steps drives every eigenvalue to
+-1.  Every operation is a batched matrix product, so the projection is
``torch.matmul`` alone: no factorisation, no host read, and it can be
captured in a CUDA graph.  A copy of ``fos_tpu.cones.psd_poly``.

Accuracy: eigenvalues with |lambda| >= ~1e-4 ||X||_2 are classified
essentially exactly; smaller ones contribute at most their own magnitude
to the error.  The products must run in full f32: ``fos_tpu_torch.config``
turns TF32 off (at the TPU's default bf16 matmul inputs the JAX package
measured about 1e-2 relative error).
"""

from __future__ import annotations

import numpy as np
import torch

import fos_tpu_torch.config  # noqa: F401  (pins full-f32 matmuls)

#: the uniform schedule's quintic coefficients
_QUINTIC = (3.4445, -4.7750, 2.0315)
#: the uniform schedule's usual step counts (chip_smoke.py times it at these)
UNIFORM_QUINTICS, UNIFORM_CUBICS = 10, 12

# The tuned schedule: each quintic maximises the post-step lower bound over
# the current spectrum interval subject to max p <= 0.9999, starting from
# [1e-4, 1]; two cubic steps finish to |f(z) - 1| <= 1e-13.  9 quintics + 2
# cubics = 31 products against the uniform schedule's 10 + 12 = 54, at the
# same classification threshold (the JAX package's design, round 5).
_SCHEDULE = np.array([
    (3.346018, -6.177797, 2.993520),
    (3.347131, -6.184793, 3.002299),
    (3.259782, -5.968771, 3.709233),
    (3.394741, -6.413290, 3.037562),
    (3.707931, -8.532502, 5.699246),
    (3.721769, -8.566419, 5.461109),
    (3.581464, -7.764542, 5.178028),
    (2.197576, -1.888380, 0.625264),
    (2.005234, -1.523195, 0.517864),
])
_SCHEDULE_CUBICS = 2
#: power-iteration steps of the spectral bound
POWER_ITERS = 8

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _coef(v, dtype) -> float:
    """A coefficient rounded to ``dtype`` first, as the JAX package casts
    its coefficient table, then passed as a Python scalar (no host copy)."""
    return float(_NP_DTYPE[dtype](v))


def _matrix_sign(Y, quintic_iters=None, cubic_iters=None):
    """sign(Y) for a symmetric Y with spectrum in [-1, 1].  Without
    ``quintic_iters`` the tuned schedule (``cubic_iters`` alone is ignored,
    as the JAX package ignores it); with it the uniform schedule of
    ``quintic_iters`` quintics and ``cubic_iters`` cubics, which must then
    be given too (the JAX package fails inside its scan without it)."""
    if quintic_iters is None:
        coefs, cubics = _SCHEDULE, _SCHEDULE_CUBICS
    else:
        if cubic_iters is None:
            raise ValueError(
                "psd_project_poly: quintic_iters selects the uniform "
                "schedule and needs cubic_iters too (e.g. quintic_iters="
                f"{UNIFORM_QUINTICS}, cubic_iters={UNIFORM_CUBICS})")
        coefs = np.tile(np.asarray(_QUINTIC)[None], (quintic_iters, 1))
        cubics = cubic_iters
    Z = Y
    for a, b, c in coefs:
        Z2 = torch.matmul(Z, Z)
        Z3 = torch.matmul(Z2, Z)
        Z5 = torch.matmul(Z2, Z3)
        dt = Y.dtype
        Z = _coef(a, dt) * Z + _coef(b, dt) * Z3 + _coef(c, dt) * Z5
    for _ in range(cubics):
        Z = 1.5 * Z - 0.5 * torch.matmul(torch.matmul(Z, Z), Z)
    return Z


def _spectral_bound(X, iters: int = POWER_ITERS):
    """Upper estimate of ||X||_2: ``1.1`` times a power iteration on X^2,
    clipped by the Frobenius norm (scaling by the loose Frobenius bound
    alone shrinks the spectrum by ~sqrt(d) and starves the sign iteration
    of small eigenvalues).  Shape (..., 1, 1)."""
    d = X.shape[-1]
    fro = torch.linalg.norm(X, dim=(-2, -1), keepdim=True)
    v = torch.full((*X.shape[:-1], 1), 1.0 / float(np.sqrt(d)),
                   dtype=X.dtype, device=X.device)
    for _ in range(iters):
        w = torch.matmul(X, torch.matmul(X, v))  # X^2 v: |lambda|_max
        v = w / torch.clamp_min(
            torch.linalg.norm(w, dim=(-2, -1), keepdim=True), 1e-30)
    lam = torch.linalg.norm(torch.matmul(X, v), dim=(-2, -1), keepdim=True)
    est = torch.minimum(1.1 * lam, fro)
    return torch.where(est > 0, est, torch.ones_like(est))


def psd_project_poly(X, *, quintic_iters=None, cubic_iters=None):
    """Project symmetric ``X`` (..., d, d) onto the PSD cone with matrix
    products only; the dtype of X is kept.  Default: the tuned 31-product
    schedule; giving ``quintic_iters`` (with ``cubic_iters``) selects the
    uniform schedule (:func:`_matrix_sign`)."""
    R = _spectral_bound(X)
    Z = _matrix_sign(X / R, quintic_iters, cubic_iters)
    absX = torch.matmul(X, Z)  # |X| up to the sign error (X and Z commute)
    Xp = 0.5 * (X + absX)
    # symmetrise: the iteration keeps symmetry only up to rounding
    return 0.5 * (Xp + Xp.mT)
