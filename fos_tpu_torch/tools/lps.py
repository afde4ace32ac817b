"""Nondegenerate LPs with a known optimum, the oracle of the gradient
checks (``tests/test_diff.py``'s ``_lp`` with kx = ky = k).

``min c'x  s.t.  Ax + s = b, s >= 0, x >= 0`` built from a primal-dual
pair (x0, y0) on k columns and k rows, with strictly complementary slacks,
so that the optimum is unique and the envelope identities hold:
``d(c'x*)/dc = x0``, ``d(c'x*)/db = -y0``, ``d(c'x*)/dA = y0 x0'``.
"""

from __future__ import annotations

import numpy as np


def nondegenerate_lp(rng, m, n, k):
    """``(A, b, c, x0, y0)`` in f64 from the numpy generator ``rng``: A
    (m, n) standard normal, x0 and y0 on k random columns and rows, every
    nonzero magnitude ``|N(0, 1)| + 0.1``."""
    A = rng.standard_normal((m, n))
    xmask = np.zeros(n, bool)
    xmask[rng.choice(n, k, replace=False)] = True
    ymask = np.zeros(m, bool)
    ymask[rng.choice(m, k, replace=False)] = True

    def mag(size):
        return np.abs(rng.standard_normal(size)) + 0.1

    x0, r0 = mag(n) * xmask, mag(n) * ~xmask
    y0, s0 = mag(m) * ymask, mag(m) * ~ymask
    return A, A @ x0 + s0, r0 - A.T @ y0, x0, y0


def orthogonal_basis_lp(rng, m, n, k):
    """The same construction with a well-conditioned optimal basis: A (m,
    n) is N(0, 1/n) except its basis block (the k rows and k columns of
    the optimum), a random orthogonal k x k matrix.  The k x k Gaussian
    block of :func:`nondegenerate_lp` is ill-conditioned (its condition
    number grows with k), and DR on the HSDE then creeps toward the
    optimum (from 64x96 up it stays ~1e-3 away after 60000 iterations, in
    both packages); with an orthogonal block it reaches the fixed point in
    a few hundred iterations.  ``(A, b, c, x0, y0)`` in f64."""
    xmask = np.zeros(n, bool)
    xmask[rng.choice(n, k, replace=False)] = True
    ymask = np.zeros(m, bool)
    ymask[rng.choice(m, k, replace=False)] = True
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    A[np.ix_(ymask, xmask)] = np.linalg.qr(rng.standard_normal((k, k)))[0]

    def mag(size):
        return np.abs(rng.standard_normal(size)) + 0.1

    x0, r0 = mag(n) * xmask, mag(n) * ~xmask
    y0, s0 = mag(m) * ymask, mag(m) * ~ymask
    return A, A @ x0 + s0, r0 - A.T @ y0, x0, y0
