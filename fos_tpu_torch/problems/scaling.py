"""Ruiz equilibration of conic problem data, on the host in numpy.

Diagonal scalings ``Ahat = D A E`` drive the row and column infinity-norms
of A toward 1, with the scaling held constant inside every
non-elementwise cone block (an SOC, PSD, exponential or power slack must
be scaled uniformly to stay in its cone).

The scaled problem is ``min (Ec)'xh  s.t.  (DAE) xh + sh = Db``, with
``x = E xh``, ``y = D yh``, ``s = D^{-1} sh``; the objective values are
preserved (``(Ec)'xh = c'x``).  The convergence check weighs the residuals
with ``D^{-1}`` and ``E^{-1}`` so that termination measures the original
problem (:meth:`fos_tpu_torch.problems.hsde.HSDEForm.check`).

A copy of ``fos_tpu.problems.scaling``: the same arithmetic, so that both
packages scale a problem to the same bits.  Ruiz keeps the sparsity
pattern, so a scaled scipy A still packs into the tile operators.
"""

from __future__ import annotations

import numpy as np

from fos_tpu_torch.cones.spec import ConeSpec, is_elementwise


def _block_average(scale, spec: ConeSpec):
    """Hold the scaling constant (its mean) within non-elementwise blocks."""
    out = np.asarray(scale).copy()
    off = 0
    for cone, d in spec.blocks:
        if not is_elementwise(cone):
            out[off: off + d] = out[off: off + d].mean()
        off += d
    return out


def ruiz_equilibrate(A, b, c, K1: ConeSpec, K2: ConeSpec, *, iters: int = 10,
                     min_scale: float = 1e-4, max_scale: float = 1e4):
    """Dense A: returns ``(A_s, b_s, c_s, d, e)`` with ``A_s = diag(d) A
    diag(e)``, ``b_s = d * b``, ``c_s = e * c``, all f64."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    m, n = A.shape
    d = np.ones(m)
    e = np.ones(n)
    As = A.copy()
    for _ in range(iters):
        row = np.max(np.abs(As), axis=1)
        col = np.max(np.abs(As), axis=0)
        dr = 1.0 / np.sqrt(np.where(row > 0, row, 1.0))
        dc = 1.0 / np.sqrt(np.where(col > 0, col, 1.0))
        dr = _block_average(dr, K1)
        dc = _block_average(dc, K2)
        d *= dr
        e *= dc
        d = np.clip(d, min_scale, max_scale)
        e = np.clip(e, min_scale, max_scale)
        As = (A * d[:, None]) * e[None, :]
    return As, d * b, e * c, d, e


def ruiz_equilibrate_sparse(A, b, c, K1: ConeSpec, K2: ConeSpec, *,
                            iters: int = 10, min_scale: float = 1e-4,
                            max_scale: float = 1e4):
    """scipy.sparse A: the same scaling as :func:`ruiz_equilibrate` over the
    nonzeros only (A is never densified); the scaled matrix comes back as
    CSR."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    m, n = A.shape
    d = np.ones(m)
    e = np.ones(n)
    As = A.copy()
    for _ in range(iters):
        absA = abs(As)
        row = absA.max(axis=1).toarray().ravel()
        col = absA.max(axis=0).toarray().ravel()
        dr = 1.0 / np.sqrt(np.where(row > 0, row, 1.0))
        dc = 1.0 / np.sqrt(np.where(col > 0, col, 1.0))
        dr = _block_average(dr, K1)
        dc = _block_average(dc, K2)
        d = np.clip(d * dr, min_scale, max_scale)
        e = np.clip(e * dc, min_scale, max_scale)
        As = sp.csr_matrix(sp.diags(d) @ A @ sp.diags(e))
    return As, d * b, e * c, d, e
