"""Conic problem container.

``min c'x  s.t.  Ax + s = b, s in K1, x in K2``.  ``A`` may be a dense
tensor, a scipy.sparse matrix (kept as scipy until
:meth:`fos_tpu_torch.problems.hsde.HSDEForm.build` picks its format) or an
operator with ``mv_pair`` (the sparse tile operators), which passes through.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from fos_tpu_torch.cones.spec import ConeSpec
from fos_tpu_torch.config import as_tensor


@dataclasses.dataclass(frozen=True)
class ConicProblem:
    A: Any
    b: torch.Tensor
    c: torch.Tensor
    K1: ConeSpec
    K2: ConeSpec

    def __post_init__(self):
        m, n = self.A.shape
        if tuple(self.b.shape) != (m,):
            raise ValueError(f"b must have shape ({m},), got {tuple(self.b.shape)}")
        if tuple(self.c.shape) != (n,):
            raise ValueError(f"c must have shape ({n},), got {tuple(self.c.shape)}")
        if self.K1.dim != m:
            raise ValueError(f"K1 must cover {m} rows, covers {self.K1.dim}")
        if self.K2.dim != n:
            raise ValueError(f"K2 must cover {n} variables, covers {self.K2.dim}")

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]


def _is_operator(A) -> bool:
    return hasattr(A, "mv_pair")


def conic_problem(A, b, c, K1: ConeSpec, K2: ConeSpec, *, device=None,
                  dtype=None) -> ConicProblem:
    """Build a :class:`ConicProblem` on ``device``.  scipy.sparse ``A`` stays
    scipy (cast to ``dtype``); operator ``A`` passes through as it is."""
    import scipy.sparse as sp

    if sp.issparse(A):
        if dtype is not None:
            A = A.astype(np.dtype(str(dtype).replace("torch.", "")))
    elif not _is_operator(A):
        A = as_tensor(A, dtype, device)
    return ConicProblem(A=A, b=as_tensor(b, dtype, device),
                        c=as_tensor(c, dtype, device), K1=K1, K2=K2)
