"""fos_tpu_torch: the fos_tpu conic solver ported to PyTorch and CUDA.

The same DR/HSDE solve as the JAX package ``fos_tpu``, with the fused
``(A @ x, A' @ z)`` pair carried by hand-written CUDA kernels for Hopper
(``csrc/pair_kernels.cu``): dense A (``solve(..., pallas=True)``), banded
and blocked-ELL tile tables (:class:`BandedBlockOp`, :class:`BlockedEllOp`).
On the CPU the same functions run in plain PyTorch.  This package imports
neither jax nor fos_tpu.

    from fos_tpu_torch import solve, DR, nonneg
    sol = solve(A, b, c, nonneg(m), nonneg(n), alg=DR(), eps=1e-5,
                dtype=torch.float32, pallas=True, device="cuda")
"""

from fos_tpu_torch import config as config  # noqa: F401  (pins full-f32 matmuls)

from fos_tpu_torch.cones import (  # noqa: F401
    Cone,
    ConeSpec,
    free,
    nonneg,
    nonpos,
    project,
    project_dual,
    rotated_soc,
    soc,
    zero,
)
from fos_tpu_torch.solvers import AP, DR, GAP, Status  # noqa: F401
from fos_tpu_torch.problems import ConicProblem, Solution, conic_problem  # noqa: F401
from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp, BlockedEllOp  # noqa: F401
from fos_tpu_torch.interface import solve  # noqa: F401

__version__ = "0.1.0"
