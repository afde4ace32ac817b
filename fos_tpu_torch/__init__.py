"""fos_tpu_torch: the fos_tpu conic solver ported to PyTorch and CUDA.

The same solves as the JAX package ``fos_tpu``, on the card unless the
caller asks for the CPU (``device="cpu"``):

* the DR/HSDE conic solve, ``solve``, with the fused ``(A @ x, A' @ z)``
  pair carried by hand-written CUDA kernels for Hopper
  (``csrc/pair_kernels.cu``): dense A (``solve(..., pallas=True)``), banded
  and blocked-ELL tile tables (:class:`BandedBlockOp`,
  :class:`BlockedEllOp`);
* the set-feasibility solve, ``solve_feasibility``, with the GAP family
  (GAP, DR, AP, GAPA, GAPP, FISTA, Dykstra), the sets library and
  :class:`AffinePlusLinearProjector`, whose CG runs the tile operators'
  single products through hand-written kernels (``csrc/tile_mv.cu``);
* the wrappers (:class:`LineSearchWrapper`, :class:`AndersonWrapper`,
  :class:`LongstepWrapper`), the batched solve (``build_batched_form``,
  ``solve_batched``) and the f64 refinement sweep (``solve(...,
  refine=N)``);
* implicit differentiation of the conic solve, :func:`diff_solve`: reverse
  and forward mode through the DR/GAP fixed point, with K1's derivative
  rules (``linalg/dense_pair.DensePairFn``) on the card;
* the front end: the MathProgBase-style and SCS-style entry points
  (:func:`load_problem`, :func:`solve_scs`, :func:`solve_lp`), the modeling
  DSL (:class:`Variable`, :class:`Problem`, :func:`minimize`, the atoms;
  ``fos_tpu_torch.modeling``), the CVXPY seam (:func:`solve_conic_data`,
  :func:`register_with_cvxpy`), checkpoints (``utils/checkpoint.py``) and
  the examples (``fos_tpu_torch/examples``).  Options such as
  ``dtype=torch.float32`` and ``pallas=True`` pass through to ``solve``.

On CPU tensors the same functions run their plain PyTorch versions.  This
package imports neither jax nor fos_tpu.

    from fos_tpu_torch import solve, DR, nonneg
    sol = solve(A, b, c, nonneg(m), nonneg(n), alg=DR(), eps=1e-5,
                dtype=torch.float32, pallas=True)

    from fos_tpu_torch import Problem, Variable, minimize, norm1, sum_squares
    x = Variable(n)
    prob = Problem(minimize(0.5 * sum_squares(A @ x - b) + lam * norm1(x)))
    prob.solve(alg=DR(), eps=1e-5, dtype=torch.float32, pallas=True)
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
from fos_tpu_torch.solvers import (  # noqa: F401
    AP, DR, FISTA, GAP, GAPA, GAPP, AndersonWrapper, Dykstra,
    LineSearchWrapper, LongstepWrapper, Status)
from fos_tpu_torch.problems import ConicProblem, Solution, conic_problem  # noqa: F401
from fos_tpu_torch.problems.feasibility import Feasibility  # noqa: F401
from fos_tpu_torch.linalg.affine import AffinePlusLinearProjector  # noqa: F401
from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp, BlockedEllOp  # noqa: F401
from fos_tpu_torch.sets import (  # noqa: F401
    AffineSet, Ball, BlockSet, Box, ConeSet, FunctionSet, Halfspace, NonNeg,
    NonPos, Point)
from fos_tpu_torch.interface import (  # noqa: F401
    load_problem, register_with_cvxpy, solve, solve_conic_data,
    solve_feasibility, solve_lp, solve_scs, supported_cones)
from fos_tpu_torch.parallel.batched import (  # noqa: F401
    build_batched_form, form_initial_value, solve_batched)
from fos_tpu_torch.diff import diff_solve  # noqa: F401
from fos_tpu_torch.modeling import (  # noqa: F401
    ExpCone, PowCone, Problem, Variable, maximize, minimize, norm1, norm2,
    norm_inf, quad_form, sum_squares, trace)

__version__ = "0.1.0"
