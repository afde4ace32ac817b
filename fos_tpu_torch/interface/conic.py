"""Conic-model front end: MathProgBase-style and SCS-style entry points.

Problems arrive as ``(c, A, b, constr_cones, var_cones)``, where each cone
list holds ``(cone, indices)`` pairs as in MathProgBase; the index runs are
checked for contiguous, in-order, full coverage (the checks of the
reference's ``ConeProduct`` constructor) and the cone names map through
:data:`CONE_MAP` (the reference's ``conemap``).  :func:`solve_scs` takes
SCS-format data (all variables free, the cone structure in the slack rows),
which any modeling layer that targets SCS emits, and :func:`solve_lp` is
the LP bridge.

Every solve runs on the card unless given ``device="cpu"``; the other
options (``dtype``, ``pallas``, ``sparse_format``, ``densify``, ...) pass
through to :func:`fos_tpu_torch.interface.api.solve` unchanged.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple, Union

import numpy as np

from fos_tpu_torch.cones.spec import Cone, ConeSpec

# the reference's conemap (cones.jl:4-14)
CONE_MAP = {
    "Free": Cone.FREE,
    "Zero": Cone.ZERO,
    "NonNeg": Cone.NONNEG,
    "NonPos": Cone.NONPOS,
    "SOC": Cone.SOC,
    "SOCRotated": Cone.SOC_ROTATED,
    "SDP": Cone.PSD,
    "ExpPrimal": Cone.EXP_PRIMAL,
    "ExpDual": Cone.EXP_DUAL,
}


def supported_cones() -> Tuple[str, ...]:
    """The cone names :func:`load_problem` accepts (``supportedcones``)."""
    return tuple(CONE_MAP)


def _to_cone(cone: Union[str, Cone]) -> Cone:
    if isinstance(cone, Cone):
        return cone
    if cone not in CONE_MAP:
        raise ValueError(
            f"Cone type {cone!r} not supported; supported: {supported_cones()}")
    return CONE_MAP[cone]


def cone_spec_from_list(dim: int,
                        cones: Iterable[Tuple[Union[str, Cone], Sequence[int]]]
                        ) -> ConeSpec:
    """A ConeSpec from MathProgBase-style ``(cone, indices)`` pairs.

    Each index list must be a contiguous run, and the runs must tile
    ``range(dim)`` in order (the reference's cones.jl:43-77).
    """
    blocks = []
    expected_start = 0
    for cone, idx in cones:
        cone = _to_cone(cone)
        idx = np.asarray(list(idx))
        if idx.size == 0:
            raise ValueError("empty index range")
        if not np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
            raise ValueError(f"Invalid range in input: {idx}")
        if idx[0] != expected_start:
            raise ValueError(
                f"ranges must tile 0..{dim - 1} in order; got start {idx[0]}, "
                f"expected {expected_start}")
        expected_start = int(idx[-1]) + 1
        blocks.append((cone, int(idx.size)))
    if expected_start != dim:
        raise ValueError(f"ranges cover 0..{expected_start - 1}, need 0..{dim - 1}")
    return ConeSpec(tuple(blocks))


def load_problem(c, A, b, constr_cones, var_cones, *, device=None):
    """``loadproblem!``: a :class:`ConicProblem` on ``device`` (the card
    unless given ``device="cpu"``).  A scipy.sparse ``A`` stays scipy, so
    that the form build picks its format (dense, tile table or torch
    sparse)."""
    from fos_tpu_torch.config import default_device
    from fos_tpu_torch.problems.conic import conic_problem

    A = np.asarray(A) if not hasattr(A, "todense") else A
    m, n = A.shape
    K1 = cone_spec_from_list(m, constr_cones)
    K2 = cone_spec_from_list(n, var_cones)
    return conic_problem(A, b, c, K1, K2, device=default_device(device))


def solve_scs(data: dict, cone: dict, alg=None, **options):
    """SCS-convention front end: ``data = {"A": ..., "b": ..., "c": ...}``,
    ``cone = {"z": n_zero, "l": n_nonneg, "q": [soc sizes], "s": [psd
    sides], "ep": n_exp_primal, "ed": n_exp_dual, "p": [pow exponents]}``
    with all variables free (SCS's convention: the cone structure lives in
    the slack s).  Power-cone exponents follow SCS: ``a > 0`` is a primal
    3-D power cone with exponent ``a``, ``a < 0`` the dual cone with
    ``|a|``.  ``options`` go to :func:`~fos_tpu_torch.interface.api.solve`.
    """
    from fos_tpu_torch.cones.spec import free
    from fos_tpu_torch.interface.api import solve

    A = data["A"]
    b = data["b"]
    c = data["c"]
    m = A.shape[0]
    K1 = scs_cone_spec(cone)
    if K1.dim != m:
        raise ValueError(f"cone dims cover {K1.dim} rows, A has {m}")
    K2 = free(A.shape[1])
    return solve(A, b, c, K1, K2, alg=alg, **options)


def scs_cone_spec(cone: dict) -> ConeSpec:
    """The constraint ConeSpec of an SCS-style cone dict (row order z, l,
    q, s, ep, ed, p: SCS's convention); consecutive power cones of one kind
    merge into one block."""
    blocks = []
    if cone.get("z"):
        blocks.append((Cone.ZERO, int(cone["z"])))
    if cone.get("l"):
        blocks.append((Cone.NONNEG, int(cone["l"])))
    for q in cone.get("q", []) or []:
        blocks.append((Cone.SOC, int(q)))
    for s in cone.get("s", []) or []:
        blocks.append((Cone.PSD, int(s) * (int(s) + 1) // 2))
    if cone.get("ep"):
        blocks.append((Cone.EXP_PRIMAL, 3 * int(cone["ep"])))
    if cone.get("ed"):
        blocks.append((Cone.EXP_DUAL, 3 * int(cone["ed"])))
    params = tuple(() for _ in blocks)
    for a in cone.get("p", []) or []:
        a = float(a)
        if not 0.0 < abs(a) < 1.0:
            raise ValueError(f"power-cone exponent must have 0<|a|<1, got {a}")
        kind = Cone.POW_PRIMAL if a > 0 else Cone.POW_DUAL
        if blocks and blocks[-1][0] is kind:  # extend the run
            blocks[-1] = (kind, blocks[-1][1] + 3)
            params = params[:-1] + (params[-1] + (abs(a),),)
        else:
            blocks.append((kind, 3))
            params = params + ((abs(a),),)
    if any(params):
        return ConeSpec(tuple(blocks), params)
    return ConeSpec(tuple(blocks))


def solve_lp(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, *,
             nonneg: bool = True, alg=None, **options):
    """The LP bridge (the reference's ``ConicToLPQPBridge`` role):

        min c'x  s.t.  A_ub x <= b_ub,  A_eq x = b_eq,  x >= 0 (nonneg=True).

    A is stacked dense on the host in f64, as the JAX package does;
    ``options`` (``dtype``, ``pallas``, ``device``, ...) go to
    :func:`~fos_tpu_torch.interface.api.solve`.
    """
    from fos_tpu_torch.cones.spec import free, zero
    from fos_tpu_torch.cones.spec import nonneg as nonneg_cone
    from fos_tpu_torch.interface.api import solve

    c = np.asarray(c, dtype=float)
    n = c.shape[0]
    rows = []
    rhs = []
    k1 = []
    if A_eq is not None:
        A_eq = np.asarray(A_eq, dtype=float)
        rows.append(A_eq)
        rhs.append(np.asarray(b_eq, dtype=float))
        k1.append(zero(A_eq.shape[0]))
    if A_ub is not None:
        A_ub = np.asarray(A_ub, dtype=float)
        rows.append(A_ub)
        rhs.append(np.asarray(b_ub, dtype=float))
        k1.append(nonneg_cone(A_ub.shape[0]))
    if not rows:
        raise ValueError("need at least one of A_ub / A_eq")
    A = np.vstack(rows)
    b = np.concatenate(rhs)
    K1 = ConeSpec.concat(k1)
    K2 = nonneg_cone(n) if nonneg else free(n)
    return solve(A, b, c, K1, K2, alg=alg, **options)
