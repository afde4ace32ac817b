"""Cone specifications (a copy of ``fos_tpu.cones.spec``, which is pure
Python but cannot be imported without jax).

A :class:`ConeSpec` is the static, hashable description of a product of
cones, mirroring the role of FirstOrderSolvers.jl's ``ConeProduct``
(src/cones.jl:31-77): an ordered tuple of ``(Cone, dim)`` blocks that tile
a vector of length ``spec.dim``.  It is compiled once by
:mod:`fos_tpu_torch.cones.project` into a single fused projection pass.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, Tuple


class Cone(enum.Enum):
    """Supported cone types.

    Mirrors the reference's cone registry ``conemap``
    (FirstOrderSolvers.jl src/cones.jl:4-14): Free, Zero, NonNeg, NonPos, SOC,
    SOCRotated, SDP (scaled svec layout), ExpPrimal, ExpDual.
    """

    FREE = "free"
    ZERO = "zero"
    NONNEG = "nonneg"
    NONPOS = "nonpos"
    SOC = "soc"
    SOC_ROTATED = "soc_rotated"
    PSD = "psd"  # svec (scaled, lower-triangular column-stacked) layout
    EXP_PRIMAL = "exp_primal"
    EXP_DUAL = "exp_dual"
    # 3D power cones (beyond the reference's registry; SCS's "p" cones):
    #   POW(a)  = {(x,y,z): x,y >= 0, x^a * y^(1-a) >= |z|},  a in (0,1)
    #   POW*(a) = {(u,v,w): u,v >= 0, (u/a)^a * (v/(1-a))^(1-a) >= |w|}
    # Parameterized: the per-3-block exponents live in ConeSpec.params.
    POW_PRIMAL = "pow_primal"
    POW_DUAL = "pow_dual"


# Dual cone of each cone type.  Self-dual: NONNEG, NONPOS(= -NONNEG, dual is
# itself under <.,.>? dual of NONPOS is NONPOS), SOC, rotated SOC, PSD.
# FREE* = {0}, ZERO* = FREE, (ExpPrimal)* = ExpDual and vice versa.
# This mirrors the reference's special-cased duals at src/cones.jl:97-102
# plus the Moreau-identity fallback (src/cones.jl:80-85).
_DUAL = {
    Cone.FREE: Cone.ZERO,
    Cone.ZERO: Cone.FREE,
    Cone.NONNEG: Cone.NONNEG,
    Cone.NONPOS: Cone.NONPOS,
    Cone.SOC: Cone.SOC,
    Cone.SOC_ROTATED: Cone.SOC_ROTATED,
    Cone.PSD: Cone.PSD,
    Cone.EXP_PRIMAL: Cone.EXP_DUAL,
    Cone.EXP_DUAL: Cone.EXP_PRIMAL,
    Cone.POW_PRIMAL: Cone.POW_DUAL,
    Cone.POW_DUAL: Cone.POW_PRIMAL,
}

_PARAMETERIZED = frozenset({Cone.POW_PRIMAL, Cone.POW_DUAL})

_ELEMENTWISE = frozenset({Cone.FREE, Cone.ZERO, Cone.NONNEG, Cone.NONPOS})


def dual_cone(cone: Cone) -> Cone:
    return _DUAL[cone]


def is_elementwise(cone: Cone) -> bool:
    return cone in _ELEMENTWISE


def psd_side_from_len(length: int) -> int:
    """Side d of the symmetric matrix stored in an svec block of ``length``.

    length = d(d+1)/2.
    """
    d = int(round((-1 + (1 + 8 * length) ** 0.5) / 2))
    if d * (d + 1) // 2 != length:
        raise ValueError(f"invalid svec length {length}: not d(d+1)/2")
    return d


@dataclass(frozen=True)
class ConeSpec:
    """An ordered product of cones tiling a vector.

    ``blocks`` is a tuple of ``(Cone, dim)`` pairs; block ``k`` occupies the
    contiguous index range ``[offset_k, offset_k + dim_k)``.

    ``params`` carries per-block parameters for parameterized cones: either
    ``()`` (no parameterized blocks anywhere) or one tuple per block — ``()``
    for non-parameterized blocks, and for POW blocks of dim ``3k`` a tuple of
    ``k`` exponents ``a`` in (0, 1), one per 3-slice.
    """

    blocks: Tuple[Tuple[Cone, int], ...] = ()
    params: Tuple[Tuple[float, ...], ...] = ()

    def __post_init__(self):
        for cone, d in self.blocks:
            if not isinstance(cone, Cone):
                raise TypeError(f"expected Cone, got {cone!r}")
            if d <= 0:
                raise ValueError(f"block dim must be positive, got {d}")
            if cone in (Cone.SOC, Cone.SOC_ROTATED) and d < 2:
                raise ValueError(f"{cone} blocks need dim >= 2, got {d}")
            if cone in (Cone.EXP_PRIMAL, Cone.EXP_DUAL,
                        Cone.POW_PRIMAL, Cone.POW_DUAL) and d % 3 != 0:
                raise ValueError(f"{cone} blocks need dim divisible by 3")
            if cone is Cone.PSD:
                psd_side_from_len(d)  # validates
        has_param_blocks = any(c in _PARAMETERIZED for c, _ in self.blocks)
        if self.params == ():
            if has_param_blocks:
                raise ValueError(
                    "POW blocks need per-block exponents in ConeSpec.params "
                    "(use cones.pow_primal/pow_dual)")
            return
        if len(self.params) != len(self.blocks):
            raise ValueError(
                f"params has {len(self.params)} entries for "
                f"{len(self.blocks)} blocks")
        for (cone, d), p in zip(self.blocks, self.params):
            if cone in _PARAMETERIZED:
                if len(p) != d // 3:
                    raise ValueError(
                        f"{cone} block of dim {d} needs {d // 3} exponents, "
                        f"got {len(p)}")
                if not all(0.0 < a < 1.0 for a in p):
                    raise ValueError(f"POW exponents must be in (0,1): {p}")
            elif p != ():
                raise ValueError(f"{cone} blocks take no params, got {p}")

    def _full_params(self) -> Tuple[Tuple[float, ...], ...]:
        """params padded to one (possibly empty) tuple per block."""
        if self.params != ():
            return self.params
        return tuple(() for _ in self.blocks)

    @property
    def dim(self) -> int:
        return sum(d for _, d in self.blocks)

    def dual(self) -> "ConeSpec":
        """The dual cone product (blockwise duals; POW keeps its exponents)."""
        return ConeSpec(tuple((dual_cone(c), d) for c, d in self.blocks),
                        self.params)

    def offsets(self) -> Tuple[int, ...]:
        offs = []
        o = 0
        for _, d in self.blocks:
            offs.append(o)
            o += d
        return tuple(offs)

    def __add__(self, other: "ConeSpec") -> "ConeSpec":
        if self.params == () and other.params == ():
            return ConeSpec(self.blocks + other.blocks)
        return ConeSpec(self.blocks + other.blocks,
                        self._full_params() + other._full_params())

    @staticmethod
    def concat(specs: Iterable["ConeSpec"]) -> "ConeSpec":
        specs = list(specs)
        out = ConeSpec()
        for s in specs:
            out = out + s
        return out


# Convenience constructors -------------------------------------------------

def free(n: int) -> ConeSpec:
    return ConeSpec(((Cone.FREE, n),))


def zero(n: int) -> ConeSpec:
    return ConeSpec(((Cone.ZERO, n),))


def nonneg(n: int) -> ConeSpec:
    return ConeSpec(((Cone.NONNEG, n),))


def nonpos(n: int) -> ConeSpec:
    return ConeSpec(((Cone.NONPOS, n),))


def soc(n: int) -> ConeSpec:
    return ConeSpec(((Cone.SOC, n),))


def rotated_soc(n: int) -> ConeSpec:
    return ConeSpec(((Cone.SOC_ROTATED, n),))


def psd(side: int) -> ConeSpec:
    """PSD cone of ``side x side`` matrices in svec layout."""
    return ConeSpec(((Cone.PSD, side * (side + 1) // 2),))


def exp_primal(num_blocks: int = 1) -> ConeSpec:
    return ConeSpec(((Cone.EXP_PRIMAL, 3 * num_blocks),))


def exp_dual(num_blocks: int = 1) -> ConeSpec:
    return ConeSpec(((Cone.EXP_DUAL, 3 * num_blocks),))


def pow_primal(alphas) -> ConeSpec:
    """Product of 3D power cones ``{(x,y,z): x^a y^(1-a) >= |z|}``, one per
    exponent in ``alphas`` (a float or iterable of floats in (0,1))."""
    alphas = (alphas,) if isinstance(alphas, float) else tuple(alphas)
    return ConeSpec(((Cone.POW_PRIMAL, 3 * len(alphas)),), (alphas,))


def pow_dual(alphas) -> ConeSpec:
    """Product of dual power cones, one per exponent in ``alphas``."""
    alphas = (alphas,) if isinstance(alphas, float) else tuple(alphas)
    return ConeSpec(((Cone.POW_DUAL, 3 * len(alphas)),), (alphas,))
