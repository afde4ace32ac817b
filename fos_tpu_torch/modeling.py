"""Native modeling front end: the Convex.jl role, self-contained.

The reference's primary entry point is a modeling layer: users write
``minimize(sumsquares(A*x - b), x >= 0)`` in Convex.jl and
``Convex.solve!`` lowers it through MathProgBase into the solver.  This
module is that layer for the port: a small affine-expression DSL that lowers
to the SCS-form conic data :func:`fos_tpu_torch.interface.conic.solve_scs`
consumes, and solves it on the card unless given ``device="cpu"``.  The
lowering is numpy/scipy only and gives the same ``(data, cone, const)`` as
the JAX package's ``fos_tpu.modeling``, bit for bit.

Scope (the reference's working set, not a CVXPY clone):

* ``Variable(shape, symmetric=...)``: scalars, vectors, matrices;
* affine algebra: ``+ - * / @ sum trace transpose`` and 1-D indexing
  with numpy constants; a scipy.sparse matrix may also stand left of
  ``@`` (``A @ x``), which the JAX package's DSL does not take: it lowers
  as the same matrix dense would, without a dense copy;
* constraints: ``==``, ``>=``, ``<=`` (elementwise), ``norm2(e) <= t``
  (SOC), ``X >> 0`` (PSD, scaled-svec rows), ``ExpCone(x, y, z)``,
  ``PowCone(x, y, z, alpha)``;
* objective atoms: ``norm2`` / ``sum_squares`` / ``norm1`` / ``norm_inf``
  / ``quad_form`` epigraphs, plus any affine expression; ``minimize``
  (convex) and ``maximize`` (concave: affine minus atoms, e.g.
  ``maximize(mu @ w - gamma * quad_form(w, Sigma))``).

Lowering puts every variable in the free cone and all structure in the
constraint rows ``s = b - Ax`` in SCS row order (z, l, q, s, ep, p).

Every per-variable coefficient block is a ``scipy.sparse`` CSR matrix: a
10^5-dim lasso or a 256x256 matrix-variable SDP lowers without
materializing a dense ``(rows, nfree)`` block or a dense kron.  The
emitted ``A`` stays sparse above ``_DENSIFY_CELLS`` cells, and the form
build then picks its format (densified on the card below 4 GiB, a tile
table for f32 data whose tiles are sparse enough, torch sparse otherwise);
small problems densify here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp

_SQRT2 = math.sqrt(2.0)

#: emit dense A below this many cells (m*n) — small problems solve faster
#: through the dense path; larger ones keep scipy CSR for the form build
_DENSIFY_CELLS = 2_000_000


def _lmul(Cs: sp.csr_matrix, F: sp.csr_matrix) -> sp.csr_matrix:
    """``Cs @ F``, skipping the matmul when F is a Variable's identity
    expansion (the ubiquitous ``C @ x`` case on large problems)."""
    if getattr(F, "_fos_eye", False) and Cs.shape[1] == F.shape[0]:
        return Cs
    return Cs @ F


def _spmat(arr) -> sp.csr_matrix:
    """2-D CSR view of a constant (rows kept sparse end to end).

    Dense inputs with high fill skip scipy's nonzero scan: the CSR arrays
    are written directly (explicit zeros stored — harmless), which is ~20x
    faster for a 100 x 1e5 dense data matrix."""
    if sp.issparse(arr):
        return arr.tocsr()
    a = np.asarray(arr, dtype=float)
    if a.ndim == 1:
        a = a[None, :]
    m, n = a.shape
    if a.size and np.count_nonzero(a) > 0.25 * a.size:
        return sp.csr_matrix(
            (a.reshape(-1), np.tile(np.arange(n, dtype=np.int64), m),
             np.arange(0, (m + 1) * n, n, dtype=np.int64)), shape=(m, n))
    return sp.csr_matrix(a)


def _size(shape: Tuple[int, ...]) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _as_const(value, shape: Tuple[int, ...]) -> np.ndarray:
    arr = np.asarray(value, dtype=float)
    if arr.shape == shape:
        return arr.reshape(-1)
    if arr.ndim == 0:
        return np.full(_size(shape), float(arr))
    raise ValueError(f"constant shape {arr.shape} incompatible with {shape}")


class AffineExpr:
    """Affine function of the problem variables: ``vec(expr) = sum_v
    terms[v] @ free(v) + const`` (row-major ``vec``).  Every ``terms[v]``
    is a 2-D scipy.sparse CSR of shape ``(size, v.nfree)``."""

    __array_priority__ = 100  # numpy defers to our __rmatmul__ etc.

    def __init__(self, shape: Tuple[int, ...],
                 terms: Dict["Variable", np.ndarray], const: np.ndarray):
        self.shape = tuple(int(d) for d in shape)
        self.terms = terms
        self.const = const

    # -- helpers ------------------------------------------------------
    @property
    def size(self) -> int:
        return _size(self.shape)

    @staticmethod
    def constant(value, shape=None) -> "AffineExpr":
        arr = np.asarray(value, dtype=float)
        shape = arr.shape if shape is None else shape
        return AffineExpr(shape, {}, _as_const(arr, tuple(shape)))

    def _coerce(self, other) -> "AffineExpr":
        if isinstance(other, AffineExpr):
            return other
        arr = np.asarray(other, dtype=float)
        if arr.ndim == 0:
            return AffineExpr(self.shape, {}, np.full(self.size, float(arr)))
        return AffineExpr.constant(arr)

    def _binary_shapes(self, other: "AffineExpr"):
        if self.shape != other.shape:
            raise ValueError(f"shape mismatch: {self.shape} vs {other.shape}")

    # -- affine algebra ----------------------------------------------
    def __add__(self, other):
        if isinstance(other, (Atom, ObjSum)):
            return ObjSum._wrap(self) + other
        other = self._coerce(other)
        self._binary_shapes(other)
        terms = dict(self.terms)
        for v, F in other.terms.items():
            terms[v] = terms.get(v, 0) + F
        return AffineExpr(self.shape, terms, self.const + other.const)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, (Atom, ObjSum)):
            # affine - convex = concave: legal inside maximize(...)
            return ObjSum._wrap(self) + ObjSum._wrap(other).negated()
        return self.__add__(self._coerce(other).__neg__())

    def __rsub__(self, other):
        return self.__neg__().__add__(other)

    def __neg__(self):
        return AffineExpr(self.shape, {v: -F for v, F in self.terms.items()},
                          -self.const)

    def __mul__(self, scalar):
        s = float(scalar)
        return AffineExpr(self.shape, {v: s * F for v, F in self.terms.items()},
                          s * self.const)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        return self.__mul__(1.0 / float(scalar))

    def __matmul__(self, other):
        # expr @ constant: (a, b) @ (b, c) -> via transpose identity
        C = np.asarray(other, dtype=float)
        if len(self.shape) != 2 or C.ndim not in (1, 2):
            raise ValueError("matmul needs a 2-D expression")
        a, b = self.shape
        if C.shape[0] != b:
            raise ValueError(f"matmul shapes {self.shape} @ {C.shape}")
        # row-major vec(E C) = (I_a (x) C') vec(E); for a 1-D C the block
        # is the (1, b) row C itself.  Sparse kron: never materialize the
        # (a*cols, a*b) dense operator.
        M = sp.kron(sp.identity(a),
                    _spmat(C.T if C.ndim == 2 else C[None, :]),
                    format="csr")
        out_shape = (a, C.shape[1]) if C.ndim == 2 else (a,)
        return AffineExpr(out_shape,
                          {v: _lmul(M, F) for v, F in self.terms.items()},
                          M @ self.const)

    def __rmatmul__(self, other):
        # constant @ expr; a scipy.sparse constant stays sparse (f64 CSR),
        # so a large sparse data matrix lowers without a dense copy
        C = (other.tocsr().astype(float) if sp.issparse(other)
             else np.asarray(other, dtype=float))
        if len(self.shape) == 1:
            if C.ndim == 1 and C.shape[0] == self.shape[0]:  # c @ x -> scalar
                Cr = _spmat(C)
                return AffineExpr((), {v: _lmul(Cr, F) for v, F in self.terms.items()},
                                  Cr @ self.const)
            if C.ndim != 2 or C.shape[1] != self.shape[0]:
                raise ValueError(f"matmul shapes {C.shape} @ {self.shape}")
            Cs = _spmat(C)
            return AffineExpr((C.shape[0],),
                              {v: _lmul(Cs, F) for v, F in self.terms.items()},
                              Cs @ self.const)
        if len(self.shape) == 2:
            a, b = self.shape
            if C.ndim != 2 or C.shape[1] != a:
                raise ValueError(f"matmul shapes {C.shape} @ {self.shape}")
            # vec(C E) = (C (x) I_b) vec(E), sparse kron
            M = sp.kron(_spmat(C), sp.identity(b), format="csr")
            return AffineExpr((C.shape[0], b),
                              {v: _lmul(M, F) for v, F in self.terms.items()},
                              M @ self.const)
        raise ValueError("matmul needs a 1-D or 2-D expression")

    @property
    def T(self) -> "AffineExpr":
        if len(self.shape) != 2:
            raise ValueError("transpose needs a 2-D expression")
        a, b = self.shape
        perm = np.arange(a * b).reshape(a, b).T.reshape(-1)
        return AffineExpr((b, a),
                          {v: F[perm] for v, F in self.terms.items()},
                          self.const[perm])

    def __getitem__(self, key) -> "AffineExpr":
        idx = np.arange(self.size).reshape(self.shape)[key]
        rows = np.atleast_1d(idx).reshape(-1)
        shape = idx.shape if hasattr(idx, "shape") else ()
        return AffineExpr(tuple(shape),
                          {v: F[rows] for v, F in self.terms.items()},
                          self.const[rows])

    def sum(self) -> "AffineExpr":
        one = _spmat(np.ones((1, self.size)))
        return AffineExpr((), {v: one @ F for v, F in self.terms.items()},
                          one @ self.const)

    # -- constraints --------------------------------------------------
    def __eq__(self, other):  # noqa: A003 - DSL operator
        other = self._coerce(other)
        self._binary_shapes(other)
        return Constraint("zero", self.__sub__(other))

    def __ne__(self, other):  # pragma: no cover
        raise TypeError("!= is not a convex constraint")

    __hash__ = object.__hash__  # __eq__ is the DSL operator, not equality

    def __ge__(self, other):
        if isinstance(other, Atom):
            return other <= self
        other = self._coerce(other)
        return Constraint("nonneg", self.__sub__(other))

    def __le__(self, other):
        if isinstance(other, Atom):
            raise TypeError("expr <= atom is nonconvex")
        other = self._coerce(other)
        return Constraint("nonneg", other.__sub__(self))

    def __rshift__(self, other):
        if not (np.isscalar(other) and float(other) == 0.0):
            raise ValueError("PSD constraint must be written  X >> 0")
        if len(self.shape) != 2 or self.shape[0] != self.shape[1]:
            raise ValueError("X >> 0 needs a square matrix expression")
        return Constraint("psd", self)

    # promoted into objectives
    def __repr__(self):
        return f"AffineExpr(shape={self.shape}, nvars={len(self.terms)})"


class Variable(AffineExpr):
    """Optimization variable.  ``symmetric=True`` (square matrices only)
    stores the lower triangle as the free entries, so symmetry is
    structural rather than enforced by constraints."""

    _counter = 0

    def __init__(self, shape: Union[int, Tuple[int, ...]] = (),
                 name: Optional[str] = None, *, symmetric: bool = False):
        if isinstance(shape, int):
            shape = (shape,)
        shape = tuple(int(d) for d in shape)
        if symmetric:
            if len(shape) != 2 or shape[0] != shape[1]:
                raise ValueError("symmetric needs a square (n, n) shape")
            n = shape[0]
            L = n * (n + 1) // 2
            rows, cols = [], []
            k = 0
            for j in range(n):
                for i in range(j, n):
                    rows.append(i * n + j)
                    cols.append(k)
                    if i != j:
                        rows.append(j * n + i)
                        cols.append(k)
                    k += 1
            expand = sp.csr_matrix(
                (np.ones(len(rows)), (rows, cols)), shape=(n * n, L))
            self.nfree = L
        else:
            expand = sp.identity(_size(shape), format="csr")
            expand._fos_eye = True  # C @ x fast path: C @ I == C
            self.nfree = _size(shape)
        Variable._counter += 1
        self.name = name or f"var{Variable._counter}"
        self.symmetric = symmetric
        self.value: Optional[np.ndarray] = None
        super().__init__(shape, {self: expand}, np.zeros(_size(shape)))

    def __repr__(self):
        return f"Variable({self.shape}, name={self.name!r})"


class Constraint:
    """kind: zero | nonneg (elementwise on ``expr``), soc (expr = stacked
    (t, x)), psd (expr = square matrix), exp / pow (expr = stacked
    (x, y, z) triple; pow carries ``alpha``)."""

    def __init__(self, kind: str, expr: AffineExpr, alpha: float = None):
        self.kind = kind
        self.expr = expr
        self.alpha = alpha
        #: dual multiplier rows after ``Problem.solve`` (the Convex.jl
        #: ``constraint.dual`` role): the slice of the conic dual ``y``
        #: for this constraint's rows — for ``zero``/``nonneg`` the
        #: Lagrange multipliers of ``expr = 0`` / ``expr >= 0``; for
        #: ``psd`` reconstructed to the dual matrix via ``smat``.
        self.dual_value = None

    def __repr__(self):
        return f"Constraint({self.kind}, {self.expr.shape})"


def _stack(exprs: Sequence[AffineExpr]) -> AffineExpr:
    sizes = [e.size for e in exprs]
    total = sum(sizes)
    variables: List[Variable] = []
    seen = set()
    for e in exprs:
        for v in e.terms:
            if id(v) not in seen:
                seen.add(id(v))
                variables.append(v)
    terms: Dict[Variable, sp.csr_matrix] = {}
    for v in variables:
        blocks = [e.terms[v] if v in e.terms
                  else sp.csr_matrix((sz, v.nfree))
                  for e, sz in zip(exprs, sizes)]
        terms[v] = sp.vstack(blocks, format="csr")
    const = np.concatenate([np.asarray(e.const).reshape(-1) for e in exprs]) \
        if exprs else np.zeros(0)
    return AffineExpr((total,), terms, const)


def _scalar(e, what: str) -> AffineExpr:
    if not isinstance(e, AffineExpr):
        e = AffineExpr.constant(e, ())
    if e.size != 1:
        raise ValueError(f"{what} must be scalar, got shape {e.shape}")
    return AffineExpr((1,), dict(e.terms),  # terms are (1, nfree) CSR already
                      np.asarray(e.const).reshape(1))


def ExpCone(x, y, z) -> Constraint:
    """(x, y, z) in Kexp: y > 0, y * exp(x / y) <= z."""
    return Constraint("exp", _stack([_scalar(x, "ExpCone x"),
                                     _scalar(y, "ExpCone y"),
                                     _scalar(z, "ExpCone z")]))


def PowCone(x, y, z, alpha: float) -> Constraint:
    """(x, y, z) in the 3-D power cone: x^a * y^(1-a) >= |z|, x, y >= 0."""
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"need 0 < alpha < 1, got {alpha}")
    return Constraint("pow", _stack([_scalar(x, "PowCone x"),
                                     _scalar(y, "PowCone y"),
                                     _scalar(z, "PowCone z")]), alpha)


def trace(expr: AffineExpr) -> AffineExpr:
    if len(expr.shape) != 2 or expr.shape[0] != expr.shape[1]:
        raise ValueError("trace needs a square matrix expression")
    n = expr.shape[0]
    diag = np.arange(n) * n + np.arange(n)
    sel = sp.csr_matrix((np.ones(n), (np.zeros(n, int), diag)),
                        shape=(1, n * n))
    return AffineExpr((), {v: sel @ F for v, F in expr.terms.items()},
                      sel @ expr.const)


# -- objective atoms (epigraph lowering at compile time) ---------------
class Atom:
    """Convex atom usable in a minimized objective; lowered to an
    auxiliary epigraph variable + an SOC constraint."""

    def __init__(self, expr: AffineExpr, weight: float = 1.0):
        self.expr = expr
        self.weight = float(weight)

    def scaled(self, s: float) -> "Atom":
        # negative weights are legal DSL objects (a CONCAVE term); the sign
        # is validated at minimize/maximize time, where convexity is known
        return type(self)(self.expr, self.weight * s)

    def __mul__(self, s):
        return self.scaled(float(s))

    __rmul__ = __mul__

    def __neg__(self):
        return self.scaled(-1.0)

    def __add__(self, other):
        return ObjSum._wrap(self) + other

    __radd__ = __add__

    def __sub__(self, other):
        return ObjSum._wrap(self) + ObjSum._wrap(other).negated()

    def __rsub__(self, other):
        return ObjSum._wrap(other) + ObjSum._wrap(self).negated()

    def lower(self) -> Tuple[Variable, Constraint]:  # pragma: no cover
        raise NotImplementedError

    def __le__(self, other) -> Constraint:  # pragma: no cover
        raise NotImplementedError

    def __ge__(self, other):
        raise TypeError("atom >= bound is nonconvex")


class Norm2Atom(Atom):
    def lower(self):
        # the weight scales the epigraph variable in the objective; the
        # SOC constraint itself is unweighted
        t = Variable((), name="_epi_norm2")
        return t, (Norm2Atom(self.expr) <= t)

    def __le__(self, other) -> Constraint:
        if self.weight != 1.0:
            raise ValueError("use norm2(e) <= t unweighted in constraints")
        vec = self.expr if len(self.expr.shape) == 1 else _flatten(self.expr)
        return Constraint("soc", _stack([_scalar(other, "SOC bound"), vec]))


class SumSquaresAtom(Atom):
    def lower(self):
        t = Variable((), name="_epi_sumsq")
        return t, (SumSquaresAtom(self.expr) <= t)

    def __le__(self, other) -> Constraint:
        # ||e||^2 <= t  <=>  ||(1 - t, 2 e)|| <= 1 + t
        if self.weight != 1.0:
            raise ValueError("use sum_squares(e) <= t unweighted in "
                             "constraints")
        vec = self.expr if len(self.expr.shape) == 1 else _flatten(self.expr)
        ts = _scalar(other, "sum_squares bound")
        head = AffineExpr((1,), {v: -F for v, F in ts.terms.items()},
                          1.0 - ts.const)                        # 1 - t
        top = AffineExpr((1,), dict(ts.terms), 1.0 + ts.const)   # 1 + t
        return Constraint("soc", _stack([top, head, vec * 2.0]))


class Norm1Atom(Atom):
    """``||e||_1`` via the standard split: aux u with -u <= e <= u and
    objective term sum(u) (pure LP rows — no cones needed)."""

    def lower(self):
        e = self.expr if len(self.expr.shape) == 1 else _flatten(self.expr)
        u = Variable(e.size, name="_epi_norm1")
        return u.sum(), [u.__sub__(e) >= 0, u.__add__(e) >= 0]

    def __le__(self, other) -> Constraint:
        if self.weight != 1.0:
            raise ValueError("use norm1(e) <= t unweighted in constraints")
        e = self.expr if len(self.expr.shape) == 1 else _flatten(self.expr)
        u = Variable(e.size, name="_abs_norm1")
        ts = _scalar(other, "norm1 bound")
        return [u.__sub__(e) >= 0, u.__add__(e) >= 0,
                Constraint("nonneg", ts.__sub__(_scalar(u.sum(), "sum")))]


class NormInfAtom(Atom):
    """``||e||_inf`` via a scalar bound t with -t <= e_i <= t."""

    def lower(self):
        e = self.expr if len(self.expr.shape) == 1 else _flatten(self.expr)
        t = Variable((), name="_epi_norminf")
        tb = _broadcast_scalar(t, e.size)
        return t, [tb.__sub__(e) >= 0, tb.__add__(e) >= 0]

    def __le__(self, other) -> Constraint:
        if self.weight != 1.0:
            raise ValueError("use norm_inf(e) <= t unweighted in constraints")
        e = self.expr if len(self.expr.shape) == 1 else _flatten(self.expr)
        tb = _broadcast_scalar(_scalar(other, "norm_inf bound"), e.size)
        return [tb.__sub__(e) >= 0, tb.__add__(e) >= 0]


def _broadcast_scalar(t, n: int) -> AffineExpr:
    """(n,) copy of a scalar expression (ones-column coefficient blocks)."""
    ts = _scalar(t, "broadcast")
    ones = _spmat(np.ones((n, 1)))
    return AffineExpr((n,), {v: ones @ F for v, F in ts.terms.items()},
                      np.full(n, float(ts.const[0])))


def _flatten(expr: AffineExpr) -> AffineExpr:
    return AffineExpr((expr.size,), expr.terms, expr.const)


def norm2(expr: AffineExpr) -> Norm2Atom:
    return Norm2Atom(expr)


def sum_squares(expr: AffineExpr) -> SumSquaresAtom:
    return SumSquaresAtom(expr)


def norm1(expr: AffineExpr) -> Norm1Atom:
    return Norm1Atom(expr)


def norm_inf(expr: AffineExpr) -> NormInfAtom:
    return NormInfAtom(expr)


def quad_form(expr: AffineExpr, P) -> SumSquaresAtom:
    """``expr' P expr`` for PSD constant P, lowered as
    ``sum_squares(R expr)`` with ``P = R'R`` (eigendecomposition at model
    time; tiny negative eigenvalues from symmetrization noise are clipped,
    genuinely indefinite P raises)."""
    P = np.asarray(P, float)
    if len(expr.shape) != 1 or P.shape != (expr.size, expr.size):
        raise ValueError(f"quad_form needs a vector expr and a matching "
                         f"square P, got {expr.shape} and {P.shape}")
    Ps = (P + P.T) / 2
    w, V = np.linalg.eigh(Ps)
    tol = -1e-10 * max(1.0, float(np.abs(w).max()))
    if w.min() < tol:
        raise ValueError(f"quad_form P must be PSD (min eigenvalue "
                         f"{w.min():.3e})")
    R = (V * np.sqrt(np.clip(w, 0.0, None))) @ V.T   # symmetric sqrt
    return SumSquaresAtom(R @ expr)


class ObjSum:
    """Affine part + weighted atoms (the minimized objective)."""

    def __init__(self, affine: AffineExpr, atoms: List[Atom]):
        self.affine = affine
        self.atoms = atoms

    @staticmethod
    def _wrap(item) -> "ObjSum":
        if isinstance(item, ObjSum):
            return item
        if isinstance(item, Atom):
            return ObjSum(AffineExpr.constant(0.0, ()), [item])
        if isinstance(item, AffineExpr):
            return ObjSum(_scalar(item, "objective"), [])
        return ObjSum(AffineExpr.constant(np.asarray(item, float), ()), [])

    def __add__(self, other):
        other = ObjSum._wrap(other)
        return ObjSum(_scalar(self.affine, "objective").__add__(
            _scalar(other.affine, "objective")),
            self.atoms + other.atoms)

    __radd__ = __add__

    def __sub__(self, other):
        return self + ObjSum._wrap(other).negated()

    def negated(self) -> "ObjSum":
        return ObjSum(_scalar(self.affine, "objective").__neg__(),
                      [a.scaled(-1.0) for a in self.atoms])


class minimize:  # noqa: N801 - DSL keyword style, as in Convex.jl
    def __init__(self, objective):
        self.obj = ObjSum._wrap(objective)
        if any(a.weight < 0 for a in self.obj.atoms):
            raise ValueError(
                "minimize with a negative-weight (concave) atom is "
                "nonconvex; write the problem as maximize(...)")
        self.sign = 1.0


class maximize:  # noqa: N801
    def __init__(self, objective):
        if isinstance(objective, (Atom, ObjSum, AffineExpr)):
            obj = ObjSum._wrap(objective)
        else:
            obj = ObjSum._wrap(np.asarray(objective, float))
        self.obj = obj.negated()   # maximize f == minimize -f
        if any(a.weight < 0 for a in self.obj.atoms):
            raise ValueError(
                "maximizing a convex atom is nonconvex (atoms may only "
                "enter maximize(...) subtracted, e.g. "
                "maximize(c @ x - sum_squares(x)))")
        self.sign = -1.0


class Problem:
    """``Problem(minimize(...), [constraints]).solve()`` — the
    ``Convex.solve!`` role (FOSSolverInterface.jl:5-64)."""

    def __init__(self, objective: Union[minimize, maximize],
                 constraints: Sequence[Constraint] = ()):
        if not isinstance(objective, (minimize, maximize)):
            raise TypeError("objective must be minimize(...) or maximize(...)")
        self.objective = objective
        self.constraints = []
        for con in constraints:
            # atoms' __le__ may lower to several rows (e.g. norm1 <= t)
            self.constraints.extend(
                con if isinstance(con, (list, tuple)) else [con])
        for con in self.constraints:
            if not isinstance(con, Constraint):
                raise TypeError(f"not a constraint: {con!r} (a bare bool "
                                "means == was used on equal objects)")
        self.status: Optional[str] = None
        self.value: Optional[float] = None
        self.solution = None

    # ------------------------------------------------------------------
    def compile(self):
        """Lower to SCS-form ``(data, cone_dict)`` + bookkeeping."""
        obj = self.objective.obj
        constraints = list(self.constraints)
        affine = _scalar(obj.affine, "objective")
        for atom in obj.atoms:
            t, cons = atom.lower()
            constraints.extend([cons] if isinstance(cons, Constraint)
                               else list(cons))
            affine = affine.__add__(_scalar(t, "epi") * atom.weight)

        # deterministic variable order: objective first, then constraints
        variables: List[Variable] = []
        seen = set()

        def visit(e: AffineExpr):
            for v in e.terms:
                if id(v) not in seen:
                    seen.add(id(v))
                    variables.append(v)

        visit(affine)
        for con in constraints:
            visit(con.expr)

        offsets = {}
        n = 0
        for v in variables:
            offsets[id(v)] = n
            n += v.nfree

        def rows_of(e: AffineExpr) -> Tuple[sp.csr_matrix, np.ndarray]:
            blocks = [e.terms[v] if v in e.terms
                      else sp.csr_matrix((e.size, v.nfree))
                      for v in variables]
            F = sp.hstack(blocks, format="csr") if blocks else \
                sp.csr_matrix((e.size, n))
            return F, np.asarray(e.const).reshape(-1)

        # group rows in SCS order: z, l, q, s, ep, p
        groups = {"zero": [], "nonneg": [], "soc": [], "psd": [],
                  "exp": [], "pow": []}
        for con in constraints:
            groups[con.kind].append(con)

        # single-pass COO assembly of A: per constraint, shift each term
        # block's triplets by its (row, variable-column) offsets — no
        # intermediate hstack/vstack copies of the big blocks
        emitted: List[Tuple[AffineExpr, float]] = []
        b_rows = []
        row_map: List[Tuple[Constraint, int, int]] = []
        row = 0
        cone = {"z": 0, "l": 0, "q": [], "s": [], "ep": 0, "p": []}

        def emit(con, e, sign, g):
            nonlocal row
            emitted.append((e, sign))
            b_rows.append(g)
            row_map.append((con, row, e.size))
            row += e.size

        for con in groups["zero"]:
            g = np.asarray(con.expr.const).reshape(-1)
            emit(con, con.expr, 1.0, -g)   # F x + g = 0: A = F, b = -g
            cone["z"] += con.expr.size
        for con in groups["nonneg"]:
            g = np.asarray(con.expr.const).reshape(-1)
            emit(con, con.expr, -1.0, g)   # F x + g >= 0 -> s = g + F x >= 0
            cone["l"] += con.expr.size
        for con in groups["soc"]:
            g = np.asarray(con.expr.const).reshape(-1)
            emit(con, con.expr, -1.0, g)
            cone["q"].append(con.expr.size)
        for con in groups["psd"]:
            nn = con.expr.shape[0]
            sym = _symmetrize_svec(con.expr)   # scaled svec rows
            emit(con, sym, -1.0, np.asarray(sym.const).reshape(-1))
            cone["s"].append(nn)
        for con in groups["exp"]:
            g = np.asarray(con.expr.const).reshape(-1)
            emit(con, con.expr, -1.0, g)
            cone["ep"] += 1
        for con in groups["pow"]:
            g = np.asarray(con.expr.const).reshape(-1)
            emit(con, con.expr, -1.0, g)
            cone["p"].append(con.alpha)

        if not emitted:
            raise ValueError("problem has no constraints")
        ri, ci, vi = [], [], []
        off_r = 0
        for e, sign in emitted:
            for v, F in e.terms.items():
                Fc = F.tocoo()
                ri.append(Fc.row.astype(np.int64) + off_r)
                ci.append(Fc.col.astype(np.int64) + offsets[id(v)])
                vi.append(sign * Fc.data)
            off_r += e.size
        A = sp.coo_matrix(
            (np.concatenate(vi) if vi else np.zeros(0),
             (np.concatenate(ri) if ri else np.zeros(0, np.int64),
              np.concatenate(ci) if ci else np.zeros(0, np.int64))),
            shape=(row, n))
        # small problems go dense (faster solve path); big ones stay CSR
        # and the form build picks their format (tile table or torch sparse)
        if A.shape[0] * A.shape[1] <= _DENSIFY_CELLS:
            A = A.toarray()
        else:
            A = A.tocsr()
        b = np.concatenate(b_rows)
        cF, cg = rows_of(affine)
        data = {"A": A, "b": b, "c": np.asarray(cF.todense()).reshape(-1)}
        return data, cone, variables, offsets, float(cg[0]), row_map

    def solve(self, alg=None, **options):
        """Lower and solve (options go to :func:`solve_scs`: ``device``,
        ``dtype``, ``pallas``, ...).  ``value``, ``Variable.value`` and
        ``Constraint.dual_value`` are host numpy, read from the solution
        once."""
        import torch

        from fos_tpu_torch.cones.project import smat
        from fos_tpu_torch.interface.conic import solve_scs

        data, cone, variables, offsets, const, row_map = self.compile()
        sol = solve_scs(data, cone, alg=alg, **options)
        self.solution = sol
        self.status = sol.status
        x = sol.x.detach().cpu().numpy()
        y = sol.y.detach().cpu().numpy()
        for con, start, sz in row_map:
            dual = y[start:start + sz]
            if con.kind == "psd":
                dual = smat(torch.from_numpy(dual)).numpy()
            con.dual_value = dual
        for v in variables:
            raw = x[offsets[id(v)]:offsets[id(v)] + v.nfree]
            if v.symmetric:
                nn = v.shape[0]
                M = np.zeros((nn, nn))
                k = 0
                for j in range(nn):
                    for i in range(j, nn):
                        M[i, j] = M[j, i] = raw[k]
                        k += 1
                v.value = M
            else:
                v.value = raw.reshape(v.shape) if v.shape else float(raw[0])
        self.value = self.objective.sign * (float(np.dot(data["c"], x)) + const)
        return sol


def _symmetrize_svec(expr: AffineExpr) -> AffineExpr:
    """Scaled-svec rows of a square matrix expression (symmetrized):
    row (i >= j) is ``X_ii`` on the diagonal, ``sqrt2 * (X_ij + X_ji)/2``
    off it — matching the solver's Cone.PSD layout
    (``fos_tpu_torch.cones.project.svec``)."""
    nn = expr.shape[0]
    L = nn * (nn + 1) // 2
    rows, cols, vals = [], [], []
    k = 0
    for j in range(nn):
        for i in range(j, nn):
            if i == j:
                rows.append(k); cols.append(i * nn + j); vals.append(1.0)
            else:
                rows.append(k); cols.append(i * nn + j); vals.append(_SQRT2 / 2)
                rows.append(k); cols.append(j * nn + i); vals.append(_SQRT2 / 2)
            k += 1
    sel = sp.csr_matrix((vals, (rows, cols)), shape=(L, nn * nn))
    return AffineExpr((L,), {v: sel @ F for v, F in expr.terms.items()},
                      sel @ expr.const)
