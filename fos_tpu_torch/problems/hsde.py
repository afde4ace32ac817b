"""Homogeneous self-dual embedding of a conic program.

The iterate is ``z = (u, v)`` in ``R^{2l}``, ``l = n + m + 1``, with
``u = (x, y, tau)`` and ``v = (r, s, kappa)`` (FirstOrderSolvers.jl
src/problemforms/HSDE/HSDE.jl):

* S1 is the subspace ``{(u, v): Qu = v}``, projected by
  :class:`fos_tpu_torch.linalg.affine.HSDEAffineProjector`;
* S2 is the cone product ``K2 x K1* x R+  x  K2* x K1 x R+``, one fused
  projection over the whole vector;
* the termination residuals p/d/g and the certificates are computed on the
  device from views into z (HSDEStatus.jl:27-71, 93-102).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fos_tpu_torch.config import eps_of
from fos_tpu_torch.cones.spec import ConeSpec, nonneg
from fos_tpu_torch.linalg.affine import HSDEAffineProjector, _default_floor
from fos_tpu_torch.linalg import hsde_ops
from fos_tpu_torch.problems.conic import ConicProblem
from fos_tpu_torch.solvers.base import ConeSet, TwoSets
from fos_tpu_torch.solvers.status import Status

#: dense forms at or above this size are never densified automatically
DENSIFY_LIMIT_BYTES = 4 * 1024**3


def hsde_cone_spec(K1: ConeSpec, K2: ConeSpec) -> ConeSpec:
    """The S2 product over z: K2 x K1* x R+ x K2* x K1 x R+
    (cones.jl:122-142)."""
    return ConeSpec.concat([K2, K1.dual(), nonneg(1), K2.dual(), K1, nonneg(1)])


class HSDECheck(NamedTuple):
    """Convergence-check scalars (one status-table row)."""

    status: torch.Tensor  # int32 Status code
    p: torch.Tensor
    d: torch.Tensor
    g: torch.Tensor
    ctx: torch.Tensor
    bty: torch.Tensor
    tau: torch.Tensor
    kappa: torch.Tensor

    def to_host(self) -> "HSDECheck":
        """The same check as Python numbers, read in one device transfer."""
        vals = torch.stack([v.to(torch.float64) for v in self]).tolist()
        return HSDECheck(int(vals[0]), *vals[1:])


def _is_scipy_sparse(A) -> bool:
    import scipy.sparse as sp

    return sp.issparse(A)


def _to_torch_sparse(A, dtype, device):
    coo = A.tocoo()
    idx = torch.as_tensor(np.stack([coo.row, coo.col]).astype(np.int64))
    vals = torch.as_tensor(coo.data).to(dtype)
    return torch.sparse_coo_tensor(idx, vals, A.shape,
                                   check_invariants=True).coalesce().to(device)


class HSDEForm:
    """Problem form driving the iteration engine."""

    #: plateau window: the rate test compares the stall score across this
    #: many checks
    STALL_WINDOW = 10

    def __init__(self, sets: TwoSets, A, b, c, norm_b, norm_c, n: int, m: int,
                 K2_spec=None, strict_certificates=False, compensated=False):
        self.sets = sets
        self.A = A
        self.b = b
        self.c = c
        self.norm_b = norm_b
        self.norm_c = norm_c
        self.n = n
        self.m = m
        self.K2_spec = K2_spec
        self.strict_certificates = strict_certificates
        self.compensated = compensated

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, problem: ConicProblem, *, direct: bool = False,
              cg_max_iters: int = 1000, pallas: bool = False,
              cg_tol_floor: float = None, cg_variant: str = "standard",
              cg_unroll: int = 2, equilibrate: bool = False,
              strict_certificates: bool = False, densify="auto",
              compensated="auto", sparse_format="auto") -> "HSDEForm":
        """Build the embedding on the device of ``problem.b``.

        Format of a sparse ``A`` (scipy.sparse or torch sparse COO):

        * ``densify``: True densifies; "auto" densifies when the target
          device is a CUDA device and the dense form takes less than
          4 GiB; False keeps A sparse.  Operators and explicit tile
          formats ("bell", "band") are never densified.
        * ``sparse_format`` (f32 only for the tile formats): "band" packs
          :class:`BandedBlockOp`; "bell" packs a tile operator, banded when
          ``band_span_ratio <= 1.25`` and blocked-ELL otherwise; "auto"
          does what "bell" does when ``bell_storage_ratio < 0.5``, on every
          device; "bcoo" (and anything left sparse) becomes a torch sparse
          COO tensor.
        * ``pallas=True`` selects :class:`PaddedDenseOp`, the hand-written
          fused pair kernel for dense A (the keyword keeps the JAX
          package's name).
        """
        if equilibrate:
            raise NotImplementedError(
                "equilibrate is not ported yet: ROADMAP queue 1, "
                "'problems/scaling.py'")
        A, b, c = problem.A, problem.b, problem.c
        device, dtype = b.device, b.dtype
        if isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo:
            import scipy.sparse as sp

            A = A.coalesce().cpu()
            idx = A.indices().numpy()
            A = sp.coo_matrix((A.values().numpy(), (idx[0], idx[1])),
                              shape=tuple(A.shape))
        if (_is_scipy_sparse(A) and densify
                and sparse_format not in ("bell", "band")):
            dense_bytes = A.shape[0] * A.shape[1] * b.element_size()
            if densify is True or (densify == "auto" and device.type == "cuda"
                                   and dense_bytes < DENSIFY_LIMIT_BYTES):
                A = torch.as_tensor(A.toarray()).to(device=device, dtype=dtype)
        if _is_scipy_sparse(A) and sparse_format in ("auto", "bell", "band"):
            if dtype == torch.float32:
                from fos_tpu_torch.linalg.sparse_ell import (
                    BandedBlockOp, BlockedEllOp, band_span_ratio,
                    bell_storage_ratio)

                # transpose_table=False: the whole HSDE path consumes the
                # fused pair, which streams A'z from the A table
                if sparse_format == "band":
                    A = BandedBlockOp.create(A, device=device)
                elif sparse_format == "bell" or bell_storage_ratio(A) < 0.5:
                    if band_span_ratio(A) <= 1.25:
                        A = BandedBlockOp.create(A, device=device)
                    else:
                        A = BlockedEllOp.create(A, device=device)
            elif sparse_format in ("bell", "band"):
                raise ValueError(
                    f"sparse_format={sparse_format!r} requires f32 problem "
                    "data (the tile kernels are f32-only); pass "
                    "dtype=torch.float32 or use sparse_format='bcoo'")
        if _is_scipy_sparse(A):
            A = _to_torch_sparse(A, dtype, device)
        if pallas:
            from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp

            if not isinstance(A, PaddedDenseOp):
                A = PaddedDenseOp.create(A)
        norm_b = torch.linalg.norm(b)
        norm_c = torch.linalg.norm(c)
        # compensated reductions: on for the f32 check by default (once per
        # checki, and it keeps the cancelling gap honest); CG dots opt-in
        if compensated == "auto":
            comp_check = dtype == torch.float32
            comp_cg = False
        else:
            comp_check = comp_cg = bool(compensated)
        s1 = HSDEAffineProjector.create(
            A, b, c, direct=direct, decreasing_accuracy=not direct,
            cg_max_iters=cg_max_iters, tol_floor=cg_tol_floor,
            cg_variant=cg_variant, cg_unroll=cg_unroll, compensated=comp_cg)
        s2 = ConeSet(hsde_cone_spec(problem.K1, problem.K2))
        if s2.spec.dim != 2 * s1.l:
            raise ValueError("cone product does not cover the embedding")
        return cls(TwoSets(s1, s2), A, b, c, norm_b, norm_c, problem.n,
                   problem.m, problem.K2, strict_certificates, comp_check)

    @property
    def l(self) -> int:
        return self.n + self.m + 1

    @property
    def dim(self) -> int:
        return 2 * self.l

    @property
    def dtype(self):
        return self.b.dtype

    @property
    def device(self):
        return self.b.device

    @property
    def direct(self) -> bool:
        return self.sets.s1.direct

    def initial_value(self, dtype):
        """tau = kappa = 1, everything else 0 (HSDE.jl:40-47)."""
        z = torch.zeros(self.dim, dtype=dtype, device=self.device)
        z[self.l - 1] = 1.0
        z[2 * self.l - 1] = 1.0
        return z

    def split(self, z):
        n, m, l = self.n, self.m, self.l
        return (z[:n], z[n: n + m], z[l - 1], z[l: l + n],
                z[l + n: l + n + m], z[2 * l - 1])

    def check(self, z, eps: float, prev=None) -> HSDECheck:
        """SCS-style residual check (HSDEStatus.jl:27-71) on the device.

        Keeps the reference arithmetic, including its normalise-twice quirk:
        the displayed residual is ``||.|| / (1 + ||b||)`` while the
        optimality test re-multiplies the tolerance by ``(1 + ||b||)``.
        """
        x, y, tau, r, s, kappa = self.split(z)
        b, c = self.b, self.c
        nb, nc = self.norm_b, self.norm_c
        Ax, ATy = hsde_ops.mv_pair(self.A, x, y)
        if self.compensated:
            # float-float: the gap numerator |c'x + b'y| cancels near the
            # optimum, so the two dots are differenced before rounding
            from fos_tpu_torch.linalg.compensated import cdot_ff, cnorm, ff_add

            _norm = cnorm
            ctx_ff = cdot_ff(c, x)
            bty_ff = cdot_ff(b, y)
            ctx, bty = ctx_ff[0] + ctx_ff[1], bty_ff[0] + bty_ff[1]
            gap_num = ff_add(ctx_ff, bty_ff)
            gap_num = torch.abs(gap_num[0] + gap_num[1])
        else:
            _norm = torch.linalg.norm
            ctx = torch.dot(c, x)
            bty = torch.dot(b, y)
            gap_num = torch.abs(ctx + bty)
        p = _norm(Ax / tau + s / tau - b) / (1.0 + nb)
        d = _norm(ATy / tau + c - r / tau) / (1.0 + nc)
        gden = 1.0 + torch.abs(ctx / tau) + torch.abs(bty / tau)
        g = (gap_num / tau) / gden

        optimal = ((p <= eps * (1.0 + nb)) & (d <= eps * (1.0 + nc))
                   & (g <= eps * gden))
        # certificates need strictly improving rays (ctx < 0 resp. bty < 0):
        # without the sign guard an iterate collapsed to z = 0 would be
        # certified (a defect of HSDEStatus.jl:58-61 not reproduced)
        unbounded = (ctx < 0) & (_norm(Ax + s) <= eps * (-ctx / nc))
        if self.strict_certificates and self.K2_spec is not None:
            # Farkas certificate: distance of A'y to K2*
            from fos_tpu_torch.cones.project import project as _proj

            cert = ATy - _proj(self.K2_spec.dual(), ATy)
            infeasible = (bty < 0) & (_norm(cert) <= eps * (-bty / nb))
        else:
            infeasible = (bty < 0) & (_norm(ATy) <= eps * (-bty / nb))

        def code(k):
            return torch.full((), k, dtype=torch.int32, device=z.device)

        status = torch.where(
            optimal, code(Status.OPTIMAL),
            torch.where(unbounded, code(Status.UNBOUNDED),
                        torch.where(infeasible, code(Status.INFEASIBLE),
                                    code(Status.CONTINUE))))
        return HSDECheck(status, p, d, g, ctx, bty, tau, kappa)

    # --- stall detection / recovery (engine hooks; host values) ---------
    def gap_stalled(self, chk: HSDECheck, eps: float) -> bool:
        """True when the primal/dual residuals pass but the duality gap does
        not: the signature of the CG tolerance floor biasing the fixed
        point.  ``chk`` holds host values (:meth:`HSDECheck.to_host`)."""
        if chk.status != Status.CONTINUE or chk.tau <= 0:
            return False
        nb, nc = float(self.norm_b), float(self.norm_c)
        ctx = chk.ctx / chk.tau
        bty = chk.bty / chk.tau
        gden = 1.0 + abs(ctx) + abs(bty)
        return (chk.p <= eps * (1.0 + nb) and chk.d <= eps * (1.0 + nc)
                and chk.g > eps * gden)

    def stall_score(self, chk: HSDECheck, eps: float) -> float:
        """Distance from passing: the largest of the three optimality tests'
        residual/threshold ratios (1.0 = exactly at the operating point)."""
        tau = chk.tau if chk.tau > 0 else 1.0
        gden = 1.0 + abs(chk.ctx / tau) + abs(chk.bty / tau)

        def ratio(num, den):
            return num / den if den != 0 else math.copysign(math.inf, num)

        return max(ratio(chk.p, eps * (1.0 + float(self.norm_b))),
                   ratio(chk.d, eps * (1.0 + float(self.norm_c))),
                   ratio(chk.g, eps * gden))

    def plateau_stalled(self, chk: HSDECheck, eps: float, win_score: float,
                        remaining_checks: int):
        """(stalled, score): fire when the per-window improvement rate of
        the stall score cannot reach 1 within ``remaining_checks``."""
        score = self.stall_score(chk, eps)
        if (chk.status != Status.CONTINUE or not math.isfinite(score)
                or not math.isfinite(win_score) or score <= 1.0):
            return False, score
        rate = max(win_score / max(score, 1e-30), 1.0 + 1e-6)
        cannot = (math.log(max(score, 1.0)) * self.STALL_WINDOW
                  > math.log(rate) * remaining_checks)
        return cannot, score

    def _floors(self):
        """(current floor, tightened floor ~sqrt(2l)*eps)."""
        s1 = self.sets.s1
        tight = float(np.sqrt(2.0 * self.l)) * eps_of(self.dtype)
        cur = (s1.tol_floor if s1.tol_floor is not None
               else _default_floor(2 * self.l, self.dtype))
        return float(cur), tight

    def fused_cg_floors(self):
        """(default_floor, tightened_floor) for an on-device recovery, or
        None when the floor is already at or below the tightened value."""
        cur, tight = self._floors()
        return None if cur <= tight else (cur, tight)

    def tighten_cg(self):
        """A copy with a ~sqrt(2l)*eps CG floor (None if not tighter):
        recovers gap-stalled f32 runs.  Every field of the projector is
        carried over (:meth:`HSDEAffineProjector.replace`)."""
        floors = self.fused_cg_floors()
        if floors is None:
            return None
        s1b = self.sets.s1.replace(tol_floor=floors[1])
        return HSDEForm(TwoSets(s1b, self.sets.s2), self.A, self.b, self.c,
                        self.norm_b, self.norm_c, self.n, self.m,
                        self.K2_spec, self.strict_certificates,
                        self.compensated)

    # --- engine observability hooks (printing + history) ------------------
    def header(self, init_duration_s: float) -> str:
        from fos_tpu_torch.utils import printing

        return printing.hsde_header(init_duration_s, self.direct)

    def _cgiter(self, st):
        return None if self.direct else int(st.s1_state.last_iters)

    def row(self, st, chk: HSDECheck, i: int, t_s: float) -> str:
        """One status-table row; ``chk`` holds host values."""
        from fos_tpu_torch.utils import printing

        return printing.hsde_row(i, chk.p, chk.d, chk.g, chk.ctx, chk.bty,
                                 chk.kappa / chk.tau, t_s,
                                 cgiter=self._cgiter(st))

    def record(self, hist, st, chk: HSDECheck, i: int, t_s: float, debug: int,
               extra=None):
        """History rows (HSDEStatus.jl:125-139): p,d,g,ctx,bty,kappa,tau,t;
        debug>1 also x,y,s.  ``chk`` holds host values.  ``extra`` is
        ignored: the reference's HSDE logextra is a no-op
        (HSDEStatus.jl:18-20)."""
        if hist is None or debug <= 0:
            return
        for key in ("p", "d", "g", "ctx", "bty", "kappa", "tau"):
            hist.push(key, i, float(getattr(chk, key)))
        hist.push("t", i, t_s)
        if not self.direct:
            hist.push("cgiter", i, int(st.s1_state.last_iters))
        if debug > 1:
            x, y, tau, r, s, kappa = self.split(st.z_check)
            hist.push("x", i, (x / tau).cpu().numpy())
            hist.push("y", i, (y / tau).cpu().numpy())
            hist.push("s", i, (s / tau).cpu().numpy())


class Solution(NamedTuple):
    """Recovered conic solution.  ``raw_z`` is the final HSDE iterate, to
    pass as ``initx`` to warm-start a later solve."""

    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    status: str
    objval: float
    iters: int
    history: object = None
    raw_z: torch.Tensor = None

    @property
    def optimal(self) -> bool:
        return self.status == "Optimal"


def populate_solution(form: HSDEForm, guess, status_code: int, iters: int,
                      history=None, raw_z=None) -> Solution:
    """(x, y, s) = (u_x, u_y, v_s) / tau; :Continue -> :Indeterminate
    (HSDE.jl:49-61).  A certificate returns the unscaled ray."""
    x, y, tau, r, s, kappa = form.split(guess)
    status = Status.name(status_code)
    if status == "Continue":
        status = "Indeterminate"
    if status in ("Unbounded", "Infeasible"):
        tau = torch.ones_like(tau)
    xs, ys, ss = x / tau, y / tau, s / tau
    return Solution(x=xs, y=ys, s=ss, status=status,
                    objval=float(torch.dot(form.c, xs)), iters=iters,
                    history=history, raw_z=raw_z)
