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
import time
from typing import NamedTuple

import numpy as np
import torch

from fos_tpu_torch.config import eps_of
from fos_tpu_torch.cones.project import resolve_psd_method
from fos_tpu_torch.cones.spec import Cone, ConeSpec, nonneg
from fos_tpu_torch.linalg.affine import HSDEAffineProjector, _default_floor
from fos_tpu_torch.linalg import hsde_ops, lanes
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

    #: what :meth:`check` returns
    CHECK = HSDECheck

    #: plateau window: the rate test compares the stall score across this
    #: many checks
    STALL_WINDOW = 10

    def __init__(self, sets: TwoSets, A, b, c, norm_b, norm_c, n: int, m: int,
                 dinv=None, einv=None, K2_spec=None, strict_certificates=False,
                 compensated=False):
        self.sets = sets
        self.A = A
        self.b = b
        self.c = c
        self.norm_b = norm_b      # the original ||b|| (before equilibration)
        self.norm_c = norm_c      # the original ||c||
        self.n = n
        self.m = m
        self.dinv = dinv          # residual unscaling weights (equilibration)
        self.einv = einv
        self.K2_spec = K2_spec
        self.strict_certificates = strict_certificates
        self.compensated = compensated
        #: where a batch split over ranks puts this form's instances
        #: (:func:`fos_tpu_torch.parallel.sharding.shard_batched_form`)
        self.batch_shard = None

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, problem: ConicProblem, *, direct: bool = False,
              cg_max_iters: int = 1000, pallas: bool = False,
              cg_tol_floor: float = None, psd_method: str = "auto",
              cg_variant: str = "standard", cg_unroll: int = 2,
              equilibrate: bool = False, equilibrate_iters: int = 10,
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

        ``equilibrate`` runs Ruiz scaling (``equilibrate_iters`` sweeps) on
        the host before A is packed (:mod:`fos_tpu_torch.problems.
        scaling`); an operator A cannot be scaled and raises.  ``direct``
        factors ``[I; Q]`` on the host (a dense (2l, l) factor) instead of
        running CG; the form's ``setup_seconds`` holds the host seconds of
        these two steps ("equilibrate", "factor").  ``psd_method`` ("auto",
        "eigh", "poly") picks the PSD projection; "eigh" on a CUDA device
        runs the solve on the eager route (:attr:`graph_route`).
        """
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
        norm_b = torch.linalg.norm(b)
        norm_c = torch.linalg.norm(c)
        dinv = einv = None
        setup = {}   # host seconds of the one-time set-up steps
        if equilibrate:
            t0 = time.perf_counter()
            A, b, c, dinv, einv = _equilibrate(A, b, c, problem.K1,
                                               problem.K2, equilibrate_iters)
            setup["equilibrate"] = time.perf_counter() - t0
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
        if pallas and not getattr(A, "sharded", False):
            # a sharded operator holds its local blocks' K1 already
            from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp

            if not isinstance(A, PaddedDenseOp):
                A = PaddedDenseOp.create(A)
        # compensated reductions: on for the f32 check by default (once per
        # checki, and it keeps the cancelling gap honest); CG dots opt-in
        if compensated == "auto":
            comp_check = dtype == torch.float32
            comp_cg = False
        else:
            comp_check = comp_cg = bool(compensated)
        t0 = time.perf_counter()
        s1 = HSDEAffineProjector.create(
            A, b, c, direct=direct, decreasing_accuracy=not direct,
            cg_max_iters=cg_max_iters, tol_floor=cg_tol_floor,
            cg_variant=cg_variant, cg_unroll=cg_unroll, compensated=comp_cg)
        if direct:
            setup["factor"] = time.perf_counter() - t0
        spec = hsde_cone_spec(problem.K1, problem.K2)
        s2 = ConeSet(spec, resolve_psd_method(psd_method, device))
        if s2.spec.dim != 2 * s1.l:
            raise ValueError("cone product does not cover the embedding")
        form = cls(TwoSets(s1, s2), A, b, c, norm_b, norm_c, problem.n,
                   problem.m, dinv, einv, problem.K2, strict_certificates,
                   comp_check)
        form._host_norms()  # read once here, not between chunks
        form.setup_seconds = setup
        return form

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

    @property
    def psd_method(self):
        """The PSD blocks' projection ("eigh" or "poly"), or None without
        PSD blocks."""
        s2 = self.sets.s2
        return (s2.psd_method if any(cone is Cone.PSD
                                     for cone, _ in s2.spec.blocks) else None)

    @property
    def sharded(self) -> bool:
        """Whether the solve runs across ranks: a sharded operator
        (:mod:`fos_tpu_torch.parallel.sharding`) or a split batch."""
        return bool(getattr(self.A, "sharded", False)
                    or self.batch_shard is not None)

    def vote(self, status):
        """The chunk loop's status: ``status`` as it is, or for a batch
        split over ranks the ranks' one vote on it (:class:`fos_tpu_torch.
        parallel.sharding.BatchShard`)."""
        return (status if self.batch_shard is None
                else self.batch_shard.vote(status))

    @property
    def graph_route(self) -> bool:
        """Whether the engine may run this form as captured CUDA graphs:
        not with PSD blocks projected by ``torch.linalg.eigh``, whose
        capture the card refuses (the stream capture is invalidated), and
        not across ranks, whose collectives are host calls.  Decided when
        the form is built, never by a failed capture."""
        return self.psd_method != "eigh" and not self.sharded

    @property
    def route(self) -> str:
        """Where and how the solve runs: "cpu", or on the card "graph"
        (captured CUDA graphs) or "eager"."""
        if self.device.type != "cuda":
            return "cpu"
        return "graph" if self.graph_route else "eager"

    def initial_value(self, dtype):
        """tau = kappa = 1, everything else 0 (HSDE.jl:40-47)."""
        z = torch.zeros(self.dim, dtype=dtype, device=self.device)
        z[self.l - 1].fill_(1.0)
        z[2 * self.l - 1].fill_(1.0)
        return z

    def prepare(self, like):
        """Copy what the step and the check copy from the host on first use
        (the cone projections' tables) before a CUDA graph is captured."""
        from fos_tpu_torch.cones.project import prepare

        self.sets.s2.prepare(like)
        if self.strict_certificates and self.K2_spec is not None:
            prepare(self.K2_spec.dual(), like)

    def split(self, z):
        n, m, l = self.n, self.m, self.l
        return (z[..., :n], z[..., n: n + m], z[..., l - 1], z[..., l: l + n],
                z[..., l + n: l + n + m], z[..., 2 * l - 1])

    def check(self, z, eps: float, prev=None) -> HSDECheck:
        """SCS-style residual check (HSDEStatus.jl:27-71) on the device.

        Keeps the reference arithmetic, including its normalise-twice quirk:
        the displayed residual is ``||.|| / (1 + ||b||)`` while the
        optimality test re-multiplies the tolerance by ``(1 + ||b||)``.
        A ``z`` with a lane axis (a batched form) gets one value per lane
        in every field.
        """
        x, y, tau, r, s, kappa = self.split(z)
        b, c = self.b, self.c
        nb, nc = self.norm_b, self.norm_c
        tv = lanes.per_lane(tau, x)   # tau against the lanes' vectors
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
            _norm = lanes.vnorm
            ctx = lanes.vdot(c, x)
            bty = lanes.vdot(b, y)
            gap_num = torch.abs(ctx + bty)
        # with equilibration the residuals are unscaled back to the original
        # problem (weights D^-1, E^-1); nb and nc are the original norms
        wp, wd = self._weigh_p, self._weigh_d
        p = _norm(wp(Ax / tv + s / tv - b)) / (1.0 + nb)
        d = _norm(wd(ATy / tv + c - r / tv)) / (1.0 + nc)
        gden = 1.0 + torch.abs(ctx / tau) + torch.abs(bty / tau)
        g = (gap_num / tau) / gden

        optimal = ((p <= eps * (1.0 + nb)) & (d <= eps * (1.0 + nc))
                   & (g <= eps * gden))
        # certificates need strictly improving rays (ctx < 0 resp. bty < 0):
        # without the sign guard an iterate collapsed to z = 0 would be
        # certified (a defect of HSDEStatus.jl:58-61 not reproduced)
        unbounded = (ctx < 0) & (_norm(wp(Ax + s)) <= eps * (-ctx / nc))
        if self.strict_certificates and self.K2_spec is not None:
            # Farkas certificate: distance of A'y to K2*
            from fos_tpu_torch.cones.project import project as _proj

            v = wd(ATy)
            cert = v - _proj(self.K2_spec.dual(), v)
            infeasible = (bty < 0) & (_norm(cert) <= eps * (-bty / nb))
        else:
            infeasible = (bty < 0) & (_norm(wd(ATy)) <= eps * (-bty / nb))

        def code(k):
            return torch.full((), k, dtype=torch.int32, device=z.device)

        status = torch.where(
            optimal, code(Status.OPTIMAL),
            torch.where(unbounded, code(Status.UNBOUNDED),
                        torch.where(infeasible, code(Status.INFEASIBLE),
                                    code(Status.CONTINUE))))
        return HSDECheck(status, p, d, g, ctx, bty, tau, kappa)

    def _weigh_p(self, v):
        return v if self.dinv is None else self.dinv * v

    def _weigh_d(self, v):
        return v if self.einv is None else self.einv * v

    # --- stall detection / recovery ------------------------------------
    # host hooks (the chunked engine, ``chk`` from HSDECheck.to_host) and
    # their tensor twins (fused_solve's on-device recovery, no host read)
    def _host_norms(self):
        """(||b||, ||c||) on the host, read once per form."""
        if getattr(self, "_norms", None) is None:
            self._norms = tuple(torch.stack([self.norm_b, self.norm_c])
                                .double().tolist())
        return self._norms

    def gap_stalled(self, chk: HSDECheck, eps: float) -> bool:
        """True when the primal/dual residuals pass but the duality gap does
        not: the signature of the CG tolerance floor biasing the fixed
        point.  ``chk`` holds host values (:meth:`HSDECheck.to_host`)."""
        if chk.status != Status.CONTINUE or chk.tau <= 0:
            return False
        nb, nc = self._host_norms()
        ctx = chk.ctx / chk.tau
        bty = chk.bty / chk.tau
        gden = 1.0 + abs(ctx) + abs(bty)
        return (chk.p <= eps * (1.0 + nb) and chk.d <= eps * (1.0 + nc)
                and chk.g > eps * gden)

    def gap_stalled_traced(self, chk: HSDECheck, eps: float):
        """:meth:`gap_stalled` on the device's check (a bool tensor)."""
        tau = chk.tau
        safe_tau = torch.where(tau > 0, tau, 1.0)
        ctx = chk.ctx / safe_tau
        bty = chk.bty / safe_tau
        gden = 1.0 + torch.abs(ctx) + torch.abs(bty)
        return ((chk.status == Status.CONTINUE) & (tau > 0)
                & (chk.p <= eps * (1.0 + self.norm_b))
                & (chk.d <= eps * (1.0 + self.norm_c))
                & (chk.g > eps * gden))

    def stall_score(self, chk: HSDECheck, eps: float):
        """Distance from passing, on the device's check: the largest of the
        three optimality tests' residual/threshold ratios (1.0 = exactly at
        the operating point)."""
        tau = chk.tau
        safe_tau = torch.where(tau > 0, tau, 1.0)
        gden = (1.0 + torch.abs(chk.ctx / safe_tau)
                + torch.abs(chk.bty / safe_tau))
        return torch.maximum(
            chk.p / (eps * (1.0 + self.norm_b)),
            torch.maximum(chk.d / (eps * (1.0 + self.norm_c)),
                          chk.g / (eps * gden)))

    def _host_stall_score(self, chk: HSDECheck, eps: float) -> float:
        """:meth:`stall_score` on host values."""
        nb, nc = self._host_norms()
        tau = chk.tau if chk.tau > 0 else 1.0
        gden = 1.0 + abs(chk.ctx / tau) + abs(chk.bty / tau)

        def ratio(num, den):  # IEEE division, as on the device
            if den != 0:
                return num / den
            return math.nan if num == 0 or num != num else math.copysign(
                math.inf, num)

        ratios = (ratio(chk.p, eps * (1.0 + nb)),
                  ratio(chk.d, eps * (1.0 + nc)), ratio(chk.g, eps * gden))
        # a NaN propagates, as through torch.maximum
        return math.nan if any(r != r for r in ratios) else max(ratios)

    def plateau_stalled(self, chk: HSDECheck, eps: float, win_score: float,
                        remaining_checks: int):
        """(stalled, score): fire when the per-window improvement rate of
        the stall score cannot reach 1 within ``remaining_checks``."""
        score = self._host_stall_score(chk, eps)
        if (chk.status != Status.CONTINUE or not math.isfinite(score)
                or not math.isfinite(win_score) or score <= 1.0):
            return False, score
        rate = max(win_score / max(score, 1e-30), 1.0 + 1e-6)
        cannot = (math.log(max(score, 1.0)) * self.STALL_WINDOW
                  > math.log(rate) * remaining_checks)
        return cannot, score

    def plateau_stalled_traced(self, chk: HSDECheck, eps: float, win_score,
                               remaining_checks):
        """(stalled, score) tensors: :meth:`plateau_stalled` on the device,
        ``win_score`` the score one window ago (a tensor) and
        ``remaining_checks`` an int or an int tensor."""
        score = self.stall_score(chk, eps)
        W = float(self.STALL_WINDOW)
        rate = torch.clamp_min(win_score / torch.clamp_min(score, 1e-30),
                               1.0 + 1e-6)
        cannot = (torch.log(torch.clamp_min(score, 1.0)) * W
                  > torch.log(rate) * remaining_checks)
        stalled = ((chk.status == Status.CONTINUE) & torch.isfinite(score)
                   & torch.isfinite(win_score) & (score > 1.0) & cannot)
        return stalled, score

    def _floors(self):
        """(current floor, tightened floor ~sqrt(2l)*eps)."""
        s1 = self.sets.s1
        tight = float(np.sqrt(2.0 * self.l)) * eps_of(self.dtype)
        cur = (s1.tol_floor if s1.tol_floor is not None
               else _default_floor(2 * self.l, self.dtype))
        return float(cur), tight

    def fused_cg_floors(self):
        """(default_floor, tightened_floor) for an on-device recovery, or
        None when it does not apply (direct mode, or the floor already at or
        below the tightened value)."""
        if self.direct:
            return None
        cur, tight = self._floors()
        return None if cur <= tight else (cur, tight)

    def tighten_cg(self):
        """A copy with a ~sqrt(2l)*eps CG floor (None if not tighter):
        recovers gap-stalled f32 runs.  Every field of the projector is
        carried over (:meth:`HSDEAffineProjector.replace`)."""
        floors = self.fused_cg_floors()
        if floors is None:
            return None
        form = self._copy(self.sets.s1.replace(tol_floor=floors[1]))
        form._norms = self._host_norms()
        return form

    def with_operator(self, A) -> "HSDEForm":
        """A copy whose A (in the form and in its projector) is ``A``: a
        sharded operator in place of the replicated data."""
        form = self._copy(self.sets.s1.replace(A=A), A=A)
        form.setup_seconds = getattr(self, "setup_seconds", {})
        return form

    def instances(self, lo: int, hi: int) -> "HSDEForm":
        """A batched form's instances ``[lo, hi)`` as a batched form."""
        def sl(t):
            return None if t is None else t[lo:hi]

        s1 = self.sets.s1
        s1 = s1.replace(A=sl(s1.A), b=sl(s1.b), c=sl(s1.c), fac=sl(s1.fac))
        return HSDEForm(TwoSets(s1, self.sets.s2), sl(self.A), sl(self.b),
                        sl(self.c), sl(self.norm_b), sl(self.norm_c), self.n,
                        self.m, sl(self.dinv), sl(self.einv), self.K2_spec,
                        self.strict_certificates, self.compensated)

    def _copy(self, s1, A=None) -> "HSDEForm":
        form = HSDEForm(TwoSets(s1, self.sets.s2),
                        self.A if A is None else A, self.b, self.c,
                        self.norm_b, self.norm_c, self.n, self.m, self.dinv,
                        self.einv, self.K2_spec, self.strict_certificates,
                        self.compensated)
        form.batch_shard = self.batch_shard
        return form

    # --- engine observability hooks (printing + history) ------------------
    def header(self, init_duration_s: float) -> str:
        from fos_tpu_torch.utils import printing

        head = printing.hsde_header(init_duration_s, self.direct)
        if self.psd_method is None:
            return head
        return f"PSD projection: {self.psd_method}, {self.route} route\n{head}"

    def _cgiter(self, st, cgiter):
        if self.direct:
            return None
        return int(st.s1_state.last_iters) if cgiter is None else cgiter

    def row(self, st, chk: HSDECheck, i: int, t_s: float,
            cgiter=None) -> str:
        """One status-table row; ``chk`` holds host values, ``cgiter`` the
        last projection's CG count read with them (else read from ``st``)."""
        from fos_tpu_torch.utils import printing

        # IEEE division, as the JAX package's device scalars divide: a check
        # at tau = 0 prints inf (or nan), it does not raise
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = float(np.float64(chk.kappa) / np.float64(chk.tau))
        return printing.hsde_row(i, chk.p, chk.d, chk.g, chk.ctx, chk.bty,
                                 ratio, t_s, cgiter=self._cgiter(st, cgiter))

    def record(self, hist, st, chk: HSDECheck, i: int, t_s: float, debug: int,
               extra=None, cgiter=None):
        """History rows (HSDEStatus.jl:125-139): p,d,g,ctx,bty,kappa,tau,t;
        debug>1 also x,y,s.  ``chk`` holds host values, ``cgiter`` as in
        :meth:`row`.  ``extra`` is ignored: the reference's HSDE logextra
        is a no-op (HSDEStatus.jl:18-20)."""
        if hist is None or debug <= 0:
            return
        for key in ("p", "d", "g", "ctx", "bty", "kappa", "tau"):
            hist.push(key, i, float(getattr(chk, key)))
        hist.push("t", i, t_s)
        if not self.direct:
            hist.push("cgiter", i, self._cgiter(st, cgiter))
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
    route: str = None   # HSDEForm.route: "cpu", "graph" or "eager"

    @property
    def optimal(self) -> bool:
        return self.status == "Optimal"


def populate_solution(form: HSDEForm, guess, status_code: int, iters: int,
                      history=None, raw_z=None) -> Solution:
    """(x, y, s) = (u_x, u_y, v_s) / tau; :Continue -> :Indeterminate
    (HSDE.jl:49-61).  A certificate returns the unscaled ray.  With
    equilibration the solution is mapped back: x = E xh, y = D yh,
    s = D^-1 sh (the objective (Ec)'xh = c'x needs no unscaling)."""
    x, y, tau, r, s, kappa = form.split(guess)
    status = Status.name(status_code)
    if status == "Continue":
        status = "Indeterminate"
    if status in ("Unbounded", "Infeasible"):
        tau = torch.ones_like(tau)
    xs, ys, ss = x / tau, y / tau, s / tau
    objval = float(torch.dot(form.c, xs))
    if form.einv is not None:
        xs, ys, ss = xs / form.einv, ys / form.dinv, ss * form.dinv
    return Solution(x=xs, y=ys, s=ss, status=status, objval=objval,
                    iters=iters, history=history, raw_z=raw_z,
                    route=form.route)


def _equilibrate(A, b, c, K1, K2, iters):
    """Ruiz-scale (A, b, c) on the host: (A_s, b_s, c_s, 1/d, 1/e) in the
    dtype and on the device of ``b``.  A scipy A stays scipy (the same
    nonzero pattern, packed afterwards); a dense tensor stays dense."""
    from fos_tpu_torch.problems.scaling import (ruiz_equilibrate,
                                                ruiz_equilibrate_sparse)

    device, dtype = b.device, b.dtype
    bh = b.detach().cpu().numpy()
    ch = c.detach().cpu().numpy()
    if _is_scipy_sparse(A):
        As, bs, cs, d, e = ruiz_equilibrate_sparse(A, bh, ch, K1, K2,
                                                   iters=iters)
        As = As.astype(bh.dtype)
    elif isinstance(A, torch.Tensor):
        As, bs, cs, d, e = ruiz_equilibrate(A.detach().cpu().numpy(), bh, ch,
                                            K1, K2, iters=iters)
        As = torch.as_tensor(As).to(device=device, dtype=dtype)
    else:
        raise ValueError(
            "equilibrate needs A as a dense tensor or sparse data (scipy."
            "sparse or torch sparse COO); equilibrate BEFORE packing A into "
            f"an operator (got {type(A).__name__})")

    def dev(v):
        return torch.as_tensor(v).to(device=device, dtype=dtype)

    return As, dev(bs), dev(cs), dev(1.0 / d), dev(1.0 / e)
