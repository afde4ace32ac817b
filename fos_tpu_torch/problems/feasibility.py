"""Set-feasibility problem form: find x in S1 ∩ S2.

The port of ``fos_tpu.problems.feasibility`` (reference: Feasibility.jl,
FeasibilityStatus.jl).  The sets pass straight through to the algorithm
(Feasibility.jl:75-81); convergence is ``||z_k - z_{k-1}|| <= eps`` between
consecutive post-S2 points (FeasibilityStatus.jl:32-72: ``stat.prev``
moves every iteration), an absolute test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fos_tpu_torch.solvers.base import TwoSets
from fos_tpu_torch.solvers.status import Status


class Feasibility(NamedTuple):
    """Problem container (Feasibility.jl:2-6)."""

    S1: object
    S2: object
    n: int


class FeasibilityCheck(NamedTuple):
    status: torch.Tensor  # int32 Status code
    err: torch.Tensor

    def to_host(self) -> "FeasibilityCheck":
        """The same check as Python numbers, read in one device transfer."""
        status, err = torch.stack([v.to(torch.float64) for v in self]).tolist()
        return FeasibilityCheck(int(status), err)


class FeasibilitySolution(NamedTuple):
    """``state`` is the final solver state (the sets' states hold, e.g.,
    the affine projection's CG counts)."""

    x: torch.Tensor
    status: str
    iters: int
    history: object = None
    state: object = None

    @property
    def optimal(self) -> bool:
        return self.status == "Optimal"


def _data_dtype(s):
    """The dtype of a set's data, looking into products of sets; None for
    sets without data."""
    dtype = getattr(s, "dtype", None)
    if dtype is None:
        for member in getattr(s, "sets", ()):
            dtype = dtype or _data_dtype(member)
    return dtype


class FeasibilityForm:
    """Problem form driving the iteration engine."""

    def __init__(self, sets: TwoSets, n: int, dtype, device):
        self.sets = sets
        self.n = n
        self.dtype = dtype
        self.device = device

    @classmethod
    def build(cls, problem: Feasibility, dtype=None,
              device=None) -> "FeasibilityForm":
        """``dtype``: the iterate's; by default the dtype of the sets' data
        (S1's first), else torch's default dtype.  ``device``: where the
        iterate lives (the sets' data must live there too)."""
        dtype = (dtype or _data_dtype(problem.S1) or _data_dtype(problem.S2)
                 or torch.get_default_dtype())
        return cls(TwoSets(problem.S1, problem.S2), int(problem.n), dtype,
                   torch.device(device))

    @property
    def direct(self) -> bool:
        # the reference's feasibility status prints the table without the
        # cg column (Feasibility.jl:76)
        return True

    def initial_value(self, dtype):
        return torch.zeros(self.n, dtype=dtype, device=self.device)

    def check(self, z, eps: float, prev=None) -> FeasibilityCheck:
        err = torch.linalg.vector_norm(prev - z)
        status = torch.where(
            err <= eps,
            torch.tensor(Status.OPTIMAL, dtype=torch.int32, device=z.device),
            torch.tensor(Status.CONTINUE, dtype=torch.int32, device=z.device))
        return FeasibilityCheck(status, err)

    # --- engine observability hooks (printing + history) ------------------
    def header(self, init_duration_s: float) -> str:
        from fos_tpu_torch.utils import printing

        return printing.feasibility_header(init_duration_s, self.direct)

    def row(self, st, chk: FeasibilityCheck, i: int, t_s: float) -> str:
        from fos_tpu_torch.utils import printing

        return printing.feasibility_row(i, chk.err, t_s)

    @property
    def wants_extra(self) -> bool:
        """Feasibility runs record logextra snapshots (FeasibilityStatus
        saves them, FeasibilityStatus.jl:19-25)."""
        return True

    def record(self, hist, st, chk: FeasibilityCheck, i: int, t_s: float,
               debug: int, extra=None):
        """History rows: err and t; ``extra`` (the check iteration's
        S1-stage triple) when given; debug > 1 also the post-S2 point."""
        if hist is None or debug <= 0:
            return
        hist.push("err", i, float(chk.err))
        hist.push("t", i, t_s)
        if extra is not None:
            hist.push("extra", i, list(extra.cpu().numpy()))
        if debug > 1:
            hist.push("z", i, st.z_check.cpu().numpy())


def populate_feasibility_solution(form, guess, status_code: int, iters: int,
                                  history=None, state=None) -> FeasibilitySolution:
    """:Continue becomes :Indeterminate (Feasibility.jl)."""
    status = Status.name(status_code)
    if status == "Continue":
        status = "Indeterminate"
    return FeasibilitySolution(x=guess, status=status, iters=iters,
                               history=history, state=state)
