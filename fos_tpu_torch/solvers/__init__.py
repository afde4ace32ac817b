from fos_tpu_torch.solvers.base import (  # noqa: F401
    AP,
    Algorithm,
    ConeSet,
    DR,
    GAP,
    SolverState,
    TwoSets,
    init_solver_state,
)
from fos_tpu_torch.solvers.status import Status  # noqa: F401
from fos_tpu_torch.solvers import engine  # noqa: F401
