from fos_tpu_torch.solvers.base import (  # noqa: F401
    AP,
    Algorithm,
    ConeSet,
    DR,
    Dykstra,
    FISTA,
    GAP,
    GAPA,
    GAPP,
    SolverState,
    TwoSets,
    init_solver_state,
)
from fos_tpu_torch.solvers.wrappers import (  # noqa: F401
    AndersonWrapper,
    LineSearchWrapper,
    LongstepWrapper,
)
from fos_tpu_torch.solvers.status import Status  # noqa: F401
from fos_tpu_torch.solvers import engine  # noqa: F401
