from fos_tpu_torch.interface.api import solve, solve_feasibility  # noqa: F401
from fos_tpu_torch.interface.conic import (  # noqa: F401
    load_problem,
    solve_lp,
    solve_scs,
    supported_cones,
)
from fos_tpu_torch.interface.cvxpy_adapter import (  # noqa: F401
    register_with_cvxpy,
    solve_conic_data,
)
