from fos_tpu_torch.interface.api import solve, solve_feasibility  # noqa: F401
