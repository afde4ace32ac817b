from fos_tpu_torch.problems.conic import ConicProblem, conic_problem  # noqa: F401
from fos_tpu_torch.problems.hsde import HSDEForm, Solution, populate_solution  # noqa: F401
