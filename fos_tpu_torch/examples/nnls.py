"""Nonnegative least squares: the reference README problem.

min ||Ax - b||^2  s.t.  x >= 0, solved two ways:

1. as a conic program through the HSDE (``fos_tpu_torch.solve``);
2. as a feasibility problem over the KKT conditions;

and checked against scipy's ``nnls``.
"""

import numpy as np

from fos_tpu_torch import DR, GAPA, Feasibility, solve, solve_feasibility
from fos_tpu_torch.cones import ConeSpec, zero
from fos_tpu_torch.cones.spec import Cone
from fos_tpu_torch.sets import AffineSet, NonNeg


def conic_form(A, b):
    """min t s.t. (t, 1/2 slot, Ax - b) in rotated SOC, x >= 0."""
    m, n = A.shape
    nv = n + 2 + m
    Ac = np.zeros((m + 1, nv))
    bc = np.zeros(m + 1)
    Ac[:m, :n] = A
    Ac[:m, n + 2 :] = -np.eye(m)
    bc[:m] = b
    Ac[m, n + 1] = 1.0
    bc[m] = 0.5
    c = np.zeros(nv)
    c[n] = 1.0
    K1 = zero(m + 1)
    K2 = ConeSpec(((Cone.NONNEG, n), (Cone.SOC_ROTATED, 2 + m)))
    return Ac, bc, c, K1, K2


def main(m=40, n=50, device=None):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)

    # way 1: conic / HSDE
    Ac, bc, c, K1, K2 = conic_form(A, b)
    sol = solve(Ac, bc, c, K1, K2, alg=DR(), eps=1e-8, max_iters=20000,
                verbose=1, device=device)
    x1 = sol.x[:n].cpu().numpy()
    obj1 = np.sum((A @ x1 - b) ** 2)
    print(f"conic/HSDE: status={sol.status} obj={obj1:.12f} iters={sol.iters}")

    # way 2: the KKT conditions as a feasibility problem: DR/GAPA iterations
    # between the affine set {(x, g): A'A x - g = A'b} and (x, g) >= 0
    # (the polyhedral part; complementarity is left to the iteration)
    AtA = A.T @ A
    Atb = A.T @ b
    kkt = np.concatenate([AtA, -np.eye(n)], axis=1)  # A'A x - g = A'b
    S1 = AffineSet.create(kkt, Atb, device=device)
    S2 = NonNeg()
    sol2 = solve_feasibility(Feasibility(S1, S2, 2 * n), GAPA(), eps=1e-10,
                             max_iters=20000, verbose=0, device=device)
    xg = sol2.x.cpu().numpy()
    x2, g2 = xg[:n], xg[n:]
    print(f"KKT feasibility: status={sol2.status} "
          f"||A'Ax-g-A'b||={np.abs(AtA @ x2 - g2 - Atb).max():.2e} "
          f"min(x)={x2.min():.2e}")

    from scipy.optimize import nnls

    xs, rn = nnls(A, b)
    print(f"scipy nnls objective: {rn**2:.12f}")
    assert abs(obj1 - rn**2) / rn**2 < 1e-6
    return sol


if __name__ == "__main__":
    main()
