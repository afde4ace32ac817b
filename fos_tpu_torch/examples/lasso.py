"""SOCP lasso: min 1/2 ||Ax - b||^2 + lam * ||x||_1.

Two routes to the same answer:

* a hand-built conic form: split x = xp - xm with xp, xm >= 0, and the
  epigraph t >= ||Ax - b||^2 through a rotated SOC;
* the modeling DSL one-liner:
  ``minimize(0.5 * sum_squares(A @ x - b) + lam * norm1(x))``.

Both are checked against proximal gradient (ISTA) on the host in f64.
"""

import numpy as np

from fos_tpu_torch import DR, FISTA, GAPP, solve
from fos_tpu_torch.cones import ConeSpec, zero
from fos_tpu_torch.cones.spec import Cone


def lasso_conic(A, b, lam):
    m, n = A.shape
    # variables: (xp[n], xm[n], t, q, w[m])
    nv = 2 * n + 2 + m
    rows = m + 1
    Ac = np.zeros((rows, nv))
    bc = np.zeros(rows)
    Ac[:m, :n] = A
    Ac[:m, n : 2 * n] = -A
    Ac[:m, 2 * n + 2 :] = -np.eye(m)
    bc[:m] = b                       # A(xp-xm) - w = b
    Ac[m, 2 * n + 1] = 1.0
    bc[m] = 0.5                      # q = 1/2
    c = np.concatenate([np.full(n, lam), np.full(n, lam), [0.5], [0.0],
                        np.zeros(m)])
    # minimize 0.5 t + lam*1'(xp+xm)
    c[2 * n] = 0.5
    K1 = zero(rows)
    K2 = ConeSpec(((Cone.NONNEG, 2 * n), (Cone.SOC_ROTATED, 2 + m)))
    return Ac, bc, c, K1, K2


def lasso_data(m, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    xtrue = np.zeros(n)
    xtrue[rng.choice(n, 8, replace=False)] = rng.standard_normal(8) * 3
    b = A @ xtrue + 0.01 * rng.standard_normal(m)
    return A, b


def ista(A, b, lam, iters=20000):
    """Proximal gradient on the host in f64: the oracle."""
    L = np.linalg.norm(A, 2) ** 2
    xk = np.zeros(A.shape[1])
    for _ in range(iters):
        g = A.T @ (A @ xk - b)
        xk = xk - g / L
        xk = np.sign(xk) * np.maximum(np.abs(xk) - lam / L, 0)
    return 0.5 * np.sum((A @ xk - b) ** 2) + lam * np.abs(xk).sum()


def main(alg=None, m=60, n=120, device=None):
    A, b = lasso_data(m, n)
    lam = 0.05

    Ac, bc, c, K1, K2 = lasso_conic(A, b, lam)
    alg = alg or GAPP(iproj=100)
    sol = solve(Ac, bc, c, K1, K2, alg=alg, eps=1e-7, max_iters=40000,
                verbose=0, device=device)
    xs = sol.x.cpu().numpy()
    x = xs[:n] - xs[n : 2 * n]
    obj = 0.5 * np.sum((A @ x - b) ** 2) + lam * np.abs(x).sum()
    print(f"{type(alg).__name__}: status={sol.status} obj={obj:.8f} "
          f"nnz={np.sum(np.abs(x) > 1e-4)} iters={sol.iters}")

    obj_ref = ista(A, b, lam)
    print(f"ISTA oracle obj: {obj_ref:.8f}")
    assert obj <= obj_ref + 1e-4 * (1 + abs(obj_ref))
    return sol


def main_dsl(m=60, n=120, device=None):
    """The same lasso through the modeling layer (norm1 atom)."""
    from fos_tpu_torch import Problem, Variable, minimize, norm1, sum_squares

    A, b = lasso_data(m, n)
    lam = 0.05

    x = Variable(n)
    prob = Problem(minimize(0.5 * sum_squares(A @ x - b) + lam * norm1(x)))
    prob.solve(alg=DR(), eps=1e-7, max_iters=40000, verbose=0, device=device)
    xs = np.asarray(x.value)
    obj = 0.5 * np.sum((A @ xs - b) ** 2) + lam * np.abs(xs).sum()
    print(f"DSL (norm1 atom): status={prob.status} obj={obj:.8f} "
          f"nnz={np.sum(np.abs(xs) > 1e-4)}")
    obj_ref = ista(A, b, lam)
    print(f"ISTA oracle obj: {obj_ref:.8f}")
    assert obj <= obj_ref + 1e-4 * (1 + abs(obj_ref))
    return prob


if __name__ == "__main__":
    main()
    main(alg=FISTA())
    main(alg=DR())
    main_dsl()
