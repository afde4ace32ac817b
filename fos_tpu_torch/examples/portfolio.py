"""Markowitz portfolio: max mu'w - gamma * w'S w  s.t.  1'w = 1, w >= 0.

SOCP form through the factor model S = F F' + diag(d): minimize
gamma * t - mu'w with ||(F'w, sqrt(d) * w)||^2 <= t (a rotated SOC
epigraph); checked against scipy's SLSQP.
"""

import numpy as np

from fos_tpu_torch import DR, solve
from fos_tpu_torch.cones import ConeSpec, zero
from fos_tpu_torch.cones.spec import Cone


def main(n=50, k=5, device=None):
    rng = np.random.default_rng(1)
    # n assets, k factors
    F = rng.standard_normal((n, k)) * 0.1
    d = np.abs(rng.standard_normal(n)) * 0.05 + 0.01
    mu = rng.standard_normal(n) * 0.03
    gamma = 5.0
    S = F @ F.T + np.diag(d)

    # variables: (w[n], t, q, v[k+n])   v = (F'w, sqrt(d)*w)
    nv = n + 2 + k + n
    rows = (k + n) + 1 + 1
    Ac = np.zeros((rows, nv))
    bc = np.zeros(rows)
    # v1 = F'w
    Ac[:k, :n] = F.T
    Ac[:k, n + 2 : n + 2 + k] = -np.eye(k)
    # v2 = sqrt(d) w
    Ac[k : k + n, :n] = np.diag(np.sqrt(d))
    Ac[k : k + n, n + 2 + k :] = -np.eye(n)
    # q = 1/2
    Ac[k + n, n + 1] = 1.0
    bc[k + n] = 0.5
    # 1'w = 1
    Ac[k + n + 1, :n] = 1.0
    bc[k + n + 1] = 1.0
    c = np.zeros(nv)
    c[:n] = -mu
    c[n] = gamma
    K1 = zero(rows)
    K2 = ConeSpec(((Cone.NONNEG, n), (Cone.SOC_ROTATED, 2 + k + n)))

    sol = solve(Ac, bc, c, K1, K2, alg=DR(), eps=1e-8, max_iters=60000,
                verbose=0, device=device)
    w = sol.x[:n].cpu().numpy()
    obj = -mu @ w + gamma * (w @ S @ w)
    print(f"status={sol.status} obj={obj:.8f} sum(w)={w.sum():.6f} "
          f"min(w)={w.min():.2e} iters={sol.iters}")

    # oracle: SLSQP
    from scipy.optimize import minimize

    res = minimize(lambda w: -mu @ w + gamma * (w @ S @ w), np.full(n, 1 / n),
                   constraints=[{"type": "eq", "fun": lambda w: w.sum() - 1}],
                   bounds=[(0, None)] * n, method="SLSQP",
                   options={"maxiter": 500, "ftol": 1e-14})
    print(f"SLSQP oracle obj: {res.fun:.8f}")
    assert abs(obj - res.fun) < 1e-5 * (1 + abs(res.fun))
    return sol


if __name__ == "__main__":
    main()
