"""Markowitz portfolio through the modeling layer.

The problem ``portfolio.py`` lowers to conic form by hand, written in the
DSL, with a risk-aversion sweep in which each solve warm-starts the next;
checked against scipy's SLSQP.  This is the reference's Convex.jl workflow
(README.md:9-17) on the port.
"""

import numpy as np

from fos_tpu_torch import (AndersonWrapper, DR, Problem, Variable, minimize,
                           sum_squares)


def main(n=50, k=5, gammas=(1.0, 2.0, 5.0, 10.0), device=None):
    rng = np.random.default_rng(1)
    # n assets, k factors
    F = rng.standard_normal((n, k)) * 0.1
    d = np.abs(rng.standard_normal(n)) * 0.05 + 0.01
    mu = rng.standard_normal(n) * 0.03
    S = F @ F.T + np.diag(d)
    Shalf = np.linalg.cholesky(S).T    # w' S w = ||Shalf w||^2

    prev = None
    for gamma in gammas:
        w = Variable(n)
        prob = Problem(
            minimize(gamma * sum_squares(Shalf @ w) - mu @ w),
            [np.ones((1, n)) @ w == 1.0, w >= 0.0],
        )
        # plain GAPA/DR converge but certify slowly on this badly scaled
        # instance (the gap decays ~2% per 100 iterations); the adaptive
        # Anderson wrapper closes it in a few hundred iterations
        sol = prob.solve(alg=AndersonWrapper(alg=DR(), adaptive=True),
                         eps=1e-8, max_iters=60000, verbose=0,
                         warm_start=prev, device=device)
        prev = sol

        # SLSQP oracle
        from scipy.optimize import minimize as sp_min

        ref = sp_min(lambda v: gamma * v @ S @ v - mu @ v,
                     np.full(n, 1.0 / n),
                     jac=lambda v: 2 * gamma * S @ v - mu,
                     constraints=[{"type": "eq",
                                   "fun": lambda v: v.sum() - 1.0}],
                     bounds=[(0, None)] * n, method="SLSQP",
                     options={"maxiter": 500, "ftol": 1e-12})
        err = abs(prob.value - ref.fun) / (1 + abs(ref.fun))
        print(f"gamma={gamma:5.1f}  status={prob.status}  iters={sol.iters:5d}"
              f"  obj={prob.value:+.6f}  vs SLSQP rel err {err:.1e}")
        assert prob.status == "Optimal" and err < 1e-5


if __name__ == "__main__":
    main()
