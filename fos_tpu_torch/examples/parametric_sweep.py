"""Parametric sweep with warm starts.

Tracing a family of related problems (here an LP whose right-hand side
drifts along a path) is the everyday workload of first-order solvers: each
solution seeds the next solve through ``Solution.raw_z`` (the reference's
``initx`` hook, solverwrapper.jl:10, composed across solves).
"""

import numpy as np

from fos_tpu_torch import GAPA, nonneg, solve


def main(steps=5, m=30, n=45, device=None):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, n))
    x0 = np.abs(rng.standard_normal(n))
    b0 = A @ x0 + np.abs(rng.standard_normal(m))
    c = np.abs(rng.standard_normal(n))
    drift = np.abs(rng.standard_normal(m)) * 0.001

    cold_total = warm_total = 0
    z = None
    for k in range(steps):
        b = b0 + k * drift
        cold = solve(A, b, c, nonneg(m), nonneg(n), alg=GAPA(), eps=1e-7,
                     verbose=0, max_iters=60000, device=device)
        warm = solve(A, b, c, nonneg(m), nonneg(n), alg=GAPA(), eps=1e-7,
                     verbose=0, max_iters=60000, initx=z, device=device)
        z = warm.raw_z
        # the warm start changes the path, not the answer
        assert cold.status == warm.status == "Optimal"
        assert abs(warm.objval - cold.objval) <= 1e-5 * (1 + abs(cold.objval))
        cold_total += cold.iters
        warm_total += warm.iters
        print(f"step {k}: cold {cold.iters:>5} iters, "
              f"warm {warm.iters:>5} iters, obj {warm.objval:+.5f} "
              f"({warm.status})")
    print(f"total: cold {cold_total}, warm {warm_total} "
          f"({cold_total / max(warm_total, 1):.1f}x fewer with warm starts)")


if __name__ == "__main__":
    main()
