"""``solve(..., refine=N)`` of fos_tpu_torch against the JAX package's: the
f64 sweep that continues a solve from its final iterate.

The same numpy-seeded LP (12 x 20, with a primal-dual certificate) goes
through both packages on the CPU: an f64 solve refined in f64 (statuses,
the iterations of both stages, the answer), and an f32 solve with Ruiz
equilibration refined in f64 from the scaled iterate (the sweep's form is
rebuilt with the same scaling).
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

import fos_tpu
import fos_tpu_torch as T

M, N = 12, 20


def _lp(seed=1):
    """tests/test_parallel.py's certificate construction: (A, b, c, f*)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    xm = rng.random(N) < 0.5
    ym = rng.random(M) < 0.5
    x0 = np.abs(rng.standard_normal(N)) * xm
    r0 = np.abs(rng.standard_normal(N)) * ~xm
    y0 = np.abs(rng.standard_normal(M)) * ym
    s0 = np.abs(rng.standard_normal(M)) * ~ym
    c = r0 - A.T @ y0
    return A, A @ x0 + s0, c, float(c @ x0)


OPTS = dict(eps=1e-5, max_iters=3000, verbose=0, refine=3000,
            refine_kwargs={"eps": 1e-9})


@functools.lru_cache(maxsize=None)
def _jax(dtype, **kw):
    A, b, c, _ = _lp()
    sol = fos_tpu.solve(A, b, c, fos_tpu.cones.nonneg(M),
                        fos_tpu.cones.nonneg(N), alg=fos_tpu.DR(),
                        dtype=getattr(jnp, dtype), **OPTS, **kw)
    return sol.status, sol.iters, np.asarray(sol.x), sol.objval


def _port(dtype, **kw):
    A, b, c, _ = _lp()
    return T.solve(A, b, c, T.nonneg(M), T.nonneg(N), alg=T.DR(),
                   dtype=getattr(torch, dtype), device="cpu", **OPTS, **kw)


def test_refine_f64_matches_jax():
    """f64 solve at eps 1e-5, refined at eps 1e-9: Optimal in both
    packages at the same total iteration count (the stages' counts add
    up), the objective within 1e-8 of the certificate and of the JAX
    package's, the answer primal feasible to 1e-8; the sweep is f64.
    (The LP's optimal x is not unique: the two packages' answers differ
    by 1.5e-5 at the same objective.)"""
    A, b, c, opt = _lp()
    sol = _port("float64")
    status, iters, x, obj = _jax("float64")
    plain = T.solve(A, b, c, T.nonneg(M), T.nonneg(N), alg=T.DR(),
                    device="cpu", eps=1e-5, max_iters=3000, verbose=0)
    assert sol.status == status == "Optimal"
    assert sol.iters == iters > plain.iters
    assert sol.x.dtype == torch.float64
    assert abs(sol.objval - opt) <= 1e-8 * (1 + abs(opt))
    assert abs(sol.objval - obj) <= 1e-8 * (1 + abs(opt))
    xs = sol.x.numpy()
    assert xs.min() >= -1e-8 and (A @ xs - b).max() <= 1e-8


def test_refine_f32_equilibrated_matches_jax():
    """f32 solve with ``equilibrate=True`` at eps 1e-5, refined in f64 from
    the Ruiz-scaled iterate: Optimal at the JAX package's total iteration
    count, the objective within 1e-8 of the certificate and of the JAX
    package's, and the sweep f64.  Its form is rebuilt from the f64 data
    as passed (the f32-rounded LP is another problem: refined on it the
    sweep stalls 5e-7 from its optimum for 20000 iterations) with the
    solve's scaling (the iterate lives in scaled coordinates)."""
    A, b, c, opt = _lp()
    sol = _port("float32", equilibrate=True)
    status, iters, x, obj = _jax("float32", equilibrate=True)
    assert sol.status == status == "Optimal"
    assert sol.iters == iters
    assert sol.x.dtype == torch.float64
    assert abs(sol.objval - opt) <= 1e-8 * (1 + abs(opt))
    assert abs(sol.objval - obj) <= 1e-8 * (1 + abs(opt))
