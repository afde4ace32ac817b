"""Where DR reaches the fixed point that diff_solve differentiates, in both
packages (fos_tpu.diff and fos_tpu_torch.diff, CPU, f64).

tests/test_diff.py's LP construction (a unique, strictly complementary
optimum on k columns and k rows) has a k x k Gaussian basis block.  From
64x96 up that block is ill-conditioned, DR creeps toward the optimum, and
the gradients are no better than the iterate: the JAX package and the port
stop at the same distance and give the same errors, so the shortfall is
the algorithm's, not the port's.  The same construction with an
orthogonal basis block (fos_tpu_torch/tools/lps.py) reaches its fixed
point in a few hundred iterations in both, with gradients at f64 accuracy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fos_tpu.cones import nonneg as jax_nonneg
from fos_tpu.diff import diff_solve as jax_diff_solve
from fos_tpu.solvers.base import DR as JaxDR

import fos_tpu_torch as T
from fos_tpu_torch.tools.lps import nondegenerate_lp, orthogonal_basis_lp

M, N, K, SEED = 64, 96, 32, 41
# the options of each basis: for the Gaussian one a short forward and a
# capped adjoint, enough to show where each package stops (it never
# reaches eps); the orthogonal one reaches eps and the adjoint's tolerance
OPTS = {"gaussian": dict(eps=1e-8, max_iters=5000, adjoint_iters=30),
        "orthogonal": dict(eps=1e-8, max_iters=10000, adjoint_iters=100)}


def _errors(x, g, x0, y0):
    """(x, g_c, g_b, g_A) against the construction's optimum, scaled by
    1 + ||x0|| + ||y0||."""
    gA, gb, gc = (np.asarray(t, dtype=np.float64) for t in g)
    scale = 1.0 + np.abs(x0).max() + np.abs(y0).max()
    return np.array([np.abs(np.asarray(x) - x0).max(),
                     np.abs(gc - x0).max(), np.abs(gb + y0).max(),
                     np.abs(gA - np.outer(y0, x0)).max()]) / scale


def _both(make, opts):
    """Each package's DR(direct=True) gradient of c'x in (A, b, c) under
    ``opts``: (errors, x, gradients) for JAX, then (errors, x, gradients,
    forward status) for the port."""
    A, b, c, x0, y0 = make(np.random.default_rng(SEED), M, N, K)

    def objective(A, b, c):
        x, _, _ = jax_diff_solve(A, b, c, jax_nonneg(M), jax_nonneg(N),
                                 alg=JaxDR(direct=True), **opts)
        return jnp.vdot(c, x), x

    jg, jx = jax.grad(objective, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    data = [torch.tensor(t, requires_grad=True) for t in (A, b, c)]
    stats = {}
    x, _, _ = T.diff_solve(*data, T.nonneg(M), T.nonneg(N),
                           alg=T.DR(direct=True), device="cpu", stats=stats,
                           **opts)
    pg = [t.numpy() for t in torch.autograd.grad(torch.dot(data[2], x),
                                                 data)]
    xp = x.detach().numpy()
    return ((_errors(jx, jg, x0, y0), np.asarray(jx),
             [np.asarray(t) for t in jg]),
            (_errors(xp, pg, x0, y0), xp, pg, int(stats["status"])))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its solves are small and eager,
    and the suite runs several worker processes on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=["gaussian", "orthogonal"])
def basis(request):
    make = {"gaussian": nondegenerate_lp,
            "orthogonal": orthogonal_basis_lp}[request.param]
    return request.param, _both(make, OPTS[request.param])


def test_both_packages_stop_at_the_same_place(basis):
    """Gaussian basis: both packages stop ~3e-3 from the optimum with
    gradients ~1e-2 off, within 10% of each other.  Orthogonal basis: both
    reach the optimum (Optimal), gradients within tests/test_diff.py's
    5e-5, and agree with each other to 1e-8."""
    name, ((jerr, jx, jg), (perr, px, pg, status)) = basis
    if name == "gaussian":
        assert status == 0  # still running at the budget
        assert jerr.min() > 1e-3 and perr.min() > 1e-3
        np.testing.assert_allclose(perr, jerr, rtol=0.1)
    else:
        assert status == 1
        assert jerr.max() <= 5e-5 and perr.max() <= 5e-5
        np.testing.assert_allclose(px, jx, atol=1e-8)
        for p, j in zip(pg, jg):
            np.testing.assert_allclose(p, j, atol=1e-8)
