"""bench.py's single-block SDP instance as a file, and GAPA on an HSDE form.

The card has no JAX, so ``fos_tpu_torch/tools/data`` carries the matrices
bench.py draws from ``PRNGKey(29)``; here they are drawn again with JAX
and compared bit for bit, and their f64 lambda_min is held to the oracle
the TPU run recorded (BENCH_r05.json).  Then GAPA(0.8, 0.9), the SDP
cells' quality algorithm, runs 100 and 200 steps on the lambda-min SDP's
HSDE form in both packages from one start (f64, eigh).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fos_tpu
from fos_tpu.cones.project import svec as jsvec
from fos_tpu.cones.spec import Cone as JCone, ConeSpec as JSpec
from fos_tpu.problems.conic import conic_problem as jconic
from fos_tpu.problems.hsde import HSDEForm as JForm
from fos_tpu.solvers import engine as jengine

import fos_tpu_torch
from fos_tpu_torch.cones import Cone, ConeSpec, free, svec
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.hsde import HSDEForm as TForm
from fos_tpu_torch.solvers import engine as tengine
from fos_tpu_torch.tools import sdp_instance

#: BENCH_r05.json's lam_min_f64_oracle of sdp_single_512 / _1024 as printed
#: there, and half a unit of the last digit printed
ORACLE = {512: (-1.390676, 5e-7), 1024: (-1.40116, 5e-6)}


@pytest.mark.parametrize("d", sdp_instance.SIDES)
def test_instance_file_is_the_prngkey29_draw(d):
    """The stored lower triangle equals bench.py:380-382's draw bit for bit,
    and its f64 lambda_min matches the TPU run's oracle to its printed
    digits."""
    C = jax.random.normal(jax.random.PRNGKey(29), (d, d), jnp.float32)
    C = C / float(np.sqrt(d))
    C = np.asarray((C + C.T) / 2)
    stored = np.load(sdp_instance.path(d))
    assert stored.dtype == np.float32
    assert np.array_equal(stored, C[np.tril_indices(d)])
    full = sdp_instance.load(d)
    assert np.array_equal(full, C)
    lam = np.linalg.eigvalsh(full.astype(np.float64))[0]
    want, half_digit = ORACLE[d]
    assert abs(lam - want) <= half_digit


def _lambda_min_sdp(d, seed=3):
    """The lambda-min SDP ``min <C, X> s.t. tr X = 1, X psd`` with a dense
    A = [svec(I)'; -I_L] (bench.py's construction) at a small side."""
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((d, d)) / np.sqrt(d)
    C = (C + C.T) / 2
    L = d * (d + 1) // 2
    sI = np.asarray(jsvec(jnp.eye(d), scaled=True))
    A = np.concatenate([sI[None, :], -np.eye(L)], 0)
    b = np.zeros(1 + L)
    b[0] = 1.0
    return C, A, b, np.asarray(jsvec(jnp.asarray(C), scaled=True)), L


@functools.lru_cache(maxsize=None)
def _jax_gapa(d, steps, nudge=0.0):
    """The JAX package's GAPA(0.8, 0.9) state after ``steps`` steps from
    tau = kappa = 1, the first entry moved by ``nudge``."""
    C, A, b, sC, L = _lambda_min_sdp(d)
    K1 = JSpec(((JCone.ZERO, 1), (JCone.PSD, L)))
    form = JForm.build(jconic(jnp.asarray(A), jnp.asarray(b), jnp.asarray(sC),
                              K1, fos_tpu.cones.free(L)), psd_method="eigh")
    x0 = form.initial_value(form.dtype).at[0].add(nudge)
    res = jengine.fused_solve(fos_tpu.GAPA(0.8, 0.9), form, x0,
                              max_iters=steps, eps=0.0, checki=steps)
    return np.asarray(res.state.x), float(res.state.aux), np.asarray(res.guess)


def _port_gapa(d, steps):
    C, A, b, sC, L = _lambda_min_sdp(d)
    K1 = ConeSpec(((Cone.ZERO, 1), (Cone.PSD, L)))
    form = TForm.build(tconic(A, b, sC, K1, free(L), device="cpu"),
                       psd_method="eigh")
    res = tengine.fused_solve(fos_tpu_torch.GAPA(0.8, 0.9), form,
                              form.initial_value(form.dtype),
                              max_iters=steps, eps=0.0, checki=steps)
    assert int(res.iters) == steps
    return res.state.x.numpy(), float(res.state.aux), res.guess.numpy()


def test_gapa_on_hsde_matches_jax():
    """GAPA(0.8, 0.9) on the d=6 lambda-min SDP's HSDE form from tau =
    kappa = 1 in both packages (f64, PSD by eigh), the port's svec of C
    equal to the JAX package's.

    After 100 steps iterate, adaptive a12 and guess agree within 1e-11.
    GAPA's a12 comes from the angle between two differences of converging
    iterates, which amplifies rounding about 1e4-fold per 100 steps here
    (DR on the same form stays within 1e-14 for 400 steps): the JAX package
    started from a first entry moved by 1e-16 differs from itself by 1.5e-9
    after 200 steps.  So after 200 steps the port is held to 1e-9 plus ten
    times that spread of the reference's own."""
    d = 6
    C, A, b, sC, L = _lambda_min_sdp(d)
    assert np.allclose(svec(torch.from_numpy(C)).numpy(), sC, rtol=0,
                       atol=1e-15)
    for steps, tol in ((100, 1e-11), (200, None)):
        x, a12, guess = _port_gapa(d, steps)
        jx, ja, jg = _jax_gapa(d, steps)
        if tol is None:
            spread = np.abs(_jax_gapa(d, steps, 1e-16)[0] - jx).max()
            tol = 1e-9 + 10.0 * spread
        np.testing.assert_allclose(x, jx, rtol=0, atol=tol)
        assert abs(a12 - ja) <= tol
        np.testing.assert_allclose(guess, jg, rtol=0, atol=tol)
