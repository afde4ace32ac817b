"""fos_tpu_torch's set-feasibility path against the JAX package, on the CPU
at f64 unless stated: AffinePlusLinearProjector (oracle, large cond, over a
tile operator), the sets library, the feasibility solves of
tests/test_feasibility.py, a solver state carried across from JAX mid-solve,
the whole slice at small size, and the entry points' default device.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

import fos_tpu
from fos_tpu.interface.api import solve_feasibility as jsolve
from fos_tpu.linalg.affine import AffinePlusLinearProjector as JAPL
from fos_tpu.problems.feasibility import (Feasibility as JFeas,
                                          FeasibilityForm as JForm)
from fos_tpu.solvers import engine as jengine
from fos_tpu.solvers.base import init_solver_state as jinit
from fos_tpu.solvers.status import Status
from fos_tpu.utils import printing as jprinting
import fos_tpu.sets as jsets

import chip_smoke
import fos_tpu_torch as T
from fos_tpu_torch import interop
from fos_tpu_torch.linalg.affine import _ls_projection_fac
from fos_tpu_torch.problems.feasibility import FeasibilityForm as TForm
from fos_tpu_torch.solvers import engine as tengine
from fos_tpu_torch.solvers.base import init_solver_state as tinit
from fos_tpu_torch.utils import printing as tprinting

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


# ------------------------------------------------ AffinePlusLinearProjector
@pytest.mark.parametrize("beta", [1, -1])
@pytest.mark.parametrize("direct", [False, True])
def test_affine_plus_linear_oracle(beta, direct):
    """test_linalg.py::test_affine_plus_linear_oracle: the prox equals the
    closed-form KKT solve (affinepluslinear.jl:46-68), to 1e-9, and the
    JAX projector's output."""
    rng = np.random.default_rng(0)
    m, n = 7, 12
    A, b, q = (rng.standard_normal(s) for s in ((m, n), m, n))
    x = rng.standard_normal(n + m)
    tp = T.AffinePlusLinearProjector.create(A, b, q, beta, direct=direct,
                                            device=CPU)
    y, st = tp.project(_t(x), tp.init_cg_state(torch.float64))
    lam = np.linalg.solve(np.eye(m) + A @ A.T,
                          A @ (x[:n] - q) - beta * x[n:] - b)
    want = np.concatenate([x[:n] - q - A.T @ lam, x[n:] + beta * lam])
    np.testing.assert_allclose(y.numpy(), want, atol=1e-9)
    np.testing.assert_allclose(A @ y[:n].numpy() - beta * y[n:].numpy(), b,
                               atol=1e-9)
    jp = JAPL.create(jnp.asarray(A), jnp.asarray(b), jnp.asarray(q), beta,
                     direct=direct)
    jy, jst = jp.project(jnp.asarray(x), jp.init_cg_state(jnp.float64))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-9)
    assert int(st.last_iters) == int(jst.last_iters)
    assert int(st.call_idx) == int(jst.call_idx) == 2


def test_affine_plus_linear_large_cond():
    """test_linalg.py::test_direct_mode_qr_large_sigma_max's projector
    part: sigma_max(A) = 1e7; the host f64 QR of [A'; I] keeps the error
    at 1e-7 relative (a Cholesky of I + AA' would square the cond)."""
    rng = np.random.default_rng(0)
    m, n = 30, 20
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = U[:, :n] @ np.diag(np.logspace(7, 0, n)) @ V.T
    b, q = rng.standard_normal(m), rng.standard_normal(n)
    for beta in (1, -1):
        pp = T.AffinePlusLinearProjector.create(A, b, q, beta, direct=True,
                                                device=CPU)
        x = rng.standard_normal(n + m)
        yp, _ = pp.project(_t(x), pp.init_cg_state(torch.float64))
        zls = np.concatenate([x[:n] - q, -(beta * x[n:] + b)])
        lam = np.linalg.lstsq(np.vstack([A.T, np.eye(m)]), zls, rcond=None)[0]
        yref = np.concatenate([x[:n] - q - A.T @ lam, x[n:] + beta * lam])
        err = np.linalg.norm(yp.numpy() - yref) / np.linalg.norm(yref)
        assert err < 1e-7
    # the factor itself is the JAX package's (host f64 QR in both)
    from fos_tpu.linalg.affine import _ls_projection_fac as jfac

    for eye_first, M in ((None, A), (False, A.T), (True, A.T)):
        np.testing.assert_allclose(
            _ls_projection_fac(M, eye_first=eye_first).numpy(),
            np.asarray(jfac(jnp.asarray(M), eye_first=eye_first)),
            rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["band", "bell"])
def test_affine_plus_linear_over_a_tile_op(kind):
    """Indirect projection over a port tile operator (plain K4/K5, f32)
    against the JAX projector on the dense matrix (f32): both CGs stop at
    ||r|| <= (m+n) eps_f32 = 6.5e-5, so the two lam differ by up to twice
    that over lambda_min(I + AA') >= 1: atol 2e-4."""
    from test_torch_kernels import _banded_scipy

    A = (_banded_scipy(300, 246, 60, seed=3) if kind == "band" else
         sp.random(300, 246, density=0.02,
                   random_state=np.random.RandomState(4))).astype(np.float32)
    m, n = A.shape
    rng = np.random.default_rng(5)
    b, q = (rng.standard_normal(k).astype(np.float32) for k in (m, n))
    cls = T.BandedBlockOp if kind == "band" else T.BlockedEllOp
    op = cls.create(A, transpose_table=True, device=CPU)
    tp = T.AffinePlusLinearProjector.create(op, b, q, -1, device=CPU)
    jp = JAPL.create(jnp.asarray(A.toarray()), jnp.asarray(b), jnp.asarray(q),
                     -1)
    tst, jst = tp.init_cg_state(torch.float32), jp.init_cg_state(jnp.float32)
    for _ in range(3):   # cold, then warm-started
        x = rng.standard_normal(n + m).astype(np.float32)
        y, tst = tp.project(torch.from_numpy(x), tst)
        jy, jst = jp.project(jnp.asarray(x), jst)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4)
    assert y.dtype == torch.float32


# --------------------------------------------------------- the sets library
def _set_pairs(rng, n):
    A = rng.standard_normal((4, n))
    b = rng.standard_normal(4)
    lo, hi = -rng.random(n), rng.random(n)
    a, p, c = (rng.standard_normal(n) for _ in range(3))
    return {
        "affine_direct": (jsets.AffineSet.create(A, b),
                          T.AffineSet.create(A, b, device=CPU)),
        "affine_cg": (jsets.AffineSet.create(A, b, direct=False),
                      T.AffineSet.create(A, b, direct=False, device=CPU)),
        "box_scalar": (jsets.Box(-0.1, 0.2), T.Box(-0.1, 0.2)),
        "box_array": (jsets.Box(lo, hi), T.Box(lo, hi, device=CPU)),
        "nonneg": (jsets.NonNeg(), T.NonNeg()),
        "nonpos": (jsets.NonPos(), T.NonPos()),
        "point": (jsets.Point(p), T.Point(p, device=CPU)),
        "halfspace": (jsets.Halfspace(a, 0.3), T.Halfspace(a, 0.3, device=CPU)),
        "ball": (jsets.Ball(0.5), T.Ball(0.5)),
        "ball_center": (jsets.Ball(0.7, jnp.asarray(c)),
                        T.Ball(0.7, c, device=CPU)),
        "blockset": (jsets.BlockSet([(jsets.Box(0.0, 1.0), 3),
                                     (jsets.Ball(0.2), 4),
                                     (jsets.NonNeg(), n - 7)]),
                     T.BlockSet([(T.Box(0.0, 1.0), 3), (T.Ball(0.2), 4),
                                 (T.NonNeg(), n - 7)])),
        "function": (jsets.FunctionSet(lambda x: x * 0.5),
                     T.FunctionSet(lambda x: x * 0.5)),
    }


@pytest.mark.parametrize("name", sorted(_set_pairs(np.random.default_rng(0),
                                                   10)))
def test_sets_match_jax(name):
    """Each set against fos_tpu.sets, on one x and on a (k, n) batch, to
    1e-12 (the batch row by row equals the single projections)."""
    rng = np.random.default_rng(11)
    n = 10
    jset, tset = _set_pairs(rng, n)[name]
    X = rng.standard_normal((5, n)) * 2.0
    jst, tst = jset.init_state(jnp.float64), tset.init_state(torch.float64)
    for x in (X[0], X):
        jy, _ = jset.project(jnp.asarray(x), jst)
        ty, _ = tset.project(_t(x), tst)
        assert ty.shape == x.shape
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-12)


# ------------------------------------------- tests/test_feasibility.py cases
@pytest.fixture(scope="module")
def problem():
    """test_feasibility.py's problem: Affine(50x100) with a strictly
    feasible point, intersected with the nonneg orthant."""
    rng = np.random.default_rng(2)
    xsol = np.abs(rng.standard_normal(100))
    A = rng.standard_normal((50, 100))
    b = A @ xsol
    return (JFeas(jsets.AffineSet.create(A, b), jsets.NonNeg(), 100),
            T.Feasibility(T.AffineSet.create(A, b, device=CPU), T.NonNeg(),
                          100), A, b)


CASES = {
    # name: (JAX alg, port alg, solve options)
    "dr": (fos_tpu.DR(eps=1e-8, verbose=0), T.DR(eps=1e-8, verbose=0),
           dict(checki=10)),
    "kwargs_override": (fos_tpu.DR(eps=1e-1, verbose=0),
                        T.DR(eps=1e-1, verbose=0), dict(eps=1e-8, checki=10)),
    "ap": (fos_tpu.AP(eps=1e-8, verbose=0), T.AP(eps=1e-8, verbose=0),
           dict(checki=1)),
    "ap_indeterminate": (fos_tpu.AP(eps=1e-14, verbose=0),
                         T.AP(eps=1e-14, verbose=0),
                         dict(max_iters=20, checki=10)),
    "gap_indeterminate": (fos_tpu.GAP(options=(("eps", 1e-14),
                                               ("verbose", 0))),
                          T.GAP(options=(("eps", 1e-14), ("verbose", 0))),
                          dict(max_iters=20, checki=10)),
    "fista_indeterminate": (fos_tpu.FISTA(options=(("eps", 1e-14),
                                                   ("verbose", 0))),
                            T.FISTA(options=(("eps", 1e-14), ("verbose", 0))),
                            dict(max_iters=20, checki=10)),
    "gapp": (fos_tpu.GAPP(options=(("eps", 1e-8), ("verbose", 0))),
             T.GAPP(options=(("eps", 1e-8), ("verbose", 0))), {}),
    "gapa": (fos_tpu.GAPA(options=(("eps", 1e-8), ("verbose", 0))),
             T.GAPA(options=(("eps", 1e-8), ("verbose", 0))), {}),
    "dykstra": (fos_tpu.Dykstra(options=(("eps", 1e-8), ("verbose", 0))),
                T.Dykstra(options=(("eps", 1e-8), ("verbose", 0))),
                dict(checki=10)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_feasibility_matches_jax(problem, name):
    """Each case of test_feasibility.py on the same data in both packages:
    the same status and iteration count, x within 1e-10, and the
    reference's own expectations."""
    jprob, tprob, A, b = problem
    jalg, talg, opts = CASES[name]
    jsol = jsolve(jprob, jalg, **opts)
    tsol = T.solve_feasibility(tprob, talg, device=CPU, **opts)
    assert (tsol.status, tsol.iters) == (jsol.status, jsol.iters)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x), rtol=0,
                               atol=1e-10)
    # the reference's expectations (Dykstra's, which it does not test,
    # held like GAPP's)
    if name.endswith("indeterminate"):
        assert tsol.status == "Indeterminate"
    elif name != "ap":
        assert tsol.status == "Optimal"
        x = tsol.x.numpy()
        assert x.min() > -1e-12
        assert np.abs(A @ x - b).max() < (1e-12 if name in ("dr",
                                                            "kwargs_override")
                                          else 1e-6)


def test_gapp_branch_follows_the_host_count(problem):
    """GAPP's projected step every iproj-th iteration: driven by the
    engine's host count or, outside it, by st.i read once -- the same
    trajectory as the JAX package's lax.cond on st.i."""
    jprob, tprob, _, _ = problem
    jalg, talg = fos_tpu.GAPP(iproj=3), T.GAPP(iproj=3)
    jf = JForm.build(jprob)
    tf = TForm.build(tprob, torch.float64, CPU)
    jst = jengine._run_steps(jalg, jf, jinit(jalg, jf.sets,
                                              jf.initial_value(jf.dtype)), 7)
    tst = tinit(talg, tf.sets, tf.initial_value(torch.float64))
    for _ in range(7):
        tst = talg.step(tf.sets, tst)
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), atol=1e-12)
    assert int(tst.i) == 7


def test_gapa_guard_when_the_step_stands_still():
    """GAPA's 0/0 angle estimate (tmp1 == x: a fixed point) maps NaN to 0
    before the clip, so aopt = 2/(1 + 1) and a12 = 1, as in the JAX
    package (unguarded, a12 would be NaN)."""
    x0 = np.array([0.5, 0.25, 1.0])
    for pkg, sets, alg, init, arr in (
            ("jax", jsets, fos_tpu.GAPA(), jinit, jnp.asarray),
            ("port", T, T.GAPA(), tinit, _t)):
        two = (fos_tpu.solvers.base.TwoSets(sets.NonNeg(), sets.NonNeg())
               if pkg == "jax" else
               T.solvers.TwoSets(T.NonNeg(), T.NonNeg()))
        st = init(alg, two, arr(x0))
        st = alg.step(two, st)
        assert float(st.aux) == 1.0
        np.testing.assert_array_equal(np.asarray(st.x), x0)


def test_logextra_snapshots():
    """test_feasibility.py::test_logextra_snapshots: at every check
    iteration history's "extra" holds (x, P_S1 x, relaxed) of that
    iteration, as the JAX package records them."""
    rng = np.random.default_rng(7)
    xsol = np.abs(rng.standard_normal(40))
    A = rng.standard_normal((20, 40))
    b = A @ xsol
    kw = dict(eps=1e-12, verbose=0, max_iters=500, checki=100, debug=1)
    jsol = jsolve(JFeas(jsets.AffineSet.create(A, b), jsets.NonNeg(), 40),
                  fos_tpu.GAP(0.8, 1.8, 1.8), **kw)
    tsol = T.solve_feasibility(
        T.Feasibility(T.AffineSet.create(A, b, device=CPU), T.NonNeg(), 40),
        T.GAP(0.8, 1.8, 1.8), device=CPU, **kw)
    jit, jextra = jsol.history.get("extra")
    tit, textra = tsol.history.get("extra")
    assert list(tit) == list(jit) and len(textra) >= 1
    np.testing.assert_allclose(np.asarray(textra), np.asarray(jextra),
                               atol=1e-10)
    x, y, relaxed = textra[0]
    np.testing.assert_allclose(A @ y, b, atol=1e-8)
    np.testing.assert_allclose(relaxed, 1.8 * y - 0.8 * x, atol=1e-10)
    np.testing.assert_allclose(tsol.history.get("err")[1],
                               jsol.history.get("err")[1], atol=1e-12)


# ------------------------------------------------- state carried across
def test_state_carried_from_jax_continues_the_trajectory():
    """50 JAX DR steps of a feasibility solve with AffinePlusLinearProjector
    (find x in [0,1]^n, s >= 0 with Ax + s = b), the state carried across,
    50 port steps == 100 JAX steps, to 1e-8.  The CG counts are not held
    equal: near the fixed point each warm-started CG takes 0 or 1
    iterations, decided by a residual at the f64 rounding level against
    the floor (m + n) eps = 1.6e-14, so single calls flip between the two
    packages (their sums over 50 steps differ by one here)."""
    rng = np.random.default_rng(12)
    m, n = 30, 40
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.1, 0.9, n) + np.maximum(0, rng.normal(0, 0.5, m))
    jS1 = JAPL.create(jnp.asarray(A), jnp.asarray(b), jnp.zeros(n), -1)
    jS2 = jsets.BlockSet([(jsets.Box(0.0, 1.0), n), (jsets.NonNeg(), m)])
    tS1 = T.AffinePlusLinearProjector.create(A, b, 0.0, -1, device=CPU)
    tS2 = T.BlockSet([(T.Box(0.0, 1.0), n), (T.NonNeg(), m)])
    jf = JForm.build(JFeas(jS1, jS2, n + m))
    tf = TForm.build(T.Feasibility(tS1, tS2, n + m), None, CPU)
    jalg, talg = fos_tpu.DR(), T.DR()
    st50 = jengine._run_steps(jalg, jf, jinit(jalg, jf.sets,
                                              jf.initial_value(jf.dtype)), 50)
    st100 = jengine._run_steps(jalg, jf, st50, 50)
    cg = {k: (None if v is None else np.asarray(v))
          for k, v in st50.s1_state._asdict().items()}
    tst = interop.solver_state_from_numpy(
        x=np.asarray(st50.x), i=np.asarray(st50.i),
        z_check=np.asarray(st50.z_check),
        z_check_prev=np.asarray(st50.z_check_prev), s1_state=cg,
        s2_state=st50.s2_state, device=CPU)
    tst = tengine._run_steps(talg, tf, tst, 50)
    assert int(tst.i) == int(st100.i) == 100
    for got, want in ((tst.x, st100.x), (tst.z_check, st100.z_check),
                      (tst.s1_state.warm, st100.s1_state.warm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8)
    assert abs(int(tst.s1_state.total_iters)
               - int(st100.s1_state.total_iters)) <= 5


def test_fista_state_carried_from_jax():
    """The aux leaves travel too: FISTA's (t, y, x_old)."""
    rng = np.random.default_rng(13)
    A = rng.standard_normal((10, 20))
    b = A @ np.abs(rng.standard_normal(20))
    jf = JForm.build(JFeas(jsets.AffineSet.create(A, b), jsets.NonNeg(), 20))
    tf = TForm.build(T.Feasibility(T.AffineSet.create(A, b, device=CPU),
                                   T.NonNeg(), 20), None, CPU)
    jalg, talg = fos_tpu.FISTA(), T.FISTA()
    st5 = jengine._run_steps(jalg, jf, jinit(jalg, jf.sets,
                                             jf.initial_value(jf.dtype)), 5)
    st10 = jengine._run_steps(jalg, jf, st5, 5)
    tst = interop.solver_state_from_numpy(
        x=np.asarray(st5.x), i=np.asarray(st5.i),
        z_check=np.asarray(st5.z_check),
        z_check_prev=np.asarray(st5.z_check_prev), s1_state=(),
        aux=tuple(np.asarray(v) for v in st5.aux), device=CPU)
    tst = tengine._run_steps(talg, tf, tst, 5)
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(st10.x), atol=1e-12)
    np.testing.assert_allclose(tst.aux[1].numpy(), np.asarray(st10.aux[1]),
                               atol=1e-12)


# ------------------------------------------- the whole slice at small size
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_feasibility_slice_small(kind):
    """chip_smoke.py's feasibility phase at nrb = 8: the tile operator
    (plain K4/K5) through AffinePlusLinearProjector and DR, f32, against
    the JAX package on the dense matrix in f32.  Both stop Optimal at the
    same check with chip_smoke's eps; the residual gate holds; the two f32
    answers agree to 2e-3 (each CG stops at ||r|| <= (m+n) eps_f32 =
    2.4e-4, and the iterates carry that noise)."""
    nrb = 8
    blk, index, _ = (chip_smoke.banded_tables(nrb=nrb) if kind == "band"
                     else chip_smoke.scattered_tables(nrb=nrb))
    slots = index[:, None] + np.arange(blk.shape[1]) if kind == "band" else index
    m = n = nrb * 128
    x0, s0 = chip_smoke.feasibility_vectors(m, n)
    b = chip_smoke.host_tile_mv(blk, slots, x0) + s0
    b32 = b.astype(np.float32)
    cls = T.BandedBlockOp if kind == "band" else T.BlockedEllOp
    op = cls.from_arrays(blk, index, m, n, transpose_table=True, device=CPU)
    eps = chip_smoke.FEAS_EPS_FLOORS * (m + n) * float(np.finfo(np.float32).eps)
    tsol = T.solve_feasibility(
        T.Feasibility(T.AffinePlusLinearProjector.create(op, b32, 0.0, -1,
                                                         device=CPU),
                      T.BlockSet([(T.Box(0.0, 1.0), n), (T.NonNeg(), m)]),
                      n + m), T.DR(), eps=eps, verbose=0, device=CPU)
    jS1 = JAPL.create(jnp.asarray(op.todense().numpy()), jnp.asarray(b32),
                      jnp.zeros(n, jnp.float32), -1)
    jS2 = jsets.BlockSet([(jsets.Box(0.0, 1.0), n), (jsets.NonNeg(), m)])
    jform = JForm.build(JFeas(jS1, jS2, n + m), dtype=jnp.float32)
    jres = jengine.run(jform, fos_tpu.DR(), eps=eps, verbose=0)
    assert tsol.status == "Optimal" and tsol.x.dtype == torch.float32
    assert jres.status == Status.OPTIMAL
    assert tsol.iters == jres.iters
    z = tsol.x.double().numpy()
    assert z[:n].min() >= 0 and z[:n].max() <= 1 and z[n:].min() >= 0
    resid = np.abs(chip_smoke.host_tile_mv(blk, slots, z[:n]) + z[n:] - b).max()
    assert resid <= chip_smoke.FEAS_RESID * (1 + np.abs(b).max())
    np.testing.assert_allclose(z, np.asarray(jres.guess), atol=2e-3)


# --------------------------------------------------- entry points, printing
def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card and without device=..., the entry points raise and
    say how to ask for the CPU; nothing falls back on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = np.eye(3)
    b = np.ones(3)
    K = T.nonneg(3)
    calls = (
        lambda: T.solve(A, b, b, K, K, verbose=0),
        lambda: T.solve_feasibility(T.Feasibility(T.NonNeg(), T.NonNeg(), 3)),
        lambda: T.BandedBlockOp.create(sp.eye(3, format="csr")),
        lambda: T.BlockedEllOp.from_arrays(np.zeros((1, 1, 128, 128)),
                                           np.zeros((1, 1)), 3, 3),
        lambda: T.AffinePlusLinearProjector.create(A, b, 0.0, 1),
        lambda: T.AffineSet.create(A, b),
        lambda: T.Box(np.zeros(3), 1.0),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_feasibility_status_table_matches_jax(capsys):
    for direct in (True, False):
        assert tprinting.feasibility_header(0.25, direct) == \
            jprinting.feasibility_header(0.25, direct)
    for row in ((100, 5.07e-2, 0.65, None), (12300, 1e-9, 123.4, 7),
                (7, float("nan"), 1e-4, None), (1, float("inf"), 0.0, 0)):
        assert tprinting.feasibility_row(*row[:3], cgiter=row[3]) == \
            jprinting.feasibility_row(*row[:3], cgiter=row[3])
    # a verbose feasibility solve prints the JAX package's table
    rng = np.random.default_rng(3)
    A = rng.standard_normal((5, 10))
    b = A @ np.abs(rng.standard_normal(10))
    T.solve_feasibility(T.Feasibility(T.AffineSet.create(A, b, device=CPU),
                                      T.NonNeg(), 10), T.AP(),
                        max_iters=200, eps=1e-30, device=CPU)
    out = capsys.readouterr().out.splitlines()
    want = jprinting.feasibility_header(0.0, True).splitlines()
    assert out[1:4] == want[1:4]
    assert out[4][:7] == "   100|" and out[5][:7] == "   200|"
