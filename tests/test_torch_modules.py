"""fos_tpu_torch's modules against their fos_tpu counterparts, at f64 on the
CPU, on the same seeded numpy inputs: cone projection, q_mul, tracked CG,
the HSDE affine projection, the residual check, a solver state carried
across from JAX mid-solve, compensated reductions and the status table.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fos_tpu
from fos_tpu.cones.project import project as jproj, project_dual as jproj_dual
from fos_tpu.cones.spec import Cone as JCone, ConeSpec as JSpec
from fos_tpu.linalg import hsde_ops as jops
from fos_tpu.linalg.affine import HSDEAffineProjector as JProj
from fos_tpu.linalg.cg import conjugate_gradient_tracked as jcgt
from fos_tpu.problems.conic import conic_problem as jconic
from fos_tpu.problems.hsde import HSDEForm as JForm
from fos_tpu.solvers import engine as jengine
from fos_tpu.solvers.base import init_solver_state as jinit
from fos_tpu.utils import printing as jprinting

import fos_tpu_torch
from fos_tpu_torch import interop
from fos_tpu_torch.cones.project import project as tproj, project_dual as tproj_dual
from fos_tpu_torch.linalg import hsde_ops as tops
from fos_tpu_torch.linalg.affine import HSDEAffineProjector as TProj
from fos_tpu_torch.linalg.cg import conjugate_gradient_tracked as tcgt
from fos_tpu_torch.linalg.compensated import cdot, cdot_ff, cnorm, ff_add
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.hsde import HSDEForm as TForm
from fos_tpu_torch.solvers import engine as tengine
from fos_tpu_torch.utils import printing as tprinting


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tspec(jspec):
    return interop.cone_spec_from_blocks([(c.name, d) for c, d in jspec.blocks])


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _lp(m, n, seed):
    """Dense LP with a primal-dual certificate (f64)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x0 = np.abs(rng.standard_normal(n)) * (rng.random(n) < 0.5)
    y0 = np.abs(rng.standard_normal(m)) * (rng.random(m) < 0.5)
    b = A @ x0 + np.abs(rng.standard_normal(m)) * (y0 == 0)
    c = np.abs(rng.standard_normal(n)) * (x0 == 0) - A.T @ y0
    return A, b, c


SPECS = {
    "lp": [(JCone.ZERO, 3), (JCone.NONNEG, 5), (JCone.NONPOS, 2), (JCone.FREE, 4)],
    "soc": [(JCone.SOC, 4), (JCone.NONNEG, 3), (JCone.SOC, 7), (JCone.SOC, 2)],
    "rotated": [(JCone.SOC_ROTATED, 5), (JCone.ZERO, 2), (JCone.SOC_ROTATED, 3),
                (JCone.SOC, 3)],
    "mixed": [(JCone.NONNEG, 10), (JCone.SOC_ROTATED, 42), (JCone.ZERO, 41),
              (JCone.SOC, 6), (JCone.FREE, 1)],
    # tails of every power-of-two width class from 1 to 128, interleaved
    "widths": [(JCone.SOC, d) if i % 3 else (JCone.SOC_ROTATED, d + 1)
               for i, d in enumerate((2, 3, 5, 9, 17, 33, 65, 129, 4, 100))],
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_cone_projection_matches_jax(name):
    jspec = JSpec(tuple(SPECS[name]))
    tspec = _tspec(jspec)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((6, jspec.dim)) * 3.0
    X[0] = 0.0
    # the JAX projections of all rows in one compiled call each (op by op
    # they cost seconds of dispatch); the port projects row by row, then
    # batched
    want = np.asarray(jax.jit(lambda v: jproj(jspec, v))(jnp.asarray(X)))
    want_d = np.asarray(jax.jit(lambda v: jproj_dual(jspec, v))(
        jnp.asarray(X)))
    for x, w, w_d in zip(X, want, want_d):
        got = tproj(tspec, _t(x)).numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-12)
        got_d = tproj_dual(tspec, _t(x)).numpy()
        np.testing.assert_allclose(got_d, w_d, rtol=0, atol=1e-12)
    # batched leading axes project row by row
    np.testing.assert_allclose(tproj(tspec, _t(X)).numpy(), want, atol=1e-12)


def test_unported_cones_raise_at_plan_build():
    """Every cone is ported; a plan of power-cone blocks without their
    exponents still raises when it is built (it would project them as
    free), as the JAX package's does."""
    from fos_tpu_torch.cones.project import make_projector

    with pytest.raises(ValueError, match="alpha"):
        make_projector(((fos_tpu_torch.Cone.POW_PRIMAL, 3),), "eigh", ())


def test_q_mul_matches_jax():
    A, b, c = _lp(30, 45, 1)
    z = np.random.default_rng(2).standard_normal(30 + 45 + 1)
    want = np.asarray(jops.q_mul(jnp.asarray(A), jnp.asarray(b),
                                 jnp.asarray(c), jnp.asarray(z)))
    got = tops.q_mul(_t(A), _t(b), _t(c), _t(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    Q = tops.q_dense(_t(A), _t(b), _t(c)).numpy()
    np.testing.assert_allclose(Q @ z, want, atol=1e-12)
    np.testing.assert_allclose(Q, -Q.T, atol=0)


def test_tracked_cg_matches_jax():
    A, b, c = _lp(40, 60, 3)
    l = 101
    rng = np.random.default_rng(4)
    x0, rhs = rng.standard_normal(l), rng.standard_normal(l)
    ja, jb, jc = jnp.asarray(A), jnp.asarray(b), jnp.asarray(c)
    jq = lambda v: jops.q_mul(ja, jb, jc, v)  # noqa: E731
    jQx0 = jq(jnp.asarray(x0))
    jr0 = jnp.asarray(rhs) - jops.hsde_normal_mul(ja, jb, jc, jnp.asarray(x0))
    want = jcgt(jq, jr0, jnp.asarray(x0), jQx0, tol=1e-9, max_iters=500,
                unroll=2)
    ta, tb, tc = _t(A), _t(b), _t(c)
    tq = lambda v: tops.q_mul(ta, tb, tc, v)  # noqa: E731
    tr0 = _t(rhs) - tops.hsde_normal_mul(ta, tb, tc, _t(x0))
    got = tcgt(tq, tr0, _t(x0), tq(_t(x0)), tol=1e-9, max_iters=500, unroll=2)
    assert int(got.iters) == int(want.iters) > 2
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-10)
    np.testing.assert_allclose(got.Qx.numpy(), np.asarray(want.Qx), atol=1e-10)


@pytest.mark.parametrize("tight", [True, False])
def test_hsde_affine_projection_matches_jax(tight):
    """Converged CG (tight=True): the projections agree to 1e-10.  With the
    default decreasing accuracy the first calls stop CG at tol 0.2, where
    the iterate is rounding-determined (a 1e-15 relative change of the
    input moves a numpy CG by ~1e-8 here), so that case is held to the
    same CG counts and 1e-6."""
    A, b, c = _lp(40, 60, 5)
    l = 101
    rng = np.random.default_rng(6)
    z0, z1 = rng.standard_normal(2 * l), rng.standard_normal(2 * l)
    kw = dict(decreasing_accuracy=False, tol_floor=1e-12) if tight else {}
    jp = JProj.create(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), **kw)
    tp = TProj.create(_t(A), _t(b), _t(c), **kw)
    atol = 1e-10 if tight else 1e-6
    Q = tops.q_dense(_t(A), _t(b), _t(c))
    jst, tst = jp.init_state_from(jnp.asarray(z0)), tp.init_state_from(_t(z0))
    for z in (z1, z0 + z1):
        jy, jst = jp.project(jnp.asarray(z), jst)
        ty, tst = tp.project(_t(z), tst)
        assert int(tst.last_iters) == int(jst.last_iters)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=atol)
        if tight:  # the result lies on the subspace Qu = v
            np.testing.assert_allclose((Q @ ty[:l]).numpy(), ty[l:].numpy(),
                                       atol=1e-9)
    assert int(tst.total_iters) == int(jst.total_iters)
    refreshed = tp.refresh_state(tst)
    np.testing.assert_allclose(refreshed.v_warm.numpy(),
                               np.asarray(jp.refresh_state(jst).v_warm),
                               atol=atol)


def _forms(A, b, c, K1, K2, **kw):
    jf = JForm.build(jconic(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                            K1, K2), **kw)
    tf = TForm.build(tconic(A, b, c, _tspec(K1), _tspec(K2)), **kw)
    return jf, tf


@pytest.mark.parametrize("seed", [8, 9])
def test_hsde_check_matches_jax(seed):
    A, b, c = _lp(30, 50, seed)
    K1 = JSpec(((JCone.NONNEG, 20), (JCone.ZERO, 10)))
    K2 = JSpec(((JCone.NONNEG, 50),))
    jf, tf = _forms(A, b, c, K1, K2)
    rng = np.random.default_rng(seed)
    for scale in (1.0, 1e-3):
        z = rng.standard_normal(2 * jf.l) * scale
        z[jf.l - 1] = 0.7                  # tau > 0
        want = jf.check(jnp.asarray(z), 1e-5)
        got = tf.check(_t(z), 1e-5).to_host()
        assert got.status == int(want.status)
        for key in ("p", "d", "g", "ctx", "bty"):
            w = float(getattr(want, key))
            assert abs(getattr(got, key) - w) <= 1e-10 * max(abs(w), 1e-300)


def test_state_carried_from_jax_continues_the_trajectory():
    """50 JAX DR steps, state carried across, 50 port steps == 100 JAX
    steps.  The projections run CG to convergence (no decreasing
    accuracy): a CG stopped at a loose tolerance on the HSDE normal matrix
    is rounding-determined (a 1e-15 relative change of its input moves it
    by ~1e-8), so only converged projections make the trajectory a
    function of the data alone."""
    A, b, c = _lp(30, 40, 10)
    K1, K2 = JSpec(((JCone.NONNEG, 30),)), JSpec(((JCone.NONNEG, 40),))
    jf, tf = _forms(A, b, c, K1, K2)
    kw = dict(decreasing_accuracy=False, tol_floor=1e-12)
    jf.sets.s1 = JProj.create(jf.A, jf.b, jf.c, **kw)
    tf.sets.s1 = TProj.create(tf.A, tf.b, tf.c, **kw)
    jalg, talg = fos_tpu.DR(), fos_tpu_torch.DR()
    st0 = jinit(jalg, jf.sets, jf.initial_value(jf.dtype))
    st50 = jengine._run_steps(jalg, jf, st0, 50)
    st100 = jengine._run_steps(jalg, jf, st50, 50)
    leaves = {k: (None if v is None else np.asarray(v))
              for k, v in st50.s1_state._asdict().items()}
    tst = interop.solver_state_from_numpy(
        x=np.asarray(st50.x), i=np.asarray(st50.i),
        z_check=np.asarray(st50.z_check),
        z_check_prev=np.asarray(st50.z_check_prev), s1_state=leaves)
    tst = tengine._run_steps(talg, tf, tst, 50)
    assert int(tst.i) == int(st100.i) == 100
    for got, want in ((tst.x, st100.x), (tst.z_check, st100.z_check),
                      (tst.s1_state.warm, st100.s1_state.warm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8)
    assert int(tst.s1_state.total_iters) == int(st100.s1_state.total_iters)


def test_tighten_cg_copies_every_projector_field():
    A, b, c = _lp(20, 30, 11)
    K1, K2 = JSpec(((JCone.NONNEG, 20),)), JSpec(((JCone.NONNEG, 30),))
    prob = tconic(A.astype(np.float32), b.astype(np.float32),
                  c.astype(np.float32), _tspec(K1), _tspec(K2))
    tf = TForm.build(prob, cg_max_iters=77, cg_unroll=3, compensated=True)
    t2 = tf.tighten_cg()
    s1, s1b = tf.sets.s1, t2.sets.s1
    for key in ("A", "b", "c", "decreasing_accuracy", "cg_max_iters",
                "cg_unroll", "compensated"):
        assert getattr(s1b, key) is getattr(s1, key) or \
            getattr(s1b, key) == getattr(s1, key)
    assert s1b.tol_floor == pytest.approx(np.sqrt(2 * tf.l) * 2**-23)
    assert t2.tighten_cg() is None
    jf = JForm.build(jconic(jnp.asarray(A, jnp.float32),
                            jnp.asarray(b, jnp.float32),
                            jnp.asarray(c, jnp.float32), K1, K2))
    assert tf.fused_cg_floors() == pytest.approx(jf.fused_cg_floors())


def test_cdot_accuracy(rng):
    """test_linalg.py::test_cdot_accuracy on the port's f32 reductions."""
    x = (rng.standard_normal(4001) * 10.0 ** rng.integers(-3, 4, 4001)).astype(np.float32)
    y = (rng.standard_normal(4001) * 10.0 ** rng.integers(-3, 4, 4001)).astype(np.float32)
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    comp = float(cdot(tx, ty))
    assert abs(comp - exact) / abs(exact) < 1e-6
    assert abs(comp - exact) <= abs(float(torch.dot(tx, ty)) - exact)
    xc = torch.tensor([1e8, 1.0, -1e8, 1e-3], dtype=torch.float32)
    assert abs(float(cdot(xc, torch.ones(4))) - 1.001) < 1e-6
    assert float(cnorm(tx)) == pytest.approx(
        float(np.linalg.norm(x.astype(np.float64))), rel=1e-6)
    s = ff_add(cdot_ff(tx, ty), cdot_ff(-tx, ty))
    assert abs(float(s[0] + s[1])) < 1e-3 * abs(exact) * np.finfo(np.float32).eps


def test_status_table_matches_jax(capsys):
    for direct in (False, True):
        assert tprinting.hsde_header(0.25, direct) == \
            jprinting.hsde_header(0.25, direct)
    rows = [(100, 5.07e-2, 1.18e-2, 1.21e-4, 2.0e-1, 2.0e-1, 0.0, 0.65, 41),
            (12300, 1e-9, -3.3e-7, 0.0, -1.5e3, 2e-300, 1e5, 123.4, 0),
            (7, float("nan"), float("inf"), 1.0, 1.0, 1.0, 1.0, 1e-4, None)]
    for r in rows:
        assert tprinting.hsde_row(*r[:8], cgiter=r[8]) == \
            jprinting.hsde_row(*r[:8], cgiter=r[8])
    # a verbose solve prints the table with the JAX layout
    A, b, c = _lp(10, 15, 12)
    fos_tpu_torch.solve(A, b, c, fos_tpu_torch.nonneg(10),
                        fos_tpu_torch.nonneg(15), max_iters=200, verbose=1,
                        device="cpu")
    out = capsys.readouterr().out.splitlines()
    want = jprinting.hsde_header(0.0, False).splitlines()
    assert out[1:4] == want[1:4]
    assert out[4][:7] == "   100|" and out[5][:7] == "   200|"
