"""fos_tpu_torch's Ruiz equilibration and direct (QR) mode against the JAX
package, on the CPU, on the same seeded numpy inputs: the scalings bit for
bit, the host Q and its factor, DR trajectories carried across from a JAX
state, the weighted residual check, end-to-end solves, and the packing of
an equilibrated sparse A into the tile operators.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch
from jax.experimental.sparse import BCOO

import fos_tpu
from fos_tpu.cones import nonneg as jnonneg
from fos_tpu.cones.spec import Cone as JCone, ConeSpec as JSpec
from fos_tpu.linalg.affine import (HSDEAffineProjector as JProj,
                                   _host_q_dense_f64 as j_host_q,
                                   _ls_projection_fac as j_fac)
from fos_tpu.problems.conic import conic_problem as jconic
from fos_tpu.problems.hsde import HSDEForm as JForm
from fos_tpu.problems.scaling import (ruiz_equilibrate as j_ruiz,
                                      ruiz_equilibrate_sparse as j_ruiz_sp)
from fos_tpu.solvers import engine as jengine
from fos_tpu.solvers.base import init_solver_state as jinit

import chip_smoke
import fos_tpu_torch as T
from fos_tpu_torch import interop
from fos_tpu_torch.config import as_dtype
from fos_tpu_torch.linalg import hsde_ops
from fos_tpu_torch.linalg.affine import (HSDEAffineProjector as TProj,
                                         _host_q_dense_f64 as t_host_q,
                                         _ls_projection_fac as t_fac)
from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.hsde import HSDEForm as TForm
from fos_tpu_torch.problems.scaling import (ruiz_equilibrate as t_ruiz,
                                            ruiz_equilibrate_sparse as t_ruiz_sp)
from fos_tpu_torch.solvers import engine as tengine

from test_equilibration import _badly_scaled_lp

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tspec(jspec):
    return interop.cone_spec_from_blocks(
        [(c.name, d) for c, d in jspec.blocks], jspec.params)


def _lp(m, n, seed):
    """A dense LP with a primal-dual certificate (f64)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x0 = np.abs(rng.standard_normal(n)) * (rng.random(n) < 0.5)
    y0 = np.abs(rng.standard_normal(m)) * (rng.random(m) < 0.5)
    b = A @ x0 + np.abs(rng.standard_normal(m)) * (y0 == 0)
    c = np.abs(rng.standard_normal(n)) * (x0 == 0) - A.T @ y0
    return A, b, c


# K1 with SOC and PSD rows: their scalings are held constant per block
K1_BLOCKS = JSpec(((JCone.NONNEG, 5), (JCone.SOC, 4), (JCone.ZERO, 3),
                   (JCone.PSD, 6), (JCone.NONNEG, 2)))


# ------------------------------------------------------------- scaling
def test_ruiz_dense_and_sparse_bit_equal_to_jax():
    """Both scalings, with block averaging over SOC and PSD rows, equal the
    JAX package's bit for bit (max |d| = 0)."""
    rng = np.random.default_rng(3)
    A, b, c = _badly_scaled_lp(rng, 20, 12)
    K2 = JSpec(((JCone.NONNEG, 12),))
    tK1, tK2 = _tspec(K1_BLOCKS), _tspec(K2)
    for kw in (dict(), dict(iters=3)):
        want = j_ruiz(A, b, c, K1_BLOCKS, K2, **kw)
        got = t_ruiz(A, b, c, tK1, tK2, **kw)
        for g, w in zip(got, want):
            assert np.abs(g - w).max() == 0
    As = sp.random(20, 12, density=0.3, random_state=np.random.RandomState(4),
                   format="coo") * 1e3
    want = j_ruiz_sp(As, b, c, K1_BLOCKS, K2)
    got = t_ruiz_sp(As, b, c, tK1, tK2)
    assert abs(got[0] - want[0]).max() == 0
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(g - w).max() == 0


def test_equilibrated_form_arrays_and_check_match_jax():
    """An equilibrated form (dense, f64 and f32; sparse scipy, f64): the
    scaled data and the weights equal the JAX form's bit for bit, and the
    check's weighted residuals (D^-1, E^-1 against the original norms;
    f32 takes the compensated branch) agree with JAX's at the same z."""
    rng = np.random.default_rng(5)
    A, b, c = _badly_scaled_lp(rng, 15, 25)
    K1, K2 = JSpec(((JCone.NONNEG, 15),)), JSpec(((JCone.NONNEG, 25),))
    z = np.random.default_rng(6).standard_normal(2 * (15 + 25 + 1))
    z[40] = z[-1] = 0.7
    for dtype, Ain in ((np.float64, A), (np.float32, A),
                       (np.float64, sp.coo_matrix(A))):
        jA = (BCOO.from_scipy_sparse(Ain) if sp.issparse(Ain)
              else jnp.asarray(Ain, dtype))
        jf = JForm.build(jconic(jA, jnp.asarray(b, dtype),
                                jnp.asarray(c, dtype), K1, K2),
                         equilibrate=True, densify=False)
        tf = TForm.build(tconic(Ain, b, c, _tspec(K1), _tspec(K2),
                                device=CPU, dtype=as_dtype(dtype)),
                         equilibrate=True, densify=False)
        for name in ("b", "c", "dinv", "einv"):
            got = getattr(tf, name).numpy()
            assert np.abs(got - np.asarray(getattr(jf, name))).max() == 0
        for name in ("norm_b", "norm_c"):   # the original norms
            w = float(getattr(jf, name))
            assert abs(float(getattr(tf, name)) - w) <= 1e-6 * w
        jAd = jf.A.todense() if hasattr(jf.A, "todense") else jf.A
        tAd = tf.A.to_dense() if tf.A.layout == torch.sparse_coo else tf.A
        assert np.abs(tAd.numpy() - np.asarray(jAd)).max() == 0
        assert tf.compensated == (dtype == np.float32)
        zj = jnp.asarray(z, dtype)
        want = jf.check(zj, 1e-6)
        got = tf.check(torch.from_numpy(z.astype(dtype)), 1e-6).to_host()
        assert got.status == int(want.status)
        rel = 1e-10 if dtype == np.float64 else 1e-5
        for key in ("p", "d", "g", "ctx", "bty"):
            w = float(getattr(want, key))
            assert abs(getattr(got, key) - w) <= rel * max(abs(w), 1e-300)


def test_equilibrated_solve_matches_jax():
    """test_equilibration.py's badly scaled LP (seed 2; seeds 0 and 1 take
    12100 and 34800 iterations in both packages): the same status,
    the objective within 1e-6 relative, iterations within one checki, and
    the solution returned in the original coordinates."""
    A, b, c = _badly_scaled_lp(np.random.default_rng(2))
    sol = T.solve(A, b, c, T.nonneg(15), T.nonneg(25), alg=T.DR(), eps=1e-7,
                  max_iters=40000, verbose=0, equilibrate=True, device=CPU)
    jsol = fos_tpu.solve(A, b, c, jnonneg(15), jnonneg(25), alg=fos_tpu.DR(),
                         eps=1e-7, max_iters=40000, verbose=0,
                         equilibrate=True)
    assert sol.status == jsol.status == "Optimal"
    assert abs(sol.objval - jsol.objval) <= 1e-6 * abs(jsol.objval)
    assert abs(sol.iters - jsol.iters) <= 100
    x = sol.x.numpy()
    assert abs(float(c @ x) - sol.objval) <= 1e-9 * abs(sol.objval)
    assert ((A @ x - b) / (1 + np.abs(b))).max() < 1e-4


def test_equilibrate_scales_before_packing():
    """A scipy A with equilibrate=True is scaled first and then packed into
    the tile operator the JAX package picks (Ruiz keeps the nonzero
    pattern); an operator cannot be scaled and raises."""
    blk, cs, vectors = chip_smoke.banded_tables(nrb=8)
    op = T.BandedBlockOp.from_arrays(blk, cs, 1024, 1024, device=CPU)
    A = sp.coo_matrix(op.todense().numpy() * np.float32(1e2))
    b, c = np.ones(1024, np.float32), np.ones(1024, np.float32)
    K = T.nonneg(1024)
    tf = TForm.build(tconic(A, b, c, K, K, device=CPU), equilibrate=True,
                     densify=False, sparse_format="bell")
    jf = JForm.build(jconic(BCOO.from_scipy_sparse(A), jnp.asarray(b),
                            jnp.asarray(c), jnonneg(1024), jnonneg(1024)),
                     equilibrate=True, densify=False, sparse_format="bell")
    assert type(tf.A).__name__ == type(jf.A).__name__ == "BandedBlockOp"
    np.testing.assert_array_equal(tf.A.blocks.numpy(), np.asarray(jf.A.blocks))
    assert np.abs(tf.einv.numpy() - np.asarray(jf.einv)).max() == 0
    with pytest.raises(ValueError, match="BEFORE packing"):
        TForm.build(tconic(op, b, c, K, K, device=CPU), equilibrate=True)


def test_equilibrated_dr_trajectory_matches_jax():
    """50 JAX DR steps on an equilibrated f64 form, the state and the
    weights carried across (interop.carry_form_arrays), then 200 steps in
    each package: <= 1e-9 relative.  Converged CG projections (a loosely
    stopped CG is decided by rounding)."""
    A, b, c = _badly_scaled_lp(np.random.default_rng(7))
    K1, K2 = JSpec(((JCone.NONNEG, 15),)), JSpec(((JCone.NONNEG, 25),))
    jf = JForm.build(jconic(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                            K1, K2), equilibrate=True)
    tf = TForm.build(tconic(A, b, c, _tspec(K1), _tspec(K2), device=CPU),
                     equilibrate=True)
    kw = dict(decreasing_accuracy=False, tol_floor=1e-12)
    jf.sets.s1 = JProj.create(jf.A, jf.b, jf.c, **kw)
    tf.sets.s1 = TProj.create(tf.A, tf.b, tf.c, **kw)
    interop.carry_form_arrays(tf, dinv=np.asarray(jf.dinv),
                              einv=np.asarray(jf.einv))
    _carried_trajectory(jf, tf, 50, 200)


def test_direct_dr_trajectory_matches_jax():
    """Direct mode: 50 JAX DR steps, the state and the factor carried
    across, then 200 steps in each package: <= 1e-9 relative, the CG
    counters as JAX's (last_iters 0, call_idx counting projections)."""
    A, b, c = _lp(30, 40, 12)
    K1, K2 = JSpec(((JCone.NONNEG, 30),)), JSpec(((JCone.NONNEG, 40),))
    jf = JForm.build(jconic(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                            K1, K2), direct=True)
    tf = TForm.build(tconic(A, b, c, _tspec(K1), _tspec(K2), device=CPU),
                     direct=True)
    jfac = np.asarray(jf.sets.s1.fac)
    assert tf.direct and tf.sets.s1.fac.shape == jfac.shape
    assert np.abs(tf.sets.s1.fac.numpy() - jfac).max() <= 1e-12
    interop.carry_form_arrays(tf, fac=jfac)
    tst = _carried_trajectory(jf, tf, 50, 200)
    assert int(tst.s1_state.last_iters) == 0
    assert int(tst.s1_state.call_idx) == 251


def _carried_trajectory(jf, tf, n0, n1):
    jalg, talg = fos_tpu.DR(), T.DR()
    st0 = jengine._run_steps(jalg, jf, jinit(jalg, jf.sets,
                                             jf.initial_value(jf.dtype)), n0)
    st1 = jengine._run_steps(jalg, jf, st0, n1)
    tst = interop.solver_state_from_tree(st0, device=CPU)
    tst = tengine._run_steps(talg, tf, tst, n1)
    assert int(tst.i) == int(st1.i) == n0 + n1
    for got, want in ((tst.x, st1.x), (tst.z_check, st1.z_check)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()
    return tst


# --------------------------------------------------------- direct mode
def test_host_q_and_factor_match_jax():
    """Q on the host in f64 from a dense tensor, a PaddedDenseOp and a tile
    operator, and the factor of QR([I; Q]): <= 1e-12."""
    A, b, c = _lp(20, 30, 3)
    want = j_host_q(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    tb, tc = torch.from_numpy(b), torch.from_numpy(c)
    for Ain in (torch.from_numpy(A), PaddedDenseOp.create(torch.from_numpy(A))):
        got = t_host_q(Ain, tb, tc)
        assert np.abs(got - want).max() <= 1e-12
    blk, cs, _ = chip_smoke.banded_tables(nrb=4)
    op = T.BandedBlockOp.from_arrays(blk, cs, 512, 512, device=CPU)
    Ad = op.todense().double().numpy()
    one = np.ones(512)
    got = t_host_q(op, torch.ones(512), torch.ones(512))
    assert np.abs(got - j_host_q(jnp.asarray(Ad), jnp.asarray(one),
                                 jnp.asarray(one))).max() <= 1e-12
    fac = t_fac(want, eye_first=True, dtype=torch.float64, device=CPU)
    jfac = np.asarray(j_fac(want, eye_first=True, out_dtype=jnp.float64))
    assert np.abs(fac.numpy() - jfac).max() <= 1e-12


def test_direct_mode_qr_large_sigma_max():
    """tests/test_linalg.py::test_direct_mode_qr_large_sigma_max's case as
    the direct-mode oracle: with sigma_max(A) = 1e7 the QR factor gives u
    within 1e-8 of the least-squares solution (a Cholesky of I + Q'Q,
    cond ~1e14, erred ~1e-3)."""
    rng = np.random.default_rng(0)
    m, n = 30, 20
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = U[:, :n] @ np.diag(np.logspace(7, 0, n)) @ V.T
    b = rng.standard_normal(m)
    c = rng.standard_normal(n)
    l = m + n + 1
    pd = TProj.create(torch.from_numpy(A), torch.from_numpy(b),
                      torch.from_numpy(c), direct=True)
    z = rng.standard_normal(2 * l)
    st = pd.init_state_from(torch.from_numpy(z))
    y, st = pd.project(torch.from_numpy(z), st)
    Qd = hsde_ops.q_dense(torch.from_numpy(A), torch.from_numpy(b),
                          torch.from_numpy(c)).numpy()
    u_ref = np.linalg.lstsq(np.vstack([np.eye(l), Qd]), z, rcond=None)[0]
    err = np.linalg.norm(y[:l].numpy() - u_ref) / np.linalg.norm(u_ref)
    assert err < 1e-8
    assert int(st.last_iters) == 0 and int(st.call_idx) == 2
    # v = Q u: the projection lands on the subspace
    assert np.abs(Qd @ y[:l].numpy() - y[l:].numpy()).max() <= 1e-6


def test_direct_solve_matches_jax():
    """DR(direct=True) through solve, f32 with pallas=True (the check's pair
    through K1's plain version): the JAX package's status and iterations,
    the objective within 1e-5 relative, no cg column in the table."""
    A, b, c, opt = chip_smoke.certificate_lp(60, 80, seed=7)
    sol = T.solve(A, b, c, T.nonneg(60), T.nonneg(80), alg=T.DR(direct=True),
                  eps=1e-5, dtype=torch.float32, pallas=True, verbose=0,
                  device=CPU)
    jsol = fos_tpu.solve(A, b, c, jnonneg(60), jnonneg(80),
                         alg=fos_tpu.DR(direct=True), eps=1e-5,
                         dtype=jnp.float32, verbose=0)
    assert sol.status == jsol.status == "Optimal"
    assert abs(sol.iters - jsol.iters) <= 100
    assert abs(sol.objval - jsol.objval) <= 1e-5 * abs(jsol.objval)
    form = TForm.build(tconic(A, b, c, T.nonneg(60), T.nonneg(80),
                              device=CPU, dtype=torch.float32),
                       direct=True, pallas=True)
    assert isinstance(form.A, PaddedDenseOp) and form.direct
    assert "cg" not in form.header(0.0)
    assert form.fused_cg_floors() is None and form.tighten_cg() is None
