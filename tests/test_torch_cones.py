"""fos_tpu_torch's PSD, exponential and power cones against the JAX package.

The same inputs, made from a seed with numpy, go through both packages on
the CPU: the PSD projection (eigh and the polynomial filter, bucketed
sides, batches, duals by Moreau), the exp/pow root finders over the JAX
package's corner battery (tests/test_cone_corners.py, tests/test_pow.py),
svec/smat, and a kitchen-sink DR trajectory with every cone.
"""

import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fos_tpu
from fos_tpu.cones.exp import project_exp_single, _h_sign as j_h_sign
from fos_tpu.cones.pow import project_pow_single
from fos_tpu.cones.project import (project as jproj, project_dual as jpd,
                                   smat as jsmat, svec as jsvec)
from fos_tpu.cones.psd_poly import psd_project_poly as jpoly
from fos_tpu.cones.spec import Cone as JCone, ConeSpec as JSpec
from fos_tpu.linalg.affine import HSDEAffineProjector as JProj
from fos_tpu.problems.conic import conic_problem as jconic
from fos_tpu.problems.hsde import HSDEForm as JForm
from fos_tpu.solvers import engine as jengine
from fos_tpu.solvers.base import init_solver_state as jinit

import fos_tpu_torch
from fos_tpu_torch import interop
from fos_tpu_torch.cones import exp as texp, pow as tpow
from fos_tpu_torch.cones.project import (project as tproj,
                                         project_dual as tpd,
                                         resolve_psd_method, smat, svec)
from fos_tpu_torch.cones.psd_poly import psd_project_poly as tpoly
from fos_tpu_torch.linalg.affine import HSDEAffineProjector as TProj
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.hsde import HSDEForm as TForm
from fos_tpu_torch.solvers import engine as tengine
from fos_tpu_torch.solvers.base import init_solver_state as tinit

from test_cone_corners import ALPHA_CORNERS, _sign_mag_grid
from test_kitchen_sink import build_problem

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


def _sym(rng, batch, d, scale=1.0):
    B = rng.standard_normal((*batch, d, d)) * scale
    return (B + np.swapaxes(B, -1, -2)) / 2


# ------------------------------------------------------------------ PSD
PSD_SPECS = {
    # one side
    "one_side": [(JCone.PSD, 10), (JCone.NONNEG, 3), (JCone.PSD, 10)],
    # more than two sides: bucketed into padded power-of-two batches
    "bucketed": [(JCone.PSD, 3), (JCone.FREE, 2), (JCone.PSD, 6),
                 (JCone.PSD, 15), (JCone.SOC, 4), (JCone.PSD, 36),
                 (JCone.PSD, 6)],
    # a uniform side >= 256: the JAX package's column-runs path
    "runs_256": [(JCone.ZERO, 1), (JCone.PSD, 256 * 257 // 2)],
}


@pytest.mark.parametrize("name", sorted(PSD_SPECS))
def test_psd_projection_eigh_matches_jax(name):
    """eigh in f64: <= 1e-12 abs, single and batched inputs, and the dual
    projection against the Moreau identity x = P_K(x) - P_K*(-x)."""
    jspec = JSpec(tuple(PSD_SPECS[name]))
    tspec = _tspec(jspec)
    X = np.random.default_rng(3).standard_normal((3, jspec.dim))
    want = np.asarray(jax.jit(lambda v: jproj(jspec, v, "eigh"))(
        jnp.asarray(X)))
    want_d = np.asarray(jax.jit(lambda v: jpd(jspec, v, "eigh"))(
        jnp.asarray(X)))
    got = tproj(tspec, torch.from_numpy(X), "eigh").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    row = tproj(tspec, torch.from_numpy(X[1]), "eigh").numpy()
    np.testing.assert_allclose(row, want[1], rtol=0, atol=1e-12)
    got_d = tpd(tspec, torch.from_numpy(X), "eigh").numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-12)
    minus = tproj(tspec, torch.from_numpy(-X), "eigh").numpy()
    np.testing.assert_allclose(X + minus, got_d, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("counts", [None, (10, 12), (6, 4)],
                         ids=["tuned", "uniform_10_12", "uniform_6_4"])
def test_psd_poly_matches_jax(dtype, tol, counts):
    """The polynomial filter, tuned schedule and uniform schedule (both
    counts passed: the JAX package ignores cubic_iters given alone), on a
    batch of 3 matrices at d=48: <= tol ||X||_2, the dtype kept."""
    X = _sym(np.random.default_rng(5), (3,), 48).astype(dtype)
    kw = {} if counts is None else dict(quintic_iters=counts[0],
                                        cubic_iters=counts[1])
    want = np.asarray(jax.jit(lambda a: jpoly(a, **kw))(jnp.asarray(X)))
    got = tpoly(torch.from_numpy(X), **kw)
    assert got.dtype == torch.from_numpy(X).dtype
    norm2 = np.linalg.norm(X.astype(np.float64), 2, axis=(-2, -1)).max()
    assert np.abs(got.numpy().astype(np.float64) - want).max() <= tol * norm2


def test_psd_poly_uniform_counts_alone():
    """A count given alone selects what the JAX package selects:
    cubic_iters alone is ignored (the tuned schedule runs), quintic_iters
    alone is refused with an error naming cubic_iters.  The port used to
    run the uniform schedule for either count alone."""
    X = torch.from_numpy(_sym(np.random.default_rng(6), (), 16))
    both = tpoly(X, quintic_iters=10, cubic_iters=12)
    assert torch.equal(tpoly(X, cubic_iters=12), tpoly(X))
    assert not torch.equal(tpoly(X, cubic_iters=12), both)
    with pytest.raises(ValueError, match="cubic_iters"):
        tpoly(X, quintic_iters=10)


def test_psd_poly_schedule_selection_matches_jax():
    """Each way of passing the counts against fos_tpu.cones.psd_poly at
    f64, 1e-10 ||X||_2: none and cubic_iters alone (both the tuned
    schedule), both counts (uniform); quintic_iters alone fails in both
    packages (JAX inside its scan, the port with a ValueError)."""
    X = _sym(np.random.default_rng(7), (2,), 24)
    norm2 = np.linalg.norm(X, 2, axis=(-2, -1)).max()
    for kw in ({}, dict(cubic_iters=5), dict(quintic_iters=6, cubic_iters=4)):
        want = np.asarray(jpoly(jnp.asarray(X), **kw))
        got = tpoly(torch.from_numpy(X), **kw).numpy()
        assert np.abs(got - want).max() <= 1e-10 * norm2, kw
    with pytest.raises(Exception):
        jpoly(jnp.asarray(X), quintic_iters=6)
    with pytest.raises(ValueError, match="cubic_iters"):
        tpoly(torch.from_numpy(X), quintic_iters=6)


def test_poly_project_keeps_f32_and_tf32_stays_off():
    """An f32 vector stays f32 through project(psd_method="poly"), the
    result is within 1e-5 ||X||_2 of the f64 eigh projection, and TF32 is
    still off after the call (fos_tpu_torch.config pins it)."""
    d = 24
    spec = fos_tpu_torch.cones.psd(d)
    X = _sym(np.random.default_rng(8), (), d)
    x = svec(torch.from_numpy(X))
    y = tproj(spec, x.float(), "poly")
    assert y.dtype == torch.float32
    ref = tproj(spec, x, "eigh")
    err = (smat(y.double()) - smat(ref)).abs().max().item()
    assert err <= 1e-5 * np.linalg.norm(X, 2)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_resolve_psd_method():
    """"auto" is "poly" on a CUDA device and "eigh" on the CPU; anything
    but auto/eigh/poly is refused."""
    assert resolve_psd_method("auto", "cpu") == "eigh"
    assert resolve_psd_method("auto", torch.device("cuda", 0)) == "poly"
    assert resolve_psd_method("poly", "cpu") == "poly"
    with pytest.raises(ValueError, match="psd_method"):
        resolve_psd_method("cholesky", "cpu")


def test_svec_smat_match_jax():
    X = _sym(np.random.default_rng(9), (2,), 7)
    for scaled in (True, False):
        v = svec(torch.from_numpy(X), scaled)
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jsvec(jnp.asarray(X), scaled)))
        np.testing.assert_array_equal(
            smat(v, scaled).numpy(), np.asarray(jsmat(jnp.asarray(v.numpy()),
                                                      scaled)))


# -------------------------------------------------------------- EXP, POW
def _exp_battery():
    """The corner battery: the sign/magnitude grid, boundary rays, the
    dual-edge neighbourhood and random extreme magnitudes."""
    pts = list(_sign_mag_grid())
    for s in (1e-6, 1.0, 1e6):
        for ratio in (-100.0, -1.0, 0.0, 1.0, 50.0):
            t = s * np.exp(ratio)
            if np.isfinite(t) and t != 0.0:
                pts += [np.array([ratio * s, s, f * t])
                        for f in (1.0 - 1e-9, 1.0, 1.0 + 1e-9, 2.0)]
    for eps, vv, ww in itertools.product((0.0, 1e-12, 1e-6), (0.0, 1.0, 1e6),
                                         (0.0, 1.0, 1e6)):
        pts += [np.array([-eps, vv, ww]), np.array([eps, -vv, -ww])]
    rng = np.random.default_rng(13)
    pts += [rng.standard_normal(3) * (10.0 ** rng.uniform(-8, 8))
            for _ in range(40)]
    return np.stack(pts)


def _pow_battery():
    """(points, alphas): the grid at every corner alpha, the boundary
    straddles of test_pow.py and random points with random alphas."""
    grid = np.stack(list(_sign_mag_grid()))
    pts = [grid] * len(ALPHA_CORNERS)
    alph = [np.full(len(grid), a) for a in ALPHA_CORNERS]
    extra, ea = [], []
    for a in (1e-3, 0.3, 0.94731, 1 - 1e-3):
        for x, y in [(2.0, 3.0), (1e2, 1e-2)]:
            zb = x ** a * y ** (1 - a)
            for f in (0.999, 1.0, 1.001, 1.5):
                extra.append([x, y, f * zb])
                ea.append(a)
    extra.append([-20.779, 4.665, 2.6805])
    ea.append(0.94731)
    rng = np.random.default_rng(4)
    for _ in range(60):
        extra.append(rng.standard_normal(3) * (10.0 ** rng.uniform(-2, 2)))
        ea.append(rng.uniform(0.05, 0.95))
    return (np.concatenate(pts + [np.array(extra)]),
            np.concatenate(alph + [np.array(ea)]))


def _close(got, want, v, rel):
    scale = 1.0 + np.abs(v).max(axis=-1, keepdims=True)
    bad = np.abs(got - want) > rel * scale
    assert not bad.any(), (v[bad.any(-1)][:5], got[bad.any(-1)][:5],
                           want[bad.any(-1)][:5])


def test_exp_battery_matches_jax():
    """Primal and dual, f64: <= 1e-10 (1 + |v|) per point."""
    V = _exp_battery()
    jp = jax.jit(jax.vmap(project_exp_single))
    want = np.asarray(jp(jnp.asarray(V)))
    want_d = V + np.asarray(jp(jnp.asarray(-V)))
    got = texp.project_exp(torch.from_numpy(V)).numpy()
    got_d = texp.project_exp_dual(torch.from_numpy(V)).numpy()
    _close(got, want, V, 1e-10)
    _close(got_d, want_d, V, 1e-10)


def test_pow_battery_matches_jax():
    V, a = _pow_battery()
    jp = jax.jit(jax.vmap(project_pow_single))
    want = np.asarray(jp(jnp.asarray(V), jnp.asarray(a)))
    want_d = V + np.asarray(jp(jnp.asarray(-V), jnp.asarray(a)))
    got = tpow.project_pow(torch.from_numpy(V), torch.from_numpy(a)).numpy()
    got_d = tpow.project_pow_dual(torch.from_numpy(V),
                                  torch.from_numpy(a)).numpy()
    _close(got, want, V, 1e-10)
    _close(got_d, want_d, V, 1e-10)


def test_exp_pow_f32_corners_stay_finite_and_match_jax():
    """The f32 tier: the grid stays finite and within 2e-4 (1 + |v|) of the
    JAX package's f32 projection."""
    V = np.stack(list(_sign_mag_grid())).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(project_exp_single))(jnp.asarray(V)))
    got = texp.project_exp(torch.from_numpy(V)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    _close(got.astype(np.float64), want.astype(np.float64), V, 2e-4)
    for a in (1e-3, 0.5, 1 - 1e-3):
        av = np.full(len(V), a, np.float32)
        want = np.asarray(jax.jit(jax.vmap(project_pow_single))(
            jnp.asarray(V), jnp.asarray(av)))
        got = tpow.project_pow(torch.from_numpy(V), torch.from_numpy(av))
        assert got.dtype == torch.float32
        assert np.isfinite(got.numpy()).all()
        _close(got.numpy().astype(np.float64), want.astype(np.float64), V,
               2e-4)


def test_h_sign_rho_1e7_overflow_case():
    """quad * (t * e1), not (quad * t) * e1: at rho = 1e7 in f32, t up to
    3.4e38, the sign function stays finite, as the JAX package's does."""
    for t in (1e30, -1e30, 3.4e38):
        args = (np.float32(1e7), np.float32(1e-7), np.float32(-1.0),
                np.float32(t))
        got = texp._h_sign(*(torch.tensor(a) for a in args))
        want = np.asarray(j_h_sign(*(jnp.float32(a) for a in args)))
        assert torch.isfinite(got) and np.isfinite(want)
        assert np.sign(got.item()) == np.sign(want)


def test_fused_exp_pow_blocks_match_jax():
    """Exp and pow blocks, primal and dual, mixed with other cones in one
    spec (the port gathers each family's primal and dual blocks into one
    batch): f64, batched, <= 1e-10 (1 + |x|)."""
    jspec = JSpec(((JCone.NONNEG, 4), (JCone.EXP_PRIMAL, 6),
                   (JCone.POW_PRIMAL, 6), (JCone.EXP_DUAL, 3),
                   (JCone.SOC, 3), (JCone.POW_DUAL, 3)),
                  ((), (), (0.3, 0.7), (), (), (0.5,)))
    tspec = _tspec(jspec)
    X = np.random.default_rng(11).standard_normal((4, jspec.dim)) * 3
    jp = jax.jit(lambda v: jproj(jspec, v))
    want = np.asarray(jp(jnp.asarray(X)))
    _close(tproj(tspec, torch.from_numpy(X)).numpy(), want, X, 1e-10)
    # the dual through the JAX projection and Moreau: x + P_K(-x) (one
    # compile of the JAX projection, not two)
    want_d = X + np.asarray(jp(jnp.asarray(-X)))
    _close(tpd(tspec, torch.from_numpy(X)).numpy(), want_d, X, 1e-10)


# ----------------------------------------------------- the kitchen sink
def test_kitchen_sink_dr_trajectory_matches_jax():
    """tests/test_kitchen_sink.py's problem (zero, nonneg, SOC, rotated
    SOC, PSD, exp and power rows), 300 DR steps in f64 from the JAX
    package's initial state carried across (interop.solver_state_from_tree:
    the tracked CG warm start, an S2 without state), both packages with
    eigh and converged CG projections (a loosely stopped CG is decided by
    rounding): <= 1e-9 relative."""
    A, b, cc, K1, K2, *_ = build_problem()
    jf = JForm.build(jconic(jnp.asarray(A), jnp.asarray(b), jnp.asarray(cc),
                            K1, K2), psd_method="eigh")
    tf = TForm.build(tconic(A, b, cc, _tspec(K1), _tspec(K2), device=CPU),
                     psd_method="eigh")
    kw = dict(decreasing_accuracy=False, tol_floor=1e-12)
    jf.sets.s1 = JProj.create(jf.A, jf.b, jf.c, **kw)
    tf.sets.s1 = TProj.create(tf.A, tf.b, tf.c, **kw)
    j0 = jinit(fos_tpu.DR(), jf.sets, jf.initial_value(jf.dtype))
    jst = jengine._run_steps(fos_tpu.DR(), jf, j0, 300)
    t0 = interop.solver_state_from_tree(j0, device=CPU)
    assert t0.s2_state == ()
    np.testing.assert_array_equal(
        t0.s1_state.v_warm.numpy(),
        tinit(fos_tpu_torch.DR(), tf.sets, t0.x).s1_state.v_warm.numpy())
    tst = tengine._run_steps(fos_tpu_torch.DR(), tf, t0, 300)
    want = np.asarray(jst.x)
    got = tst.x.numpy()
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    assert tf.route == "cpu" and tf.psd_method == "eigh"


# ---------------------------------------------------- solves and routes
@pytest.mark.parametrize("psd_method", ["eigh", "poly"])
def test_nearest_psd_solve(psd_method, capsys):
    """tests/test_psd_exp_e2e.py::test_nearest_psd through the port's solve:
    Optimal, the eigenvalue clamp to 1e-7; the PSD method and the route
    are fixed when the form is built, printed in the header and carried
    on the solution (eigh cannot run on the graph route)."""
    ys = np.array([[-0.0064709, -0.22443], [-0.22443, -1.02411]])
    vs = svec(torch.from_numpy(ys)).numpy()
    L, nv = 3, 4
    Ac = np.zeros((1 + L, nv))
    bc = np.zeros(1 + L)
    Ac[0, 0] = -1.0
    Ac[1:, 1:] = -np.eye(L)
    bc[1:] = -vs
    c = np.zeros(nv)
    c[0] = 1.0
    K1 = fos_tpu_torch.soc(1 + L)
    K2 = fos_tpu_torch.ConeSpec(((fos_tpu_torch.Cone.FREE, 1),
                                 (fos_tpu_torch.Cone.PSD, L)))
    sol = fos_tpu_torch.solve(Ac, bc, c, K1, K2, alg=fos_tpu_torch.DR(),
                              eps=1e-9, max_iters=20000, verbose=1,
                              device=CPU, psd_method=psd_method)
    assert sol.status == "Optimal" and sol.route == "cpu"
    assert f"PSD projection: {psd_method}, cpu route" in capsys.readouterr().out
    w, V = np.linalg.eigh(ys)
    np.testing.assert_allclose(smat(sol.x[1:]).numpy(),
                               (V * np.maximum(w, 0)) @ V.T, atol=1e-7)
    form = TForm.build(tconic(Ac, bc, c, K1, K2, device=CPU),
                       psd_method=psd_method)
    assert form.psd_method == psd_method
    assert form.graph_route == (psd_method == "poly")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_exp_x2_edge_projects_to_its_limit(dtype):
    """Points of bench.py's exp recipe (N(0, 4) entries) near the x2 = 0
    edge, r -> 0+ and s < 0: the numerator of x2 cancels to rounding noise
    there.  The port's projection is in the cone's closure and at least as
    close to v as the cone point (0, 0, t); the JAX package's result for
    these points turns on how its compiler rounds that numerator (it gave
    z = 0 for the second point and an x of 0.036 with y ~ 1e-21, outside
    the cone, for the first)."""
    V = np.array([[0.03613972, -2.86787963, 5.1898694],
                  [0.00343741, -1.536738, 1.5350136],
                  [0.0497, -1.83, 1.414],
                  [1e-9, -1.0, 2.0]], dtype=dtype)
    P = texp.project_exp(torch.from_numpy(V)).numpy().astype(np.float64)
    V = V.astype(np.float64)
    assert np.isfinite(P).all()
    x, y, z = P.T
    with np.errstate(over="ignore"):
        inside = np.where(y > 0, y * np.exp(np.minimum(x / np.where(
            y > 0, y, 1.0), 700.0)) <= z * (1 + 1e-6) + 1e-12,
            (x <= 1e-12) & (z >= 0))
    assert inside.all(), P
    corner = np.stack([np.zeros(4), np.zeros(4), V[:, 2]], 1)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert (np.linalg.norm(V - P, axis=1)
            <= np.linalg.norm(V - corner, axis=1) * (1 + tol)).all()
