"""fos_tpu_torch's fused solve and device loops against the JAX package, on
the CPU at f64 (one f32 case), on the same seeded numpy inputs:

* ``fused_solve`` against the port's chunked ``run`` and JAX's
  ``fused_solve`` (the role of tests/test_parallel.py:43), its exact budget
  and gated history (test_parallel.py:83), exact resume within the port
  (test_parallel.py:62) and from a JAX ``FusedResult.state``;
* the stall recovery's tensor hooks against JAX's and the port's host
  hooks, and an f32 solve whose floor tightens on the device at the same
  check as JAX's;
* fused feasibility (tests/test_feasibility.py:98);
* the device-loop route of :mod:`fos_tpu_torch.linalg.control` (its loop
  buffers and copies, the conditions read on the host as a stand-in for
  the conditional nodes) against the eager loops, bit for bit;
* ``run``'s ``profile_dir``.

The graph route itself (CUDA graphs, conditional nodes) runs only on the
card: tests/test_torch_cuda.py.
"""

import json
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import fos_tpu
from fos_tpu.linalg.affine import HSDEAffineProjector as JProj
from fos_tpu.problems.conic import conic_problem as jconic
from fos_tpu.problems.feasibility import (Feasibility as JFeasibility,
                                         FeasibilityForm as JFeasForm)
from fos_tpu.problems.hsde import HSDECheck as JCheck, HSDEForm as JForm
from fos_tpu.sets import AffineSet as JAffineSet, NonNeg as JNonNeg
from fos_tpu.solvers.engine import fused_solve as jfused

import fos_tpu_torch as T
from fos_tpu_torch import interop
from fos_tpu_torch.linalg import control
from fos_tpu_torch.linalg.affine import HSDEAffineProjector as TProj
from fos_tpu_torch.linalg.cg import (conjugate_gradient,
                                     conjugate_gradient_tracked)
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.feasibility import FeasibilityForm as TFeasForm
from fos_tpu_torch.problems.hsde import HSDECheck as TCheck, HSDEForm as TForm
from fos_tpu_torch.solvers import engine
from fos_tpu_torch.solvers.status import Status


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _lp(m, n, seed):
    """An LP with a primal-dual certificate (the recipe of
    test_parallel.py's ``_lp_batch``), f64."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    xmask = rng.random(n) < 0.5
    x0 = np.abs(rng.standard_normal(n)) * xmask
    r0 = np.abs(rng.standard_normal(n)) * ~xmask
    ymask = rng.random(m) < 0.5
    y0 = np.abs(rng.standard_normal(m)) * ymask
    s0 = np.abs(rng.standard_normal(m)) * ~ymask
    return A, A @ x0 + s0, r0 - A.T @ y0


def _forms(A, b, c, **build):
    m, n = A.shape
    tf = TForm.build(tconic(A, b, c, T.nonneg(m), T.nonneg(n), device="cpu"),
                     **build)
    jf = JForm.build(jconic(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                            fos_tpu.cones.nonneg(m), fos_tpu.cones.nonneg(n)),
                     **build)
    return tf, jf


@pytest.fixture(scope="module")
def solved():
    """The 8x12 LP solved to eps=1e-7 by the port's run and fused_solve
    (with history) and by JAX's fused_solve."""
    tf, jf = _forms(*_lp(8, 12, 0))
    run = engine.run(tf, T.DR(), eps=1e-7, max_iters=10000, checki=100,
                     verbose=0)
    fused = engine.fused_solve(T.DR(), tf, tf.initial_value(tf.dtype),
                               max_iters=10000, eps=1e-7, checki=100,
                               record_history=True)
    jres = jfused(fos_tpu.DR(), jf, jf.initial_value(jf.dtype),
                  max_iters=10000, eps=1e-7, checki=100)
    return tf, run, fused, jres


def _x(form, guess):
    return (guess[: form.n] / guess[form.l - 1]).numpy()


def test_fused_matches_chunked_and_jax(solved):
    tf, run, fused, jres = solved
    assert run.status == int(fused.status) == Status.OPTIMAL
    assert int(jres.status) == Status.OPTIMAL
    assert run.iters == int(fused.iters) == int(jres.iters)
    np.testing.assert_allclose(_x(tf, fused.guess), _x(tf, run.guess),
                               atol=1e-6)
    jg = np.asarray(jres.guess)
    np.testing.assert_allclose(_x(tf, fused.guess),
                               jg[: tf.n] / jg[tf.l - 1], atol=1e-6)


def test_fused_budget_exact_and_history_gated(solved):
    tf, _, fused, _ = solved
    res_f = engine.fused_solve(T.DR(), tf, tf.initial_value(tf.dtype),
                               max_iters=250, eps=1e-30, checki=100)
    res_c = engine.run(tf, T.DR(), max_iters=250, eps=1e-30, checki=100,
                       verbose=0)
    assert int(res_f.iters) == 250 == res_c.iters
    # history rows after the termination row stay zero
    kterm = int(fused.iters) // 100 - 1
    hist = fused.hist.numpy()
    assert hist.shape == (100, len(TCheck._fields))
    assert np.any(hist[kterm] != 0)
    assert np.all(hist[kterm + 1:] == 0)


def test_fused_resume_is_exact():
    """Two 700-iteration segments are bit for bit one 1400-iteration run:
    iterate, counter, CG warm start and schedule all carried."""
    tf, _ = _forms(*_lp(4, 6, 0))
    z0 = tf.initial_value(tf.dtype)
    full = engine.fused_solve(T.DR(), tf, z0, max_iters=1400, eps=0.0,
                              checki=100)
    r1 = engine.fused_solve(T.DR(), tf, z0, max_iters=700, eps=0.0,
                            checki=100)
    r2 = engine.fused_solve(T.DR(), tf, z0, max_iters=700, eps=0.0,
                            checki=100, resume_state=r1.state)
    assert int(r2.state.i) == int(full.state.i) == 1400
    assert torch.equal(r2.state.x, full.state.x)
    assert torch.equal(r2.state.s1_state.warm, full.state.s1_state.warm)
    assert int(r2.state.s1_state.total_iters) == int(
        full.state.s1_state.total_iters)


def test_jax_fused_state_resumes_in_the_port():
    """JAX's FusedResult.state after 100 iterations (with its recovery floor
    and plateau baseline) carried into the port, 100 more fused port
    iterations == JAX's 200.  The projections run CG to a 1e-10 floor, not
    the decreasing schedule: a loosely stopped CG is rounding-determined
    (ROADMAP queue 3), so only converged projections make the trajectory a
    function of the data alone; the tolerance is that of
    test_torch_modules.py::test_state_carried_from_jax_continues_the_trajectory."""
    tf, jf = _forms(*_lp(8, 12, 1))
    kw = dict(decreasing_accuracy=False, tol_floor=1e-10)
    jf.sets.s1 = JProj.create(jf.A, jf.b, jf.c, **kw)
    tf.sets.s1 = TProj.create(tf.A, tf.b, tf.c, **kw)
    z0 = jf.initial_value(jf.dtype)
    j100 = jfused(fos_tpu.DR(), jf, z0, max_iters=100, eps=0.0, checki=50)
    j200 = jfused(fos_tpu.DR(), jf, z0, max_iters=200, eps=0.0, checki=50)
    st = interop.solver_state_from_tree(j100.state, device="cpu")
    assert st.s1_state.floor is not None and st.s1_state.win_score is not None
    t200 = engine.fused_solve(T.DR(), tf, None, max_iters=100, eps=0.0,
                              checki=50, resume_state=st)
    assert int(t200.iters) == int(j200.iters) == 200
    for got, want in ((t200.state.x, j200.state.x),
                      (t200.state.s1_state.warm, j200.state.s1_state.warm),
                      (t200.guess, j200.guess)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8)
    assert int(t200.state.s1_state.total_iters) == int(
        j200.state.s1_state.total_iters)
    assert float(t200.state.s1_state.floor) == float(j200.state.s1_state.floor)


def _check_grid():
    """Check values around the recovery's thresholds (eps = 1e-3,
    ||b||, ||c|| of the form): both statuses, tau of both signs, p/d/g
    just inside and outside, a NaN."""
    rows = []
    for status in (Status.CONTINUE, Status.OPTIMAL):
        for tau in (1.0, 0.5, -1.0):
            for p in (1e-4, 0.5):
                for g in (1e-4, 0.02, math.nan):
                    rows.append((status, p, 2e-4, g, 3.0, -2.5, tau, 0.1))
    return rows


def test_traced_stall_hooks_match_jax_and_host_hooks():
    tf, jf = _forms(*_lp(8, 12, 0))
    eps = 1e-3
    for vals in _check_grid():
        status, rest = vals[0], vals[1:]
        tchk = TCheck(torch.tensor(status, dtype=torch.int32),
                      *(torch.tensor(v, dtype=torch.float64) for v in rest))
        jchk = JCheck(jnp.asarray(status, jnp.int32),
                      *(jnp.asarray(v, jnp.float64) for v in rest))
        hchk = TCheck(status, *rest)
        gap = bool(tf.gap_stalled_traced(tchk, eps))
        assert gap == bool(jf.gap_stalled_traced(jchk, eps))
        assert gap == tf.gap_stalled(hchk, eps)
        score = float(tf.stall_score(tchk, eps))
        jscore = float(jf.stall_score(jchk, eps))
        assert score == pytest.approx(jscore, rel=1e-12, nan_ok=True)
        for win in (math.inf, 2.0 * score if math.isfinite(score) else 1.0,
                    1.01 * score if math.isfinite(score) else 1.0):
            for remaining in (1, 40):
                got, gs = tf.plateau_stalled_traced(
                    tchk, eps, torch.tensor(win, dtype=torch.float64),
                    torch.tensor(remaining, dtype=torch.int32))
                want, _ = jf.plateau_stalled_traced(
                    jchk, eps, jnp.asarray(win, jnp.float64),
                    jnp.asarray(remaining, jnp.int32))
                host, hs = tf.plateau_stalled(hchk, eps, win, remaining)
                assert bool(got) == bool(want) == host, (vals, win, remaining)
                assert float(gs) == pytest.approx(hs, rel=1e-12, nan_ok=True)


def test_f32_floor_tightens_on_the_device_at_the_same_check_as_jax():
    """An f32 solve held to an unreachable eps: with a 150-iteration budget
    the plateau test (every 10 checks of 5 iterations) fires at check 20 in
    both packages, so the floor is the default after 95 iterations and
    ~sqrt(2l) eps_f32 after 100.  Both packages check without compensated
    reductions, which halves the JAX package's compile time here."""
    A, b, c = (a.astype(np.float32) for a in _lp(8, 12, 0))
    tf, jf = _forms(A, b, c, compensated=False)
    default, tight = tf.fused_cg_floors()
    floors = {}
    for n in (95, 100):
        kw = dict(max_iters=n, eps=1e-9, checki=5, budget_iters=150)
        t = engine.fused_solve(T.DR(), tf, tf.initial_value(tf.dtype), **kw)
        j = jfused(fos_tpu.DR(), jf, jf.initial_value(jf.dtype), **kw)
        floors[n] = (float(t.state.s1_state.floor),
                     float(j.state.s1_state.floor))
    assert floors[95] == pytest.approx((default, default), rel=1e-6)
    assert floors[100] == pytest.approx((tight, tight), rel=1e-6)


def test_fused_feasibility():
    """test_feasibility.py:98 in the port: DR on {Ax = b} and x >= 0, fused,
    against the port's run and JAX's fused_solve."""
    rng = np.random.default_rng(2)
    xsol = np.abs(rng.standard_normal(100))
    A = rng.standard_normal((50, 100))
    b = A @ xsol
    tform = TFeasForm.build(T.Feasibility(
        T.AffineSet.create(A, b, device="cpu"), T.NonNeg(), 100),
        device="cpu")
    res = engine.fused_solve(T.DR(), tform, tform.initial_value(tform.dtype),
                             max_iters=10000, eps=1e-8, checki=100)
    assert int(res.status) == Status.OPTIMAL
    x = res.guess.numpy()
    assert x.min() > -1e-10
    assert np.max(np.abs(A @ x - b)) < 1e-6
    run = engine.run(tform, T.DR(), max_iters=10000, eps=1e-8, checki=100,
                     verbose=0)
    jform = JFeasForm.build(JFeasibility(JAffineSet.create(A, b), JNonNeg(),
                                         100))
    jres = jfused(fos_tpu.DR(), jform, jform.initial_value(jform.dtype),
                  max_iters=10000, eps=1e-8, checki=100)
    assert run.iters == int(res.iters) == int(jres.iters)
    np.testing.assert_allclose(x, np.asarray(jres.guess), atol=1e-8)


def test_cg_device_loop_matches_the_eager_loop():
    """CG through the device-loop route (buffers, copies, the condition read
    on the host in place of the conditional node) takes the eager loop's
    iterations and gives its bits, standard and tracked."""
    tf, _ = _forms(*_lp(8, 12, 3))
    l = tf.l
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal(l))
    x0 = torch.from_numpy(rng.standard_normal(l))
    q = tf.sets.s1._q
    for unroll in (1, 2):
        for route in ("eager", "device"):
            with control.emulated() if route == "device" else _nothing():
                std = conjugate_gradient(
                    lambda v: v - q(q(v)), u, x0, tol=1e-9, max_iters=50,
                    unroll=unroll)
                trk = conjugate_gradient_tracked(
                    q, u - (x0 - q(q(x0))), x0, q(x0), tol=1e-9,
                    max_iters=50, unroll=unroll)
            if route == "eager":
                want = (std, trk)
        for got, ref in zip((std, trk), want):
            assert int(got.iters) == int(ref.iters) > 0
            for a, b in zip(got, ref):
                assert torch.equal(a, b)


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("alg", ["gapp", "fista", "dykstra"])
def test_algorithms_through_the_device_loops(alg):
    """The chunked run with its step loops and GAPP's branch on the device
    route (GAPP then branches on the device's st.i instead of the host's
    count) gives the eager run's iterations and bits."""
    rng = np.random.default_rng(2)
    xsol = np.abs(rng.standard_normal(40))
    A = rng.standard_normal((20, 40))
    algorithm = {"gapp": T.GAPP(iproj=7), "fista": T.FISTA(),
                 "dykstra": T.Dykstra()}[alg]
    form = TFeasForm.build(T.Feasibility(
        T.AffineSet.create(A, A @ xsol, device="cpu"), T.NonNeg(), 40),
        device="cpu")
    kw = dict(max_iters=250, eps=1e-9, checki=50, verbose=0)
    eager = engine.run(form, algorithm, **kw)
    with control.emulated():
        device = engine.run(form, algorithm, **kw)
    assert (eager.status, eager.iters) == (device.status, device.iters)
    assert torch.equal(eager.guess, device.guess)
    np.testing.assert_array_equal(eager.history.get("err")[1],
                                  device.history.get("err")[1])


def test_run_profile_dir_writes_a_trace(tmp_path):
    tf, _ = _forms(*_lp(4, 6, 0))
    engine.run(tf, T.DR(), max_iters=20, checki=10, eps=0.0, verbose=0,
               profile_dir=str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_graph_cache_keeps_one_graph_per_kind():
    """A form keeps the last graph of each kind (chunk, steps, final,
    fused); a new key of a kind frees the graph it replaces, and
    ``release`` frees the rest."""
    from fos_tpu_torch.solvers import graphs

    class Graph:
        def __init__(self, key):
            self.key, self.released = key, False

        def release(self):
            self.released = True

    class Owner:
        pass

    owner = Owner()
    a = graphs.cached(owner, ("chunk", 100, 1e-5), lambda: Graph("a"))
    s = graphs.cached(owner, ("steps", 7), lambda: Graph("s"))
    assert graphs.cached(owner, ("chunk", 100, 1e-5), lambda: Graph("x")) is a
    b = graphs.cached(owner, ("chunk", 100, 1e-6), lambda: Graph("b"))
    assert a.released and not b.released and not s.released
    graphs.release(owner)
    assert b.released and s.released
    c = graphs.cached(owner, ("chunk", 100, 1e-6), lambda: Graph("c"))
    assert c.key == "c"
