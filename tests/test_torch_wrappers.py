"""fos_tpu_torch's wrappers (line search, Anderson, longstep) against the
JAX package's, in the role of tests/test_wrappers.py.

The same numpy-seeded problems go through both packages on the CPU in f64:
the capability traits, the plane projection, N wrapped steps from one
start (state and guess at 1e-9), the line search's call counter and its
probe cache's affine identity, the line search on a feasibility problem
(CG per candidate lane, AffinePlusLinearProjector), and a wrapped
``fused_solve`` against ``run`` and the captured route's data flow.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fos_tpu
from fos_tpu.linalg.affine import AffinePlusLinearProjector as JAPL
from fos_tpu.problems.conic import conic_problem as jconic
from fos_tpu.problems.feasibility import (Feasibility as JFeas,
                                          FeasibilityForm as JFeasForm)
from fos_tpu.problems.hsde import HSDEForm as JForm
from fos_tpu.sets import BlockSet as JBlockSet, Box as JBox, NonNeg as JNonNeg
from fos_tpu.solvers import engine as jengine
from fos_tpu.solvers import wrappers as jwrappers
from fos_tpu.solvers.base import init_solver_state as jinit

import fos_tpu_torch as T
from fos_tpu_torch import interop
from fos_tpu_torch.linalg import control
from fos_tpu_torch.linalg.affine import (AffinePlusLinearProjector as TAPL,
                                         HSDEAffineProjector as THSDE)
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.feasibility import (Feasibility as TFeas,
                                                FeasibilityForm as TFeasForm)
from fos_tpu_torch.problems.hsde import HSDEForm as THSDEForm
from fos_tpu_torch.solvers import engine as tengine
from fos_tpu_torch.solvers import wrappers as twrappers
from fos_tpu_torch.solvers.base import init_solver_state as tinit

M, N = 12, 20


def _lp(seed=0, m=M, n=N):
    """An LP with a primal-dual certificate (tests/test_parallel.py's
    construction), so the HSDE converges with tau > 0."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    xm = rng.random(n) < 0.5
    ym = rng.random(m) < 0.5
    x0 = np.abs(rng.standard_normal(n)) * xm
    r0 = np.abs(rng.standard_normal(n)) * ~xm
    y0 = np.abs(rng.standard_normal(m)) * ym
    s0 = np.abs(rng.standard_normal(m)) * ~ym
    return A, A @ x0 + s0, r0 - A.T @ y0


def _forms(direct=False):
    A, b, c = _lp()
    jf = JForm.build(jconic(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                            fos_tpu.cones.nonneg(M), fos_tpu.cones.nonneg(N)),
                     direct=direct)
    tf = THSDEForm.build(tconic(A, b, c, T.nonneg(M), T.nonneg(N),
                                device="cpu"), direct=direct)
    return jf, tf


#: (make the wrapper from a package, steps, direct mode); the inner
#: algorithms are DR (also in direct mode, which takes the probe cache) and
#: GAPA
WRAPPED = {
    "linesearch": (lambda m: m.LineSearchWrapper(m.DR(), lsinterval=10), 40,
                   False),
    "linesearch_direct": (lambda m: m.LineSearchWrapper(
        m.DR(direct=True), lsinterval=10), 40, True),
    "linesearch_gapa": (lambda m: m.LineSearchWrapper(m.GAPA(0.8, 0.9),
                                                      lsinterval=10), 30,
                        False),
    "anderson": (lambda m: m.AndersonWrapper(m.DR(), memory=5,
                                             adaptive=False), 40, False),
    "longstep": (lambda m: m.LongstepWrapper(m.DR(), longinterval=20,
                                             nsave=5), 40, False),
}
#: DR steps that carry both packages to a common start: by then the
#: decreasing-accuracy CG tolerance is at its floor, so projections are
#: converged (an early projection stops at a loose tolerance, where CG's
#: iterate moves ~1e8 times its inputs' rounding, in either package)
WARMUP = 400


@functools.lru_cache(maxsize=None)
def _jax_warm(direct):
    jf, _ = _forms(direct)
    res = jengine.fused_solve(fos_tpu.DR(direct=direct), jf,
                              jf.initial_value(jf.dtype), max_iters=WARMUP,
                              eps=0.0, checki=WARMUP)
    return res.state


def _starts(key):
    """The JAX DR state after WARMUP steps, with the wrapper's fresh aux,
    as a JAX state and as the port's (interop)."""
    make, _, direct = WRAPPED[key]
    jst = _jax_warm(direct)
    jalg, talg = make(fos_tpu), make(T)
    jst = jst._replace(aux=jalg.init_aux(jst.x))
    tst = interop.solver_state_from_tree(jst._replace(aux=()), "cpu")
    return jalg, jst, talg, tst._replace(aux=talg.init_aux(tst.x))


@functools.lru_cache(maxsize=None)
def _jax_steps(key):
    _, steps, direct = WRAPPED[key]
    jf, _ = _forms(direct)
    jalg, jst, _, _ = _starts(key)
    res = jengine.fused_solve(jalg, jf, jst.x, max_iters=steps, eps=0.0,
                              checki=steps, resume_state=jst)
    return (np.asarray(res.state.x), np.asarray(res.guess),
            int(res.state.s1_state.call_idx))


def test_trait_checks():
    """The capability traits of every algorithm equal the JAX package's,
    and the wrappers refuse the algorithms the JAX package refuses."""
    for name in ("GAP", "GAPA", "GAPP", "FISTA", "Dykstra"):
        j, t = getattr(fos_tpu, name)(), getattr(T, name)()
        assert (t.support_linesearch, t.support_longstep) == (
            j.support_linesearch, j.support_longstep), name
    for mod in (fos_tpu, T):
        with pytest.raises(ValueError):
            mod.LineSearchWrapper(alg=mod.FISTA())
        with pytest.raises(ValueError):
            mod.LongstepWrapper(alg=mod.GAPP())
        assert not mod.LineSearchWrapper(alg=mod.DR()).support_longstep
    assert THSDE.projection_is_affine and THSDE.projection_offset_free
    assert TAPL.projection_is_affine and not TAPL.projection_offset_free


def test_project_on_planes_matches_jax():
    """The plane-intersection projection (400 FISTA steps on the dual) on
    random equality and inequality planes, some rows empty: 1e-12."""
    rng = np.random.default_rng(3)
    nsave, dim = 4, 30
    rows = 2 * (nsave + 1)
    A = rng.standard_normal((rows, dim))
    A[[2, 7]] = 0.0   # unwritten rows
    b = rng.standard_normal(rows)
    x = rng.standard_normal(dim)
    want = np.asarray(jwrappers._project_on_planes(
        jnp.asarray(x), jnp.asarray(A), jnp.asarray(b), nsave))
    got = twrappers._project_on_planes(torch.from_numpy(x),
                                       torch.from_numpy(A),
                                       torch.from_numpy(b), nsave).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("key", list(WRAPPED))
def test_wrapped_steps_match_jax(key):
    """N wrapped steps on the 12x20 LP in both packages from the JAX
    package's DR state after WARMUP steps (f64; fused_solve with eps = 0,
    so every step runs): iterate, guess and the S1 call counter (which the
    line search advances by its 31 probes) at 1e-9."""
    _, steps, direct = WRAPPED[key]
    _, tf = _forms(direct)
    _, _, talg, tst = _starts(key)
    res = tengine.fused_solve(talg, tf, tst.x, max_iters=steps, eps=0.0,
                              checki=steps, resume_state=tst)
    jx, jg, jcalls = _jax_steps(key)
    assert int(res.iters) == WARMUP + steps
    np.testing.assert_allclose(res.state.x.numpy(), jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.guess.numpy(), jg, rtol=0, atol=1e-9)
    assert int(res.state.s1_state.call_idx) == jcalls


def test_linesearch_advances_cg_call_counter():
    """A line-search step makes 1 real and 31 probe S1 calls, so the call
    counter advances by 32 (affinepluslinear.jl:113), as the JAX package's;
    a plain step advances it by 1."""
    jf, tf = _forms()
    for i, want in ((0, 32), (1, 1)):
        alg = T.LineSearchWrapper(T.DR(), lsinterval=1 + i)
        st = tinit(alg, tf.sets, tf.initial_value(tf.dtype))
        st = alg.step(tf.sets, st, 0)
        assert int(st.s1_state.call_idx) == 1 + want
    jalg = fos_tpu.LineSearchWrapper(fos_tpu.DR(), lsinterval=1)
    jst = jinit(jalg, jf.sets, jf.initial_value(jf.dtype))
    assert int(jalg.step(jf.sets, jst).s1_state.call_idx) == 33


def test_probe_cache_affine_identity_and_lanes():
    """The probe cache's identity ``P(z + a r) = P(z) + a (P(r) - P(0))``
    holds for both direct projectors (HSDE offset-free); and a projection
    of points on a lane axis equals the projections of each point, in
    direct mode and through CG (per-lane stops) alike, against a shared
    state, at 1e-12, with equal CG counts.  The HSDE projector's state is
    at call 400, where its decreasing tolerance has reached the floor."""
    rng = np.random.default_rng(4)
    A = torch.from_numpy(rng.standard_normal((M, N)))
    b = torch.from_numpy(rng.standard_normal(M))
    c = torch.from_numpy(rng.standard_normal(N))
    q = torch.from_numpy(rng.standard_normal(N))
    sets = [THSDE.create(A, b, c, direct=True),
            THSDE.create(A, b, c),
            TAPL.create(A, b, q, 1, direct=True, device="cpu"),
            TAPL.create(A, b, q, 1, device="cpu")]
    for p in sets:
        dim = p.dim
        z = torch.from_numpy(rng.standard_normal(dim))
        st = (p.init_state_from(z) if hasattr(p, "init_state_from")
              else p.init_state(z.dtype))
        st = st._replace(call_idx=torch.full_like(st.call_idx, 400))
        if p.direct:
            r = torch.from_numpy(rng.standard_normal(dim))
            pz, pr, p0 = (p.project(v, st)[0] for v in (z, r, 0 * z))
            if p.projection_offset_free:
                assert float(p0.abs().max()) <= 1e-12
            for a in (0.1, 1.0, 5.8):
                np.testing.assert_allclose(p.project(z + a * r, st)[0],
                                           pz + a * (pr - p0), atol=1e-9)
        pts = torch.from_numpy(rng.standard_normal((5, dim)))
        lanes, lst = p.project(pts, st)
        for j in range(5):
            one, ost = p.project(pts[j], st)
            np.testing.assert_allclose(lanes[j], one, rtol=0, atol=1e-12)
            if not p.direct:
                assert int(lst.last_iters[j]) == int(ost.last_iters)


def _feasibility(mod, device=None):
    """A small feasibility problem for AffinePlusLinearProjector, ``Ax + s
    = b, x in [0, 1]^n, s >= 0`` (chip_smoke.py's construction at 24 x 40,
    dense A), in ``mod`` (the JAX package or the port)."""
    rng = np.random.default_rng(8)
    m, n = 24, 40
    A = rng.standard_normal((m, n))
    b = A @ rng.random(n) + np.abs(rng.standard_normal(m))
    kw = {} if device is None else {"device": device}
    S1 = (mod.AffinePlusLinearProjector if mod is T else JAPL).create(
        A, b, 0.0 if mod is T else jnp.zeros(n), -1, **kw)
    Box, NonNeg, BlockSet = ((T.Box, T.NonNeg, T.BlockSet) if mod is T
                             else (JBox, JNonNeg, JBlockSet))
    S2 = BlockSet([(Box(0.0, 1.0), n), (NonNeg(), m)])
    return (TFeas if mod is T else JFeas)(S1, S2, n + m)


@functools.lru_cache(maxsize=None)
def _jax_feasibility_steps(steps):
    form = JFeasForm.build(_feasibility(fos_tpu))
    alg = fos_tpu.LineSearchWrapper(fos_tpu.AP(), lsinterval=10)
    res = jengine.fused_solve(alg, form, form.initial_value(form.dtype),
                              max_iters=steps, eps=0.0, checki=steps)
    return np.asarray(res.state.x), int(res.state.s1_state.total_iters)


def test_linesearch_on_feasibility_matches_jax():
    """LineSearch(AP) on a feasibility problem whose S1 runs CG on I + AA'
    (AffinePlusLinearProjector: the 31 probes are 31 lanes of that CG) to
    its fixed (m + n) eps floor: 30 steps, iterate at 1e-9; the real
    steps' CG counts within 1% (rounding decides the last iteration at an
    f64 floor of 1.4e-14)."""
    form = TFeasForm.build(_feasibility(T, "cpu"), device="cpu")
    alg = T.LineSearchWrapper(T.AP(), lsinterval=10)
    res = tengine.fused_solve(alg, form, form.initial_value(form.dtype),
                              max_iters=30, eps=0.0, checki=30)
    jx, jcg = _jax_feasibility_steps(30)
    np.testing.assert_allclose(res.state.x.numpy(), jx, rtol=0, atol=1e-9)
    assert abs(int(res.state.s1_state.total_iters) - jcg) <= 0.01 * jcg


@pytest.mark.parametrize("key", ["linesearch", "anderson", "longstep"])
def test_wrapped_fused_matches_run(key):
    """A wrapped solve through ``fused_solve`` (the device's ``st.i``
    picks the extra steps: IF nodes on the card), through ``run`` (the
    host's count picks them) and through ``fused_solve`` on the captured
    route's buffers (``control.emulated``): the same status, iterations
    and bits."""
    make, _, direct = WRAPPED[key]
    _, tf = _forms(direct)
    alg = make(T)
    opts = dict(max_iters=120, eps=1e-9, checki=40)
    ran = tengine.run(tf, alg, verbose=0, **opts)
    fused = tengine.fused_solve(alg, tf, tf.initial_value(tf.dtype), **opts)
    with control.emulated():
        emu = tengine.fused_solve(alg, tf, tf.initial_value(tf.dtype), **opts)
    assert int(fused.iters) == ran.iters == int(emu.iters)
    assert int(fused.status) == int(emu.status)
    assert torch.equal(fused.guess, ran.guess)
    assert torch.equal(fused.guess, emu.guess)
    assert torch.equal(fused.state.x, emu.state.x)
