"""fos_tpu_torch's batched solve against the JAX package's, in the role of
the batched cases of tests/test_parallel.py.

B = 4 LP instances of 8 x 12 with primal-dual certificates, made with
numpy, go through ``build_batched_form`` / ``solve_batched`` of both
packages on the CPU in f64: statuses and iterations, iterates, each lane
against its own single solve, segments, warm starts, the direct mode,
``form_initial_value``, and the lane-axis CG itself.

From tau = kappa = 1 the first projections stop CG at the decreasing
schedule's loose tolerance (0.2 at the first call), where CG's iterate
moves about 1e8 times the rounding of its inputs: a lane solved alone by
either package differs from its batched self by up to ~2e-6 after a
thousand iterations.  Iterates are therefore held at 1e-9 from a common
start that the JAX package reached first (WARMUP iterations), where the
tolerance has reached its floor; from scratch, statuses and iterations
are held equal and iterates at 1e-5.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fos_tpu
from fos_tpu.parallel.batched import (build_batched_form as jbuild,
                                      form_initial_value as jinitial,
                                      solve_batched as jsolve)

import fos_tpu_torch as T
from fos_tpu_torch import interop
from fos_tpu_torch.linalg import control, hsde_ops
from fos_tpu_torch.linalg.affine import HSDEAffineProjector
from fos_tpu_torch.linalg.cg import conjugate_gradient_tracked
from fos_tpu_torch.parallel import batched as tbatched
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.hsde import HSDEForm as TForm
from fos_tpu_torch.solvers import engine as tengine

B, M, N = 4, 8, 12
L = M + N + 1
BUDGET, EPS = 1000, 1e-6
WARMUP, STEPS = 400, 200


def _lp_batch(seed=0, B=B, m=M, n=N):
    """tests/test_parallel.py's certificate batch."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    xm = rng.random((B, n)) < 0.5
    x0 = np.abs(rng.standard_normal((B, n))) * xm
    r0 = np.abs(rng.standard_normal((B, n))) * ~xm
    ym = rng.random((B, m)) < 0.5
    y0 = np.abs(rng.standard_normal((B, m))) * ym
    s0 = np.abs(rng.standard_normal((B, m))) * ~ym
    return (A, np.einsum("bmn,bn->bm", A, x0) + s0,
            r0 - np.einsum("bmn,bm->bn", A, y0))


def _forms(direct=False):
    A, b, c = _lp_batch()
    jf = jbuild(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                fos_tpu.cones.nonneg(M), fos_tpu.cones.nonneg(N),
                direct=direct)
    tf = T.build_batched_form(A, b, c, T.nonneg(M), T.nonneg(N),
                              direct=direct, device="cpu")
    return jf, tf


@functools.lru_cache(maxsize=None)
def _jax_solve(direct=False, **kw):
    jf, _ = _forms(direct)
    res = jsolve(fos_tpu.DR(direct=direct), jf, eps=EPS, **kw)
    return (np.asarray(res.status), np.asarray(res.iters),
            np.asarray(res.guess), res.state)


@functools.lru_cache(maxsize=None)
def _port_solve(segment_iters=None):
    _, tf = _forms()
    return T.solve_batched(T.DR(), tf, max_iters=BUDGET, eps=EPS,
                           segment_iters=segment_iters, record_history=True)


def test_solve_batched_matches_jax():
    """From scratch: per-instance statuses and iteration counts equal to
    the JAX package's ``solve_batched`` (DR, eps 1e-6, 1000 iterations,
    some instances stopping early), guesses at 1e-5 (see the module
    docstring)."""
    res = _port_solve()
    js, ji, jg, _ = _jax_solve(max_iters=BUDGET)
    assert res.status.shape == (B,) and res.iters.dtype == torch.int32
    np.testing.assert_array_equal(res.status.numpy(), js)
    np.testing.assert_array_equal(res.iters.numpy(), ji)
    assert 0 < int((res.status == 1).sum()) < B   # some stop, some run on
    np.testing.assert_allclose(res.guess.numpy(), jg, rtol=0, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _warm():
    """The JAX package's batched state after WARMUP iterations, and its
    STEPS more (eps = 0: every iteration runs)."""
    jf, _ = _forms()
    first = jsolve(fos_tpu.DR(), jf, max_iters=WARMUP, eps=0.0)
    from fos_tpu.parallel.batched import _solve_batched_once
    more = _solve_batched_once(fos_tpu.DR(), jf, max_iters=STEPS, eps=0.0,
                               checki=100, record_history=False, unroll=1,
                               initx=None, resume_state=first.state,
                               budget_iters=WARMUP + STEPS)
    return first.state, np.asarray(more.state.x), np.asarray(more.guess)


def test_batched_iterates_match_jax_from_a_common_start():
    """STEPS iterations from the JAX package's batched state after WARMUP
    (carried leaf by leaf): every lane's iterate and guess at 1e-9."""
    _, tf = _forms()
    jst, jx, jg = _warm()
    st = interop.solver_state_from_tree(jst, "cpu")
    res = tengine.fused_solve(T.DR(), tf, st.x, max_iters=STEPS, eps=0.0,
                              resume_state=st,
                              budget_iters=WARMUP + STEPS)
    assert res.iters.tolist() == [WARMUP + STEPS] * B
    np.testing.assert_allclose(res.state.x.numpy(), jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.guess.numpy(), jg, rtol=0, atol=1e-9)


def test_each_lane_matches_its_single_solve():
    """Each lane continued from the common start equals the port's single
    solve of that instance from the same state (1e-9); from scratch a
    single solve stops where its lane stops (one instance that stops
    early, one that runs to the budget)."""
    A, b, c = _lp_batch()
    _, tf = _forms()
    jst, _, _ = _warm()
    st = interop.solver_state_from_tree(jst, "cpu")
    lanes = tengine.fused_solve(T.DR(), tf, st.x, max_iters=STEPS, eps=0.0,
                                resume_state=st,
                                budget_iters=WARMUP + STEPS)
    full = _port_solve()
    stopped = [j for j in range(B) if int(full.status[j]) == 1][:1]
    ran_on = [j for j in range(B) if int(full.status[j]) != 1][:1]
    for j in range(B):
        f1 = TForm.build(tconic(A[j], b[j], c[j], T.nonneg(M), T.nonneg(N),
                                device="cpu"))
        one = control.tree_map(lambda t: t[j], st)
        r1 = tengine.fused_solve(T.DR(), f1, one.x, max_iters=STEPS,
                                 eps=0.0, resume_state=one,
                                 budget_iters=WARMUP + STEPS)
        np.testing.assert_allclose(r1.guess.numpy(), lanes.guess[j].numpy(),
                                   rtol=0, atol=1e-9)
        if j not in stopped + ran_on:
            continue
        s1 = tengine.fused_solve(T.DR(), f1, f1.initial_value(f1.dtype),
                                 max_iters=BUDGET, eps=EPS)
        assert (int(s1.status), int(s1.iters)) == (int(full.status[j]),
                                                   int(full.iters[j]))


def test_segmented_matches_jax_and_unsegmented():
    """``segment_iters`` resumes the full state.  300-iteration segments
    (not a divisor of the budget) give the JAX package's segmented
    statuses and counts, and the unsegmented run's statuses.  Each segment
    ends with the forced check of its guess, which may stop an instance at
    a boundary where the unsegmented run checked only the iterate: such an
    instance stops earlier, and every other one keeps the unsegmented run's
    count, guess (1e-12) and history rows; the rows of an instance that
    finished in an earlier segment are zero."""
    full, seg = _port_solve(), _port_solve(300)
    js, ji, _, _ = _jax_solve(max_iters=BUDGET, segment_iters=300)
    np.testing.assert_array_equal(seg.status.numpy(), js)
    np.testing.assert_array_equal(seg.iters.numpy(), ji)
    assert torch.equal(seg.status, full.status)
    assert bool((seg.iters <= full.iters).all())
    same = seg.iters == full.iters
    assert bool(same.any())
    np.testing.assert_allclose(seg.guess[same].numpy(),
                               full.guess[same].numpy(), rtol=0, atol=1e-12)
    assert seg.hist.shape == full.hist.shape == (B, BUDGET // 100, 8)
    np.testing.assert_allclose(seg.hist[same].numpy(),
                               full.hist[same].numpy(), rtol=0, atol=1e-12)
    for j in range(B):
        after = (int(seg.iters[j]) + 299) // 300 * 3   # rows of later segments
        assert float(seg.hist[j, after:].abs().sum()) == 0.0


def test_warm_start_matches_jax():
    """``initx``: a perturbed batch warm-started from the first batch's
    raw iterates stops where the JAX package's warm start stops, in fewer
    iterations than from scratch."""
    A, b, c = _lp_batch()
    _, _, _, jst = _jax_solve(max_iters=BUDGET)
    jf2 = jbuild(jnp.asarray(A), jnp.asarray(b * 1.001), jnp.asarray(c),
                 fos_tpu.cones.nonneg(M), fos_tpu.cones.nonneg(N))
    jwarm = jsolve(fos_tpu.DR(), jf2, max_iters=BUDGET, eps=EPS,
                   initx=jst.x)
    tf2 = T.build_batched_form(A, b * 1.001, c, T.nonneg(M), T.nonneg(N),
                               device="cpu")
    warm = T.solve_batched(T.DR(), tf2, max_iters=BUDGET, eps=EPS,
                           initx=_port_solve().state.x)
    np.testing.assert_array_equal(warm.status.numpy(),
                                  np.asarray(jwarm.status))
    np.testing.assert_array_equal(warm.iters.numpy(), np.asarray(jwarm.iters))
    assert int(warm.iters.max()) <= int(_port_solve().iters.max())
    with pytest.raises(ValueError, match="initx"):
        T.solve_batched(T.DR(), tf2, max_iters=10, initx=np.zeros((B, 3)))


def test_direct_mode_matches_jax():
    """``direct=True``: each instance's factor equals the single direct
    projector's (bits) and the JAX package's batched factor (1e-12); the
    direct solve (no CG) matches the JAX package's in statuses, counts and
    guesses (1e-9) and the indirect solve's objectives (1e-4)."""
    A, b, c = _lp_batch()
    jf, tf = _forms(direct=True)
    single = HSDEAffineProjector.create(
        torch.from_numpy(A[1]), torch.from_numpy(b[1]),
        torch.from_numpy(c[1]), direct=True)
    assert torch.equal(tf.sets.s1.fac[1], single.fac)
    np.testing.assert_allclose(tf.sets.s1.fac.numpy(),
                               np.asarray(jf.sets.s1.fac), rtol=0, atol=1e-12)
    res = T.solve_batched(T.DR(direct=True), tf, max_iters=BUDGET, eps=EPS)
    js, ji, jg, _ = _jax_solve(direct=True, max_iters=BUDGET)
    np.testing.assert_array_equal(res.status.numpy(), js)
    np.testing.assert_array_equal(res.iters.numpy(), ji)
    np.testing.assert_allclose(res.guess.numpy(), jg, rtol=0, atol=1e-9)
    ind = _port_solve()
    both = (res.status == 1) & (ind.status == 1)
    assert bool(both.any())

    def objective(r):
        return (torch.from_numpy(c) * r.guess[:, :N]
                / r.guess[:, L - 1:L]).sum(-1)

    od, oi = objective(res)[both], objective(ind)[both]
    assert float((od - oi).abs().max()) <= 1e-4 * (1 + float(oi.abs().max()))


def test_form_initial_value_matches_jax():
    jf, tf = _forms()
    np.testing.assert_array_equal(tbatched.form_initial_value(tf).numpy(),
                                  np.asarray(jinitial(jf)))


def test_lane_cg_matches_single_cg():
    """The lane-axis CG on (5, l) right-hand sides of one operator.  With
    A behind an operator (``PaddedDenseOp``: one pair call per lane, as K1
    on the card) lane j is bit for bit the solve of lane j alone on a
    (1, l) lane axis: each lane stops on its own test, at its own count.
    With A a dense tensor (one matmul for all lanes, whose sum order may
    differ from a single product's), and against the one-vector solve
    (``torch.dot`` where the lanes take row sums), each lane stops at the
    same count within 1e-12.  Two lanes start smaller, one below the
    tolerance, so the lanes stop at different counts."""
    from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp

    A, b, c = _lp_batch(seed=2, B=1, m=10, n=14)
    A, b, c = (torch.from_numpy(v[0]) for v in (A, b, c))
    l = 25
    rng = np.random.default_rng(5)
    r0 = torch.from_numpy(rng.standard_normal((5, l)))
    r0[2] *= 1e-12   # a lane that starts converged
    r0[3] *= 1e-7    # and one that needs fewer iterations
    x0 = torch.from_numpy(rng.standard_normal(l))
    kw = dict(tol=1e-8, max_iters=1000, unroll=2)
    for op in (PaddedDenseOp.create(A), A):
        q = functools.partial(hsde_ops.q_mul, op, b, c)
        Qx0 = q(x0)
        lanes = conjugate_gradient_tracked(q, r0, x0, Qx0, **kw)
        assert len(set(lanes.iters.tolist())) > 2
        for j in range(5):
            one = conjugate_gradient_tracked(q, r0[j:j + 1], x0, Qx0, **kw)
            vec = conjugate_gradient_tracked(q, r0[j], x0, Qx0, **kw)
            assert int(one.iters[0]) == int(vec.iters) == int(lanes.iters[j])
            if op is not A:
                assert torch.equal(one.x[0], lanes.x[j])
                assert torch.equal(one.Qx[0], lanes.Qx[j])
            np.testing.assert_allclose(one.x[0].numpy(), lanes.x[j].numpy(),
                                       rtol=0, atol=1e-12)
            np.testing.assert_allclose(vec.x.numpy(), lanes.x[j].numpy(),
                                       rtol=0, atol=1e-12)


def test_batched_captured_route_and_refusals():
    """The batched fused solve on the captured route's buffers
    (``control.emulated``: the chunk loop's lane-status condition and CG's
    any-lane condition read on the host) gives the eager run's bits and
    history; algorithms whose steps branch per instance are refused."""
    _, tf = _forms()
    eager = T.solve_batched(T.DR(), tf, max_iters=300, eps=EPS,
                            record_history=True)
    with control.emulated():
        emu = T.solve_batched(T.DR(), tf, max_iters=300, eps=EPS,
                              record_history=True)
    assert torch.equal(emu.guess, eager.guess)
    assert torch.equal(emu.hist, eager.hist)
    assert torch.equal(emu.iters, eager.iters)
    for alg in (T.GAPP(), T.LineSearchWrapper(T.DR()),
                T.AndersonWrapper(T.DR()), T.LongstepWrapper(T.DR())):
        with pytest.raises(NotImplementedError):
            T.solve_batched(alg, tf, max_iters=10)
