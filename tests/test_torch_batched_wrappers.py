"""Wrapped and projected algorithms inside fos_tpu_torch's batched solve
against the JAX package's ``solve_batched`` (its ``vmap`` of the fused
solve), in the role of tests/test_wrappers.py's batched line search.

tests/test_torch_batched.py's certificate batch (B = 4 LPs of 8 x 12, f64,
numpy-seeded) goes through LineSearch(DR), Anderson(DR) (without and with
adaptive engagement), Longstep(DR) and GAPP in both packages on the CPU:
from a common start, from scratch, each lane against its single solve,
segments, the direct mode's probe cache, a stride-0 shared A, and the
gradients of a batched ``diff_solve``.

The port branches once per step for the whole batch, on the count its
running lanes share; the JAX package's ``vmap`` selects per instance.  The
two agree on every running lane, and a frozen lane's step is discarded
(module ``fos_tpu_torch.linalg.lanes``, ``common_count``).  The segment
cases hold that where a segment boundary falls between two extra steps.

As in tests/test_torch_batched.py, iterates are held at 1e-9 from a common
start that the JAX package reached (WARMUP DR iterations, where CG's
decreasing tolerance has reached its floor); from scratch, statuses and
counts are held equal and guesses at 1e-5.  Two measured limits set the
depths:

* Anderson amplifies rounding once it engages: from the common start, the
  adaptive wrapper engages on one lane after ~35 steps, and after 80 steps
  the JAX package's own iterate moves 2.6e-9 under a 1e-15 relative change
  of its start (the port is 1.3e-9 from it there), so STEPS is 60
  (3e-10).
* From scratch, the CG form's early projections stop at a loose tolerance
  (module docstring of tests/test_torch_batched.py) and Anderson then
  amplifies that: a 1e-15 relative change of A moves the JAX package's
  own Anderson guesses by 1e-3 and flips a lane's final status.  The
  from-scratch case runs on the direct form (no CG), where the JAX
  package's spread is 4e-8 and the port is 1e-9 from it; the CG form's
  from-scratch path (its probes included) is held by the segment cases.

JAX compiles dominate the file's time (1.2-3.5 s each on this CPU): the
common-start reference is the JAX package's vmapped step in a
``lax.fori_loop`` (the body of its batched fused solve, which costs about
half the compile), and every JAX result is computed once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fos_tpu
from fos_tpu.parallel.batched import (build_batched_form as jbuild,
                                      solve_batched as jsolve)

import fos_tpu_torch as T
from fos_tpu_torch import interop
from fos_tpu_torch.linalg import control
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.hsde import HSDEForm as TForm
from fos_tpu_torch.solvers import engine as tengine
from fos_tpu_torch.solvers.base import PlaneBuf

from test_torch_batched import B, M, N, _lp_batch

#: each algorithm, made from either package; intervals of 20 and 40 so
#: that a short run takes each wrapper's extra step several times
ALGS = {
    "linesearch": lambda m, d=False: m.LineSearchWrapper(
        m.DR(direct=d), lsinterval=20),
    "anderson": lambda m, d=False: m.AndersonWrapper(
        m.DR(direct=d), memory=5, adaptive=False),
    "anderson_adaptive": lambda m, d=False: m.AndersonWrapper(
        m.DR(direct=d), memory=5),
    "longstep": lambda m, d=False: m.LongstepWrapper(
        m.DR(direct=d), longinterval=40, nsave=4),
    "gapp": lambda m, d=False: m.GAPP(iproj=20),
}
WARMUP, STEPS = 400, 60
BUDGET, EPS = 400, 1e-4
SEGMENT = 130   # not a multiple of the line search's 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the solves are small and eager, and the suite
    runs several worker processes on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _forms(direct=False):
    A, b, c = _lp_batch()
    jf = jbuild(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                fos_tpu.cones.nonneg(M), fos_tpu.cones.nonneg(N),
                direct=direct)
    tf = T.build_batched_form(A, b, c, T.nonneg(M), T.nonneg(N),
                              direct=direct, device="cpu")
    return jf, tf


@functools.lru_cache(maxsize=None)
def _jax_warm():
    """The JAX package's batched DR state after WARMUP iterations."""
    jf, _ = _forms()
    return jsolve(fos_tpu.DR(), jf, max_iters=WARMUP, eps=0.0).state


def _starts(key):
    """The common start: the JAX DR state after WARMUP, with the
    algorithm's fresh aux made in each package (the JAX one by ``vmap``)."""
    jst, make = _jax_warm(), ALGS[key]
    jalg, talg = make(fos_tpu), make(T)
    tst = interop.solver_state_from_tree(jst._replace(aux=()), "cpu")
    return (jalg, jst._replace(aux=jax.vmap(jalg.init_aux)(jst.x)),
            talg, tst._replace(aux=talg.init_aux(tst.x)))


@functools.lru_cache(maxsize=None)
def _jax_steps(key):
    """STEPS vmapped JAX steps from the common start: (state, guess)."""
    jf, _ = _forms()
    jalg, jst, _, _ = _starts(key)

    @jax.jit
    def steps(sets, st):
        step = jax.vmap(jalg.step)
        st = jax.lax.fori_loop(0, STEPS, lambda _, s: step(sets, s), st)
        return st, jax.vmap(jalg.getsol)(sets, st)[0]

    return steps(jf.sets, jst)


@pytest.mark.parametrize("key", list(ALGS))
def test_from_a_common_start(key):
    """(a) STEPS iterations from the JAX package's batched DR state after
    WARMUP, the algorithm's aux fresh in both packages, through the port's
    batched ``fused_solve`` and the JAX package's vmapped steps: every
    lane's iterate and guess at 1e-9, and the S1 call counter (which the
    line search advances by its 31 probes per instance) equal."""
    _, tf = _forms()
    _, _, talg, tst = _starts(key)
    res = tengine.fused_solve(talg, tf, tst.x, max_iters=STEPS, eps=0.0,
                              resume_state=tst, budget_iters=WARMUP + STEPS)
    jst, jguess = _jax_steps(key)
    assert res.iters.tolist() == np.asarray(jst.i).tolist() == [
        WARMUP + STEPS] * B
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(jst.x),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.guess.numpy(), np.asarray(jguess),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(res.state.s1_state.call_idx.numpy(),
                                  np.asarray(jst.s1_state.call_idx))


def _result(r):
    return np.asarray(r.status), np.asarray(r.iters), np.asarray(r.guess)


@functools.lru_cache(maxsize=None)
def _scratch(key, direct, **run):
    """From scratch in both packages: (port result, JAX status, iters,
    guess)."""
    jf, tf = _forms(direct)
    run = dict(dict(max_iters=BUDGET, eps=EPS), **run)
    return (T.solve_batched(ALGS[key](T, direct), tf, **run),
            *_result(jsolve(ALGS[key](fos_tpu, direct), jf, **run)))


@pytest.mark.parametrize("key", list(ALGS))
def test_from_scratch(key):
    """(b) BUDGET iterations from tau = kappa = 1 on the direct form (the
    module docstring): statuses and iteration counts equal to the JAX
    package's, guesses at 1e-5."""
    res, js, ji, jg = _scratch(key, True)
    np.testing.assert_array_equal(res.status.numpy(), js)
    np.testing.assert_array_equal(res.iters.numpy(), ji)
    np.testing.assert_allclose(res.guess.numpy(), jg, rtol=0, atol=1e-5)


@pytest.mark.parametrize("key", list(ALGS))
def test_each_lane_matches_its_single_solve(key):
    """(c) Each lane continued STEPS iterations from the common start at
    eps 3e-5, checked every 20, where some lanes freeze before the end and
    some run on, equals the port's single wrapped ``fused_solve`` of that
    instance from the same state (status, count, guess at 1e-9): a frozen
    lane keeps what its single solve ends with while the others take the
    extra steps, and a running lane steps as it would alone.  One frozen
    and one running lane are solved alone."""
    A, b, c = _lp_batch()
    _, tf = _forms()
    _, _, talg, tst = _starts(key)
    run = dict(max_iters=STEPS, eps=3e-5, checki=20,
               budget_iters=WARMUP + STEPS)
    lanes = tengine.fused_solve(talg, tf, tst.x, resume_state=tst, **run)
    frozen = (lanes.iters < WARMUP + STEPS).tolist()
    for j in (frozen.index(True), frozen.index(False)):
        f1 = TForm.build(tconic(A[j], b[j], c[j], T.nonneg(M), T.nonneg(N),
                                device="cpu"))
        one = control.tree_map(lambda t: t[j], tst)
        r1 = tengine.fused_solve(talg, f1, one.x, resume_state=one, **run)
        assert (int(r1.status), int(r1.iters)) == (int(lanes.status[j]),
                                                   int(lanes.iters[j]))
        np.testing.assert_allclose(r1.guess.numpy(), lanes.guess[j].numpy(),
                                   rtol=0, atol=1e-9)


def test_segments_match_jax():
    """(d) The line search from scratch on the CG form, 200 iterations at
    eps 1e-3 checked every 50, in SEGMENT-iteration segments, a boundary
    between two line-search steps: an instance that finished in the first
    segment runs again in the second from its frozen state, at a lower
    count than the running ones, which pick the branch.  Statuses and
    counts equal the JAX package's segmented solve, where each instance
    branches on its own count; guesses at 1e-5."""
    res, js, ji, jg = _scratch("linesearch", False, max_iters=200, eps=1e-3,
                               checki=50, segment_iters=SEGMENT)
    np.testing.assert_array_equal(res.status.numpy(), js)
    np.testing.assert_array_equal(res.iters.numpy(), ji)
    assert bool((res.iters < SEGMENT).any() & (res.iters > SEGMENT).any())
    np.testing.assert_allclose(res.guess.numpy(), jg, rtol=0, atol=1e-5)


def test_direct_linesearch_matches_jax():
    """(e) LineSearch(DR(direct=True)) on the direct batched form, (b)'s
    solve: the probe cache on a (B, 2l, l) factor collapses each
    instance's 31 S1 probes to one projection; guesses at 1e-9, and some
    instances stop while others run to the budget."""
    res, js, ji, jg = _scratch("linesearch", True)
    np.testing.assert_array_equal(res.iters.numpy(), ji)
    assert bool((res.iters < BUDGET).any() & (res.status == 0).any())
    np.testing.assert_allclose(res.guess.numpy(), jg, rtol=0, atol=1e-9)


def test_shared_matrix_matches_materialised():
    """(f) Instances that share one A through a stride-0 batch axis (the
    probes' products: one matmul over all B x 31 rows) against the same A
    stacked B times: the line search's STEPS iterations from the common
    start (converged CG projections) within 1e-12."""
    A, b, c = _lp_batch()
    A0 = torch.from_numpy(A[0])
    shared = T.build_batched_form(A0.expand(B, M, N), b, c, T.nonneg(M),
                                  T.nonneg(N), device="cpu")
    stacked = T.build_batched_form(np.stack([A[0]] * B), b, c, T.nonneg(M),
                                   T.nonneg(N), device="cpu")
    assert shared.A.stride(0) == 0 and stacked.A.stride(0) != 0
    _, _, talg, tst = _starts("linesearch")
    r1, r2 = (tengine.fused_solve(talg, f, tst.x, max_iters=STEPS, eps=0.0,
                                  resume_state=tst)
              for f in (shared, stacked))
    for v1, v2 in ((r1.guess, r2.guess), (r1.state.x, r2.state.x)):
        np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("key", ["linesearch", "anderson"])
def test_batched_wrapped_gradients(key):
    """(g) A batched ``diff_solve`` whose forward runs the wrapper
    (tests/test_diff.py::test_wrapped_algorithm_grads over a batch of
    three 12 x 18 orthogonal-basis LPs, which DR solves to eps 1e-10): the
    backward differentiates the inner DR's frozen map, so each instance's
    g_c equals its x (5e-5, the envelope theorem) and plain batched DR's
    gradient (1e-6)."""
    from fos_tpu_torch.tools.lps import orthogonal_basis_lp

    rng = np.random.default_rng(0)
    draws = [orthogonal_basis_lp(rng, 12, 18, 6) for _ in range(3)]
    A, b, c = (torch.from_numpy(np.stack([d[i] for d in draws]))
               for i in range(3))
    inner = T.DR(direct=True)
    wrapped = {"linesearch": T.LineSearchWrapper(inner, lsinterval=20),
               "anderson": T.AndersonWrapper(inner, memory=5,
                                             adaptive=False)}[key]
    g, x = _grad(A, b, c, wrapped)
    g_plain, _ = _grad(A, b, c, inner)
    np.testing.assert_allclose(g, x, atol=5e-5)
    np.testing.assert_allclose(g, g_plain, atol=1e-6)


def _grad(A, b, c, alg):
    """g_c of sum_i c_i'x_i through a batched ``diff_solve`` under ``alg``,
    and x; every instance Optimal."""
    ct = c.clone().requires_grad_(True)
    stats = {}
    x, _, _ = T.diff_solve(A, b, ct, T.nonneg(12), T.nonneg(18), alg=alg,
                           eps=1e-10, max_iters=40000, device="cpu",
                           stats=stats)
    assert stats["status"].tolist() == [1] * 3
    (g,) = torch.autograd.grad((ct * x).sum(), ct)
    return g.numpy(), x.detach().numpy()


@pytest.mark.parametrize("key", ["anderson", "longstep"])
def test_wrapper_state_round_trips(key):
    """A JAX batched state of a wrapper, its aux nested (Anderson's inner
    aux and ring after it engaged; Longstep's ``PlaneBuf`` with captured
    rows), carried into the port by ``interop.solver_state_from_tree``:
    every leaf equal, dtypes kept, the named tuple the port's (the JAX
    package's ``PlaneBuf`` also carries ``nsave``, which the port's
    wrapper holds)."""
    jst = _jax_steps(key)[0]
    st = interop.solver_state_from_tree(jst, "cpu")
    if key == "longstep":
        jaux = jst.aux[1]
        assert isinstance(st.aux[1], PlaneBuf)
        assert float(st.aux[1].A.abs().sum()) > 0   # rows were captured
        jst = jst._replace(aux=(jst.aux[0], (jaux.A, jaux.b, jaux.slot)))
    else:
        assert bool(st.aux[6].all()) and int(st.aux[3].min()) >= 2
    jl = jax.tree_util.tree_leaves(jst)
    tl = control.tree_leaves(st)
    assert len(tl) == len(jl)
    for a, t in zip(jl, tl):
        assert t.dtype == torch.from_numpy(np.asarray(a)).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
