"""fos_tpu_torch's tile products over a lane axis (K2-K5 over lanes: their
plain PyTorch versions, which the operators run on CPU tensors) against
the JAX package's ``jax.vmap`` of the same products, one ``pallas_call``
with the lanes in its grid (interpret mode), on chip_smoke.py's tables at
512^2; and the line search on tile forms, whose 31 probes reach those
products through CG, against the JAX package's solves.

Tolerances: the products at rtol=2e-5, atol=2e-4 in f32 (the JAX sparse
tests' own: f32 sums taken in another order), each lane bit-equal to the
port's single call; the solves as stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fos_tpu
from fos_tpu.linalg import sparse_ell as jse
from fos_tpu.linalg.affine import AffinePlusLinearProjector as JAPL
from fos_tpu.problems.conic import conic_problem as jconic
from fos_tpu.problems.feasibility import (Feasibility as JFeas,
                                          FeasibilityForm as JFeasForm)
from fos_tpu.problems.hsde import HSDEForm as JForm
from fos_tpu.sets import BlockSet as JBlockSet, Box as JBox, NonNeg as JNonNeg
from fos_tpu.solvers import engine as jengine
from fos_tpu.solvers.base import init_solver_state as jinit

import chip_smoke
import fos_tpu_torch as T
from fos_tpu_torch import interop
from fos_tpu_torch.linalg import hsde_ops, lanes
from fos_tpu_torch.linalg import sparse_ell as tse
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.feasibility import (Feasibility as TFeas,
                                                FeasibilityForm as TFeasForm)
from fos_tpu_torch.problems.hsde import HSDEForm as TForm
from fos_tpu_torch.solvers import engine as tengine

RTOL, ATOL = 2e-5, 2e-4
NRB = 4   # 512 x 512 tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _tables(kind):
    """chip_smoke.py's banded or scattered tables at NRB block rows, and
    the certificate vectors of their LP.  The scattered table has one tile
    beside the diagonal one per block row: with three, at 4 block rows it
    fills every tile, and the JAX package's form build packs a full grid
    as banded (``band_span_ratio`` 1; with one it is 1.5)."""
    if kind == "band":
        return chip_smoke.banded_tables(nrb=NRB)
    return chip_smoke.scattered_tables(nrb=NRB, extra=1)


def _port_op(kind):
    blk, index, _ = _tables(kind)
    cls = tse.BandedBlockOp if kind == "band" else tse.BlockedEllOp
    k = NRB * 128
    return cls.from_arrays(blk, index, k, k, transpose_table=True,
                           device="cpu")


def _jax_op(top):
    """The JAX package's operator on the port operator's A and A' tables
    (interpret mode)."""
    a = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    m, n = top.shape
    if top.kind == "band":
        return jse.BandedBlockOp(a(top.blocks), a(top.cs), a(top.blocks_t),
                                 a(top.cs_t), m, n, interpret=True)
    return jse.BlockedEllOp(a(top.blocks), a(top.cols), a(top.blocks_t),
                            a(top.cols_t), m, n, interpret=True)


@pytest.mark.parametrize("lanes_n", [1, 2, 31])
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_lane_products_match_vmapped_pallas(kind, lanes_n):
    """``mv_pair``, ``mv`` and ``rmv`` on (L, k) lanes, the lanes rows of a
    larger state (q_mul's slices), against ``jax.vmap`` of the JAX
    operator's products (one vmapped ``pallas_call`` each), and each lane
    bit-equal to the port's single call on its vectors."""
    top = _port_op(kind)
    jop = _jax_op(top)
    M, N = top.shape
    rng = np.random.default_rng(lanes_n)
    state = rng.standard_normal((lanes_n, N + M + 1)).astype(np.float32)
    X, Z = torch.from_numpy(state)[:, :N], torch.from_numpy(state)[:, N:N + M]
    got = {"mv_pair": top.mv_pair(X, Z), "mv": (top.mv(X),),
           "rmv": (top.rmv(Z),)}
    jX, jZ = jnp.asarray(X.numpy()), jnp.asarray(Z.numpy())
    want = {"mv_pair": jax.vmap(jop.mv_pair)(jX, jZ),
            "mv": (jax.vmap(jop.mv)(jX),), "rmv": (jax.vmap(jop.rmv)(jZ),)}
    for key in got:
        for g, w in zip(got[key], want[key]):
            assert g.shape == (lanes_n, N)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=key)
    for b in range(lanes_n):
        for g, s in zip(got["mv_pair"], top.mv_pair(X[b], Z[b])):
            assert torch.equal(g[b], s)
        assert torch.equal(got["mv"][0][b], top.mv(X[b]))
        assert torch.equal(got["rmv"][0][b], top.rmv(Z[b]))


def _counting(op):
    """Count the calls of the operator's bound single and lane products."""
    calls = {}
    for attr in ("_pair", "_mv", "_rmv", "_pair_lanes", "_mv_lanes",
                 "_rmv_lanes"):
        fn = getattr(op, attr)
        calls[attr] = 0

        def counted(*a, fn=fn, attr=attr):
            calls[attr] += 1
            return fn(*a)
        setattr(op, attr, counted)
    return calls


@pytest.mark.parametrize("kind", ["band", "bell"])
def test_hsde_products_make_one_lane_call(kind):
    """``hsde_ops.mv_pair`` and ``kkt_normal_mul`` (through ``mv`` and
    ``rmv``) on 31 lanes make one lane call per product and no single
    call; an operator whose products take one vector (the row-sharded
    operator's case) gets single calls lane by lane, with the same bits."""
    op = _port_op(kind)
    M, N = op.shape
    rng = np.random.default_rng(7)
    X = torch.from_numpy(rng.standard_normal((31, N)).astype(np.float32))
    Z = torch.from_numpy(rng.standard_normal((31, M)).astype(np.float32))
    calls = _counting(op)
    y1, y2 = hsde_ops.mv_pair(op, X, Z)
    assert calls == {"_pair": 0, "_mv": 0, "_rmv": 0, "_pair_lanes": 1,
                     "_mv_lanes": 0, "_rmv_lanes": 0}
    k = hsde_ops.kkt_normal_mul(op, Z)
    assert calls == {"_pair": 0, "_mv": 0, "_rmv": 0, "_pair_lanes": 1,
                     "_mv_lanes": 1, "_rmv_lanes": 1}
    single = chip_smoke.SingleVectorOp(op)
    r1, r2 = hsde_ops.mv_pair(single, X, Z)
    rk = hsde_ops.kkt_normal_mul(single, Z)
    assert calls["_pair"] == calls["_mv"] == calls["_rmv"] == 31
    assert calls["_pair_lanes"] == calls["_mv_lanes"] == 1
    assert torch.equal(r1, y1) and torch.equal(r2, y2) and torch.equal(rk, k)
    assert torch.equal(torch.stack([op.mv_pair(u, v)[0]
                                    for u, v in zip(X, Z)]), y1)
    np.testing.assert_array_equal(
        lanes.lane_by_lane(op.mv_pair, X, Z)[1].numpy(), y2.numpy())


def _lp(kind):
    """The tables' LP with its certificate (chip_smoke.lp_from_operator) as
    an f32 scipy matrix: both packages pack it into their own tables of
    ``kind``'s layout (bit-identical builders)."""
    op = _port_op(kind)
    b, c, _ = chip_smoke.lp_from_operator(op, _tables(kind)[2], "cpu")
    return (sp.csr_matrix(op.todense().numpy()), b.numpy(), c.numpy())


#: a line-search step every LS_INTERVAL iterations, LS_ITERS iterations,
#: from a start whose S1 call counter is CALL0: there the decreasing-
#: accuracy CG tolerance 0.2^sqrt(i) is below the f32 floor 2 l eps
#: (i > 27 at 512^2), so every projection is converged (a projection at a
#: loose tolerance moves with its inputs' rounding by orders of magnitude
#: more, in either package: from the plain start the two packages' iterates
#: part by 4e-3 in 10 iterations)
LS_INTERVAL, LS_ITERS, CALL0 = 5, 10, 30


def _jax_lp_start(kind):
    A, b, c = _lp(kind)
    M, N = A.shape
    form = JForm.build(jconic(A, jnp.asarray(b), jnp.asarray(c),
                              fos_tpu.cones.nonneg(M),
                              fos_tpu.cones.nonneg(N)),
                       densify=False, sparse_format=kind)
    assert type(form.A).__name__ == ("BandedBlockOp" if kind == "band"
                                     else "BlockedEllOp")
    alg = fos_tpu.LineSearchWrapper(fos_tpu.DR(), lsinterval=LS_INTERVAL)
    st = jinit(alg, form.sets, form.initial_value(form.dtype))
    s1 = st.s1_state
    # CALL0 calls made, and the stall hooks' fields a fresh fused_solve sets
    st = st._replace(s1_state=s1._replace(
        call_idx=jnp.full_like(s1.call_idx, CALL0),
        floor=jnp.asarray(form.fused_cg_floors()[0], form.dtype),
        win_score=jnp.asarray(jnp.inf, form.dtype)))
    return form, alg, st


@functools.lru_cache(maxsize=None)
def _jax_linesearch(kind):
    form, alg, st = _jax_lp_start(kind)
    res = jengine.fused_solve(alg, form, st.x, max_iters=LS_ITERS, eps=0.0,
                              checki=LS_ITERS, resume_state=st)
    return (np.asarray(res.state.x), int(res.state.s1_state.call_idx),
            int(res.state.s1_state.total_iters))


@pytest.mark.parametrize("kind", ["band", "bell"])
def test_linesearch_dr_on_tile_lp_matches_jax(kind):
    """LineSearch(DR) with a line-search step every LS_INTERVAL iterations
    on the banded (K2) and scattered (K3) LP, LS_ITERS iterations in f32 in
    both packages from the JAX package's start with CALL0 calls made,
    carried to the port (the JAX package's tile form through
    ``sparse_format``, its 31 probes a vmapped ``pallas_call`` inside CG;
    the port's through its lane products): the iterate within 5e-5 (1 +
    max |x|) of the JAX package's (measured 6e-6 and 8e-6), the S1 call
    counter equal and the CG iterations within 3% (147 / 149 and 155 /
    158)."""
    A, b, c = _lp(kind)
    M, N = A.shape
    form = TForm.build(tconic(A, b, c, T.nonneg(M), T.nonneg(N),
                              device="cpu"),
                       densify=False, sparse_format=kind)
    assert type(form.A).__name__ == ("BandedBlockOp" if kind == "band"
                                     else "BlockedEllOp")
    _, _, jst = _jax_lp_start(kind)
    alg = T.LineSearchWrapper(T.DR(), lsinterval=LS_INTERVAL)
    st = interop.solver_state_from_tree(jst._replace(aux=()), "cpu")
    st = st._replace(aux=alg.init_aux(st.x))
    calls = _counting(form.A)
    res = tengine.fused_solve(alg, form, st.x, max_iters=LS_ITERS, eps=0.0,
                              checki=LS_ITERS, resume_state=st)
    jx, jcalls, jcg = _jax_linesearch(kind)
    x = res.state.x.numpy()
    assert float(np.abs(x - jx).max()) <= 5e-5 * (1.0 + float(
        np.abs(jx).max()))
    assert int(res.state.s1_state.call_idx) == jcalls
    cg = int(res.state.s1_state.total_iters)
    assert abs(cg - jcg) <= 0.03 * jcg
    assert calls["_pair_lanes"] > 0 and calls["_mv_lanes"] == 0


def _feasibility(mod, op):
    """``Ax + s = b, x in [0, 1]^n, s >= 0`` (chip_smoke.py's feasibility
    problem) on the tile operator ``op`` of ``mod`` (the JAX package or
    the port), b from the f64 host product of the tables."""
    blk, cs, _ = _tables("band")
    M, N = op.shape
    x0, s0 = chip_smoke.feasibility_vectors(M, N)
    bvec = (chip_smoke.host_tile_mv(blk, cs[:, None] + np.arange(3), x0)
            + s0).astype(np.float32)
    if mod is T:
        S1 = T.AffinePlusLinearProjector.create(op, bvec, 0.0, -1,
                                                device="cpu")
        S2 = T.BlockSet([(T.Box(0.0, 1.0), N), (T.NonNeg(), M)])
        return TFeas(S1, S2, N + M)
    S1 = JAPL.create(op, jnp.asarray(bvec), jnp.zeros(N, jnp.float32), -1)
    S2 = JBlockSet([(JBox(0.0, 1.0), N), (JNonNeg(), M)])
    return JFeas(S1, S2, N + M)


FEAS_ITERS = 20


@functools.lru_cache(maxsize=None)
def _jax_feasibility():
    form = JFeasForm.build(_feasibility(fos_tpu, _jax_op(_port_op("band"))),
                           dtype=jnp.float32)
    alg = fos_tpu.LineSearchWrapper(fos_tpu.AP(), lsinterval=LS_INTERVAL)
    res = jengine.fused_solve(alg, form, form.initial_value(form.dtype),
                              max_iters=FEAS_ITERS, eps=0.0,
                              checki=FEAS_ITERS)
    return np.asarray(res.state.x), int(res.state.s1_state.total_iters)


def test_linesearch_ap_on_tile_feasibility_matches_jax():
    """LineSearch(AP) on the banded feasibility problem through the tile
    operator (the probes' CG on I + AA' through K4's lane products; the
    JAX package's through a vmapped ``pallas_call``), FEAS_ITERS
    iterations in f32 from the initial point (the projection's CG runs to
    its fixed floor from the first call): the iterate within 1e-4 (1 + max
    |x|) of the JAX package's (measured 1.8e-5), the CG iterations within
    2% (equal when measured)."""
    op = _port_op("band")
    form = TFeasForm.build(_feasibility(T, op), device="cpu")
    calls = _counting(op)
    alg = T.LineSearchWrapper(T.AP(), lsinterval=LS_INTERVAL)
    res = tengine.fused_solve(alg, form, form.initial_value(form.dtype),
                              max_iters=FEAS_ITERS, eps=0.0,
                              checki=FEAS_ITERS)
    jx, jcg = _jax_feasibility()
    x = res.state.x.numpy()
    assert float(np.abs(x - jx).max()) <= 1e-4 * (1.0 + float(
        np.abs(jx).max()))
    cg = int(res.state.s1_state.total_iters)
    assert abs(cg - jcg) <= 0.02 * jcg
    assert calls["_mv_lanes"] > 0 and calls["_rmv_lanes"] > 0
    assert calls["_pair"] == calls["_pair_lanes"] == 0
