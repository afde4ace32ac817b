"""fos_tpu_torch.diff (the port of fos_tpu.diff) on the CPU in f64.

Each of tests/test_diff.py's 13 cases is mirrored on the port with the same
oracles (LP duality and the envelope theorem at a nondegenerate optimum,
central finite differences) and tolerances, on the same numpy instances.
Parity with the JAX package on the same numpy inputs: the gradients of one
seeded LP (1e-6), the eigh projection's JVP and VJP at tied eigenvalues
(1e-10), an exp and a pow projection's VJP, and the implicit CG solve's VJP
and JVP against ``jax.scipy.sparse.linalg.cg``'s.  K1's autograd Function
on CPU tensors (its plain route) against autograd of the plain pair.

Depth, so that the file runs in about two minutes in one process: the
forward solves run ``DR(direct=True)`` (the host QR factor in place of CG:
the same fixed point and the same derivative map, at ~0.12 ms an iteration
against ~3 ms for CG's eager loop on this size), except the SOCP and SDP
cases, which run the CG forward; solves that several cases read are
module-scoped fixtures (the LP of the envelope case also serves the FD,
jvp, sparse, wrapped and parity cases, as in test_diff.py every case draws
it first from ``default_rng(0)``); the JAX package runs one gradient solve.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

import fos_tpu_torch as T
from fos_tpu_torch.cones import Cone, ConeSpec
from fos_tpu_torch.cones.project import psd_project_eigh, svec
from fos_tpu_torch.diff import NormalSolve, _Data
from fos_tpu_torch.linalg.dense_pair import (DensePairFn, PaddedDenseOp,
                                             fused_matvec, fused_matvec_plain)
from fos_tpu_torch.tools.lps import nondegenerate_lp

F64 = torch.float64
EPS, ITERS = 1e-10, 40000


def _lp(rng, m=12, n=18, k=6):
    """tests/test_diff.py's LP with a unique nondegenerate primal-dual
    vertex pair (kx = ky = k), as numpy arrays (A, b, c, x0, y0)."""
    return nondegenerate_lp(rng, m, n, k)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its solves are small and eager,
    and the suite runs several worker processes on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=grad)


def _np(t):
    return t.detach().numpy()


def _dsolve(A, b, c, K1, K2, alg=None, **kw):
    kw.setdefault("eps", EPS)
    kw.setdefault("max_iters", ITERS)
    return T.diff_solve(A, b, c, K1, K2,
                        alg=T.DR(direct=True) if alg is None else alg,
                        device="cpu", **kw)


@pytest.fixture(scope="module")
def lp0():
    """The first draw of default_rng(0) and the FD direction drawn after
    it (test_diff.py's FD and jvp cases draw it so)."""
    rng = np.random.default_rng(0)
    A, b, c, x0, y0 = _lp(rng)
    v = rng.standard_normal(A.shape[0])
    return A, b, c, v


@pytest.fixture(scope="module")
def rev(lp0):
    """One reverse-mode solve of lp0; cases take their gradients from its
    graph (retain_graph)."""
    A, b, c, _ = lp0
    m, n = A.shape
    At, bt, ct = _t(A, True), _t(b, True), _t(c, True)
    x, y, s = _dsolve(At, bt, ct, T.nonneg(m), T.nonneg(n))
    grads = torch.autograd.grad(torch.dot(ct, x), (At, bt, ct),
                                retain_graph=True)
    return dict(A=At, b=bt, c=ct, x=x, y=y, s=s,
                grads=tuple(_np(g) for g in grads))


@pytest.fixture(scope="module")
def fd_b(lp0):
    """x*(b +- eps v) (forward solves only), eps = 1e-5."""
    A, b, c, v = lp0
    m, n = A.shape
    with torch.no_grad():
        return {sgn: _np(_dsolve(_t(A), _t(b + sgn * 1e-5 * v), _t(c),
                                 T.nonneg(m), T.nonneg(n))[0])
                for sgn in (1.0, -1.0)}


def _envelope(g, x, y, atol=5e-5):
    gA, gb, gc = g
    np.testing.assert_allclose(gc, x, atol=atol)
    np.testing.assert_allclose(gb, -y, atol=atol)
    np.testing.assert_allclose(gA, np.outer(y, x), atol=atol)


# ------------------------------------------------- test_diff.py, mirrored
def test_envelope_theorem_grads(rev):
    # d(c'x*)/dc = x*, d(c'x*)/db = -y*, d(c'x*)/dA = y* x*'
    _envelope(rev["grads"], _np(rev["x"]), _np(rev["y"]))


def test_finite_difference_check(rev, fd_b, lp0):
    v = lp0[3]
    (g,) = torch.autograd.grad((rev["x"] ** 2).sum(), rev["b"],
                               retain_graph=True)
    fd = (float((fd_b[1.0] ** 2).sum()) - float((fd_b[-1.0] ** 2).sum())) \
        / (2 * 1e-5)
    an = float(np.dot(_np(g), v))
    assert abs(fd - an) < 1e-3 * (1 + abs(fd))


def test_diff_solve_solution_matches_solve():
    A, b, c, _, _ = _lp(np.random.default_rng(0), m=10, n=15)
    m, n = A.shape
    x, y, s = _dsolve(_t(A), _t(b), _t(c), T.nonneg(m), T.nonneg(n), eps=1e-9)
    sol = T.solve(A, b, c, T.nonneg(m), T.nonneg(n), alg=T.DR(direct=True),
                  eps=1e-9, verbose=0, max_iters=ITERS, device="cpu")
    np.testing.assert_allclose(_np(x), _np(sol.x), atol=1e-6)
    np.testing.assert_allclose(_np(y), _np(sol.y), atol=1e-6)


def test_gapa_envelope_grads(lp0):
    # the frozen converged-coefficient map gives DR's envelope identities
    A, b, c, _ = lp0
    m, n = A.shape
    At, bt, ct = _t(A, True), _t(b, True), _t(c, True)
    x, y, s = _dsolve(At, bt, ct, T.nonneg(m), T.nonneg(n),
                      alg=T.GAPA(0.8, direct=True))
    g = torch.autograd.grad(torch.dot(ct, x), (At, bt, ct))
    _envelope(tuple(_np(t) for t in g), _np(x), _np(y))


def test_forward_mode_jvp(rev, fd_b, lp0):
    # mode="jvp": d/dt x*(b + t v) matches central FD, and <grad, v> of
    # sum(x^2) from reverse mode
    A, b, c, v = lp0
    m, n = A.shape
    with fwAD.dual_level():
        bd = fwAD.make_dual(_t(b), _t(v))
        x, _, _ = _dsolve(_t(A), bd, _t(c), T.nonneg(m), T.nonneg(n),
                          mode="jvp")
        xp, dx = (_np(t) for t in fwAD.unpack_dual(x))
    fd = (fd_b[1.0] - fd_b[-1.0]) / (2 * 1e-5)
    np.testing.assert_allclose(dx, fd, atol=1e-3)
    dl = float(2.0 * np.dot(xp, dx))
    (g,) = torch.autograd.grad((rev["x"] ** 2).sum(), rev["b"],
                               retain_graph=True)
    assert abs(dl - float(np.dot(_np(g), v))) < 1e-5 * (1 + abs(dl))


def test_diff_mode_validation():
    A, b, c, _, _ = _lp(np.random.default_rng(0), m=8, n=12)
    m, n = A.shape
    with pytest.raises(ValueError, match="mode"):
        T.diff_solve(A, b, c, T.nonneg(m), T.nonneg(n), mode="fwd",
                     device="cpu")
    with pytest.raises(ValueError, match="GAPA"):
        T.diff_solve(A, b, c, T.nonneg(m), T.nonneg(n), alg=T.FISTA(),
                     device="cpu")
    with pytest.raises(TypeError, match="adjoint_tl"):
        T.diff_solve(A, b, c, T.nonneg(m), T.nonneg(n), adjoint_tl=1e-9,
                     device="cpu")


def test_adjoint_damping_regression():
    # the 4th draw of the construction with seed 0: undamped CGLS drifts
    # into the ray's null space there (JAX: ||w|| ~ 1e13); the default
    # 1e-10 Tikhonov damping gives the exact envelope gradient
    rng = np.random.default_rng(0)
    m, n, k = 12, 18, 6
    for _ in range(4):
        A = rng.standard_normal((m, n))
        xm = np.zeros(n, bool)
        xm[rng.choice(n, k, replace=False)] = True
        ym = np.zeros(m, bool)
        ym[rng.choice(m, k, replace=False)] = True
        x0 = (np.abs(rng.standard_normal(n)) + 0.1) * xm
        r0 = (np.abs(rng.standard_normal(n)) + 0.1) * (~xm)
        y0 = (np.abs(rng.standard_normal(m)) + 0.1) * ym
        s0 = (np.abs(rng.standard_normal(m)) + 0.1) * (~ym)
        b = A @ x0 + s0
        c = r0 - A.T @ y0
    ct = _t(c, True)
    x, _, _ = _dsolve(_t(A), _t(b), ct, T.nonneg(m), T.nonneg(n))
    (g,) = torch.autograd.grad(torch.dot(ct, x), ct)
    np.testing.assert_allclose(_np(g), _np(x), atol=5e-5)


def test_vmap_batched_grads():
    # a leading batch axis: per-instance envelope gradients
    rng = np.random.default_rng(0)
    draws = [_lp(rng) for _ in range(3)]
    A, b, c = (np.stack([d[i] for d in draws]) for i in range(3))
    m, n = A.shape[1:]
    ct = _t(c, True)
    stats = {}
    x, _, _ = _dsolve(_t(A), _t(b), ct, T.nonneg(m), T.nonneg(n),
                      stats=stats)
    assert tuple(x.shape) == (3, n)
    assert tuple(stats["status"].shape) == (3,)
    (g,) = torch.autograd.grad((ct * x).sum(), ct)
    np.testing.assert_allclose(_np(g), _np(x), atol=5e-5)
    assert stats["cgls_iters"].dim() == 0   # the slowest lane's


def test_socp_gradient_fd():
    # min c'x s.t. ||x - a|| <= r: x* = a - r c/||c||, d(c'x*)/da = c.
    # The CG forward (plain DR).
    rng = np.random.default_rng(0)
    n = 6
    a = _t(np.abs(rng.standard_normal(n)) + 0.5, True)
    c = _t(rng.standard_normal(n))
    A = torch.cat([torch.zeros(1, n, dtype=F64), torch.eye(n, dtype=F64)])
    K1 = ConeSpec(((Cone.SOC, n + 1),))
    K2 = ConeSpec(((Cone.FREE, n),))
    b = torch.cat([torch.ones(1, dtype=F64), a])
    x, _, _ = _dsolve(A, b, c, K1, K2, alg=T.DR())
    (g,) = torch.autograd.grad(torch.dot(c, x), a)
    np.testing.assert_allclose(_np(g), _np(c), atol=1e-6)


def test_sdp_gradient_lambda_min():
    # min <C,X> s.t. tr X = 1, X PSD: value lambda_min(C), gradient v v',
    # with a repeated non-minimal eigenvalue (eigh's own derivative divides
    # by zero there; the divided differences do not).  The CG forward.
    rng = np.random.default_rng(0)
    d = 3
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    C = Q @ np.diag([1.0, 2.0, 2.0]) @ Q.T
    v = Q[:, 0]
    A = svec(torch.eye(d, dtype=F64))[None, :]
    c0 = svec(_t(C)).detach().requires_grad_()
    x, _, _ = _dsolve(A, torch.ones(1, dtype=F64), c0, T.zero(1),
                      ConeSpec(((Cone.PSD, 6),)), alg=T.DR(),
                      max_iters=60000)
    val = torch.dot(c0, x)
    assert abs(float(val) - 1.0) < 1e-6
    (g,) = torch.autograd.grad(val, c0)
    assert np.isfinite(_np(g)).all()
    np.testing.assert_allclose(_np(g), _np(svec(_t(np.outer(v, v)))),
                               atol=5e-5)


def test_sparse_grads_match_dense(rev, lp0):
    # a torch sparse COO A (every entry stored): gradients on its stored
    # values are the dense gradient at the pattern; envelope on the sparse
    # path
    A, b, c, _ = lp0
    m, n = A.shape
    rows, cols = np.nonzero(np.ones_like(A))
    vals = _t(A[rows, cols], True)
    Asp = torch.sparse_coo_tensor(torch.as_tensor(np.stack([rows, cols])),
                                  vals, (m, n))
    bt, ct = _t(b, True), _t(c, True)
    x, y, s = _dsolve(Asp, bt, ct, T.nonneg(m), T.nonneg(n))
    gd, gbs, gcs = (_np(g) for g in torch.autograd.grad(
        torch.dot(ct, x), (vals, bt, ct)))
    gA, gb, gc = rev["grads"]
    np.testing.assert_allclose(gbs, gb, atol=1e-6)
    np.testing.assert_allclose(gcs, gc, atol=1e-6)
    np.testing.assert_allclose(gd, gA[rows, cols], atol=1e-6)
    np.testing.assert_allclose(gcs, _np(x), atol=5e-5)
    np.testing.assert_allclose(gbs, -_np(y), atol=5e-5)


@pytest.mark.parametrize("wrapper", ["linesearch", "anderson"])
def test_wrapped_algorithm_grads(rev, lp0, wrapper):
    # a wrapped solve reaches the same fixed point: the frozen inner map
    # gives plain DR's gradients
    A, b, c, _ = lp0
    m, n = A.shape
    wrap = (T.LineSearchWrapper if wrapper == "linesearch"
            else T.AndersonWrapper)
    bt, ct = _t(b, True), _t(c)
    x, _, _ = _dsolve(_t(A), bt, ct, T.nonneg(m), T.nonneg(n),
                      alg=wrap(alg=T.DR(direct=True)))
    (g,) = torch.autograd.grad(torch.dot(ct, x), bt)
    np.testing.assert_allclose(_np(g), rev["grads"][1], atol=1e-6)


def test_diff_unsupported_algorithm_is_loud(lp0):
    A, b, c, _ = lp0
    m, n = A.shape
    with pytest.raises(ValueError, match="Dykstra"):
        T.diff_solve(A, b, c, T.nonneg(m), T.nonneg(n), alg=T.Dykstra(),
                     device="cpu")


# --------------------------------------------- parity with the JAX package
def test_gradients_match_jax(rev, lp0):
    """(g_A, g_b, g_c) of d(c'x*) on lp0 from fos_tpu.diff.diff_solve (its
    CG forward) and the port's, within 1e-6."""
    from fos_tpu.cones import nonneg
    from fos_tpu.diff import diff_solve
    from fos_tpu.solvers.base import DR

    A, b, c, _ = lp0
    m, n = A.shape

    def objval(A_, b_, c_):
        x, _, _ = diff_solve(A_, b_, c_, nonneg(m), nonneg(n), alg=DR(),
                             eps=EPS, max_iters=ITERS)
        return jnp.vdot(c_, x)

    want = jax.grad(objval, argnums=(0, 1, 2))(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    for got, w in zip(rev["grads"], want):
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-6)


def _tied(seed=5, d=5):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    X = Q @ np.diag([-1.5, -1.5, 0.7, 2.0, 2.0]) @ Q.T
    E = rng.standard_normal((d, d))
    return X, E + E.T


def test_psd_eigh_derivative_matches_jax():
    """The divided-difference JVP and VJP at tied eigenvalues (a double
    -1.5 and a double 2, where eigh's own derivative divides by zero)
    against fos_tpu's custom_jvp, within 1e-10."""
    from fos_tpu.cones.project import psd_project_eigh as jax_eigh

    X, E = _tied()
    _, jvp_want = jax.jvp(jax_eigh, (jnp.asarray(X),), (jnp.asarray(E),))
    _, vjp_fn = jax.vjp(jax_eigh, jnp.asarray(X))
    (vjp_want,) = vjp_fn(jnp.asarray(E))
    with fwAD.dual_level():
        y = psd_project_eigh(fwAD.make_dual(_t(X), _t(E)))
        jvp_got = _np(fwAD.unpack_dual(y).tangent)
    Xt = _t(X, True)
    (vjp_got,) = torch.autograd.grad(psd_project_eigh(Xt), Xt, _t(E))
    np.testing.assert_allclose(jvp_got, np.asarray(jvp_want), atol=1e-10)
    np.testing.assert_allclose(_np(vjp_got), np.asarray(vjp_want),
                               atol=1e-10)
    # the forward keeps its bits off the autograd route
    assert torch.equal(psd_project_eigh(Xt).detach(),
                       psd_project_eigh(_t(X)))


def test_exp_pow_projection_vjp_matches_jax():
    """One hard-case exp block and one pow block (alpha 0.3): the VJP of the
    port's projection (plain autograd through the fixed-step root finder)
    against jax.vjp of fos_tpu's, within 1e-8."""
    from fos_tpu.cones.exp import project_exp_single
    from fos_tpu.cones.pow import project_pow_single
    from fos_tpu_torch.cones.exp import project_exp
    from fos_tpu_torch.cones.pow import project_pow

    v_exp = np.array([0.7, -0.4, 0.3])
    v_pow = np.array([-0.3, 0.8, 1.1])
    g = np.array([0.3, -1.2, 0.8])
    _, fn = jax.vjp(project_exp_single, jnp.asarray(v_exp))
    want_exp = np.asarray(fn(jnp.asarray(g))[0])
    _, fn = jax.vjp(lambda u: project_pow_single(u, 0.3), jnp.asarray(v_pow))
    want_pow = np.asarray(fn(jnp.asarray(g))[0])
    ve, vp = _t(v_exp[None], True), _t(v_pow[None], True)
    pe = project_exp(ve)
    pp = project_pow(vp, torch.tensor([0.3], dtype=F64))
    # both points are hard cases: the projection moves them
    assert float((pe - ve).abs().max()) > 1e-3
    assert float((pp - vp).abs().max()) > 1e-3
    (got_exp,) = torch.autograd.grad(pe, ve, _t(g[None]))
    (got_pow,) = torch.autograd.grad(pp, vp, _t(g[None]))
    np.testing.assert_allclose(_np(got_exp)[0], want_exp, atol=1e-8)
    np.testing.assert_allclose(_np(got_pow)[0], want_pow, atol=1e-8)


def test_implicit_cg_matches_jax_cg():
    """NormalSolve's VJP (in r, A, b, c) and JVP against jax.scipy's cg on
    the same SPD map (I + Q'Q), tol 1e-10 relative, within 1e-8."""
    from fos_tpu.linalg import hsde_ops as jax_ops

    rng = np.random.default_rng(11)
    m, n = 5, 7
    l = m + n + 1
    A, b, c = (rng.standard_normal(s) for s in ((m, n), (m,), (n,)))
    r, g = rng.standard_normal(l), rng.standard_normal(l)
    dA, db, dc, dr = (rng.standard_normal(s)
                      for s in ((m, n), (m,), (n,), (l,)))

    def solve(r_, A_, b_, c_):
        return jax.scipy.sparse.linalg.cg(
            lambda t: jax_ops.hsde_normal_mul(A_, b_, c_, t), r_, tol=1e-10,
            maxiter=500)[0]

    prim = tuple(jnp.asarray(v) for v in (r, A, b, c))
    u_want, fn = jax.vjp(solve, *prim)
    vjp_want = fn(jnp.asarray(g))
    _, jvp_want = jax.jvp(solve, prim,
                          tuple(jnp.asarray(v) for v in (dr, dA, db, dc)))
    data = _Data(m, n)
    ins = [_t(v, True) for v in (r, A, b, c)]
    u = NormalSolve.apply(ins[0], None, data, *ins[1:])
    np.testing.assert_allclose(_np(u), np.asarray(u_want), atol=1e-8)
    got = torch.autograd.grad(u, ins, _t(g))
    for a, w in zip(got, vjp_want):
        np.testing.assert_allclose(_np(a), np.asarray(w), atol=1e-8)
    with fwAD.dual_level():
        duals = [fwAD.make_dual(_t(p), _t(t))
                 for p, t in zip((r, A, b, c), (dr, dA, db, dc))]
        du = fwAD.unpack_dual(
            NormalSolve.apply(duals[0], None, data, *duals[1:])).tangent
    np.testing.assert_allclose(_np(du), np.asarray(jvp_want), atol=1e-8)


# ---------------------------------------- K1's Function on the plain route
@pytest.mark.parametrize("need_A", [False, True])
def test_dense_pair_function_backward(need_A):
    rng = np.random.default_rng(3)
    M, N = 7, 9
    A = _t(rng.standard_normal((M, N)), need_A)
    x1, x2 = _t(rng.standard_normal(N), True), _t(rng.standard_normal(M), True)
    gy, gz = _t(rng.standard_normal(M)), _t(rng.standard_normal(N))
    op = PaddedDenseOp.create(A)
    y, z = op.mv_pair(x1, x2)
    assert type(y.grad_fn).__name__ == "DensePairFnBackward"
    ins = (A, x1, x2) if need_A else (x1, x2)
    got = torch.autograd.grad((y, z), ins, (gy, gz))
    want = torch.autograd.grad(fused_matvec_plain(A, x1, x2), ins, (gy, gz))
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(w), rtol=1e-13, atol=1e-13)
    # the free function takes the same route
    y2, z2 = fused_matvec(A, x1, x2)
    assert type(y2.grad_fn).__name__ == "DensePairFnBackward"


@pytest.mark.parametrize("with_dA", [False, True])
def test_dense_pair_function_jvp(with_dA):
    rng = np.random.default_rng(4)
    M, N = 7, 9
    A, dA = (_t(rng.standard_normal((M, N))) for _ in range(2))
    x1, dx1 = (_t(rng.standard_normal(N)) for _ in range(2))
    x2, dx2 = (_t(rng.standard_normal(M)) for _ in range(2))
    with fwAD.dual_level():
        Ad = fwAD.make_dual(A, dA) if with_dA else A
        y, z = PaddedDenseOp(Ad).mv_pair(fwAD.make_dual(x1, dx1),
                                         fwAD.make_dual(x2, dx2))
        got = (fwAD.unpack_dual(y).tangent, fwAD.unpack_dual(z).tangent)
    want = fused_matvec_plain(A, dx1, dx2)
    if with_dA:
        want = tuple(w + e for w, e in zip(want,
                                           fused_matvec_plain(dA, x1, x2)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(w), rtol=1e-13, atol=1e-13)


def test_dense_pair_function_double_backward():
    """The backward is K1 again, so it differentiates once more (the
    transpose-of-VJP route of diff.py's J w)."""
    rng = np.random.default_rng(5)
    M, N = 6, 4
    A = _t(rng.standard_normal((M, N)))
    x1, x2 = _t(rng.standard_normal(N), True), _t(rng.standard_normal(M), True)
    gy = torch.zeros(M, dtype=F64, requires_grad=True)
    gz = torch.zeros(N, dtype=F64, requires_grad=True)
    y, z = DensePairFn.apply(A, x1, x2, None)
    g1, g2 = torch.autograd.grad((y, z), (x1, x2), (gy, gz),
                                 create_graph=True)
    w1, w2 = _t(rng.standard_normal(N)), _t(rng.standard_normal(M))
    jy, jz = torch.autograd.grad((g1, g2), (gy, gz), (w1, w2))
    np.testing.assert_allclose(_np(jy), _np(A @ w1), atol=1e-13)
    np.testing.assert_allclose(_np(jz), _np(A.T @ w2), atol=1e-13)


def test_pallas_route_grads_match_plain(rev, lp0):
    """diff_solve with pallas=True (every pair through K1's Function, its
    plain route on the CPU) gives the plain products' gradients."""
    A, b, c, _ = lp0
    m, n = A.shape
    At, bt, ct = _t(A, True), _t(b, True), _t(c, True)
    x, _, _ = _dsolve(At, bt, ct, T.nonneg(m), T.nonneg(n), pallas=True)
    g = torch.autograd.grad(torch.dot(ct, x), (At, bt, ct))
    for got, want in zip(g, rev["grads"]):
        np.testing.assert_allclose(_np(got), want, atol=1e-9)


def test_diff_solve_needs_a_device_without_a_card(lp0):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    A, b, c, _ = lp0
    m, n = A.shape
    with pytest.raises(RuntimeError, match="CUDA"):
        T.diff_solve(A, b, c, T.nonneg(m), T.nonneg(n))


def test_f32_envelope_with_f32_options(lp0):
    """f32 through K1's Function (its plain route here) with the f32
    options the module recommends (chip_smoke.py's DIFF_F32): the envelope
    identities within 1e-3 scaled, as phase 8 gates them on the card."""
    A, b, c, _ = lp0
    _, _, _, x0, y0 = _lp(np.random.default_rng(0))
    m, n = A.shape
    At, bt, ct = (torch.tensor(v, dtype=torch.float32, requires_grad=True)
                  for v in (A, b, c))
    x, y, s = T.diff_solve(At, bt, ct, T.nonneg(m), T.nonneg(n),
                           alg=T.DR(direct=True), device="cpu", pallas=True,
                           eps=1e-6, max_iters=ITERS, diff_cg_tol=1e-6,
                           adjoint_tol=1e-6, adjoint_iters=300,
                           adjoint_damping=1e-8)
    assert x.dtype == torch.float32
    g = torch.autograd.grad(torch.dot(ct, x), (At, bt, ct))
    scale = 1.0 + np.abs(x0).max() + np.abs(y0).max()
    _envelope(tuple(_np(t).astype(np.float64) for t in g), x0, y0,
              atol=1e-3 * scale)
