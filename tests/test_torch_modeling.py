"""fos_tpu_torch's modeling DSL against the JAX package's, on the CPU.

Every problem of ``tests/test_native_modeling.py`` (every atom and
constraint kind) is built in both DSLs from the same numpy draws, and
``Problem.compile`` must give bit-identical SCS data: the CSR arrays of A
(or the dense A), b, c, the cone dict, the constant, the variable layout
and the row map.  So must the affine algebra's random expression trees (the
property fuzz of ``test_affine_lowering_fuzz``) and a lowering with
``_DENSIFY_CELLS`` forced to 0.  Then the DSL solves: both packages run
``DR(direct=True)`` in f64 at eps 1e-9 and the values, objectives and
constraint duals agree within 1e-6 (1 + |.|), the port's checked against
the closed form or scipy oracle as the JAX tests do.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog, nnls

import fos_tpu.modeling as JM
import fos_tpu_torch.modeling as TM
from fos_tpu import DR as JDR
from fos_tpu_torch import DR as TDR

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its solves are small and eager,
    and the suite runs several worker processes on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------- problems
# Each recipe takes a modeling module M and a seeded rng and returns
# (problem, handles); the same rng draws give the same data in both
# packages.
def nnls_problem(M, rng):
    m, n = 40, 50
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    x = M.Variable(n)
    return M.Problem(M.minimize(M.sum_squares(A @ x - b)), [x >= 0]), \
        dict(x=x, A=A, b=b)


def lp_problem(M, rng):
    m, n = 12, 8
    A = rng.standard_normal((m, n))
    x0 = np.abs(rng.standard_normal(n))
    b = A @ x0 + np.abs(rng.standard_normal(m))
    c = np.abs(rng.standard_normal(n)) + 0.1
    x = M.Variable(n)
    ub, pos = A @ x <= b, x >= 0
    return M.Problem(M.minimize(c @ np.eye(n) @ x), [ub, pos]), \
        dict(x=x, A=A, b=b, c=c, ub=ub, pos=pos)


def lambda_min_problem(M, rng):
    d = 4
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    C = Q @ np.diag([0.3, 1.0, 2.0, 2.0]) @ Q.T
    X = M.Variable((d, d), symmetric=True)
    tr, cone = M.trace(X) == 1, X >> 0
    return M.Problem(M.minimize(M.trace(C @ X)), [tr, cone]), \
        dict(X=X, Q=Q, tr=tr, cone=cone)


def exp_problem(M, rng):
    x, y, z = M.Variable(), M.Variable(), M.Variable()
    cons = [M.ExpCone(x, y, z), x == 1, y == 1]
    return M.Problem(M.minimize(1.0 * z), cons), dict(z=z, cons=cons)


def pow_problem(M, rng):
    x, y, z = M.Variable(), M.Variable(), M.Variable()
    cons = [M.PowCone(x, y, z, 0.5), x == 2, y == 8]
    return M.Problem(M.maximize(1.0 * z), cons), dict(z=z, cons=cons)


def norm2_constraint_problem(M, rng):
    n = 6
    a = rng.standard_normal(n)
    c = rng.standard_normal(n)
    x = M.Variable(n)
    return M.Problem(M.minimize(c @ np.eye(n) @ x),
                     [M.norm2(x - a) <= 1.0]), dict(x=x)


def norm2_objective_problem(M, rng):
    a = rng.standard_normal(7)
    x = M.Variable(7)
    return M.Problem(M.minimize(M.norm2(x - a)), [x >= 0]), dict(x=x)


def weighted_atoms_problem(M, rng):
    n, lam = 5, 0.7
    a = rng.standard_normal(n) + 0.5
    x = M.Variable(n)
    return M.Problem(M.minimize(M.sum_squares(x - a)
                                + lam * (np.ones((1, n)) @ x)[0]),
                     [x >= 0]), dict(x=x)


def matrix_algebra_problem(M, rng):
    d = 3
    B = rng.standard_normal((d, d))
    X = M.Variable((d, d))
    x0 = rng.standard_normal((d, d))
    return M.Problem(M.minimize(M.trace(B.T @ X)), [X == x0]), dict(X=X)


def infeasible_problem(M, rng):
    x = M.Variable(3)
    return M.Problem(M.minimize((np.ones((1, 3)) @ x)[0]),
                     [x >= 1, x <= 0]), dict(x=x)


def indexing_problem(M, rng):
    x = M.Variable(4)
    return M.Problem(M.minimize(x.sum()),
                     [x[0] + x[2] == 3, x[1] == 1, x >= 0]), dict(x=x)


def duals_problem(M, rng):
    m, n = 10, 6
    A = rng.standard_normal((m, n))
    x0 = np.abs(rng.standard_normal(n))
    b = A @ x0 + np.abs(rng.standard_normal(m)) * (rng.random(m) > 0.5)
    c = np.abs(rng.standard_normal(n)) + 0.1
    Aeq = rng.standard_normal((2, n))
    x = M.Variable(n)
    return M.Problem(M.minimize(c @ x), [A @ x <= b, Aeq @ x == Aeq @ x0,
                                         x >= 0]), dict(x=x)


def matmul_constant_problem(M, rng):
    d, b = 3, 4
    E0 = rng.standard_normal((d, b))
    C2 = rng.standard_normal((b, 2))
    c1 = rng.standard_normal(b)
    w1, w2, w3 = (rng.standard_normal(k) for k in (d, 2, d))
    E = M.Variable((d, b))
    obj = ((w1[None, :] @ (E @ C2)) @ w2)[0] + (w3 @ (E @ c1))
    return M.Problem(M.minimize(obj), [E == E0]), dict(E=E)


def norm1_lasso_problem(M, rng):
    n, lam = 12, 0.8
    z = rng.standard_normal(n)
    x = M.Variable(n)
    box = x <= 10.0
    return M.Problem(M.minimize(M.sum_squares(x - z) + lam * M.norm1(x)),
                     [box]), dict(x=x, z=z, lam=lam, box=box)


def norm_inf_problem(M, rng):
    m, n = 14, 6
    A = rng.standard_normal((m, n))
    g = rng.standard_normal(m)
    x = M.Variable(n)
    return M.Problem(M.minimize(M.norm_inf(A @ x - g)),
                     [x <= 100.0, -100.0 <= x]), dict(x=x)


def norm1_constraint_problem(M, rng):
    c = np.abs(rng.standard_normal(6)) + 0.1
    x = M.Variable(6)
    return M.Problem(M.minimize(-(c @ x)), [M.norm1(x) <= 1.0]), dict(x=x)


def norm_inf_constraint_problem(M, rng):
    c = np.abs(rng.standard_normal(6)) + 0.1
    x = M.Variable(6)
    return M.Problem(M.minimize(-(c @ x)), [M.norm_inf(x) <= 1.0]), \
        dict(x=x)


def maximize_problem(M, rng):
    n, gamma = 6, 2.0
    c = rng.standard_normal(n) * 0.5
    x = M.Variable(n)
    return M.Problem(M.maximize(c @ x - gamma * M.sum_squares(x)),
                     [x <= 10.0, -10.0 <= x]), dict(x=x)


def markowitz_problem(M, rng):
    n, gamma = 7, 4.0
    F = rng.standard_normal((n, n))
    Sigma = F @ F.T / n + 0.05 * np.eye(n)
    mu = rng.standard_normal(n) * 0.2
    w = M.Variable(n)
    budget, pos = w.sum() == 1.0, w >= 0
    return M.Problem(M.maximize(mu @ w - gamma * M.quad_form(w, Sigma)),
                     [budget, pos]), \
        dict(w=w, mu=mu, Sigma=Sigma, gamma=gamma, budget=budget, pos=pos)


def sparse_lasso_problem(M, rng):
    """tests/test_native_modeling.py's sparse-lowering lasso, cut to
    n = 2000 (above _DENSIFY_CELLS, so A stays CSR)."""
    n, m = 2000, 100
    A = rng.standard_normal((m, n))
    bb = rng.standard_normal(m)
    x, t = M.Variable(n), M.Variable(n)
    return M.Problem(M.minimize(M.sum_squares(A @ x - bb) + 0.1 * t.sum()),
                     [x <= t, -x <= t]), dict(x=x)


def sparse_sdp_problem(M, rng):
    nn = 64     # 2081 x 2080 cells: A stays CSR
    C = rng.standard_normal((nn, nn))
    X = M.Variable((nn, nn), symmetric=True)
    return M.Problem(M.minimize(M.trace((C + C.T) / 2 @ X)),
                     [X >> 0, M.trace(X) == 1]), dict(X=X)


PROBLEMS = [nnls_problem, lp_problem, lambda_min_problem, exp_problem,
            pow_problem, norm2_constraint_problem, norm2_objective_problem,
            weighted_atoms_problem, matrix_algebra_problem,
            infeasible_problem, indexing_problem, duals_problem,
            matmul_constant_problem, norm1_lasso_problem, norm_inf_problem,
            norm1_constraint_problem, norm_inf_constraint_problem,
            maximize_problem, markowitz_problem, sparse_lasso_problem,
            sparse_sdp_problem]


def _build(recipe, M, seed=0):
    return recipe(M, np.random.default_rng(seed))


def _assert_same_matrix(a, b):
    assert sp.issparse(a) == sp.issparse(b)
    if sp.issparse(a):
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype
    else:
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _assert_same_compile(jprob, tprob):
    jdata, jcone, jvars, joff, jconst, jrows = jprob.compile()
    tdata, tcone, tvars, toff, tconst, trows = tprob.compile()
    _assert_same_matrix(jdata["A"], tdata["A"])
    for k in ("b", "c"):
        np.testing.assert_array_equal(jdata[k], tdata[k])
    assert jcone == tcone
    assert jconst == tconst
    assert [(v.shape, v.nfree, v.symmetric) for v in jvars] == \
        [(v.shape, v.nfree, v.symmetric) for v in tvars]
    assert [joff[id(v)] for v in jvars] == [toff[id(v)] for v in tvars]
    assert [(c.kind, s, n) for c, s, n in jrows] == \
        [(c.kind, s, n) for c, s, n in trows]
    return tdata


@pytest.mark.parametrize("recipe", PROBLEMS, ids=lambda f: f.__name__)
def test_compile_matches_jax(recipe):
    (jprob, _), (tprob, _) = _build(recipe, JM), _build(recipe, TM)
    _assert_same_compile(jprob, tprob)


@pytest.mark.parametrize("recipe", [lp_problem, lambda_min_problem,
                                     norm1_lasso_problem, exp_problem],
                         ids=lambda f: f.__name__)
def test_compile_matches_jax_all_sparse(recipe, monkeypatch):
    """With _DENSIFY_CELLS forced to 0 in both packages A stays CSR, with
    the same arrays."""
    monkeypatch.setattr(JM, "_DENSIFY_CELLS", 0)
    monkeypatch.setattr(TM, "_DENSIFY_CELLS", 0)
    (jprob, _), (tprob, _) = _build(recipe, JM), _build(recipe, TM)
    data = _assert_same_compile(jprob, tprob)
    assert sp.issparse(data["A"])


def test_sparse_constant_lowers_as_dense():
    """The port's DSL also takes a scipy.sparse matrix left of ``@`` (the
    JAX package's takes numpy only): a CSR A lowers to the data the JAX
    package lowers the same matrix dense to (fill under 25%, where its
    dense path drops the zeros), with A emitted dense and as CSR."""
    rng = np.random.default_rng(5)

    def build(M, A, b, c):
        x = M.Variable(A.shape[1])
        return M.Problem(M.minimize(c @ x), [A @ x <= b, x >= 0])

    for m, n, density in ((40, 30, 0.1), (2000, 1500, 0.002)):
        A = sp.random(m, n, density=density, random_state=rng, format="coo")
        b = A @ np.abs(rng.standard_normal(n)) + 1.0
        c = np.abs(rng.standard_normal(n)) + 0.1
        data = _assert_same_compile(build(JM, A.toarray(), b, c),
                                    build(TM, A, b, c))
        assert sp.issparse(data["A"]) == (m > 40)
        assert data["A"].shape == (m + n, n)


def test_sparse_emitted_A_solves(monkeypatch):
    """The emitted CSR reaches the form build as scipy (a torch sparse A on
    the CPU in f64) and solves to the dense-path answer."""
    values = []
    for cells in (TM._DENSIFY_CELLS, 0):
        monkeypatch.setattr(TM, "_DENSIFY_CELLS", cells)
        prob, h = _build(lp_problem, TM)
        prob.solve(alg=TDR(direct=True), eps=1e-9, max_iters=20000,
                   verbose=0, device=CPU)
        assert prob.status == "Optimal"
        values.append(prob.value)
    assert abs(values[0] - values[1]) <= 1e-6 * (1 + abs(values[0]))


def _fuzz_tree(M, rng):
    """A random expression tree over valued variables (the property fuzz of
    tests/test_native_modeling.py), built with module M from ``rng``."""
    env = {}
    kind = rng.integers(0, 3)
    if kind == 0:
        n = int(rng.integers(2, 6))
        v = M.Variable(n)
        env[v] = rng.standard_normal(n)
    elif kind == 1:
        a, b = int(rng.integers(2, 4)), int(rng.integers(2, 4))
        v = M.Variable((a, b))
        env[v] = rng.standard_normal((a, b))
    else:
        d = int(rng.integers(2, 4))
        v = M.Variable((d, d), symmetric=True)
        Mv = rng.standard_normal((d, d))
        env[v] = (Mv + Mv.T) / 2
    expr, val = v, env[v]
    for _ in range(4):
        op = rng.integers(0, 8)
        if op == 0:
            s = float(rng.standard_normal())
            expr, val = expr * s, val * s
        elif op == 1:
            cst = (rng.standard_normal(expr.shape) if expr.shape
                   else float(rng.standard_normal()))
            expr, val = expr + cst, val + cst
        elif op == 2:
            cst = (rng.standard_normal(expr.shape) if expr.shape
                   else float(rng.standard_normal()))
            expr, val = cst - expr, cst - val
        elif op == 3 and len(expr.shape) == 2:
            expr, val = expr.T, val.T
        elif op == 4 and len(expr.shape) == 2:
            C = rng.standard_normal((int(rng.integers(2, 5)), expr.shape[0]))
            expr, val = C @ expr, C @ val
        elif op == 5 and len(expr.shape) == 2:
            C = rng.standard_normal((expr.shape[1], int(rng.integers(2, 5))))
            expr, val = expr @ C, val @ C
        elif op == 6 and len(expr.shape) == 2 and \
                expr.shape[0] == expr.shape[1]:
            expr, val = M.trace(expr), np.trace(val)
        elif op == 7 and expr.shape:
            i = int(rng.integers(0, expr.shape[0]))
            expr, val = expr[i], np.asarray(val)[i]
    return expr, val, env


def _evaluate(expr, env):
    out = np.array(expr.const, float, copy=True)
    for v, F in expr.terms.items():
        mv = env[v]
        if v.symmetric:
            d = v.shape[0]
            free = np.array([mv[i, j] for j in range(d) for i in range(j, d)])
        else:
            free = np.asarray(mv).reshape(-1)
        out = out + (F.toarray() if sp.issparse(F) else np.asarray(F)) @ free
    return out


@pytest.mark.parametrize("seed", range(4))
def test_affine_lowering_fuzz(seed):
    """Random expression trees: the port's coefficient blocks and constant
    are bit-identical to the JAX package's, and evaluate to numpy's value
    of the same operations."""
    jr, tr = (np.random.default_rng(100 + seed) for _ in range(2))
    for trial in range(20):
        jexpr, _, _ = _fuzz_tree(JM, jr)
        texpr, val, env = _fuzz_tree(TM, tr)
        assert texpr.shape == jexpr.shape
        np.testing.assert_array_equal(texpr.const, jexpr.const)
        assert len(texpr.terms) == len(jexpr.terms) == 1
        (jF,), (tF,) = jexpr.terms.values(), texpr.terms.values()
        _assert_same_matrix(sp.csr_matrix(jF), sp.csr_matrix(tF))
        got = _evaluate(texpr, env)
        want = np.asarray(val, float).reshape(got.shape)
        np.testing.assert_allclose(got, want, atol=1e-9,
                                   err_msg=f"trial {trial}")


# ------------------------------------------------------------------ solves
def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want))), (
        float(np.abs(got - want).max()))


def _solve_both(recipe, eps=1e-9, max_iters=60000):
    """The same problem solved by both packages with DR(direct=True) in
    f64; values, objective and every constraint's dual agree."""
    jprob, jh = _build(recipe, JM)
    tprob, th = _build(recipe, TM)
    jprob.solve(alg=JDR(direct=True), eps=eps, max_iters=max_iters,
                verbose=0)
    tprob.solve(alg=TDR(direct=True), eps=eps, max_iters=max_iters,
                verbose=0, device=CPU)
    assert tprob.status == jprob.status == "Optimal"
    _close(tprob.value, jprob.value)
    for key, v_t in th.items():
        if isinstance(v_t, TM.Variable):
            _close(v_t.value, jh[key].value)
    for c_t, c_j in zip(tprob.constraints, jprob.constraints):
        _close(c_t.dual_value, c_j.dual_value)
    return tprob, th


def test_nnls_solve():
    prob, h = _solve_both(nnls_problem)
    xs, rnorm = nnls(h["A"], h["b"])
    assert abs(prob.value - rnorm**2) < 1e-6 * (1 + rnorm**2)
    np.testing.assert_allclose(h["x"].value, xs, atol=1e-4)


def test_lp_solve_and_duals():
    prob, h = _solve_both(lp_problem)
    ref = linprog(h["c"], A_ub=h["A"], b_ub=h["b"],
                  bounds=[(0, None)] * len(h["c"]))
    assert abs(prob.value - ref.fun) < 1e-6 * (1 + abs(ref.fun))
    np.testing.assert_allclose(h["ub"].dual_value,
                               -np.asarray(ref.ineqlin.marginals), atol=1e-5)


def test_lambda_min_sdp_solve():
    prob, h = _solve_both(lambda_min_problem)
    assert abs(prob.value - 0.3) < 1e-5
    v = h["Q"][:, 0]
    np.testing.assert_allclose(h["X"].value, np.outer(v, v), atol=1e-4)
    # the PSD constraint's dual is a matrix (smat of its rows)
    assert h["cone"].dual_value.shape == (4, 4)


def test_exp_cone_solve():
    prob, _ = _solve_both(exp_problem)
    assert abs(prob.value - np.e) < 1e-5


def test_pow_cone_solve():
    prob, _ = _solve_both(pow_problem)
    assert abs(prob.value - 4.0) < 1e-4


def test_norm1_lasso_solve():
    prob, h = _solve_both(norm1_lasso_problem)
    z, lam = h["z"], h["lam"]
    xstar = np.sign(z) * np.maximum(np.abs(z) - lam / 2, 0.0)
    np.testing.assert_allclose(h["x"].value, xstar, atol=2e-5)


def test_quad_form_markowitz_solve():
    from scipy.optimize import minimize as sp_min

    prob, h = _solve_both(markowitz_problem)
    mu, Sigma, gamma = h["mu"], h["Sigma"], h["gamma"]
    n = len(mu)
    ref = sp_min(lambda v: -(mu @ v) + gamma * v @ Sigma @ v,
                 np.ones(n) / n, method="SLSQP", bounds=[(0, None)] * n,
                 constraints=[{"type": "eq", "fun": lambda v: v.sum() - 1}])
    assert ref.success
    assert abs(prob.value - (-ref.fun)) < 1e-6 * (1 + abs(ref.fun))


def test_solve_runs_on_the_card_unless_asked():
    """Without ``device`` the DSL solves on the card: with no card it
    raises rather than falling back to the CPU."""
    prob, _ = _build(exp_problem, TM)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the solve would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        prob.solve(alg=TDR(), eps=1e-6, max_iters=100, verbose=0)
