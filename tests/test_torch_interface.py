"""fos_tpu_torch's conic front end against the JAX package's, on the CPU.

The same numpy inputs go through ``fos_tpu.interface`` and
``fos_tpu_torch.interface``: the cone tables and their errors must agree
exactly, and the f64 solves (eps 1e-9, as ``tests/test_interface_extras.
py``) within 1e-6 (1 + |.|) in x, y and the objective.  The recorded
CVXPY fixtures of ``tests/test_modeling.py`` run their own oracle checks on
the port's ``solve_conic_data``, and the cvxpy stand-in of
``tests/test_cvxpy_conformance.py`` drives the port's backend class.

Port solves use ``direct=True`` (the cached host QR in place of CG, the
same algorithm otherwise): at these sizes it is ~10x faster on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

import fos_tpu.interface.conic as jconic
import fos_tpu.interface.cvxpy_adapter as jadapter
import fos_tpu_torch as T
import fos_tpu_torch.interface.conic as tconic
import fos_tpu_torch.interface.cvxpy_adapter as tadapter
from fos_tpu import DR as JDR
from fos_tpu import solve as jsolve

import test_cvxpy_conformance as jcvx
import test_modeling as jfixtures

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its solves are small and eager,
    and the suite runs several worker processes on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pairs(spec):
    return [(cone.name, dim) for cone, dim in spec.blocks], spec.params


CONE_DICTS = [
    {"l": 3},
    {"z": 2, "l": 3, "q": [4, 3], "s": [3], "ep": 2, "ed": 1},
    {"f": 1, "q": [2]},
    {"s": [1, 2, 4]},
    {"p": [0.3, 0.4, -0.5, -0.6, 0.7]},
    {"l": 1, "p": [-0.2]},
    {"z": 1, "ep": 1, "p": [0.5, 0.5]},
]


@pytest.mark.parametrize("cone", CONE_DICTS, ids=str)
def test_scs_cone_spec_matches(cone):
    dims = tadapter._dims_to_cone_dict(cone)
    assert dims == jadapter._dims_to_cone_dict(cone)
    assert _pairs(tconic.scs_cone_spec(dims)) == _pairs(
        jconic.scs_cone_spec(dims))


MPB_LISTS = [
    (5, [("NonNeg", range(3)), ("Zero", [3, 4])]),
    (7, [("SOC", range(3)), ("SOCRotated", range(3, 6)), ("Free", [6])]),
    (9, [("SDP", range(6)), ("ExpPrimal", range(6, 9))]),
    (6, [("ExpDual", range(3)), ("NonPos", range(3, 6))]),
]


@pytest.mark.parametrize("dim,cones", MPB_LISTS)
def test_cone_spec_from_list_matches(dim, cones):
    assert tconic.supported_cones() == jconic.supported_cones()
    assert _pairs(tconic.cone_spec_from_list(dim, cones)) == _pairs(
        jconic.cone_spec_from_list(dim, cones))
    # Cone members are accepted in place of names
    assert _pairs(jconic.cone_spec_from_list(
        dim, [(jconic.CONE_MAP[c], i) for c, i in cones])) == _pairs(
        tconic.cone_spec_from_list(dim, [(tconic.CONE_MAP[c], i)
                                         for c, i in cones]))


BAD_INPUTS = [
    ("list", (3, [("Bogus", range(3))])),
    ("list", (3, [("NonNeg", [])])),
    ("list", (3, [("NonNeg", [0, 2, 1])])),
    ("list", (3, [("NonNeg", [1, 2]), ("Zero", [0])])),
    ("list", (4, [("NonNeg", range(3))])),
    ("list", (2, [("SOC", [0]), ("Zero", [1])])),
    ("list", (4, [("ExpPrimal", range(4))])),
    ("scs", ({"p": [1.5]},)),
    ("scs", ({"p": [0.0]},)),
    ("scs", ({"s": [0]},)),
]


@pytest.mark.parametrize("kind,args", BAD_INPUTS, ids=str)
def test_same_exceptions(kind, args):
    fn = {"list": "cone_spec_from_list", "scs": "scs_cone_spec"}[kind]
    caught = []
    for mod in (jconic, tconic):
        with pytest.raises(Exception) as info:
            getattr(mod, fn)(*args)
        caught.append(type(info.value))
    assert caught[0] is caught[1]


def test_validation_errors_match():
    """Row coverage and missing dims raise as in the JAX package."""
    A = np.zeros((4, 2))
    data = dict(A=A, b=np.zeros(4), c=np.zeros(2))
    with pytest.raises(ValueError, match="cover"):
        tconic.solve_scs(data, dict(l=3), device=CPU)
    with pytest.raises(ValueError, match="A_ub"):
        tconic.solve_lp(np.ones(2), device=CPU)
    with pytest.raises(TypeError, match="dims"):
        tadapter.solve_conic_data({"A": sp.csc_matrix(np.ones((1, 1))),
                                   "b": np.ones(1), "c": np.ones(1)})
    # without a card and without device= the entry points raise
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tconic.load_problem(np.ones(2), np.eye(2), np.ones(2),
                                [("NonNeg", range(2))], [("Free", range(2))])
        with pytest.raises(RuntimeError, match="CUDA"):
            tconic.solve_scs(dict(A=np.eye(2), b=np.ones(2), c=np.ones(2)),
                             dict(l=2))
    # without cvxpy the seam raises what the JAX package's raises
    errors = []
    for mod in (jadapter, tadapter):
        with pytest.raises(ImportError) as info:
            mod.register_with_cvxpy()
        errors.append(type(info.value))
    assert errors[0] is errors[1]


@pytest.mark.parametrize("sparse", [False, True])
def test_load_problem(rng, sparse):
    m, n = 6, 5
    A = rng.standard_normal((m, n))
    A[A < 0.3] = 0.0
    b, c = rng.standard_normal(m), rng.standard_normal(n)
    A_in = sp.csr_matrix(A) if sparse else A
    K1 = [("Zero", range(2)), ("NonNeg", range(2, 6))]
    K2 = [("Free", range(2)), ("NonNeg", range(2, 5))]
    jp = jconic.load_problem(c, A_in, b, K1, K2)
    tp = tconic.load_problem(c, A_in, b, K1, K2, device=CPU)
    assert _pairs(tp.K1) == _pairs(jp.K1) and _pairs(tp.K2) == _pairs(jp.K2)
    assert sp.issparse(tp.A) == sparse    # scipy reaches the form build
    dense = tp.A.toarray() if sparse else tp.A.numpy()
    np.testing.assert_array_equal(dense, np.asarray(jp.A.todense()
                                                    if sparse else jp.A))
    np.testing.assert_array_equal(tp.b.numpy(), b)
    np.testing.assert_array_equal(tp.c.numpy(), c)
    sol = T.solve(problem=tp, alg=T.DR(direct=True), eps=1e-8,
                  max_iters=20000, verbose=0)
    ref = jsolve(problem=jp, alg=JDR(), eps=1e-8, max_iters=20000, verbose=0)
    assert sol.status == ref.status
    if ref.status == "Optimal":
        assert abs(sol.objval - ref.objval) <= 1e-6 * (1 + abs(ref.objval))


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want))), (
        float(np.abs(got - want).max()))


def _same_solution(sol, ref):
    assert sol.status == ref.status == "Optimal"
    _close(sol.x.numpy(), np.asarray(ref.x))
    _close(sol.y.numpy(), np.asarray(ref.y))
    _close(sol.objval, ref.objval)


SCS_LP = (dict(A=np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]),
               b=np.array([1.0, 0.0, 0.0]), c=np.array([-1.0, -0.5])),
          dict(l=3))
SCS_SOC = (dict(A=np.array([[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0]]),
                b=np.array([1.0, 0.0, 0.0]), c=np.array([1.0, 0.0])),
           dict(q=[3]))


@pytest.mark.parametrize("data,cone", [SCS_LP, SCS_SOC], ids=["lp", "soc"])
def test_solve_scs_matches_jax(data, cone):
    ref = jconic.solve_scs(data, cone, alg=JDR(), eps=1e-9, max_iters=20000,
                           verbose=0)
    sol = tconic.solve_scs(data, cone, alg=T.DR(direct=True), eps=1e-9,
                           max_iters=20000, verbose=0, device=CPU)
    _same_solution(sol, ref)


def test_solve_lp_matches_jax(rng):
    m, n = 12, 8
    A = rng.standard_normal((m, n))
    x0 = np.abs(rng.standard_normal(n))
    b = A @ x0 + np.abs(rng.standard_normal(m))
    Aeq = rng.standard_normal((2, n))
    beq = Aeq @ x0
    c = np.abs(rng.standard_normal(n)) + 0.1
    ref = jconic.solve_lp(c, A_ub=A, b_ub=b, A_eq=Aeq, b_eq=beq, alg=JDR(),
                          eps=1e-9, max_iters=40000, verbose=0)
    sol = tconic.solve_lp(c, A_ub=A, b_ub=b, A_eq=Aeq, b_eq=beq,
                          alg=T.DR(direct=True), eps=1e-9, max_iters=40000,
                          verbose=0, device=CPU)
    _same_solution(sol, ref)
    lp = linprog(c, A_ub=A, b_ub=b, A_eq=Aeq, b_eq=beq,
                 bounds=[(0, None)] * n)
    assert abs(sol.objval - lp.fun) <= 1e-6 * (1 + abs(lp.fun))
    # options pass through to solve unchanged: the dtype reaches the form
    sol32 = tconic.solve_lp(c, A_ub=A, b_ub=b, nonneg=False, eps=1e-4,
                            max_iters=50, dtype=torch.float32, verbose=0,
                            device=CPU)
    assert sol32.x.dtype == torch.float32


def _port_alg(alg):
    """The port's counterpart of a JAX algorithm (None: DR), in direct mode."""
    if alg is None:
        return T.DR(direct=True)
    fields = {f.name: getattr(alg, f.name) for f in dataclasses.fields(alg)}
    fields["direct"] = True
    return getattr(T, type(alg).__name__)(**fields)


FIXTURES = ["test_lp_fixture_vs_linprog", "test_nnls_fixture_vs_scipy",
            "test_min_eigenvalue_sdp_fixture", "test_exp_cone_fixture",
            "test_mixed_cone_fixture", "test_infeasible_fixture_status"]


@pytest.mark.parametrize("name", FIXTURES)
def test_recorded_fixtures_through_port(name, monkeypatch):
    """Each recorded CVXPY fixture test of tests/test_modeling.py, its data
    and its oracle checks unchanged, with its ``solve_conic_data`` pointed
    at the port (on the CPU)."""
    calls = []

    def port_solve_conic_data(data, dims=None, alg=None, **options):
        out = tadapter.solve_conic_data(data, dims, alg=_port_alg(alg),
                                        device=CPU, **options)
        assert all(isinstance(out[k], np.ndarray) for k in ("x", "y", "s"))
        calls.append(out["info"]["status"])
        return out

    monkeypatch.setattr(jfixtures, "solve_conic_data", port_solve_conic_data)
    getattr(jfixtures, name)()
    assert calls


def test_cvxpy_backend_class_drives_solves(monkeypatch):
    """tests/test_cvxpy_conformance.py's stand-in cvxpy modules, with the
    port's backend class: constructed, driven through solve_via_data and
    invert on an optimal and an infeasible LP, and registered."""
    defines = jcvx._install_cvxpy_standin(monkeypatch)
    backend = tadapter.make_cvxpy_solver_class()()
    assert backend.name() == "FOS_TPU"
    backend.import_solver()

    rng = np.random.default_rng(19)
    m, n = 8, 5
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + np.abs(rng.standard_normal(m)) + 0.3
    c = -G.T @ (np.abs(rng.standard_normal(m)) + 0.1)
    ref = linprog(c, A_ub=G, b_ub=h, bounds=(None, None))
    opts = {"device": CPU, "alg": T.DR(direct=True)}
    raw = backend.solve_via_data(
        {"A": sp.csc_matrix(G), "b": h, "c": c,
         "dims": jcvx.ConeDims(nonneg=m)},
        warm_start=False, verbose=False,
        solver_opts={"eps": 1e-9, "max_iters": 60000, **opts})
    sol = backend.invert(raw, inverse_data=None)
    assert sol.status == "optimal"
    assert abs(sol.opt_val - ref.fun) < 1e-5 * (1 + abs(ref.fun))
    np.testing.assert_allclose(sol.primal_vars["x"], ref.x, atol=1e-4)

    raw = backend.solve_via_data(
        {"A": sp.csc_matrix(np.array([[-1.0], [1.0]])),
         "b": np.array([-1.0, 0.0]), "c": np.array([1.0]),
         "dims": jcvx.ConeDims(nonneg=2)},
        warm_start=False, verbose=False,
        solver_opts={"eps": 1e-6, "strict_certificates": True,
                     "max_iters": 40000, **opts})
    sol = backend.invert(raw, inverse_data=None)
    assert sol.status == "infeasible"

    name = tadapter.register_with_cvxpy()
    assert name == "FOS_TPU"
    assert "FOS_TPU" in defines.SOLVER_MAP_CONIC
    assert "FOS_TPU" in defines.INSTALLED_SOLVERS


def test_status_row_at_tau_zero():
    """A verbose solve's status row divides kappa by tau as the JAX
    package's device scalars do: inf at tau = 0, no exception (f32 DR on
    the card passes through tau = 0 on sparse_banded's 4096 x 4096 LP)."""
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDECheck, HSDEForm

    form = HSDEForm.build(conic_problem(np.eye(2), np.ones(2), np.ones(2),
                                        T.nonneg(2), T.nonneg(2),
                                        device=CPU))
    chk = HSDECheck(0, 1.0, 2.0, 3.0, 4.0, 5.0, 0.0, 1.5)
    # the CG count is given, so no solver state is read
    assert "inf" in form.row(None, chk, 100, 0.5, cgiter=3)
    assert "nan" in form.row(None, chk._replace(kappa=0.0), 100, 0.5,
                             cgiter=3)
