"""fos_tpu_torch's checkpoints and history plot, on the CPU.

The resume contract of ``tests/test_checkpoint.py`` (300 GAPA iterations,
save, load into a fresh template, resume to Optimal within 1e-5 (1 + |f|)
of a straight-through solve) on the port; the leaf-count and shape errors;
and a checkpoint written by the JAX package's ``save_state`` loaded into
the port's template and resumed to the JAX package's straight-through
objective.  The two packages' solver states have the same leaves in the
same order (listed in ``LEAVES``), so the file maps one to one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fos_tpu import GAPA as JGAPA
from fos_tpu.cones import nonneg as jnonneg
from fos_tpu.problems.conic import conic_problem as jconic_problem
from fos_tpu.problems.hsde import HSDEForm as JHSDEForm
from fos_tpu.problems.hsde import populate_solution as jpopulate
from fos_tpu.solvers import engine as jengine
from fos_tpu.utils.checkpoint import save_state as jsave_state

from fos_tpu_torch import DR, GAPA, nonneg
from fos_tpu_torch.problems.conic import conic_problem
from fos_tpu_torch.problems.hsde import HSDEForm, populate_solution
from fos_tpu_torch.solvers import engine
from fos_tpu_torch.solvers.base import init_solver_state
from fos_tpu_torch.solvers.status import Status
from fos_tpu_torch.utils.checkpoint import _leaves, load_state, save_state

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its solves are small and eager,
    and the suite runs several worker processes on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

#: the leaves of a GAPA state on an HSDE form with CG, in file order
LEAVES = ["x", "i", "z_check", "z_check_prev", "s1_state.warm",
          "s1_state.initialized", "s1_state.call_idx", "s1_state.last_iters",
          "s1_state.total_iters", "s1_state.v_warm", "aux"]


def _lp(rng, m=20, n=30):
    A = rng.standard_normal((m, n))
    xmask = rng.random(n) < 0.5
    x0 = np.abs(rng.standard_normal(n)) * xmask
    r0 = np.abs(rng.standard_normal(n)) * (~xmask)
    ymask = rng.random(m) < 0.5
    y0 = np.abs(rng.standard_normal(m)) * ymask
    s0 = np.abs(rng.standard_normal(m)) * (~ymask)
    return A, A @ x0 + s0, r0 - A.T @ y0


def _form(A, b, c, direct=False):
    m, n = A.shape
    return HSDEForm.build(conic_problem(A, b, c, nonneg(m), nonneg(n),
                                        device=CPU), direct=direct)


def _template(alg, form):
    return init_solver_state(alg, form.sets, form.initial_value(form.dtype))


def _paths(tree, prefix=""):
    """Dotted field paths of the leaves, in the order ``_leaves`` takes."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f, v in zip(tree._fields, tree)
                for p in _paths(v, f"{prefix}{f}.")]
    if isinstance(tree, (tuple, list)):
        return [p for k, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{k}.")]
    return [prefix[:-1]]


def _objval(form, res):
    return populate_solution(form, res.guess, res.status, res.iters).objval


def test_checkpoint_resume(rng, tmp_path):
    """The contract on a direct-mode form (its CG state is the plain one,
    without ``v_warm``: the CG form's leaves are checked below with the
    JAX package's checkpoint), ~10x faster on the CPU than CG here."""
    A, b, c = _lp(rng)
    form = _form(A, b, c, direct=True)
    alg = GAPA()
    r1 = engine.run(form, alg, max_iters=300, eps=1e-9, checki=100,
                    verbose=0)
    assert r1.status == Status.CONTINUE
    path = str(tmp_path / "ckpt.npz")
    save_state(path, r1.state)

    template = _template(alg, form)
    assert _paths(template) == [p for p in LEAVES if p != "s1_state.v_warm"]
    restored = load_state(path, template)
    assert type(restored) is type(r1.state)
    for got, want in zip(_leaves(restored), _leaves(r1.state)):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want)
    assert int(restored.i) == int(r1.state.i) == 300
    assert float(restored.aux) == float(r1.state.aux)   # GAPA's a12 carry

    r2 = engine.run(form, alg, resume_state=restored, max_iters=20000,
                    eps=1e-8, checki=100, verbose=0)
    assert r2.status == Status.OPTIMAL
    r3 = engine.run(form, alg, max_iters=20000, eps=1e-8, checki=100,
                    verbose=0)
    f2, f3 = _objval(form, r2), _objval(form, r3)
    assert abs(f2 - f3) <= 1e-5 * (1 + abs(f3))


def test_checkpoint_errors(rng, tmp_path):
    A, b, c = _lp(rng)
    alg = DR()
    st = _template(alg, _form(A, b, c))
    path = str(tmp_path / "ckpt.npz")
    save_state(path, st)
    # a template of another size
    st2 = _template(alg, _form(*_lp(rng, 10, 15)))
    with pytest.raises(ValueError, match="shape"):
        load_state(path, st2)
    # a template with other leaves: GAPA carries one more (its a12)
    with pytest.raises(ValueError, match="leaves"):
        load_state(path, _template(GAPA(), _form(A, b, c)))


def test_jax_checkpoint_resumes_in_port(rng, tmp_path):
    """300 GAPA iterations in the JAX package, saved with its save_state,
    loaded into the port's template and resumed to the JAX package's own
    straight-through objective."""
    A, b, c = _lp(rng)
    m, n = A.shape
    jform = JHSDEForm.build(jconic_problem(jnp.asarray(A), jnp.asarray(b),
                                           jnp.asarray(c), jnonneg(m),
                                           jnonneg(n)))
    jalg = JGAPA()
    r1 = jengine.run(jform, jalg, max_iters=300, eps=1e-9, checki=100,
                     verbose=0)
    path = str(tmp_path / "jax_ckpt.npz")
    jsave_state(path, r1.state)
    # the JAX state's leaves, by field, are the port's LEAVES
    jpaths = [".".join(str(getattr(k, "name", getattr(k, "idx", k)))
                       for k in path_)
              for path_, _ in jax.tree_util.tree_flatten_with_path(
                  r1.state)[0]]
    assert jpaths == LEAVES

    form = _form(A, b, c)
    alg = GAPA()
    template = _template(alg, form)
    assert _paths(template) == LEAVES
    restored = load_state(path, template)
    np.testing.assert_array_equal(restored.x.numpy(), np.asarray(r1.state.x))
    assert int(restored.i) == 300
    r2 = engine.run(form, alg, resume_state=restored, max_iters=20000,
                    eps=1e-8, checki=100, verbose=0)
    assert r2.status == Status.OPTIMAL
    r3 = jengine.run(jform, jalg, max_iters=20000, eps=1e-8, checki=100,
                     verbose=0)
    f3 = jpopulate(jform, r3.guess, r3.status, r3.iters).objval
    assert abs(_objval(form, r2) - f3) <= 1e-5 * (1 + abs(f3))


def test_plothistory(rng):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fos_tpu_torch import solve
    from fos_tpu_torch.utils.plotting import plothistory

    A, b, c = _lp(rng)
    m, n = A.shape
    sol = solve(A, b, c, nonneg(m), nonneg(n), alg=DR(direct=True), eps=1e-6,
                max_iters=2000, verbose=0, device=CPU)
    _, ax = plt.subplots()
    assert plothistory(sol.history, "p", ax=ax) is ax
    assert ax.get_ylabel() == "p" and ax.get_yscale() == "log"
    iters, vals = sol.history.get("p")
    np.testing.assert_array_equal(ax.lines[0].get_xdata(), iters)
    plt.close("all")
