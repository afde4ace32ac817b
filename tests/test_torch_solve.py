"""End-to-end solves through fos_tpu_torch.solve on the CPU, where the pair
kernels run their plain PyTorch versions, held to the contracts of the JAX
package's own end-to-end tests and to its solves of the same data.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch
from jax.experimental.sparse import BCOO

import fos_tpu
from fos_tpu.cones import nonneg as jnonneg
from fos_tpu.problems.conic import conic_problem as jconic
from fos_tpu.problems.hsde import HSDEForm as JForm

import chip_smoke
import fos_tpu_torch
from fos_tpu_torch import interop
from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.problems.conic import conic_problem as tconic
from fos_tpu_torch.problems.hsde import HSDEForm as TForm

from test_solve_e2e import readme_problem
from test_sparse import _banded_scipy, _sparse_lp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tspec(jspec):
    return interop.cone_spec_from_blocks([(c.name, d) for c, d in jspec.blocks])


def test_dr_readme():
    """test_solve_e2e.py::test_dr_readme's contract.  The port takes the
    JAX package's iteration count, or one checki more or less: the two
    packages round their sums differently, and a check that lands on the
    eps boundary may pass one chunk earlier or later."""
    Ac, bc, c, K1, K2, A, b, xstar, opt = readme_problem()
    n = A.shape[1]
    sol = fos_tpu_torch.solve(Ac, bc, c, _tspec(K1), _tspec(K2),
                              alg=fos_tpu_torch.DR(), eps=1e-8,
                              max_iters=20000, verbose=0, device="cpu")
    assert sol.status == "Optimal"
    x = sol.x[:n].numpy()
    obj = np.sum((A @ x - b) ** 2)
    assert abs(obj - opt) / opt < 1e-6
    assert np.min(x) > -1e-6
    np.testing.assert_allclose(x, xstar, atol=1e-4)
    jsol = fos_tpu.solve(Ac, bc, c, K1, K2, alg=fos_tpu.DR(), eps=1e-8,
                         max_iters=20000, verbose=0)
    assert abs(sol.iters - jsol.iters) <= 100


def test_dense_lp_f32_through_the_pair_kernel():
    """bench.py's certificate LP recipe at 200x300, f32, pallas=True: the
    dense pair goes through fused_matvec (its plain version on CPU
    tensors)."""
    A, b, c, opt = chip_smoke.certificate_lp(200, 300, seed=7)
    K1, K2 = fos_tpu_torch.nonneg(200), fos_tpu_torch.nonneg(300)
    prob = tconic(A, b, c, K1, K2)
    from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp

    assert isinstance(TForm.build(prob, pallas=True).A, PaddedDenseOp)
    before = dict(_cuda.LAUNCHES)
    sol = fos_tpu_torch.solve(A, b, c, K1, K2, alg=fos_tpu_torch.DR(),
                              eps=1e-5, dtype=torch.float32, pallas=True,
                              verbose=0, device="cpu")
    assert _cuda.LAUNCHES == before
    assert sol.status == "Optimal" and sol.x.dtype == torch.float32
    assert abs(sol.objval - opt) / abs(opt) < 1e-3
    jsol = fos_tpu.solve(A, b, c, jnonneg(200), jnonneg(300),
                         alg=fos_tpu.DR(), eps=1e-5, dtype=jnp.float32,
                         verbose=0)
    assert jsol.status == "Optimal"
    assert abs(sol.objval - jsol.objval) / abs(jsol.objval) < 1e-3


def _banded_lp():
    """test_sparse.py::test_banded_auto_selected_and_solves's problem."""
    A = _banded_scipy(512, 512, 100, seed=6).astype(np.float32)
    rng = np.random.default_rng(1)
    x0 = np.abs(rng.standard_normal(512)).astype(np.float32)
    b = (A @ x0 + np.abs(rng.standard_normal(512))).astype(np.float32)
    c = np.abs(rng.standard_normal(512)).astype(np.float32) + 0.1
    return A, b, c


def _scattered_lp():
    """test_sparse.py::test_sparse_solve_bell_end_to_end's problem."""
    A, b, c, _ = _sparse_lp()
    return (A.astype(np.float32), b.astype(np.float32), c.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_dense_solve(name):
    """The JAX package's dense f32 solve of a problem, solved once for the
    cases that share it."""
    A, b, c = _banded_lp() if name == "banded" else _scattered_lp()
    m, n = A.shape
    return fos_tpu.solve(np.asarray(A.toarray()), b, c, jnonneg(m),
                         jnonneg(n), alg=fos_tpu.DR(), eps=1e-5, verbose=0,
                         dtype=jnp.float32, max_iters=20000)


@pytest.mark.parametrize("name,fmt,tol", [
    # the JAX tests' tolerances against their densified solves
    ("banded", "bell", ("abs", 2e-3)),
    ("scattered", "bell", ("rel", 1e-3)),
    # auto keeps this small grid sparse (storage ratio >= 0.5), as JAX does
    ("scattered", "auto", ("rel", 1e-3)),
])
def test_sparse_lp_tile_ops(name, fmt, tol):
    A, b, c = _banded_lp() if name == "banded" else _scattered_lp()
    m, n = A.shape
    jform = JForm.build(jconic(A, jnp.asarray(b), jnp.asarray(c), jnonneg(m),
                               jnonneg(n)), densify=False, sparse_format=fmt)
    tform = TForm.build(tconic(A, b, c, fos_tpu_torch.nonneg(m),
                               fos_tpu_torch.nonneg(n)),
                        densify=False, sparse_format=fmt)
    # the same layout decision; a matrix left sparse is the JAX package's
    # BCOO and the port's torch sparse COO tensor
    jname = type(jform.A).__name__
    if jname == "BCOO":
        assert tform.A.layout == torch.sparse_coo
    else:
        assert type(tform.A).__name__ == jname
    sol = fos_tpu_torch.solve(A, b, c, fos_tpu_torch.nonneg(m),
                              fos_tpu_torch.nonneg(n), alg=fos_tpu_torch.DR(),
                              eps=1e-5, verbose=0, densify=False,
                              sparse_format=fmt, max_iters=20000,
                              device="cpu")
    assert sol.status == "Optimal"
    jsol = _jax_dense_solve(name)
    assert jsol.status == "Optimal"
    kind, t = tol
    err = abs(sol.objval - jsol.objval)
    assert err < t * (1 + abs(jsol.objval) if kind == "abs" else abs(jsol.objval))


def test_auto_format_selection_matches_jax():
    """Auto picks the banded layout for a large banded matrix, keeps a
    uniformly filled one sparse (as torch sparse COO, the port's BCOO), and
    refuses tile formats at f64 -- the JAX package's decisions on CPU."""
    Abig = _banded_scipy(4096, 4096, 150, seed=6).astype(np.float32)
    one = np.ones(4096, np.float32)
    form = TForm.build(tconic(Abig, one, one, fos_tpu_torch.nonneg(4096),
                              fos_tpu_torch.nonneg(4096)), densify=False)
    assert type(form.A).__name__ == "BandedBlockOp"
    full = sp.random(256, 256, density=0.05,
                     random_state=np.random.RandomState(5), format="csr")
    form = TForm.build(tconic(full, np.ones(256), np.ones(256),
                              fos_tpu_torch.nonneg(256),
                              fos_tpu_torch.nonneg(256)), densify=False)
    assert form.A.layout == torch.sparse_coo
    with pytest.raises(ValueError, match="bell"):
        TForm.build(tconic(full, np.ones(256), np.ones(256),
                           fos_tpu_torch.nonneg(256),
                           fos_tpu_torch.nonneg(256)), sparse_format="bell")


def test_bench_banded_lp_through_the_band_pair():
    """chip_smoke's (bench.py's) block-tridiagonal LP at nrb=8, passed as a
    BandedBlockOp (K2's plain version on CPU), against the JAX package's
    solve of the same matrix packed as its own BandedBlockOp (K2's Pallas
    kernel in interpret mode: 6 s on the CPU, where the JAX dense f32 solve
    took 48 s)."""
    blk, cs, vectors = chip_smoke.banded_tables(nrb=8)
    m = n = 8 * 128
    op = fos_tpu_torch.BandedBlockOp.from_arrays(blk, cs, m, n, device="cpu")
    b, c, opt = chip_smoke.lp_from_operator(op, vectors, "cpu")
    sol = fos_tpu_torch.solve(op, b, c, fos_tpu_torch.nonneg(m),
                              fos_tpu_torch.nonneg(n), alg=fos_tpu_torch.DR(),
                              eps=1e-5, max_iters=10000, verbose=0,
                              device="cpu")
    assert sol.status == "Optimal"
    assert abs(sol.objval - opt) / abs(opt) < 1e-3
    jA = BCOO.from_scipy_sparse(sp.csr_matrix(op.todense().numpy()))
    jsol = fos_tpu.solve(jA, b.numpy(), c.numpy(), jnonneg(m), jnonneg(n),
                         alg=fos_tpu.DR(), eps=1e-5, max_iters=10000,
                         verbose=0, dtype=jnp.float32, densify=False,
                         sparse_format="band")
    assert jsol.status == "Optimal"
    assert abs(sol.objval - jsol.objval) / abs(jsol.objval) < 1e-3


@pytest.mark.parametrize("kw,match", [
    (dict(refine=10), None),
    (dict(epsilon=1e-3), "unknown"),
], ids=["refine", "unknown_option"])
def test_unported_options_raise(kw, match):
    """A misspelled option is refused.  ``refine`` is ported (its parity
    with the JAX package: tests/test_torch_refine.py): here it continues an
    f32 solve of the banded LP for its 10 iterations in f64, the counts of
    both stages adding up; equilibrate and direct mode are ported too
    (tests/test_torch_scaling_direct.py)."""
    A, b, c = _banded_lp()
    K = fos_tpu_torch.nonneg(512)
    opts = dict(max_iters=10, verbose=0, device="cpu", dtype=torch.float32)
    if match is None:
        sol = fos_tpu_torch.solve(A.toarray(), b, c, K, K, **opts, **kw)
        assert sol.x.dtype == torch.float64 and sol.iters == 20
        assert bool(torch.isfinite(sol.raw_z).all())
        return
    with pytest.raises((NotImplementedError, TypeError), match=match):
        fos_tpu_torch.solve(A.toarray(), b, c, K, K, **opts, **kw)