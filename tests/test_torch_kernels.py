"""fos_tpu_torch's pair kernels K1-K3 (their plain PyTorch versions, which
the wrappers run on CPU tensors) against the JAX package's Pallas kernels
in interpret mode, and the port's host builders against the JAX builders.

Tolerance: rtol=2e-5, atol=2e-4 in f32, the JAX sparse tests' own (f32
sums taken in another order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from fos_tpu.linalg import pallas_kernels as jpk
from fos_tpu.linalg import sparse_ell as jse

from fos_tpu_torch import interop
from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.linalg import sparse_ell as tse
from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp, fused_matvec

RTOL, ATOL = 2e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _banded_scipy(m, n, bw, seed):
    """Random banded matrix: nonzeros within |i - j| <= bw (as in
    tests/test_sparse.py)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        nz = rng.integers(1, 4)
        rows.extend([i] * nz)
        cols.extend(rng.integers(lo, hi, nz).tolist())
        vals.extend(rng.standard_normal(nz).tolist())
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()


SPARSE_CASES = {
    # non-square and window overlap (test_sparse.py::test_banded_mv_pair_oracle)
    "band_1000x1200": lambda: _banded_scipy(1000, 1200, 150, 4),
    "band_1200x1000": lambda: _banded_scipy(1200, 1000, 250, 4),
    "band_512": lambda: _banded_scipy(512, 512, 100, 4),
    # every tile occupied -> S = 16 > 8 (test_banded_wide_span_slabs)
    "wide_span_2048": lambda: sp.random(
        2048, 2048, density=0.03, random_state=np.random.RandomState(31),
        format="csr"),
    # genuinely scattered columns (test_banded_mv_pair_oracle, ELL part)
    "scattered_700x900": lambda: sp.random(
        700, 900, density=0.01, random_state=np.random.RandomState(9),
        format="csr"),
}


def _vectors(m, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


@pytest.mark.parametrize("M,N", [(512, 1024), (300, 471), (70, 90)])
def test_fused_matvec_plain_vs_pallas(M, N, rng):
    A = rng.standard_normal((M, N)).astype(np.float32)
    x1, x2 = _vectors(M, N)
    jop = jpk.PaddedDenseOp.create(A, bm=256, bn=256, interpret=True)
    jy, jz = jop.mv_pair(jnp.asarray(x1), jnp.asarray(x2))
    before = dict(_cuda.LAUNCHES)
    ty, tz = fused_matvec(torch.from_numpy(A), torch.from_numpy(x1),
                          torch.from_numpy(x2))
    assert _cuda.LAUNCHES == before  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ty.numpy(), A @ x1, rtol=RTOL, atol=ATOL)
    op = PaddedDenseOp.create(torch.from_numpy(A))
    py, pz = op.mv_pair(torch.from_numpy(x1), torch.from_numpy(x2))
    assert torch.equal(py, ty) and torch.equal(pz, tz)


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_pair_plain_vs_pallas(case, kind):
    A = SPARSE_CASES[case]().astype(np.float32)
    m, n = A.shape
    jcls = jse.BandedBlockOp if kind == "band" else jse.BlockedEllOp
    tcls = tse.BandedBlockOp if kind == "band" else tse.BlockedEllOp
    jop = jcls.create(A, transpose_table=False)
    top = tcls.create(A)
    x, z = _vectors(m, n)
    jy1, jy2 = jop.mv_pair(jnp.asarray(x), jnp.asarray(z))
    ty1, ty2 = top.mv_pair(torch.from_numpy(x), torch.from_numpy(z))
    for got, want, exact in ((ty1, jy1, A @ x), (ty2, jy2, A.T @ z)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), exact, rtol=RTOL, atol=ATOL)
    # the operator built from the JAX op's own tables gives the same pair
    index = np.asarray(jop.cs if kind == "band" else jop.cols)
    iop = interop.tile_op_from_numpy(kind, np.asarray(jop.blocks), index, m, n)
    iy1, iy2 = iop.mv_pair(torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_allclose(iy1.numpy(), ty1.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(iy2.numpy(), ty2.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(top.todense().numpy(), A.toarray(), atol=1e-6)


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_builders_bit_identical(case):
    A = SPARSE_CASES[case]().astype(np.float32).tocoo()
    m, n = A.shape
    args = (m, n, A.row, A.col, A.data, 128, 128)
    for jb, tb in ((jse._build_band_arrays, tse._build_band_arrays),
                   (jse._build_ell_arrays, tse._build_ell_arrays)):
        for j, t in zip(jb(*args), tb(*args)):
            assert np.array_equal(np.asarray(j), np.asarray(t))
    # transposed packing (the A' layout) too
    targs = (n, m, A.col, A.row, A.data, 128, 128)
    for j, t in zip(jse._build_ell_arrays(*targs), tse._build_ell_arrays(*targs)):
        assert np.array_equal(np.asarray(j), np.asarray(t))
    assert jse.band_span_ratio(A) == tse.band_span_ratio(A)
    assert jse.bell_storage_ratio(A) == tse.bell_storage_ratio(A)


def test_ell_padding_slots_and_counts():
    """Padding slots alias column 0 and hold zeros; from_arrays without
    counts treats every slot as stored, which gives the same pair."""
    A = sp.csr_matrix((np.ones(3), ([5, 200, 399], [7, 0, 250])),
                      shape=(400, 300)).astype(np.float32)
    op = tse.BlockedEllOp.create(A)
    same = tse.BlockedEllOp.from_arrays(op.blocks, op.cols, 400, 300)
    x, z = _vectors(400, 300, seed=2)
    for o in (op, same):
        y1, y2 = o.mv_pair(torch.from_numpy(x), torch.from_numpy(z))
        np.testing.assert_allclose(y1.numpy(), A @ x, rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(y2.numpy(), A.T @ z, rtol=RTOL, atol=1e-5)
    with pytest.raises(NotImplementedError, match="K4/K5"):
        op.mv(torch.from_numpy(x))
    with pytest.raises(NotImplementedError, match="K4/K5"):
        tse.BandedBlockOp.create(A, transpose_table=True)


def test_inverse_table_lists_each_stored_tile_once():
    cs = np.array([0, 0, 1, 2], np.int64)
    S = 3
    ptr, idx = tse.inverse_table(cs[:, None] + np.arange(S),
                                 np.ones((4, S), bool), 4 + S)
    assert ptr[-1] == 4 * S and sorted(idx.tolist()) == list(range(4 * S))
    for cb in range(4 + S):
        slots = idx[ptr[cb]:ptr[cb + 1]]
        assert all(cs[s // S] + s % S == cb for s in slots)
        assert list(slots) == sorted(slots)  # fixed (row-major) order


def test_wrappers_reject_bad_cuda_like_inputs():
    """Mixed devices never fall back to the plain version."""
    A = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_matvec(A, torch.zeros(4), torch.zeros(4))
