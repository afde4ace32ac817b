"""fos_tpu_torch's single-product tile kernels K4/K5 (their plain PyTorch
versions, which the wrappers run on CPU tensors) against the JAX package's
``op.mv``/``op.rmv`` (Pallas in interpret mode), the A' tables against the
JAX builders, and the launch-probe kernels P1/P2's plain versions.

Tolerance: rtol=2e-5, atol=2e-4 in f32, the JAX sparse tests' own (f32
sums taken in another order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from fos_tpu.linalg import sparse_ell as jse

from fos_tpu_torch import interop
from fos_tpu_torch.linalg import _cuda, hsde_ops
from fos_tpu_torch.linalg import sparse_ell as tse
from fos_tpu_torch.tools import launch_probe

from test_torch_kernels import SPARSE_CASES

RTOL, ATOL = 2e-5, 2e-4

CASES = dict(SPARSE_CASES)
# test_sparse.py::test_bell_empty_rows_and_tall: empty rows and columns
CASES["empty_rows_400x300"] = lambda: sp.csr_matrix(
    (np.ones(3), ([5, 200, 399], [7, 0, 250])), shape=(400, 300))
# test_sparse.py::test_bell_matches_scipy_0001_density: the reference's
# sparse oracle point
CASES["oracle_1000x2000"] = lambda: sp.random(
    1000, 2000, density=0.001, random_state=np.random.RandomState(5),
    format="csr")
# test_sparse.py::test_duplicate_coo_entries_sum: duplicates sum
CASES["duplicates_4x4"] = lambda: sp.coo_matrix(
    (np.array([1.0, 2.0, 0.5]), ([0, 0, 1], [0, 0, 2])), shape=(4, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _vectors(m, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


def _pair(kind):
    return ((jse.BandedBlockOp, tse.BandedBlockOp) if kind == "band"
            else (jse.BlockedEllOp, tse.BlockedEllOp))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_mv_plain_vs_pallas(case, kind):
    A = CASES[case]().astype(np.float32)
    m, n = A.shape
    jcls, tcls = _pair(kind)
    jop = jcls.create(A)                    # JAX packs the A' table too
    top = tcls.create(A, transpose_table=True, device="cpu")
    x, y = _vectors(m, n)
    before = dict(_cuda.LAUNCHES)
    got_mv = top.mv(torch.from_numpy(x)).numpy()
    got_rmv = top.rmv(torch.from_numpy(y)).numpy()
    assert _cuda.LAUNCHES == before  # a CPU tensor never reaches the kernel
    dense = A.toarray()
    for got, want, exact in ((got_mv, jop.mv(jnp.asarray(x)), dense @ x),
                             (got_rmv, jop.rmv(jnp.asarray(y)), dense.T @ y)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL)
    # an operator built from the JAX op's own A and A' tables gives the
    # same products (the JAX banded tables carry S padded to 8 past 8)
    index = np.asarray(jop.cs if kind == "band" else jop.cols)
    index_t = np.asarray(jop.cs_t if kind == "band" else jop.cols_t)
    iop = interop.tile_op_from_numpy(
        kind, np.asarray(jop.blocks), index, m, n, device="cpu",
        blocks_t=np.asarray(jop.blocks_t), index_t=index_t)
    np.testing.assert_allclose(iop.mv(torch.from_numpy(x)).numpy(), got_mv,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(iop.rmv(torch.from_numpy(y)).numpy(), got_rmv,
                               rtol=RTOL, atol=ATOL)
    # (I + AA') lam goes through mv and rmv, as the JAX package's does
    lam = torch.from_numpy(y)
    np.testing.assert_allclose(
        hsde_ops.kkt_normal_mul(top, lam).numpy(),
        y + dense @ (dense.T @ y), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_transposed_tables_bit_identical(case):
    """The A' tables: create packs them with the JAX builders' layout, and
    from_arrays(transpose_table=True) packs the same bits from the A table
    alone."""
    A = CASES[case]().astype(np.float32).tocoo()
    m, n = A.shape
    targs = (n, m, A.col, A.row, A.data, 128, 128)
    jband, jcs_t, _ = jse._build_band_arrays(*targs)
    jell, jcols_t, jcounts_t = jse._build_ell_arrays(*targs)
    band = tse.BandedBlockOp.create(A, transpose_table=True, device="cpu")
    ell = tse.BlockedEllOp.create(A, transpose_table=True, device="cpu")
    for got, want in ((band.blocks_t, jband), (band.cs_t, jcs_t),
                      (ell.blocks_t, jell), (ell.cols_t, jcols_t),
                      (ell.counts_t, jcounts_t)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    band2 = tse.BandedBlockOp.from_arrays(band.blocks, band.cs, m, n,
                                          transpose_table=True, device="cpu")
    ell2 = tse.BlockedEllOp.from_arrays(ell.blocks, ell.cols, m, n,
                                        counts=ell.counts,
                                        transpose_table=True, device="cpu")
    for a, b in ((band2.blocks_t, band.blocks_t), (band2.cs_t, band.cs_t),
                 (ell2.blocks_t, ell.blocks_t), (ell2.cols_t, ell.cols_t),
                 (ell2.counts_t, ell.counts_t)):
        assert torch.equal(a, b)
    dense = A.toarray()
    for op in (band2, ell2):
        np.testing.assert_array_equal(op.todense().numpy(), dense)


def test_transpose_from_chip_tables():
    """chip_smoke's tables (edge tiles zeroed, random scattered columns):
    the A' table packed from the tiles equals the one create packs from the
    same matrix as scipy COO."""
    import chip_smoke

    for kind, (blk, index, _) in (("band", chip_smoke.banded_tables(nrb=8)),
                                  ("bell", chip_smoke.scattered_tables(nrb=8))):
        cls = tse.BandedBlockOp if kind == "band" else tse.BlockedEllOp
        op = cls.from_arrays(blk, index, 1024, 1024, transpose_table=True,
                             device="cpu")
        ref = cls.create(sp.coo_matrix(op.todense().numpy()),
                         transpose_table=True, device="cpu")
        assert torch.equal(op.blocks_t, ref.blocks_t)
        assert torch.equal(op.cs_t if kind == "band" else op.cols_t,
                           ref.cs_t if kind == "band" else ref.cols_t)


def test_rmv_needs_the_transpose_table():
    A = CASES["band_512"]().astype(np.float32)
    for cls in (tse.BlockedEllOp, tse.BandedBlockOp):
        op = cls.create(A, device="cpu")
        with pytest.raises(TypeError, match=f"rebuild with {cls.__name__}"):
            op.rmv(torch.zeros(512))
    # a given A' table is checked like the A table
    with pytest.raises(ValueError, match="cs_t"):
        tse.BandedBlockOp.from_arrays(op.blocks, op.cs, 512, 512,
                                      device="cpu", blocks_t=op.blocks,
                                      cs_t=np.full(op.blocks.shape[0], 99))


def test_probe_plain_versions():
    """P1/P2's plain versions: one f32 rounding of x * 1.0000001, the
    operand of P2 not read; CPU tensors never reach the kernels."""
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(1))
    idx = torch.arange(8, dtype=torch.int32)
    before = dict(_cuda.LAUNCHES)
    want = torch.from_numpy(x.numpy() * np.float32(1.0000001))
    assert torch.equal(launch_probe.probe_tiny(x), want)
    assert torch.equal(launch_probe.probe_prefetch(idx, x), want)
    assert _cuda.LAUNCHES == before


def test_tile_wrappers_reject_non_cuda_devices():
    """Mixed or non-CUDA devices never fall back to the plain version."""
    blocks = torch.zeros(2, 1, 128, 128, device="meta")
    with pytest.raises(ValueError, match="device"):
        tse.band_mv(torch.zeros(2, dtype=torch.int32), blocks,
                    torch.zeros(3, 128))
    with pytest.raises(ValueError, match="device"):
        tse.bell_mv(torch.zeros(2, 1, dtype=torch.int32), blocks,
                    torch.zeros(3, 128), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        launch_probe.probe_prefetch(torch.zeros(8, dtype=torch.int32),
                                    torch.zeros(8, 128, device="meta"))
