"""fos_tpu_torch's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors, at ragged and wide shapes, plus
bit-reproducibility, launch counting and input checks.

Needs a CUDA card (marker ``gpu``); skips without one.  Run on the card
(``--noconftest``: ``tests/conftest.py`` imports jax, which the port's
machines need not have):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: |kernel - plain| <= 2e-4 + 2e-5 |plain| (f32 sums in another
order).  This file imports no jax, so it also runs where jax is absent.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.linalg import sparse_ell as tse
from fos_tpu_torch.linalg.dense_pair import (PaddedDenseOp, fused_matvec,
                                             fused_matvec_plain)

pytestmark = pytest.mark.gpu
RTOL, ATOL = 2e-5, 2e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _close(got, want):
    for g, w in zip(got, want):
        assert bool(((g - w).abs() <= ATOL + RTOL * w.abs()).all()), (
            float((g - w).abs().max()))


def _dense(M, N, cuda):
    g = torch.Generator(device="cpu").manual_seed(M * 7919 + N)
    return (torch.randn(M, N, generator=g).to(cuda),
            torch.randn(N, generator=g).to(cuda),
            torch.randn(M, generator=g).to(cuda))


# ragged edges, one row of tiles (1x4000), one column of tiles (4000x1),
# tall and wide (many partials per output in one direction)
DENSE_SHAPES = [(1, 1), (33, 129), (300, 471), (1000, 1000), (4097, 130),
                (1, 4000), (4000, 1), (5000, 300), (300, 5000)]


@pytest.mark.parametrize("M,N", DENSE_SHAPES)
def test_fused_matvec_kernel(cuda, M, N):
    """K1 through the free function and through the operator, against the
    plain version."""
    A, x1, x2 = _dense(M, N, cuda)
    before = _cuda.LAUNCHES["fused_matvec"]
    got = fused_matvec(A, x1, x2)
    assert _cuda.LAUNCHES["fused_matvec"] == before + 1
    _close(got, fused_matvec_plain(A, x1, x2))
    again = fused_matvec(A, x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    op = PaddedDenseOp.create(A)
    _close(op.mv_pair(x1, x2), got)
    _close((op.mv(x1), op.rmv(x2)), got)


def test_dense_pair_repeats_and_interleaves(cuda):
    """100 calls give the same bits (the partial buffers are the operator's
    and are rewritten by every call), also with another operator's calls in
    between."""
    A, x1, x2 = _dense(2000, 1000, cuda)
    B, u1, u2 = _dense(333, 1000, cuda)
    opa, opb = PaddedDenseOp.create(A), PaddedDenseOp.create(B)
    first_a, first_b = opa.mv_pair(x1, x2), opb.mv_pair(u1, u2)
    for _ in range(100):
        assert all(torch.equal(a, b) for a, b in zip(opa.mv_pair(x1, x2),
                                                     first_a))
        assert all(torch.equal(a, b) for a, b in zip(opb.mv_pair(u1, u2),
                                                     first_b))
    _close(first_a, fused_matvec_plain(A, x1, x2))


def test_dense_op_takes_slices_of_the_state(cuda):
    """x1, x2 as the HSDE solve passes them: slices of one vector at any
    offset (not 16-byte aligned)."""
    A, _, _ = _dense(301, 203, cuda)
    v = torch.randn(1 + 203 + 301, device=cuda)
    x1, x2 = v[1:204], v[204:]
    op = PaddedDenseOp.create(A)
    _close(op.mv_pair(x1, x2), fused_matvec_plain(A, x1, x2))


def _banded(m, n, bw, seed):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        nz = rng.integers(1, 4)
        rows.extend([i] * nz)
        cols.extend(rng.integers(lo, hi, nz).tolist())
        vals.extend(rng.standard_normal(nz).tolist())
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()


CASES = {
    "band_1000x1200": lambda: _banded(1000, 1200, 150, 4),
    "band_1200x1000": lambda: _banded(1200, 1000, 250, 4),
    "wide_span_2048": lambda: sp.random(
        2048, 2048, density=0.03, random_state=np.random.RandomState(31)),
    "scattered_700x900": lambda: sp.random(
        700, 900, density=0.01, random_state=np.random.RandomState(9)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_pair_kernels(cuda, case, kind):
    A = CASES[case]().astype(np.float32)
    m, n = A.shape
    cls = tse.BandedBlockOp if kind == "band" else tse.BlockedEllOp
    op = cls.create(A, device=cuda)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n, dtype=np.float32), device=cuda)
    z = torch.as_tensor(rng.standard_normal(m, dtype=np.float32), device=cuda)
    key = "band_mv_pair" if kind == "band" else "bell_mv_pair"
    before = _cuda.LAUNCHES[key]
    y1, y2 = op.mv_pair(x, z)
    assert _cuda.LAUNCHES[key] == before + 1
    _close((y1.cpu(), y2.cpu()),
           (torch.from_numpy(A @ x.cpu().numpy()),
            torch.from_numpy(A.T @ z.cpu().numpy())))
    again = op.mv_pair(x, z)
    assert torch.equal(again[0], y1) and torch.equal(again[1], y2)


def test_kernels_raise_on_inputs_they_do_not_take(cuda):
    A = torch.zeros(8, 8, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fused_matvec(A, torch.zeros(8, dtype=torch.float64, device=cuda),
                     torch.zeros(8, dtype=torch.float64, device=cuda))
    A = torch.zeros(8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_matvec(A.T, torch.zeros(8, device=cuda),
                     torch.zeros(16, device=cuda))
    with pytest.raises(ValueError, match="device"):
        fused_matvec(torch.zeros(8, 8, device=cuda), torch.zeros(8),
                     torch.zeros(8, device=cuda))
    # the bound routes: fixed operands at build, vectors per call
    with pytest.raises(TypeError, match="float32"):
        PaddedDenseOp.create(torch.zeros(8, 8, dtype=torch.float64,
                                         device=cuda))
    op = PaddedDenseOp.create(torch.zeros(8, 16, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        op.mv_pair(torch.zeros(8, device=cuda), torch.zeros(8, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        op.mv_pair(torch.zeros(16, dtype=torch.float64, device=cuda),
                   torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        op.mv_pair(torch.zeros(32, device=cuda)[::2],
                   torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="device"):
        op.mv_pair(torch.zeros(16), torch.zeros(8, device=cuda))
    _, band = _ops("band_1000x1200", "band", cuda)
    with pytest.raises(ValueError, match="device"):
        band.mv_pair(torch.zeros(1200), torch.zeros(1000, device=cuda))


def _ops(case, kind, cuda):
    A = CASES[case]().astype(np.float32)
    cls = tse.BandedBlockOp if kind == "band" else tse.BlockedEllOp
    return A, cls.create(A, transpose_table=True, device=cuda)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_mv_kernels(cuda, case, kind):
    """K4/K5 over the A table (mv) and the A' table (rmv): ragged ELL rows
    (the scattered A' table), S > 8 (wide span), non-square shapes."""
    A, op = _ops(case, kind, cuda)
    m, n = A.shape
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(n, dtype=np.float32), device=cuda)
    y = torch.as_tensor(rng.standard_normal(m, dtype=np.float32), device=cuda)
    key = "band_mv" if kind == "band" else "bell_mv"
    before = _cuda.LAUNCHES[key]
    got_mv, got_rmv = op.mv(x), op.rmv(y)
    assert _cuda.LAUNCHES[key] == before + 2
    _close((got_mv.cpu(), got_rmv.cpu()),
           (torch.from_numpy(A @ x.cpu().numpy()),
            torch.from_numpy(A.T @ y.cpu().numpy())))
    assert torch.equal(op.mv(x), got_mv) and torch.equal(op.rmv(y), got_rmv)
    # against the plain versions on the same padded CUDA inputs
    if kind == "band":
        xb = op._pad(x, op._ncb() + op.blocks.shape[1], 128)
        _close((tse.band_mv(op.cs, op.blocks, xb),),
               (tse.band_mv_plain(op.cs, op.blocks, xb),))
    else:
        yb = op._pad(y, op.blocks.shape[0], 128)
        _close((tse.bell_mv(op.cols_t, op.blocks_t, yb, op.counts_t),),
               (tse.bell_mv_plain(op.cols_t, op.blocks_t, yb),))


def test_probe_kernels_bit_equal(cuda):
    from fos_tpu_torch.tools import launch_probe as lp

    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(4)).to(cuda)
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    before = dict(_cuda.LAUNCHES)
    assert torch.equal(lp.probe_tiny(x), lp.probe_tiny_plain(x))
    assert torch.equal(lp.probe_prefetch(idx, x), lp.probe_prefetch_plain(idx, x))
    assert _cuda.LAUNCHES["probe_tiny"] == before["probe_tiny"] + 1
    assert _cuda.LAUNCHES["probe_prefetch"] == before["probe_prefetch"] + 1


def test_tile_mv_raise_on_inputs_they_do_not_take(cuda):
    _, op = _ops("band_1000x1200", "band", cuda)
    xb = op._pad(torch.zeros(op.n, device=cuda), op._ncb() + op.blocks.shape[1],
                 128)
    with pytest.raises(TypeError, match="float32"):
        tse.band_mv(op.cs, op.blocks, xb.double())
    with pytest.raises(ValueError, match="device"):
        tse.band_mv(op.cs, op.blocks, xb.cpu())
    shifted = torch.zeros(xb.numel() + 1, device=cuda)[1:].view_as(xb)
    with pytest.raises(ValueError, match="aligned"):
        tse.band_mv(op.cs, op.blocks, shifted)
    _, ell = _ops("scattered_700x900", "bell", cuda)
    with pytest.raises(ValueError, match="device"):
        tse.bell_mv(ell.cols, ell.blocks, torch.zeros(ell._ncb(), 128,
                                                      device=cuda),
                    ell.counts.cpu())


def test_soc_projection_repeats_on_card(cuda):
    """The mixed SOC / rotated-SOC projection repeats bit for bit on the
    card (no atomics) and agrees with the CPU projection."""
    from fos_tpu_torch.cones import project
    from fos_tpu_torch.interop import cone_spec_from_blocks

    rng = np.random.default_rng(5)
    blocks = [("NONNEG", 7)] + [
        (("SOC", "SOC_ROTATED")[i % 2], int(d))
        for i, d in enumerate(rng.integers(3, 300, 60))]
    spec = cone_spec_from_blocks(blocks)
    x = torch.as_tensor(rng.standard_normal((3, spec.dim)) * 3.0)
    got = project(spec, x.to(cuda))
    assert torch.equal(project(spec, x.to(cuda)), got)
    np.testing.assert_allclose(got.cpu().numpy(), project(spec, x).numpy(),
                               rtol=1e-12, atol=1e-12)
