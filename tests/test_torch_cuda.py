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
from fos_tpu_torch.linalg.dense_pair import fused_matvec, fused_matvec_plain

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


@pytest.mark.parametrize("M,N", [(1, 1), (33, 129), (300, 471), (1000, 1000),
                                 (4097, 130)])
def test_fused_matvec_kernel(cuda, M, N):
    g = torch.Generator(device="cpu").manual_seed(M * 7919 + N)
    A = torch.randn(M, N, generator=g).to(cuda)
    x1 = torch.randn(N, generator=g).to(cuda)
    x2 = torch.randn(M, generator=g).to(cuda)
    before = _cuda.LAUNCHES["fused_matvec"]
    got = fused_matvec(A, x1, x2)
    assert _cuda.LAUNCHES["fused_matvec"] == before + 1
    _close(got, fused_matvec_plain(A, x1, x2))
    again = fused_matvec(A, x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


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
