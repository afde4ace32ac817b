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
from fos_tpu_torch.linalg.dense_pair import (PaddedDenseOp, fused_matvec,
                                             fused_matvec_lanes_plain,
                                             fused_matvec_plain)

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


@pytest.mark.parametrize("M,N", [(33, 129), (300, 471), (1000, 1000)])
def test_padded_dense_op_matches_jax(M, N, rng):
    """The port's PaddedDenseOp gives the JAX PaddedDenseOp's mv, rmv and
    mv_pair (Pallas, interpret mode, A padded to 256x256 tiles) on the same
    A at ragged shapes; so does the op carried across from the JAX op's own
    padded array by ``interop.dense_op_from_numpy``."""
    A = rng.standard_normal((M, N)).astype(np.float32)
    x1, x2 = _vectors(M, N)
    jop = jpk.PaddedDenseOp.create(A, bm=256, bn=256, interpret=True)
    jx1, jx2 = jnp.asarray(x1), jnp.asarray(x2)
    want = (*jop.mv_pair(jx1, jx2), jop.mv(jx1), jop.rmv(jx2))
    op = PaddedDenseOp.create(torch.from_numpy(A))
    iop = interop.dense_op_from_numpy(np.asarray(jop.A_pad), jop.m, jop.n,
                                      device="cpu")
    assert op.shape == iop.shape == (M, N) and iop.A.is_contiguous()
    for o in (op, iop):
        t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
        got = (*o.mv_pair(t1, t2), o.mv(t1), o.rmv(t2))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_array_equal(o.todense().numpy(), A)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("M,N", [(33, 129), (70, 90)])
def test_dense_pair_lanes_match_vmapped_pallas(B, M, N, rng):
    """K1 over a lane axis (the plain version, the single pair lane by
    lane) against ``jax.vmap`` of the JAX PaddedDenseOp's mv_pair (Pallas,
    interpret mode): one pallas_call with a lane axis in its grid, as the
    JAX package's line search runs it."""
    import jax

    A = rng.standard_normal((M, N)).astype(np.float32)
    X1 = rng.standard_normal((B, N)).astype(np.float32)
    X2 = rng.standard_normal((B, M)).astype(np.float32)
    jop = jpk.PaddedDenseOp.create(A, bm=256, bn=256, interpret=True)
    jy, jz = jax.vmap(jop.mv_pair)(jnp.asarray(X1), jnp.asarray(X2))
    op = PaddedDenseOp.create(torch.from_numpy(A))
    before = dict(_cuda.LAUNCHES)
    ty, tz = op.mv_pair(torch.from_numpy(X1), torch.from_numpy(X2))
    assert _cuda.LAUNCHES == before
    assert ty.shape == (B, M) and tz.shape == (B, N)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=RTOL,
                               atol=ATOL)
    py, pz = fused_matvec_lanes_plain(torch.from_numpy(A),
                                      torch.from_numpy(X1),
                                      torch.from_numpy(X2))
    assert torch.equal(py, ty) and torch.equal(pz, tz)


def test_hsde_mv_pair_sends_lanes_to_the_lane_entry_once(monkeypatch):
    """``hsde_ops.mv_pair`` with a lane axis on a PaddedDenseOp makes one
    call of the lane entry (not one per lane) and, on the CPU, binds and
    launches nothing; an operator whose pair takes no lanes still runs
    lane by lane.  ``q_mul``'s slices of the state (rows at a stride) go
    through the same entry."""
    from fos_tpu_torch.linalg import dense_pair, hsde_ops

    calls = []
    plain = dense_pair.fused_matvec_lanes_plain

    def spy(*args):
        calls.append(args[1].shape)
        return plain(*args)

    monkeypatch.setattr(dense_pair, "fused_matvec_lanes_plain", spy)
    g = torch.Generator().manual_seed(5)
    A = torch.randn(6, 9, generator=g)
    op = PaddedDenseOp.create(A)
    X = torch.randn(4, 9 + 6 + 1, generator=g)
    _cuda._bound.clear()
    before = dict(_cuda.LAUNCHES)
    y, z = hsde_ops.mv_pair(op, X[:, :9], X[:, 9:15])
    assert calls == [(4, 9)]
    assert _cuda.LAUNCHES == before and not _cuda._bound
    for b in range(4):   # each lane a single call's bits
        wy, wz = fused_matvec_plain(A, X[b, :9], X[b, 9:15])
        assert torch.equal(y[b], wy) and torch.equal(z[b], wz)
    q = hsde_ops.q_mul(op, X[0, 9:15], X[0, :9], X)
    assert len(calls) == 2 and q.shape == X.shape
    want = torch.stack([hsde_ops.q_mul(A, X[0, 9:15], X[0, :9], v)
                        for v in X])
    torch.testing.assert_close(q, want, rtol=1e-6, atol=1e-6)

    class PerLane:
        def __init__(self):
            self.n = 0

        def mv_pair(self, x1, x2):
            self.n += 1
            return fused_matvec_plain(A, x1, x2)

    per_lane = PerLane()
    hsde_ops.mv_pair(per_lane, X[:, :9], X[:, 9:15])
    assert per_lane.n == 4


def test_bound_kernel_cache_keeps_the_last_few():
    """The free wrappers' bindings: one per key, made once, the last
    ``BOUND_KEPT`` kept, a kept key refreshed when it is used."""
    made = []
    _cuda._bound.clear()

    def make(key):
        made.append(key)
        return object()

    keys = [("test", i) for i in range(_cuda.BOUND_KEPT + 1)]
    first = _cuda.bound_kernel(keys[0], lambda: make(keys[0]))
    for k in keys[1:-1]:
        _cuda.bound_kernel(k, lambda k=k: make(k))
    assert _cuda.bound_kernel(keys[0], lambda: make("again")) is first
    _cuda.bound_kernel(keys[-1], lambda: make(keys[-1]))  # evicts keys[1]
    assert _cuda.bound_kernel(keys[0], lambda: make("again")) is first
    _cuda.bound_kernel(keys[1], lambda: make("remade"))
    assert made == keys + ["remade"]
    _cuda._bound.clear()
    A = torch.zeros(3, 4)
    assert _cuda.operand_key(A, None) == _cuda.operand_key(A.view(3, 4), None)
    assert _cuda.operand_key(A) != _cuda.operand_key(A.T)


def test_free_wrappers_on_cpu_run_plain_and_bind_nothing():
    """On CPU tensors the free wrappers are their plain versions: the same
    results, and no kernel bound (no library is loaded)."""
    g = torch.Generator().manual_seed(8)
    A, x1, x2 = (torch.randn(5, 7, generator=g), torch.randn(7, generator=g),
                 torch.randn(5, generator=g))
    blocks = torch.randn(2, 2, 128, 128, generator=g)
    cs = torch.tensor([0, 1], dtype=torch.int32)
    cols = torch.tensor([[0, 2], [1, 2]], dtype=torch.int32)
    counts = torch.tensor([2, 2], dtype=torch.int32)
    xb, zb = torch.randn(3, 128, generator=g), torch.randn(2, 128, generator=g)
    _cuda._bound.clear()
    pairs = [(fused_matvec(A, x1, x2), fused_matvec_plain(A, x1, x2)),
             (tse.band_mv_pair(cs, blocks, xb, zb),
              tse.band_mv_pair_plain(cs, blocks, xb, zb)),
             (tse.bell_mv_pair(cols, blocks, xb, zb),
              tse.bell_mv_pair_plain(cols, blocks, xb, zb)),
             ((tse.band_mv(cs, blocks, xb),),
              (tse.band_mv_plain(cs, blocks, xb),)),
             ((tse.bell_mv(cols, blocks, xb, counts),),
              (tse.bell_mv_plain(cols, blocks, xb),))]
    for got, want in pairs:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not _cuda._bound and _cuda._lib is None


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_pair_plain_vs_pallas(case, kind):
    A = SPARSE_CASES[case]().astype(np.float32)
    m, n = A.shape
    jcls = jse.BandedBlockOp if kind == "band" else jse.BlockedEllOp
    tcls = tse.BandedBlockOp if kind == "band" else tse.BlockedEllOp
    jop = jcls.create(A, transpose_table=False)
    top = tcls.create(A, device="cpu")
    x, z = _vectors(m, n)
    jy1, jy2 = jop.mv_pair(jnp.asarray(x), jnp.asarray(z))
    ty1, ty2 = top.mv_pair(torch.from_numpy(x), torch.from_numpy(z))
    for got, want, exact in ((ty1, jy1, A @ x), (ty2, jy2, A.T @ z)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), exact, rtol=RTOL, atol=ATOL)
    # the operator built from the JAX op's own tables gives the same pair
    index = np.asarray(jop.cs if kind == "band" else jop.cols)
    iop = interop.tile_op_from_numpy(kind, np.asarray(jop.blocks), index, m, n,
                                     device="cpu")
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
    counts treats every slot as stored, which gives the same pair and the
    same single products.  rmv needs the A' table."""
    A = sp.csr_matrix((np.ones(3), ([5, 200, 399], [7, 0, 250])),
                      shape=(400, 300)).astype(np.float32)
    op = tse.BlockedEllOp.create(A, device="cpu")
    same = tse.BlockedEllOp.from_arrays(op.blocks, op.cols, 400, 300,
                                        transpose_table=True, device="cpu")
    x, z = _vectors(400, 300, seed=2)
    for o in (op, same):
        y1, y2 = o.mv_pair(torch.from_numpy(x), torch.from_numpy(z))
        np.testing.assert_allclose(y1.numpy(), A @ x, rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(y2.numpy(), A.T @ z, rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(o.mv(torch.from_numpy(x)).numpy(), A @ x,
                                   rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(same.rmv(torch.from_numpy(z)).numpy(), A.T @ z,
                               rtol=RTOL, atol=1e-5)
    with pytest.raises(TypeError, match="transpose_table=False"):
        op.rmv(torch.from_numpy(z))
    band = tse.BandedBlockOp.create(A, transpose_table=True, device="cpu")
    np.testing.assert_allclose(band.rmv(torch.from_numpy(z)).numpy(), A.T @ z,
                               rtol=RTOL, atol=1e-5)


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
