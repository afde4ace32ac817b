"""fos_tpu_torch's native tile packer (``fos_tpu_torch/native/packer.cpp``)
against its numpy versions and against the JAX package's builders.

The port's native packs must be bit-identical to the port's numpy packs
(same tile order, same duplicate-COO sums, same padding) and to the JAX
package's ``_build_band_arrays`` / ``_build_ell_arrays`` on
``tests/test_native.py``'s five cases, in both directions and for both of
its tile shapes; the native ``band_span_ratio`` / ``bell_storage_ratio``
must return the numpy versions' floats exactly.
"""

import math

import numpy as np
import pytest
import scipy.sparse as sp

from fos_tpu.linalg import sparse_ell as jse

from fos_tpu_torch import native
from fos_tpu_torch.linalg import sparse_ell as tse


def _cases():
    """tests/test_native.py's five cases."""
    yield "banded", sp.diags(
        [np.ones(500), 2.0 * np.ones(512), np.ones(308)],
        offsets=[-12, 0, 212], shape=(512, 520), format="csr",
    ).astype(np.float32)
    yield "random", sp.random(700, 330, density=0.01, format="csr",
                              random_state=3, dtype=np.float32)
    yield "empty", sp.csr_matrix((200, 400), dtype=np.float32)
    yield "tall-sliver", sp.random(2000, 40, density=0.05, format="csr",
                                   random_state=4, dtype=np.float32)
    # duplicate COO entries must SUM identically (same stable order)
    r = np.array([0, 0, 5, 129, 129, 129, 300], np.int64)
    c = np.array([3, 3, 200, 7, 7, 7, 410], np.int64)
    v = np.array([1.0, 2.5, -1.0, 0.1, 0.2, 0.4, 9.0], np.float32)
    yield "dups", sp.coo_matrix((v, (r, c)), shape=(512, 512))


CASES = dict(_cases())


def _numpy_only(mp):
    for name in ("ell_pack", "band_pack", "tile_stats"):
        mp.setattr(native, name, lambda *a, **k: None)


@pytest.fixture(scope="module")
def lib():
    lib = native.get()
    if lib is None:
        pytest.fail(f"the native packer did not build: {native.load_error()}")
    return lib


def _directions(A):
    coo = A.tocoo()
    rows = np.asarray(coo.row, np.int64)
    cols = np.asarray(coo.col, np.int64)
    vals = np.asarray(coo.data, np.float32)
    m, n = A.shape
    return ((m, n, rows, cols, vals), (n, m, cols, rows, vals))


@pytest.mark.parametrize("tile", [(128, 128), (128, 256)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_native_packs_bit_equal_numpy_and_jax(lib, monkeypatch, name, tile):
    bm, bn = tile
    for mm, nn, rr, cc, vals in _directions(CASES[name]):
        nrb = tse._pad8(math.ceil(mm / bm))
        ncb = math.ceil(nn / bn)
        nat = native.ell_pack(rr, cc, vals, nrb, ncb, bm, bn, tse._ell_kmax)
        natb = native.band_pack(rr, cc, vals, nrb, ncb, bm, bn)
        assert nat is not None and natb is not None
        ell = tse._build_ell_arrays(mm, nn, rr, cc, vals, bm, bn)
        band = tse._build_band_arrays(mm, nn, rr, cc, vals, bm, bn)
        with monkeypatch.context() as mp:
            _numpy_only(mp)
            ell_np = tse._build_ell_arrays(mm, nn, rr, cc, vals, bm, bn)
            band_np = tse._build_band_arrays(mm, nn, rr, cc, vals, bm, bn)
        ell_jax = jse._build_ell_arrays(mm, nn, rr, cc, vals, bm, bn)
        band_jax = jse._build_band_arrays(mm, nn, rr, cc, vals, bm, bn)
        for ref in (nat, ell_np, ell_jax):
            for a, b in zip(ell, ref):
                np.testing.assert_array_equal(a, b, err_msg=name)
        for ref in (natb, band_np, band_jax):
            np.testing.assert_array_equal(band[0], ref[0], err_msg=name)
            np.testing.assert_array_equal(band[1], ref[1], err_msg=name)
            assert band[2] == ref[2], name


@pytest.mark.parametrize("tile", [(128, 128), (128, 256)])
@pytest.mark.parametrize("name", sorted(CASES) + ["scattered", "wide"])
def test_native_ratios_equal_numpy_and_jax(lib, monkeypatch, name, tile):
    bm, bn = tile
    A = {"scattered": lambda: sp.random(1500, 2600, density=0.004,
                                        format="csr", random_state=9),
         "wide": lambda: sp.random(60, 3000, density=0.05, format="csr",
                                   random_state=11)}.get(name,
                                                         lambda: CASES[name])()
    got = (tse.band_span_ratio(A, bm, bn), tse.bell_storage_ratio(A, bm, bn))
    with monkeypatch.context() as mp:
        _numpy_only(mp)
        ref = (tse.band_span_ratio(A, bm, bn),
               tse.bell_storage_ratio(A, bm, bn))
    jax_ref = (jse.band_span_ratio(A, bm, bn),
               jse.bell_storage_ratio(A, bm, bn))
    assert got == ref == jax_ref, (name, got, ref, jax_ref)
    assert all(type(v) is float for v in got)


def test_ops_built_native_agree_with_scipy(lib):
    """test_native.py's operator check, on the port's operators."""
    rng = np.random.default_rng(0)
    A = sp.random(900, 700, density=0.02, format="csr", random_state=7,
                  dtype=np.float32)
    x = rng.standard_normal(700).astype(np.float32)
    y = rng.standard_normal(900).astype(np.float32)
    import torch

    for cls in (tse.BlockedEllOp, tse.BandedBlockOp):
        op = cls.create(A, transpose_table=True, device="cpu")
        np.testing.assert_allclose(op.mv(torch.from_numpy(x)).numpy(), A @ x,
                                   atol=2e-4)
        np.testing.assert_allclose(op.rmv(torch.from_numpy(y)).numpy(),
                                   A.T @ y, atol=2e-4)


def test_out_of_grid_entries_reject(lib):
    """Negative / too-large indices return None (the numpy path raises on
    them): C++ truncating division would otherwise let rows in (-bm, 0)
    alias block 0 and scatter out of bounds."""
    vals = np.ones(1, np.float32)
    for r, c in ((-1, 3), (3, -1), (10**6, 3), (3, 10**6)):
        rows = np.array([r], np.int64)
        cols = np.array([c], np.int64)
        assert native.ell_pack(rows, cols, vals, 8, 4, 128, 128,
                               tse._ell_kmax) is None
        assert native.band_pack(rows, cols, vals, 8, 4, 128, 128) is None
        assert native.tile_stats(rows, cols, 8, 4, 128, 128) is None


def test_ratios_past_the_bitmap_fall_back_to_numpy(lib):
    """A tile grid whose bitmap would pass the library's limit takes the
    numpy count, with the same floats as the JAX package's."""
    assert native.tile_stats(np.zeros(1), np.zeros(1), 1 << 17, 1 << 17,
                             1, 1) is None
    rng = np.random.default_rng(5)
    r, c = rng.integers(0, 1 << 17, (2, 40))
    A = sp.coo_matrix((rng.standard_normal(40), (r, c)),
                      shape=(1 << 17, 1 << 17))
    assert tse.band_span_ratio(A, 1, 1) == jse.band_span_ratio(A, 1, 1)
    assert tse.bell_storage_ratio(A, 1, 1) == jse.bell_storage_ratio(A, 1, 1)


def test_library_lives_under_build(lib):
    """Built from the port's own source into build/, never from or beside
    fos_tpu/native."""
    path = native.library_path()
    assert path.exists() and path.parent.name == "fos_tpu_torch"
    assert path.parent.parent.name == "build"
    assert native.SRC.parent.name == "native"
    assert native.SRC.parent.parent.name == "fos_tpu_torch"


def test_fallback_when_disabled(monkeypatch):
    """FOS_TPU_TORCH_NO_NATIVE=1 forces get() -> None and the numpy path."""
    monkeypatch.setenv("FOS_TPU_TORCH_NO_NATIVE", "1")
    assert native.get() is None
    assert native.tile_stats(np.zeros(1), np.zeros(1), 1, 1, 128, 128) is None
    A = sp.random(300, 300, density=0.02, format="csr", random_state=1,
                  dtype=np.float32)
    import torch

    op = tse.BlockedEllOp.create(A, device="cpu")
    x = np.ones(300, np.float32)
    np.testing.assert_allclose(op.mv(torch.from_numpy(x)).numpy(), A @ x,
                               atol=2e-4)
    assert tse.band_span_ratio(A) == jse.band_span_ratio(A)
