"""The native (C++) tile packer, loaded with ctypes.

The port's copy of ``fos_tpu.native``: ``packer.cpp`` turns COO triplets
into the tile tables of :mod:`fos_tpu_torch.linalg.sparse_ell` and counts
the tile statistics behind the format choice (``band_span_ratio``,
``bell_storage_ratio``).  It is compiled at first use with ``g++`` into
``build/fos_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of the source, so an edit rebuilds it; nothing is built or
loaded when the module is imported.  If the compiler is missing or the
build or load fails, every entry point returns None and the callers run
their numpy versions, which give bit-identical results
(``tests/test_torch_native.py``).

Set ``FOS_TPU_TORCH_NO_NATIVE=1`` to force the numpy versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from fos_tpu_torch.linalg._cuda import BUILD_DIR

SRC = Path(__file__).resolve().parent / "packer.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_load_attempted = False
_load_error: str | None = None


def library_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"_packer-{tag}.so"


def _compile_and_load():
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.build-{os.getpid()}")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)  # atomic against concurrent builders
        finally:
            tmp.unlink(missing_ok=True)
    return ctypes.CDLL(str(path))


def _declare(lib):
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p32i = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p32f = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.fos_ell_phase1.restype = i64
    lib.fos_ell_phase1.argtypes = [p64, p64, i64, i64, i64, i64, i64,
                                   p64, p64, p32i, p64]
    lib.fos_ell_fill.restype = None
    lib.fos_ell_fill.argtypes = [p64, p64, p32f, p64, p64, p32i,
                                 i64, i64, i64, i64, p32f, p32i]
    lib.fos_band_phase1.restype = i64
    lib.fos_band_phase1.argtypes = [p64, p64, i64, i64, i64, i64, i64, p64]
    lib.fos_band_fill.restype = None
    lib.fos_band_fill.argtypes = [p64, p64, p32f, i64, i64, i64, i64,
                                  p64, p32f]
    lib.fos_tile_stats.restype = i64
    lib.fos_tile_stats.argtypes = [p64, p64, i64, i64, i64, i64, i64, p64]
    return lib


def get():
    """The loaded native library, or None (compiler missing, build or load
    failed, or ``FOS_TPU_TORCH_NO_NATIVE`` set)."""
    global _lib, _load_attempted, _load_error
    if os.environ.get("FOS_TPU_TORCH_NO_NATIVE"):
        return None
    if _load_attempted:
        return _lib
    with _lock:
        if not _load_attempted:
            try:
                _lib = _declare(_compile_and_load())
            except (OSError, subprocess.SubprocessError) as e:
                # any build or load failure => the numpy versions
                _load_error = f"{type(e).__name__}: {e}"
                _lib = None
            _load_attempted = True
    return _lib


def load_error() -> str | None:
    """Why the native library is unavailable (None if loaded / not tried)."""
    return _load_error


def _as_c(rows, cols, vals=None):
    r = np.ascontiguousarray(rows, np.int64)
    c = np.ascontiguousarray(cols, np.int64)
    if vals is None:
        return r, c
    return r, c, np.ascontiguousarray(vals, np.float32)


def ell_pack(rows, cols, vals, nrb, ncb, bm, bn, kmax_of):
    """Native blocked-ELL pack; returns (blocks, cols_tab, counts) or None.

    ``kmax_of(max_count)`` maps the max per-block tile count to the padded
    kmax (the caller owns the padding policy so numpy and native paths
    cannot drift).
    """
    lib = get()
    if lib is None:
        return None
    r, c, v = _as_c(rows, cols, vals)
    nnz = r.size
    perm = np.empty(max(nnz, 1), np.int64)
    offs = np.empty(nrb + 1, np.int64)
    slot = np.empty(max(nnz, 1), np.int32)
    counts = np.empty(nrb, np.int64)
    maxc = lib.fos_ell_phase1(r, c, nnz, bm, bn, nrb, ncb,
                              perm, offs, slot, counts)
    if maxc < 0:
        return None  # out-of-grid entry: let the numpy path raise naturally
    kmax = kmax_of(int(maxc))
    blocks = np.zeros((nrb, kmax, bm, bn), np.float32)
    cols_tab = np.zeros((nrb, kmax), np.int32)
    lib.fos_ell_fill(r, c, v, perm, offs, slot, nrb, bm, bn, kmax,
                     blocks, cols_tab)
    return blocks, cols_tab, counts


def band_pack(rows, cols, vals, nrb, ncb, bm, bn):
    """Native banded-block pack; returns (blocks, lo, S) or None."""
    lib = get()
    if lib is None:
        return None
    r, c, v = _as_c(rows, cols, vals)
    nnz = r.size
    lo = np.empty(nrb, np.int64)
    S = lib.fos_band_phase1(r, c, nnz, bm, bn, nrb, ncb, lo)
    if S < 0:
        return None
    blocks = np.zeros((nrb, int(S), bm, bn), np.float32)
    lib.fos_band_fill(r, c, v, nnz, bm, bn, S, lo, blocks)
    return blocks, lo.astype(np.int32), int(S)


def tile_stats(rows, cols, nrb, ncb, bm, bn):
    """The tile statistics of a COO pattern on an (nrb, ncb) tile grid:
    ((widest window of tile columns, most distinct tiles) over the row
    blocks, the same over the column blocks), or None (no library, an
    out-of-grid entry, or a grid too large for the library's bitmap)."""
    lib = get()
    if lib is None:
        return None
    r, c = _as_c(rows, cols)
    out = np.empty(4, np.int64)
    if lib.fos_tile_stats(r, c, r.size, bm, bn, nrb, ncb, out) < 0:
        return None
    return (int(out[0]), int(out[1])), (int(out[2]), int(out[3]))
