"""Build, load and call the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library's name carries a hash of the sources, so an edit rebuilds it; it
lives under ``build/fos_tpu_torch/`` at the root of the checkout.  Nothing
is built or loaded when the module is imported.

``LAUNCHES`` counts, per kernel wrapper, the calls that launched the kernel
(a plain integer each); a run reads it to show that its path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fos_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

LAUNCHES = {"fused_matvec": 0, "band_mv_pair": 0, "bell_mv_pair": 0}

#: tile side the kernels are compiled for (checked when the library loads)
TILE = 128

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpair_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> str:
    """Compile the library if it is missing; return nvcc's report (ptxas
    register and spill lines), or "" when the library already existed."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def library():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fos_tile_side.restype = I
        lib.fos_tile_side.argtypes = []
        lib.fos_error_string.restype = ctypes.c_char_p
        lib.fos_error_string.argtypes = [I]
        lib.fos_dense_pair.restype = I
        lib.fos_dense_pair.argtypes = [P, I, I, P, P, P, P, P, P, P]
        lib.fos_band_pair.restype = I
        lib.fos_band_pair.argtypes = [P, P, I, I, P, P, P, P, P, P, P, P, I, P]
        if lib.fos_tile_side() != TILE:
            raise RuntimeError("kernel library tile side != 128")
        lib.fos_bell_pair.restype = I
        lib.fos_bell_pair.argtypes = [P, P, P, I, I, P, P, P, P, P, P, P, P,
                                      I, P]
        _lib = lib
    return _lib


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = library().fos_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def require_cuda_f32(name: str, device, **tensors) -> None:
    """Raise unless every tensor lies on ``device`` (a CUDA device), is
    contiguous, and is f32 (index tables: int32)."""
    import torch

    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(
                f"{name}: {key} is on device {t.device}, expected {device}")
        want = torch.int32 if key in ("cs", "cols", "counts", "inv_ptr",
                                      "inv_idx") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
