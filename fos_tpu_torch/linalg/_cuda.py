"""Build, load and call the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per ``csrc/*.cu`` source, all started together, then one link.
The library's name carries a hash of the sources, so an edit rebuilds it;
it lives under ``build/fos_tpu_torch/`` at the root of the checkout.
Nothing is built or loaded when the module is imported.

The launch route, the same for every kernel wrapper (:class:`Kernel`):

* a kernel is bound once to its fixed operands (the dense A, a tile table
  and its index tables), which the binder checks once; a call checks only
  its vectors (device, dtype, shape, contiguity) and raises on what the
  kernel does not take;
* every C entry point takes one argument, the address of its *launch
  record*: a host array of int64 slots (pointers, sizes, the stream last).
  The fixed slots are written when the kernel is bound; a call writes its
  vectors' and outputs' pointers and the current stream, read as a raw
  handle (``torch._C._cuda_getCurrentRawStream``, no Stream object), so a
  launch is one foreign call with one argument;
* the pair kernels' partial sums live in a scratch buffer that the
  operator allocates once; a call allocates only its outputs.

A bound kernel, its record and its scratch serve one host thread and one
stream at a time, which is how the port runs.  The free wrapper functions,
which take their fixed operands per call, keep the kernels they bound for
the last few operands (:func:`bound_kernel`), so a loop over one matrix
binds once.

``LAUNCHES`` counts, per kernel wrapper, the calls that launched the kernel
(a plain integer each).  A call made while a CUDA graph is being captured
counts once, when it puts its kernel into the graph: replays of the graph
launch the kernel again without a wrapper call.  The kernels count their
own launches on the device, replays included
(:func:`device_launch_counts`); a run reads those to show that its path
went through the kernels.

The graph entry points of ``csrc/graph.cu`` (:func:`graph_handle`,
:func:`cond_open`, :func:`cond_close`) and its condition kernels
(:func:`cg_continue`, :func:`count_continue`, :func:`flag_continue`) serve
:mod:`fos_tpu_torch.linalg.control`; they are called while a graph is
captured, not per iteration, and take a launch record made per call.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fos_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

LAUNCHES = {"fused_matvec": 0, "band_mv_pair": 0, "bell_mv_pair": 0,
            "band_mv": 0, "bell_mv": 0, "probe_tiny": 0, "probe_prefetch": 0}

#: tile side the kernels are compiled for (checked when the library loads)
TILE = 128
#: kernels the free wrapper functions keep bound (:func:`bound_kernel`)
BOUND_KEPT = 8

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def device_launch_counts(reset: bool = False) -> dict:
    """Launches of each kernel counted on the device (``csrc/common.cuh``):
    the counts that include replays of CUDA graphs.  Synchronises the
    device; ``reset`` zeroes the counts after reading them."""
    torch.cuda.synchronize()
    out = {}
    for entry, names in DEVICE_COUNTERS.items():
        counts = (ctypes.c_ulonglong * 4)()
        _record_call(entry, ctypes.addressof(counts), int(reset))
        out.update(zip(names, counts))
    return out


def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libfos_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> str:
    """Compile the library if it is missing; return nvcc's report (ptxas
    register and spill lines), or "" when the library already existed.
    Each source compiles in its own nvcc process, all at once."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                   str(Path(tmp) / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        report, failed = [], []
        for cmd, proc in jobs:
            stdout, stderr = proc.communicate()
            report.append(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = str(Path(tmp) / out.name)
        cmd = [nvcc, "-shared", "-o", lib, *(c[c.index("-o") + 1]
                                             for c, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        os.replace(lib, out)
    return "".join(report)


#: the kernels' C entry points, each taking one launch record
ENTRY_POINTS = ("fos_dense_pair", "fos_band_pair", "fos_bell_pair",
                "fos_band_mv", "fos_bell_mv", "fos_probe_tiny",
                "fos_probe_prefetch", "fos_graph_handle", "fos_graph_cond_open",
                "fos_graph_cond_close", "fos_stream_create", "fos_cg_continue",
                "fos_count_continue", "fos_flag_continue",
                "fos_pair_launch_counts", "fos_tile_mv_launch_counts",
                "fos_graph_launch_counts")

#: the kernels counted on the device, by the entry point that reads them
DEVICE_COUNTERS = {
    "fos_pair_launch_counts": ("fused_matvec", "band_mv_pair", "bell_mv_pair",
                               "fused_matvec_sum"),
    "fos_tile_mv_launch_counts": ("band_mv", "bell_mv"),
    "fos_graph_launch_counts": ("cg_continue", "count_continue",
                                "flag_continue"),
}


def library():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.fos_tile_side.restype = ctypes.c_int
        lib.fos_tile_side.argtypes = []
        lib.fos_dense_tile_rows.restype = ctypes.c_int
        lib.fos_dense_tile_rows.argtypes = []
        lib.fos_error_string.restype = ctypes.c_char_p
        lib.fos_error_string.argtypes = [ctypes.c_int]
        if lib.fos_tile_side() != TILE:
            raise RuntimeError(f"kernel library tile side differs from "
                               f"TILE={TILE}")
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = library().fos_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def operand_key(*tensors):
    """What identifies fixed operands for :func:`bound_kernel`: each
    tensor's device, dtype, address, shape and strides (None stays None)."""
    return tuple(None if t is None else
                 (t.device, t.dtype, t.data_ptr(), tuple(t.shape), t.stride())
                 for t in tensors)


_bound = collections.OrderedDict()


def bound_kernel(key, make):
    """The kernel bound for ``key`` (a name and :func:`operand_key` of the
    fixed operands, plus whatever else fixes the binding), made by
    ``make()`` the first time.  The last ``BOUND_KEPT`` are kept; a kept
    kernel holds its operands, so their addresses cannot be reused by other
    tensors while it is kept."""
    k = _bound.get(key)
    if k is None:
        k = _bound[key] = make()
        if len(_bound) > BOUND_KEPT:
            _bound.popitem(last=False)
    else:
        _bound.move_to_end(key)
    return k


class Kernel:
    """One kernel bound to its fixed operands.

    ``fixed``: the record's leading slots (pointers and sizes of operands
    the binder has checked); ``ins``: (shape, dtype) of each vector a call
    passes; ``outs``: the shapes of the f32 outputs a call allocates.  The
    record's remaining slots are the vectors, the outputs and the stream,
    in that order.  ``keep`` holds tensors whose pointers are in ``fixed``.
    """

    def __init__(self, name, entry, device, fixed, ins, outs, keep=()):
        if device.type != "cuda" or device.index is None:
            raise ValueError(f"{name}: needs an indexed CUDA device, got "
                             f"{device}")
        self.name, self.device, self.index = name, device, device.index
        self.ins = tuple((torch.Size(s), d) for s, d in ins)
        # an output shaped like an f32 input is allocated with empty_like
        # (the cheapest allocation call), others from their sizes
        like = {s: k for k, (s, d) in enumerate(self.ins)
                if d is torch.float32}
        self.outs = tuple((like.get(torch.Size(s)), tuple(s)) for s in outs)
        self.keep = keep
        self.lo = len(fixed)
        self.slots = (ctypes.c_longlong * (self.lo + len(ins) + len(outs)
                                           + 1))(*fixed)
        self.addr = ctypes.addressof(self.slots)
        self.fn = getattr(library(), entry)
        self.stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, *vectors):
        index = self.index
        for t, (shape, dtype) in zip(vectors, self.ins):
            if (t.get_device() != index or t.dtype is not dtype
                    or t.shape != shape or not t.is_contiguous()):
                self._reject(t, shape, dtype)
        outs = [torch.empty_like(vectors[k]) if k is not None else
                torch.empty(*s, dtype=torch.float32, device=self.device)
                for k, s in self.outs]
        slots, i = self.slots, self.lo
        for t in vectors:
            slots[i] = t.data_ptr()
            i += 1
        for t in outs:
            slots[i] = t.data_ptr()
            i += 1
        slots[i] = self.stream(index)
        rc = self.fn(self.addr)
        if rc:
            check(rc, self.name)
        LAUNCHES[self.name] += 1
        return outs[0] if len(outs) == 1 else outs

    def _reject(self, t, shape, dtype):
        if t.device != self.device:
            raise ValueError(f"{self.name}: a vector is on device {t.device}"
                             f", expected {self.device}")
        if t.dtype is not dtype:
            raise TypeError(f"{self.name}: a vector is {t.dtype}, expected "
                            f"{dtype}")
        if t.shape != shape:
            raise ValueError(f"{self.name}: a vector has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        raise ValueError(f"{self.name}: a vector is not contiguous")


def require_cuda_f32(name: str, device, **tensors) -> None:
    """Raise unless every tensor lies on ``device`` (a CUDA device), is
    contiguous, and is f32 (index tables: int32).  Binders run it once on
    the fixed operands."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(
                f"{name}: {key} is on device {t.device}, expected {device}")
        want = torch.int32 if key in ("cs", "cols", "counts", "inv_ptr",
                                      "inv_idx", "idx") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def require_aligned(name: str, **tensors) -> None:
    """Raise unless each tensor's data starts on a 16-byte boundary (the
    kernels load 4 floats at a time)."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")


# ------------------------------------------------------- graph entry points
def _record_call(entry: str, *slots) -> None:
    rec = (ctypes.c_longlong * len(slots))(*slots)
    check(getattr(library(), entry)(ctypes.addressof(rec)), entry)


def graph_handle(stream: int) -> int:
    """A conditional handle in the graph that ``stream`` (a raw handle) is
    capturing into."""
    out = ctypes.c_ulonglong(0)
    _record_call("fos_graph_handle", stream, ctypes.addressof(out))
    return out.value


#: conditional node kinds of :func:`cond_open`
WHILE, IF = 0, 1


def cond_open(stream: int, body_stream: int, handle: int, kind: int) -> None:
    """Add a WHILE or IF node on ``handle`` after what ``stream`` has
    captured, and start capturing its body on ``body_stream``."""
    _record_call("fos_graph_cond_open", stream, body_stream,
                 ctypes.c_longlong(handle).value, kind)


def cond_close(body_stream: int) -> None:
    """End the capture of a conditional node's body."""
    _record_call("fos_graph_cond_close", body_stream)


def stream_create() -> int:
    """A new non-blocking stream on the current device (a raw handle, never
    destroyed: the library makes one per capture level)."""
    out = ctypes.c_void_p(0)
    _record_call("fos_stream_create", ctypes.addressof(out))
    return out.value


def _current(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _scalar(t: torch.Tensor, dtype, name: str) -> int:
    if (t.device.type != "cuda" or t.dtype != dtype or t.numel() != 1):
        raise ValueError(f"{name}: expected a one-element {dtype} CUDA tensor, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def cg_continue(handle: int, rn, tol2, it, max_iters: int) -> None:
    """Set ``handle`` to ``(rn > tol2) & (it < max_iters)`` on the device
    (CG's stopping test; f32 or f64 ``rn`` and ``tol2``, int32 ``it``)."""
    if rn.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cg_continue: rn is {rn.dtype}")
    _record_call("fos_cg_continue", ctypes.c_longlong(handle).value,
                 _scalar(rn, rn.dtype, "cg_continue"),
                 _scalar(tol2, rn.dtype, "cg_continue"),
                 _scalar(it, torch.int32, "cg_continue"), int(max_iters),
                 int(rn.dtype == torch.float64), _current(rn))


#: :func:`count_continue` modes
TEST, RESET, ADVANCE = 0, 1, 2


def count_continue(handle: int, k, mode: int, limit: int, status=None,
                   want: int = 0) -> None:
    """Set ``handle`` to ``k < limit`` (and ``status == want`` when a status
    is given) after ``mode`` reset (``k = 0``) or advanced (``k += 1``) the
    int32 counter ``k`` on the device."""
    _record_call("fos_count_continue", ctypes.c_longlong(handle).value,
                 _scalar(k, torch.int32, "count_continue"), int(mode),
                 int(limit),
                 0 if status is None else _scalar(status, torch.int32,
                                                  "count_continue"),
                 int(want), _current(k))


def flag_continue(handle: int, flag, negate: bool = False) -> None:
    """Set ``handle`` to the bool ``flag`` (or its negation)."""
    _record_call("fos_flag_continue", ctypes.c_longlong(handle).value,
                 _scalar(flag, torch.bool, "flag_continue"), int(negate),
                 _current(flag))
