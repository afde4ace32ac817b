"""The fused dense pair ``(A @ x1, A' @ x2)``: kernel K1.

:func:`fused_matvec` reads A once for both products.  On a CUDA tensor it
launches the hand-written kernel (``csrc/pair_kernels.cu``, the port of
``fos_tpu.linalg.pallas_kernels.fused_matvec``); on a CPU tensor it runs
:func:`fused_matvec_plain`, the same function in plain PyTorch.  A CUDA
input the kernel does not take (not f32, not contiguous, mixed devices)
raises; nothing falls back.

:class:`PaddedDenseOp` keeps the JAX package's name so that the counterpart
is easy to find.  It pads nothing: the kernel masks its ragged edges.
"""

from __future__ import annotations

import torch

import fos_tpu_torch.config  # noqa: F401  (pins full-f32 matmuls)
from fos_tpu_torch.linalg import _cuda


def fused_matvec_plain(A, x1, x2):
    """(A @ x1, A' @ x2) with two ``torch.matmul`` calls."""
    return torch.matmul(A, x1), torch.matmul(A.T, x2)


def fused_matvec(A, x1, x2):
    """(A @ x1, A' @ x2) from one pass over A.

    A: (M, N); x1: (N,); x2: (M,).  On the card all f32 and contiguous.
    """
    M, N = A.shape
    if tuple(x1.shape) != (N,) or tuple(x2.shape) != (M,):
        raise ValueError(
            f"fused_matvec: A {tuple(A.shape)}, x1 {tuple(x1.shape)}, "
            f"x2 {tuple(x2.shape)}")
    if all(t.device.type == "cpu" for t in (A, x1, x2)):
        return fused_matvec_plain(A, x1, x2)
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"fused_matvec: unsupported device {dev}")
    _cuda.require_cuda_f32("fused_matvec", dev, A=A, x1=x1, x2=x2)
    if M == 0 or N == 0:
        raise ValueError("fused_matvec: empty A")
    lib = _cuda.library()
    nti, ntj = -(-M // _cuda.TILE), -(-N // _cuda.TILE)
    if ntj > 65535:
        raise ValueError(f"fused_matvec: N={N} exceeds the kernel's grid")
    # outputs and the two partial buffers in one allocation
    buf = torch.empty(M + N + ntj * M + nti * N, dtype=torch.float32,
                      device=dev)
    y, z = buf[:M], buf[M:M + N]
    ypart = buf[M + N:M + N + ntj * M]
    zpart = buf[M + N + ntj * M:]
    rc = lib.fos_dense_pair(A.data_ptr(), M, N, x1.data_ptr(), x2.data_ptr(),
                            y.data_ptr(), z.data_ptr(), ypart.data_ptr(),
                            zpart.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(rc, "fused_matvec")
    _cuda.LAUNCHES["fused_matvec"] += 1
    return y, z


class PaddedDenseOp:
    """Dense A serving the fused pair through :func:`fused_matvec` and the
    single products through ``torch.matmul``; a duck-typed drop-in for the
    raw tensor in :mod:`fos_tpu_torch.linalg.hsde_ops`."""

    def __init__(self, A):
        self.A = A

    @classmethod
    def create(cls, A):
        if hasattr(A, "todense"):
            A = A.todense()
        elif isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo:
            A = A.to_dense()
        return cls(A.contiguous())

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def mv_pair(self, x1, x2):
        return fused_matvec(self.A, x1, x2)

    def mv(self, x):
        return torch.matmul(self.A, x)

    def rmv(self, y):
        return torch.matmul(self.A.T, y)

    def todense(self):
        return self.A
