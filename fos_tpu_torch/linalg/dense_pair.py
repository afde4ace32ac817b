"""The fused dense pair ``(A @ x1, A' @ x2)``: kernel K1.

:class:`DensePair` binds the hand-written kernel (``csrc/pair_kernels.cu``,
the port of ``fos_tpu.linalg.pallas_kernels.fused_matvec``) to one CUDA
matrix: A is checked once, and the kernel's partial sums are allocated
once.  A call checks its two vectors, allocates the two outputs and
launches the tile kernel and its ordered sum.  :func:`fused_matvec` takes A
per call and keeps the last few bindings (``_cuda.bound_kernel``); on a
CPU tensor it runs :func:`fused_matvec_plain`, the same function in plain
PyTorch.  A CUDA input the kernel does not take (not f32, not contiguous,
mixed devices) raises; nothing falls back.

:class:`PaddedDenseOp` keeps the JAX package's name so that the
counterpart is easy to find.  It pads nothing: the kernel masks its ragged
edges.
"""

from __future__ import annotations

import torch

import fos_tpu_torch.config  # noqa: F401  (pins full-f32 matmuls)
from fos_tpu_torch.linalg import _cuda


def fused_matvec_plain(A, x1, x2):
    """(A @ x1, A' @ x2) with two ``torch.matmul`` calls."""
    return torch.matmul(A, x1), torch.matmul(A.T, x2)


class DensePair:
    """K1 bound to one contiguous f32 CUDA matrix A (M, N):
    ``pair(x1, x2) -> (A @ x1, A' @ x2)``.  It holds the kernel's partial
    sums (one per column tile for each row of y, one per row tile for each
    column of z); ``tiles`` is the tile grid (row tiles, column tiles)."""

    def __init__(self, A):
        name = "fused_matvec"
        if A.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {A.device}")
        if A.dim() != 2:
            raise ValueError(f"{name}: A has shape {tuple(A.shape)}")
        _cuda.require_cuda_f32(name, A.device, A=A)
        M, N = A.shape
        if M == 0 or N == 0:
            raise ValueError(f"{name}: empty A")
        rows = _cuda.library().fos_dense_tile_rows()
        nti, ntj = -(-M // rows), -(-N // _cuda.TILE)
        if ntj > 65535:
            raise ValueError(f"{name}: N={N} exceeds the kernel's grid")
        self.tiles = (nti, ntj)
        self.part = torch.empty(ntj * M + nti * N, dtype=torch.float32,
                                device=A.device)
        f32 = torch.float32
        self.kernel = _cuda.Kernel(
            name, "fos_dense_pair", A.device,
            (A.data_ptr(), M, N, self.part.data_ptr()),
            ins=(((N,), f32), ((M,), f32)), outs=((M,), (N,)),
            keep=(A, self.part))

    def __call__(self, x1, x2):
        y, z = self.kernel(x1, x2)
        return y, z


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
    pair = _cuda.bound_kernel(("fused_matvec", _cuda.operand_key(A)),
                              lambda: DensePair(A))
    return pair(x1, x2)


class PaddedDenseOp:
    """Dense A serving the fused pair through K1 and the single products
    through ``torch.matmul``; a duck-typed drop-in for the raw tensor in
    :mod:`fos_tpu_torch.linalg.hsde_ops`.  On a CUDA A the kernel is bound
    when the op is made (:class:`DensePair`)."""

    def __init__(self, A):
        self.A = A
        self._pair = DensePair(A) if A.device.type == "cuda" else None

    @classmethod
    def create(cls, A):
        """Wrap A (a tensor, a sparse COO tensor or anything with
        ``todense``), made contiguous."""
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
        if self._pair is None:
            return fused_matvec_plain(self.A, x1, x2)
        return self._pair(x1, x2)

    def mv(self, x):
        return torch.matmul(self.A, x)

    def rmv(self, y):
        return torch.matmul(self.A.T, y)

    def todense(self):
        return self.A
