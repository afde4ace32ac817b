"""The fused dense pair ``(A @ x1, A' @ x2)``: kernel K1.

:class:`DensePair` binds the hand-written kernel (``csrc/pair_kernels.cu``,
the port of ``fos_tpu.linalg.pallas_kernels.fused_matvec``) to one CUDA
matrix: A is checked once, and the kernel's partial sums are allocated
once.  A call checks its two vectors, allocates the two outputs and
launches the tile kernel and its ordered sum.  ``DensePair.lanes`` is K1
over a lane axis (the line search's candidate steps): one launch of a tile
kernel that reads A once for all B lanes and one of its sum, each lane
bit-equal to a single call on its vectors.  :func:`fused_matvec` takes A
per call and keeps the last few bindings (``_cuda.bound_kernel``); on a
CPU tensor it runs :func:`fused_matvec_plain`, the same function in plain
PyTorch.  A CUDA input the kernel does not take (not f32, not contiguous,
mixed devices) raises; nothing falls back.

The pair is differentiable through :class:`DensePairFn` (a
``torch.autograd.Function``) whenever A, x1 or x2 needs a gradient or a
forward-mode tangent is live; otherwise the kernel is called directly, so
the solve's own path is unchanged.  The pair is its own adjoint: the
backward is one more K1 call, ``K1(A, gz, gy) = (A gz, A' gy)`` with its
outputs swapped, and A's cotangent ``gy x1' + x2 gz'`` is a rank-2 update
formed only when A needs it; the forward-mode rule is ``K1(A, dx1, dx2) +
K1(dA, x1, x2)``.  The TPU kernel has no derivative rule: the JAX package
differentiates its plain XLA products instead.

:class:`PaddedDenseOp` keeps the JAX package's name so that the
counterpart is easy to find.  It pads nothing: the kernel masks its ragged
edges.
"""

from __future__ import annotations

import torch

import fos_tpu_torch.config  # noqa: F401  (pins full-f32 matmuls)
from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.linalg.lanes import lane_by_lane
from fos_tpu_torch.utils.autograd import differentiated


def fused_matvec_plain(A, x1, x2):
    """(A @ x1, A' @ x2) with two ``torch.matmul`` calls."""
    return torch.matmul(A, x1), torch.matmul(A.T, x2)


def fused_matvec_lanes_plain(A, X1, X2):
    """(X1 @ A', X2 @ A) for lanes X1 (B, N), X2 (B, M): the plain pair
    lane by lane, so that lane b has the bits of a single call on lane b's
    vectors whatever the number of lanes, as the lane kernel's lanes do (a
    lane-batched ``torch.matmul`` on the CPU gives bits that depend on the
    number of lanes)."""
    return lane_by_lane(lambda u, v: fused_matvec_plain(A, u, v), X1, X2)


class DensePair:
    """K1 bound to one contiguous f32 CUDA matrix A (M, N):
    ``pair(x1, x2) -> (A @ x1, A' @ x2)``, and ``pair.lanes(X1, X2)`` over
    B lanes.  It holds the kernel's partial sums (one per column tile for
    each row of y, one per row tile for each column of z); ``tiles`` is the
    tile grid (row tiles, column tiles)."""

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
        self.shape = (M, N)
        self.part = torch.empty(ntj * M + nti * N, dtype=torch.float32,
                                device=A.device)
        f32 = torch.float32
        self.kernel = _cuda.Kernel(
            name, "fos_dense_pair", A.device,
            (A.data_ptr(), M, N, self.part.data_ptr()),
            ins=(((N,), f32), ((M,), f32)), outs=((M,), (N,)),
            keep=(A, self.part))
        # lanes at any row stride (the columns of a larger state), rows
        # unaligned: the kernel loads them a float at a time
        self.lane_kernel = _cuda.Kernel(
            f"{name}_lanes", "fos_dense_pair_lanes", A.device,
            (A.data_ptr(), M, N), ins=(((N,), f32), ((M,), f32)),
            outs=((M,), (N,)), keep=(A,), lanes=True,
            part=self.part.numel())

    def __call__(self, x1, x2):
        y, z = self.kernel(x1, x2)
        return y, z

    def lanes(self, X1, X2):
        """(X1 @ A', X2 @ A) for X1 (B, N) and X2 (B, M): one launch of the
        lane tile kernel and one of its sum.  Each lane's row has unit
        stride (the lanes may sit at any row stride, as the columns of a
        larger state do); f32 on A's device."""
        Y, Z = self.lane_kernel(X1, X2)
        return Y, Z


def _launch(A, pair, x1, x2):
    """The pair of plain tensors: the bound kernel, or on the CPU the plain
    version (never on a CUDA A)."""
    if pair is None:
        if A.device.type != "cpu":
            raise ValueError(f"fused_matvec: no kernel bound to the "
                             f"{A.device} matrix")
        return fused_matvec_plain(A, x1, x2)
    y, z = pair(x1.contiguous(), x2.contiguous())
    return y, z


class DensePairFn(torch.autograd.Function):
    """``(A @ x1, A' @ x2)`` with K1's derivative rules.

    ``pair`` is K1 bound to A (:class:`DensePair`), or None on the CPU,
    where the plain version runs.  Reverse: ``(g_x1, g_x2) = (A' gy,
    A gz)``, one K1 call; ``g_A = gy x1' + x2 gz'`` only when A needs it.
    Forward: ``K1(A, dx1, dx2) + K1(dA, x1, x2)``, the second term only
    when A carries a tangent (``dA`` binds through :func:`fused_matvec`).
    The backward goes through this Function again, so it can itself be
    differentiated."""

    @staticmethod
    def forward(A, x1, x2, pair):
        return _launch(A, pair, x1, x2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, x1, x2, pair = inputs
        ctx.pair = pair
        ctx.save_for_backward(A, x1, x2)
        ctx.save_for_forward(A, x1, x2)

    @staticmethod
    def backward(ctx, gy, gz):
        A, x1, x2 = ctx.saved_tensors
        need_A, need_1, need_2 = ctx.needs_input_grad[:3]
        g_A = g_1 = g_2 = None
        if need_1 or need_2:
            g_2, g_1 = DensePairFn.apply(A, gz, gy, ctx.pair)
        if need_A:
            g_A = torch.addr(torch.outer(gy, x1), x2, gz)
        return g_A, g_1, g_2, None

    @staticmethod
    def jvp(ctx, dA, dx1, dx2, _):
        A, x1, x2 = ctx.saved_tensors
        dy = dz = None
        if dx1 is not None or dx2 is not None:
            dy, dz = _launch(A, ctx.pair,
                             torch.zeros_like(x1) if dx1 is None else dx1,
                             torch.zeros_like(x2) if dx2 is None else dx2)
        if dA is not None:
            ey, ez = fused_matvec(dA.contiguous(), x1, x2)
            dy, dz = (ey, ez) if dy is None else (dy + ey, dz + ez)
        return dy, dz


def fused_matvec(A, x1, x2):
    """(A @ x1, A' @ x2) from one pass over A.

    A: (M, N); x1: (N,); x2: (M,).  On the card all f32 and contiguous.
    Differentiable (:class:`DensePairFn`).
    """
    M, N = A.shape
    if tuple(x1.shape) != (N,) or tuple(x2.shape) != (M,):
        raise ValueError(
            f"fused_matvec: A {tuple(A.shape)}, x1 {tuple(x1.shape)}, "
            f"x2 {tuple(x2.shape)}")
    pair = None
    if not all(t.device.type == "cpu" for t in (A, x1, x2)):
        pair = _cuda.bound_kernel(("fused_matvec", _cuda.operand_key(A)),
                                  lambda: DensePair(A))
    if differentiated(A, x1, x2):
        return DensePairFn.apply(A, x1, x2, pair)
    if pair is None:
        return fused_matvec_plain(A, x1, x2)
    return pair(x1, x2)


class PaddedDenseOp:
    """Dense A serving the fused pair through K1 and the single products
    through ``torch.matmul``; a duck-typed drop-in for the raw tensor in
    :mod:`fos_tpu_torch.linalg.hsde_ops`.  On a CUDA A the kernel is bound
    when the op is made (:class:`DensePair`).  ``mv_pair`` takes a lane
    axis (vectors (B, k): ``pair_lanes``), which goes to the lane kernel in
    one call.  It is differentiable in A, x1 and x2 (:class:`DensePairFn`,
    lane by lane); ``mv`` and ``rmv`` are ``torch.matmul``."""

    #: ``mv_pair`` takes (B, k) vectors in one call (:mod:`hsde_ops`)
    pair_lanes = True

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
        if differentiated(self.A, x1, x2):
            if x1.dim() > 1:
                return lane_by_lane(lambda u, v: DensePairFn.apply(
                    self.A, u, v, self._pair), x1, x2)
            return DensePairFn.apply(self.A, x1, x2, self._pair)
        if x1.dim() > 1:
            if self._pair is None:
                return fused_matvec_lanes_plain(self.A, x1, x2)
            return self._pair.lanes(x1, x2)
        if self._pair is None:
            return fused_matvec_plain(self.A, x1, x2)
        return self._pair(x1, x2)

    def mv(self, x):
        return torch.matmul(self.A, x)

    def rmv(self, y):
        return torch.matmul(self.A.T, y)

    def todense(self):
        return self.A
