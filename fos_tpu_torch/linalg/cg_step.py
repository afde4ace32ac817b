"""CG's iteration on the card: C1 (the masked update) and C2 (``q_mul``'s
rank-1 epilogue), the hand-written kernels of ``csrc/cg_step.cu``.

On the TPU, XLA fuses the vector work of one CG iteration into a few
fusions (``fos_tpu/linalg/cg.py:181-195`` and ``:119-131``, the rank-1
terms of ``fos_tpu/linalg/hsde_ops.py:77-91``).  Here they are two
kernels:

* :class:`CGStep` (C1) binds one CG solve's loop state, which the kernel
  updates in place: ``x``, ``r``, ``p`` (and the tracked ``Qx``), the
  per-lane ``rn`` and ``it``.  A call takes the operator's product of
  ``p`` (``w``: ``Ap = w``, ``p + w`` or ``p - w`` by ``mode``; the tracked
  CG also ``Qp``) and runs one iteration for every lane in one launch.
  With a process ``group`` (the vectors are shards) the step runs in three
  launches, the lanes' partial ``den`` and ``rn'`` all-reduced between
  them; at world size 1 that gives the fused launch's bits.  Both kernels
  sum in double, f32 data too (each dot rounded to the data's type once).
* :func:`q_rank1` (C2): ``[A'z2 + c z3, b z3 - A z1, -[c; b] . z[:n+m]]``
  from the pair's products, over one vector or lanes, with instance data
  shared or one row per instance; :func:`rank1` is the route ``q_mul``
  takes on the card (:class:`QRank1Fn` when autograd watches).

Their plain versions are where they were: ``linalg/cg.py``'s ``_cg_step``
and the tracked update, and ``hsde_ops.q_mul``'s epilogue, which run on
CPU tensors.  On CUDA tensors the wrappers launch or raise (a dtype other
than f32/f64, a tensor that needs a gradient, a lane layout that does not
flatten to one stride, a row that is not contiguous, mixed devices).
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from fos_tpu_torch.linalg import _cuda, lanes
from fos_tpu_torch.utils.autograd import differentiated

#: C1's ``mode``: how the kernel forms ``Ap`` from ``p`` and ``w``
AP_IS_W, P_PLUS_W, P_MINUS_W = 0, 1, 2
#: the geometries of ``csrc/cg_step.cu``
BLOCK, CLUSTER, MULTI = 0, 1, 2
#: C1's phases (one launch runs FUSED; a sharded step A, then B, then C)
PHASE_A, PHASE_B, PHASE_C, FUSED = 1, 2, 4, 7

_DTYPES = {torch.float32: 0, torch.float64: 1}


def takes(t: torch.Tensor) -> bool:
    """Whether CG's iteration runs here on ``t``'s device (a CUDA tensor);
    elsewhere its plain versions run."""
    return t.is_cuda


def geometry(k: int) -> dict:
    """The launch geometry the kernels take for vectors of length ``k``:
    kind (BLOCK, CLUSTER, MULTI), threads a block, blocks a lane."""
    out = (ctypes.c_longlong * 3)()
    rec = (ctypes.c_longlong * 2)(int(k), ctypes.addressof(out))
    _cuda.check(_cuda.library().fos_cg_geometry(ctypes.addressof(rec)),
                "cg_geometry")
    return {"kind": out[0], "threads": out[1], "blocks": out[2]}


def _rows(t: torch.Tensor, name: str, what: str, dtype, device):
    """(the lanes of ``t`` flattened to rows, their lane stride): ``t`` on
    ``device`` in ``dtype``, needing no gradient while autograd records
    (a Function's forward may pass leaves that require one), its last axis
    contiguous and its lane axes one stride apart."""
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
    if t.dtype is not dtype:
        raise TypeError(f"{name}: {what} is {t.dtype}, expected {dtype}")
    if t.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{name}: {what} requires grad (the kernel takes "
                         "no autograd graph)")
    if t.dim() == 0:
        raise ValueError(f"{name}: {what} is 0-dim, expected a vector")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: {what}'s rows are not contiguous "
                         f"(stride {t.stride()})")
    try:
        flat = t.view(-1, t.shape[-1]) if t.dim() > 1 else t[None]
    except RuntimeError:
        raise ValueError(f"{name}: {what}'s lanes {tuple(t.shape[:-1])} do "
                         f"not flatten to one stride ({t.stride()})") from None
    return flat, (flat.stride(0) if flat.shape[0] > 1 else 0)


def _per_lane(t: torch.Tensor, name: str, what: str, dtype, device, L: int):
    """A per-lane scalar's device pointer: ``L`` contiguous entries."""
    if (t.device != device or t.dtype is not dtype or t.numel() != L
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {what} must be {L} contiguous {dtype} "
                         f"entries on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.data_ptr()


class CGStep:
    """C1 bound to one CG solve: ``step(w, Qp=None, first=False)`` runs one
    iteration on every lane, in place.

    ``x``, ``r``, ``p`` (and ``Qx``): ``(*lanes, k)``, the loop's own
    tensors; ``rn`` (the loop's dtype) and ``it`` (int32): ``lanes``;
    ``tol2``: 0-dim or ``lanes``.  ``mode``: how ``Ap`` follows from ``p``
    and the product ``w`` handed to each call (``AP_IS_W``, ``P_PLUS_W``,
    ``P_MINUS_W``).  With lanes the step keeps the group mask: a call with
    ``first`` tests ``(rn > tol2) & (it < max_iters)`` per lane and later
    calls step only the lanes that passed (the plain loop's ``lanes.
    select``).  ``next`` holds that test after the last call (before the
    first, as computed here): the eager loop reads it instead of computing
    the test.  ``group``: the split launches with an all-reduce of each
    lane's partial sums between them."""

    NAME = "cg_step"

    def __init__(self, x, r, p, rn, it, tol2, max_iters: int, Qx=None,
                 mode: int = AP_IS_W, group=None):
        name = self.NAME
        dtype, device = r.dtype, r.device
        if device.type != "cuda":
            raise ValueError(f"{name}: needs CUDA tensors, got {device}")
        if dtype not in _DTYPES:
            raise TypeError(f"{name}: {dtype} (the kernel takes f32 and f64)")
        shape = r.shape
        self.L = L = max(1, r[..., 0].numel())
        self.k = k = shape[-1]
        slots = {}
        for key, t in (("p", p), ("r", r), ("x", x), ("Qx", Qx)):
            if t is None:
                continue
            if t.shape != shape:
                raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}"
                                 f", r {tuple(shape)}")
            flat, stride = _rows(t, name, key, dtype, device)
            slots[key] = (flat.data_ptr(), stride)
        self.shape, self.dtype, self.device = shape, dtype, device
        self.tracked = Qx is not None
        lane_axes = rn.dim() > 0
        tol_lanes = tol2.dim() > 0
        self.next = (rn > tol2) & (it < max_iters)
        self.go = (torch.empty(L, dtype=torch.bool, device=device)
                   if lane_axes else None)
        geo = geometry(k)
        self.sc = torch.empty(3 * L, dtype=dtype, device=device)
        self.part = (torch.empty(L * geo["blocks"], dtype=torch.float64,
                                 device=device)
                     if geo["kind"] == MULTI else None)
        self.group = group
        self.keep = (x, r, p, Qx, rn, it, tol2)
        rec = [_DTYPES[dtype], k, L, int(mode), int(max_iters),
               int(tol_lanes), *slots["p"], *slots["r"], *slots["x"],
               *slots.get("Qx", (0, 0)), 0, 0, 0, 0,
               _per_lane(rn, name, "rn", dtype, device, L),
               _per_lane(it, name, "it", torch.int32, device, L),
               _per_lane(tol2, name, "tol2", dtype, device,
                         L if tol_lanes else 1),
               0 if self.go is None else self.go.data_ptr(),
               self.next.data_ptr(), self.sc.data_ptr(),
               0 if self.part is None else self.part.data_ptr(), 0, 0, 0]
        self.slots = (ctypes.c_longlong * len(rec))(*rec)
        self.addr = ctypes.addressof(self.slots)
        self.fn = _cuda.library().fos_cg_step
        self.index = device.index

    def _operand(self, t, what, at):
        if t.shape != self.shape:
            raise ValueError(f"{self.NAME}: {what} has shape "
                             f"{tuple(t.shape)}, expected {tuple(self.shape)}")
        flat, stride = _rows(t, self.NAME, what, self.dtype, self.device)
        self.slots[at], self.slots[at + 1] = flat.data_ptr(), stride

    def _launch(self, first, phases):
        s = self.slots
        s[25], s[26] = int(first), phases
        s[27] = torch._C._cuda_getCurrentRawStream(self.index)
        rc = self.fn(self.addr)
        if rc:
            _cuda.check(rc, self.NAME)

    def __call__(self, w, Qp=None, first=False):
        self._operand(w, "w", 14)
        if self.tracked:
            if Qp is None:
                raise ValueError(f"{self.NAME}: the tracked step needs Qp")
            self._operand(Qp, "Qp", 16)
        if self.group is None:
            self._launch(first, FUSED)
        else:
            L = self.L
            self._launch(first, PHASE_A)
            dist.all_reduce(self.sc[:L], group=self.group)
            self._launch(False, PHASE_B)
            dist.all_reduce(self.sc[L: 2 * L], group=self.group)
            self._launch(False, PHASE_C)
        _cuda.LAUNCHES[self.NAME] += 1


_rank1_slots = None


def q_rank1(Az1, ATz2, z, b, c):
    """C2: ``[ATz2 + c z3, b z3 - Az1, -[c; b] . z[..., :n+m]]`` in one
    launch, where ``z3 = z[..., n+m]``; ``z`` ``(*lanes, n+m+1)``, ``Az1``
    ``(*lanes, m)``, ``ATz2`` ``(*lanes, n)``; ``b`` ``(*inst, m)``, ``c``
    ``(*inst, n)`` with ``inst`` empty (shared by all lanes) or leading
    ``lanes`` (one row per instance, its candidates after it)."""
    global _rank1_slots
    name = "q_rank1"
    dtype, device = z.dtype, z.device
    if device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {device}")
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: {dtype} (the kernel takes f32 and f64)")
    n, m = c.shape[-1], b.shape[-1]
    lane_shape = tuple(z.shape[:-1])
    inst = tuple(b.shape[:-1])
    if (z.shape[-1] != n + m + 1 or tuple(Az1.shape) != lane_shape + (m,)
            or tuple(ATz2.shape) != lane_shape + (n,)
            or tuple(c.shape[:-1]) != inst
            or lane_shape[: len(inst)] != inst):
        raise ValueError(f"{name}: z {tuple(z.shape)}, A z1 "
                         f"{tuple(Az1.shape)}, A'z2 {tuple(ATz2.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} do not fit")
    rows = {key: _rows(t, name, key, dtype, device)
            for key, t in (("z", z), ("A z1", Az1), ("A'z2", ATz2),
                           ("b", b), ("c", c))}
    L = rows["z"][0].shape[0]
    per = L // rows["b"][0].shape[0]
    out = torch.empty(lane_shape + (n + m + 1,), dtype=dtype, device=device)
    geo = geometry(n + m)
    part = (torch.empty(L * geo["blocks"], dtype=torch.float64,
                        device=device)
            if geo["kind"] == MULTI else None)
    if _rank1_slots is None:
        _rank1_slots = (ctypes.c_longlong * 18)()
    s = _rank1_slots
    s[0], s[1], s[2], s[3], s[4] = _DTYPES[dtype], n, m, L, per
    i = 5
    for key in ("z", "A z1", "A'z2", "b", "c"):
        flat, stride = rows[key]
        s[i], s[i + 1] = flat.data_ptr(), stride
        i += 2
    s[15] = out.data_ptr()
    s[16] = 0 if part is None else part.data_ptr()
    s[17] = torch._C._cuda_getCurrentRawStream(device.index)
    rc = _cuda.library().fos_q_rank1(ctypes.addressof(s))
    if rc:
        _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def unit_rows(t):
    """``t`` with contiguous rows (a transposed product is copied once)."""
    return t if t.shape[-1] < 2 or t.stride(-1) == 1 else t.contiguous()


def rank1(Az1, ATz2, z, b, c):
    """``q_mul``'s epilogue on the card: C2, through :class:`QRank1Fn`
    when autograd watches one of the operands."""
    Az1, ATz2 = unit_rows(Az1), unit_rows(ATz2)
    if differentiated(Az1, ATz2, z, b, c):
        return QRank1Fn.apply(Az1, ATz2, z, b, c)
    return q_rank1(Az1, ATz2, z, b, c)


def _sum_to(g, like):
    """``g`` summed over the axes that ``like`` (an instance tensor led
    against the lanes, :func:`lanes.lead`) broadcast along."""
    return g.sum_to_size(like.shape)


class QRank1Fn(torch.autograd.Function):
    """C2 with derivative rules: the epilogue is linear in ``(Az1, ATz2,
    z)`` for fixed data and bilinear in the data.  Reverse: ``g_ATz2 =
    g1``, ``g_Az1 = -g2``, ``g_z = [-g3 [c; b], c.g1 + b.g2]``, ``g_c = g1
    z3 - g3 z1``, ``g_b = g2 z3 - g3 z2`` (summed over the lanes that share
    an instance's row); forward: the same terms by the tangents.  The
    TPU's XLA differentiated its fusion; the rules are plain PyTorch on
    the saved operands."""

    @staticmethod
    def forward(Az1, ATz2, z, b, c):
        return q_rank1(*(t.detach() for t in (Az1, ATz2, z, b, c)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, g):
        Az1, ATz2, z, b, c = ctx.saved_tensors
        n, m = c.shape[-1], b.shape[-1]
        g1, g2, g3 = g[..., :n], g[..., n: n + m], g[..., n + m, None]
        z1, z2, z3 = z[..., :n], z[..., n: n + m], z[..., n + m, None]
        bl, cl = (lanes.lead(t, z) for t in (b, c))
        need = ctx.needs_input_grad
        out = [None] * 5
        if need[0]:
            out[0] = -g2
        if need[1]:
            out[1] = g1
        if need[2]:
            out[2] = torch.cat([-g3 * cl, -g3 * bl,
                                ((g1 * cl).sum(-1) + (g2 * bl).sum(-1))
                                [..., None]], -1)
        if need[3]:
            out[3] = _sum_to(g2 * z3 - g3 * z2, bl).reshape(b.shape)
        if need[4]:
            out[4] = _sum_to(g1 * z3 - g3 * z1, cl).reshape(c.shape)
        return tuple(out)

    @staticmethod
    def jvp(ctx, dAz1, dATz2, dz, db, dc):
        Az1, ATz2, z, b, c = ctx.saved_tensors
        n, m = c.shape[-1], b.shape[-1]
        z1, z2, z3 = z[..., :n], z[..., n: n + m], z[..., n + m, None]
        bl, cl = (lanes.lead(t, z) for t in (b, c))
        zeros = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        y1 = torch.zeros_like(ATz2) if dATz2 is None else dATz2
        y2 = torch.zeros_like(Az1) if dAz1 is None else -dAz1
        y3 = zeros
        if dz is not None:
            dz3 = dz[..., n + m, None]
            y1 = y1 + cl * dz3
            y2 = y2 + bl * dz3
            y3 = y3 - (cl * dz[..., :n]).sum(-1) - (bl * dz[..., n: n + m]
                                                    ).sum(-1)
        if dc is not None:
            dcl = lanes.lead(dc, z)
            y1 = y1 + dcl * z3
            y3 = y3 - (dcl * z1).sum(-1)
        if db is not None:
            dbl = lanes.lead(db, z)
            y2 = y2 + dbl * z3
            y3 = y3 - (dbl * z2).sum(-1)
        return torch.cat([y1, y2, y3[..., None]], -1)
