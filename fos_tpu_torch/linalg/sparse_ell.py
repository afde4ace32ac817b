"""Sparse A as a table of dense 128x128 tiles, with fused pair kernels.

A sparse A is cut into (bm, bn) = (128, 128) tiles and only the tiles that
hold nonzeros are stored, in one of two layouts:

* :class:`BandedBlockOp`: row block r stores the contiguous window of tile
  columns ``[cs[r], cs[r] + S)``, so A x reads one contiguous slice of x;
* :class:`BlockedEllOp`: row block r stores up to ``kmax`` tiles with their
  block columns in ``cols[r]``; padding slots alias column 0 and hold zeros.

``mv_pair`` computes ``(A @ x, A' @ z)`` from ONE read of the tile table,
which is all the HSDE solve needs (the A' table is never packed).  On a
CUDA tensor it launches the hand-written kernels K2
(:func:`band_mv_pair`, the port of ``fos_tpu.linalg.sparse_ell.
_band_mv_pair``) and K3 (:func:`bell_mv_pair`, of ``_bell_mv_pair``); on a
CPU tensor the plain PyTorch versions beside them.  The kernels sum the
transposed products of each column block in a fixed order, listed by an
inverse table that ``create``/``from_arrays`` build once on the host.

The host builders are numpy and produce tables bit-identical to the JAX
package's.  Standalone ``mv``/``rmv`` need the single-product kernels K4
and K5, which are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fos_tpu_torch.linalg import _cuda

_K45 = ("standalone mv/rmv need kernels K4/K5 (_band_mv, _bell_mv), not "
        "ported yet: ROADMAP queue 2; use mv_pair")


# ------------------------------------------------------------ host builders
def _pad8(nb: int) -> int:
    """Block-grid rows padded to a multiple of 8 when there are more than 8
    (the JAX package's table layout, kept so the tables match it)."""
    return ((nb + 7) // 8) * 8 if nb > 8 else nb


def _ell_kmax(max_count: int) -> int:
    """Tile-slot count per block row: at least 1, padded to a multiple of 8
    past 8."""
    return _pad8(max(max_count, 1))


def _coo_parts(A):
    """(rows, cols, vals, m, n) of a scipy.sparse matrix."""
    if not hasattr(A, "tocoo"):
        raise TypeError(f"expected a scipy.sparse matrix, got {type(A)}")
    coo = A.tocoo()
    return (np.asarray(coo.row), np.asarray(coo.col), np.asarray(coo.data),
            *A.shape)


def _build_ell_arrays(m, n, rows, cols, vals, bm, bn):
    """Pack COO triplets into blocked-ELL arrays: (blocks, cols, counts)."""
    nrb = _pad8(math.ceil(m / bm))
    ncb = math.ceil(n / bn)
    ti = rows // bm
    tj = cols // bn
    pair = ti.astype(np.int64) * ncb + tj
    upair, inv = np.unique(pair, return_inverse=True)
    uti = (upair // ncb).astype(np.int64)
    utj = (upair % ncb).astype(np.int64)
    counts = np.bincount(uti, minlength=nrb)
    kmax = _ell_kmax(int(counts.max()) if counts.size else 0)
    row_start = np.zeros(nrb + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    slot = np.arange(upair.size) - row_start[uti]

    blocks = np.zeros((nrb, kmax, bm, bn), np.float32)
    cols_tab = np.zeros((nrb, kmax), np.int32)
    cols_tab[uti, slot] = utj.astype(np.int32)
    # duplicate COO entries sum
    np.add.at(blocks, (uti[inv], slot[inv], rows - ti * bm, cols - tj * bn),
              vals)
    return blocks, cols_tab, counts


def _build_band_arrays(m, n, rows, cols, vals, bm, bn):
    """Pack COO triplets into banded arrays: (blocks, cs, S), where row
    block i holds the tile-column window [cs_i, cs_i + S)."""
    nrb = _pad8(math.ceil(m / bm))
    ti = rows // bm
    tj = cols // bn
    lo = np.full(nrb, np.iinfo(np.int64).max, np.int64)
    hi = np.full(nrb, -1, np.int64)
    if rows.size:
        np.minimum.at(lo, ti, tj)
        np.maximum.at(hi, ti, tj)
    lo = np.where(hi >= 0, lo, 0)
    S = max(int((hi - lo + 1).max()) if rows.size else 1, 1)
    blocks = np.zeros((nrb, S, bm, bn), np.float32)
    if rows.size:
        np.add.at(blocks, (ti, tj - lo[ti], rows - ti * bm, cols - tj * bn),
                  vals)
    return blocks, lo.astype(np.int32), S


def band_span_ratio(A, bm=128, bn=128) -> float:
    """Banded storage (of A and of A') relative to blocked-ELL storage:
    1.0 when every row block's tiles are contiguous, large when columns
    scatter across the row."""
    rows, cols, _, m, n = _coo_parts(A)
    if rows.size == 0:
        return 1.0

    def one(r, c, mm, br, bc):
        nrb = _pad8(math.ceil(mm / br))
        ti = r // br
        tj = c // bc
        lo = np.full(nrb, np.iinfo(np.int64).max, np.int64)
        hi = np.full(nrb, -1, np.int64)
        np.minimum.at(lo, ti, tj)
        np.maximum.at(hi, ti, tj)
        span = int(np.where(hi >= 0, hi - lo + 1, 0).max())
        ncb_tiles = int(tj.max()) + 1
        upair = np.unique(ti.astype(np.int64) * ncb_tiles + tj)
        cnt = int(np.bincount(upair // ncb_tiles, minlength=nrb).max())
        return span / max(cnt, 1)

    return max(one(rows, cols, m, bm, bn), one(cols, rows, n, bn, bm))


def bell_storage_ratio(A, bm=128, bn=128) -> float:
    """Padded blocked-ELL storage (A and A' layouts) relative to one dense
    copy, from the index pattern alone."""
    rows, cols, _, m, n = _coo_parts(A)
    nrb = _pad8(math.ceil(m / bm))
    ncb = _pad8(math.ceil(n / bn))
    ti = rows // bm
    tj = cols // bn
    pair = ti.astype(np.int64) * ncb + tj
    upair = np.unique(pair)
    kmax = int(np.bincount(upair // ncb, minlength=nrb).max()) if upair.size else 1
    kmax_t = int(np.bincount(upair % ncb, minlength=ncb).max()) if upair.size else 1
    return ((nrb * kmax + ncb * kmax_t) * bm * bn) / float(m * n)


def inverse_table(col_of_slot, valid, ncb_out):
    """(inv_ptr, inv_idx) int32: for each output column block, the flat
    slots (row block major) whose tile lands there, in slot order."""
    col = np.asarray(col_of_slot, np.int64).ravel()
    slots = np.flatnonzero(np.asarray(valid, bool).ravel())
    col = col[slots]
    order = np.argsort(col, kind="stable")
    ptr = np.zeros(ncb_out + 1, np.int64)
    np.cumsum(np.bincount(col, minlength=ncb_out), out=ptr[1:])
    return ptr.astype(np.int32), slots[order].astype(np.int32)


# --------------------------------------------------------------- K2 and K3
def band_mv_pair_plain(cs, blocks, xb, zb):
    """Plain PyTorch K2: cs (nrb,); blocks (nrb, S, bm, bn); xb (ncb+S, bn);
    zb (nrb, bm) -> (y1 (nrb, bm) = A x, y2 (ncb+S, bn) = A' z)."""
    S = blocks.shape[1]
    win = cs.long()[:, None] + torch.arange(S, device=cs.device)
    return _tile_pair_plain(blocks, win, xb, zb)


def _tile_pair_plain(blocks, col, xb, zb):
    """Batched tile products of both plain versions: ``col`` (nrb, slots)
    is each tile's block column."""
    y1 = torch.matmul(blocks, xb[col].unsqueeze(-1)).squeeze(-1).sum(1)
    pt = torch.matmul(zb[:, None, None, :], blocks).squeeze(-2)
    y2 = xb.new_zeros(xb.shape).index_add_(0, col.reshape(-1),
                                           pt.reshape(-1, pt.shape[-1]))
    return y1, y2


def bell_mv_pair_plain(cols, blocks, xb, zb):
    """Plain PyTorch K3: cols (nrb, kmax); blocks (nrb, kmax, bm, bn);
    xb (ncb, bn); zb (nrb, bm) -> (y1 (nrb, bm), y2 (ncb, bn)).  Padding
    slots alias column 0 and hold zero tiles."""
    return _tile_pair_plain(blocks, cols.long(), xb, zb)


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _tile_launch_checks(name, blocks, xb, zb, tables):
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if tables is None:
        raise ValueError(f"{name}: the kernel needs the (inv_ptr, inv_idx) "
                         "inverse table of the operator")
    _cuda.require_cuda_f32(name, dev, blocks=blocks, xb=xb, zb=zb, **tables)
    side = _cuda.TILE
    if tuple(blocks.shape[2:]) != (side, side):
        raise ValueError(f"{name}: tiles must be {side}x{side}, got "
                         f"{tuple(blocks.shape[2:])}")
    nrb = blocks.shape[0]
    if tuple(zb.shape) != (nrb, side) or xb.shape[1] != side:
        raise ValueError(f"{name}: xb {tuple(xb.shape)} / zb "
                         f"{tuple(zb.shape)} do not fit the table")
    return dev


def _outputs(nrb, slots, ncb_out, dev):
    """y1 (nrb, T), y2 (ncb_out, T) and the partials y1part, y2part
    (nrb, slots, T), T = 128, carved from one allocation."""
    T = _cuda.TILE
    buf = torch.empty((nrb + ncb_out + 2 * nrb * slots) * T,
                      dtype=torch.float32, device=dev)
    sizes = (nrb * T, ncb_out * T, nrb * slots * T, nrb * slots * T)
    y1, y2, p1, p2 = torch.split(buf, sizes)
    return (y1.view(nrb, T), y2.view(ncb_out, T), p1.view(nrb, slots, T),
            p2.view(nrb, slots, T))


def band_mv_pair(cs, blocks, xb, zb, inverse=None):
    """K2: ``(A @ x, A' @ z)`` over a banded tile table, in one read of it.
    ``inverse`` is the operator's ``(inv_ptr, inv_idx)`` (needed on the
    card only)."""
    if _on_cpu(cs, blocks, xb, zb):
        return band_mv_pair_plain(cs, blocks, xb, zb)
    tables = None if inverse is None else dict(
        cs=cs, inv_ptr=inverse[0], inv_idx=inverse[1])
    dev = _tile_launch_checks("band_mv_pair", blocks, xb, zb, tables)
    nrb, S = blocks.shape[:2]
    ncb_out = xb.shape[0]
    if inverse[0].shape[0] != ncb_out + 1 or cs.shape != (nrb,):
        raise ValueError("band_mv_pair: index tables do not fit the table")
    y1, y2, y1part, y2part = _outputs(nrb, S, ncb_out, dev)
    lib = _cuda.library()
    rc = lib.fos_band_pair(blocks.data_ptr(), cs.data_ptr(), nrb, S,
                           xb.data_ptr(), zb.data_ptr(), y1.data_ptr(),
                           y2.data_ptr(), y1part.data_ptr(), y2part.data_ptr(),
                           inverse[0].data_ptr(), inverse[1].data_ptr(),
                           ncb_out, _cuda.stream_ptr(dev))
    _cuda.check(rc, "band_mv_pair")
    _cuda.LAUNCHES["band_mv_pair"] += 1
    return y1, y2


def bell_mv_pair(cols, blocks, xb, zb, counts=None, inverse=None):
    """K3: ``(A @ x, A' @ z)`` over a blocked-ELL tile table, in one read of
    it.  ``counts`` (stored tiles per row block) and ``inverse`` are the
    operator's tables (needed on the card only)."""
    if _on_cpu(cols, blocks, xb, zb):
        return bell_mv_pair_plain(cols, blocks, xb, zb)
    tables = None if inverse is None or counts is None else dict(
        cols=cols, counts=counts, inv_ptr=inverse[0], inv_idx=inverse[1])
    dev = _tile_launch_checks("bell_mv_pair", blocks, xb, zb, tables)
    nrb, kmax = blocks.shape[:2]
    ncb_out = xb.shape[0]
    if (inverse[0].shape[0] != ncb_out + 1 or cols.shape != (nrb, kmax)
            or counts.shape != (nrb,)):
        raise ValueError("bell_mv_pair: index tables do not fit the table")
    y1, y2, y1part, y2part = _outputs(nrb, kmax, ncb_out, dev)
    lib = _cuda.library()
    rc = lib.fos_bell_pair(blocks.data_ptr(), cols.data_ptr(),
                           counts.data_ptr(), nrb, kmax, xb.data_ptr(),
                           zb.data_ptr(), y1.data_ptr(), y2.data_ptr(),
                           y1part.data_ptr(), y2part.data_ptr(),
                           inverse[0].data_ptr(),
                           inverse[1].data_ptr(), ncb_out,
                           _cuda.stream_ptr(dev))
    _cuda.check(rc, "bell_mv_pair")
    _cuda.LAUNCHES["bell_mv_pair"] += 1
    return y1, y2


# ---------------------------------------------------------------- operators
def _tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.array(a)).to(dtype=dtype, device=device)


def _reject_transpose_table(transpose_table):
    if transpose_table:
        raise NotImplementedError(
            "transpose_table=True serves standalone rmv, which needs kernel "
            "K4/K5: not ported yet (ROADMAP queue 2)")


class _TileOp:
    """What the two layouts share: shape, padding of x and z, and the
    standalone products that are not ported."""

    bm = bn = 128

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    def _ncb(self) -> int:
        """Column-block count: the _pad8 formula of the table builder."""
        return _pad8(math.ceil(self.n / self.bn))

    def _pad(self, v, nblocks, width):
        out = v.new_zeros(nblocks * width)
        out[: v.shape[0]] = v
        return out.reshape(nblocks, width)

    def mv(self, x):
        raise NotImplementedError(_K45)

    def rmv(self, y):
        raise NotImplementedError(_K45)


class BandedBlockOp(_TileOp):
    """Banded tile table: row block r holds tile columns [cs[r], cs[r]+S)."""

    def __init__(self, blocks, cs, m, n, inv_ptr, inv_idx):
        self.blocks = blocks        # (nrb, S, bm, bn) f32
        self.cs = cs                # (nrb,) int32 first tile column
        self.m = m
        self.n = n
        self.inv_ptr = inv_ptr      # (ncb + S + 1,) int32
        self.inv_idx = inv_idx      # (nrb * S,) int32

    @classmethod
    def create(cls, A, *, transpose_table=False, device=None):
        """Pack a scipy.sparse matrix (the A' table is never packed: the
        pair computes A'z from the A table)."""
        _reject_transpose_table(transpose_table)
        rows, cols, vals, m, n = _coo_parts(A)
        blocks, cs, _ = _build_band_arrays(m, n, rows, cols,
                                           vals.astype(np.float32),
                                           cls.bm, cls.bn)
        return cls.from_arrays(blocks, cs, m, n, device=device)

    @classmethod
    def from_arrays(cls, blocks, cs, m, n, *, device=None):
        """Wrap a tile table (numpy or tensors): blocks (nrb, S, 128, 128),
        cs (nrb,); the inverse table is built here, on the host."""
        nrb, S = blocks.shape[:2]
        ncb = _pad8(math.ceil(n / cls.bn))
        cs_h = (cs.cpu().numpy() if isinstance(cs, torch.Tensor)
                else np.asarray(cs)).astype(np.int64)
        if tuple(blocks.shape[2:]) != (cls.bm, cls.bn) or cs_h.shape != (nrb,):
            raise ValueError(f"tables {tuple(blocks.shape)} / {cs_h.shape}")
        if nrb * cls.bm < m or (cs_h.size and not (0 <= cs_h.min()
                                                   and cs_h.max() <= ncb)):
            raise ValueError("banded tables do not cover A / windows leave x")
        ptr, idx = inverse_table(cs_h[:, None] + np.arange(S),
                                 np.ones((nrb, S), bool), ncb + S)
        device = device if device is not None else (
            blocks.device if isinstance(blocks, torch.Tensor) else "cpu")
        return cls(_tensor(blocks, torch.float32, device),
                   _tensor(cs_h, torch.int32, device), m, n,
                   _tensor(ptr, torch.int32, device),
                   _tensor(idx, torch.int32, device))

    def mv_pair(self, x, z):
        """(A @ x, A' @ z) from one read of the tile table (K2).  x carries
        S zero blocks at its end so that every window stays in range."""
        nrb, S = self.blocks.shape[:2]
        xb = self._pad(x, self._ncb() + S, self.bn)
        zb = self._pad(z, nrb, self.bm)
        y1, y2 = band_mv_pair(self.cs, self.blocks, xb, zb,
                              (self.inv_ptr, self.inv_idx))
        return y1.reshape(-1)[: self.m], y2.reshape(-1)[: self.n]

    def todense(self):
        nrb, S, bm, bn = self.blocks.shape
        dense = self.blocks.new_zeros((nrb * bm, (self._ncb() + S) * bn))
        cs = self.cs.tolist()
        for i in range(nrb):
            for k in range(S):
                c = (cs[i] + k) * bn
                dense[i * bm:(i + 1) * bm, c:c + bn] += self.blocks[i, k]
        return dense[: self.m, : self.n]


class BlockedEllOp(_TileOp):
    """Blocked-ELL tile table: row block r holds ``counts[r]`` tiles at tile
    columns ``cols[r, :counts[r]]``; the remaining slots are zero padding
    aliasing column 0."""

    def __init__(self, blocks, cols, counts, m, n, inv_ptr, inv_idx):
        self.blocks = blocks        # (nrb, kmax, bm, bn) f32
        self.cols = cols            # (nrb, kmax) int32
        self.counts = counts        # (nrb,) int32 stored tiles per row block
        self.m = m
        self.n = n
        self.inv_ptr = inv_ptr      # (ncb + 1,) int32
        self.inv_idx = inv_idx      # (stored tiles,) int32

    @classmethod
    def create(cls, A, *, transpose_table=False, device=None):
        """Pack a scipy.sparse matrix (A table only, as for BandedBlockOp)."""
        _reject_transpose_table(transpose_table)
        rows, cols, vals, m, n = _coo_parts(A)
        blocks, cols_tab, counts = _build_ell_arrays(
            m, n, rows, cols, vals.astype(np.float32), cls.bm, cls.bn)
        return cls.from_arrays(blocks, cols_tab, m, n, counts=counts,
                               device=device)

    @classmethod
    def from_arrays(cls, blocks, cols, m, n, *, counts=None, device=None):
        """Wrap a tile table (numpy or tensors): blocks (nrb, kmax, 128,
        128), cols (nrb, kmax), and optionally counts (nrb,) — without it
        every slot is treated as stored (padding tiles are zeros, so the
        result is the same)."""
        nrb, kmax = blocks.shape[:2]
        ncb = _pad8(math.ceil(n / cls.bn))
        host = lambda a: (a.cpu().numpy() if isinstance(a, torch.Tensor)  # noqa: E731
                          else np.asarray(a)).astype(np.int64)
        cols_h = host(cols)
        counts_h = (np.full(nrb, kmax, np.int64) if counts is None
                    else host(counts))
        if (tuple(blocks.shape[2:]) != (cls.bm, cls.bn)
                or cols_h.shape != (nrb, kmax) or counts_h.shape != (nrb,)):
            raise ValueError(f"tables {tuple(blocks.shape)} / {cols_h.shape}")
        if nrb * cls.bm < m or (cols_h.size and not (
                0 <= cols_h.min() and cols_h.max() < ncb)) or (
                counts_h.size and not (0 <= counts_h.min()
                                       and counts_h.max() <= kmax)):
            raise ValueError("ELL tables do not cover A / columns leave x")
        valid = np.arange(kmax)[None, :] < counts_h[:, None]
        ptr, idx = inverse_table(cols_h, valid, ncb)
        device = device if device is not None else (
            blocks.device if isinstance(blocks, torch.Tensor) else "cpu")
        t = lambda a: _tensor(a, torch.int32, device)  # noqa: E731
        return cls(_tensor(blocks, torch.float32, device), t(cols_h),
                   t(counts_h), m, n, t(ptr), t(idx))

    def mv_pair(self, x, z):
        """(A @ x, A' @ z) from one read of the tile table (K3)."""
        nrb = self.blocks.shape[0]
        xb = self._pad(x, self._ncb(), self.bn)
        zb = self._pad(z, nrb, self.bm)
        y1, y2 = bell_mv_pair(self.cols, self.blocks, xb, zb, self.counts,
                              (self.inv_ptr, self.inv_idx))
        return y1.reshape(-1)[: self.m], y2.reshape(-1)[: self.n]

    def todense(self):
        nrb, kmax, bm, bn = self.blocks.shape
        dense = self.blocks.new_zeros((nrb * bm, self._ncb() * bn))
        cols = self.cols.tolist()
        for i in range(nrb):
            for k in range(kmax):
                c = cols[i][k] * bn
                dense[i * bm:(i + 1) * bm, c:c + bn] += self.blocks[i, k]
        return dense[: self.m, : self.n]
