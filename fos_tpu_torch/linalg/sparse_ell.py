"""Sparse A as a table of dense 128x128 tiles, with hand-written kernels.

A sparse A is cut into (bm, bn) = (128, 128) tiles and only the tiles that
hold nonzeros are stored, in one of two layouts:

* :class:`BandedBlockOp`: row block r stores the contiguous window of tile
  columns ``[cs[r], cs[r] + S)``, so A x reads one contiguous slice of x;
* :class:`BlockedEllOp`: row block r stores ``counts[r]`` tiles with their
  block columns in ``cols[r]``; padding slots alias column 0 and hold zeros.

Two kinds of product run over a table, each a hand-written CUDA kernel on a
CUDA tensor and its plain PyTorch version on a CPU tensor:

* ``mv_pair`` computes ``(A @ x, A' @ z)`` from ONE read of the A table,
  which is all the HSDE solve needs: K2 (:func:`band_mv_pair`, the port of
  ``fos_tpu.linalg.sparse_ell._band_mv_pair``) and K3
  (:func:`bell_mv_pair`, of ``_bell_mv_pair``).  They sum the transposed
  products of each column block in a fixed order, listed by an inverse
  table that ``from_arrays`` builds once on the host.
* ``mv`` and ``rmv`` compute one product each, ``A @ x`` over the A table
  and ``A' @ y`` over the A' table (packed only with
  ``transpose_table=True``), as the set-feasibility solve's affine
  projection needs them: K4 (:func:`band_mv`, of ``_band_mv``) and K5
  (:func:`bell_mv`, of ``_bell_mv``).

The operators' three products also take a lane axis, vectors ``(L, k)``
(the line search's 31 candidate steps; the JAX package's ``vmap`` over
the ``pallas_call``, one call with the lanes in its grid): one launch of
a lane kernel that reads each tile once for all L lanes (K2-K5 over
lanes), each lane bit-equal to a single call on its vectors.  Their plain
versions (:func:`band_mv_pair_lanes_plain` and the three beside it) run
the single plain version lane by lane.

The host builders run the native packer (:mod:`fos_tpu_torch.native`), or
their numpy versions without it, and produce tables bit-identical to the
JAX package's builders; ``from_arrays(..., transpose_table=True)`` packs the A'
table from the A table's tiles, bit-identical to what ``create`` packs from
the same matrix.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fos_tpu_torch.config import default_device
from fos_tpu_torch import native
from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.linalg.lanes import lane_by_lane


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
    """Pack COO triplets into blocked-ELL arrays: (blocks, cols, counts).

    The native packer (:mod:`fos_tpu_torch.native`) runs first; the numpy
    code below is its fallback and the reference it is held to, bit for
    bit."""
    nrb = _pad8(math.ceil(m / bm))
    ncb = math.ceil(n / bn)
    nat = native.ell_pack(rows, cols, vals, nrb, ncb, bm, bn, _ell_kmax)
    if nat is not None:
        return nat
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
    block i holds the tile-column window [cs_i, cs_i + S).  Native first,
    as :func:`_build_ell_arrays`."""
    nrb = _pad8(math.ceil(m / bm))
    nat = native.band_pack(rows, cols, vals, nrb, math.ceil(n / bn), bm, bn)
    if nat is not None:
        return nat
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


def _band_stats_numpy(r, c, mm, br, bc):
    """(widest window, most distinct tiles) over the row blocks of one
    direction of a nonempty COO pattern, in numpy."""
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
    return span, int(np.bincount(upair // ncb_tiles, minlength=nrb).max())


def _tile_stats(rows, cols, m, n, bm, bn):
    """Both directions' (widest window, most tiles) of a nonempty COO
    pattern: the native library's, else numpy's."""
    return (native.tile_stats(rows, cols, math.ceil(m / bm),
                              math.ceil(n / bn), bm, bn)
            or (_band_stats_numpy(rows, cols, m, bm, bn),
                _band_stats_numpy(cols, rows, n, bn, bm)))


def band_span_ratio(A, bm=128, bn=128) -> float:
    """Banded storage (of A and of A') relative to blocked-ELL storage:
    1.0 when every row block's tiles are contiguous, large when columns
    scatter across the row."""
    rows, cols, _, m, n = _coo_parts(A)
    if rows.size == 0:
        return 1.0
    return max(span / max(cnt, 1)
               for span, cnt in _tile_stats(rows, cols, m, n, bm, bn))


def bell_storage_ratio(A, bm=128, bn=128) -> float:
    """Padded blocked-ELL storage (A and A' layouts) relative to one dense
    copy, from the index pattern alone."""
    rows, cols, _, m, n = _coo_parts(A)
    nrb = _pad8(math.ceil(m / bm))
    ncb = _pad8(math.ceil(n / bn))
    kmax = kmax_t = 1
    if rows.size:
        stats = _tile_stats(rows, cols, m, n, bm, bn)
        kmax, kmax_t = stats[0][1], stats[1][1]
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


def _transposed_tiles(blocks, col_of_slot, valid, nrb):
    """The A' tiles of a tile table: (tj, ti, tiles) with one entry per
    tile position (ti, tj) of A that holds a nonzero, ordered by (tj, ti),
    each tile transposed (duplicate positions summed)."""
    blocks = np.asarray(blocks)
    col = np.asarray(col_of_slot, np.int64)
    occ = np.asarray(valid, bool) & (blocks != 0).any(axis=(2, 3))
    ti, k = np.nonzero(occ)
    key, inv = np.unique(col[ti, k] * nrb + ti, return_inverse=True)
    tiles = np.zeros((key.size,) + blocks.shape[2:][::-1], blocks.dtype)
    np.add.at(tiles, inv, blocks[ti, k].transpose(0, 2, 1))
    return key // nrb, key % nrb, tiles


def _band_from_tiles(tj, ti, tiles, nrb_t):
    """Banded A' table (blocks_t, cs_t) from :func:`_transposed_tiles`,
    laid out as ``_build_band_arrays`` lays out the transposed COO."""
    lo = np.full(nrb_t, np.iinfo(np.int64).max, np.int64)
    hi = np.full(nrb_t, -1, np.int64)
    np.minimum.at(lo, tj, ti)
    np.maximum.at(hi, tj, ti)
    lo = np.where(hi >= 0, lo, 0)
    S = max(int((hi - lo + 1).max()) if tj.size else 1, 1)
    blocks = np.zeros((nrb_t, S) + tiles.shape[1:], tiles.dtype)
    blocks[tj, ti - lo[tj]] = tiles
    return blocks, lo.astype(np.int32)


def _ell_from_tiles(tj, ti, tiles, nrb_t):
    """Blocked-ELL A' table (blocks_t, cols_t, counts_t) from
    :func:`_transposed_tiles`, laid out as ``_build_ell_arrays`` lays out
    the transposed COO."""
    counts = np.bincount(tj, minlength=nrb_t)
    kmax = _ell_kmax(int(counts.max()) if counts.size else 0)
    row_start = np.zeros(nrb_t + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    slot = np.arange(tj.size) - row_start[tj]
    blocks = np.zeros((nrb_t, kmax) + tiles.shape[1:], tiles.dtype)
    cols = np.zeros((nrb_t, kmax), np.int32)
    blocks[tj, slot] = tiles
    cols[tj, slot] = ti
    return blocks, cols, counts


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


# The plain lane versions run the single plain version lane by lane: a
# lane has the bits of a single call whatever the number of lanes, as the
# lane kernels' lanes do (a batched ``torch.matmul`` on the CPU gives bits
# that depend on it).
def band_mv_pair_lanes_plain(cs, blocks, XB, ZB):
    """Plain K2 over lanes: XB (L, ncb+S, bn), ZB (L, nrb, bm) -> (Y1 (L,
    nrb, bm), Y2 (L, ncb+S, bn))."""
    return lane_by_lane(functools.partial(band_mv_pair_plain, cs, blocks),
                        XB, ZB)


def bell_mv_pair_lanes_plain(cols, blocks, XB, ZB):
    """Plain K3 over lanes: XB (L, ncb, bn), ZB (L, nrb, bm) -> (Y1 (L,
    nrb, bm), Y2 (L, ncb, bn))."""
    return lane_by_lane(functools.partial(bell_mv_pair_plain, cols, blocks),
                        XB, ZB)


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


_F32 = torch.float32


def _check_table(name, blocks, aligned=False, **tables):
    """The checks of a tile table and its index tables, made once when a
    kernel is bound to them: on one CUDA device, f32 tiles (int32 index
    tables), contiguous, 128x128 tiles, not empty."""
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _cuda.require_cuda_f32(name, dev, blocks=blocks, **tables)
    if aligned:
        _cuda.require_aligned(name, blocks=blocks)
    side = _cuda.TILE
    if blocks.dim() != 4 or tuple(blocks.shape[2:]) != (side, side):
        raise ValueError(f"{name}: tiles must be {side}x{side}, got "
                         f"{tuple(blocks.shape)}")
    if blocks.shape[0] == 0:
        raise ValueError(f"{name}: empty tile table")
    return dev


def _table_slots(blocks, index, counts):
    """A tile kernel's leading record slots: the tiles, the column index
    (cs or cols) and, for blocked-ELL, the counts."""
    return (blocks.data_ptr(), index.data_ptr(),
            *(() if counts is None else (counts.data_ptr(),)))


def _pair_kernel(kind, blocks, index, counts, inverse, ncb_out):
    """K2 (``kind`` "band": ``index`` is cs) or K3 ("bell": ``index`` is
    cols, with ``counts``) bound to a checked table: ``(xb, zb) -> (y1,
    y2)`` with xb (ncb_out, 128), zb (nrb, 128).  It holds the partial
    buffers y1part, y2part (nrb, slots, 128)."""
    nrb, slots = blocks.shape[:2]
    T = _cuda.TILE
    part = torch.empty(2 * nrb * slots * T, dtype=_F32, device=blocks.device)
    return _cuda.Kernel(
        f"{kind}_mv_pair", f"fos_{kind}_pair", blocks.device,
        (*_table_slots(blocks, index, counts), nrb, slots,
         inverse[0].data_ptr(), inverse[1].data_ptr(), ncb_out,
         part.data_ptr()),
        ins=(((ncb_out, T), _F32), ((nrb, T), _F32)),
        outs=((nrb, T), (ncb_out, T)),
        keep=(blocks, index, counts, *inverse, part))


def _pair_lanes_kernel(kind, blocks, index, counts, inverse, ncb_out):
    """K2 or K3 over lanes bound to a checked table (as
    :func:`_pair_kernel`): ``(XB, ZB) -> (Y1, Y2)`` with XB (L, ncb_out,
    128), ZB (L, nrb, 128); each lane count's partials (y2's, nrb slots
    128 floats a lane: y1's sum stays on chip) are allocated at its first
    call."""
    nrb, slots = blocks.shape[:2]
    T = _cuda.TILE
    return _cuda.Kernel(
        f"{kind}_mv_pair_lanes", f"fos_{kind}_pair_lanes", blocks.device,
        (*_table_slots(blocks, index, counts), nrb, slots,
         inverse[0].data_ptr(), inverse[1].data_ptr(), ncb_out),
        ins=(((ncb_out, T), _F32), ((nrb, T), _F32)),
        outs=((nrb, T), (ncb_out, T)), keep=(blocks, index, counts, *inverse),
        lanes=True, part=nrb * slots * T, aligned=True)


def lane_task_order(counts):
    """The order in which K5's lane kernel deals out a blocked-ELL table's
    row blocks: by stored tiles, the longest first (ties in row order), so
    that the blocks of its persistent grid, taking the rows in turn, end
    together.  int32, on ``counts``' device."""
    return torch.sort(counts, descending=True, stable=True)[1].to(
        torch.int32)


def _mv_lanes_kernel(kind, blocks, index, counts, xrows):
    """K4 or K5 over lanes bound to a checked table: ``XB -> Y`` with XB
    (L, xrows, 128), Y (L, nrb, 128); K5 also takes
    :func:`lane_task_order` of the counts."""
    nrb, slots = blocks.shape[:2]
    T = _cuda.TILE
    order = None if counts is None else lane_task_order(counts)
    return _cuda.Kernel(
        f"{kind}_mv_lanes", f"fos_{kind}_mv_lanes", blocks.device,
        (*_table_slots(blocks, index, counts), nrb, slots,
         *(() if order is None else (order.data_ptr(),))),
        ins=(((xrows, T), _F32),), outs=((nrb, T),),
        keep=(blocks, index, counts, order), lanes=True, aligned=True)


def _mv_kernel(kind, blocks, index, counts, xrows):
    """K4 ("band": ``index`` is cs) or K5 ("bell": cols, with ``counts``)
    bound to a checked table: ``xb -> y`` with xb (xrows, 128) 16-byte
    aligned (the operators' padded vectors are fresh allocations)."""
    nrb, slots = blocks.shape[:2]
    T = _cuda.TILE
    return _cuda.Kernel(f"{kind}_mv", f"fos_{kind}_mv", blocks.device,
                        (*_table_slots(blocks, index, counts), nrb, slots),
                        ins=(((xrows, T), _F32),), outs=((nrb, T),),
                        keep=(blocks, index, counts))


def band_mv_pair(cs, blocks, xb, zb, inverse=None):
    """K2: ``(A @ x, A' @ z)`` over a banded tile table, in one read of it.
    ``inverse`` is the operator's ``(inv_ptr, inv_idx)`` (needed on the
    card only)."""
    if _on_cpu(cs, blocks, xb, zb):
        return band_mv_pair_plain(cs, blocks, xb, zb)
    name = "band_mv_pair"
    if inverse is None:
        raise ValueError(f"{name}: the kernel needs the (inv_ptr, inv_idx) "
                         "inverse table of the operator")
    ncb_out = xb.shape[0]

    def make():
        _check_table(name, blocks, cs=cs, inv_ptr=inverse[0],
                     inv_idx=inverse[1])
        if (inverse[0].shape[0] != ncb_out + 1
                or cs.shape != (blocks.shape[0],)):
            raise ValueError(f"{name}: index tables do not fit the table")
        return _pair_kernel("band", blocks, cs, None, inverse, ncb_out)

    key = (name, _cuda.operand_key(blocks, cs, *inverse), ncb_out)
    return tuple(_cuda.bound_kernel(key, make)(xb, zb))


def bell_mv_pair(cols, blocks, xb, zb, counts=None, inverse=None):
    """K3: ``(A @ x, A' @ z)`` over a blocked-ELL tile table, in one read of
    it.  ``counts`` (stored tiles per row block) and ``inverse`` are the
    operator's tables (needed on the card only)."""
    if _on_cpu(cols, blocks, xb, zb):
        return bell_mv_pair_plain(cols, blocks, xb, zb)
    name = "bell_mv_pair"
    if inverse is None or counts is None:
        raise ValueError(f"{name}: the kernel needs the (inv_ptr, inv_idx) "
                         "inverse table and the counts of the operator")
    ncb_out = xb.shape[0]

    def make():
        _check_table(name, blocks, cols=cols, counts=counts,
                     inv_ptr=inverse[0], inv_idx=inverse[1])
        nrb, kmax = blocks.shape[:2]
        if (inverse[0].shape[0] != ncb_out + 1 or cols.shape != (nrb, kmax)
                or counts.shape != (nrb,)):
            raise ValueError(f"{name}: index tables do not fit the table")
        return _pair_kernel("bell", blocks, cols, counts, inverse, ncb_out)

    key = (name, _cuda.operand_key(blocks, cols, counts, *inverse), ncb_out)
    return tuple(_cuda.bound_kernel(key, make)(xb, zb))


# --------------------------------------------------------------- K4 and K5
def band_mv_plain(cs, blocks, xb):
    """Plain PyTorch K4: cs (nrb,); blocks (nrb, S, bm, bn); xb (rows, bn)
    with every window [cs[r], cs[r] + S) inside it -> y (nrb, bm) = A x."""
    S = blocks.shape[1]
    win = cs.long()[:, None] + torch.arange(S, device=cs.device)
    return torch.matmul(blocks, xb[win].unsqueeze(-1)).squeeze(-1).sum(1)


def bell_mv_plain(cols, blocks, xb):
    """Plain PyTorch K5: cols (nrb, kmax); blocks (nrb, kmax, bm, bn);
    xb (ncb, bn) -> y (nrb, bm).  Padding slots hold zero tiles, so every
    slot is summed."""
    return torch.matmul(blocks, xb[cols.long()].unsqueeze(-1)).squeeze(-1).sum(1)


def band_mv_lanes_plain(cs, blocks, XB):
    """Plain K4 over lanes: XB (L, rows, bn) -> Y (L, nrb, bm)."""
    return torch.stack([band_mv_plain(cs, blocks, xb) for xb in XB])


def bell_mv_lanes_plain(cols, blocks, XB):
    """Plain K5 over lanes: XB (L, ncb, bn) -> Y (L, nrb, bm)."""
    return torch.stack([bell_mv_plain(cols, blocks, xb) for xb in XB])


def band_mv(cs, blocks, xb):
    """K4: ``y = A x`` over a banded tile table.  ``cs`` must keep every
    window inside ``xb`` (the operators check it when they are built); the
    kernel reads each stored tile once."""
    if _on_cpu(cs, blocks, xb):
        return band_mv_plain(cs, blocks, xb)
    _cuda.require_aligned("band_mv", xb=xb)
    xrows = xb.shape[0]

    def make():
        _check_table("band_mv", blocks, aligned=True, cs=cs)
        nrb, S = blocks.shape[:2]
        if tuple(cs.shape) != (nrb,) or xrows < S:
            raise ValueError("band_mv: cs / xb do not fit the table")
        return _mv_kernel("band", blocks, cs, None, xrows)

    key = ("band_mv", _cuda.operand_key(blocks, cs), xrows)
    return _cuda.bound_kernel(key, make)(xb)


def bell_mv(cols, blocks, xb, counts):
    """K5: ``y = A x`` over a blocked-ELL tile table; on the card only the
    ``counts[r]`` stored slots of each row block are read."""
    if _on_cpu(cols, blocks, xb, counts):
        return bell_mv_plain(cols, blocks, xb)
    _cuda.require_aligned("bell_mv", xb=xb)

    def make():
        _check_table("bell_mv", blocks, aligned=True, cols=cols,
                     counts=counts)
        nrb, kmax = blocks.shape[:2]
        if tuple(cols.shape) != (nrb, kmax) or tuple(counts.shape) != (nrb,):
            raise ValueError("bell_mv: cols / counts do not fit the table")
        return _mv_kernel("bell", blocks, cols, counts, xb.shape[0])

    key = ("bell_mv", _cuda.operand_key(blocks, cols, counts), xb.shape[0])
    return _cuda.bound_kernel(key, make)(xb)


# ---------------------------------------------------------------- operators
def _tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.array(a)).to(dtype=dtype, device=device)


def _host(a, dtype=np.int64):
    """A numpy copy of an array or tensor (tensors come to the host)."""
    return (a.cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a)).astype(dtype, copy=False)


def _check_index(name, idx, shape, hi, inclusive=False):
    if idx.shape != shape:
        raise ValueError(f"{name} has shape {idx.shape}, expected {shape}")
    if idx.size and not (0 <= idx.min() and (idx.max() <= hi if inclusive
                                              else idx.max() < hi)):
        raise ValueError(f"{name} indexes tiles outside the table")


class _TileOp:
    """What the two layouts share: shape, device, padding of vectors, and
    the products, which take one vector or a lane axis (``(..., k)``: the
    leading axes are lanes, sent to a lane kernel in one call)."""

    bm = bn = 128
    #: ``mv_pair`` takes (L, k) vectors in one call (:mod:`hsde_ops`)
    pair_lanes = True
    #: so do ``mv`` and ``rmv``
    mv_lanes = True

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
        """Column-block count: the _pad8 formula of the table builder (also
        the A' table's row count)."""
        return _pad8(math.ceil(self.n / self.bn))

    def _pad(self, v, nblocks, width):
        """``v`` (..., k) zero-padded to (..., nblocks, width): one buffer
        for every lane."""
        lead = v.shape[:-1]
        out = v.new_zeros(lead + (nblocks * width,))
        out[..., : v.shape[-1]] = v
        return out.reshape(lead + (nblocks, width))

    @staticmethod
    def _cut(y, lead, k):
        """A product's (..., blocks, width) output as (..., k) vectors."""
        return y.reshape(lead + (-1,))[..., :k]

    def _no_transpose_table(self):
        name = type(self).__name__
        return TypeError(
            f"this {name} was built with transpose_table=False (no A' tile "
            f"table): use mv_pair for A'z, or rebuild with {name}.create(A, "
            "transpose_table=True) for standalone rmv")

    def _product(self, single, lanes, v, rows, width, k):
        """One product of ``v`` (k,) through ``single``, or of (..., k)
        lanes through ``lanes`` in one call.  One vector keeps the single
        kernel: the lane kernels at one lane take 1.08-1.25x its time on
        the card (PERF.md)."""
        vb = self._pad(v, rows, width)
        lead = v.shape[:-1]
        if not lead:
            return single(vb).reshape(-1)[:k]
        return self._cut(lanes(vb.reshape((-1, rows, width))), lead, k)

    def mv(self, x):
        """A @ x over the A table (K4/K5; over lanes, their lane kernels).
        A banded x carries S zero blocks at its end so that every window
        stays in range."""
        return self._product(self._mv, self._mv_lanes, x, self._xrows,
                             self.bn, self.m)

    def rmv(self, y):
        """A' @ y over the A' table (K4/K5; over lanes, their lane
        kernels)."""
        if self._rmv is None:
            raise self._no_transpose_table()
        return self._product(self._rmv, self._rmv_lanes, y, self._yrows_t,
                             self.bm, self.n)

    def mv_pair(self, x, z):
        """(A @ x, A' @ z) from one read of the A table (K2/K3; over
        lanes, their lane kernels: one read for every lane)."""
        nrb = self.blocks.shape[0]
        xb = self._pad(x, self._xrows, self.bn)
        zb = self._pad(z, nrb, self.bm)
        lead = x.shape[:-1]
        if not lead:
            y1, y2 = self._pair(xb, zb)
            return y1.reshape(-1)[: self.m], y2.reshape(-1)[: self.n]
        y1, y2 = self._pair_lanes(xb.reshape((-1, self._xrows, self.bn)),
                                  zb.reshape((-1, nrb, self.bm)))
        return self._cut(y1, lead, self.m), self._cut(y2, lead, self.n)

    def _bind(self):
        """Bind the products to the tables once they are on their device:
        on the card the kernels and their lane kernels (tables checked
        here, the pair's partials allocated here, the lane pair's at the
        first call with each lane count), on the CPU the plain versions."""
        kind = self.kind
        nrb, slots = self.blocks.shape[:2]
        index = self.cs if kind == "band" else self.cols
        counts = None if kind == "band" else self.counts
        # x's tile rows: band windows reach S blocks past the last column
        ncb_out = self._xrows = self._ncb() + (slots if kind == "band" else 0)
        t = self.transposed()
        self._yrows_t = nrb + (t[0].shape[1] if t and kind == "band" else 0)
        if self.device.type == "cpu":
            plain = ((band_mv_pair_plain, band_mv_plain,
                      band_mv_pair_lanes_plain, band_mv_lanes_plain)
                     if kind == "band" else
                     (bell_mv_pair_plain, bell_mv_plain,
                      bell_mv_pair_lanes_plain, bell_mv_lanes_plain))
            self._pair, self._mv, self._pair_lanes, self._mv_lanes = (
                functools.partial(f, index, self.blocks) for f in plain)
            self._rmv = self._rmv_lanes = None
            if t is not None:
                self._rmv = functools.partial(plain[1], t[1], t[0])
                self._rmv_lanes = functools.partial(plain[3], t[1], t[0])
            return
        name = f"{kind}_mv_pair"
        tables = (dict(cs=self.cs) if kind == "band" else
                  dict(cols=self.cols, counts=self.counts))
        _check_table(name, self.blocks, aligned=True, inv_ptr=self.inv_ptr,
                     inv_idx=self.inv_idx, **tables)
        inverse = (self.inv_ptr, self.inv_idx)
        self._pair = _pair_kernel(kind, self.blocks, index, counts, inverse,
                                  ncb_out)
        self._pair_lanes = _pair_lanes_kernel(kind, self.blocks, index,
                                              counts, inverse, ncb_out)
        self._mv = _mv_kernel(kind, self.blocks, index, counts, ncb_out)
        self._mv_lanes = _mv_lanes_kernel(kind, self.blocks, index, counts,
                                          ncb_out)
        self._rmv = self._rmv_lanes = None
        if t is not None:
            blocks_t, index_t, counts_t = t
            tables_t = (dict(cs=index_t) if kind == "band" else
                        dict(cols=index_t, counts=counts_t))
            _check_table(f"{kind}_mv", blocks_t, aligned=True, **tables_t)
            self._rmv = _mv_kernel(kind, blocks_t, index_t, counts_t,
                                   self._yrows_t)
            self._rmv_lanes = _mv_lanes_kernel(kind, blocks_t, index_t,
                                               counts_t, self._yrows_t)

    def _transposed(self, blocks, col_of_slot, valid):
        """A' tiles of the A table given on the host (see
        :func:`_transposed_tiles`), checked to stay inside the A' table."""
        nrb = blocks.shape[0]
        tj, ti, tiles = _transposed_tiles(_host(blocks, np.float32),
                                          col_of_slot, valid, nrb)
        if tj.size and tj.max() >= self._ncb():
            raise ValueError("the A table holds nonzero tiles past column n")
        return tj, ti, tiles


class BandedBlockOp(_TileOp):
    """Banded tile table: row block r holds tile columns [cs[r], cs[r]+S).
    The optional A' table (``blocks_t``, ``cs_t``) is packed the same way
    from A' and serves :meth:`rmv`."""

    kind = "band"

    def __init__(self, blocks, cs, m, n, inv_ptr, inv_idx, blocks_t=None,
                 cs_t=None):
        self.blocks = blocks        # (nrb, S, bm, bn) f32
        self.cs = cs                # (nrb,) int32 first tile column
        self.m = m
        self.n = n
        self.inv_ptr = inv_ptr      # (ncb + S + 1,) int32
        self.inv_idx = inv_idx      # (nrb * S,) int32
        self.blocks_t = blocks_t    # (ncb, S_t, bn, bm) f32 or None
        self.cs_t = cs_t            # (ncb,) int32 or None

    @classmethod
    def create(cls, A, *, transpose_table=False, device=None):
        """Pack a scipy.sparse matrix.  ``transpose_table=True`` also packs
        the A' table for :meth:`rmv`; the HSDE solve never needs it (the
        pair computes A'z from the A table), so it is off by default."""
        rows, cols, vals, m, n = _coo_parts(A)
        vals = vals.astype(np.float32)
        blocks, cs, _ = _build_band_arrays(m, n, rows, cols, vals, cls.bm,
                                           cls.bn)
        blocks_t = cs_t = None
        if transpose_table:
            blocks_t, cs_t, _ = _build_band_arrays(n, m, cols, rows, vals,
                                                   cls.bn, cls.bm)
        return cls.from_arrays(blocks, cs, m, n, blocks_t=blocks_t, cs_t=cs_t,
                               device=device)

    @classmethod
    def from_arrays(cls, blocks, cs, m, n, *, transpose_table=False,
                    blocks_t=None, cs_t=None, device=None):
        """Wrap a tile table (numpy or tensors): blocks (nrb, S, 128, 128),
        cs (nrb,), moved to ``device`` (default: the card).  The A' table is
        ``blocks_t``/``cs_t`` when given, else with ``transpose_table=True``
        it is packed here, on the host, from the A table's nonzero tiles.
        The inverse table of the pair kernel is built here too."""
        device = default_device(device)
        nrb, S = blocks.shape[:2]
        ncb = _pad8(math.ceil(n / cls.bn))
        cs_h = _host(cs)
        if tuple(blocks.shape[2:]) != (cls.bm, cls.bn) or nrb * cls.bm < m:
            raise ValueError(f"tile table {tuple(blocks.shape)} does not "
                             f"cover a {m}x{n} matrix")
        _check_index("cs", cs_h, (nrb,), ncb, inclusive=True)
        win = cs_h[:, None] + np.arange(S)
        ptr, idx = inverse_table(win, np.ones((nrb, S), bool), ncb + S)
        self = cls(_tensor(blocks, torch.float32, device),
                   _tensor(cs_h, torch.int32, device), m, n,
                   _tensor(ptr, torch.int32, device),
                   _tensor(idx, torch.int32, device))
        if blocks_t is None and transpose_table:
            blocks_t, cs_t = _band_from_tiles(
                *self._transposed(blocks, win, np.ones((nrb, S), bool)), ncb)
        if blocks_t is not None:
            cs_t_h = _host(cs_t)
            if tuple(blocks_t.shape[::2]) != (ncb, cls.bn) or \
                    blocks_t.shape[3] != cls.bm:
                raise ValueError(f"A' table {tuple(blocks_t.shape)} does not "
                                 f"cover a {n}x{m} matrix")
            _check_index("cs_t", cs_t_h, (ncb,), nrb, inclusive=True)
            self.blocks_t = _tensor(blocks_t, torch.float32, device)
            self.cs_t = _tensor(cs_t_h, torch.int32, device)
        self._bind()
        return self

    def transposed(self):
        """(blocks_t, cs_t, None), or None without the A' table."""
        return None if self.blocks_t is None else (self.blocks_t, self.cs_t,
                                                   None)

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
    aliasing column 0.  The optional A' table (``blocks_t``, ``cols_t``,
    ``counts_t``) is packed the same way from A' and serves :meth:`rmv`."""

    kind = "bell"

    def __init__(self, blocks, cols, counts, m, n, inv_ptr, inv_idx,
                 blocks_t=None, cols_t=None, counts_t=None):
        self.blocks = blocks        # (nrb, kmax, bm, bn) f32
        self.cols = cols            # (nrb, kmax) int32
        self.counts = counts        # (nrb,) int32 stored tiles per row block
        self.m = m
        self.n = n
        self.inv_ptr = inv_ptr      # (ncb + 1,) int32
        self.inv_idx = inv_idx      # (stored tiles,) int32
        self.blocks_t = blocks_t    # (ncb, kmax_t, bn, bm) f32 or None
        self.cols_t = cols_t        # (ncb, kmax_t) int32 or None
        self.counts_t = counts_t    # (ncb,) int32 or None

    @classmethod
    def create(cls, A, *, transpose_table=False, device=None):
        """Pack a scipy.sparse matrix (the A' table only with
        ``transpose_table=True``, as for :class:`BandedBlockOp`)."""
        rows, cols, vals, m, n = _coo_parts(A)
        vals = vals.astype(np.float32)
        blocks, cols_tab, counts = _build_ell_arrays(m, n, rows, cols, vals,
                                                     cls.bm, cls.bn)
        blocks_t = cols_t = counts_t = None
        if transpose_table:
            blocks_t, cols_t, counts_t = _build_ell_arrays(
                n, m, cols, rows, vals, cls.bn, cls.bm)
        return cls.from_arrays(blocks, cols_tab, m, n, counts=counts,
                               blocks_t=blocks_t, cols_t=cols_t,
                               counts_t=counts_t, device=device)

    @classmethod
    def from_arrays(cls, blocks, cols, m, n, *, counts=None,
                    transpose_table=False, blocks_t=None, cols_t=None,
                    counts_t=None, device=None):
        """Wrap a tile table (numpy or tensors): blocks (nrb, kmax, 128,
        128), cols (nrb, kmax), and optionally counts (nrb,) — without it
        every slot is treated as stored (padding tiles are zeros, so the
        result is the same) — moved to ``device`` (default: the card).  The
        A' table is ``blocks_t``/``cols_t``/``counts_t`` when given, else
        with ``transpose_table=True`` it is packed here, on the host, from
        the A table's nonzero tiles."""
        device = default_device(device)
        nrb, kmax = blocks.shape[:2]
        ncb = _pad8(math.ceil(n / cls.bn))
        cols_h = _host(cols)
        counts_h = (np.full(nrb, kmax, np.int64) if counts is None
                    else _host(counts))
        if tuple(blocks.shape[2:]) != (cls.bm, cls.bn) or nrb * cls.bm < m:
            raise ValueError(f"tile table {tuple(blocks.shape)} does not "
                             f"cover a {m}x{n} matrix")
        _check_index("cols", cols_h, (nrb, kmax), ncb)
        _check_index("counts", counts_h, (nrb,), kmax, inclusive=True)
        valid = np.arange(kmax)[None, :] < counts_h[:, None]
        ptr, idx = inverse_table(cols_h, valid, ncb)
        t = lambda a: _tensor(a, torch.int32, device)  # noqa: E731
        self = cls(_tensor(blocks, torch.float32, device), t(cols_h),
                   t(counts_h), m, n, t(ptr), t(idx))
        if blocks_t is None and transpose_table:
            blocks_t, cols_t, counts_t = _ell_from_tiles(
                *self._transposed(blocks, cols_h, valid), ncb)
        if blocks_t is not None:
            kmax_t = blocks_t.shape[1]
            cols_t_h = _host(cols_t)
            counts_t_h = (np.full(ncb, kmax_t, np.int64) if counts_t is None
                          else _host(counts_t))
            if tuple(blocks_t.shape[::2]) != (ncb, cls.bn) or \
                    blocks_t.shape[3] != cls.bm:
                raise ValueError(f"A' table {tuple(blocks_t.shape)} does not "
                                 f"cover a {n}x{m} matrix")
            _check_index("cols_t", cols_t_h, (ncb, kmax_t), nrb)
            _check_index("counts_t", counts_t_h, (ncb,), kmax_t,
                         inclusive=True)
            self.blocks_t = _tensor(blocks_t, torch.float32, device)
            self.cols_t, self.counts_t = t(cols_t_h), t(counts_t_h)
        self._bind()
        return self

    def transposed(self):
        """(blocks_t, cols_t, counts_t), or None without the A' table."""
        return None if self.blocks_t is None else (self.blocks_t, self.cols_t,
                                                   self.counts_t)

    def todense(self):
        nrb, kmax, bm, bn = self.blocks.shape
        dense = self.blocks.new_zeros((nrb * bm, self._ncb() * bn))
        cols = self.cols.tolist()
        for i in range(nrb):
            for k in range(kmax):
                c = cols[i][k] * bn
                dense[i * bm:(i + 1) * bm, c:c + bn] += self.blocks[i, k]
        return dense[: self.m, : self.n]
