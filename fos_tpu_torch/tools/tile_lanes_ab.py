"""K2-K5 over lanes (the line search's probes through the tile products),
timed on the card against another build of themselves.

    python3 -m fos_tpu_torch.tools.tile_lanes_ab [--parent DIR]
                                                 [--products pair,mv]
                                                 [--rounds R] [--out FILE]
                                                 [--ablations]

Run from the root of a checkout (it takes ``chip_smoke.py``'s phase-2
tables from there).  One process on one card; every comparison is made in
turns (A, B, B, A per round), as ``k1_ab``'s.  The libraries are built from
sources when the script runs, all at once, one per product (``pair``: K2/K3
in ``pair_kernels.cu``; ``mv``: K4/K5 in ``tile_mv.cu``):

* ``head``: this checkout's source;
* ``parent`` (with ``--parent``): DIR's ``fos_tpu_torch/csrc/`` source as
  it is, timed through its own lane entries (``fos_band_pair_lanes``,
  ``fos_bell_pair_lanes``, ``fos_band_mv_lanes``, ``fos_bell_mv_lanes``),
  whose records have not changed since the lane kernels were ported (the
  pair's parent is given twice the head's partials: before its redesign
  its y1 partials went to memory too).  Unpack DIR with ``git archive``
  into a directory that ``.gitignore`` lists (``build/``);
* with ``--ablations``, the head built again from a copy of the sources
  with lines edited (``ABLATIONS`` for the pair, ``MV_ABLATIONS`` for
  K4/K5: what each removes from the lane kernel; their outputs are wrong
  by design and only timed), which says where the lane kernel's time goes.
  An ablation whose lines a later change removed is skipped, with a note.

Lines printed (also appended to ``--out``), times in us per call:

* ``ptxas``: each library's registers, spills and shared memory of its
  lane kernels, and the head's resident blocks per SM;
* ``tile_lanes``: per table and lane count (1, 2, 31; the lanes rows of a
  larger state, 4 floats past their length): the pair on phase 2's banded
  256 x 3 and scattered 256 x 4 tables of 128 x 128 tiles, K4/K5 on those
  tables (``mv``) and on their A' tables (``rmv``: the scattered one
  ragged, up to 16 slots); ``device`` (the profiler's kernel durations,
  summed, by kernel) and ``graph`` (50 calls captured in one CUDA graph and
  replayed) of each library's lane entry; each lane's bits against the
  single kernel of the head's library (``fos_band_pair``, ``fos_bell_pair``,
  ``fos_band_mv``, ``fos_bell_mv``) on its vectors; ``head_won``: of the
  graph samples taken in turns, how many of the head's are below the
  parent's in the same place; at one lane the single kernel is timed in
  the same turns, and ``head_over_single`` is the ratio of the medians of
  the graph times; at 31 lanes, with ``--ablations``, each ablation timed
  in turns with the head (one round).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.linalg.sparse_ell import lane_task_order
from fos_tpu_torch.tools.k1_ab import Call, emit, summary, turns

LANE_COUNTS = (1, 2, 31)
_TRADE = "  for (int n = 0; n < kN; ++n) trade_halves<{h}>(d[n], l, {h});"
#: name: [(source file, a line, the line the ablation has instead), ...]
ABLATIONS = {
    # the row sums' shuffles and selects, for 15 plain adds a lane
    "no_tree": [
        ("pair_kernels.cu", _TRADE.format(h=8),
         "  for (int n = 0; n < kN; ++n)\n"
         "    for (int i = 1; i < kGroupRows; ++i) d[n][0] += d[n][i];"),
        ("pair_kernels.cu", _TRADE.format(h=4), ""),
        ("pair_kernels.cu", _TRADE.format(h=2), ""),
        ("pair_kernels.cu", "    trade_halves<1>(d[n], l, 1);", "")],
    # the column totals' reads, adds and stores after the exchange
    "no_column_totals": [
        ("pair_kernels.cu", "        if (q0 + h < nc) {",
         "        if (q0 + h < 0) {")],
    # the column chains' FMAs (half the FMAs)
    "no_column_chains": [
        ("pair_kernels.cu",
         "          za[n][k] = fmaf(a[i][k], z[n][j], za[n][k]);",
         "          ;")],
    # one lane a pass in place of two
    "one_lane_a_pass": [
        ("pair_kernels.cu", "constexpr int kLanePass = 2;",
         "constexpr int kLanePass = 1;")],
}
_TILES = "          for (int u = 0; u < kTileCopies; ++u)"
_EXPECT = "          mbar_expect_tx(&full[k], kTileFloats * 4);"
_XS = ("        for (int j = 0; j < nl; ++j) cp_async16(xd + j * kTile, "
       "xs + j * ldx);")
_NO_TILES = [("tile_mv.cu", _TILES, "          for (int u = 0; u < 0; ++u)"),
             ("tile_mv.cu", _EXPECT,
              "          mbar_expect_tx(&full[k], 0);")]
_NO_XS = [("tile_mv.cu", _XS, "")]
_FMA = "            v = fmaf(a[i].{c}, xv.{c}, v);"
#: K4/K5 over lanes: name: [(source file, a line, its replacement), ...]
MV_ABLATIONS = {
    # no copies: the stages' mbarriers complete on the arrivals alone and
    # the FMAs run on whatever the stages hold
    "no_copies": _NO_TILES + _NO_XS,
    # the x windows' copies only, or the tile rows' only
    "no_tile_copies": _NO_TILES,
    "no_x_copies": _NO_XS,
    # a quarter of the FMAs (the .x column of each float4)
    "quarter_fmas": [("tile_mv.cu", _FMA.format(c=c), "")
                     for c in ("y", "z", "w")],
    # the row tree's shuffles, for adds in the thread
    "no_tree": [("tile_mv.cu",
                 "    trade_levels<kSetSums, kColThreads / 2>(acc, lane);",
                 "    for (int q = 4; q < kSetSums; ++q) acc[q % 4] += "
                 "acc[q];")],
    # two stages in every shape (one item in flight)
    "two_stages": [("tile_mv.cu",
                    "  static constexpr int kStages = kSets == 1 ? 2 : 4;",
                    "  static constexpr int kStages = 2;")],
    # 4 rows x 8 lanes a thread at 4 float4 columns (48 shared-memory
    # reads a slot against 32; the tree's levels 16 and 8 local)
    "four_columns": [
        ("tile_mv.cu", "constexpr int kColThreads = 16;  // threads across "
         "a tile row", "constexpr int kColThreads = 8;")],
    # K5's row blocks in row order, every round forwards
    "rows_in_order": [
        ("tile_mv.cu",
         "  __device__ int row_of(int rank) const { return order[rank]; }",
         "  __device__ int row_of(int rank) const { return rank; }"),
        ("tile_mv.cu",
         "    return k * grid + (k & 1 ? grid - 1 - b : b);",
         "    return k * grid + b;")],
}
SOURCES = {"pair": "pair_kernels.cu", "mv": "tile_mv.cu"}
ENTRIES = ("fos_band_pair", "fos_bell_pair", "fos_band_pair_lanes",
           "fos_bell_pair_lanes", "fos_pair_lanes_occupancy", "fos_band_mv",
           "fos_bell_mv", "fos_band_mv_lanes", "fos_bell_mv_lanes",
           "fos_mv_lanes_occupancy")


def _load(path):
    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
    return lib


def _ptxas(report):
    """ptxas's lines about the lane kernels: the entry's name, then its
    stack and spills, then its registers and shared memory."""
    out, keep = [], False
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            keep = "pair_lanes" in ln or "tile_mv_lanes" in ln
        if keep and ("Compiling" in ln or "spill" in ln
                     or "registers" in ln):
            out.append(ln.strip())
    return out


def ablation_sources(product, name, edits):
    """A copy of the head's sources with ``edits`` made (None if a line is
    not found once)."""
    src = _cuda.BUILD_DIR / "tile_lanes_ab" / "ablations" / product / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.SRC_DIR, src)
    for fname, line, instead in edits:
        text = (src / fname).read_text()
        if text.count(line) != 1:
            print(f"tile_lanes_ab: {name} skipped: {fname} has "
                  f"{text.count(line)} lines '{line}'", flush=True)
            return None
        (src / fname).write_text(text.replace(line, instead))
    return src / edits[0][0]


def libraries(products, parent, ablations=False):
    """({(product, name): loaded library}, {(product, name): ptxas
    lines}): each product's source of the head and the parent and its
    ablations, each built alone, all at once."""
    srcs = {}
    for product in products:
        fname = SOURCES[product]
        srcs[product, "head"] = _cuda.SRC_DIR / fname
        if parent:
            srcs[product, "parent"] = (Path(parent).resolve() / "fos_tpu_torch"
                                       / "csrc" / fname)
        table = ABLATIONS if product == "pair" else MV_ABLATIONS
        for name, edits in table.items() if ablations else ():
            src = ablation_sources(product, name, edits)
            if src is not None:
                srcs[product, name] = src

    def build(key):
        product, name = key
        out = (_cuda.BUILD_DIR / "tile_lanes_ab" / product / name
               / f"lib{product}_{name}.so")
        return out, _ptxas(_cuda.build_library(out, [srcs[key]]))

    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(build, srcs)))
    libs = {k: _load(out) for k, (out, _) in built.items()}
    return libs, {f"{p}.{n}": rep for (p, n), (_, rep) in built.items()}


def blocks_per_sm(lib, product):
    """The head's resident blocks per SM of its lane kernels (K4/K5: at 8
    and 32 lanes a chunk); sets their shared memory first."""
    entry, n = (("fos_pair_lanes_occupancy", 2) if product == "pair" else
                ("fos_mv_lanes_occupancy", 4))
    out = (ctypes.c_longlong * n)()
    rec = (ctypes.c_longlong * 1)(ctypes.addressof(out))
    if getattr(lib, entry)(ctypes.addressof(rec)):
        raise RuntimeError(f"{entry} failed")
    if product == "pair":
        return {"band": out[0], "bell": out[1]}
    return {"band": list(out[:2]), "bell": list(out[2:])}


def table_slots(op):
    """A tile operator's fixed record slots, as its pair entries list them
    (``fos_band_pair``: blocks, cs, nrb, S, inv_ptr, inv_idx, ncb_out;
    ``fos_bell_pair``: blocks, cols, counts, nrb, kmax, inv_ptr, inv_idx,
    ncb)."""
    nrb, slots = op.blocks.shape[:2]
    index = (op.cs,) if op.kind == "band" else (op.cols, op.counts)
    return [op.blocks.data_ptr(), *(t.data_ptr() for t in index), nrb,
            slots, op.inv_ptr.data_ptr(), op.inv_idx.data_ptr(), op._xrows]


def lane_call(lib, op, XB, ZB):
    """``fos_{kind}_pair_lanes`` of ``lib`` on the lanes XB, ZB."""
    L, (nrb, slots) = XB.shape[0], op.blocks.shape[:2]
    part = torch.empty(L * 2 * nrb * slots * _cuda.TILE, device=XB.device)
    Y1 = torch.empty(L, nrb, _cuda.TILE, device=XB.device)
    Y2 = torch.empty(L, op._xrows, _cuda.TILE, device=XB.device)
    fixed = table_slots(op)
    slots_ = [*fixed, L, part.data_ptr(), XB.data_ptr(), XB.stride(0),
              ZB.data_ptr(), ZB.stride(0), Y1.data_ptr(), Y2.data_ptr(), 0]
    call = Call(lib, f"fos_{op.kind}_pair_lanes", slots_, len(slots_) - 1,
                (Y1, Y2))
    call.keep = (op, XB, ZB, part)
    return call


def single_call(lib, op, xb, zb):
    """``fos_{kind}_pair`` of ``lib`` on one lane's xb, zb."""
    nrb, slots = op.blocks.shape[:2]
    part = torch.empty(2 * nrb * slots * _cuda.TILE, device=xb.device)
    y1 = torch.empty(nrb, _cuda.TILE, device=xb.device)
    y2 = torch.empty(op._xrows, _cuda.TILE, device=xb.device)
    slots_ = [*table_slots(op), part.data_ptr(), xb.data_ptr(),
              zb.data_ptr(), y1.data_ptr(), y2.data_ptr(), 0]
    call = Call(lib, f"fos_{op.kind}_pair", slots_, len(slots_) - 1,
                (y1, y2))
    call.keep = (op, xb, zb, part)
    return call


def mv_table(op, direction, order=True):
    """(fixed record slots, x rows, tensors to keep) of K4/K5 over the A
    table ("mv") or the A' table ("rmv"), as ``fos_band_mv`` /
    ``fos_bell_mv`` list the slots (blocks, cs, nrb, S; blocks, cols,
    counts, nrb, kmax); with ``order``, K5's lane entry's row order after
    them (``sparse_ell.lane_task_order``: the parent's lane entry has
    none)."""
    blocks, index, counts = ((op.blocks, op.cs if op.kind == "band" else
                              op.cols, getattr(op, "counts", None))
                             if direction == "mv" else op.transposed())
    nrb, slots = blocks.shape[:2]
    fixed = [blocks.data_ptr(), index.data_ptr(),
             *(() if counts is None else (counts.data_ptr(),)), nrb, slots]
    keep = [blocks, index, counts]
    if order and counts is not None:
        keep.append(lane_task_order(counts))
        fixed.append(keep[-1].data_ptr())
    rows = op._xrows if direction == "mv" else op._yrows_t
    return fixed, rows, keep


def mv_lane_call(lib, op, direction, XB, order=True):
    """``fos_{kind}_mv_lanes`` of ``lib`` on the lanes XB."""
    fixed, _, keep = mv_table(op, direction, order)
    nrb = (op.blocks if direction == "mv" else op.transposed()[0]).shape[0]
    Y = torch.empty(XB.shape[0], nrb, _cuda.TILE, device=XB.device)
    slots_ = [*fixed, XB.shape[0], XB.data_ptr(), XB.stride(0),
              Y.data_ptr(), 0]
    call = Call(lib, f"fos_{op.kind}_mv_lanes", slots_, len(slots_) - 1,
                (Y,))
    call.keep = (keep, XB)
    return call


def mv_single_call(lib, op, direction, xb):
    """``fos_{kind}_mv`` of ``lib`` on one lane's xb."""
    fixed, _, keep = mv_table(op, direction, order=False)
    y = torch.empty(fixed[-2], _cuda.TILE, device=xb.device)
    slots_ = [*fixed, xb.data_ptr(), y.data_ptr(), 0]
    call = Call(lib, f"fos_{op.kind}_mv", slots_, len(slots_) - 1, (y,))
    call.keep = (keep, xb)
    return call


def lanes_of(g, L, rows, dev):
    """(L, rows, 128) lanes, rows of a larger state 4 floats past their
    length (16-byte aligned, as the operators' padded vectors are)."""
    big = torch.as_tensor(g.standard_normal((L, rows * _cuda.TILE + 4),
                                            dtype=np.float32), device=dev)
    return big[:, :rows * _cuda.TILE].unflatten(1, (rows, _cuda.TILE))


def tables(dev):
    """phase 2's banded and scattered operators (``chip_smoke.py``)."""
    from chip_smoke import NRB, TILE, banded_tables, scattered_tables
    from fos_tpu_torch import BandedBlockOp, BlockedEllOp

    m = n = NRB * TILE
    blk, cs, _ = banded_tables()
    band = BandedBlockOp.from_arrays(blk, cs, m, n, transpose_table=True,
                                     device=dev)
    blk, cols, _ = scattered_tables()
    ell = BlockedEllOp.from_arrays(blk, cols, m, n, transpose_table=True,
                                   device=dev)
    return {"banded": band, "scattered": ell}


def cells(product, op, g, dev, L, libs, names):
    """(lane calls by library, the head's single calls, the lanes) of one
    table at L lanes: the pair over the A table, or K4/K5 over the A
    ("mv") or A' ("rmv") table."""
    if product == "pair":
        nrb = op.blocks.shape[0]
        XB, ZB = lanes_of(g, L, op._xrows, dev), lanes_of(g, L, nrb, dev)
        calls = {n: lane_call(libs[product, n], op, XB, ZB) for n in names}
        singles = [single_call(libs[product, "head"], op, XB[b], ZB[b])
                   for b in range(L)]
        return calls, singles, lambda lib: lane_call(lib, op, XB, ZB)
    direction = product.split(".")[1]
    XB = lanes_of(g, L, mv_table(op, direction)[1], dev)
    calls = {n: mv_lane_call(libs["mv", n], op, direction, XB,
                             order=n != "parent") for n in names}
    singles = [mv_single_call(libs["mv", "head"], op, direction, XB[b])
               for b in range(L)]
    return calls, singles, lambda lib: mv_lane_call(lib, op, direction, XB)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent",
                    help="checkout holding the other sources")
    ap.add_argument("--products", default="pair,mv",
                    help="comma-separated: pair (K2/K3), mv (K4/K5)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="build/tile_lanes_ab.jsonl")
    ap.add_argument("--ablations", action="store_true",
                    help="also time the head with the ablations' edits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_lanes_ab: no CUDA device")
    products = args.products.split(",")
    if not set(products) <= set(SOURCES):
        raise SystemExit(f"tile_lanes_ab: products are {sorted(SOURCES)}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda}, args.out)
    libs, ptxas = libraries(products, args.parent, args.ablations)
    emit({"what": "ptxas", **ptxas, "head_blocks_per_sm": {
        p: blocks_per_sm(libs[p, "head"], p) for p in products}}, args.out)
    g = np.random.default_rng(5)
    ops = tables(dev)
    for product in products:
        names = [n for n in ("parent", "head") if (product, n) in libs]
        ablated = [n for p, n in libs if p == product and n not in names]
        labels = (["pair"] if product == "pair" else ["mv.mv", "mv.rmv"])
        for table, op in ops.items():
            for label in labels:
                for L in LANE_COUNTS:
                    calls, singles, make = cells(label, op, g, dev, L, libs,
                                                 names)
                    emit(lane_row(label, table, op, L, calls, singles, make,
                                  ablated, libs, product, args.rounds),
                         args.out)
    return 0


def lane_row(label, table, op, L, calls, singles, make, ablated, libs,
             product, rounds):
    """One ``tile_lanes`` line: bits against the single kernel, the lane
    entries timed in turns, the ablations at 31 lanes."""
    want = [tuple(t.clone() for t in s()) for s in singles]
    bits = {}
    for n, c in calls.items():
        got = c()
        bits[n] = all(torch.equal(y[b], w) for b, ws in enumerate(want)
                      for y, w in zip(got, ws))
    if L == 1:
        calls["single"] = singles[0]
    row = {"what": "tile_lanes", "product": label, "table": table,
           "shape": list((op.blocks if label != "mv.rmv" else
                          op.transposed()[0]).shape),
           "lanes": L, "bit_equal_to_single": bits}
    row.update({n: summary(r) for n, r in turns(calls, rounds).items()})
    if ablated and L == LANE_COUNTS[-1]:
        # each ablation against the head, in turns, one round
        for n in ablated:
            pair = {"head": calls["head"], n: make(libs[product, n])}
            row[n] = summary(turns(pair, 1)[n])
    if "parent" in row:
        row["head_won"] = [sum(h < p for p, h in zip(
            row["parent"]["graph"], row["head"]["graph"])),
            len(row["head"]["graph"])]
    row["medians"] = {n: {k: float(np.median(row[n][k]))
                          for k in ("device", "graph")}
                      for n in (*calls, *ablated) if n in row}
    if L == 1:
        row["head_over_single"] = (row["medians"]["head"]["graph"]
                                   / row["medians"]["single"]["graph"])
    return row


if __name__ == "__main__":
    raise SystemExit(main())
