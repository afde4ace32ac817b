"""K2 and K3 over lanes (the line search's probes through the tile pair),
timed on the card against another build of themselves.

    python3 -m fos_tpu_torch.tools.tile_lanes_ab [--parent DIR]
                                                 [--rounds R] [--out FILE]
                                                 [--ablations]

Run from the root of a checkout (it takes ``chip_smoke.py``'s phase-2
tables from there).  One process on one card; every comparison is made in
turns (A, B, B, A per round), as ``k1_ab``'s.  The libraries are built from
sources when the script runs:

* ``head``: this checkout's ``fos_tpu_torch/csrc/pair_kernels.cu``;
* ``parent`` (with ``--parent``): DIR's ``fos_tpu_torch/csrc/
  pair_kernels.cu`` as it is, timed through its own ``fos_band_pair_lanes``
  and ``fos_bell_pair_lanes``, whose records have not changed since the lane
  kernels were ported (the parent is given twice the head's partials: its
  y1 partials went to memory too).  Unpack DIR with ``git archive`` into a
  directory that ``.gitignore`` lists (``build/``);
* with ``--ablations``, the head built again from a copy of the sources
  with lines edited (``ABLATIONS``: what each removes from the lane
  kernel; their outputs are wrong by design and only timed), which says
  where the lane kernel's time goes.  An ablation whose lines a later
  change removed is skipped, with a note.

Lines printed (also appended to ``--out``), times in us per call:

* ``ptxas``: each library's registers, spills and shared memory of its
  lane kernels, and the head's resident blocks per SM;
* ``tile_lanes``: per table (phase 2's banded 256 x 3 and scattered 256 x 4
  tables of 128 x 128 tiles) and lane count (1, 2, 31; the lanes rows of a
  larger state, 4 floats past their length): ``device`` (the profiler's
  kernel durations, summed, by kernel) and ``graph`` (50 calls captured in
  one CUDA graph and replayed) of each library's lane entry; each lane's
  bits against the single kernel (``fos_band_pair`` / ``fos_bell_pair`` of
  the head's library) on its vectors; ``head_won``: of the graph samples
  taken in turns, how many of the head's are below the parent's in the same
  place; at one lane the single kernel is timed in the same turns, and
  ``head_over_single`` is the ratio of the medians of the graph times; at
  31 lanes, with ``--ablations``, each ablation timed in turns with the
  head (one round).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from fos_tpu_torch.linalg import _cuda
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
ENTRIES = ("fos_band_pair", "fos_bell_pair", "fos_band_pair_lanes",
           "fos_bell_pair_lanes", "fos_pair_lanes_occupancy")


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
            keep = "pair_lanes" in ln
        if keep and ("Compiling" in ln or "spill" in ln
                     or "registers" in ln):
            out.append(ln.strip())
    return out


def ablation_sources(name, edits):
    """A copy of the head's sources with ``edits`` made (None if a line is
    not found once)."""
    src = _cuda.BUILD_DIR / "tile_lanes_ab" / "ablations" / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.SRC_DIR, src)
    for fname, line, instead in edits:
        text = (src / fname).read_text()
        if text.count(line) != 1:
            print(f"tile_lanes_ab: {name} skipped: {fname} has "
                  f"{text.count(line)} lines '{line}'", flush=True)
            return None
        (src / fname).write_text(text.replace(line, instead))
    return src / "pair_kernels.cu"


def libraries(parent, ablations=False):
    """({name: loaded library}, {name: ptxas lines}): the head's and the
    parent's pair_kernels.cu and the ablations, each built alone."""
    srcs = {"head": _cuda.SRC_DIR / "pair_kernels.cu"}
    if parent:
        srcs["parent"] = (Path(parent).resolve() / "fos_tpu_torch" / "csrc"
                          / "pair_kernels.cu")
    for name, edits in ABLATIONS.items() if ablations else ():
        src = ablation_sources(name, edits)
        if src is not None:
            srcs[name] = src
    libs, reports = {}, {}
    for name, src in srcs.items():
        out = _cuda.BUILD_DIR / "tile_lanes_ab" / name / f"lib{name}.so"
        reports[name] = _ptxas(_cuda.build_library(out, [src]))
        libs[name] = _load(out)
    return libs, reports


def blocks_per_sm(lib):
    out = (ctypes.c_longlong * 2)()
    rec = (ctypes.c_longlong * 1)(ctypes.addressof(out))
    if lib.fos_pair_lanes_occupancy(ctypes.addressof(rec)):
        raise RuntimeError("fos_pair_lanes_occupancy failed")
    return {"band": out[0], "bell": out[1]}


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
    band = BandedBlockOp.from_arrays(blk, cs, m, n, device=dev)
    blk, cols, _ = scattered_tables()
    ell = BlockedEllOp.from_arrays(blk, cols, m, n, device=dev)
    return {"banded": band, "scattered": ell}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent",
                    help="checkout holding the other pair_kernels.cu")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="build/tile_lanes_ab.jsonl")
    ap.add_argument("--ablations", action="store_true",
                    help="also time the head with ABLATIONS' edits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_lanes_ab: no CUDA device")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda}, args.out)
    libs, ptxas = libraries(args.parent, args.ablations)
    emit({"what": "ptxas", **ptxas,
          "head_blocks_per_sm": blocks_per_sm(libs["head"])}, args.out)
    names = [n for n in ("parent", "head") if n in libs]
    ablated = [n for n in libs if n not in names]
    g = np.random.default_rng(5)
    for table, op in tables(dev).items():
        nrb = op.blocks.shape[0]
        for L in LANE_COUNTS:
            XB, ZB = lanes_of(g, L, op._xrows, dev), lanes_of(g, L, nrb, dev)
            calls = {n: lane_call(libs[n], op, XB, ZB) for n in names}
            singles = [single_call(libs["head"], op, XB[b], ZB[b])
                       for b in range(L)]
            want = [tuple(t.clone() for t in s()) for s in singles]
            bits = {}
            for n, c in calls.items():
                Y1, Y2 = c()
                bits[n] = all(torch.equal(Y1[b], w1) and torch.equal(Y2[b], w2)
                              for b, (w1, w2) in enumerate(want))
            if L == 1:
                calls["single"] = singles[0]
            row = {"what": "tile_lanes", "table": table,
                   "shape": list(op.blocks.shape), "lanes": L,
                   "bit_equal_to_single": bits}
            row.update({n: summary(r) for n, r in turns(calls, args.rounds)
                        .items()})
            if ablated and L == LANE_COUNTS[-1]:
                # each ablation against the head, in turns, one round
                for n in ablated:
                    pair = {"head": calls["head"],
                            n: lane_call(libs[n], op, XB, ZB)}
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
            emit(row, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
