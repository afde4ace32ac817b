"""chip_smoke.py's wrappers_feasibility cells (phase 7: LineSearch(AP) and
Longstep(DR) on the banded 32768^2 feasibility problem, LineSearch(DR) on
the scattered one, each through its three routes), run in two checkouts in
turns, so that the downstream effect of a change to the tile products is
read on one card in one call.

    python3 -m fos_tpu_torch.tools.feasibility_ab --parent DIR
                                                  [--rounds R] [--out FILE]

Run from the root of a checkout (the head).  DIR is another checkout, whole
(``git archive <commit> | tar -x -C DIR`` into a directory that
``.gitignore`` lists, ``build/``).  Each run is a process of its own in its
checkout (``chip_smoke.py`` and ``fos_tpu_torch`` from there, the kernels
built into that checkout's ``build/``), in the order parent, head, head,
parent per round.  Lines printed (also appended to ``--out``): the card,
then one per run and cell: chip_smoke's ``wrappers_feasibility`` line
(status, iterations, ``graph_iters_per_s``, launches over the three
routes, the probe check) with ``checkout`` and ``round`` added.  Needs the
card; the cells gate themselves (chip_smoke raises if one fails).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from fos_tpu_torch.tools.k1_ab import emit

#: the cells, as chip_smoke.py's main makes their problems
CELLS = r"""
import collections

import numpy as np
import torch

import chip_smoke as cs
from fos_tpu_torch import BandedBlockOp, BlockedEllOp

dev = torch.device("cuda", 0)
blk_band, cols_band, _ = cs.banded_tables()
m = n = blk_band.shape[0] * cs.TILE
band = BandedBlockOp.from_arrays(blk_band, cols_band, m, n,
                                 transpose_table=True, device=dev)
blk_ell, cols_ell, _ = cs.scattered_tables()
ell = BlockedEllOp.from_arrays(blk_ell, cols_ell, m, n, transpose_table=True,
                               device=dev)
x0, s0 = cs.feasibility_vectors(m, n)
band_slots = cols_band[:, None] + np.arange(blk_band.shape[1])
feas = {"band": (band, blk_band, band_slots,
                 cs.host_tile_mv(blk_band, band_slots, x0) + s0),
        "bell": (ell, blk_ell, cols_ell,
                 cs.host_tile_mv(blk_ell, cols_ell, x0) + s0)}
cs.wrapper_feasibility_cells(dev, feas, m, n, collections.Counter())
"""


def run(checkout: Path) -> list:
    """The cells in ``checkout``, in a process of their own: their
    ``wrappers_feasibility`` lines."""
    proc = subprocess.run([sys.executable, "-c", CELLS], cwd=checkout,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"feasibility_ab: {checkout} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    rows = []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            if row.get("phase") == "wrappers_feasibility":
                rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other checkout, whole")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default="build/feasibility_ab.jsonl")
    args = ap.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    checkouts = {"parent": Path(args.parent).resolve(),
                 "head": Path.cwd().resolve()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"card": card}, args.out)
    for rnd in range(args.rounds):
        for name in ("parent", "head", "head", "parent"):
            for row in run(checkouts[name]):
                emit({"checkout": name, "round": rnd, **row}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
