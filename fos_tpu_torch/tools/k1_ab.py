"""K1, the dense pair, and the launch probes P1/P2, timed on the card
against another build of themselves.

    python3 -m fos_tpu_torch.tools.k1_ab [--parent DIR] [--rounds R]
                                         [--out FILE] [--probe-only]

One process on one card; every comparison is made in turns (A, B, B, A
per round).  The libraries are built from sources when the script runs:

* ``head``: this checkout's kernel library (``linalg/_cuda.build``);
* ``parent`` (with ``--parent``): DIR's ``fos_tpu_torch/csrc/
  pair_kernels.cu`` and ``probe.cu`` as they are, timed through their own
  ``fos_dense_pair`` (whose launch record, A, M, N, partials, x1, x2, y,
  z, stream, has not changed since K1 was ported) and probe entries.
  Unpack DIR with ``git archive`` into a directory that ``.gitignore``
  lists (``build/``);
* ablations of ``head``, each built from a copy of the sources with one
  line edited (``ABLATIONS``; the library itself has no such switch):
  ``nocount`` without the device launch counters, which prices them, and
  ``nopdl`` with K1's sums launched as plain launches, which prices the
  programmatic dependent launch.  An ablation whose line a later change
  removed is skipped, with a note.

Lines printed (also appended to ``--out``), times in us per call:

* ``k1``: the single-vector pair at 1000^2, 4000^2 and ``chip_smoke.py``'s
  edge shapes, each library's ``fos_dense_pair`` (parent, head, nopdl) on
  the same inputs:
  ``device`` (the profiler's kernel durations, summed, by kernel) and
  ``graph`` (50 calls captured in one CUDA graph and replayed, launch gaps
  included); the outputs' bits against the first library's; with a
  parent, ``head_won``: of the samples taken in turns, how many of the
  head's graph times are below the parent's sample in the same place;
* ``k1_counters``: head against nocount, in turns;
* ``k1_lanes``: the lane kernel over 31 lanes against 31 single-vector
  calls on the same vectors (head and nopdl), bits compared;
* ``yardstick``: ``torch.mv(A, x)`` and ``torch.mv(A.T, z)`` (two cuBLAS
  calls), and over 31 lanes ``torch.matmul(X, A.T)`` and
  ``torch.matmul(Z, A)``;
* ``probe``: the launch probes of ``csrc/probe.cu`` on one (8, 128) f32
  tile, in turns: P1 (``fos_probe_tiny``) and P2 (``fos_probe_prefetch``,
  an (8,) index) of the parent (its ``probe.cu`` built beside its
  ``pair_kernels.cu``, through its own entry points, whose records have
  not changed since the probes were ported) and of the head; the head's
  P1 on the same tile starting 4 bytes into a buffer (its unaligned
  path); ``torch.mul`` on the tile and on a (1,) tensor (the card's
  launch floor), timed only.  ``device`` and ``graph`` as for ``k1``,
  their medians, each output's bits against ``torch.mul``'s and, with a
  parent, ``p1_head_won`` and ``p2_head_won`` (device and graph samples).

``--probe-only`` prints the probe line alone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.tools.launch_probe import SCALE

SHAPES = ((1000, 1000), (4000, 4000), (1, 4000), (4000, 1), (5000, 300),
          (300, 5000))
YARDSTICK_SHAPES = ((1000, 1000), (4000, 4000))
LANES = 31
GRAPH_CALLS, GRAPH_REPS, PROFILE_CALLS = 50, 10, 50
ENTRIES = ("fos_dense_pair", "fos_dense_pair_lanes", "fos_probe_tiny",
           "fos_probe_prefetch")
#: name: (source file, its line, the line the ablation has instead)
ABLATIONS = {
    "nocount": ("common.cuh", "atomicAdd(&launch_count[id], 1ull);", ";"),
    "nopdl": ("pair_kernels.cu", "cfg.numAttrs = 1;", "cfg.numAttrs = 0;"),
}


def _load(path):
    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
    lib.fos_dense_tile_rows.restype = ctypes.c_int
    return lib


def libraries(parent):
    """({name: loaded library}, each built from its sources; {name: ptxas's
    register and spill lines of pair_kernels.cu})."""
    head = _cuda.library_path()
    _cuda.build()
    libs, reports = {"head": _load(head)}, {}
    for name, (fname, line, instead) in ABLATIONS.items():
        src = _cuda.BUILD_DIR / "k1_ab" / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_cuda.SRC_DIR, src)
        text = (src / fname).read_text()
        if text.count(line) != 1:
            print(f"k1_ab: {name} skipped: {fname} has {text.count(line)} "
                  f"lines '{line}'", flush=True)
            continue
        (src / fname).write_text(text.replace(line, instead))
        path = src / f"lib{name}.so"
        reports[name] = _cuda.build_library(
            path, sorted(p for p in src.iterdir() if p.suffix == ".cu"))
        libs[name] = _load(path)
    if parent:
        src = Path(parent).resolve() / "fos_tpu_torch" / "csrc"
        out = _cuda.BUILD_DIR / "k1_ab" / "parent" / "libparent.so"
        _cuda.build_library(out, [src / "pair_kernels.cu", src / "probe.cu"])
        libs["parent"] = _load(out)
    return libs, {name: [ln.strip() for ln in r.splitlines()
                         if "dense_pair" in ln or "probe" in ln
                         or "registers" in ln or "spill" in ln]
                  for name, r in reports.items()}


class Call:
    """One entry point of one library bound to its operands: ``slots`` as
    the entry's record lists them, the stream last or at ``stream_slot``;
    the outputs are allocated once, so a graph can capture the call."""

    def __init__(self, lib, entry, slots, stream_slot, outs):
        self.fn = getattr(lib, entry)
        self.rec = (ctypes.c_longlong * len(slots))(*slots)
        self.addr = ctypes.addressof(self.rec)
        self.stream_slot, self.outs = stream_slot, outs

    def __call__(self):
        self.rec[self.stream_slot] = torch._C._cuda_getCurrentRawStream(0)
        rc = self.fn(self.addr)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return self.outs


def k1_call(lib, A, x1, x2):
    """``fos_dense_pair`` of ``lib`` on A, x1, x2, with its own partial sums
    and outputs."""
    M, N = A.shape
    rows = lib.fos_dense_tile_rows()
    part = torch.empty(-(-N // _cuda.TILE) * M + -(-M // rows) * N,
                       device=A.device)
    y, z = torch.empty(M, device=A.device), torch.empty(N, device=A.device)
    slots = [A.data_ptr(), M, N, part.data_ptr(), x1.data_ptr(),
             x2.data_ptr(), y.data_ptr(), z.data_ptr(), 0]
    call = Call(lib, "fos_dense_pair", slots, 8, (y, z))
    call.keep = (A, x1, x2, part)
    return call


def lanes_call(lib, A, X1, X2):
    """``fos_dense_pair_lanes`` of ``lib`` on A and the lanes X1, X2."""
    (M, N), B = A.shape, X1.shape[0]
    rows = lib.fos_dense_tile_rows()
    part = torch.empty(B * (-(-N // _cuda.TILE) * M + -(-M // rows) * N),
                       device=A.device)
    Y = torch.empty(B, M, device=A.device)
    Z = torch.empty(B, N, device=A.device)
    call = Call(lib, "fos_dense_pair_lanes",
                [A.data_ptr(), M, N, B, part.data_ptr(), X1.data_ptr(),
                 X1.stride(0), X2.data_ptr(), X2.stride(0), Y.data_ptr(),
                 Z.data_ptr(), 0], 11, (Y, Z))
    call.keep = (A, X1, X2, part)
    return call


def device_us(fn, calls=PROFILE_CALLS):
    """The profiler's device time of one call (us), by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"\w+(?=[<(])", e.key)
            name = m.group(0) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    return out


def graph_us(fn, calls=GRAPH_CALLS, reps=GRAPH_REPS):
    """One call's time (us) in a graph of ``calls`` calls, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * calls)


def timed(fn):
    by_kernel = device_us(fn)
    return {"device": sum(by_kernel.values()), "by_kernel": by_kernel,
            "graph": graph_us(fn)}


def turns(calls, rounds):
    """{name: [measurements]} over ``rounds`` rounds of A, B, B, A."""
    names = list(calls)
    order = names + names[::-1]
    out = {n: [] for n in names}
    for _ in range(rounds):
        for n in order:
            out[n].append(timed(calls[n]))
    return out


def summary(runs):
    return {"device": [r["device"] for r in runs],
            "graph": [r["graph"] for r in runs],
            "by_kernel": runs[0]["by_kernel"]}


def probe_row(libs, dev, rounds):
    """The ``probe`` line: P1 and P2 of each library and ``torch.mul`` on
    the same (8, 128) tile and on a (1,) tensor, in turns."""
    g = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn(8, 128, generator=g).to(dev)
    one = x.reshape(-1)[:1].clone()
    # the same tile starting 4 bytes into a buffer (P1's unaligned path)
    shifted = torch.empty(x.numel() + 4, device=dev)[1:1 + x.numel()]
    shifted.copy_(x.reshape(-1))
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    want = torch.mul(x, SCALE)

    def tiny(lib, src):
        y = torch.empty_like(x)
        return Call(lib, "fos_probe_tiny",
                    [x.numel(), src.data_ptr(), y.data_ptr(), 0], 3, (y,))

    def pref(lib):
        y = torch.empty_like(x)
        return Call(lib, "fos_probe_prefetch",
                    [x.numel(), idx.numel(), idx.data_ptr(), x.data_ptr(),
                     y.data_ptr(), 0], 5, (y,))

    calls = {}
    for name in (n for n in ("parent", "head") if n in libs):
        calls[f"p1_{name}"] = tiny(libs[name], x)
        calls[f"p2_{name}"] = pref(libs[name])
    calls["p1_head_unaligned"] = tiny(libs["head"], shifted)
    bits = {n: bool(torch.equal(c()[0], want)) for n, c in calls.items()}
    calls["mul_tile"] = lambda: torch.mul(x, SCALE)
    calls["mul_floor"] = lambda: torch.mul(one, SCALE)
    row = {"what": "probe", "shape": [8, 128], "bit_equal_to_mul": bits,
           **{n: summary(r) for n, r in turns(calls, rounds).items()}}
    row["medians"] = {n: {k: float(np.median(row[n][k]))
                          for k in ("device", "graph")} for n in calls}
    if "parent" in libs:
        for p in ("p1", "p2"):
            row[f"{p}_head_won"] = {k: [sum(h < q for q, h in zip(
                row[f"{p}_parent"][k], row[f"{p}_head"][k])),
                len(row[f"{p}_head"][k])] for k in ("device", "graph")}
    return row


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent",
                    help="checkout holding the other K1 and probes")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="build/k1_ab.jsonl")
    ap.add_argument("--probe-only", action="store_true",
                    help="print only the probe line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_ab: no CUDA device")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda}, args.out)
    libs, ptxas = libraries(args.parent)
    emit({"ptxas": ptxas}, args.out)
    rng = np.random.default_rng(3)

    def vec(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                               device=dev)

    pair_libs = [n for n in ("parent", "head", "nopdl") if n in libs]
    lane_libs = [n for n in ("head", "nopdl") if n in libs]
    for M, N in () if args.probe_only else SHAPES:
        A, x1, x2 = vec(M, N), vec(N), vec(M)
        calls = {n: k1_call(libs[n], A, x1, x2) for n in pair_libs}
        first = calls[pair_libs[0]]()
        bits = {n: all(torch.equal(a, b) for a, b in zip(c(), first))
                for n, c in calls.items()}
        row = {"what": "k1", "shape": [M, N], "bit_equal_to_first": bits}
        row.update({n: summary(r) for n, r in turns(calls, args.rounds)
                    .items()})
        if "parent" in row:
            row["head_won"] = [sum(h < p for p, h in zip(
                row["parent"]["graph"], row["head"]["graph"])),
                len(row["head"]["graph"])]
        emit(row, args.out)
        if "nocount" in libs:
            counted = {n: k1_call(libs[n], A, x1, x2)
                       for n in ("head", "nocount")}
            emit({"what": "k1_counters", "shape": [M, N],
                  **{n: summary(r) for n, r in turns(counted, 1).items()}},
                 args.out)
        if (M, N) in YARDSTICK_SHAPES:
            X1, X2 = vec(LANES, N), vec(LANES, M)
            singles = [k1_call(libs["head"], A, X1[b], X2[b])
                       for b in range(LANES)]

            def all_singles():
                for c in singles:
                    c()

            calls, bits = {"singles": all_singles}, {}
            for n in lane_libs:
                calls[n] = lanes_call(libs[n], A, X1, X2)
                Y, Z = calls[n]()
                bits[n] = all(torch.equal(Y[b], singles[b]()[0])
                              and torch.equal(Z[b], singles[b]()[1])
                              for b in range(LANES))
            runs = turns(calls, 1)
            emit({"what": "k1_lanes", "shape": [M, N], "lanes": LANES,
                  "bit_equal_to_singles": bits,
                  **{n: summary(r) for n, r in runs.items()}}, args.out)
            emit({"what": "yardstick", "shape": [M, N], "lanes": LANES,
                  "two_mv": timed(lambda: (torch.mv(A, x1),
                                           torch.mv(A.T, x2))),
                  "two_matmul_lanes": timed(lambda: (
                      torch.matmul(X1, A.T), torch.matmul(X2, A)))},
                 args.out)
    emit(probe_row(libs, dev, args.rounds), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
