"""Launch-cost probe: the per-call cost of small kernels and of the tile
products on the card, by differential timing.

    python3 -m fos_tpu_torch.tools.launch_probe

The port of ``tools/launch_probe.py``.  It holds the probe kernels P1
(:func:`probe_tiny`, the port of its ``tiny``) and P2
(:func:`probe_prefetch`, of ``pref``), written in CUDA (``csrc/probe.cu``)
with their plain PyTorch versions, and :func:`main`, which prints the
per-call cost of: torch's tiny multiply, P1, P2, ``torch.mv`` at 4096^2
and 8192^2, and K4/K5 ``mv`` on block-tridiagonal tables at nrb = 64 and
256 (with the rate at which they read the table).

The method (:func:`time_chain_diff`) times a chain of R dependent calls
and one of 2R with CUDA events and reports ``(T(2R) - T(R)) / R``: the
fixed costs of a chain (the first launch's latency, the final
synchronisation, the events themselves) cancel, and what remains is what
one more call in a dependent sequence costs, host launch and device time
together, as a solve's loop pays it.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from fos_tpu_torch.linalg import _cuda

SCALE = 1.0000001  # y = x * SCALE, one f32 rounding
DENSE_SIDES = (4096, 8192)   # torch.mv probes
TABLE_NRBS = (64, 256)       # K4/K5 mv probes: 12 and 48 MiB tables


def probe_tiny_plain(x):
    return x * SCALE


def probe_prefetch_plain(idx, x):
    """The result does not depend on ``idx`` (the operand P2 loads)."""
    return x * SCALE


_bound = {}


def _probe_kernel(name, x, idx=None):
    """P1 (``idx`` None) or P2 bound to x's device and shape (and idx's
    length), made once per key: the route every kernel wrapper takes."""
    key = (name, x.get_device(), x.shape, None if idx is None else idx.shape)
    k = _bound.get(key)
    if k is None:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {x.device}")
        f32, n = torch.float32, x.numel()
        if idx is None:
            k = _cuda.Kernel(name, "fos_probe_tiny", x.device, (n,),
                             ins=((x.shape, f32),), outs=(x.shape,))
        else:
            if idx.dim() != 1 or idx.numel() > 256:
                raise ValueError(f"{name}: idx must be (k,) with k <= 256")
            k = _cuda.Kernel(name, "fos_probe_prefetch", x.device,
                             (n, idx.numel()),
                             ins=((idx.shape, torch.int32), (x.shape, f32)),
                             outs=(x.shape,))
        _bound[key] = k
    return k


def probe_tiny(x):
    """P1: ``x * 1.0000001``; x is an (8, 128) f32 tile (one block), or
    any contiguous f32 tensor (a block per 1024 elements).  An x that is
    not 16-byte aligned takes the kernel's scalar loads."""
    if x.is_cuda:
        return _probe_kernel("probe_tiny", x)(x)
    if x.device.type == "cpu":
        return probe_tiny_plain(x)
    raise ValueError(f"probe_tiny: unsupported device {x.device}")


def probe_prefetch(idx, x):
    """P2: P1 with an (8,) int32 operand (at most 256 long) that each block
    loads beside its tile (the TPU kernel's scalar prefetch); the result
    does not wait on it."""
    if x.is_cuda:
        return _probe_kernel("probe_prefetch", x, idx)(idx, x)
    if idx.device.type == "cpu" and x.device.type == "cpu":
        return probe_prefetch_plain(idx, x)
    raise ValueError(f"probe_prefetch: unsupported device {x.device}")


def _chain(fn, x, n):
    for _ in range(n):
        x = fn(x)
    return x


def time_chain_diff(fn, x0, reps=200):
    """``fn(x) -> x'``.  Returns (seconds per call, implied fixed seconds)
    of a dependent chain, from the times T(R) and T(2R) of chains of R and
    2R calls: per call ``(T(2R) - T(R)) / R``, fixed ``T(R) - R * per``."""

    def timed(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _chain(fn, x0, n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    timed(reps)                     # warm up
    timed(2 * reps)
    t1, t2 = timed(reps), timed(2 * reps)
    per = (t2 - t1) / reps
    return max(per, 1e-12), t1 - reps * per


def _banded_ops(nrb, device):
    """Block-tridiagonal tables (the probe of ``tools/launch_probe.py``):
    a banded and a blocked-ELL operator over the same tiles."""
    from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp, BlockedEllOp

    rng = np.random.default_rng(1)
    blocks = rng.standard_normal((nrb, 3, 128, 128), dtype=np.float32) * 1e-2
    cs = np.clip(np.arange(nrb) - 1, 0, nrb - 3).astype(np.int32)
    i = np.arange(nrb)
    cols = np.stack([np.maximum(i - 1, 0), i, np.minimum(i + 1, nrb - 1)], 1)
    n = nrb * 128
    band = BandedBlockOp.from_arrays(blocks, cs, n, n, device=device)
    ell = BlockedEllOp.from_arrays(blocks, cols.astype(np.int32), n, n,
                                   device=device)
    return band, ell, blocks.nbytes


def main(device=None) -> list:
    """Print one line per probe and return them as dictionaries."""
    if not torch.cuda.is_available():
        raise RuntimeError("the launch probe times the card: no CUDA device")
    dev = torch.device(device or "cuda")
    rows = []

    def report(name, fn, x0, reps=200, nbytes=None):
        per, fixed = time_chain_diff(fn, x0, reps)
        row = {"probe": name, "us_per_call": per * 1e6,
               "fixed_ms": fixed * 1e3}
        line = f"{name:28s} {per * 1e6:9.2f} us/call (fixed {fixed * 1e3:.2f} ms)"
        if nbytes is not None:
            row["GB_per_s"] = nbytes / per / 1e9
            line += f"  {row['GB_per_s']:7.1f} GB/s"
        print(line, flush=True)
        rows.append(row)

    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    report("torch tiny mul", probe_tiny_plain, x)
    report("P1 probe_tiny", probe_tiny, x)
    report("P2 probe_prefetch", lambda v: probe_prefetch(idx, v), x)
    for m in DENSE_SIDES:
        g = torch.Generator(device="cpu").manual_seed(0)
        A = torch.randn((m, m), generator=g).to(dev)
        report(f"torch.mv {m}^2", lambda v: torch.mv(A, v) * 1e-3 + 1.0,
               torch.ones(m, device=dev), reps=100, nbytes=4 * m * m)
        del A
    for nrb in TABLE_NRBS:
        band, ell, nbytes = _banded_ops(nrb, dev)
        x0 = torch.ones(nrb * 128, device=dev)
        for name, op in (("band", band), ("ell", ell)):
            report(f"{name} mv nrb={nrb} ({nbytes / 2**20:.0f} MiB)",
                   lambda v: op.mv(v) * 1e-30 + 1.0, x0, nbytes=nbytes)
    return rows


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("launch_probe: no CUDA device", file=sys.stderr)
        sys.exit(2)
    main()
