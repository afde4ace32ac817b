"""How far DR gets on tests/test_diff.py's LP family, and what that does to
``diff_solve``'s gradients.

    python3 -m fos_tpu_torch.tools.diff_study [--device cpu]

Prints one JSON line per case (errors scaled by 1 + ||x0||_inf +
||y0||_inf, against the construction's optimum (x0, y0)):

* ``stall``: DR on the direct projection in f64 at eps 1e-8 on ``_lp`` at
  several sizes (seed 37, k = a third of n), with its Gaussian basis block
  and with an orthogonal one (``tools/lps.py``): status, iterations and
  the distance of x from x0 after the budget;
* ``f32_gradients``: the 12x18 test LP (seed 0) differentiated in f32 with
  the forward on CG or on the direct projection, and the CGLS damping at
  the JAX package's 1e-10 or at 1e-8 (adjoint tolerance 1e-6): the
  envelope identities' errors and the CGLS iterations;
* ``gradients_where_dr_stalls``: the 64x96 member of the family (seed 41)
  differentiated in f64: the errors of the gradients and of x, and the
  CGLS iterations;
* ``full_width``: the 1000^2 orthogonal-basis LP (k = 250, seed 37) that
  ``chip_smoke.py`` gates, differentiated with DR in f32 (the f32 budget
  of ``diff.py``'s note) and in f64 (the defaults), and 64 of them at
  64x96 (k = 32, seed 41) in one batched f32 solve: the same errors (the
  batch: max |g_c - x| over the lanes) and counts.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time

import numpy as np
import torch

from fos_tpu_torch.config import default_device
from fos_tpu_torch.tools.lps import nondegenerate_lp, orthogonal_basis_lp

#: the f32 derivative budget (diff.py's note)
F32 = dict(eps=1e-6, max_iters=40000, diff_cg_tol=1e-6, diff_cg_maxiter=500,
           adjoint_tol=1e-6, adjoint_iters=300, adjoint_damping=1e-8)


def _scale(x0, y0):
    return 1.0 + np.abs(x0).max() + np.abs(y0).max()


def stall(device, sizes=((12, 18, 6), (64, 96, 32), (200, 200, 67),
                         (400, 400, 133)), iters=60000):
    from fos_tpu_torch import DR, nonneg, solve

    for (m, n, k), (basis, make) in itertools.product(sizes, (
            ("gaussian", nondegenerate_lp),
            ("orthogonal", orthogonal_basis_lp))):
        A, b, c, x0, y0 = make(np.random.default_rng(37), m, n, k)
        t0 = time.perf_counter()
        sol = solve(A, b, c, nonneg(m), nonneg(n), alg=DR(direct=True),
                    eps=1e-8, max_iters=iters, device=device, verbose=0)
        x = sol.x.double().cpu().numpy()
        yield {"case": "stall", "shape": [m, n], "k": k, "basis": basis,
               "eps": 1e-8, "status": sol.status, "iters": sol.iters,
               "seconds": time.perf_counter() - t0,
               "x_err": float(np.abs(x - x0).max() / _scale(x0, y0))}


def _gradients(device, lp, dtype, alg, **opts):
    from fos_tpu_torch import diff_solve, nonneg

    A, b, c, x0, y0 = lp
    m, n = A.shape
    data = [torch.tensor(t, dtype=dtype, device=device, requires_grad=True)
            for t in (A, b, c)]
    stats = {}
    x, y, _ = diff_solve(*data, nonneg(m), nonneg(n), alg=alg, device=device,
                         stats=stats, **opts)
    fwd = {"status": int(stats["status"]), "iters": int(stats["iters"])}
    gA, gb, gc = (g.double().cpu().numpy() for g in torch.autograd.grad(
        torch.dot(data[2], x), data))
    sc = _scale(x0, y0)
    return {**fwd, "cgls_iters": int(stats["cgls_iters"]),
            "inner_cg_iters": int(stats["inner_cg_iters"]),
            "x_err": float(np.abs(x.detach().double().cpu().numpy()
                                  - x0).max() / sc),
            "g_c_err": float(np.abs(gc - x0).max() / sc),
            "g_b_err": float(np.abs(gb + y0).max() / sc),
            "g_A_err": float(np.abs(gA - np.outer(y0, x0)).max() / sc)}


def f32_gradients(device):
    from fos_tpu_torch import DR

    lp = nondegenerate_lp(np.random.default_rng(0), 12, 18, 6)
    for direct in (False, True):
        for damping in (1e-10, 1e-8):
            row = _gradients(device, lp, torch.float32, DR(direct=direct),
                             eps=1e-6, max_iters=40000, diff_cg_tol=1e-6,
                             adjoint_tol=1e-6, adjoint_iters=300,
                             adjoint_damping=damping)
            yield {"case": "f32_gradients", "shape": [12, 18],
                   "forward": "direct" if direct else "cg",
                   "adjoint_damping": damping, **row}


def gradients_where_dr_stalls(device):
    from fos_tpu_torch import DR

    lp = nondegenerate_lp(np.random.default_rng(41), 64, 96, 32)
    row = _gradients(device, lp, torch.float64, DR(direct=True), eps=1e-8,
                     max_iters=40000)
    yield {"case": "gradients_where_dr_stalls", "shape": [64, 96],
           "dtype": "float64", **row}


def full_width(device):
    from fos_tpu_torch import DR, diff_solve, nonneg

    lp = orthogonal_basis_lp(np.random.default_rng(37), 1000, 1000, 250)
    for dtype, opts in ((torch.float32, F32),
                        (torch.float64, dict(eps=1e-8, max_iters=40000))):
        t0 = time.perf_counter()
        row = _gradients(device, lp, dtype, DR(), **opts)
        yield {"case": "full_width", "shape": [1000, 1000], "k": 250,
               "dtype": str(dtype).replace("torch.", ""),
               "seconds": time.perf_counter() - t0, **row}
    rng = np.random.default_rng(41)
    draws = [orthogonal_basis_lp(rng, 64, 96, 32) for _ in range(64)]
    A, b, c, x0 = (np.stack([d[i] for d in draws]) for i in range(4))
    At, bt = (torch.tensor(t, dtype=torch.float32, device=device)
              for t in (A, b))
    ct = torch.tensor(c, dtype=torch.float32, device=device,
                      requires_grad=True)
    stats = {}
    x, _, _ = diff_solve(At, bt, ct, nonneg(64), nonneg(96), alg=DR(),
                         device=device, stats=stats, **F32)
    (g,) = torch.autograd.grad((ct * x).sum(), ct)
    yield {"case": "full_width", "batch": 64, "shape": [64, 96], "k": 32,
           "dtype": "float32",
           "statuses": np.bincount(stats["status"].cpu().numpy(),
                                   minlength=4).tolist(),
           "iters_max": int(stats["iters"].max()),
           "cgls_iters": int(stats["cgls_iters"].max()),
           "max_abs_g_c_minus_x": float((g - x).detach().abs().max()),
           "max_abs_x_minus_x0": float(np.abs(
               x.detach().double().cpu().numpy() - x0).max())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="the card unless given (cpu for the CPU)")
    args = p.parse_args(argv)
    device = default_device(args.device)
    for study in (full_width, stall, f32_gradients,
                  gradients_where_dr_stalls):
        for row in study(device):
            print(json.dumps({"device": str(device), **row}), flush=True)


if __name__ == "__main__":
    main()
