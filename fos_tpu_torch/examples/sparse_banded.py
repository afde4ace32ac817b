"""Sparse banded LP through the tile kernels.

A block-banded LP handed to ``solve`` as scipy.sparse with
``densify=False, sparse_format="bell"`` in f32: the form build packs A into
a tile table (banded or blocked-ELL by the pattern's span) and the solve
runs through the hand-written pair kernel on the card.  The solution is
checked against the primal-dual certificate the data are built from
(objective within 1e-3).

    python3 -m fos_tpu_torch.examples.sparse_banded
"""

import numpy as np
import scipy.sparse as sp
import torch

from fos_tpu_torch import DR, nonneg, solve
from fos_tpu_torch.config import default_device


def main(m=None, half_band=40, seed=3, device=None):
    device = default_device(device)
    if m is None:
        # the CPU runs the tile kernels' plain versions: a smaller demo there
        m = 4096 if device.type == "cuda" else 1024
    rng = np.random.default_rng(seed)
    offs = list(range(-half_band, half_band + 1))
    A = sp.diags(
        [rng.standard_normal(m - abs(o)) / np.sqrt(2 * half_band + 1) for o in offs],
        offsets=offs, shape=(m, m), format="csr")
    A = A + sp.identity(m) * 2.0  # diagonal dominance: fast DR convergence

    # primal-dual certificate (complementary slackness)
    xmask = rng.random(m) < 0.5
    x0 = np.abs(rng.standard_normal(m)) * xmask
    r0 = np.abs(rng.standard_normal(m)) * (~xmask)
    ymask = rng.random(m) < 0.5
    y0 = np.abs(rng.standard_normal(m)) * ymask
    s0 = np.abs(rng.standard_normal(m)) * (~ymask)
    b = A @ x0 + s0
    c = r0 - A.T @ y0
    opt = float(c @ x0)

    print(f"A: {m}x{m}, nnz {A.nnz} (density {A.nnz / m**2:.2%})")
    sol = solve(A, b, c, nonneg(m), nonneg(m), alg=DR(), eps=1e-5, verbose=1,
                densify=False, sparse_format="bell", dtype=torch.float32,
                max_iters=20000, device=device)
    rel = abs(sol.objval - opt) / abs(opt)
    print(f"status {sol.status} at {sol.iters} iterations")
    print(f"objective {sol.objval:.4f}  certificate {opt:.4f}  "
          f"rel err {rel:.2e}")
    assert sol.status == "Optimal" and rel <= 1e-3
    return sol


if __name__ == "__main__":
    main()
