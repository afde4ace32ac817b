"""Batched scenario LPs: B independent LP instances as one batched solve.

All instances run in one ``fused_solve`` with a lane axis on one card (a
CUDA graph there).  The JAX package's example also shards the batch axis
over a device mesh; that branch waits for the port's sharding slice
(ROADMAP queue 1, item 2), so this example runs on one card.
"""

import time

import numpy as np

from fos_tpu_torch import DR, Status, nonneg
from fos_tpu_torch.parallel.batched import build_batched_form, solve_batched


def main(B=64, m=24, n=40, device=None):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, m, n))
    xmask = rng.random((B, n)) < 0.5
    x0 = np.abs(rng.standard_normal((B, n))) * xmask
    r0 = np.abs(rng.standard_normal((B, n))) * (~xmask)
    ymask = rng.random((B, m)) < 0.5
    y0 = np.abs(rng.standard_normal((B, m))) * ymask
    s0 = np.abs(rng.standard_normal((B, m))) * (~ymask)
    b = np.einsum("bmn,bn->bm", A, x0) + s0
    c = r0 - np.einsum("bmn,bm->bn", A, y0)

    form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device=device)
    t0 = time.time()
    res = solve_batched(DR(), form, max_iters=20000, eps=1e-6, checki=100)
    statuses = res.status.cpu().numpy()
    n_opt = int(np.sum(statuses == Status.OPTIMAL))
    print(f"B={B}: {n_opt}/{B} optimal in {time.time() - t0:.2f}s "
          f"(capture included)")
    # a couple of random instances are near-degenerate and need more than the
    # budget at eps=1e-6: the per-instance statuses are the point of the demo
    assert n_opt >= 0.9 * B
    return res


if __name__ == "__main__":
    main()
