"""Batched scenario LPs: B independent LP instances as one batched solve.

All instances run in one ``fused_solve`` with a lane axis (a CUDA graph on
one card).  Launched on several ranks (``torchrun --nproc-per-node N``, or
under a process group the caller initialised), the batch axis is split
over a ``(N, 1)`` mesh when N divides B: each rank solves its instances on
its own card and every rank gets the whole batch's result, as the JAX
package's example shards the batch over its device mesh.
"""

import os
import time

import numpy as np
import torch.distributed as dist

from fos_tpu_torch import DR, Status, nonneg
from fos_tpu_torch.parallel import (build_batched_form, make_mesh,
                                    shard_batched_form, solve_batched)


def _ranks() -> int:
    """The number of ranks this program was launched on (1 alone)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


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

    ranks = _ranks()
    # the mesh first: on the card it picks this rank's device
    mesh = (make_mesh((ranks, 1), ("batch", "model"), device=device)
            if ranks > 1 and B % ranks == 0 else None)
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device=device)
    if mesh is not None:
        form = shard_batched_form(form, mesh)
        print(f"batch axis sharded over {ranks} ranks")
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
