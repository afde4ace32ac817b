"""Differentiable solves: gradients of an LP's optimum with respect to its
data.

``fos_tpu_torch.diff_solve`` differentiates implicitly through the DR
fixed point, and ``torch.autograd`` carries the gradient.  Here the
envelope theorem, d(c'x*)/db = -y*, is checked numerically, and one
gradient step on b lowers the achievable optimum.
"""

import numpy as np
import torch

from fos_tpu_torch import DR, diff_solve, nonneg
from fos_tpu_torch.config import default_device


def main(device=None):
    device = default_device(device)
    rng = np.random.default_rng(5)  # seed 5: DR Optimal in ~1.7k iterations
    m, n, k = 8, 12, 4
    A = rng.standard_normal((m, n))
    xmask = np.zeros(n, bool)
    xmask[rng.choice(n, k, replace=False)] = True
    ymask = np.zeros(m, bool)
    ymask[rng.choice(m, k, replace=False)] = True
    x0 = (np.abs(rng.standard_normal(n)) + 0.1) * xmask
    r0 = (np.abs(rng.standard_normal(n)) + 0.1) * (~xmask)
    y0 = (np.abs(rng.standard_normal(m)) + 0.1) * ymask
    s0 = (np.abs(rng.standard_normal(m)) + 0.1) * (~ymask)
    b = torch.tensor(A @ x0 + s0, device=device, requires_grad=True)
    c = torch.tensor(r0 - A.T @ y0, device=device)
    A = torch.tensor(A, device=device)
    K1, K2 = nonneg(m), nonneg(n)

    def objective(b_):
        x, y, s = diff_solve(A, b_, c, K1, K2, alg=DR(), eps=1e-10,
                             max_iters=8000, device=device)
        return torch.dot(c, x), y

    val, y = objective(b)
    (grad,) = torch.autograd.grad(val, b)
    val = float(val.detach())
    envelope = float((grad + y.detach()).abs().max())
    print(f"optimum: {val:.6f}")
    print(f"envelope check max|d(obj)/db + y*| = {envelope:.2e}")
    assert envelope <= 1e-6

    # one gradient step on b lowers the achievable optimum
    with torch.no_grad():
        b2 = b - 0.1 * grad
    val2 = float(objective(b2)[0])
    print(f"after a gradient step on b: {val2:.6f} "
          f"(improved: {val2 < val})")
    assert val2 < val


if __name__ == "__main__":
    main()
