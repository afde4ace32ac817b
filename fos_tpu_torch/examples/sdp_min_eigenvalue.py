"""SDP: the smallest shift that makes C positive semidefinite,
min t s.t. C + t I >= 0, whose optimum is t* = -lambda_min(C) for an
indefinite C (checked against numpy's eigvalsh).
"""

import numpy as np
import torch

from fos_tpu_torch import DR, solve
from fos_tpu_torch.cones import ConeSpec, svec
from fos_tpu_torch.cones.spec import Cone


def main(device=None):
    rng = np.random.default_rng(4)
    d = 8
    B = rng.standard_normal((d, d))
    C = (B + B.T) / 2
    L = d * (d + 1) // 2

    # variables: (t, X in svec) with the constraint X = C + t I (zero
    # rows) and X in PSD
    sI = svec(torch.eye(d, dtype=torch.float64)).numpy()
    sC = svec(torch.from_numpy(C)).numpy()
    nv = 1 + L
    A = np.zeros((L, nv))
    b = np.zeros(L)
    A[:, 0] = -sI
    A[:, 1:] = np.eye(L)
    b[:] = sC                      # X - t I = C
    c = np.zeros(nv)
    c[0] = 1.0
    K1 = ConeSpec(((Cone.ZERO, L),))
    K2 = ConeSpec(((Cone.FREE, 1), (Cone.PSD, L)))

    sol = solve(A, b, c, K1, K2, alg=DR(), eps=1e-8, max_iters=40000,
                verbose=0, device=device)
    t = float(sol.x[0])
    lam_min = np.linalg.eigvalsh(C).min()
    print(f"status={sol.status} t={t:.8f} -lambda_min(C)={-lam_min:.8f} "
          f"iters={sol.iters}")
    assert sol.status == "Optimal"
    assert abs(t - (-lam_min)) < 1e-5
    return sol


if __name__ == "__main__":
    main()
