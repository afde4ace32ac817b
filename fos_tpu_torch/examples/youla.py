"""Youla-parameterized FIR controller design (the reference's
examples/youla.jl, in discrete time).

For a stable FIR plant ``g`` every stabilizing closed loop has sensitivity
``S = 1 - G Q`` with a free Youla parameter ``Q``; pick an FIR Q that
minimizes the step-tracking error while bounding the control effort, as a
conic program:

    min  t
    s.t. ||e||_2 <= t               (SOC)          e_k = step error coeffs
         |u_k|  <= u_max            (box rows)     u = Q * step
         e = conv(1 - g*q, step) truncated

The constraint matrices are built by hand and solved through the conic
HSDE path; the answer is checked against scipy's SLSQP on the same QP in q.
"""

import numpy as np

from fos_tpu_torch import DR, solve
from fos_tpu_torch.cones import ConeSpec, nonneg, soc, zero
from fos_tpu_torch.cones.spec import Cone


def conv_matrix(g, nq, nt):
    """T s.t. (T q)[k] = (g * q)[k] for k < nt."""
    T = np.zeros((nt, nq))
    for i, gi in enumerate(g):
        for j in range(nq):
            if i + j < nt:
                T[i + j, j] += gi
    return T


def main(nq=8, nt=20, device=None):
    # stable FIR plant
    g = np.array([0.0, 0.5, 0.3, 0.1, 0.05])
    u_max = 2.0                         # nq controller taps, nt horizon

    T = conv_matrix(g, nq, nt)          # y = T q (impulse response of GQ)
    L = np.tril(np.ones((nt, nt)))      # step accumulation
    # step error e = 1_step - L T q ; control u = L q_padded
    Lq = np.tril(np.ones((nt, nq)))[:, :nq]

    # variables: (q[nq], t, e[nt], u[nt])
    nv = nq + 1 + nt + nt
    rows_eq = nt + nt            # e and u definitions
    rows_soc = 1 + nt            # (t, e) in SOC
    rows_box = 2 * nt            # -u_max <= u_k <= u_max
    A = np.zeros((rows_eq + rows_soc + rows_box, nv))
    b = np.zeros(A.shape[0])
    iq, it, ie, iu = 0, nq, nq + 1, nq + 1 + nt
    r = 0
    # e + L T q = step  (e = step - LTq)
    A[r : r + nt, ie : ie + nt] = np.eye(nt)
    A[r : r + nt, iq : iq + nq] = L @ T
    b[r : r + nt] = 1.0
    r += nt
    # u - Lq q = 0
    A[r : r + nt, iu : iu + nt] = np.eye(nt)
    A[r : r + nt, iq : iq + nq] = -Lq
    r += nt
    # SOC rows: s = (t, e) in SOC  ->  s0 = t; s_k = e_k
    A[r, it] = -1.0
    A[r + 1 : r + 1 + nt, ie : ie + nt] = -np.eye(nt)
    r += 1 + nt
    # box: u_max - u_k >= 0 ; u_max + u_k >= 0
    A[r : r + nt, iu : iu + nt] = np.eye(nt)
    b[r : r + nt] = u_max
    r += nt
    A[r : r + nt, iu : iu + nt] = -np.eye(nt)
    b[r : r + nt] = u_max
    r += nt

    c = np.zeros(nv)
    c[it] = 1.0
    K1 = ConeSpec.concat([zero(rows_eq), soc(rows_soc), nonneg(rows_box)])
    K2 = ConeSpec(((Cone.FREE, nv),))

    sol = solve(A, b, c, K1, K2, alg=DR(), eps=1e-8, max_iters=60000,
                verbose=0, device=device)
    xs = sol.x.cpu().numpy()
    e = xs[ie : ie + nt]
    u = xs[iu : iu + nt]
    print(f"status={sol.status} ||e||={np.linalg.norm(e):.6f} "
          f"max|u|={np.abs(u).max():.4f} (bound {u_max}) iters={sol.iters}")
    assert sol.status == "Optimal"
    assert np.abs(u).max() <= u_max + 1e-6
    # oracle: SLSQP on the same QP in q
    from scipy.optimize import minimize

    def obj(qv):
        ev = 1.0 - L @ T @ qv
        return float(ev @ ev)

    cons = []
    for k in range(nt):
        cons.append({"type": "ineq", "fun": (lambda qv, k=k: u_max - (Lq @ qv)[k])})
        cons.append({"type": "ineq", "fun": (lambda qv, k=k: u_max + (Lq @ qv)[k])})
    res = minimize(obj, np.zeros(nq), constraints=cons, method="SLSQP",
                   options={"maxiter": 1000, "ftol": 1e-14})
    print(f"SLSQP oracle ||e||: {np.sqrt(res.fun):.6f}")
    assert np.linalg.norm(e) <= np.sqrt(res.fun) + 1e-4
    return sol


if __name__ == "__main__":
    main()
