"""CG's iteration (C1) and q_mul's rank-1 epilogue (C2) on the CPU: their
plain versions against the JAX package, and the route CG takes on the card
driven here with the plain step in the kernel's place.

* ``cg.step_plain`` (the version C1 is held to) and the card route's loop
  (its state updated in place, the group mask kept by the step, the eager
  test read from the step's flag), with a stand-in that runs
  ``step_plain`` where the card launches C1: tracked and standard CG
  against ``fos_tpu.linalg.cg`` (vmapped for lanes) for one vector,
  ``(B, k)`` and ``(B, P, k)`` lanes, shared and per-instance data, a lane
  that is never live, ``den == 0`` and ``rn == 0``; and bit-equal to the
  port's plain route.
* ``hsde_ops.q_rank1_plain`` (the version C2 is held to) against
  ``fos_tpu.linalg.hsde_ops.q_mul``, over lanes with shared and
  per-instance ``b``, ``c``; C2's derivative rules (``QRank1Fn``) against
  numerical derivatives, the plain epilogue in the kernel's place.
* The routing: CPU tensors reach the plain versions and never C1 or C2;
  ``compensated=True`` and the pipelined variant never reach C1.

Inputs are numpy-seeded f64; tolerance 1e-12 (the two packages' f64 sums
in another order).  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from fos_tpu.linalg import cg as jcg  # noqa: E402
from fos_tpu.linalg import hsde_ops as jops  # noqa: E402
from fos_tpu_torch.linalg import cg as tcg  # noqa: E402
from fos_tpu_torch.linalg import cg_step, hsde_ops  # noqa: E402

TOL = 1e-12
#: CG steps compared with the JAX package at TOL
STEPS = 4


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _np(t):
    return np.asarray(t)


class PlainStep:
    """C1's interface over the plain step: the state updated in place, the
    group mask taken at a group's first step, ``next`` the test after each
    step.  Records every instance."""

    made = []

    def __init__(self, x, r, p, rn, it, tol2, max_iters, Qx=None,
                 mode=cg_step.AP_IS_W, group=None):
        assert group is None
        self.state = (x, Qx, r, p, rn, it)
        self.tol2, self.max_iters, self.mode = tol2, max_iters, mode
        self.next = (rn > tol2) & (it < max_iters)
        self.go = None
        PlainStep.made.append(self)

    def __call__(self, w, Qp=None, first=False):
        x, Qx, r, p, rn, it = self.state
        if rn.dim() and first:
            self.go = (rn > self.tol2) & (it < self.max_iters)
        new = tcg.step_plain(x, r, p, rn, it, self.tol2, w, self.mode, Qx, Qp,
                             self.go if rn.dim() else None)
        for old, v in zip(self.state, new):
            if old is not None:
                old.copy_(v)
        self.next.copy_((rn > self.tol2) & (it < self.max_iters))


@pytest.fixture
def card_route(monkeypatch):
    """CPU tensors through the card's route, the plain step in C1's place."""
    PlainStep.made = []
    monkeypatch.setattr(cg_step, "takes", lambda t: True)
    monkeypatch.setattr(cg_step, "CGStep", PlainStep)
    monkeypatch.setattr(cg_step, "rank1", hsde_ops.q_rank1_plain)
    return PlainStep


def _lp(m, n, seed, lanes=()):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lanes + (m, n)), rng.standard_normal(
        lanes + (m,)), rng.standard_normal(lanes + (n,)))


def _jax_tracked(A, b, c, r0, x0, tol, max_iters, unroll, lanes):
    """The JAX package's tracked CG on Q = Q(A, b, c), vmapped over ``r0``'s
    and ``tol``'s lanes (instance data over the leading lanes when A
    has them)."""
    def one(A, b, c, r, tol):
        q = lambda v: jops.q_mul(A, b, c, v)  # noqa: E731
        x = jnp.asarray(x0)
        return jcg.conjugate_gradient_tracked(q, r, x, q(x), tol=tol,
                                              max_iters=max_iters,
                                              unroll=unroll)
    fn = one
    inst = A.ndim == 3
    for k in range(len(lanes)):     # the innermost lane axis first
        data = 0 if inst and k == len(lanes) - 1 else None
        fn = jax.vmap(fn, in_axes=(data, data, data, 0, 0))
    return fn(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), jnp.asarray(r0),
              jnp.asarray(tol))


CASES = [
    # (lanes, instance data per leading lane)
    ((), False),
    ((5,), False),
    ((4,), True),
    ((3, 4), True),
    ((2, 3), False),
]


@pytest.mark.parametrize("lanes,inst", CASES)
def test_card_route_tracked_cg_matches_jax(card_route, lanes, inst):
    """Tracked CG through the card route (the plain step in C1's place):
    against the JAX package's tracked CG at 1e-12, with a lane that is
    never live (tol above its residual); bit-equal to the port's plain
    route; one step object a solve."""
    m, n = 7, 9
    A, b, c = _lp(m, n, 3, lanes[:1] if inst else ())
    l = m + n + 1
    rng = np.random.default_rng(5)
    r0 = rng.standard_normal(lanes + (l,))
    # a warm start (zero with per-instance data, whose Q x0 needs lanes)
    x0 = np.zeros(l) if inst else rng.standard_normal(l)
    tol = np.full(lanes, 1e-8)
    if lanes:
        tol.reshape(-1)[-1] = 1e3      # never live
    At, bt, ct = _t(A), _t(b), _t(c)
    q = lambda v: hsde_ops.q_mul(At, bt, ct, v)  # noqa: E731
    args = (q, _t(r0), _t(x0), _t(x0) if inst else q(_t(x0)))
    # a few steps against the JAX package (CG amplifies the two packages'
    # last-bit differences by the system's conditioning as it goes), then
    # to convergence against the port's plain route, bit for bit
    for max_iters in (STEPS, 40):
        kw = dict(tol=_t(tol) if lanes else 1e-8, max_iters=max_iters,
                  unroll=2)
        card_route.made = []
        got = tcg.conjugate_gradient_tracked(*args, **kw)
        assert len(card_route.made) == 1
        if lanes:
            assert int(got.iters.reshape(-1)[-1]) == 0
        if max_iters == STEPS:
            want = _jax_tracked(A, b, c, r0, x0, tol, max_iters, 2, lanes)
            np.testing.assert_array_equal(_np(got.iters),
                                          np.asarray(want.iters))
            for key in ("x", "Qx", "rnorm"):
                np.testing.assert_allclose(_np(getattr(got, key)),
                                           np.asarray(getattr(want, key)),
                                           rtol=0, atol=TOL)
            continue
        # the plain route: the same operations, so the same bits
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cg_step, "takes", lambda t: False)
            plain = tcg.conjugate_gradient_tracked(*args, **kw)
        for key in ("x", "Qx", "iters", "rnorm"):
            assert torch.equal(getattr(plain, key), getattr(got, key)), key


@pytest.mark.parametrize("lanes", [(), (6,), (2, 3)])
def test_card_route_standard_cg_matches_jax(card_route, lanes):
    """Standard CG through the card route on ``I + AA'`` given as
    ``PlusProduct`` (the feasibility S1) and on an SPD matrix given whole:
    against the JAX package's CG at 1e-12 and bit-equal to the plain
    route."""
    rng = np.random.default_rng(8)
    m, n = 12, 20
    A = rng.standard_normal((m, n))
    S = A @ A.T + np.eye(m)
    rhs = rng.standard_normal(lanes + (m,))
    At, St = _t(A), _t(S)
    ops = ((tcg.PlusProduct(lambda v: (At @ (At.T @ v[..., None]))[..., 0]),
            lambda v: v + (jnp.asarray(A) @ (jnp.asarray(A).T @ v))),
           (lambda v: (St @ v[..., None])[..., 0],
            lambda v: jnp.asarray(S) @ v))
    for top, jop in ops:
        fn = lambda r: jcg.conjugate_gradient(  # noqa: E731
            jop, r, jnp.zeros(m), tol=1e-9, max_iters=STEPS, unroll=2)
        for _ in lanes:
            fn = jax.vmap(fn)
        want = fn(jnp.asarray(rhs))
        kw = dict(tol=1e-9, max_iters=STEPS, unroll=2)
        got = tcg.conjugate_gradient(top, _t(rhs), torch.zeros(m,
                                     dtype=torch.float64), **kw)
        np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
        np.testing.assert_allclose(_np(got.x), np.asarray(want.x), rtol=0,
                                   atol=TOL)
        kw["max_iters"] = 60
        got = tcg.conjugate_gradient(top, _t(rhs), torch.zeros(
            m, dtype=torch.float64), **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cg_step, "takes", lambda t: False)
            plain = tcg.conjugate_gradient(top, _t(rhs), torch.zeros(
                m, dtype=torch.float64), **kw)
        assert torch.equal(plain.x, got.x) and torch.equal(plain.iters,
                                                           got.iters)


def test_step_plain_den_zero_and_rn_zero(card_route):
    """den == 0 (Q with Q(Q p) = p, so Ap = 0: alpha 0, the iterate kept)
    and rn == 0 (a zero residual: no step) against the JAX package."""
    l = 6
    rng = np.random.default_rng(1)
    r0 = rng.standard_normal(l)
    x0 = rng.standard_normal(l)
    for r in (r0, np.zeros(l)):
        want = jcg.conjugate_gradient_tracked(
            lambda v: v, jnp.asarray(r), jnp.asarray(x0), jnp.asarray(x0),
            tol=0.0, max_iters=3, unroll=1)
        got = tcg.conjugate_gradient_tracked(
            lambda v: v, _t(r), _t(x0), _t(x0), tol=0.0, max_iters=3,
            unroll=1)
        assert int(got.iters) == int(want.iters)
        for key in ("x", "Qx", "rnorm"):
            np.testing.assert_allclose(_np(getattr(got, key)),
                                       np.asarray(getattr(want, key)),
                                       rtol=0, atol=TOL)
    # one step of step_plain on lanes: live, den == 0, rn == 0
    x, r, p, w = (_t(rng.standard_normal((3, l))) for _ in range(4))
    w[1] = p[1]                   # Ap = p - w = 0: den == 0
    r[2] = 0.0
    rn = (r * r).sum(-1)
    it = torch.zeros(3, dtype=torch.int32)
    tol2 = torch.zeros((), dtype=torch.float64)
    x1, _, r1, p1, rn1, it1 = tcg.step_plain(x, r, p, rn, it, tol2, w,
                                             cg_step.P_MINUS_W)
    assert torch.equal(x1[1], x[1]) and torch.equal(r1[1], r[1])
    assert torch.equal(x1[2], x[2]) and torch.equal(p1[2], p[2])
    assert it1.tolist() == [1, 1, 0] and float(rn1[2]) == 0.0


@pytest.mark.parametrize("lanes,inst", [((), ()), ((5,), ()), ((5,), (5,)),
                                        ((3, 4), (3,))])
def test_q_rank1_plain_matches_jax(lanes, inst):
    """q_mul's plain epilogue from the pair's products against the JAX
    package's q_mul (vmapped), shared and per-instance b, c; and q_mul on
    the CPU is that epilogue."""
    m, n = 8, 11
    rng = np.random.default_rng(6)
    A = rng.standard_normal(inst + (m, n))
    b, c = rng.standard_normal(inst + (m,)), rng.standard_normal(inst + (n,))
    z = rng.standard_normal(lanes + (n + m + 1,))
    Ab = A.reshape(inst + (1,) * (len(lanes) - len(inst)) + (m, n))
    Az1 = np.einsum("...ij,...j->...i", Ab, z[..., :n])
    ATz2 = np.einsum("...ij,...i->...j", Ab, z[..., n: n + m])
    ncb = -np.concatenate([c, b], -1)
    got = hsde_ops.q_rank1_plain(_t(Az1), _t(ATz2), _t(z), _t(b), _t(c),
                                 _t(ncb))
    fn = jops.q_mul
    for k in range(len(lanes)):     # the innermost lane axis first
        data = 0 if len(lanes) - 1 - k < len(inst) else None
        fn = jax.vmap(fn, in_axes=(data, data, data, 0))
    want = fn(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), jnp.asarray(z))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    tq = hsde_ops.q_mul(_t(A), _t(b), _t(c), _t(z))
    np.testing.assert_allclose(_np(tq), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("lanes,inst", [((), ()), ((4,), ()),
                                        ((3, 2), (3,))])
def test_q_rank1_rules_match_numerical_derivatives(monkeypatch, lanes, inst):
    """QRank1Fn's reverse and forward rules (C2 under autograd: the dot
    -[c; b] . z[:n+m] formed from b and c) against numerical derivatives,
    f64, shared and per-instance data; the forward is the plain epilogue
    here, where the card launches C2."""
    monkeypatch.setattr(cg_step, "q_rank1", hsde_ops.q_rank1_plain)
    n, m = 5, 4
    rng = np.random.default_rng(9)
    shapes = (lanes + (m,), lanes + (n,), lanes + (n + m + 1,), inst + (m,),
              inst + (n,))
    args = tuple(_t(rng.standard_normal(s)).requires_grad_() for s in shapes)
    got = cg_step.QRank1Fn.apply(*args)
    want = hsde_ops.q_rank1_plain(*args)
    np.testing.assert_allclose(_np(got.detach()), _np(want.detach()),
                               rtol=0, atol=TOL)
    assert torch.autograd.gradcheck(cg_step.QRank1Fn.apply, args,
                                    check_forward_ad=True)


def test_cpu_tensors_reach_the_plain_versions(monkeypatch):
    """On CPU tensors neither C1 nor C2 is reached: CG and q_mul run their
    plain versions."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was reached on the CPU")

    monkeypatch.setattr(cg_step, "CGStep", refuse)
    monkeypatch.setattr(cg_step, "rank1", refuse)
    monkeypatch.setattr(cg_step, "q_rank1", refuse)
    A, b, c = _lp(5, 7, 2)
    At, bt, ct = _t(A), _t(b), _t(c)
    q = lambda v: hsde_ops.q_mul(At, bt, ct, v)  # noqa: E731
    r0 = _t(np.random.default_rng(3).standard_normal(13))
    x0 = torch.zeros(13, dtype=torch.float64)
    res = tcg.conjugate_gradient_tracked(q, r0, x0, x0, tol=1e-10,
                                         max_iters=50)
    assert int(res.iters) > 0
    res = tcg.conjugate_gradient(tcg.PlusProduct(lambda v: q(q(v)), -1), r0,
                                 x0, tol=1e-10, max_iters=50)
    assert int(res.iters) > 0


def test_compensated_and_pipelined_do_not_reach_c1(card_route):
    """With every tensor taken as the card's, ``compensated=True`` (its
    error-free dots) and the pipelined variant still run the PyTorch route:
    no step object is made; plain CG makes one."""
    A, b, c = _lp(5, 7, 2)
    At, bt, ct = _t(A), _t(b), _t(c)
    q = lambda v: hsde_ops.q_mul(At, bt, ct, v)  # noqa: E731
    r0 = _t(np.random.default_rng(3).standard_normal(13))
    x0 = torch.zeros(13, dtype=torch.float64)
    normal = tcg.PlusProduct(lambda v: q(q(v)), -1)
    tcg.conjugate_gradient_tracked(q, r0, x0, x0, tol=1e-10, max_iters=50,
                                   compensated=True)
    tcg.conjugate_gradient(normal, r0, x0, tol=1e-10, max_iters=50,
                           compensated=True)
    tcg.conjugate_gradient_pipelined(normal, r0, x0, tol=1e-10, max_iters=50)
    assert card_route.made == []
    tcg.conjugate_gradient(normal, r0, x0, tol=1e-10, max_iters=50)
    assert len(card_route.made) == 1


def test_card_route_flag_replaces_the_test():
    """The eager loop reads the step's flag: the test's own operands are
    never compared on the host once the loop runs (a condition built with
    a flag ignores rn and it)."""
    from fos_tpu_torch.linalg import control

    flag = torch.tensor(True)
    cond = control.CGContinue(torch.tensor(0.0), torch.tensor(1.0),
                              torch.tensor(5), 3, flag)
    assert cond.plain() is True
    lanes_cond = control.CGContinueLanes(torch.zeros(3), torch.tensor(1.0),
                                         torch.zeros(3, dtype=torch.int32), 3,
                                         torch.tensor([False, True, False]))
    assert lanes_cond.plain() is True
