"""fos_tpu_torch's sharded solves over gloo, against the JAX package.

One spawn of four gloo ranks per module (``_torch_sharding_ranks``, which
imports no JAX) runs every case; the parent computes the JAX references
meanwhile and each test asserts one case.  The cases mirror the sharded
tests of ``tests/test_parallel.py`` (its 8 virtual devices become 4 ranks:
1x4 for rows, 4x1 for the batch, 2x2 for 2D and the hybrid layout) at its
sizes or smaller, and the collective counts of ``tests/test_comm_volume.py``
(counted by wrapping ``torch.distributed``'s functions in the ranks).
Every rank must hold the same bits, and a second call must repeat them.

Tolerances are the JAX tests' own: objectives within 1e-4 (1 + |f|) (1e-5
for the 2D-against-rows case), tile products within 2e-4 in f32, residuals
recomputed in numpy within 1e-9 (1 + p) in f64.  The pipelined CG is held
to ``fos_tpu.linalg.cg.conjugate_gradient_pipelined`` within 1e-10
relative in f64.
"""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

import fos_tpu
from fos_tpu import DR
from fos_tpu.cones import nonneg as jnonneg
from fos_tpu.linalg import cg as jcg
from fos_tpu.parallel.batched import build_batched_form as jbuild_batched
from fos_tpu.parallel.batched import solve_batched as jsolve_batched
from fos_tpu.problems.conic import conic_problem as jconic_problem
from fos_tpu.problems.hsde import HSDEForm as JHSDEForm
from fos_tpu.solvers.engine import fused_solve as jfused_solve
from fos_tpu.solvers.status import Status

import fos_tpu_torch
from fos_tpu_torch.linalg import cg as tcg

import _torch_sharding_ranks as ranks

WORLD = 4


def _lp_batch(rng, B=4, m=24, n=40):
    """tests/test_parallel.py's LP batch with optimal certificates."""
    A = rng.standard_normal((B, m, n))
    xmask = rng.random((B, n)) < 0.5
    x0 = np.abs(rng.standard_normal((B, n))) * xmask
    r0 = np.abs(rng.standard_normal((B, n))) * (~xmask)
    ymask = rng.random((B, m)) < 0.5
    y0 = np.abs(rng.standard_normal((B, m))) * ymask
    s0 = np.abs(rng.standard_normal((B, m))) * (~ymask)
    b = np.einsum("bmn,bn->bm", A, x0) + s0
    c = r0 - np.einsum("bmn,bm->bn", A, y0)
    return A, b, c


def _single_lp(seed, m, n):
    A, b, c = _lp_batch(np.random.default_rng(seed), B=1, m=m, n=n)
    return A[0], b[0], c[0]


def _banded(m, n, offsets, scale):
    diags = [np.ones(min(m, n) - abs(o)) * s for o, s in zip(offsets, scale)]
    return sp.diags(diags, offsets=offsets, shape=(m, n),
                    format="csr").astype(np.float32)


def _inputs():
    rng = np.random.default_rng(0)
    A1 = _banded(1024, 1024, (-130, 0, 130), (-129.0, 1.0, 131.0))
    A1 = A1 / 131.0
    r2 = np.random.default_rng(1)
    x0 = np.abs(r2.standard_normal(1024)).astype(np.float32)
    b1 = (A1 @ x0 + np.abs(r2.standard_normal(1024))).astype(np.float32)
    c1 = (np.abs(r2.standard_normal(1024)) + 0.1).astype(np.float32)
    Ah = sp.diags([np.ones(832) * 2.0, -np.ones(832 - 140)], offsets=[0, 140],
                  shape=(1024, 832), format="csr").astype(np.float32)

    def vecs(m, n, dtype=np.float32):
        return (rng.standard_normal(n).astype(dtype),
                rng.standard_normal(m).astype(dtype))

    x1, y1 = vecs(1024, 1024)
    xh, yh = vecs(1024, 832)
    rows = _single_lp(2, 32, 20)
    sq = _single_lp(3, 24, 24)
    d2 = _single_lp(4, 32, 32)
    eq = _single_lp(5, 48, 24)
    xr, zr = vecs(32, 20, np.float64)
    x2, z2 = vecs(32, 32, np.float64)
    xe, ze = vecs(48, 24, np.float64)
    return {
        "sparse_flat": {"A": A1.toarray(), "x": x1, "y": y1, "bc": (b1, c1),
                        "x5": rng.standard_normal(640).astype(np.float32)},
        "sparse_hierarchical": {"A": Ah.toarray(), "x": xh, "y": yh},
        "rows_single": {"lp": rows, "x": xr, "z": zr},
        "square_rows": {"lp": sq},
        "single_2d": {"lp": d2, "x": x2, "z": z2},
        "rows_2d_equal": {"lp": eq, "x": xe, "z": ze},
        "batched_sharded": {"lp": _lp_batch(np.random.default_rng(6), B=4,
                                            m=16, n=24)},
        "batched_linesearch": {"lp": _lp_batch(np.random.default_rng(6),
                                               B=4, m=16, n=24)},
        "hybrid_rows": {"lp": _lp_batch(np.random.default_rng(7), B=2,
                                        m=16, n=24)},
        "hybrid_validation": {"lp": _lp_batch(np.random.default_rng(8),
                                              B=2, m=16, n=16)},
        "cg_counts": {"d": np.linspace(1.0, 4.0, 512),
                      "b": np.ones(512)},
    }


def _jax_single(A, b, c, max_iters, eps):
    """The JAX package's unsharded direct-mode solve (the ranks' forms are
    direct: one pair an iteration, where CG's eager loop makes several)."""
    m, n = A.shape
    prob = jconic_problem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                          jnonneg(m), jnonneg(n))
    form = JHSDEForm.build(prob, direct=True)
    return jfused_solve(DR(), form, form.initial_value(form.dtype),
                        max_iters=max_iters, eps=eps, checki=100)


def _jax_batched(A, b, c):
    m, n = A.shape[1:]
    form = jbuild_batched(A, b, c, jnonneg(m), jnonneg(n), direct=True)
    return jsolve_batched(DR(), form, max_iters=3000, eps=1e-6, checki=100)


def _references(inp):
    """The JAX package's unsharded solves and products of the same data."""
    from fos_tpu.linalg.sparse_ell import (BandedBlockOp, BlockedEllOp,
                                           RowShardedOp)
    from fos_tpu.parallel import make_mesh

    ref = {}
    f = inp["sparse_flat"]
    A1 = sp.csr_matrix(f["A"])
    mesh = make_mesh((1, 8), ("batch", "model"))
    x, y = jnp.asarray(f["x"]), jnp.asarray(f["y"])
    for cls in (BandedBlockOp, BlockedEllOp):
        sh = RowShardedOp.create(cls.create(A1, interpret=True), mesh,
                                 "model")
        ref[cls.__name__] = [np.asarray(sh.mv(x)), np.asarray(sh.rmv(y)),
                             *map(np.asarray, sh.mv_pair(x, y))]
    b1, c1 = f["bc"]
    m, n = A1.shape
    ref["banded_solve"] = fos_tpu.solve(
        f["A"], b1, c1, jnonneg(m), jnonneg(n), alg=DR(), eps=1e-5,
        max_iters=200, verbose=0, dtype=jnp.float32)
    for name, iters, eps in (("rows_single", 1500, 1e-6),
                             ("square_rows", 1500, 1e-5),
                             ("single_2d", 3000, 1e-5),
                             ("rows_2d_equal", 2000, 1e-7)):
        ref[name] = _jax_single(*inp[name]["lp"], iters, eps)
    ref["batched_sharded"] = _jax_batched(*inp["batched_sharded"]["lp"])
    ref["hybrid_rows"] = _jax_batched(*inp["hybrid_rows"]["lp"])
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the four ranks once, compute the JAX references while they
    run, and return (inputs, per-rank results, references)."""
    work = str(tmp_path_factory.mktemp("sharding"))
    inp = _inputs()
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    ctx = torch.multiprocessing.start_processes(
        ranks.main, args=(WORLD, work), nprocs=WORLD, join=False,
        start_method="spawn")
    try:
        ref = _references(inp)
    finally:
        while not ctx.join(timeout=300):
            pass
    out = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return inp, out, ref


def _case(run, name):
    """Rank 0's results of one case, after checking that every rank ran it
    and holds the same bits."""
    _, out, _ = run
    for r, res in enumerate(out):
        assert name in res, f"rank {r} did not reach {name}"
        assert "error" not in res[name], res[name]["error"]
    for res in out[1:]:
        _assert_same_bits(out[0][name], res[name], name)
    return out[0][name]


def _assert_same_bits(a, b, where):
    if isinstance(a, dict):
        for k in a:
            if k != "seconds":
                _assert_same_bits(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same_bits(u, v, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), where


def _x(guess, n, m):
    g = np.asarray(guess, np.float64)
    l = m + n + 1
    return g[..., :n] / g[..., l - 1, None]


def _p_numpy(A, b, guess):
    m, n = A.shape
    g = np.asarray(guess, np.float64)
    l = m + n + 1
    x, tau, s = g[:n], g[l - 1], g[l + n: l + n + m]
    return np.linalg.norm(A @ (x / tau) + s / tau - b) / (
        1 + np.linalg.norm(b))


# ------------------------------------------------------------- tile tables
@pytest.mark.parametrize("kind", ["BandedBlockOp", "BlockedEllOp"])
def test_row_sharded_sparse_op(run, kind):
    """test_parallel.py::test_row_sharded_sparse_op at 1024^2 (8 block
    rows, 2 a rank): the products against the unsharded operator and
    against the JAX package's RowShardedOp on its 8-device mesh; the
    collectives of tests/test_comm_volume.py; a repeat of every call."""
    inp, _, ref = run
    res = _case(run, "sparse_flat")[kind]
    A = inp["sparse_flat"]["A"]
    x, y = inp["sparse_flat"]["x"], inp["sparse_flat"]["y"]
    assert res["local_rows"] == 2
    mv, rmv, p1, p2 = res["mv"][0], res["rmv"][0], *res["mv_pair"]
    plain = res["plain"]
    for got, want, jax_want in ((mv, plain[0], ref[kind][0]),
                                (rmv, plain[1], ref[kind][1]),
                                (p1, plain[0], ref[kind][2]),
                                (p2, plain[1], ref[kind][3])):
        np.testing.assert_allclose(got, want, atol=2e-4)
        np.testing.assert_allclose(got, jax_want, atol=2e-4)
    np.testing.assert_allclose(mv, A @ x, atol=2e-4)
    np.testing.assert_allclose(p2, A.T @ y, atol=2e-4)
    for name in ("mv", "rmv", "mv_pair"):
        _assert_same_bits(res[name], res[f"{name}_again"], name)
    # the sharded mv is the unsharded one's rows: the same bits
    np.testing.assert_array_equal(mv, plain[0])
    for name in ("mv", "rmv"):
        assert res[f"{name}_counts"] == {"all_gather": 1}, res
    assert res["mv_pair_counts"] == {"all_gather": 1, "all_reduce": 1}, res


def test_row_sharded_nondivisible_block_rows(run):
    """640 rows = 5 block rows, zero-padded to 8 over 4 ranks."""
    inp, _, _ = run
    res = _case(run, "sparse_flat")["nondivisible"]
    assert res["local_rows"] == 2
    np.testing.assert_allclose(res["mv"], inp["sparse_flat"]["x5"], atol=1e-6)


def test_row_sharded_sparse_solve_tracks_unsharded(run):
    """A short fused budget through the sharded banded operator tracks the
    unsharded one's residuals and the JAX package's status."""
    _, _, ref = run
    res = _case(run, "sparse_flat")["solve"]
    rp, rs = res["plain"], res["sharded"]
    assert rs["route"] == "cpu"
    assert rs["status"] == rp["status"]
    assert (rs["status"] == Status.OPTIMAL) == ref["banded_solve"].optimal
    assert rs["p"] <= 3 * rp["p"] + 1e-6
    assert rs["d"] <= 3 * rp["d"] + 1e-6


@pytest.mark.parametrize("kind", ["BandedBlockOp", "BlockedEllOp"])
def test_row_sharded_sparse_op_hierarchical(run, kind):
    """Block rows over the ("dcn", "ici") product of a 2x2 mesh (a
    rectangular 8 x 7 block grid): gathered ici first, then dcn; one
    all-gather per axis and one all-reduce for the pair."""
    inp, _, _ = run
    res = _case(run, "sparse_hierarchical")[kind]
    A = inp["sparse_hierarchical"]["A"]
    x, y = inp["sparse_hierarchical"]["x"], inp["sparse_hierarchical"]["y"]
    assert tuple(res["axis"]) == ("dcn", "ici")
    np.testing.assert_allclose(res["mv"], res["plain"][0], atol=2e-4)
    np.testing.assert_allclose(res["rmv"], res["plain"][1], atol=2e-4)
    np.testing.assert_allclose(res["mv_pair"][0], A @ x, atol=2e-4)
    np.testing.assert_allclose(res["mv_pair"][1], A.T @ y, atol=2e-4)
    _assert_same_bits(res["mv_pair"], res["mv_pair_again"], "mv_pair")
    assert res["mv_pair_counts"] == {"all_gather": 2, "all_reduce": 1}, res


# ------------------------------------------------------------------- dense
def test_row_sharded_single_problem(run):
    """test_parallel.py::test_row_sharded_single_problem (32x20 over 1x4):
    the status of the unsharded JAX solve, the residual recomputed in numpy
    from the sharded guess, and comparable convergence."""
    inp, _, ref = run
    res = _case(run, "rows_single")
    A, b, c = inp["rows_single"]["lp"]
    r, jr = res["solve"], ref["rows_single"]
    assert res["block"] == (8, 20) and res["same_projector_A"]
    assert r["status"] == int(jr.status)
    p_np = _p_numpy(A, b, r["guess"])
    assert abs(p_np - r["p"]) < 1e-9 * (1 + p_np)
    assert r["p"] <= 10 * float(jr.check.p) + 1e-9
    assert r["d"] <= 10 * float(jr.check.d) + 1e-9


def test_dense_row_sharded_pair_budget(run):
    """tests/test_comm_volume.py's dense row-sharded pair: one all-gather
    (y1) and one all-reduce (A'z), and the right answer, repeated."""
    inp, _, _ = run
    res = _case(run, "rows_single")
    A = inp["rows_single"]["lp"][0]
    x, z = inp["rows_single"]["x"], inp["rows_single"]["z"]
    assert res["pair_counts"] == {"all_gather": 1, "all_reduce": 1}
    np.testing.assert_allclose(res["pair"][0], A @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(res["pair"][1], A.T @ z, rtol=1e-12,
                               atol=1e-12)
    _assert_same_bits(res["pair"], res["pair_again"], "pair")


def test_row_sharding_square_problem(run):
    """m == n row-shards (placement keys on the form's fields): A's rows
    split 4 ways, b and c replicated; the objective of the unsharded JAX
    solve within 1e-4 (1 + |f|)."""
    inp, _, ref = run
    res = _case(run, "square_rows")
    A, b, c = inp["square_rows"]["lp"]
    assert res["block"] == (6, 24)
    assert res["b"] == (24,) and res["c"] == (24,)
    r, jr = res["solve"], ref["square_rows"]
    assert r["status"] == int(jr.status)
    o_s = float(c @ _x(r["guess"], 24, 24))
    o_p = float(c @ _x(jr.guess, 24, 24))
    assert abs(o_p - o_s) <= 1e-4 * (1 + abs(o_p))


def test_2d_sharded_single_problem(run):
    """test_parallel.py::test_2d_sharded_single_problem (32x32 over a 2x2
    (model_r, model_c) mesh): Optimal like the JAX solve, objective within
    1e-4 (1 + |f|), the residual recomputed in numpy."""
    inp, _, ref = run
    res = _case(run, "single_2d")
    A, b, c = inp["single_2d"]["lp"]
    r, jr = res["solve"], ref["single_2d"]
    assert res["block"] == (16, 16)
    assert r["status"] == Status.OPTIMAL == int(jr.status)
    o_s = float(c @ _x(r["guess"], 32, 32))
    o_p = float(c @ _x(jr.guess, 32, 32))
    assert abs(o_p - o_s) <= 1e-4 * (1 + abs(o_p))
    p_np = _p_numpy(A, b, r["guess"])
    assert abs(p_np - r["p"]) < 1e-9 * (1 + p_np)
    x, z = inp["single_2d"]["x"], inp["single_2d"]["z"]
    np.testing.assert_allclose(res["pair"][0], A @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(res["pair"][1], A.T @ z, rtol=1e-12,
                               atol=1e-12)
    # y1: all-reduce over model_c, gather over model_r; y2 the converse
    assert res["pair_counts"] == {"all_gather": 2, "all_reduce": 2}


def test_2d_sharded_equals_row_sharded(run):
    """test_parallel.py::test_2d_sharded_equals_row_sharded (48x24, 2x2):
    the status and, within 1e-5 (1 + |f|), the objective of the unsharded
    JAX solve."""
    inp, _, ref = run
    res = _case(run, "rows_2d_equal")
    c = inp["rows_2d_equal"]["lp"][2]
    r, jr = res["solve"], ref["rows_2d_equal"]
    assert r["status"] == int(jr.status)
    o1 = float(c @ _x(jr.guess, 24, 48))
    o2 = float(c @ _x(r["guess"], 24, 48))
    assert abs(o1 - o2) <= 1e-5 * (1 + abs(o1))


# ----------------------------------------------------------------- batches
def _batched_asserts(inp, res, jr, name):
    A, b, c = inp[name]["lp"]
    np.testing.assert_array_equal(res["status"], np.asarray(jr.status))
    m, n = A.shape[1:]
    for i in range(A.shape[0]):
        x_p = _x(np.asarray(jr.guess[i]), n, m)
        x_s = _x(res["guess"][i], n, m)
        o_p, o_s = float(c[i] @ x_p), float(c[i] @ x_s)
        assert abs(o_p - o_s) <= 1e-4 * (1 + abs(o_p))
        assert x_s.min() > -1e-5
        assert (b[i] - A[i] @ x_s).min() > -1e-3


def test_batched_sharded(run):
    """test_parallel.py::test_batched_sharded over a 4x1 mesh (one instance
    a rank): the whole batch's statuses on every rank, equal to the JAX
    package's unsharded batch, objectives within 1e-4 (1 + |f|), one vote
    per check."""
    inp, _, ref = run
    res = _case(run, "batched_sharded")
    assert res["local_instances"] == 1 and res["route"] == "cpu"
    _batched_asserts(inp, res, ref["batched_sharded"], "batched_sharded")
    # the batch split alone: a vote per check and the result's gathers
    assert set(res["counts"]) <= {"all_reduce", "all_gather"}
    checks = int(res["iters"].max()) // 100 + 1
    assert res["counts"]["all_reduce"] <= checks + 1


def test_batched_sharded_linesearch(run):
    """LineSearch(DR) with CG on a batch split one instance a rank (each
    rank's line search probes its instance on a (1, 31) lane axis): every
    rank holds the whole batch's result, bit for bit the batch solved
    whole in one process; some instances stop at a check, the others run
    to the budget."""
    res = _case(run, "batched_linesearch")
    split, whole = res["split"], res["whole"]
    for k in whole:
        np.testing.assert_array_equal(split[k], whole[k], err_msg=k)
    assert 0 < int((whole["status"] == 1).sum()) < 4
    assert int(whole["calls"].max()) > 200   # the probes' calls counted


def test_hybrid_batched_rows(run):
    """test_parallel.py::test_hybrid_batched_rows: instances over the outer
    axis, each A's rows over the inner axis of make_hybrid_mesh(2, 2)."""
    inp, _, ref = run
    res = _case(run, "hybrid_rows")
    assert res["local_instances"] == 1
    _batched_asserts(inp, res, ref["hybrid_rows"], "hybrid_rows")


def test_hybrid_mesh_validation(run):
    """make_hybrid_mesh raises on a size mismatch; a square (m == n) batch
    row-shards by its named fields: A's rows split, b and c whole."""
    res = _case(run, "hybrid_validation")
    assert res["raised"] is not None and "devices" in res["raised"]
    assert res["block"] == (1, 8, 16)
    assert res["A_shape"] == (1, 16, 16)
    assert res["b"] == (1, 16) and res["c"] == (1, 16)


# ---------------------------------------------------------------------- CG
@pytest.mark.parametrize("variant,per_iter", [("standard", 2),
                                              ("pipelined", 1),
                                              ("tracked", 2)])
def test_cg_sharded_vectors_reduction_counts(run, variant, per_iter):
    """tests/test_comm_volume.py's CG budgets: standard CG (and the
    tracked CG of the HSDE projection) makes 1 + 2 all-reduces per
    iteration, the pipelined variant 1 + 1, and nothing else; the gathered
    solution solves the system."""
    inp, _, _ = run
    res = _case(run, "cg_counts")[variant]
    it = res["iters"]
    assert it > 0
    assert res["counts"] == {"all_reduce": 1 + per_iter * it}, res
    d, b = inp["cg_counts"]["d"], inp["cg_counts"]["b"]
    scale = d / 4 if variant == "tracked" else d   # M = d/4 I there
    np.testing.assert_allclose(scale * res["x"], b, atol=1e-7)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    M = (Q * np.linspace(1.0, 50.0, n)) @ Q.T
    return M, rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("tol", [1e-6, 1e-9])
def test_pipelined_cg_matches_jax(tol):
    """conjugate_gradient_pipelined against the JAX package's at f64 on an
    SPD system: iterates within 1e-10 relative, the same count."""
    M, b, x0 = _spd(60, 3)
    ref = jcg.conjugate_gradient_pipelined(
        lambda v: jnp.asarray(M) @ v, jnp.asarray(b), jnp.asarray(x0),
        tol=tol, max_iters=500)
    Mt = torch.as_tensor(M)
    got = tcg.conjugate_gradient_pipelined(
        lambda v: Mt @ v, torch.as_tensor(b), torch.as_tensor(x0), tol=tol,
        max_iters=500)
    assert int(got.iters) == int(ref.iters)
    want = np.asarray(ref.x)
    np.testing.assert_allclose(got.x.numpy(), want,
                               rtol=0, atol=1e-10 * np.abs(want).max())


def test_pipelined_cg_lanes_match_single():
    """With a lane axis each lane stops on its own, as under vmap."""
    M, b, x0 = _spd(40, 4)
    Mt = torch.as_tensor(M)
    B = torch.stack([torch.as_tensor(b), 3.0 * torch.as_tensor(b)])
    X0 = torch.stack([torch.as_tensor(x0), torch.zeros(40, dtype=B.dtype)])
    lanes = tcg.conjugate_gradient_pipelined(
        lambda V: V @ Mt.T, B, X0, tol=1e-8, max_iters=300)
    for j in range(2):
        one = tcg.conjugate_gradient_pipelined(
            lambda v: Mt @ v, B[j], X0[j], tol=1e-8, max_iters=300)
        assert int(lanes.iters[j]) == int(one.iters)
        np.testing.assert_allclose(lanes.x[j].numpy(), one.x.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_solve_pipelined_matches_jax():
    """solve(..., cg_variant="pipelined") on a small LP against the JAX
    package's solve with the same option: the same status, the objective
    within 1e-6 (1 + |f|) in f64, at the same iteration count."""
    A, b, c = _single_lp(17, 12, 18)
    m, n = A.shape
    opts = dict(eps=1e-6, max_iters=3000, verbose=0, cg_variant="pipelined")
    jsol = fos_tpu.solve(A, b, c, jnonneg(m), jnonneg(n), alg=DR(), **opts)
    sol = fos_tpu_torch.solve(A, b, c, fos_tpu_torch.nonneg(m),
                              fos_tpu_torch.nonneg(n), alg=fos_tpu_torch.DR(),
                              device="cpu", **opts)
    assert sol.status == jsol.status == "Optimal"
    assert sol.iters == jsol.iters
    assert abs(sol.objval - jsol.objval) <= 1e-6 * (1 + abs(jsol.objval))


def test_pipelined_projector_keeps_no_tracked_state():
    """The pipelined variant never reads v_warm (the JAX package's
    init_state_from): its state carries none, and a projection lands on
    the HSDE subspace {Qu = v}."""
    from fos_tpu_torch.linalg import hsde_ops
    from fos_tpu_torch.linalg.affine import HSDEAffineProjector

    A, b, c = (torch.as_tensor(v) for v in _single_lp(10, 8, 12))
    proj = HSDEAffineProjector.create(A, b, c, cg_variant="pipelined",
                                      decreasing_accuracy=False,
                                      tol_floor=1e-12)
    z = torch.as_tensor(np.random.default_rng(2).standard_normal(2 * proj.l))
    st = proj.init_state_from(z)
    assert st.v_warm is None
    out, st2 = proj.project(z, st)
    l = proj.l
    q = hsde_ops.q_mul(A, b, c, out[:l])
    np.testing.assert_allclose(out[l:].numpy(), q.numpy(), atol=1e-9)
    assert bool(st2.initialized) and int(st2.last_iters) > 0
    with pytest.raises(ValueError):
        HSDEAffineProjector.create(A, b, c, cg_variant="fused")


def test_no_group_means_no_mesh(monkeypatch):
    """Without an initialised group or torchrun's environment the mesh
    raises; nothing carries on in one process."""
    import torch.distributed as dist

    from fos_tpu_torch.parallel import make_mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), device="cpu")

