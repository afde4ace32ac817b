"""fos_tpu_torch's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors, at ragged and wide shapes, plus
bit-reproducibility, launch counting and input checks.

Needs a CUDA card (marker ``gpu``); skips without one.  Run on the card
(``--noconftest``: ``tests/conftest.py`` imports jax, which the port's
machines need not have):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: |kernel - plain| <= 2e-4 + 2e-5 |plain| (f32 sums in another
order).  This file imports no jax, so it also runs where jax is absent.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.linalg import sparse_ell as tse
from fos_tpu_torch.linalg.dense_pair import (PaddedDenseOp, fused_matvec,
                                             fused_matvec_plain)

pytestmark = pytest.mark.gpu
RTOL, ATOL = 2e-5, 2e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _close(got, want):
    for g, w in zip(got, want):
        assert bool(((g - w).abs() <= ATOL + RTOL * w.abs()).all()), (
            float((g - w).abs().max()))


def _dense(M, N, cuda):
    g = torch.Generator(device="cpu").manual_seed(M * 7919 + N)
    return (torch.randn(M, N, generator=g).to(cuda),
            torch.randn(N, generator=g).to(cuda),
            torch.randn(M, generator=g).to(cuda))


# ragged edges, one row of tiles (1x4000), one column of tiles (4000x1),
# tall and wide (many partials per output in one direction)
DENSE_SHAPES = [(1, 1), (33, 129), (300, 471), (1000, 1000), (4097, 130),
                (1, 4000), (4000, 1), (5000, 300), (300, 5000)]


@pytest.mark.parametrize("M,N", DENSE_SHAPES)
def test_fused_matvec_kernel(cuda, M, N):
    """K1 through the free function (its tile kernel and its sum launched
    once each) and through the operator, against the plain version."""
    A, x1, x2 = _dense(M, N, cuda)
    before = _cuda.LAUNCHES["fused_matvec"]
    _cuda.device_launch_counts(reset=True)
    got = fused_matvec(A, x1, x2)
    assert _cuda.LAUNCHES["fused_matvec"] == before + 1
    # one launch of each of K1's two kernels, counted on the device
    counts = _cuda.device_launch_counts(reset=True)
    assert counts["fused_matvec"] == counts["fused_matvec_sum"] == 1
    _close(got, fused_matvec_plain(A, x1, x2))
    again = fused_matvec(A, x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    op = PaddedDenseOp.create(A)
    _close(op.mv_pair(x1, x2), got)
    _close((op.mv(x1), op.rmv(x2)), got)


def test_dense_pair_repeats_and_interleaves(cuda):
    """100 calls give the same bits (the partial buffers are the operator's
    and are rewritten by every call), also with another operator's calls in
    between."""
    A, x1, x2 = _dense(2000, 1000, cuda)
    B, u1, u2 = _dense(333, 1000, cuda)
    opa, opb = PaddedDenseOp.create(A), PaddedDenseOp.create(B)
    first_a, first_b = opa.mv_pair(x1, x2), opb.mv_pair(u1, u2)
    for _ in range(100):
        assert all(torch.equal(a, b) for a, b in zip(opa.mv_pair(x1, x2),
                                                     first_a))
        assert all(torch.equal(a, b) for a, b in zip(opb.mv_pair(u1, u2),
                                                     first_b))
    _close(first_a, fused_matvec_plain(A, x1, x2))


def test_dense_op_takes_slices_of_the_state(cuda):
    """x1, x2 as the HSDE solve passes them: slices of one vector at any
    offset (not 16-byte aligned)."""
    A, _, _ = _dense(301, 203, cuda)
    v = torch.randn(1 + 203 + 301, device=cuda)
    x1, x2 = v[1:204], v[204:]
    op = PaddedDenseOp.create(A)
    _close(op.mv_pair(x1, x2), fused_matvec_plain(A, x1, x2))


# (M, N, lanes): the dense LP's 1000^2 at the line search's 31 lanes and
# fewer, and two of chip_smoke.py's K1 edge shapes (tall, wide)
LANE_CASES = [(1000, 1000, 1), (1000, 1000, 2), (1000, 1000, 31),
              (5000, 300, 3), (300, 5000, 31)]


@pytest.mark.parametrize("M,N,B", LANE_CASES)
def test_dense_pair_lanes_bit_equal_to_single(cuda, M, N, B):
    """K1 over B lanes: one launch of the lane tile kernel and one of its
    sum, counted on the device; lane b bit-equal to the single-vector K1
    on lane b's vectors, also when the lanes are rows of a larger state
    (q_mul's slices); within tolerance of the plain version."""
    A, _, _ = _dense(M, N, cuda)
    g = torch.Generator(device="cpu").manual_seed(B)
    state = torch.randn(B, N + M + 1, generator=g).to(cuda)
    op = PaddedDenseOp.create(A)
    for X1, X2 in ((state[:, :N], state[:, N:N + M]),
                   (state[:, :N].contiguous(), state[:, N:N + M].contiguous())):
        before = dict(_cuda.LAUNCHES)
        _cuda.device_launch_counts(reset=True)
        Y, Z = op.mv_pair(X1, X2)
        counts = _cuda.device_launch_counts(reset=True)
        assert _cuda.LAUNCHES["fused_matvec_lanes"] == \
            before["fused_matvec_lanes"] + 1
        assert _cuda.LAUNCHES["fused_matvec"] == before["fused_matvec"]
        assert counts["fused_matvec_lanes"] == 1
        assert counts["fused_matvec_lanes_sum"] == 1
        assert counts["fused_matvec"] == counts["fused_matvec_sum"] == 0
        for b in range(B):
            y, z = op.mv_pair(X1[b], X2[b])
            assert torch.equal(Y[b], y) and torch.equal(Z[b], z), b
        _close((Y, Z), (X1 @ A.T, X2 @ A))
        again = op.mv_pair(X1, X2)
        assert torch.equal(again[0], Y) and torch.equal(again[1], Z)


def test_dense_pair_lanes_raise_on_inputs_they_do_not_take(cuda):
    op = PaddedDenseOp.create(torch.zeros(8, 16, device=cuda))
    lanes = op._pair.lanes
    X1, X2 = torch.zeros(3, 16, device=cuda), torch.zeros(3, 8, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        lanes(torch.zeros(3, 8, device=cuda), X2)
    with pytest.raises(ValueError, match="shape"):
        lanes(X1, torch.zeros(3, 8, 1, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        lanes(X1.double(), X2)
    with pytest.raises(ValueError, match="device"):
        lanes(X1.cpu(), X2)
    with pytest.raises(ValueError, match="contiguous"):
        lanes(torch.zeros(3, 32, device=cuda)[:, ::2], X2)
    with pytest.raises(ValueError, match="lanes"):
        lanes(X1, torch.zeros(2, 8, device=cuda))
    with pytest.raises(ValueError, match="lanes"):
        lanes(X1[:0], X2[:0])


def _banded(m, n, bw, seed):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        nz = rng.integers(1, 4)
        rows.extend([i] * nz)
        cols.extend(rng.integers(lo, hi, nz).tolist())
        vals.extend(rng.standard_normal(nz).tolist())
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()


CASES = {
    "band_1000x1200": lambda: _banded(1000, 1200, 150, 4),
    "band_1200x1000": lambda: _banded(1200, 1000, 250, 4),
    "wide_span_2048": lambda: sp.random(
        2048, 2048, density=0.03, random_state=np.random.RandomState(31)),
    "scattered_700x900": lambda: sp.random(
        700, 900, density=0.01, random_state=np.random.RandomState(9)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_pair_kernels(cuda, case, kind):
    A = CASES[case]().astype(np.float32)
    m, n = A.shape
    cls = tse.BandedBlockOp if kind == "band" else tse.BlockedEllOp
    op = cls.create(A, device=cuda)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n, dtype=np.float32), device=cuda)
    z = torch.as_tensor(rng.standard_normal(m, dtype=np.float32), device=cuda)
    key = "band_mv_pair" if kind == "band" else "bell_mv_pair"
    before = _cuda.LAUNCHES[key]
    y1, y2 = op.mv_pair(x, z)
    assert _cuda.LAUNCHES[key] == before + 1
    _close((y1.cpu(), y2.cpu()),
           (torch.from_numpy(A @ x.cpu().numpy()),
            torch.from_numpy(A.T @ z.cpu().numpy())))
    again = op.mv_pair(x, z)
    assert torch.equal(again[0], y1) and torch.equal(again[1], y2)


def test_kernels_raise_on_inputs_they_do_not_take(cuda):
    A = torch.zeros(8, 8, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fused_matvec(A, torch.zeros(8, dtype=torch.float64, device=cuda),
                     torch.zeros(8, dtype=torch.float64, device=cuda))
    A = torch.zeros(8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_matvec(A.T, torch.zeros(8, device=cuda),
                     torch.zeros(16, device=cuda))
    with pytest.raises(ValueError, match="device"):
        fused_matvec(torch.zeros(8, 8, device=cuda), torch.zeros(8),
                     torch.zeros(8, device=cuda))
    # the bound routes: fixed operands at build, vectors per call
    with pytest.raises(TypeError, match="float32"):
        PaddedDenseOp.create(torch.zeros(8, 8, dtype=torch.float64,
                                         device=cuda))
    op = PaddedDenseOp.create(torch.zeros(8, 16, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        op.mv_pair(torch.zeros(8, device=cuda), torch.zeros(8, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        op.mv_pair(torch.zeros(16, dtype=torch.float64, device=cuda),
                   torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        op.mv_pair(torch.zeros(32, device=cuda)[::2],
                   torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="device"):
        op.mv_pair(torch.zeros(16), torch.zeros(8, device=cuda))
    _, band = _ops("band_1000x1200", "band", cuda)
    with pytest.raises(ValueError, match="device"):
        band.mv_pair(torch.zeros(1200), torch.zeros(1000, device=cuda))


def _ops(case, kind, cuda):
    A = CASES[case]().astype(np.float32)
    cls = tse.BandedBlockOp if kind == "band" else tse.BlockedEllOp
    return A, cls.create(A, transpose_table=True, device=cuda)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_mv_kernels(cuda, case, kind):
    """K4/K5 over the A table (mv) and the A' table (rmv): ragged ELL rows
    (the scattered A' table), S > 8 (wide span), non-square shapes."""
    A, op = _ops(case, kind, cuda)
    m, n = A.shape
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(n, dtype=np.float32), device=cuda)
    y = torch.as_tensor(rng.standard_normal(m, dtype=np.float32), device=cuda)
    key = "band_mv" if kind == "band" else "bell_mv"
    before = _cuda.LAUNCHES[key]
    got_mv, got_rmv = op.mv(x), op.rmv(y)
    assert _cuda.LAUNCHES[key] == before + 2
    _close((got_mv.cpu(), got_rmv.cpu()),
           (torch.from_numpy(A @ x.cpu().numpy()),
            torch.from_numpy(A.T @ y.cpu().numpy())))
    assert torch.equal(op.mv(x), got_mv) and torch.equal(op.rmv(y), got_rmv)
    # against the plain versions on the same padded CUDA inputs
    if kind == "band":
        xb = op._pad(x, op._ncb() + op.blocks.shape[1], 128)
        _close((tse.band_mv(op.cs, op.blocks, xb),),
               (tse.band_mv_plain(op.cs, op.blocks, xb),))
    else:
        yb = op._pad(y, op.blocks.shape[0], 128)
        _close((tse.bell_mv(op.cols_t, op.blocks_t, yb, op.counts_t),),
               (tse.bell_mv_plain(op.cols_t, op.blocks_t, yb),))


#: the products' names: (single kernel, lane kernel, lane kernel's sum)
TILE_LANE_KERNELS = {
    ("band", "mv_pair"): ("band_mv_pair", "band_mv_pair_lanes",
                          "band_mv_pair_lanes_sum"),
    ("bell", "mv_pair"): ("bell_mv_pair", "bell_mv_pair_lanes",
                          "bell_mv_pair_lanes_sum"),
    ("band", "mv"): ("band_mv", "band_mv_lanes", None),
    ("bell", "mv"): ("bell_mv", "bell_mv_lanes", None),
}


#: lane counts: one and two lanes, an odd count, the line search's 31,
#: and the edges of the lane kernels' chunks: K4/K5 take 8 lanes a chunk
#: up to 8, else 32 (K2/K3 32)
TILE_LANE_COUNTS = [1, 2, 5, 7, 8, 9, 31, 32, 33, 64]


@pytest.mark.parametrize("lanes", TILE_LANE_COUNTS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_lanes_bit_equal_to_single(cuda, case, kind, lanes):
    """K2-K5 over lanes (``mv_pair``, ``mv``, ``rmv`` on (L, k) vectors,
    the lanes rows of a larger state as q_mul's slices): one launch of the
    lane kernel (and of its sum) per call, counted on the device, and no
    single call; lane b bit-equal to the single kernel on lane b's
    vectors; within tolerance of the plain lane versions on the same
    padded inputs; a repeat bit-equal.  The blocked-ELL tables of the
    banded cases have ragged rows (band_1200x1000: counts 0 to 5 under a
    kmax of 5, six row blocks empty), wide_span_2048 16 slots a row."""
    A, op = _ops(case, kind, cuda)
    m, n = A.shape
    g = torch.Generator(device="cpu").manual_seed(lanes * 31 + m)
    state = torch.randn(lanes, n + m + 1, generator=g).to(cuda)
    X, Z = state[:, :n], state[:, n:n + m]
    plain_pair, plain_mv = ((tse.band_mv_pair_lanes_plain,
                             tse.band_mv_lanes_plain) if kind == "band" else
                            (tse.bell_mv_pair_lanes_plain,
                             tse.bell_mv_lanes_plain))
    index = op.cs if kind == "band" else op.cols
    t = op.transposed()
    calls = (
        ("mv_pair", lambda: op.mv_pair(X, Z),
         lambda b: op.mv_pair(X[b], Z[b]),
         lambda: plain_pair(index, op.blocks,
                            op._pad(X, op._xrows, 128),
                            op._pad(Z, op.blocks.shape[0], 128)), (m, n)),
        ("mv", lambda: (op.mv(X),), lambda b: (op.mv(X[b]),),
         lambda: (plain_mv(index, op.blocks, op._pad(X, op._xrows, 128)),),
         (m,)),
        ("mv", lambda: (op.rmv(Z),), lambda b: (op.rmv(Z[b]),),
         lambda: (plain_mv(t[1], t[0], op._pad(Z, op._yrows_t, 128)),),
         (n,)))
    for product, lane_call, single, plain, cut in calls:
        one, lane_kernel, lane_sum = TILE_LANE_KERNELS[(kind, product)]
        _cuda.device_launch_counts(reset=True)
        got = lane_call()
        counts = _cuda.device_launch_counts(reset=True)
        assert counts[lane_kernel] == 1 and counts[one] == 0, counts
        if lane_sum is not None:
            assert counts[lane_sum] == 1, counts
        for b in range(lanes):
            for g1, s1 in zip(got, single(b)):
                assert torch.equal(g1[b], s1), (product, b)
        want = plain()
        _close([g.cpu() for g in got],
               [w.reshape(lanes, -1)[:, :k].cpu()
                for w, k in zip(want, cut)])
        again = lane_call()
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("lanes", [31, 33])
@pytest.mark.parametrize("case", ["band_1200x1000", "wide_span_2048"])
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_pair_lanes_replayed_bit_equal(cuda, case, kind, lanes):
    """K2/K3 over lanes captured in a CUDA graph: a replay on new vectors
    (copied into the captured inputs) is bit-equal to the eager call on
    them, and launches the lane kernel and its sum once each."""
    _, op = _ops(case, kind, cuda)
    g = torch.Generator(device="cpu").manual_seed(lanes + len(case))
    X = torch.randn(lanes, op.n, generator=g).to(cuda)
    Z = torch.randn(lanes, op.m, generator=g).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op.mv_pair(X, Z)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = op.mv_pair(X, Z)
    X.copy_(torch.randn(lanes, op.n, generator=g).to(cuda))
    Z.copy_(torch.randn(lanes, op.m, generator=g).to(cuda))
    _cuda.device_launch_counts(reset=True)
    graph.replay()
    counts = _cuda.device_launch_counts(reset=True)
    name = f"{kind}_mv_pair_lanes"
    assert counts[name] == counts[f"{name}_sum"] == 1, counts
    eager = op.mv_pair(X, Z)
    assert all(torch.equal(a, b) for a, b in zip(out, eager))


@pytest.mark.parametrize("lanes", [5, 31, 33])
@pytest.mark.parametrize("product", ["mv", "rmv"])
@pytest.mark.parametrize("case", ["band_1200x1000", "wide_span_2048"])
@pytest.mark.parametrize("kind", ["band", "bell"])
def test_tile_mv_lanes_replayed_bit_equal(cuda, case, kind, product, lanes):
    """K4/K5 over lanes captured in a CUDA graph (``mv`` over the A table,
    ``rmv`` over the A' table): a replay on new vectors (copied into the
    captured input) is bit-equal to the eager call on them, and launches
    the lane kernel once."""
    _, op = _ops(case, kind, cuda)
    g = torch.Generator(device="cpu").manual_seed(lanes + 7 * len(case))
    width = op.n if product == "mv" else op.m
    X = torch.randn(lanes, width, generator=g).to(cuda)
    call = getattr(op, product)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(X)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(X)
    X.copy_(torch.randn(lanes, width, generator=g).to(cuda))
    _cuda.device_launch_counts(reset=True)
    graph.replay()
    counts = _cuda.device_launch_counts(reset=True)
    assert counts[f"{kind}_mv_lanes"] == 1 and counts[f"{kind}_mv"] == 0, \
        counts
    assert torch.equal(out, call(X))


def test_tile_lanes_raise_on_inputs_they_do_not_take(cuda):
    """The lane kernels' bound route raises on what it does not take; a
    lane call on the card never drops to the plain version or to single
    calls."""
    for kind, case in (("band", "band_1000x1200"),
                       ("bell", "scattered_700x900")):
        _, op = _ops(case, kind, cuda)
        nrb = op.blocks.shape[0]
        XB = torch.zeros(3, op._xrows, 128, device=cuda)
        ZB = torch.zeros(3, nrb, 128, device=cuda)
        for fn, args in ((op._pair_lanes, (XB, ZB)), (op._mv_lanes, (XB,))):
            with pytest.raises(TypeError, match="float32"):
                fn(*(a.double() for a in args))
            with pytest.raises(ValueError, match="device"):
                fn(*(a.cpu() for a in args))
            with pytest.raises(ValueError, match="shape"):
                fn(*(a[:, 1:] for a in args))
            with pytest.raises(ValueError, match="lanes"):
                fn(*(a[:0] for a in args))
            shifted = torch.zeros(XB.numel() + 1, device=cuda)[1:]
            with pytest.raises(ValueError, match="aligned"):
                fn(shifted.view_as(XB), *args[1:])
            with pytest.raises(ValueError, match="contiguous"):
                fn(torch.zeros(3, op._xrows, 256, device=cuda)[..., ::2],
                   *args[1:])
        with pytest.raises(ValueError, match="shape"):
            op._pair_lanes(XB, ZB[:2])
        with pytest.raises(ValueError, match="device"):
            op.mv_pair(torch.zeros(3, op.n), torch.zeros(3, op.m,
                                                         device=cuda))
        with pytest.raises(ValueError, match="device"):
            op.mv(torch.zeros(3, op.n))


def test_probe_kernels_bit_equal(cuda):
    from fos_tpu_torch.tools import launch_probe as lp

    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(4)).to(cuda)
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    before = dict(_cuda.LAUNCHES)
    assert torch.equal(lp.probe_tiny(x), lp.probe_tiny_plain(x))
    assert torch.equal(lp.probe_prefetch(idx, x), lp.probe_prefetch_plain(idx, x))
    assert _cuda.LAUNCHES["probe_tiny"] == before["probe_tiny"] + 1
    assert _cuda.LAUNCHES["probe_prefetch"] == before["probe_prefetch"] + 1


# (offset in floats into a buffer, shape): the tile at each unaligned
# start (scalar loads; the aligned tile is the test above), and a ragged
# length over several blocks (a partial last vector)
PROBE_VIEWS = [(1, (8, 128)), (2, (8, 128)), (3, (8, 128)), (0, (4099,)),
               (1, (4099,))]


@pytest.mark.parametrize("offset,shape", PROBE_VIEWS)
def test_probe_kernels_on_views(cuda, offset, shape):
    """P1 and P2 on a contiguous view that starts ``offset`` floats into a
    larger buffer: bit-equal to their plain versions, one launch a call."""
    from fos_tpu_torch.tools import launch_probe as lp

    n = int(np.prod(shape))
    g = torch.Generator().manual_seed(5 + offset)
    x = torch.randn(n + 4, generator=g).to(cuda)[offset:offset + n].view(shape)
    assert x.data_ptr() % 16 == 4 * offset
    idx = torch.arange(1, 9, dtype=torch.int32, device=cuda)
    for name, call, plain in (
            ("probe_tiny", lambda: lp.probe_tiny(x), lp.probe_tiny_plain(x)),
            ("probe_prefetch", lambda: lp.probe_prefetch(idx, x),
             lp.probe_prefetch_plain(idx, x))):
        before = _cuda.LAUNCHES[name]
        assert torch.equal(call(), plain), name
        assert _cuda.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("nidx", [1, 8, 256])
def test_probe_prefetch_index_lengths(cuda, nidx):
    """P2's result does not depend on its operand's length or values (the
    TPU kernel's index maps ignore it); 256 is the longest it takes."""
    from fos_tpu_torch.tools import launch_probe as lp

    rng = np.random.default_rng(nidx)
    x = torch.as_tensor(rng.standard_normal((8, 128), dtype=np.float32),
                        device=cuda)
    idx = torch.as_tensor(rng.integers(1, 2**31 - 1, nidx, dtype=np.int32),
                          device=cuda)
    zeros = torch.zeros(nidx, dtype=torch.int32, device=cuda)
    before = _cuda.LAUNCHES["probe_prefetch"]
    got = lp.probe_prefetch(idx, x)
    assert _cuda.LAUNCHES["probe_prefetch"] == before + 1
    assert torch.equal(got, lp.probe_prefetch_plain(idx, x))
    assert torch.equal(got, lp.probe_prefetch(zeros, x))
    assert _cuda.LAUNCHES["probe_prefetch"] == before + 2
    with pytest.raises(ValueError, match="k <= 256"):
        lp.probe_prefetch(torch.zeros(257, dtype=torch.int32, device=cuda), x)
    assert _cuda.LAUNCHES["probe_prefetch"] == before + 2


def test_tile_mv_raise_on_inputs_they_do_not_take(cuda):
    _, op = _ops("band_1000x1200", "band", cuda)
    xb = op._pad(torch.zeros(op.n, device=cuda), op._ncb() + op.blocks.shape[1],
                 128)
    with pytest.raises(TypeError, match="float32"):
        tse.band_mv(op.cs, op.blocks, xb.double())
    with pytest.raises(ValueError, match="device"):
        tse.band_mv(op.cs, op.blocks, xb.cpu())
    shifted = torch.zeros(xb.numel() + 1, device=cuda)[1:].view_as(xb)
    with pytest.raises(ValueError, match="aligned"):
        tse.band_mv(op.cs, op.blocks, shifted)
    _, ell = _ops("scattered_700x900", "bell", cuda)
    with pytest.raises(ValueError, match="device"):
        tse.bell_mv(ell.cols, ell.blocks, torch.zeros(ell._ncb(), 128,
                                                      device=cuda),
                    ell.counts.cpu())


def test_soc_projection_repeats_on_card(cuda):
    """The mixed SOC / rotated-SOC projection repeats bit for bit on the
    card (no atomics) and agrees with the CPU projection."""
    from fos_tpu_torch.cones import project
    from fos_tpu_torch.interop import cone_spec_from_blocks

    rng = np.random.default_rng(5)
    blocks = [("NONNEG", 7)] + [
        (("SOC", "SOC_ROTATED")[i % 2], int(d))
        for i, d in enumerate(rng.integers(3, 300, 60))]
    spec = cone_spec_from_blocks(blocks)
    x = torch.as_tensor(rng.standard_normal((3, spec.dim)) * 3.0)
    got = project(spec, x.to(cuda))
    assert torch.equal(project(spec, x.to(cuda)), got)
    np.testing.assert_allclose(got.cpu().numpy(), project(spec, x).numpy(),
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ graph route
def _lp_vectors(rng, m, n):
    """(x0, y0, s0, r0): complementary nonnegative pairs, f32."""
    x0, y0, s0, r0 = (np.abs(rng.standard_normal(k)).astype(np.float32)
                      for k in (n, m, m, n))
    xm, ym = rng.random(n) < 0.5, rng.random(m) < 0.5
    return x0 * xm, y0 * ym, s0 * ~ym, r0 * ~xm


def _tile_op(kind, cuda, nrb=4):
    """A banded (+2I diagonal) or scattered tile operator with both tables."""
    rng = np.random.default_rng(17)
    blocks = rng.standard_normal((nrb, 3, 128, 128)).astype(np.float32) / 20
    blocks[:, 1] += 2.0 * np.eye(128, dtype=np.float32)
    if kind == "band":
        cs = np.clip(np.arange(nrb) - 1, 0, nrb - 3).astype(np.int32)
        return tse.BandedBlockOp.from_arrays(blocks, cs, nrb * 128, nrb * 128,
                                             transpose_table=True, device=cuda)
    cols = np.stack([(np.arange(nrb) + k) % nrb for k in (1, 0, 2)], 1)
    return tse.BlockedEllOp.from_arrays(blocks, cols.astype(np.int32),
                                        nrb * 128, nrb * 128,
                                        transpose_table=True, device=cuda)


def _route_case(case, cuda):
    """(a form factory, the kernel the path runs, eps, max_iters)."""
    from fos_tpu_torch import (AffinePlusLinearProjector, BlockSet, Box,
                               Feasibility, NonNeg, nonneg)
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.feasibility import FeasibilityForm
    from fos_tpu_torch.problems.hsde import HSDEForm

    rng = np.random.default_rng(3)
    if case == "dense":
        m, n = 200, 300
        A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
        x0, y0, s0, r0 = _lp_vectors(rng, m, n)
        b, c = A @ x0 + s0, r0 - A.T @ y0
        return (lambda: HSDEForm.build(conic_problem(
            A, b, c, nonneg(m), nonneg(n), device=cuda), pallas=True),
            "fused_matvec", 1e-5, 1000)
    kind = "band" if case.endswith("band") else "bell"
    op = _tile_op(kind, cuda)
    m, n = op.shape
    if case.startswith("feas"):
        xs = rng.uniform(0.1, 0.9, n).astype(np.float32)
        b = op.mv(torch.as_tensor(xs, device=cuda)).cpu().numpy() + 0.5
        S1 = AffinePlusLinearProjector.create(op, b, 0.0, -1, device=cuda)
        S2 = BlockSet([(Box(0.0, 1.0), n), (NonNeg(), m)])
        return (lambda: FeasibilityForm.build(
            Feasibility(S1, S2, n + m), device=cuda),
            f"{kind}_mv", 1e-3, 300)
    x0, y0, s0, r0 = (torch.as_tensor(v, device=cuda)
                      for v in _lp_vectors(rng, m, n))
    Ax0, ATy0 = op.mv_pair(x0, y0)
    b, c = Ax0 + s0, r0 - ATy0
    return (lambda: HSDEForm.build(conic_problem(
        op, b, c, nonneg(m), nonneg(n), device=cuda)),
        f"{kind}_mv_pair", 1e-5, 1000)


@pytest.mark.parametrize("case", ["dense", "band", "bell", "feas_band",
                                  "feas_bell"])
def test_graph_route_matches_the_eager_route(cuda, case):
    """K1-K5 paths: run's graph chunks and fused_solve (under sync debug
    mode "error": no host read) give the eager chunks' status, iterations
    and bits, and the device counts the kernel's launches in the replays."""
    from fos_tpu_torch import DR
    from fos_tpu_torch.solvers import engine

    make_form, kernel, eps, max_iters = _route_case(case, cuda)
    kw = dict(eps=eps, max_iters=max_iters, checki=50, verbose=0)
    eager = engine._run_eager(make_form(), DR(), **kw)
    _cuda.device_launch_counts(reset=True)
    graph = engine.run(make_form(), DR(), **kw)
    counts = _cuda.device_launch_counts(reset=True)
    assert (graph.status, graph.iters) == (eager.status, eager.iters)
    assert torch.equal(graph.guess, eager.guess)
    assert torch.equal(graph.state.x, eager.state.x)
    assert counts[kernel] > 0 and counts["cg_continue"] > 0
    assert counts["count_continue"] > 0
    form = make_form()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused = engine.fused_solve(DR(), form, form.initial_value(form.dtype),
                                   max_iters=max_iters, eps=eps, checki=50)
        again = engine.fused_solve(DR(), form,
                                   form.initial_value(form.dtype),
                                   max_iters=max_iters, eps=eps, checki=50)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(fused.iters) == eager.iters
    assert torch.equal(fused.guess, eager.guess)
    # a budget spent without a terminal status: run keeps Continue after a
    # check at the last iteration, fused_solve (as the JAX package's) still
    # checks the guess at the end
    if not (eager.status == engine.Status.CONTINUE
            and eager.iters == max_iters):
        assert int(fused.status) == eager.status
    assert torch.equal(again.guess, fused.guess)


@pytest.mark.parametrize("alg", ["gapp", "gapa", "fista", "dykstra"])
def test_algorithms_through_graphs(cuda, alg):
    """The testfeasibility tier through the graph route (GAPP's projected
    step an IF node on the device's st.i) gives the eager route's counts
    and bits."""
    from fos_tpu_torch import (AffineSet, Dykstra, FISTA, Feasibility, GAPA,
                               GAPP, NonNeg)
    from fos_tpu_torch.problems.feasibility import FeasibilityForm
    from fos_tpu_torch.solvers import engine

    rng = np.random.default_rng(2)
    xsol = np.abs(rng.standard_normal(100))
    A = rng.standard_normal((50, 100))
    prob = Feasibility(AffineSet.create(A, A @ xsol, device=cuda), NonNeg(),
                       100)
    algorithm = {"gapp": GAPP(iproj=7), "gapa": GAPA(), "fista": FISTA(),
                 "dykstra": Dykstra()}[alg]
    kw = dict(max_iters=500, checki=50, eps=1e-8, verbose=0)
    eager = engine._run_eager(FeasibilityForm.build(prob, device=cuda),
                              algorithm, **kw)
    graph = engine.run(FeasibilityForm.build(prob, device=cuda), algorithm,
                       **kw)
    assert (graph.status, graph.iters) == (eager.status, eager.iters)
    assert torch.equal(graph.guess, eager.guess)


def test_condition_kernels_set_their_nodes(cuda):
    """cg_continue, count_continue and flag_continue decide an IF node as
    their plain versions decide on the host."""
    from fos_tpu_torch.linalg import control
    from fos_tpu_torch.solvers import graphs

    rn, tol2 = (torch.zeros((), device=cuda) for _ in range(2))
    it = torch.zeros((), dtype=torch.int32, device=cuda)
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    conds = {"cg": lambda: control.CGContinue(rn, tol2, it, 5),
             "count": lambda: control.Count(it, control.TEST, 3),
             "flag": lambda: control.Flag(flag, True)}
    for name, make in conds.items():
        hit = torch.zeros((), dtype=torch.int32, device=cuda)

        def fn(h, make=make):
            control._Captured.if_(h, make, lambda: h.fill_(1))
            return (h,)

        g = graphs.Captured(fn, (hit,))
        for r, i, f in ((0.0, 0, False), (2.0, 4, True), (2.0, 5, False),
                        (float("nan"), 1, True), (2.0, 2, True)):
            rn.fill_(r), tol2.fill_(1.0), it.fill_(i), flag.fill_(f)
            assert bool(g(hit)[0]) == make().plain(), (name, r, i, f)


# -------------------------------------------------------------- the cones
@pytest.mark.parametrize("d", [64, 256])
def test_psd_poly_on_card_vs_f64_oracle(cuda, d):
    """The tuned polynomial filter on the card in f32 (TF32 off) within
    1e-5 ||X||_2 of the eigenvalue clamp computed on the host in f64."""
    from fos_tpu_torch.cones.psd_poly import psd_project_poly

    rng = np.random.default_rng(29 + d)
    B = rng.standard_normal((2, d, d)) / np.sqrt(d)
    X = ((B + np.swapaxes(B, -1, -2)) / 2).astype(np.float32)
    got = psd_project_poly(torch.as_tensor(X, device=cuda))
    assert got.dtype == torch.float32
    w, V = np.linalg.eigh(X.astype(np.float64))
    ref = (V * np.maximum(w, 0.0)[:, None, :]) @ np.swapaxes(V, -1, -2)
    err = np.abs(got.double().cpu().numpy() - ref).max()
    assert err <= 1e-5 * np.abs(w).max()
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _sdp_form(cuda, psd_method, d=16):
    """The lambda-min SDP (min <C, X> s.t. tr X = 1, X psd) at a small side
    through chip_smoke's matrix-free operator."""
    import chip_smoke
    from fos_tpu_torch.problems.hsde import HSDEForm

    prob, sC, lam = chip_smoke.sdp_problem(d, cuda)
    return (lambda: HSDEForm.build(prob, densify=False,
                                   psd_method=psd_method)), sC, lam


def test_psd_form_captures_under_sync_debug_error(cuda):
    """A form with PSD blocks projected by "auto" (poly on the card): run's
    graph chunks give the eager route's status, iterations and bits, and
    fused_solve captures and replays with no host read (sync debug mode
    "error")."""
    from fos_tpu_torch import DR
    from fos_tpu_torch.solvers import engine

    make_form, _, _ = _sdp_form(cuda, "auto")
    assert make_form().psd_method == "poly" and make_form().graph_route
    kw = dict(eps=1e-5, max_iters=300, checki=50, verbose=0)
    eager = engine._run_eager(make_form(), DR(), **kw)
    graph = engine.run(make_form(), DR(), **kw)
    assert (graph.status, graph.iters) == (eager.status, eager.iters)
    assert torch.equal(graph.guess, eager.guess)
    form = make_form()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused = engine.fused_solve(DR(), form, form.initial_value(form.dtype),
                                   max_iters=300, eps=1e-5, checki=50)
        again = engine.fused_solve(DR(), form, form.initial_value(form.dtype),
                                   max_iters=300, eps=1e-5, checki=50)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(fused.iters) == eager.iters
    assert torch.equal(fused.guess, eager.guess)
    assert torch.equal(again.guess, fused.guess)


def test_eigh_runs_the_eager_route_on_card(cuda, capsys):
    """psd_method="eigh" on the card: the form is built for the eager route
    (a capture of torch.linalg.eigh is refused), the solve says so in its
    header and on its solution, and reaches lambda_min."""
    from fos_tpu_torch import DR, solve
    from fos_tpu_torch.problems.hsde import populate_solution
    from fos_tpu_torch.solvers import engine

    make_form, sC, lam = _sdp_form(cuda, "eigh")
    form = make_form()
    assert form.psd_method == "eigh" and not form.graph_route
    assert form.route == "eager"
    res = engine.run(form, DR(), eps=1e-6, max_iters=20000, verbose=1)
    assert "PSD projection: eigh, eager route" in capsys.readouterr().out
    sol = populate_solution(form, res.guess, res.status, res.iters)
    assert sol.status == "Optimal" and sol.route == "eager"
    assert abs(sol.objval - lam) <= 1e-3 * abs(lam)
    fused = engine.fused_solve(DR(), form, form.initial_value(form.dtype),
                               max_iters=200, eps=1e-6, checki=50)
    assert int(fused.iters) > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exp_pow_on_card_vs_f64_host(cuda, dtype):
    """The exp and power projections on the card against the same functions
    run in f64 on the host: f64 within 1e-10 (1 + |v|); f32 finite, in the
    dtype, and repeating bit for bit (its error in the degenerate exp
    regime is the JAX package's too: PERF.md)."""
    from fos_tpu_torch.cones.exp import project_exp, project_exp_dual
    from fos_tpu_torch.cones.pow import project_pow, project_pow_dual

    rng = np.random.default_rng(31)
    V = rng.standard_normal((4096, 3)) * 2.0
    a = rng.uniform(0.05, 0.95, 4096)
    Vd, ad = torch.as_tensor(V, device=cuda, dtype=dtype), torch.as_tensor(
        a, device=cuda, dtype=dtype)
    Vh, ah = torch.as_tensor(V), torch.as_tensor(a)
    scale = 1.0 + Vh.abs().amax(-1, keepdim=True)
    for card, host in ((lambda: project_exp(Vd), lambda: project_exp(Vh)),
                       (lambda: project_exp_dual(Vd),
                        lambda: project_exp_dual(Vh)),
                       (lambda: project_pow(Vd, ad),
                        lambda: project_pow(Vh, ah)),
                       (lambda: project_pow_dual(Vd, ad),
                        lambda: project_pow_dual(Vh, ah))):
        got = card()
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert torch.equal(card(), got)
        if dtype == torch.float64:
            err = ((got.cpu() - host()).abs() / scale).max().item()
            assert err <= 1e-10


def test_equilibrated_banded_lp_launches_k2(cuda):
    """A banded LP handed to solve as scipy sparse with equilibrate=True is
    scaled on the host, packed into a BandedBlockOp, and solved through K2
    (launches counted on the device) to its certificate."""
    from fos_tpu_torch import DR, nonneg, solve
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    op = _tile_op("band", cuda)
    A = sp.coo_matrix(op.todense().cpu().numpy())
    m, n = A.shape
    rng = np.random.default_rng(3)
    x0, y0, s0, r0 = _lp_vectors(rng, m, n)
    b, c = A @ x0 + s0, r0 - A.T @ y0
    opt = float(c.astype(np.float64) @ x0)
    # at 512^2 "auto" keeps this grid sparse (storage ratio >= 0.5), as the
    # JAX package does; "bell" packs it (banded: span ratio 1)
    form = HSDEForm.build(conic_problem(A, b, c, nonneg(m), nonneg(n),
                                        device=cuda), equilibrate=True,
                          densify=False, sparse_format="bell")
    assert type(form.A).__name__ == "BandedBlockOp"
    assert form.dinv is not None and form.setup_seconds["equilibrate"] > 0
    _cuda.device_launch_counts(reset=True)
    sol = solve(A, b, c, nonneg(m), nonneg(n), alg=DR(), eps=1e-5,
                max_iters=5000, verbose=0, device=cuda, equilibrate=True,
                densify=False, sparse_format="bell")
    assert _cuda.device_launch_counts(reset=True)["band_mv_pair"] > 0
    assert sol.status == "Optimal" and sol.route == "graph"
    assert abs(sol.objval - opt) <= 1e-3 * abs(opt)


# ------------------------------------------- the lane axis, wrappers, batches
def _if_node(cuda, make):
    """A graph whose IF node ``make()`` decides; returns ``taken()``."""
    from fos_tpu_torch.linalg import control
    from fos_tpu_torch.solvers import graphs

    hit = torch.zeros((), dtype=torch.int32, device=cuda)

    def fn(h):
        control._Captured.if_(h, make, lambda: h.fill_(1))
        return (h,)

    g = graphs.Captured(fn, (hit,))
    return lambda: bool(g(hit)[0])


@pytest.mark.parametrize("lanes", [1, 31, 1024])
def test_cg_continue_lanes_sets_its_node(cuda, lanes):
    """cg_continue_lanes (any lane with rn > tol2 and it < max_iters; tol2
    shared or per lane, NaN included) and count_continue over a lane
    status decide an IF node as their plain versions decide on the host,
    and the lane kernel counts its launches on the device."""
    from fos_tpu_torch.linalg import control

    rng = np.random.default_rng(lanes)
    rn = torch.zeros(lanes, device=cuda)
    it = torch.zeros(lanes, dtype=torch.int32, device=cuda)
    for tol2 in (torch.ones((), device=cuda), torch.ones(lanes, device=cuda)):
        taken = _if_node(cuda, lambda: control.CGContinueLanes(rn, tol2, it,
                                                               5))
        _cuda.device_launch_counts(reset=True)
        for trial in range(8):
            rn.copy_(torch.as_tensor(rng.choice(
                [0.0, 0.5, 2.0, np.nan], lanes).astype(np.float32)))
            it.copy_(torch.as_tensor(rng.choice([0, 4, 5, 6], lanes)
                                     .astype(np.int32)))
            if trial % 2:
                rn.fill_(0.5)
            assert taken() == control.CGContinueLanes(rn, tol2, it,
                                                      5).plain()
        assert _cuda.device_launch_counts(reset=True)["cg_continue_lanes"] \
            == 8
    k = torch.zeros((), dtype=torch.int32, device=cuda)
    status = torch.ones(lanes, dtype=torch.int32, device=cuda)
    taken = _if_node(cuda, lambda: control.Count(k, control.TEST, 3, status,
                                                 0))
    for kv, live in ((0, 0), (0, 1), (2, lanes), (3, 1)):
        status.fill_(1)
        status[:live].fill_(0)
        k.fill_(kv)
        assert taken() == control.Count(k, control.TEST, 3, status, 0).plain()


def _dense_lp_form(cuda, m=120, n=200):
    from fos_tpu_torch import nonneg
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    rng = np.random.default_rng(4)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    x0, y0, s0, r0 = _lp_vectors(rng, m, n)
    return lambda: HSDEForm.build(conic_problem(
        A, A @ x0 + s0, r0 - A.T @ y0, nonneg(m), nonneg(n), device=cuda),
        pallas=True)


def test_linesearch_step_k1_count(cuda):
    """One LineSearch(DR) boundary step on a dense LP with pallas=True,
    eagerly and replayed from a CUDA graph: K1's device counts equal each
    other and the counts the CG passes imply, with the same bits.  The real
    projection makes single-vector calls (its r0 pair and 2 unroll pairs
    per pass); the 31 probe lanes make lane calls, one for all lanes per
    product (their r0 pair and 2 unroll pairs per pass, the passes running
    to the slowest lane)."""
    from fos_tpu_torch import DR, LineSearchWrapper
    from fos_tpu_torch.solvers import engine, graphs, wrappers
    from fos_tpu_torch.solvers.base import init_solver_state

    form = _dense_lp_form(cuda)()
    alg = LineSearchWrapper(DR(), lsinterval=20)
    sets, u = form.sets, form.sets.s1.cg_unroll
    st = engine._run_steps(alg, form, init_solver_state(
        alg, sets, form.initial_value(form.dtype)), 19, 0)
    tmp2, s1 = alg.alg.relaxed_s1(sets, st.x, st.s1_state, st.aux)
    _, x_new, _ = alg.alg.relaxed_s2(sets, tmp2, st.s2_state, st.aux)
    cands = st.x[None] + wrappers.ls_alphas(st.x)[:, None] * (
        x_new - st.x)[None]
    _, probes = sets.s1.project(cands, s1)
    passes = -(-probes.last_iters.cpu().numpy().max() // u)
    single = 1 + 2 * u * (-(-int(s1.last_iters) // u))
    lane = 1 + 2 * u * int(passes)
    _cuda.device_launch_counts(reset=True)
    eager = alg.step(sets, st, 19)
    n_eager = _cuda.device_launch_counts(reset=True)
    form.prepare(st.x)
    g = graphs.Captured(lambda s: (alg.step(sets, s, None),), (st,))
    _cuda.device_launch_counts(reset=True)
    out = g(st)[0]
    counts = _cuda.device_launch_counts(reset=True)
    assert single == n_eager["fused_matvec"] == counts["fused_matvec"] \
        == counts["fused_matvec_sum"]
    assert lane == n_eager["fused_matvec_lanes"] \
        == counts["fused_matvec_lanes"] == counts["fused_matvec_lanes_sum"]
    assert counts["cg_continue_lanes"] > 0
    assert torch.equal(out.x, eager.x)


@pytest.mark.parametrize("wrapper", ["linesearch", "anderson", "longstep"])
def test_wrappers_through_graphs(cuda, wrapper):
    """A wrapped DR solve through run's graphs and fused_solve (under sync
    debug mode "error": the Anderson solve, the longstep FISTA loop and the
    line search's lanes hold no host read) gives the eager route's status,
    iterations and bits."""
    from fos_tpu_torch import (DR, AndersonWrapper, LineSearchWrapper,
                               LongstepWrapper)
    from fos_tpu_torch.solvers import engine

    alg = {"linesearch": LineSearchWrapper(DR(), lsinterval=20),
           "anderson": AndersonWrapper(DR(), adaptive=False),
           "longstep": LongstepWrapper(DR(), longinterval=20,
                                       nsave=5)}[wrapper]
    make = _dense_lp_form(cuda)
    kw = dict(eps=1e-5, max_iters=300, checki=50, verbose=0)
    eager = engine._run_eager(make(), alg, **kw)
    graph = engine.run(make(), alg, **kw)
    assert (graph.status, graph.iters) == (eager.status, eager.iters)
    assert torch.equal(graph.guess, eager.guess)
    form = make()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused = engine.fused_solve(alg, form, form.initial_value(form.dtype),
                                   max_iters=300, eps=1e-5, checki=50)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(fused.iters) == eager.iters
    assert torch.equal(fused.guess, eager.guess)


def test_anderson_solve_captures(cuda):
    """The Anderson k x k solve (pivoted elimination in tensor operations)
    captured in a CUDA graph under sync debug mode "error" gives the eager
    call's bits, and agrees with torch.linalg.solve."""
    from fos_tpu_torch.solvers import graphs
    from fos_tpu_torch.solvers.wrappers import _solve_small

    rng = np.random.default_rng(9)
    F = torch.as_tensor(rng.standard_normal((10, 300)), dtype=torch.float32,
                        device=cuda)
    M = F @ F.T
    M = M / M.trace() + 1e-5 * torch.eye(10, device=cuda)
    M[7, 7] += 1e30
    rhs = torch.ones(10, device=cuda)
    eager = _solve_small(M, rhs)
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = graphs.Captured(lambda a, b: (_solve_small(a, b),), (M, rhs))
        got = g(M, rhs)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, eager)
    want = torch.linalg.solve(M.double(), rhs.double()).float()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_solve_batched_routes_agree(cuda):
    """solve_batched on 16 instances of 32 x 48: the captured fused graph
    (under sync debug mode "error") and its loops run eagerly give equal
    statuses, iterations, CG iterations and bits, per instance."""
    from fos_tpu_torch import DR, build_batched_form, nonneg, solve_batched
    from fos_tpu_torch.parallel import batched

    rng = np.random.default_rng(6)
    B, m, n = 16, 32, 48
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    b = (np.einsum("bmn,bn->bm", A, np.abs(rng.standard_normal((B, n))))
         + np.abs(rng.standard_normal((B, m)))).astype(np.float32)
    c = np.abs(rng.standard_normal((B, n))).astype(np.float32)
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device=cuda)
    kw = dict(max_iters=600, eps=1e-5, checki=100)
    eager = batched._solve_batched_eager(DR(), form, **kw)
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph = solve_batched(DR(), form, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(graph.status, eager.status)
    assert torch.equal(graph.iters, eager.iters)
    assert torch.equal(graph.state.s1_state.total_iters,
                       eager.state.s1_state.total_iters)
    assert torch.equal(graph.guess, eager.guess)


@pytest.mark.parametrize("key", ["gapp", "linesearch", "anderson",
                                 "longstep"])
def test_solve_batched_wrapped_routes_agree(cuda, key):
    """GAPP and the wrappers in solve_batched on 16 instances of 32 x 48
    (their extra steps every 20 or 40 iterations: IF nodes on the lanes'
    shared count, the line search's CG over (16, 31) probe lanes): the
    captured fused graph (under sync debug mode "error") and its loops run
    eagerly give equal statuses, iterations and bits; the lane condition
    kernel ran in the graph."""
    from fos_tpu_torch import (DR, GAPP, AndersonWrapper, LineSearchWrapper,
                               LongstepWrapper, build_batched_form, nonneg,
                               solve_batched)
    from fos_tpu_torch.parallel import batched

    alg = {"gapp": GAPP(iproj=20),
           "linesearch": LineSearchWrapper(DR(), lsinterval=20),
           "anderson": AndersonWrapper(DR(), memory=5, adaptive=False),
           "longstep": LongstepWrapper(DR(), longinterval=40,
                                       nsave=4)}[key]
    rng = np.random.default_rng(6)
    B, m, n = 16, 32, 48
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    b = (np.einsum("bmn,bn->bm", A, np.abs(rng.standard_normal((B, n))))
         + np.abs(rng.standard_normal((B, m)))).astype(np.float32)
    c = np.abs(rng.standard_normal((B, n))).astype(np.float32)
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n), device=cuda)
    kw = dict(max_iters=120, eps=1e-5, checki=40)
    eager = batched._solve_batched_eager(alg, form, **kw)
    torch.cuda.set_sync_debug_mode("error")
    _cuda.device_launch_counts(reset=True)
    try:
        graph = solve_batched(alg, form, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _cuda.device_launch_counts(reset=True)["cg_continue_lanes"] > 0
    assert torch.equal(graph.status, eager.status)
    assert torch.equal(graph.iters, eager.iters)
    assert torch.equal(graph.guess, eager.guess)
    assert torch.equal(graph.state.x, eager.state.x)


# K1's derivative rules (DensePairFn): the shapes of the first test, the
# 1000^2 LP's and the tile-counting ones
@pytest.mark.parametrize("M,N", [(1000, 1000), (33, 129), (1, 4000),
                                 (4000, 1), (5000, 300), (300, 5000)])
def test_dense_pair_derivative_rules(cuda, M, N):
    """backward (with and without A's cotangent; one K1 call, one launch of
    each of its kernels, for the vectors' cotangents) and jvp (with and
    without dA) against the plain version under autograd on the card."""
    import torch.autograd.forward_ad as fwAD
    from fos_tpu_torch.linalg.dense_pair import DensePairFn

    A, x1, x2 = _dense(M, N, cuda)
    g = torch.Generator(device="cpu").manual_seed(M + 31 * N)
    gz, dx1, gy, dx2 = (torch.randn(k, generator=g).to(cuda)
                        for k in (N, N, M, M))
    dA = torch.randn(M, N, generator=g).to(cuda)
    for need_A in (False, True):
        Ar = A.detach().requires_grad_(need_A)
        v1, v2 = x1.detach().requires_grad_(), x2.detach().requires_grad_()
        y, z = PaddedDenseOp(Ar).mv_pair(v1, v2)
        assert type(y.grad_fn).__name__ == "DensePairFnBackward"
        ins = (Ar, v1, v2) if need_A else (v1, v2)
        _cuda.device_launch_counts(reset=True)
        got = torch.autograd.grad((y, z), ins, (gy, gz))
        counts = _cuda.device_launch_counts(reset=True)
        assert counts["fused_matvec"] == counts["fused_matvec_sum"] == 1
        want = torch.autograd.grad(fused_matvec_plain(Ar, v1, v2), ins,
                                   (gy, gz))
        _close(got, want)
    for with_dA in (False, True):
        with fwAD.dual_level():
            Ad = fwAD.make_dual(A, dA) if with_dA else A
            y, z = PaddedDenseOp(Ad).mv_pair(fwAD.make_dual(x1, dx1),
                                             fwAD.make_dual(x2, dx2))
            got = (fwAD.unpack_dual(y).tangent, fwAD.unpack_dual(z).tangent)
        want = fused_matvec_plain(A, dx1, dx2)
        if with_dA:
            want = tuple(w + e for w, e in
                         zip(want, fused_matvec_plain(dA, x1, x2)))
        _close(got, want)
    # the Function's forward launches the kernel, never the plain version
    before = _cuda.LAUNCHES["fused_matvec"]
    DensePairFn.apply(A, x1.detach().requires_grad_(), x2,
                      PaddedDenseOp(A)._pair)
    assert _cuda.LAUNCHES["fused_matvec"] == before + 1


def test_diff_solve_envelope_f32_through_k1(cuda):
    """diff_solve on the card in f32 through K1 (pallas=True, DR) with the
    f32 options (fos_tpu_torch/diff.py's note), on a 200x300 LP with a
    known optimum where DR reaches its fixed point (the orthogonal-basis
    construction of fos_tpu_torch/tools/lps.py; the Gaussian-basis one of
    tests/test_diff.py stops short of its optimum at this size: see
    tests/test_torch_diff_conditioning.py): the envelope identities within
    1e-3 (1 + ||x0|| + ||y0||), and K1 launched by the backward."""
    from fos_tpu_torch import DR, diff_solve, nonneg
    from fos_tpu_torch.tools.lps import orthogonal_basis_lp

    m, n = 200, 300
    A, b, c, x0, y0 = orthogonal_basis_lp(np.random.default_rng(0), m, n, 67)
    data = [torch.tensor(t, dtype=torch.float32, device=cuda,
                         requires_grad=True) for t in (A, b, c)]
    x, y, _ = diff_solve(*data, nonneg(m), nonneg(n), alg=DR(), pallas=True,
                         device=cuda, eps=1e-6, max_iters=40000,
                         diff_cg_tol=1e-6, adjoint_tol=1e-6,
                         adjoint_iters=300, adjoint_damping=1e-8)
    _cuda.device_launch_counts(reset=True)
    gA, gb, gc = (g.double().cpu().numpy() for g in torch.autograd.grad(
        torch.dot(data[2], x), data))
    assert _cuda.device_launch_counts(reset=True)["fused_matvec"] > 0
    scale = 1.0 + np.abs(x0).max() + np.abs(y0).max()
    assert np.abs(gc - x0).max() <= 1e-3 * scale
    assert np.abs(gb + y0).max() <= 1e-3 * scale
    assert np.abs(gA - np.outer(y0, x0)).max() <= 1e-3 * scale


# --------------------------------------------------------------- front end
def test_modeled_lasso_through_k1(cuda):
    """A lasso written in the DSL, solved on the card in f32 with
    pallas=True: the dense lowering becomes PaddedDenseOp and K1 runs;
    the objective within 1e-3 (1 + |f*|) of proximal gradient on the host
    in f64 (examples/lasso.py's oracle)."""
    from fos_tpu_torch import (DR, Problem, Variable, minimize, norm1,
                               sum_squares)
    from fos_tpu_torch.examples.lasso import ista

    rng = np.random.default_rng(3)
    m = n = 200
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ (rng.standard_normal(n) * (rng.random(n) < 0.1)) \
        + 0.01 * rng.standard_normal(m)
    lam = 0.1 * float(np.abs(A.T @ b).max())
    x = Variable(n)
    prob = Problem(minimize(0.5 * sum_squares(A @ x - b) + lam * norm1(x)))
    _cuda.device_launch_counts(reset=True)
    sol = prob.solve(alg=DR(), dtype=torch.float32, pallas=True, eps=1e-5,
                     max_iters=20000, verbose=0)
    counts = _cuda.device_launch_counts(reset=True)
    assert sol.x.is_cuda and prob.status == "Optimal"
    assert counts["fused_matvec"] > 0
    assert counts["fused_matvec"] == counts["fused_matvec_sum"]
    xs = x.value
    obj = 0.5 * np.sum((A @ xs - b) ** 2) + lam * np.abs(xs).sum()
    ref = ista(A, b, lam)
    assert abs(obj - ref) <= 1e-3 * (1 + abs(ref))


def test_solve_lp_bit_equal_to_solve(cuda):
    """solve_lp stacks A on the host and builds the form solve builds:
    the same status, iterations and final iterate bits through K1."""
    from fos_tpu_torch import DR, nonneg, solve, solve_lp

    rng = np.random.default_rng(7)
    m, n = 200, 300
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    x0, y0, s0, r0 = _lp_vectors(rng, m, n)
    b, c = A @ x0 + s0, r0 - A.T @ y0
    opts = dict(alg=DR(), eps=1e-5, dtype=torch.float32, pallas=True,
                verbose=0, device=cuda)
    ref = solve(A, b, c, nonneg(m), nonneg(n), **opts)
    got = solve_lp(c, A_ub=A, b_ub=b, **opts)
    assert ref.status == "Optimal"
    assert (got.status, got.iters) == (ref.status, ref.iters)
    assert torch.equal(got.raw_z, ref.raw_z)


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """save_state / load_state of a CUDA state: every leaf back on the card
    in its dtype and bits, and the resumed GAPA solve within 1e-5 (1 + |f|)
    of a straight-through one."""
    from fos_tpu_torch import GAPA, nonneg
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm, populate_solution
    from fos_tpu_torch.solvers import engine
    from fos_tpu_torch.solvers.base import init_solver_state
    from fos_tpu_torch.utils.checkpoint import _leaves, load_state, save_state

    rng = np.random.default_rng(11)
    m, n = 200, 300
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    x0, y0, s0, r0 = _lp_vectors(rng, m, n)
    form = HSDEForm.build(conic_problem(A, A @ x0 + s0, r0 - A.T @ y0,
                                        nonneg(m), nonneg(n), device=cuda),
                          pallas=True)
    alg = GAPA(0.8, 0.9)
    opts = dict(eps=1e-5, checki=100, verbose=0)
    first = engine.run(form, alg, max_iters=300, **opts)
    path = str(tmp_path / "state.npz")
    save_state(path, first.state)
    restored = load_state(path, init_solver_state(
        alg, form.sets, form.initial_value(form.dtype)))
    for got, want in zip(_leaves(restored), _leaves(first.state)):
        assert got.is_cuda and got.dtype == want.dtype
        assert torch.equal(got, want)
    resumed = engine.run(form, alg, resume_state=restored, max_iters=20000,
                         **opts)
    straight = engine.run(form, alg, max_iters=20000, **opts)
    f = [populate_solution(form, r.guess, r.status, r.iters).objval
         for r in (resumed, straight)]
    assert resumed.status == straight.status == 1
    assert abs(f[0] - f[1]) <= 1e-5 * (1 + abs(f[1]))


def test_native_loader_beside_the_kernels(cuda):
    """The native packer builds from fos_tpu_torch/native into build/ beside
    the CUDA library, and its packs are the numpy packs bit for bit."""
    import os

    from fos_tpu_torch import native

    assert native.get() is not None, native.load_error()
    assert native.library_path().parent == _cuda.BUILD_DIR
    A = sp.random(900, 700, density=0.02, format="coo", random_state=7,
                  dtype=np.float32)
    rows, cols = A.row.astype(np.int64), A.col.astype(np.int64)
    got = tse._build_ell_arrays(900, 700, rows, cols, A.data, 128, 128)
    os.environ["FOS_TPU_TORCH_NO_NATIVE"] = "1"
    try:
        want = tse._build_ell_arrays(900, 700, rows, cols, A.data, 128, 128)
        want_ratio = tse.band_span_ratio(A)
    finally:
        del os.environ["FOS_TPU_TORCH_NO_NATIVE"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tse.band_span_ratio(A) == want_ratio


@pytest.fixture(scope="module")
def nccl_mesh(cuda, tmp_path_factory):
    """A world-size-1 NCCL group in this process and its (1, 1) mesh."""
    import torch.distributed as dist

    from fos_tpu_torch.parallel import make_mesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("batch", "model"), device=cuda)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["band", "bell"])
def test_row_sharded_op_nccl_bit_equal(cuda, nccl_mesh, kind):
    """RowShardedOp over a world-size-1 NCCL group: mv, rmv (K4/K5) and
    mv_pair (K2/K3) bit-equal to the unsharded operator, also over 31
    lanes in one call (K2-K5 over lanes), and a sharded form over NCCL
    groups runs the graph route."""
    from fos_tpu_torch import nonneg
    from fos_tpu_torch.parallel import RowShardedOp
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    A = sp.random(1500, 1300, density=0.003, format="csr", random_state=3,
                  dtype=np.float32)
    cls = tse.BandedBlockOp if kind == "band" else tse.BlockedEllOp
    op = cls.create(A, transpose_table=True, device=cuda)
    sh = RowShardedOp.create(op, nccl_mesh, "model")
    g = torch.Generator(device="cpu").manual_seed(5)
    x, y = (torch.randn(k, generator=g).to(cuda) for k in (1300, 1500))
    assert torch.equal(sh.mv(x), op.mv(x))
    assert torch.equal(sh.rmv(y), op.rmv(y))
    for a, b in zip(sh.mv_pair(x, y), op.mv_pair(x, y)):
        assert torch.equal(a, b)
    X, Y = (torch.randn(31, k, generator=g).to(cuda) for k in (1300, 1500))
    _cuda.device_launch_counts(reset=True)
    assert torch.equal(sh.mv(X), op.mv(X))
    assert torch.equal(sh.rmv(Y), op.rmv(Y))
    for a, b in zip(sh.mv_pair(X, Y), op.mv_pair(X, Y)):
        assert torch.equal(a, b)
    counts = _cuda.device_launch_counts(reset=True)
    assert counts[f"{kind}_mv_lanes"] == 4
    assert counts[f"{kind}_mv_pair_lanes"] == 2
    assert counts[f"{kind}_mv"] == counts[f"{kind}_mv_pair"] == 0
    b = torch.ones(1500, device=cuda)
    c = torch.ones(1300, device=cuda)
    form = HSDEForm.build(conic_problem(sh, b, c, nonneg(1500),
                                        nonneg(1300)))
    assert form.route == "graph"


def _certificate_lp(m, n, seed):
    """An LP with an optimal certificate (tests/test_parallel.py's
    recipe), f32 numpy."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    xm = rng.random(n) < 0.5
    x0 = np.abs(rng.standard_normal(n)) * xm
    r0 = np.abs(rng.standard_normal(n)) * ~xm
    ym = rng.random(m) < 0.5
    y0 = np.abs(rng.standard_normal(m)) * ym
    s0 = np.abs(rng.standard_normal(m)) * ~ym
    return tuple(v.astype(np.float32)
                 for v in (A, A @ x0 + s0, r0 - A.T @ y0))


def _sharded_lp_forms(kind, cuda, mesh):
    """(unsharded form, sharded form) of a small LP: a dense A through
    ``shard_problem_rows`` (K1 per shard) or a banded A through
    RowShardedOp (K2 per shard)."""
    from fos_tpu_torch import nonneg
    from fos_tpu_torch.parallel import RowShardedOp, shard_problem_rows
    from fos_tpu_torch.problems.conic import conic_problem
    from fos_tpu_torch.problems.hsde import HSDEForm

    if kind == "dense_rows":
        A, b, c = _certificate_lp(120, 180, 3)
        op = A
    else:
        A = sp.diags([np.ones(1024 - 130) * -0.98, np.ones(1024),
                      np.ones(1024 - 130) * 0.99], offsets=[-130, 0, 130],
                     shape=(1024, 1024), format="csr").astype(np.float32)
        rng = np.random.default_rng(1)
        b = (A @ np.abs(rng.standard_normal(1024))
             + np.abs(rng.standard_normal(1024))).astype(np.float32)
        c = (np.abs(rng.standard_normal(1024)) + 0.1).astype(np.float32)
        op = tse.BandedBlockOp.create(A, device=cuda)
    m, n = A.shape

    def form(a, **kw):
        return HSDEForm.build(conic_problem(a, b, c, nonneg(m), nonneg(n),
                                            device=cuda,
                                            dtype=torch.float32), **kw)

    if kind == "dense_rows":
        plain = form(op, pallas=True)
        return plain, shard_problem_rows(form(op, pallas=True), mesh)
    return form(op), form(RowShardedOp.create(op, mesh, "model"))


@pytest.mark.parametrize("kind", ["dense_rows", "banded_rows"])
def test_sharded_lp_graph_route_bit_equal(cuda, nccl_mesh, kind):
    """A row-sharded dense LP and a RowShardedOp banded LP over the NCCL
    group report the graph route, and ``run`` (its collectives captured in
    the chunks) is bit-equal to the form's eager route and to the unsharded
    solve, in status and iterations too; so is ``fused_solve`` (one
    graph)."""
    from fos_tpu_torch import DR
    from fos_tpu_torch.solvers import engine

    plain, sharded = _sharded_lp_forms(kind, cuda, nccl_mesh)
    assert sharded.route == "graph" and plain.route == "graph"
    opts = dict(max_iters=300, eps=1e-5, checki=100, verbose=0)
    got = engine.run(sharded, DR(), **opts)
    for want in (engine._run_eager(sharded, DR(), **opts),
                 engine.run(plain, DR(), **opts)):
        assert (got.status, got.iters) == (want.status, want.iters)
        assert torch.equal(got.guess, want.guess)
    x0 = sharded.initial_value(sharded.dtype)
    del opts["verbose"]
    fused = engine.fused_solve(DR(), sharded, x0, **opts)
    eager = engine._fused_solve_eager(DR(), sharded, x0, **opts)
    for k in ("status", "iters", "guess"):
        assert torch.equal(getattr(fused, k), getattr(eager, k)), k


def _batch(cuda, B=8, m=16, n=24):
    from fos_tpu_torch import build_batched_form, nonneg

    A, b, c = zip(*(_certificate_lp(m, n, 10 + i) for i in range(B)))
    return build_batched_form(np.stack(A), np.stack(b), np.stack(c),
                              nonneg(m), nonneg(n), device=cuda)


def test_split_batch_fused_graph_equals_eager(cuda, nccl_mesh):
    """``fused_solve`` on a batch split over the NCCL group's batch axis
    (the vote captured in the chunk loop's condition): the graph route
    bit-equal to its eager plain version and to the unsharded batch."""
    from fos_tpu_torch import DR
    from fos_tpu_torch.parallel import shard_batched_form
    from fos_tpu_torch.parallel.batched import _start
    from fos_tpu_torch.solvers import engine

    form = _batch(cuda)
    split = shard_batched_form(form, nccl_mesh)
    assert split.route == "graph"
    opts = dict(max_iters=300, eps=1e-5, checki=50)
    x0 = _start(split, None)
    got = engine.fused_solve(DR(), split, x0, **opts)
    for want in (engine._fused_solve_eager(DR(), split, x0, **opts),
                 engine.fused_solve(DR(), form, x0, **opts)):
        for k in ("status", "iters", "guess"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_hybrid_linesearch_graph_bit_equal(cuda, nccl_mesh):
    """LineSearch(DR) with CG on ``shard_batched_form_rows`` (the probes
    (B, 31, k) through the row-sharded batched operator) on the graph
    route: bit-equal to the unsharded batched line search and to its own
    eager route."""
    from fos_tpu_torch import DR, LineSearchWrapper, solve_batched
    from fos_tpu_torch.parallel import shard_batched_form_rows
    from fos_tpu_torch.parallel.batched import _solve_batched_eager

    form = _batch(cuda)
    hybrid = shard_batched_form_rows(form, nccl_mesh)
    assert hybrid.route == "graph"
    alg = LineSearchWrapper(DR(), lsinterval=20)
    opts = dict(max_iters=100, eps=1e-4, checki=50)
    got = solve_batched(alg, hybrid, **opts)
    for want in (solve_batched(alg, form, **opts),
                 _solve_batched_eager(alg, hybrid, **opts)):
        for k in ("status", "iters", "guess"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k


_CAPTURE_FAILURE = """
import json, sys
import torch
import torch.distributed as dist
from fos_tpu_torch import DR
from fos_tpu_torch.parallel import make_mesh
from fos_tpu_torch.solvers import engine
from test_torch_cuda import _sharded_lp_forms

dist.init_process_group("nccl", store=dist.FileStore(sys.argv[1], 1),
                        rank=0, world_size=1)
cuda = torch.device("cuda", 0)
_, sharded = _sharded_lp_forms("banded_rows", cuda,
                               make_mesh((1, 1), device=cuda))
op, calls = sharded.A, []
pair = op.mv_pair

def reading(x, z):
    capturing = torch.cuda.is_current_stream_capturing()
    calls.append(capturing)
    if capturing:
        float(x.sum())   # a host read: the capture fails here
    return pair(x, z)

op.mv_pair = reading
try:
    engine.run(sharded, DR(), max_iters=200, eps=1e-5, checki=100,
               verbose=0)
    raised = None
except RuntimeError as e:
    raised = str(e)[:300]
print(json.dumps({"route": sharded.route, "raised": raised,
                  "calls": calls}), flush=True)
"""


def test_sharded_capture_failure_raises(cuda, tmp_path):
    """A sharded NCCL form whose capture fails (a host read inside the
    captured chunk) raises from ``run``, and nothing runs after the failed
    capture, so nothing fell back to the eager route.  In a process of its
    own with a group of its own: a failed capture is not left behind in
    this one."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _CAPTURE_FAILURE,
                          str(tmp_path / "store")], capture_output=True,
                         text=True, env=env, timeout=600)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert lines, (res.returncode, res.stdout[-2000:], res.stderr[-2000:])
    got = json.loads(lines[-1])
    calls = got["calls"]
    assert got["route"] == "graph" and got["raised"], got
    assert calls and calls[-1] and calls.count(True) == 1, got


# ---------------------------------------------------------------- C1, C2
# CG's step kernel (C1) and q_mul's rank-1 epilogue (C2), csrc/cg_step.cu,
# against their plain versions (cg.step_plain, hsde_ops.q_rank1_plain) on
# the same CUDA tensors.  Tolerance: f32 as the file's (2e-4 + 2e-5 |plain|,
# sums in another order; for C2's dot, 2e-5 of the sum of its terms'
# magnitudes); f64 1e-9 + 1e-9 of the same.  k covers one block
# (1, 161, 2001), a cluster (12345, 65537) and the split launches
# (300001 > 2^18).
CG_KS = [1, 161, 2001, 12345, 65537, 300001]
# C2's (n, m): n + m + 1 = k
RANK1_NM = {1: (0, 0), 161: (96, 64), 2001: (1000, 1000),
            12345: (6000, 6344), 65537: (32768, 32768),
            300001: (150000, 150000)}


def _tol(dtype):
    return (ATOL, RTOL) if dtype == torch.float32 else (1e-9, 1e-9)


def _close_d(got, want, dtype, scales=None):
    """|got - want| <= atol + rtol * scale, the scale |want| unless given
    (per output)."""
    atol, rtol = _tol(dtype)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        d = (g.double() - w.double()).abs()
        scale = w.double().abs() if scales is None else scales[i]
        assert bool((d <= atol + rtol * scale).all()), float(d.max())


def _rank1_scale(want, z, b, c):
    """C2's tolerance scale: |plain|, and for the dot -[c; b] . z[:n+m] the
    sum of its terms' magnitudes (a cancelling dot's rounding scales with
    it, not with its value)."""
    scale = want.double().abs()
    cb = torch.cat([c, b], -1)
    K = cb.shape[-1]
    scale[..., -1] = (lanes_lead(cb, z).double().abs()
                      * z[..., :K].double().abs()).sum(-1)
    return [scale]


def lanes_lead(t, like):
    from fos_tpu_torch.linalg import lanes

    return lanes.lead(t, like)


def _randn(rng, shape, dtype, cuda):
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                           device=cuda)


def _step_inputs(shape, dtype, cuda, seed, tracked=True, it_hi=3):
    """x, r, p, rn, it, tol2 and the products w, Qx, Qp for lanes
    ``shape[:-1]``; rn is r.r (the loop's invariant), it below it_hi.  w is
    the product of a positive diagonal (negated for the tracked step's p -
    w), so that Ap is an SPD operator's product, as CG's are, and den = Ap.p
    sums positive terms: with a random w, den cancels and two f32 sum
    orders part by ~2e-5 of it at k = 65537."""
    rng = np.random.default_rng(seed)
    x, r, p, Qx, Qp = (_randn(rng, shape, dtype, cuda) for _ in range(5))
    d = torch.as_tensor(rng.uniform(0.0, 2.0, shape), dtype=dtype,
                        device=cuda)
    w = (-d if tracked else d) * p
    lanes = tuple(shape[:-1])
    rn = (r.double() * r.double()).sum(-1).to(dtype)
    it = torch.as_tensor(rng.integers(0, it_hi, lanes), dtype=torch.int32,
                         device=cuda)
    tol2 = (torch.full((), 1e-3, dtype=dtype, device=cuda) if not lanes else
            torch.as_tensor(rng.uniform(0, 1e-3, lanes), dtype=dtype,
                            device=cuda))
    return dict(x=x, r=r, p=p, rn=rn, it=it, tol2=tol2, w=w,
                Qx=Qx if tracked else None, Qp=Qp if tracked else None)


def _run_step(inp, mode, max_iters=100, group=None):
    """C1 on copies of the state (one step, ``first``): the new state."""
    from fos_tpu_torch.linalg import cg_step

    st = {k: (None if inp[k] is None else inp[k].clone())
          for k in ("x", "Qx", "r", "p", "rn", "it")}
    step = cg_step.CGStep(st["x"], st["r"], st["p"], st["rn"], st["it"],
                          inp["tol2"], max_iters, Qx=st["Qx"], mode=mode,
                          group=group)
    step(inp["w"], inp["Qp"], first=True)
    return tuple(st[k] for k in ("x", "Qx", "r", "p", "rn", "it")), step


def _plain_step(inp, mode, max_iters=100):
    from fos_tpu_torch.linalg.cg import step_plain

    go = (None if inp["rn"].dim() == 0 else
          (inp["rn"] > inp["tol2"]) & (inp["it"] < max_iters))
    return step_plain(inp["x"], inp["r"], inp["p"], inp["rn"], inp["it"],
                      inp["tol2"], inp["w"], mode, inp["Qx"], inp["Qp"], go)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", CG_KS)
def test_cg_step_matches_plain(cuda, k, dtype):
    """C1 at each geometry, tracked (p - Q(Qp), Qx) and standard (w, p +
    w), against the plain step; the iteration counts exact, the bits
    repeating, one launch a step (three more with the split sums past
    2^18, counted on the device)."""
    from fos_tpu_torch.linalg import cg_step

    for mode, tracked in ((cg_step.P_MINUS_W, True), (cg_step.AP_IS_W, False),
                          (cg_step.P_PLUS_W, False)):
        inp = _step_inputs((k,), dtype, cuda, k + mode, tracked)
        _cuda.device_launch_counts(reset=True)
        got, _ = _run_step(inp, mode)
        counts = _cuda.device_launch_counts(reset=True)
        split = cg_step.geometry(k)["kind"] == cg_step.MULTI
        assert counts["cg_step"] == (3 if split else 1)
        assert counts["cg_step_sum"] == (2 if split else 0)
        want = _plain_step(inp, mode)
        _close_d(got, want, dtype)
        assert torch.equal(got[5], want[5])
        again, _ = _run_step(inp, mode)
        assert all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(again, got))


@pytest.mark.parametrize("lanes", [(1,), (2,), (31,), (128,), (1024,),
                                   (128, 31)])
def test_cg_step_lanes_bit_equal_to_single(cuda, lanes):
    """C1 over lanes: one launch for all of them, each lane bit-equal to a
    single-system call on its vectors (and to the plain step within the
    tolerance); at 31 lanes also the dense LP's and the tile LPs' k."""
    from fos_tpu_torch.linalg import cg_step

    ks = [161] + ([2001, 65537] if lanes == (31,) else [])
    for k in ks:
        inp = _step_inputs(lanes + (k,), torch.float32, cuda, 7 * k, it_hi=1)
        _cuda.device_launch_counts(reset=True)
        got, _ = _run_step(inp, cg_step.P_MINUS_W)
        assert _cuda.device_launch_counts(reset=True)["cg_step"] == 1
        _close_d(got, _plain_step(inp, cg_step.P_MINUS_W), torch.float32)
        flat = [t.reshape(-1, k) if t.dim() == len(lanes) + 1 else
                t.reshape(-1) for t in got]
        L = flat[0].shape[0]
        for b in sorted({0, L // 2, L - 1}):
            one = {key: (v if key == "tol2" and v.dim() == 0 else
                         v.reshape(L, *v.shape[len(lanes):])[b])
                   for key, v in inp.items() if v is not None}
            one.setdefault("Qx", None)
            one.setdefault("Qp", None)
            single, _ = _run_step(one, cg_step.P_MINUS_W)
            for a, s in zip(flat, single):
                assert torch.equal(a[b], s)


def test_cg_step_frozen_lanes_untouched(cuda):
    """Lanes that fail the group's test (it at max_iters, or rn <= tol2)
    keep every carried tensor's bits, also in a later step of the group
    (first=False), and their next flag is false."""
    from fos_tpu_torch.linalg import cg_step

    inp = _step_inputs((64, 2001), torch.float32, cuda, 3, it_hi=1)
    max_iters = 5
    inp["it"][::3] = max_iters
    inp["rn"][1::5] = 0.0
    st = {k: inp[k].clone() for k in ("x", "Qx", "r", "p", "rn", "it")}
    step = cg_step.CGStep(st["x"], st["r"], st["p"], st["rn"], st["it"],
                          inp["tol2"], max_iters, Qx=st["Qx"],
                          mode=cg_step.P_MINUS_W)
    frozen = ~((inp["rn"] > inp["tol2"]) & (inp["it"] < max_iters))
    for first in (True, False):
        step(inp["w"], inp["Qp"], first=first)
    for key in ("x", "Qx", "r", "p", "rn", "it"):
        assert torch.equal(st[key][frozen], inp[key][frozen]), key
        assert not torch.equal(st[key][~frozen], inp[key][~frozen]) or (
            key == "it"), key
    assert not bool(step.next[frozen].any())


def test_cg_step_strided_lane_views(cuda):
    """The state and the products as views into wider rows (z[..., :l]):
    read and written in place at their lane strides, bit-equal to the same
    step on contiguous copies; a view whose lanes do not flatten raises."""
    from fos_tpu_torch.linalg import cg_step

    rng = np.random.default_rng(11)
    L, k = 31, 2001
    wide = {key: _randn(rng, (L, 2 * k + 3), torch.float32, cuda)
            for key in ("x", "Qx", "r", "p", "w", "Qp")}
    views = {key: v[:, 1: k + 1] for key, v in wide.items()}
    rn = (views["r"] * views["r"]).sum(-1)
    it = torch.zeros(L, dtype=torch.int32, device=cuda)
    tol2 = torch.full((), 1e-3, device=cuda)
    inp = dict(views, rn=rn, it=it, tol2=tol2)
    want, _ = _run_step({k2: (v.contiguous() if v.dim() == 2 else v)
                         for k2, v in inp.items()}, cg_step.P_MINUS_W)
    before = wide["x"].clone()
    st = dict(views, rn=rn.clone(), it=it.clone())
    step = cg_step.CGStep(st["x"], st["r"], st["p"], st["rn"], st["it"],
                          tol2, 100, Qx=st["Qx"], mode=cg_step.P_MINUS_W)
    step(views["w"], views["Qp"], first=True)
    for key, w in zip(("x", "Qx", "r", "p", "rn", "it"), want):
        assert torch.equal(st[key], w), key
    # the wide rows' other columns are untouched
    assert torch.equal(wide["x"][:, 0], before[:, 0])
    assert torch.equal(wide["x"][:, k + 1:], before[:, k + 1:])
    bad = _randn(rng, (4, 5, k), torch.float32, cuda).transpose(0, 1)
    with pytest.raises(ValueError):
        cg_step.CGStep(bad, bad.clone(), bad.clone(),
                       torch.ones(5, 4, device=cuda),
                       torch.zeros(5, 4, dtype=torch.int32, device=cuda),
                       tol2, 10)


def test_cg_step_and_rank1_raise(cuda):
    """On CUDA tensors C1 and C2 launch or raise: an operand that needs a
    gradient, f16, one on another device, a row that is not contiguous."""
    from fos_tpu_torch.linalg import cg_step

    inp = _step_inputs((161,), torch.float32, cuda, 1)
    _, step = _run_step(inp, cg_step.P_MINUS_W)
    with pytest.raises(ValueError, match="requires grad"):
        step(inp["w"].clone().requires_grad_(), inp["Qp"])
    with pytest.raises(TypeError):
        step(inp["w"].double(), inp["Qp"])
    with pytest.raises(ValueError, match="is on"):
        step(inp["w"].cpu(), inp["Qp"])
    h = {k: (v.half() if v is not None and v.is_floating_point() else v)
         for k, v in inp.items()}
    with pytest.raises(TypeError):
        cg_step.CGStep(h["x"], h["r"], h["p"], h["rn"], h["it"], h["tol2"],
                       10)
    rng = np.random.default_rng(2)
    n, m = 96, 64
    z = _randn(rng, (n + m + 1,), torch.float32, cuda)
    az, atz = _randn(rng, (m,), torch.float32, cuda), _randn(
        rng, (n,), torch.float32, cuda)
    b, c = _randn(rng, (m,), torch.float32, cuda), _randn(
        rng, (n,), torch.float32, cuda)
    with pytest.raises(ValueError, match="requires grad"):
        cg_step.q_rank1(az.requires_grad_(), atz, z, b, c)
    with torch.no_grad():   # no graph recorded: a leaf's values are taken
        cg_step.q_rank1(az, atz, z, b, c)
    with pytest.raises(TypeError):
        cg_step.q_rank1(*(t.half() for t in (az.detach(), atz, z, b, c)))
    with pytest.raises(ValueError, match="is on"):
        cg_step.q_rank1(az.detach(), atz.cpu(), z, b, c)
    strided = _randn(rng, (2 * n,), torch.float32, cuda)[::2]
    with pytest.raises(ValueError, match="not contiguous"):
        cg_step.q_rank1(az.detach(), strided, z, b, c)


def _rank1_inputs(lanes, inst, n, m, dtype, cuda, seed):
    rng = np.random.default_rng(seed)
    z = _randn(rng, lanes + (n + m + 1,), dtype, cuda)
    az = _randn(rng, lanes + (m,), dtype, cuda)
    atz = _randn(rng, lanes + (n,), dtype, cuda)
    b = _randn(rng, inst + (m,), dtype, cuda)
    c = _randn(rng, inst + (n,), dtype, cuda)
    return az, atz, z, b, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", CG_KS)
def test_q_rank1_matches_plain(cuda, k, dtype):
    """C2 at each geometry against q_mul's plain epilogue; bits repeat; one
    launch (and one dependent sum past 2^18)."""
    from fos_tpu_torch.linalg import cg_step, hsde_ops

    n, m = RANK1_NM[k]
    args = _rank1_inputs((), (), n, m, dtype, cuda, k)
    _cuda.device_launch_counts(reset=True)
    got = cg_step.q_rank1(*args)
    counts = _cuda.device_launch_counts(reset=True)
    split = cg_step.geometry(n + m)["kind"] == cg_step.MULTI
    assert counts["q_rank1"] == 1
    assert counts["q_rank1_sum"] == (1 if split else 0)
    want = hsde_ops.q_rank1_plain(*args)
    _close_d([got], [want], dtype, _rank1_scale(want, *args[2:]))
    assert torch.equal(cg_step.q_rank1(*args), got)


@pytest.mark.parametrize("lanes,inst", [((1,), ()), ((2,), (2,)),
                                        ((31,), ()), ((128,), (128,)),
                                        ((1024,), (1024,)),
                                        ((128, 31), (128,))])
def test_q_rank1_lanes_bit_equal_to_single(cuda, lanes, inst):
    """C2 over lanes, instance data shared or one row per instance (the
    batched line search's (B, P) candidates against (B,) instances): one
    launch, each lane bit-equal to a single call with its instance's
    data, and within the tolerance of the plain epilogue."""
    from fos_tpu_torch.linalg import cg_step, hsde_ops

    n, m = 96, 64
    az, atz, z, b, c = _rank1_inputs(lanes, inst, n, m, torch.float32,
                                     cuda, len(lanes) * 100 + lanes[0])
    _cuda.device_launch_counts(reset=True)
    got = cg_step.q_rank1(az, atz, z, b, c)
    assert _cuda.device_launch_counts(reset=True)["q_rank1"] == 1
    want = hsde_ops.q_rank1_plain(az, atz, z, b, c)
    _close_d([got], [want], torch.float32, _rank1_scale(want, z, b, c))
    L = got[..., 0].numel()
    per = L // max(1, b[..., 0].numel())
    flat = got.reshape(L, -1)
    for j in sorted({0, L // 2, L - 1}):
        d = j // per
        data = [t if not inst else t.reshape(-1, t.shape[-1])[d]
                for t in (b, c)]
        one = cg_step.q_rank1(az.reshape(L, m)[j], atz.reshape(L, n)[j],
                              z.reshape(L, -1)[j], *data)
        assert torch.equal(flat[j], one)


def test_q_rank1_strided_views(cuda):
    """z and the products as rows of wider tensors (the state's slices):
    bit-equal to contiguous copies."""
    from fos_tpu_torch.linalg import cg_step

    n, m, L = 1000, 1000, 31
    az, atz, z, b, c = _rank1_inputs((L,), (), n, m, torch.float32, cuda, 5)
    wide = torch.cat([z, z], -1)
    got = cg_step.q_rank1(az, atz, wide[:, : n + m + 1], b, c)
    assert torch.equal(got, cg_step.q_rank1(az, atz, z, b, c))


def test_q_rank1_derivative_rules(cuda):
    """QRank1Fn (C2 under autograd) against numerical derivatives, reverse
    and forward mode, in f64 on the card, with per-instance data and
    lanes."""
    from fos_tpu_torch.linalg import cg_step

    args = _rank1_inputs((3, 2), (3,), 5, 4, torch.float64, cuda, 9)
    args = tuple(t.detach().requires_grad_() for t in args)
    assert torch.autograd.gradcheck(cg_step.rank1, args,
                                    check_forward_ad=True)


@pytest.mark.parametrize("k", [2001, 65537, 300001])
def test_cg_step_split_bit_equal_at_world_size_1(cuda, nccl_mesh, k):
    """With a process group the step runs split at its two reductions, an
    all-reduce between the launches: over a world-size-1 NCCL group, bit-
    equal to the fused launch, over lanes too."""
    import torch.distributed as dist

    from fos_tpu_torch.linalg import cg_step

    for shape in ((k,), (3, k)):
        inp = _step_inputs(shape, torch.float32, cuda, k, it_hi=1)
        fused, _ = _run_step(inp, cg_step.P_MINUS_W)
        split, _ = _run_step(inp, cg_step.P_MINUS_W, group=dist.group.WORLD)
        assert all(torch.equal(a, b) for a, b in zip(fused, split))


def test_cg_solves_through_c1_c2(cuda):
    """Tracked and standard CG on the card (one system, lanes, nested
    lanes) through C1 and C2: against the CPU's plain route in f64, each
    lane's iteration count within one (at the tolerance, the card's sum
    order can take one more or one fewer step) and its solution within
    1e-8."""
    from fos_tpu_torch.linalg import hsde_ops
    from fos_tpu_torch.linalg.cg import (PlusProduct, conjugate_gradient,
                                         conjugate_gradient_tracked)

    rng = np.random.default_rng(4)
    m, n = 40, 60
    A = rng.standard_normal((m, n))
    b, c = rng.standard_normal(m), rng.standard_normal(n)
    l = m + n + 1
    for lanes in ((), (5,), (2, 3)):
        r0 = rng.standard_normal(lanes + (l,))
        outs = {}
        for on_card in (False, True):
            dev = cuda if on_card else torch.device("cpu")
            t = lambda v: torch.as_tensor(v, device=dev)  # noqa: E731
            At, bt, ct = t(A), t(b), t(c)
            q = lambda v: hsde_ops.q_mul(At, bt, ct, v)  # noqa: E731
            x0 = torch.zeros(l, dtype=torch.float64, device=dev)
            if on_card:
                _cuda.device_launch_counts(reset=True)
            res = conjugate_gradient_tracked(q, t(r0), x0, x0, tol=1e-9,
                                             max_iters=200, unroll=2)
            std = conjugate_gradient(PlusProduct(
                lambda v: q(q(v)), -1), t(r0), x0, tol=1e-9, max_iters=200)
            if on_card:
                counts = _cuda.device_launch_counts(reset=True)
                assert counts["cg_step"] > 0 and counts["q_rank1"] > 0
            outs[on_card] = (res, std)
        for want, got in zip(outs[False], outs[True]):
            assert int((want.iters - got.iters.cpu()).abs().max()) <= 1
            np.testing.assert_allclose(got.x.cpu().numpy(), want.x.numpy(),
                                       rtol=1e-8, atol=1e-8)
            # a converged residual norm is rounding (both below tol)
            assert bool((got.rnorm <= 1e-9).all())
            assert bool((want.rnorm <= 1e-9).all())
