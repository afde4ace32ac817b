"""Sharded solves over ``torch.distributed``: one large problem across ranks,
or a batch of instances split across them.

The port of ``fos_tpu.parallel.sharding`` and of ``RowShardedOp``
(``fos_tpu/linalg/sparse_ell.py:828``).  In the JAX package GSPMD placed
the data on a ``jax.sharding.Mesh`` and inserted the collectives; here the
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the same
axis names, each rank holds its block of A in an operator, and the
operator makes the collectives itself:

* :class:`RowShardedOp`: a tile table's block rows split over a mesh axis
  (or a tuple of axes, outer-major); ``mv``/``rmv`` run K4/K5 on the local
  table and all-gather y, ``mv_pair`` runs K2/K3 and all-gathers y1 and
  all-reduces the partial A'z;
* :class:`DenseRowShardedOp` (:func:`shard_problem_rows`): a dense A's rows
  over ``model``, the local block's pair through K1 (one pass over it),
  then y1 gathered and y2 all-reduced;
* :class:`Dense2DShardedOp` (:func:`shard_problem_2d`): A in (r, c) blocks,
  y1 all-reduced over the column axis then gathered over the row axis, y2
  the converse;
* :func:`shard_batched_form` / :func:`shard_batched_form_rows`: each rank
  solves its instances (and with ``rows``, its rows of each instance's A),
  votes once per check on whether any instance continues, and
  :func:`fos_tpu_torch.parallel.batched.solve_batched` returns the whole
  batch on every rank.

The iterate, b, c and the scaling vectors stay replicated: every rank runs
the same solver steps on the same data, and the reductions give every rank
the same bits (a ring all-reduce hands each rank the same sums), so the
ranks take the same branches.  A sharded form runs the eager route on the
card, a choice made by its operator's type (:attr:`sharded`): the
collectives are host calls there, not captured into the solver's graphs.

The process group comes from ``torchrun``'s environment or from a default
group the caller initialised; the mesh uses NCCL on the card and gloo on
the CPU (``device="cpu"``).  Nothing falls back to a single process.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from fos_tpu_torch.config import as_tensor, default_device
from fos_tpu_torch.linalg import control
from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp

# ------------------------------------------------------------------ meshes


def make_mesh(shape: Sequence[int] = None,
              names: Sequence[str] = ("batch", "model"), device=None):
    """A device mesh over every rank of the default group, shaped ``shape``
    (default ``(world size, 1)``) with axis ``names``; on the card unless
    ``device="cpu"``.  Without an initialised group or ``torchrun``'s
    environment it raises."""
    from torch.distributed.device_mesh import init_device_mesh

    device = default_device(device)
    world = _world_size()
    if shape is None:
        shape = (world, 1)
    return init_device_mesh(device.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_hybrid_mesh(outer: int, inner: int,
                     names: Sequence[str] = ("batch", "model"), device=None):
    """A two-level mesh: the ``outer`` axis for the data-parallel batch (it
    communicates only at the termination vote), the ``inner`` axis for the
    rows of A (a collective per product).  Ranks are laid out inner-minor,
    so one host's ranks share an inner group under ``torchrun``."""
    world = _world_size()
    if outer * inner != world:
        raise ValueError(f"mesh {outer}x{inner} != {world} devices")
    return make_mesh((outer, inner), names, device)


def _world_size() -> int:
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "no process group: launch with torchrun or call "
                "torch.distributed.init_process_group first")
        return int(os.environ["WORLD_SIZE"])
    return dist.get_world_size()


class _Axes:
    """The process groups of a tuple of mesh axes (outer first), this
    rank's shard index over their product and the product's group."""

    def __init__(self, mesh, axis):
        self.names = (axis,) if isinstance(axis, str) else tuple(axis)
        dims = [mesh.mesh_dim_names.index(a) for a in self.names]
        self.groups = [mesh.get_group(a) for a in self.names]
        self.sizes = [mesh.mesh.shape[d] for d in dims]
        self.size = math.prod(self.sizes)
        self.index = 0
        for a, s in zip(self.names, self.sizes):
            self.index = self.index * s + mesh.get_local_rank(a)
        self.product = (self.groups[0] if len(dims) == 1
                        else _product_group(mesh, dims))


def _product_group(mesh, dims):
    """The group of the ranks that share every mesh coordinate outside
    ``dims`` (every rank makes each such group, in the same order)."""
    cache = mesh.__dict__.setdefault("_fos_product_groups", {})
    key = tuple(dims)
    if key not in cache:
        rest = [d for d in range(mesh.mesh.dim()) if d not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(mesh.mesh.shape[d] for d in dims)).tolist()
        me = dist.get_rank()
        for row in rows:
            g = (dist.group.WORLD if len(row) == dist.get_world_size()
                 else dist.new_group(row))
            if me in row:
                cache[key] = g
    return cache[key]


def gather(t, groups, dim=-1):
    """``t``'s shards concatenated along ``dim`` over ``groups`` (one
    all-gather per group, the innermost axis first, so that an outer-major
    shard order comes back in order)."""
    for g in reversed(groups):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, t.contiguous(), group=g)
        t = torch.cat(parts, dim)
    return t


def all_reduce(t, group):
    """``t`` summed over ``group`` (one all-reduce, in place)."""
    dist.all_reduce(t, group=group)
    return t


def _rows(v, k, per, dim=-1):
    """Rows ``[k per, (k + 1) per)`` of ``v`` along ``dim``, zero-padded to
    ``per`` rows where ``v`` ends first."""
    size = v.shape[dim]
    lo, hi = min(k * per, size), min((k + 1) * per, size)
    out = v.narrow(dim, lo, hi - lo)
    if hi - lo < per:
        shape = list(v.shape)
        shape[dim] = per - (hi - lo)
        out = torch.cat([out, v.new_zeros(shape)], dim)
    return out


# ------------------------------------------------------------ tile tables
class RowShardedOp:
    """A :class:`BandedBlockOp` / :class:`BlockedEllOp` whose tile tables
    are split by block rows over the mesh axis ``axis`` (a name, or a tuple
    of names outer first, e.g. ``("dcn", "ici")``): each rank holds its
    block rows of the A table and, when the operator has one, of the A'
    table, as an operator of the same class with its own inverse table.
    Block rows are zero-padded to a multiple of the shard count (padded
    tiles have index 0 and zero values).  x and z stay replicated.

    * ``mv`` / ``rmv``: K4/K5 on the local A / A' table, then one
      all-gather of y per axis (the inner axis first);
    * ``mv_pair``: K2/K3 on the local A table (the local rows of z), then
      the gathers of y1 and one all-reduce of the partial A'z over every
      axis of ``axis``.
    """

    #: its collectives run on the host: solves run the eager route
    sharded = True

    def __init__(self, local, local_t, m, n, axes: _Axes):
        self.local = local        # this rank's block rows of A
        self.local_t = local_t    # ... of A' (None without an A' table)
        self.m, self.n = m, n
        self.axes = axes

    @classmethod
    def create(cls, op, mesh, axis="model"):
        """Keep this rank's block rows of ``op``'s tables (``op`` itself is
        not kept: the caller may free it)."""
        axes = _Axes(mesh, axis)

        def shard(blocks, index, counts, n):
            per = -(-blocks.shape[0] // axes.size)
            kw = {} if counts is None else {
                "counts": _rows(counts, axes.index, per, dim=0)}
            return type(op).from_arrays(
                _rows(blocks, axes.index, per, dim=0),
                _rows(index, axes.index, per, dim=0), per * op.bm, n,
                device=op.device, **kw)

        index = op.cs if op.kind == "band" else op.cols
        local = shard(op.blocks, index, getattr(op, "counts", None), op.n)
        t = op.transposed()
        local_t = None if t is None else shard(*t, op.m)
        return cls(local, local_t, op.m, op.n, axes)

    axis = property(lambda self: self.axes.names)
    shape = property(lambda self: (self.m, self.n))
    dtype = property(lambda self: self.local.dtype)
    device = property(lambda self: self.local.device)

    def mv(self, x):
        return gather(self.local.mv(x), self.axes.groups)[: self.m]

    def rmv(self, y):
        if self.local_t is None:
            raise self.local._no_transpose_table()
        return gather(self.local_t.mv(y), self.axes.groups)[: self.n]

    def mv_pair(self, x, z):
        y1, y2 = self.local.mv_pair(
            x, _rows(z, self.axes.index, self.local.m))
        return (gather(y1, self.axes.groups)[: self.m],
                all_reduce(y2, self.axes.product))

    def todense(self):
        """The whole A on every rank (one all-gather per axis: a test
        oracle, or a direct form's host factor)."""
        return gather(self.local.todense(), self.axes.groups, dim=0)[: self.m]


# ------------------------------------------------------------------ dense
def _dense(A):
    if hasattr(A, "todense"):
        A = A.todense()
    if not isinstance(A, torch.Tensor) or A.layout != torch.strided:
        raise ValueError(
            f"row sharding supports dense A only (got {type(A).__name__}); "
            "for sparse data wrap a BlockedEllOp/BandedBlockOp in "
            "RowShardedOp (tile tables sharded, the local kernels per rank)")
    return A


class DenseRowShardedOp:
    """A dense A whose rows are split over one mesh axis: each rank holds
    rows ``[k p, (k + 1) p)`` of A zero-padded to a multiple of the axis
    size.  ``mv_pair`` runs the local block's pair (K1), gathers y1 and
    all-reduces the partial A'z: one all-gather and one all-reduce."""

    sharded = True

    def __init__(self, block, m, n, axes: _Axes):
        self.block = PaddedDenseOp.create(block)   # K1 on the card
        self.m, self.n = m, n
        self.axes = axes

    @classmethod
    def create(cls, A, mesh, axis="model"):
        A = _dense(A)
        axes = _Axes(mesh, axis)
        m, n = A.shape
        block = _rows(A, axes.index, -(-m // axes.size), dim=0)
        return cls(block.contiguous(), m, n, axes)

    shape = property(lambda self: (self.m, self.n))
    dtype = property(lambda self: self.block.dtype)
    device = property(lambda self: self.block.device)

    def mv_pair(self, x, z):
        y1, y2 = self.block.mv_pair(x, _rows(z, self.axes.index,
                                             self.block.m))
        return (gather(y1, self.axes.groups)[: self.m],
                all_reduce(y2, self.axes.product))

    def todense(self):
        """The whole A on every rank (one all-gather; a direct form's host
        factor needs it)."""
        return gather(self.block.A, self.axes.groups, dim=0)[: self.m]


class Dense2DShardedOp:
    """A dense A in ``(R, C)`` blocks over the mesh axes ``(r, c)``: each
    rank holds block ``(i, j)`` of A zero-padded to multiples of R and C.
    ``mv_pair`` runs the block's pair (K1) on x's j-th and z's i-th slice,
    then all-reduces y1 over ``c`` and gathers it over ``r``, and
    all-reduces y2 over ``r`` and gathers it over ``c``."""

    sharded = True

    def __init__(self, block, m, n, row: _Axes, col: _Axes):
        self.block = PaddedDenseOp.create(block)   # K1 on the card
        self.m, self.n = m, n
        self.row, self.col = row, col

    @classmethod
    def create(cls, A, mesh, axes=("model_r", "model_c")):
        A = _dense(A)
        row, col = _Axes(mesh, axes[0]), _Axes(mesh, axes[1])
        m, n = A.shape
        block = _rows(_rows(A, row.index, -(-m // row.size), dim=0),
                      col.index, -(-n // col.size), dim=1)
        return cls(block.contiguous(), m, n, row, col)

    shape = property(lambda self: (self.m, self.n))
    dtype = property(lambda self: self.block.dtype)
    device = property(lambda self: self.block.device)

    def mv_pair(self, x, z):
        y1, y2 = self.block.mv_pair(_rows(x, self.col.index, self.block.n),
                                    _rows(z, self.row.index, self.block.m))
        y1 = gather(all_reduce(y1, self.col.product), self.row.groups)
        y2 = gather(all_reduce(y2, self.row.product), self.col.groups)
        return y1[: self.m], y2[: self.n]

    def todense(self):
        """The whole A on every rank (a gather over each axis; a direct
        form's host factor needs it)."""
        full = gather(gather(self.block.A, self.col.groups, dim=1),
                      self.row.groups, dim=0)
        return full[: self.m, : self.n]


def shard_problem_rows(form, mesh, axis: str = "model"):
    """Row-block shard one large problem's built form: A by rows over
    ``axis`` (:class:`DenseRowShardedOp`); b, c, the scaling vectors and the
    iterate stay replicated.  The placement keys on the form's named
    fields, so square problems (m == n) work."""
    return form.with_operator(DenseRowShardedOp.create(form.A, mesh, axis))


def shard_problem_2d(A, b, c, mesh, axes=("model_r", "model_c"),
                     device=None):
    """2D block-shard one large problem's data BEFORE the form is built:
    returns ``(op, b, c)`` with ``op`` a :class:`Dense2DShardedOp` over the
    mesh axes ``(r, c)`` and b, c replicated tensors on the mesh's device;
    pass them to ``conic_problem`` / ``HSDEForm.build`` as usual."""
    device = default_device("cpu" if mesh.device_type == "cpu" else device)
    A = as_tensor(A, device=device)
    return (Dense2DShardedOp.create(A, mesh, axes),
            as_tensor(b, A.dtype, device), as_tensor(c, A.dtype, device))


# ----------------------------------------------------------------- batches
class BatchShard(NamedTuple):
    """Where a rank's instances sit in a batch split over ``group``:
    instances ``[start, start + count)`` of ``total``; and the split's
    collectives: the termination vote and the result's gathers."""

    group: object
    start: int
    count: int
    total: int

    def vote(self, status):
        """The chunk loop's status: one all-reduce over the batch's group
        of whether any local instance continues, so every rank runs the
        same number of chunks."""
        from fos_tpu_torch.solvers.status import Status

        live = (status == Status.CONTINUE).any().to(torch.int32).reshape(1)
        dist.all_reduce(live, op=dist.ReduceOp.MAX, group=self.group)
        return torch.where(live > 0, Status.CONTINUE, Status.OPTIMAL).to(
            torch.int32)

    def gather(self, tree):
        """A result with every per-instance tensor gathered from the
        batch's ranks, in instance order (other leaves as they are)."""
        def full(t):
            if not isinstance(t, torch.Tensor) or t.dim() == 0 \
                    or t.shape[0] != self.count:
                return t
            return gather(t, [self.group], dim=0)

        return control.tree_map(full, tree)

    def local_rows(self, x0):
        """This rank's rows of a whole batch's ``(B, ...)`` start, or
        ``x0`` as it is when it already has the local instances."""
        if x0.shape[0] != self.total:
            return x0
        return x0[self.start: self.start + self.count]


class BatchedRowShardedDense:
    """Each instance's dense A (a ``(B, m, n)`` stack) split by rows over
    one mesh axis; ``mv_pair`` takes the lane axis in one call (one
    ``torch.bmm`` each way), gathers y1 and all-reduces the partial A'z."""

    sharded = True
    #: ``mv_pair`` takes (B, k) vectors (:mod:`fos_tpu_torch.linalg.hsde_ops`)
    pair_lanes = True

    def __init__(self, block, m, n, axes: _Axes):
        self.block = block      # (B, p, n)
        self.m, self.n = m, n
        self.axes = axes

    shape = property(lambda self: (self.block.shape[0], self.m, self.n))
    dtype = property(lambda self: self.block.dtype)
    device = property(lambda self: self.block.device)

    def mv_pair(self, x, z):
        z_loc = _rows(z, self.axes.index, self.block.shape[1])
        y1 = torch.bmm(self.block, x[..., None])[..., 0]
        y2 = torch.bmm(self.block.transpose(1, 2), z_loc[..., None])[..., 0]
        return (gather(y1, self.axes.groups)[..., : self.m],
                all_reduce(y2, self.axes.product))


def shard_batched_form(form, mesh, axis: str = "batch"):
    """Split a batched form's instances over ``axis``: each rank keeps its
    ``B / size`` of them (the batch must divide evenly)."""
    axes = _Axes(mesh, axis)
    B = form.b.shape[0]
    if B % axes.size:
        raise ValueError(f"{B} instances do not split over the {axes.size} "
                         f"ranks of {axes.names}")
    count = B // axes.size
    start = axes.index * count
    local = form.instances(start, start + count)
    local.batch_shard = BatchShard(axes.product, start, count, B)
    return local


def shard_batched_form_rows(form, mesh, batch_axis: str = "batch",
                            model_axis: str = "model"):
    """Data x model parallelism for a batched form: instances split over
    ``batch_axis`` (a collective only at the termination vote) and each
    instance's A split by rows over ``model_axis``
    (:class:`BatchedRowShardedDense`, a collective per product)."""
    local = shard_batched_form(form, mesh, batch_axis)
    A = local.A
    if not isinstance(A, torch.Tensor) or A.dim() != 3:
        raise ValueError("shard_batched_form_rows takes a batched form with "
                         "a dense (B, m, n) A")
    axes = _Axes(mesh, model_axis)
    B, m, n = A.shape
    block = _rows(A, axes.index, -(-m // axes.size), dim=1).contiguous()
    return local.with_operator(BatchedRowShardedDense(block, m, n, axes))

