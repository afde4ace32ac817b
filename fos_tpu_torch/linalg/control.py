"""Loops and branches that stay on the device inside a CUDA graph.

The JAX package keeps the solve's loops on the device (``lax.while_loop``
for CG and for ``fused_solve``'s chunks, ``lax.fori_loop`` for a chunk's
steps).  Here the same Python code runs three ways:

* **eagerly** (CPU tensors, or CUDA tensors outside a capture): a Python
  loop that reads its condition on the host once per pass of the body.
  This is the plain version the tests hold the other two against.
* **under CUDA-graph capture** (a CUDA tensor while the current stream
  captures, :mod:`fos_tpu_torch.solvers.graphs`): a WHILE or IF
  conditional node (``csrc/graph.cu``).  The loop's state is copied once
  into buffers that the body reads and, at its end, overwrites with its
  result; a condition kernel sets the node's handle before the node and at
  the end of each pass.  The body is captured once, on a stream of its own,
  from the same Python code.
* **emulated** (:func:`emulated`, CPU tensors, for tests): the buffers and
  copies of the captured route with the conditions read on the host, so
  the CPU tests check the captured route's data flow.

A condition is an object with ``plain()`` (its value, read on the host)
and ``launch(handle)`` (its kernel, under capture).  The captured route
reads nothing on the host.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch

from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.linalg._cuda import ADVANCE, RESET, TEST  # noqa: F401


# ---------------------------------------------------------------- trees
def tree_leaves(tree) -> list:
    """The tensors of a tree of tuples (named or not), tensors and None."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    raise TypeError(f"a loop state holds {type(tree).__name__}; only "
                    "tensors, None and tuples of them are allowed")


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the same places of
    ``rest``), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        vals = [tree_map(fn, sub, *(r[k] for r in rest))
                for k, sub in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    raise TypeError(f"a loop state holds {type(tree).__name__}")


def assign(dst, src) -> None:
    """Copy a new loop state into the buffers that hold the old one.  A new
    leaf that shares memory with a buffer (``z_check_prev = z_check``) is
    copied out first, so that no copy reads a buffer already overwritten."""
    d, s = tree_leaves(dst), tree_leaves(src)
    if len(d) != len(s):
        raise ValueError("a loop body changed the structure of its state")
    held = {b.untyped_storage().data_ptr() for b in d}
    s = [v if v is b or v.untyped_storage().data_ptr() not in held
         else v.clone() for b, v in zip(d, s)]
    pairs = [(b, v) for b, v in zip(d, s) if v is not b]
    if pairs:
        # one multi-tensor copy per dtype on the card, not a copy per leaf
        torch._foreach_copy_([b for b, _ in pairs], [v for _, v in pairs])


def _first(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("a loop state needs at least one tensor")
    return leaves[0]


# ------------------------------------------------------------ conditions
class CGContinue(NamedTuple):
    """CG's stopping test ``(rn > tol2) & (it < max_iters)``; ``flag``, where
    given, holds that test already (CG's step kernel writes it), and the
    plain version reads it instead of computing it."""

    rn: torch.Tensor
    tol2: torch.Tensor
    it: torch.Tensor
    max_iters: int
    flag: Any = None

    def plain(self) -> bool:
        if self.flag is not None:
            return bool(self.flag)
        return bool((self.rn > self.tol2) & (self.it < self.max_iters))

    def launch(self, handle: int) -> None:
        _cuda.cg_continue(handle, self.rn, self.tol2, self.it, self.max_iters)


class CGContinueLanes(NamedTuple):
    """CG's stopping test over lanes: any lane with ``(rn > tol2) & (it <
    max_iters)``; ``rn`` and ``it`` have one entry per lane (lanes that
    nest, ``(B, P)``, are handed to the kernel as one run of ``B P``),
    ``tol2`` one per lane or one for all; ``flag`` as for
    :class:`CGContinue`, one per lane."""

    rn: torch.Tensor
    tol2: torch.Tensor
    it: torch.Tensor
    max_iters: int
    flag: Any = None

    def plain(self) -> bool:
        if self.flag is not None:
            return bool(self.flag.any())
        return bool(((self.rn > self.tol2) & (self.it < self.max_iters)).any())

    def launch(self, handle: int) -> None:
        tol2 = self.tol2.reshape(-1) if self.tol2.dim() else self.tol2
        _cuda.cg_continue_lanes(handle, self.rn.reshape(-1), tol2,
                                self.it.reshape(-1), self.max_iters)


def count_continue_plain(k, mode: int, limit: int, status=None,
                         want: int = 0) -> bool:
    """The plain version of the ``count_continue`` kernel: reset or advance
    the counter ``k`` in place, then ``k < limit`` (and ``status == want``
    for some lane of ``status``)."""
    if mode == RESET:
        k.fill_(0)
    elif mode == ADVANCE:
        k.add_(1)
    live = k < limit
    if status is not None:
        live = live & (status == want).any()
    return bool(live)


class Count(NamedTuple):
    """A counter reset or advanced, then ``k < limit`` (and, with a status,
    ``status == want``; with a status per lane, for any lane)."""

    k: torch.Tensor
    mode: int
    limit: int
    status: Any = None
    want: int = 0

    def plain(self) -> bool:
        return count_continue_plain(*self)

    def launch(self, handle: int) -> None:
        _cuda.count_continue(handle, *self)


class Flag(NamedTuple):
    """A bool tensor, or its negation."""

    flag: torch.Tensor
    negate: bool = False

    def plain(self) -> bool:
        return bool(self.flag) != self.negate

    def launch(self, handle: int) -> None:
        _cuda.flag_continue(handle, self.flag, self.negate)


# ------------------------------------------------------------- routes
_emulate = False
_depth = 0
_streams = {}


@contextlib.contextmanager
def emulated():
    """Run loops on CPU tensors through the captured route's buffers and
    copies, the conditions read on the host (tests)."""
    global _emulate
    prev, _emulate = _emulate, True
    try:
        yield
    finally:
        _emulate = prev


def capturing(t: torch.Tensor) -> bool:
    """True when ``t`` lies on the card and its stream is being captured."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def side_stream(device, level: int) -> torch.cuda.ExternalStream:
    """The stream that captures a graph (``level`` 0) or the bodies of its
    conditional nodes nested ``level`` deep; made once, by the library, so
    that nothing else runs on it."""
    key = (device.index, level)
    s = _streams.get(key)
    if s is None:
        with torch.cuda.device(device):
            s = _streams[key] = torch.cuda.ExternalStream(
                _cuda.stream_create(), device=device)
    return s


def _route(t):
    if capturing(t):
        return _Captured
    if _emulate and not t.is_cuda:
        return _Emulated
    return None


class _Emulated:
    @staticmethod
    def while_(like, test, step):
        while test().plain():
            step()

    @staticmethod
    def if_(like, test, step):
        if test().plain():
            step()


class _Captured:
    @staticmethod
    def _node(like, kind, test, step, loop):
        global _depth
        parent = torch.cuda.current_stream(like.device)
        handle = _cuda.graph_handle(parent.cuda_stream)
        test().launch(handle)
        body = side_stream(like.device, _depth + 1)
        _cuda.cond_open(parent.cuda_stream, body.cuda_stream, handle, kind)
        _depth += 1
        try:
            with torch.cuda.stream(body):
                step()
                if loop:
                    test().launch(handle)
        except BaseException:
            _cuda.capture_abort(body.cuda_stream)
            raise
        else:
            _cuda.cond_close(body.cuda_stream)
        finally:
            _depth -= 1

    @classmethod
    def while_(cls, like, test, step):
        cls._node(like, _cuda.WHILE, test, step, loop=True)

    @classmethod
    def if_(cls, like, test, step):
        cls._node(like, _cuda.IF, test, step, loop=False)


# ------------------------------------------------------- loops, branches
def while_loop(cond, body, carry, in_place: bool = False):
    """``while cond(carry): carry = body(carry)``; ``cond`` returns a
    condition (:class:`CGContinue`, :class:`CGContinueLanes`,
    :class:`Count`, :class:`Flag`).  ``in_place``: the body updates the
    carry's tensors in place and returns them, and the caller owns them, so
    the captured route uses them as its buffers (no copies)."""
    first = _first(carry)
    route = _route(first)
    if route is None:
        while cond(carry).plain():
            carry = body(carry)
        return carry
    bufs = carry if in_place else tree_map(torch.clone, carry)
    route.while_(first, lambda: cond(bufs), lambda: assign(bufs, body(bufs)))
    return bufs


def fori_loop(n: int, body, carry):
    """``for k in range(n): carry = body(k, carry)``.  Eagerly ``k`` is the
    host's count; on the captured route the body runs with ``k = None``
    (the loop counts on the device) and must not need it."""
    if n <= 0:
        return carry
    first = _first(carry)
    route = _route(first)
    if route is None:
        for k in range(n):
            carry = body(k, carry)
        return carry
    if n == 1:
        return body(None, carry)
    bufs = tree_map(torch.clone, carry)
    k = torch.empty((), dtype=torch.int32, device=first.device)
    modes = iter((RESET,))
    route.while_(first, lambda: Count(k, next(modes, ADVANCE), n),
                 lambda: assign(bufs, body(None, bufs)))
    return bufs


def cond(pred: torch.Tensor, true_fn, false_fn, operand):
    """``true_fn(operand)`` if ``pred`` else ``false_fn(operand)``; both
    return trees shaped like ``operand``.  Captured, it is two IF nodes
    (``pred`` and its negation) writing one set of outputs."""
    route = _route(pred)
    if route is None:
        return true_fn(operand) if bool(pred) else false_fn(operand)
    out = tree_map(torch.empty_like, operand)
    for fn, negate in ((true_fn, False), (false_fn, True)):
        route.if_(pred, lambda: Flag(pred, negate),
                  lambda: assign(out, fn(operand)))
    return out
