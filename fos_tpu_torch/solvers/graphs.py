"""Capture and replay: the solve's device work as CUDA graphs.

The JAX package compiles each chunk of ``checki`` iterations (and the
whole of ``fused_solve``) into one XLA program, re-traced when a static
argument changes.  The port captures the same functions into CUDA graphs
(:class:`Captured`): their loops and branches become conditional nodes
(:mod:`fos_tpu_torch.linalg.control`), so a replay runs a whole chunk,
CG's data-dependent stops included, with no host work between kernels.

* A graph is captured once per key, the counterpart of JAX's static
  arguments (algorithm, step count, eps, ...), and kept on the problem form
  (:func:`cached`, the last key of each kind: chunk, steps, final,
  fused); a new form (the stall recovery's :meth:`tighten_cg`)
  captures anew, and :func:`release` frees the old form's graphs.
* Its inputs are static copies made when it is captured; a call copies new
  inputs into them, skipping any that already are them.  With ``inplace``
  the graph itself copies its new state over its input state, so a chain
  of calls that passes the returned state back in replays with no copy and
  no host work.
* Capture runs on a stream of the library's own, in a private memory pool;
  the bodies of conditional nodes capture on other streams (one per
  nesting level), whose allocations go to a second private pool of the
  same graph.  A failed capture raises: nothing carries on eagerly.
"""

from __future__ import annotations

import contextlib

import torch

from fos_tpu_torch.linalg import control

#: nesting levels whose streams are warmed (cuBLAS handle, workspace) before
#: a first capture: the chunk loop, the step loop, CG, and a branch in a step
WARM_LEVELS = 5

_warmed = set()
_spans = None


@contextlib.contextmanager
def replay_spans():
    """Record a pair of CUDA events around every replay made inside the
    block; yields the list of (start, end) pairs, to be read with
    ``start.elapsed_time(end)`` after a synchronise.  A measurement hook
    (``chip_smoke.py``): off, a replay pays one test."""
    global _spans
    prev, _spans = _spans, []
    try:
        yield _spans
    finally:
        _spans = prev


def signature(tree):
    """What a graph's inputs must keep between calls: the tree's structure
    and each tensor's shape and dtype."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return (type(tree).__name__, tuple(signature(t) for t in tree))


def _warm(device) -> None:
    """Create cuBLAS's handle and each capture stream's workspace before the
    first capture on ``device`` (neither may be made during one)."""
    if device.index in _warmed:
        return
    v = torch.ones(8, device=device)
    for level in range(WARM_LEVELS):
        s = control.side_stream(device, level)
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            torch.dot(v, v)
            torch.mv(v[:, None], v[:1])
        torch.cuda.current_stream(device).wait_stream(s)
    _warmed.add(device.index)


def _route_bodies(device, pool) -> None:
    """Send this thread's allocations that the graph's own capture does not
    take (those of body streams) to ``pool``."""
    begin = getattr(torch._C, "_cuda_beginAllocateCurrentThreadToPool", None)
    if begin is None:
        torch._C._cuda_beginAllocateToPool(device.index, pool)
    else:
        begin(device.index, pool)


class Captured:
    """``fn(*args)`` captured once into a CUDA graph over static copies of
    the tensors in ``args`` (a tree of tuples, tensors and None).

    Calling it copies its arguments into those copies and replays the
    graph; it returns ``fn``'s outputs, static tensors that the next replay
    overwrites.  With ``inplace`` the graph ends by copying ``fn``'s first
    output over the copies of its first argument, and returns those."""

    def __init__(self, fn, args, *, inplace: bool = False):
        device = control.tree_leaves(args)[0].device
        self.device = device
        self.signature = signature(args)
        self.args = control.tree_map(torch.clone, args)
        self.graph = torch.cuda.CUDAGraph()
        self.body_pool = torch.cuda.graph_pool_handle()
        _warm(device)
        stream = control.side_stream(device, 0)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=torch.cuda.graph_pool_handle())
            _route_bodies(device, self.body_pool)
            try:
                out = fn(*self.args)
                if inplace:
                    control.assign(self.args[0], out[0])
                    out = (self.args[0], *out[1:])
            except BaseException:
                torch._C._cuda_endAllocateToPool(device.index, self.body_pool)
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            torch._C._cuda_endAllocateToPool(device.index, self.body_pool)
            self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.out = out

    def __call__(self, *args):
        if signature(args) != self.signature:
            raise ValueError("a captured graph was called with inputs of "
                             "another structure, shape or dtype")
        for buf, v in zip(control.tree_leaves(self.args),
                          control.tree_leaves(args)):
            if v is not buf:
                buf.copy_(v)
        if _spans is None:
            self.graph.replay()
        else:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            self.graph.replay()
            end.record()
            _spans.append((start, end))
        return self.out

    def release(self) -> None:
        """Free the graph and its memory pools."""
        if self.graph is None:
            return
        self.graph.reset()
        self.graph = self.args = self.out = None
        torch._C._cuda_releasePool(self.device.index, self.body_pool)

    def __del__(self):
        with contextlib.suppress(Exception):
            self.release()


def cached(owner, key, make) -> Captured:
    """The graph kept on ``owner`` (a problem form) for ``key``, captured by
    ``make()`` when the graph kept for its kind (``key[0]``) has another
    key: one graph is kept per kind, and the one a new key replaces is
    freed first, so a form reused with other options holds no graphs it
    no longer replays."""
    graphs = owner.__dict__.setdefault("_graphs", {})
    kept = graphs.get(key[0])
    if kept is not None:
        if kept[0] == key:
            return kept[1]
        del graphs[key[0]]
        kept[1].release()
    g = make()
    graphs[key[0]] = (key, g)
    return g


def release(owner) -> None:
    """Free every graph kept on ``owner``."""
    for _, g in owner.__dict__.pop("_graphs", {}).values():
        g.release()
