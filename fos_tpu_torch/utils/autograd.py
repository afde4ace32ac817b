"""When an operation must go through its ``torch.autograd.Function``.

A hand-written kernel's ctypes launch reads ``data_ptr()`` of plain
tensors; an operation with derivative rules of its own (K1's pair, the PSD
eigh projection) takes its Function only when autograd is watching, so the
solve's own path runs the plain arithmetic unchanged.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD


def differentiated(*tensors) -> bool:
    """Whether an operation on ``tensors`` must go through an autograd
    Function: one of them needs a gradient, a forward-mode dual level is
    open, or one is wrapped by a ``torch.func`` transform.  A Function's
    forward gets plain tensors, so only it may reach a ctypes launch
    then."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return True
    if fwAD._current_level >= 0:
        return True
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)
