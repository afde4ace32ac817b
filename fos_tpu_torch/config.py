"""Global configuration for fos_tpu_torch.

Importing this module pins full-f32 matrix products: a float32
``torch.matmul`` on the card must not run in TF32, which keeps about three
decimal digits and stalls first-order conic solves the way a reduced-
precision matrix unit does (the counterpart of ``fos_tpu.linalg.hsde_ops.
PREC``).  The dtype of a solve follows its input: f64 stays f64, with no
global switch.

Entry points (``solve``, ``solve_feasibility``, the tile operators' and the
sets' constructors) run on the card unless the caller asks for the CPU:
:func:`default_device`.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def eps_of(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def as_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def as_tensor(v, dtype=None, device=None) -> torch.Tensor:
    """numpy / list / tensor -> tensor, keeping the input's float dtype
    unless ``dtype`` is given."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device if device is not None else v.device,
                    dtype=dtype if dtype is not None else v.dtype)
    arr = np.asarray(v)
    if not np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float64)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def default_device(device=None) -> torch.device:
    """Where an entry point runs: ``device`` when given, else the current
    CUDA card (the first, unless a rank of a sharded run chose its own).
    Without a card it raises: the CPU is used only when asked for
    (``device="cpu"``), never as a silent fallback."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError(
        "no CUDA device is available; pass device=\"cpu\" to run on the CPU")


def require_hopper(device=None) -> None:
    """Raise unless ``device`` (default: the current CUDA device) is an sm_90
    card, the target the hand-written kernels are compiled for."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        name = torch.cuda.get_device_name(device)
        raise RuntimeError(
            f"{name} is sm_{major}{minor}; the pair kernels are built for sm_90a")
