"""The single-block lambda-min SDP instances of bench.py, as files.

bench.py's ``sdp_single_bench`` draws its cost matrix with JAX,
``C = normal(PRNGKey(29), (d, d), f32) / sqrt(d)``, symmetrised as
``(C + C') / 2`` (bench.py:380-382).  The card has no JAX, so the lower
triangles of those matrices for d = 512 and 1024 are stored here
(``data/sdp_c_<d>.npy``, f32, row-major ``numpy.tril_indices`` order),
made with jax 0.9.0 on the CPU; ``tests/test_torch_sdp_instance.py``
regenerates them and checks the files bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"
SIDES = (512, 1024)


def path(d: int) -> Path:
    return DATA / f"sdp_c_{d}.npy"


def load(d: int) -> np.ndarray:
    """The symmetric f32 matrix C (d, d) of bench.py's instance."""
    low = np.load(path(d))
    C = np.zeros((d, d), np.float32)
    rows, cols = np.tril_indices(d)
    C[rows, cols] = low
    C[cols, rows] = low
    return C
