"""The launch probes P1/P2 against the TPU kernels they replace.

``tools/launch_probe.py`` builds its two Pallas kernels, ``tiny`` (kernel
``k``) and ``pref`` (kernel ``k3``, one scalar-prefetch operand), as
closures inside its ``main``, which times them on a TPU; so this file
restates their three-line bodies and runs them in interpret mode on the
CPU.  P1/P2's plain versions (what the CUDA kernels are held to on the
card, bit for bit) must equal them bit for bit on a numpy-seeded (8, 128)
tile: one f32 multiply by 1.0000001 per element, whatever P2's indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.tools import launch_probe


def _tiny(x):
    """``tools/launch_probe.py``'s ``tiny``: grid 1, one (8, 128) block."""

    def k(x_ref, y_ref):
        y_ref[...] = x_ref[...] * 1.0000001

    return pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(x)


def _pref(sp, x):
    """``tools/launch_probe.py``'s ``pref``: the same body with one
    scalar-prefetch operand, which its index maps ignore."""

    def k3(s_ref, x_ref, y_ref):
        y_ref[...] = x_ref[...] * 1.0000001

    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(1,),
        in_specs=[pl.BlockSpec((8, 128), lambda i, s: (i * 0, i * 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i, s: (i * 0, i * 0)))
    return pl.pallas_call(
        k3, grid_spec=gs,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(sp, x)


def _indices(case, rng):
    if case == "pref_random_idx":
        return rng.integers(-2**31, 2**31 - 1, 8, dtype=np.int32)
    return np.arange(8, dtype=np.int32)


@pytest.mark.parametrize("case", ["tiny", "pref", "pref_random_idx"])
def test_probe_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 128), dtype=np.float32)
    idx = _indices(case, rng)
    before = dict(_cuda.LAUNCHES)
    if case == "tiny":
        want = np.asarray(_tiny(jnp.asarray(x)))
        got = launch_probe.probe_tiny(torch.from_numpy(x))
    else:
        want = np.asarray(_pref(jnp.asarray(idx), jnp.asarray(x)))
        got = launch_probe.probe_prefetch(torch.from_numpy(idx),
                                          torch.from_numpy(x))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    # bit for bit, and both one f32 rounding of x * 1.0000001
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(want, x * np.float32(1.0000001))
    assert _cuda.LAUNCHES == before   # CPU tensors take the plain version
