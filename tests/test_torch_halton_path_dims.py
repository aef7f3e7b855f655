"""The port's Halton sequence against the JAX package's (CPU), bit for bit,
in the dimensions the renderer reads to jitter the pixel and to sample
each bounce's direction (``DIM_PIXEL_X``, ``DIM_PIXEL_Y`` and
``bounce_dim(b, k)`` for k = 3, 4; the light's dimensions are in
``tests/test_torch_halton_light_dims.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import sampling as jsampling
from metal_raytracing_tpu_torch import sampling as tsampling
from torch_port_common import (few_torch_threads,  # noqa: F401
                               procedural_models)

# the pixel jitter, then bounce_dim(b, k), k = 3, 4: the bounce direction
DIMS = [0, 1, 5, 6, 10, 11, 15, 16]


@pytest.mark.parametrize("dim", DIMS)
def test_halton_bit_exact(dim):
    """4,096 indices below 2^21 (offset < 2^20 plus the sample index):
    every Halton dimension the renderer reads is bit-identical."""
    idx = np.random.default_rng(dim).integers(0, 1 << 21, 4096,
                                              dtype=np.int32)
    ref = np.asarray(jsampling.halton(jnp.asarray(idx), dim))
    got = tsampling.halton(torch.from_numpy(idx), dim).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
