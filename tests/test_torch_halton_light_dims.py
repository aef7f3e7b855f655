"""The port's Halton sequence against the JAX package's (CPU), bit for bit,
in the dimensions the renderer reads to pick and sample a light at each
bounce (``bounce_dim(b, k)`` for k = 0, 1, 2; the others are in
``tests/test_torch_halton_path_dims.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import sampling as jsampling
from metal_raytracing_tpu_torch import sampling as tsampling
from torch_port_common import (few_torch_threads,  # noqa: F401
                               procedural_models)

# bounce_dim(b, k), k = 0: the light pick, k = 1, 2: the light sample
DIMS = [2, 3, 4, 7, 8, 9, 12, 13, 14]


@pytest.mark.parametrize("dim", DIMS)
def test_halton_bit_exact(dim):
    """4,096 indices below 2^21 (offset < 2^20 plus the sample index):
    every Halton dimension the renderer reads is bit-identical."""
    idx = np.random.default_rng(dim).integers(0, 1 << 21, 4096,
                                              dtype=np.int32)
    ref = np.asarray(jsampling.halton(jnp.asarray(idx), dim))
    got = tsampling.halton(torch.from_numpy(idx), dim).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
