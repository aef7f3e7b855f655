"""The port's pixel decorrelation offsets (CPU): seeded, in range, and bit
for bit the JAX package's ``jax.random.randint`` draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu_torch import sampling as tsampling
from torch_port_common import (few_torch_threads,  # noqa: F401
                               procedural_models)


def test_pixel_offsets_seeded_and_in_range():
    a = tsampling.pixel_decorrelation_offsets(3, 4096, bits=20)
    b = tsampling.pixel_decorrelation_offsets(3, 4096, bits=20)
    c = tsampling.pixel_decorrelation_offsets(4, 4096, bits=20)
    assert a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < (1 << 20)
    with pytest.raises(ValueError, match="headroom"):
        tsampling.pixel_decorrelation_offsets(0, 8, bits=22)


@pytest.mark.parametrize("bits", [16, 20])
@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_pixel_offsets_equal_jax_random(seed, bits):
    """Bit for bit the JAX package's offsets (``jax.random.randint`` under
    this JAX's threefry settings), at an odd length."""
    n = 3 * 1021
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                                        1 << bits, dtype=jnp.int32))
    got = tsampling.pixel_decorrelation_offsets(seed, n, bits=bits).numpy()
    np.testing.assert_array_equal(got, ref)
    # randint's two-draw span arithmetic at a span that is not a power of
    # two, where the uint32 product 2^16 * 2^16 wraps
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                                        100_003, dtype=jnp.int32))
    np.testing.assert_array_equal(tsampling.jax_randint(seed, n, 100_003),
                                  ref)
