"""The port's sampling and light sampling against the JAX package (CPU);
the Halton sequence and the pixel offsets are in
``tests/test_torch_halton_*.py`` and ``tests/test_torch_pixel_offsets.py``.

Inputs are drawn from a seeded numpy generator and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import lights as jlights
from metal_raytracing_tpu import sampling as jsampling
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import pack_lights as jpack_lights
from metal_raytracing_tpu_torch import lights as tlights
from metal_raytracing_tpu_torch import sampling as tsampling
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import pack_lights as tpack_lights
from torch_port_common import (few_torch_threads,  # noqa: F401
                               procedural_models)


def test_bounce_dim_schedule():
    for b in range(4):
        for k in range(5):
            assert tsampling.bounce_dim(b, k) == jsampling.bounce_dim(b, k)


def _uniform(seed, n=2048):
    return np.random.default_rng(seed).random((n, 2), dtype=np.float32)


def test_cosine_hemisphere_matches():
    u = _uniform(1)
    ref = np.asarray(jsampling.sample_cosine_weighted_hemisphere(
        jnp.asarray(u)))
    got = tsampling.sample_cosine_weighted_hemisphere(
        torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_align_hemisphere_matches():
    rng = np.random.default_rng(2)
    local = np.array(jsampling.sample_cosine_weighted_hemisphere(
        jnp.asarray(_uniform(3))))
    normal = rng.normal(size=(2048, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    ref = np.asarray(jsampling.align_hemisphere_with_normal(
        jnp.asarray(local), jnp.asarray(normal)))
    got = tsampling.align_hemisphere_with_normal(
        torch.from_numpy(local), torch.from_numpy(normal)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scene", ["coatball", "teapot"])
def test_sample_lights_matches(scene):
    """coatball: area + spot lights; teapot: area + sun."""
    jl = jpack_lights(jlib.get_scene(scene, 32, 32).lights)
    tl = tpack_lights(tlib.get_scene(scene, 32, 32).lights)
    rng = np.random.default_rng(4)
    n = 4096
    lu = rng.random(n, dtype=np.float32)
    u = rng.random((n, 2), dtype=np.float32)
    pos = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1])
    jidx = jlights.select_light(jnp.asarray(lu), jl.count)
    tidx = tlights.select_light(torch.from_numpy(lu), tl.count)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    ref = jlights.sample_lights(jl, jidx, jnp.asarray(u), jnp.asarray(pos))
    got = tlights.sample_lights(tl, tidx, torch.from_numpy(u),
                                torch.from_numpy(pos))
    for field in ("direction", "color", "distance"):
        r = np.asarray(getattr(ref, field))
        g = getattr(got, field).numpy()
        np.testing.assert_array_equal(np.isinf(g), np.isinf(r))
        fin = np.isfinite(r)
        np.testing.assert_allclose(g[fin], r[fin], rtol=0, atol=1e-5,
                                   err_msg=field)
