"""The port's sampling and light sampling against the JAX package (CPU).

Inputs are drawn from a seeded numpy generator and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import lights as jlights
from metal_raytracing_tpu import sampling as jsampling
from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import pack_lights as jpack_lights
from metal_raytracing_tpu_torch import lights as tlights
from metal_raytracing_tpu_torch import sampling as tsampling
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import pack_lights as tpack_lights


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def procedural_models():
    """Both packages build their scenes from the procedural stand-ins."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
               jproc.make_model(n))
    mp.setattr(tlib, "resolve_model", lambda n, prefer_file=True:
               tproc.make_model(n))
    yield
    mp.undo()


@pytest.mark.parametrize("dim", range(17))
def test_halton_bit_exact(dim):
    """4,096 indices below 2^21 (offset < 2^20 plus the sample index):
    every Halton dimension the renderer reads is bit-identical."""
    idx = np.random.default_rng(dim).integers(0, 1 << 21, 4096,
                                              dtype=np.int32)
    ref = np.asarray(jsampling.halton(jnp.asarray(idx), dim))
    got = tsampling.halton(torch.from_numpy(idx), dim).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


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
