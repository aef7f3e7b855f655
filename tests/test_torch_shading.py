"""The port's shading extensions against the JAX package's, on the CPU:
coatball with its specular lobe and emission, glass_sphere with refraction.

One JAX build of each scene (procedural stand-ins) feeds both renderers at
32x32, 1 sample, 3 bounces, the port on its plain tracers.  The gate is the
reference's golden gate (``tests/test_golden.py``: RMSE < 1e-3, max pixel
difference < 5e-2) against the JAX renderer with the same flags and seed.

glass_sphere's reference runs the JAX package's exact BVH tracer.
coatball's runs its Pallas tracer in interpret mode, the tracer whose packed
key the port's kernels share: coatball's base stands on the floor, so
bounce rays from the glowing base meet the base's bottom and the floor at
one distance, and the packed key gives such a tie to the floor (the global
set's seed wins ties) where the exact tracer may pick the base.  Under
emission that choice is visible, beyond the gate at this size, and the JAX
package's two tracers disagree there the same way
(``tests/test_torch_shading_ties.py`` holds that).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from metal_raytracing_tpu import renderer as JR
from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (assert_image_gate, build_both,  # noqa: F401
                               few_torch_threads)

W = H = 32
CASES = {
    "coatball": (dict(enable_specular=True, enable_emission=True), "pallas"),
    "glass_sphere": (dict(enable_refraction=True), "bvh"),
}


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec)."""
    return {scene: build_both(scene, W, H) for scene in CASES}


_IMAGES = {}


def port_sample(scenes, scene, **kw):
    """(image, stats) of one port sample on the plain tracers, each config
    rendered once per module."""
    tag = (scene, tuple(sorted(kw.items())))
    if tag not in _IMAGES:
        _, _, tdata, tspec = scenes[scene]
        cfg = RenderConfig(width=W, height=H, **kw)
        img, stats = R.render_sample(tdata, tspec, cfg,
                                     R.make_pixel_offsets(cfg), 0)
        _IMAGES[tag] = (img.numpy(), {k: int(v) for k, v in stats.items()})
    return _IMAGES[tag]


@pytest.mark.parametrize("scene", sorted(CASES))
def test_extension_image_matches_reference(scenes, scene):
    flags, tracer = CASES[scene]
    jdata, jspec, _, _ = scenes[scene]
    jcfg = JConfig(width=W, height=H, tracer=tracer, compaction=False,
                   **flags)
    ref, jstats = JR.render_sample(jdata, jspec, jcfg,
                                   JR.make_pixel_offsets(jcfg), jnp.int32(0))
    ref = np.asarray(ref)
    img, stats = port_sample(scenes, scene, **flags)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.max() > 0.01
    assert_image_gate(img, ref, f"{scene} {flags} against JAX {tracer}")
    assert stats["closest_rays"] == int(jstats["closest_rays"])
    # the extension changes the image: it is not a no-op
    plain, _ = port_sample(scenes, scene)
    assert rmse(plain, img) > 1e-2


def test_glass_sphere_compaction_is_a_permutation(scenes, monkeypatch):
    """Refraction moves the next bounce's origin off the shadow origin, so
    the pair sweep (shadow key and next sort keys over one origin) is off
    under it; the sorted wavefront gives the unsorted one's image."""
    flags = CASES["glass_sphere"][0]
    ref, ref_stats = port_sample(scenes, "glass_sphere", **flags)
    pairs = []
    sweep = BP.nearest_cluster_pair
    monkeypatch.setattr(R, "nearest_cluster_pair",
                        lambda *a, **k: pairs.append(1) or sweep(*a, **k))
    img, stats = port_sample(scenes, "glass_sphere", compaction=True, **flags)
    assert not pairs
    assert rmse(ref, img) < 1e-6
    assert stats["closest_rays"] == ref_stats["closest_rays"]
    assert stats["shadow_rays"] == ref_stats["shadow_rays"]
    # without refraction the same config does take the pair sweep
    port_sample(scenes, "glass_sphere", compaction=True)
    assert pairs


def test_extensions_without_their_data_change_nothing(scenes):
    """An extension whose scene has nothing for it (no environment map, no
    texture, no dielectric, no Ke) leaves the diffuse image bit for bit;
    coatball has none of the first three, glass_sphere no Ke.  (The
    specular lobe is not such a no-op: without Ks it still divides the
    diffuse throughput by 1 - 1e-6, as in the JAX package.)"""
    ref, ref_stats = port_sample(scenes, "coatball")
    img, stats = port_sample(scenes, "coatball", env_map=True,
                             enable_textures=True, enable_refraction=True)
    np.testing.assert_array_equal(img, ref)
    assert stats == ref_stats
    glass, _ = port_sample(scenes, "glass_sphere")
    lit, _ = port_sample(scenes, "glass_sphere", enable_emission=True)
    np.testing.assert_array_equal(lit, glass)


def test_config_carries_the_extension_fields():
    ref = JConfig()
    for name in ("enable_specular", "enable_emission", "enable_refraction",
                 "enable_textures", "texture_filter", "env_map"):
        assert getattr(RenderConfig(), name) == getattr(ref, name), name
    assert RenderConfig(texture_filter="bilinear").texture_filter == "bilinear"
    with pytest.raises(ValueError, match="texture_filter"):
        RenderConfig(texture_filter="trilinear")
    cfg = dataclasses.replace(RenderConfig(), enable_refraction=True)
    assert cfg.enable_refraction and not RenderConfig().enable_refraction
