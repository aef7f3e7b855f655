"""The port's renderer end to end against the JAX package's, on the CPU.

Both render the same scene at its default config (the port with its plain
tracer versions, the JAX package with its CPU tracer), from the same seed:
the port draws the JAX package's pixel offsets bit for bit.  The gate is the
reference's own golden gate (``tests/test_golden.py``): RMSE < 1e-3 and max
pixel difference < 5e-2.  Checkpoints pass between the two renderers.  The
config, the tracer choice and the CLI are in
``tests/test_torch_renderer_config.py``.
"""

import numpy as np
import pytest

from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.renderer import Renderer as JRenderer
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (few_torch_threads,  # noqa: F401
                               procedural_models)

W, H = 64, 48


def renderers(scene):
    """A fresh (JAX, port) renderer pair at the default config; both draw
    the same pixel offsets from the seed."""
    jr = JRenderer(jlib.get_scene(scene, W, H), JConfig(width=W, height=H))
    tr = R.Renderer(tlib.get_scene(scene, W, H),
                    RenderConfig(width=W, height=H), device="cpu")
    np.testing.assert_array_equal(tr.offsets.numpy(), np.asarray(jr.offsets))
    return jr, tr


_IMAGES = {}


def images(scene):
    """(JAX renderer, port renderer) after one sample each."""
    if scene not in _IMAGES:
        jr, tr = renderers(scene)
        jr.render(1)
        tr.render(1)
        _IMAGES[scene] = (jr, tr)
    return _IMAGES[scene]


@pytest.mark.parametrize("scene", ["coatball", "teapot"])
def test_image_matches_reference(scene):
    """1 spp, 3 bounces: the reference's golden gate."""
    jr, tr = images(scene)
    a, b = jr.image, tr.image
    assert b.shape == (H, W, 3) and np.isfinite(b).all() and b.max() > 0.01
    assert rmse(a, b) < 1e-3
    assert np.abs(a - b).max() < 5e-2
    assert tr.total_closest_rays == jr.total_closest_rays
    assert abs(tr.total_shadow_rays - jr.total_shadow_rays) <= (
        1e-3 * jr.total_shadow_rays)


@pytest.mark.parametrize("scene", ["coatball", "teapot"])
def test_fingerprint_matches_reference(scene):
    jr, tr = images(scene)
    assert tr.fingerprint() == jr.fingerprint()


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """The port resumes a JAX checkpoint with the JAX offsets, so the next
    sample continues the JAX image to float rounding (RMSE < 1e-6)."""
    jr, tr = renderers("teapot")
    jr.render(1)
    path = str(tmp_path / "jax_ckpt")
    jr.save(path)
    tr.load(path)
    assert tr.total_samples == 1
    np.testing.assert_array_equal(tr.image, jr.image)
    assert tr.total_closest_rays == jr.total_closest_rays
    jr.render(1)
    tr.render(1)
    assert tr.total_samples == 2
    assert rmse(jr.image, tr.image) < 1e-6


def test_port_checkpoint_resumes_in_reference(tmp_path):
    jr, tr = renderers("teapot")
    tr.render(1)
    path = str(tmp_path / "port_ckpt.npz")
    tr.save(path)
    jr.load(path)
    assert jr.total_samples == 1
    np.testing.assert_array_equal(jr.image, tr.image)
    assert jr.total_shadow_rays == tr.total_shadow_rays


def test_checkpoint_rejects_other_scene(tmp_path):
    _, tr = images("teapot")
    path = str(tmp_path / "ckpt.npz")
    tr.save(path)
    other = R.Renderer(tlib.get_scene("plane_sphere", W, H),
                       RenderConfig(width=W, height=H), device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        other.load(path)
