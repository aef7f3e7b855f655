"""The port's renderer end to end against the JAX package's, on the CPU.

Both render the same scene at its default config (the port with its plain
tracer versions, the JAX package with its CPU tracer), from the same seed:
the port draws the JAX package's pixel offsets bit for bit.  The gate is the
reference's own golden gate (``tests/test_golden.py``): RMSE < 1e-3 and max
pixel difference < 5e-2.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.renderer import Renderer as JRenderer
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.cli import build_parser
from metal_raytracing_tpu_torch.cli import main as cli_main
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import RenderConfig

W, H = 64, 48
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_host_seed_off_gives_the_same_image():
    """host_seed only moves the global set's shadow test from the host fold
    into the any-hit pass; the closest pass is seeded either way."""
    imgs = [R.Renderer(tlib.get_scene("teapot", 32, 32),
                       RenderConfig(width=32, height=32, host_seed=hs),
                       device="cpu").render(1) for hs in (True, False)]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0].max() > 0.01


def test_cuda_tracer_on_cpu_device_raises():
    with pytest.raises(ValueError, match="CUDA device"):
        R.Renderer(tlib.get_scene("teapot", 32, 32),
                   RenderConfig(width=32, height=32, tracer="cuda"),
                   device="cpu")
    assert R.resolve_tracer(RenderConfig(), "cpu") == "torch"
    assert R.resolve_tracer(RenderConfig(), "cuda") == "cuda"
    assert R.resolve_tracer(RenderConfig(tracer="torch"), "cuda") == "torch"


def test_unported_config_knobs_are_errors():
    for knob in ("carry_seed", "live_from_bounce", "live_widths",
                 "shadow_mid_order", "visit_pairs", "visit_pairs2"):
        with pytest.raises(TypeError):
            RenderConfig(**{knob: False})
    with pytest.raises(ValueError, match="tracer"):
        RenderConfig(tracer="pallas")
    # every field the port carries keeps the reference's default, but
    # compaction, which stays off in the port until its key chain is fused
    ref = JConfig()
    for name in RenderConfig.__dataclass_fields__:
        if name != "compaction":
            assert getattr(RenderConfig(), name) == getattr(ref, name), name
    assert RenderConfig().compaction is False


def test_accumulate_and_tiles():
    a = torch.zeros((2, 2, 3))
    for i, v in enumerate((1.0, 2.0, 6.0)):
        a = R.accumulate(a, torch.full((2, 2, 3), v), i)
    torch.testing.assert_close(a, torch.full((2, 2, 3), 3.0))
    img = torch.arange(48 * 64 * 3, dtype=torch.float32).reshape(48, 64, 3)
    th, tw = R.tile_shape(RenderConfig(width=64, height=48))
    flat = R._tile_flatten(img, th, tw)
    assert torch.equal(flat[:th * tw].reshape(th, tw, 3), img[:th, :tw])
    assert torch.equal(R._tile_unflatten(flat, 48, 64, th, tw), img)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import metal_raytracing_tpu_torch.renderer\n"
            "import metal_raytracing_tpu_torch.cli\n"
            "import metal_raytracing_tpu_torch.utils.metrics\n"
            "import metal_raytracing_tpu_torch.ops.broadphase_cuda\n"
            "import metal_raytracing_tpu_torch.ops._build\n"
            "import metal_raytracing_tpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'metal_raytracing_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_cli_render_resume_and_scenes(tmp_path, capsys):
    out = str(tmp_path / "t.png")
    hdr = str(tmp_path / "t.hdr")
    ckpt = str(tmp_path / "ckpt")
    args = ["render", "--scene", "teapot", "--size", "32x16", "--device",
            "cpu", "--out", out, "--checkpoint", ckpt]
    assert cli_main(args + ["--spp", "1", "--hdr-out", hdr]) == 0
    assert os.path.getsize(out) > 0 and os.path.getsize(hdr) > 0
    assert cli_main(args + ["--spp", "2", "--resume"]) == 0
    state = np.load(ckpt + ".npz")
    assert int(state["total_samples"]) == 2
    assert cli_main(["scenes"]) == 0
    listed = capsys.readouterr().out.split()
    assert "coatball" in listed and len(listed) == 7
    # the headline scene is the default, as in the JAX package's CLI
    assert build_parser().parse_args(["render"]).scene == "dragon"
