"""The port's renderer on the CPU: the host seed, the tracer choice, the
config against the JAX package's (knobs the port does not carry raise,
every field it carries keeps the reference's default), the accumulation
and tile helpers, the port's imports (no JAX) and the CLI's render,
resume and scene list."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.cli import build_parser
from metal_raytracing_tpu_torch.cli import main as cli_main
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (few_torch_threads,  # noqa: F401
                               procedural_models)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
