"""The port's texture and environment-map extensions and the CLI's render
flags against the JAX package, on the CPU.

uv_test (a textured quad, nearest and bilinear filtering) and bunny_env
(the environment map) render at 32x32, 1 sample, 3 bounces from one JAX
build of each scene, the port on its plain tracers, within the reference's
golden gate (``tests/test_golden.py``: RMSE < 1e-3, max pixel difference <
5e-2) of the JAX renderer's exact BVH tracer with the same flags and seed.
The port's own build of uv_test gives the JAX build's texture tables bit
for bit, and ``load_texture`` decodes as the JAX package's does.  The CLI
turns on each extension scene's extension as the JAX CLI does, and
``parity`` takes the JAX parity command's flags and refuses the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import assets as jassets
from metal_raytracing_tpu import renderer as JR
from metal_raytracing_tpu import scene as JS
from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import assets as tassets
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch import scene as TS
from metal_raytracing_tpu_torch.cli import build_parser, render_config
from metal_raytracing_tpu_torch.cli import main as cli_main
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (assert_image_gate, build_both,  # noqa: F401
                               few_torch_threads, jax_scene_arrays)

W = H = 32
CASES = {
    "uv_test-nearest": ("uv_test", dict(enable_textures=True)),
    "uv_test-bilinear": ("uv_test", dict(enable_textures=True,
                                         texture_filter="bilinear")),
    "bunny_env-env_map": ("bunny_env", dict(env_map=True)),
}


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec)."""
    return {scene: build_both(scene, W, H)
            for scene in sorted({s for s, _ in CASES.values()})}


@pytest.fixture
def procedural_models(monkeypatch):
    """Both packages build their scenes from the procedural stand-ins."""
    monkeypatch.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
                        jproc.make_model(n))
    monkeypatch.setattr(tlib, "resolve_model", lambda n, prefer_file=True:
                        tproc.make_model(n))


@pytest.mark.parametrize("case", sorted(CASES))
def test_map_image_matches_reference(scenes, case):
    scene, flags = CASES[case]
    jdata, jspec, tdata, tspec = scenes[scene]
    jcfg = JConfig(width=W, height=H, tracer="bvh", compaction=False, **flags)
    ref, jstats = JR.render_sample(jdata, jspec, jcfg,
                                   JR.make_pixel_offsets(jcfg), jnp.int32(0))
    ref = np.asarray(ref)
    cfg = RenderConfig(width=W, height=H, **flags)
    img, stats = R.render_sample(tdata, tspec, cfg, R.make_pixel_offsets(cfg),
                                 0)
    img = img.numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.max() > 0.01
    assert_image_gate(img, ref, f"{case} against JAX bvh")
    assert int(stats["closest_rays"]) == int(jstats["closest_rays"])
    # the extension changes the image: it is not a no-op
    plain = R.render_sample(tdata, tspec, RenderConfig(width=W, height=H),
                            R.make_pixel_offsets(cfg), 0)[0].numpy()
    assert rmse(plain, img) > 1e-2


def test_texture_tables_equal_reference(procedural_models):
    """The port's own build of uv_test: ``uv_table``, ``tex_stack`` and
    ``tex_hw`` are the JAX build's bit for bit, and they carry across
    ``scene_data_from_reference``; ``_pack_uv_table`` rounds as the JAX
    package's jitted one (fused multiply-adds) on seeded tables too."""
    jdata, jspec = jlib.get_scene("uv_test", W, H).build(
        cluster_size=384, builder="sah_free")
    tdata, tspec = tlib.get_scene("uv_test", W, H).build(
        cluster_size=384, builder="sah_free", device="cpu")
    assert tspec.has_textures and jspec.has_textures
    ja, ta = jax_scene_arrays(jdata), TS.scene_data_arrays(tdata)
    for key in ("uv_table", "tex_stack", "tex_hw"):
        assert ta[key].dtype == ja[key].dtype, key
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
    back, bspec = TS.scene_data_from_reference(ja, jspec, "cpu")
    assert bspec.has_textures
    for key in ("uv_table", "tex_stack", "tex_hw"):
        assert torch.equal(getattr(back, key), getattr(tdata, key)), key
    assert tlib.get_scene("teapot", W, H).build(
        device="cpu")[0].uv_table is None
    rng = np.random.RandomState(7)
    uvc = rng.uniform(-2.0, 3.0, (2048, 3, 2)).astype(np.float32)
    tri = rng.normal(size=(12, 2048)).astype(np.float32)
    np.testing.assert_array_equal(
        TS._pack_uv_table(torch.from_numpy(uvc), torch.from_numpy(tri)),
        np.asarray(JS._pack_uv_table(uvc, jnp.asarray(tri))))


def test_load_texture_equals_reference(tmp_path):
    for spec in ("checker:8", "checker:3"):
        got = tassets.load_texture(spec)
        assert got.dtype == np.float32 and got.shape[2] == 3
        np.testing.assert_array_equal(got, jassets.load_texture(spec))
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(3)
    path = str(tmp_path / "t.png")
    pil.fromarray(rng.randint(0, 256, (5, 7, 3), np.uint8)).save(path)
    got = tassets.load_texture(path)
    assert got.shape == (5, 7, 3)
    np.testing.assert_array_equal(got, jassets.load_texture(path))


def test_cli_turns_on_each_scene_extension(tmp_path, procedural_models):
    """The JAX CLI's per-scene defaults (``metal_raytracing_tpu/cli.py``
    ``cmd_render``), and a uv_test render with them on the CPU."""
    on = {"coatball": "enable_specular", "bunny_env": "env_map",
          "uv_test": "enable_textures", "glass_sphere": "enable_refraction"}
    flags = set(on.values()) | {"enable_emission"}
    parse = build_parser().parse_args
    for name in ("coatball", "bunny_env", "uv_test", "glass_sphere",
                 "dragon", "teapot", "plane_sphere"):
        cfg = render_config(parse(["render", "--scene", name]),
                            tlib.get_scene(name, 8, 8))
        assert {f for f in flags if getattr(cfg, f)} == (
            {on[name]} if name in on else set()), name
    cfg = render_config(
        parse(["render", "--specular", "--emission", "--refraction",
               "--textures", "--env-map", "--texture-filter", "bilinear",
               "--bounces", "2", "--seed", "5", "--size", "16x8"]),
        tlib.get_scene("teapot", 16, 8))
    assert all(getattr(cfg, f) for f in flags)
    assert (cfg.texture_filter, cfg.max_bounces, cfg.seed) == (
        "bilinear", 2, 5)
    assert (cfg.width, cfg.height) == (16, 8)
    out, hdr = str(tmp_path / "uv.png"), str(tmp_path / "uv.hdr")
    assert cli_main(["render", "--scene", "uv_test", "--size", "16x16",
                     "--spp", "1", "--device", "cpu", "--tracer", "torch",
                     "--no-tonemap", "--quiet", "--out", out,
                     "--hdr-out", hdr]) == 0
    assert os.path.getsize(out) > 0 and os.path.getsize(hdr) > 0


def test_cli_parity_on_the_plain_versions(capsys, procedural_models):
    """``parity`` holds the CUDA kernels against their plain versions, so
    it refuses a CPU device rather than hold the plain versions against
    themselves; it takes the JAX parity command's flags and ``--device``,
    and the per-scene shading defaults of ``render``."""
    assert cli_main(["parity", "--scene", "glass_sphere", "--size", "16x16",
                     "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "needs a CUDA device" in err, err
    parse = build_parser().parse_args
    args = parse(["parity"])
    assert (args.scene, args.size, args.spp, args.bounces, args.seed,
            args.device) == ("plane_sphere", (64, 64), 1, 3, 0, "cuda")
    for flag in (["--tracer", "torch"], ["--specular"], ["--env-map"]):
        with pytest.raises(SystemExit):
            parse(["parity"] + flag)
    capsys.readouterr()
    on = {"coatball": "enable_specular", "uv_test": "enable_textures",
          "glass_sphere": "enable_refraction"}
    for name, flag in on.items():
        cfg = render_config(parse(["parity", "--scene", name, "--bounces",
                                   "2", "--seed", "4"]),
                            tlib.get_scene(name, 8, 8))
        assert getattr(cfg, flag) and (cfg.max_bounces, cfg.seed) == (2, 4)
        assert not cfg.enable_emission and cfg.texture_filter == "nearest"
