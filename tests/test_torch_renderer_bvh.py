"""The port's renderer on the exact tracers (``tracer="bvh"`` and
``"bruteforce"``) against the JAX renderer's ``tracer="bvh"``, on the CPU.

One JAX build of each scene (procedural stand-ins) feeds both renderers at
32x32, 1 sample, 3 bounces; the port runs the plain packet walk of
``ops.trace``.  The gate is the reference's golden gate
(``tests/test_golden.py``: RMSE < 1e-3, max pixel difference < 5e-2).

The reference image is the JAX package's own path off a TPU:
``tracer="bvh"`` with its default ``compaction=True`` (the ``dir_major``
bounce key and the light-major shadow key).  The port is held against it
with ``compaction=True`` and, on plane_sphere, with ``compaction=False``
too (compaction permutes the rays: the JAX package holds its two images to
1e-7, ``tests/test_renderer.py``).  The exact path's other checks (the
brute force, the cluster passes it skips, the CLI) are in
``tests/test_torch_trace_bvh.py``.  coatball renders with its specular lobe
only: emission would light the base-on-floor tie that float rounding can
give to either surface (ROADMAP.md, Queue 3 item 5).  dragon's bvh image
is held in ``tests/test_torch_dragon.py``, against the JAX render that
file already makes.

Run as a script, this file renders every in-repo scene with its CLI
shading flags through both exact tracers under both ``compaction``
settings and prints each image's distance to the JAX ``bvh`` image.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest

from metal_raytracing_tpu import renderer as JR
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (GATE_MAX, GATE_RMSE,  # noqa: F401
                               assert_image_gate, build_both,
                               few_torch_threads)

W = H = 32
# scene -> the shading flags of the reference image
SCENES = {"plane_sphere": {}, "coatball": dict(enable_specular=True)}


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec), each built on
    first use."""
    cache = {}

    def get(scene):
        if scene not in cache:
            cache[scene] = build_both(scene, W, H)
        return cache[scene]

    return get


def reference_image(jdata, jspec, w, h, **flags):
    """(image, stats) of the JAX renderer's tracer="bvh" at its default
    compaction=True, one sample."""
    jcfg = JConfig(width=w, height=h, tracer="bvh", **flags)
    img, stats = JR.render_sample(jdata, jspec, jcfg,
                                  JR.make_pixel_offsets(jcfg), jnp.int32(0))
    return np.asarray(img), {k: int(v) for k, v in stats.items()}


def port_image(tdata, tspec, w, h, tracer="bvh", **kw):
    cfg = RenderConfig(width=w, height=h, tracer=tracer, **kw)
    img, stats = R.render_sample(tdata, tspec, cfg, R.make_pixel_offsets(cfg),
                                 0, tracer=R.resolve_tracer(cfg, "cpu"))
    return img.numpy(), {k: int(v) for k, v in stats.items()}


_REFS = {}


def reference(scenes, scene):
    if scene not in _REFS:
        jdata, jspec, _, _ = scenes(scene)
        _REFS[scene] = reference_image(jdata, jspec, W, H, **SCENES[scene])
    return _REFS[scene]


@pytest.mark.parametrize("scene,compaction", [
    ("plane_sphere", True), ("plane_sphere", False), ("coatball", True)])
def test_bvh_image_matches_reference(scenes, scene, compaction):
    _, _, tdata, tspec = scenes(scene)
    ref, jstats = reference(scenes, scene)
    img, stats = port_image(tdata, tspec, W, H, compaction=compaction,
                            **SCENES[scene])
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.max() > 0.01
    assert_image_gate(img, ref, f"{scene} bvh compaction={compaction} "
                      "against JAX bvh")
    assert stats["closest_rays"] == jstats["closest_rays"]


def every_scene(size=32):
    """Every in-repo scene with its CLI shading flags, through both exact
    tracers under both compaction settings, against the JAX bvh image;
    prints one line per image and returns the worst (RMSE, max)."""
    from metal_raytracing_tpu_torch.cli import build_parser, render_config
    from metal_raytracing_tpu_torch.scenes import SCENES as ALL
    from metal_raytracing_tpu_torch.scenes import get_scene

    worst = (0.0, 0.0)
    for scene in sorted(ALL):
        jdata, jspec, tdata, tspec = build_both(scene, size, size)
        args = build_parser().parse_args(["render", "--scene", scene,
                                          "--size", f"{size}x{size}"])
        cfg = render_config(args, get_scene(scene, size, size))
        flags = {f: getattr(cfg, f) for f in (
            "env_map", "enable_specular", "enable_emission",
            "enable_textures", "enable_refraction", "texture_filter")}
        ref, _ = reference_image(jdata, jspec, size, size, **flags)
        for tracer in ("bvh", "bruteforce"):
            for compaction in (True, False):
                img, _ = port_image(tdata, tspec, size, size, tracer,
                                    compaction=compaction, **flags)
                diff = np.abs(img.astype(np.float64) - ref)
                err = (float(np.sqrt((diff ** 2).mean())), float(diff.max()))
                ok = err[0] < GATE_RMSE and err[1] < GATE_MAX
                print(f"{scene} {size}x{size} {tracer} compaction="
                      f"{compaction}: RMSE {err[0]:.3e} max {err[1]:.3e} "
                      f"{'ok' if ok else 'OVER THE GATE'}", flush=True)
                worst = (max(worst[0], err[0]), max(worst[1], err[1]))
    return worst


if __name__ == "__main__":
    rmse_, max_ = every_scene()
    print(f"worst RMSE {rmse_:.3e}, worst max {max_:.3e} (gate "
          f"{GATE_RMSE}, {GATE_MAX})")
    sys.exit(0 if rmse_ < GATE_RMSE and max_ < GATE_MAX else 1)
