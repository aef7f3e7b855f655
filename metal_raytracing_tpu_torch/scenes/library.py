"""Concrete scenes: the DragonScene of the reference plus the BASELINE.json
config ladder (plane+sphere, teapot, bunny+HDR, dragon, coatball).

The port's copy of ``metal_raytracing_tpu.scenes.library``: the same seven
constructors build the same scenes.  The port renders every scene on the
GPU: dragon, with 344 clusters, through the hierarchical kernels, the others
through the flat ones."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from ..assets import resolve_env_map, resolve_model
from ..scene import Scene
from ..types import area_light, spot_light, sun_light

__all__ = [
    "dragon_scene", "plane_sphere_scene", "teapot_scene", "bunny_env_scene",
    "coatball_scene", "uv_test_scene", "glass_sphere_scene", "SCENES",
    "get_scene",
]


def _fit(model, target: float):
    """Uniform scale factor that fits a model's largest extent to ``target``."""
    lo = model.positions.min(axis=0)
    hi = model.positions.max(axis=0)
    extent = float((hi - lo).max())
    return target / max(extent, 1e-9), lo, hi


def dragon_scene(width: int = 1024, height: int = 1024) -> Scene:
    """The reference's showcase scene: 7 instances with the default area +
    spot lights (reference: DragonScene.swift:11-33, Scene.swift:18-34)."""
    s = Scene(width, height)
    s.name = "dragon"
    s.add_instance(resolve_model("train"), position=(-0.3, 0.0, 0.4), scale=0.5)
    s.add_instance(resolve_model("dragon"), position=(0.3, 0.38, 2.5),
                   rotation=(0.0, np.pi / 2 * 1.2, 0.0), scale=1.2)
    s.add_instance(resolve_model("treefir"), position=(0.5, 0.0, -0.2), scale=0.7)
    s.add_instance(resolve_model("plane"), position=(0.0, 0.0, 0.0), scale=10.0)
    s.add_instance(resolve_model("sphere"), position=(-1.9, 0.0, 0.3), scale=1.0)
    s.add_instance(resolve_model("sphere"), position=(2.9, 0.0, -0.5), scale=2.0)
    s.add_instance(resolve_model("plane-back"), position=(0.0, 0.0, -1.5), scale=10.0)
    return s


def plane_sphere_scene(width: int = 256, height: int = 256) -> Scene:
    """BASELINE configs[0]: plane + sphere, one area light."""
    s = Scene(width, height, default_lights=False)
    s.name = "plane_sphere"
    # Light placed well above the sphere (radius 1 at y=1) so the scene is
    # actually lit: at the sphere top the falloff is 1/4 -> radiance ~2.5.
    s.lights = [area_light(position=(0.0, 4.0, 1.0), forward=(0.0, -1.0, 0.0),
                           right=(0.5, 0.0, 0.0), up=(0.0, 0.0, 0.5),
                           color=(10.0, 10.0, 10.0))]
    s.add_instance(resolve_model("plane"), position=(0.0, 0.0, 0.0), scale=10.0)
    s.add_instance(resolve_model("sphere"), position=(0.0, 1.0, 1.0), scale=1.0)
    return s


def uv_test_scene(width: int = 256, height: int = 256) -> Scene:
    """Textured-quad scene for the UV/texture extension (reference ships
    Resources/uv_test + texture PNGs but never shades them, SURVEY.md §2d).

    When the real ``uv_test.obj`` resolves from disk its material carries
    no texture (the exporter's .mtl is absent), so the sibling
    ``uv_test.png`` is attached to every material; the procedural quad
    stand-in comes with a checkerboard already attached.  Render with
    ``--textures`` / ``enable_textures=True``."""
    import dataclasses
    import os

    from ..assets import find_obj

    s = Scene(width, height, default_lights=False)
    s.name = "uv_test"
    s.lights = [area_light(position=(0.0, 2.5, 3.5), forward=(0.0, -0.5, -1.0),
                           right=(1.2, 0.0, 0.0), up=(0.0, 1.2, 0.0),
                           color=(18.0, 18.0, 18.0))]
    model = resolve_model("uv_test")
    path = find_obj("uv_test")
    if path is not None and any(
            sub.tri_uv_idx is not None and not sub.material.texture
            for sub in model.submeshes):
        png = os.path.join(os.path.dirname(path), "uv_test.png")
        if os.path.isfile(png):
            # copy before attaching: resolve_model's result is lru-cached
            model = dataclasses.replace(model, submeshes=[
                dataclasses.replace(sub, material=dataclasses.replace(
                    sub.material, texture=png))
                for sub in model.submeshes])
    scale, lo, hi = _fit(model, 2.0)
    # center the fitted model just above the floor plane
    mid_xz = (lo + hi) * 0.5 * scale
    s.add_instance(model,
                   position=(-mid_xz[0], -lo[1] * scale - 0.7, -mid_xz[2]),
                   scale=scale)
    s.add_instance(resolve_model("plane"), position=(0.0, -0.7, 0.0),
                   scale=8.0)
    return s


def glass_sphere_scene(width: int = 512, height: int = 512) -> Scene:
    """Dielectric test scene for the refraction extension
    (``--refraction`` / ``enable_refraction=True``): a glass sphere
    (Ni = 1.5, dissolve = 0.15) over a diffuse floor with a matte sphere
    behind it, so both refraction (inverted image of the back sphere)
    and Fresnel reflection (floor glints near grazing) are visible.
    The reference declares refraction as its next feature but never
    implements it (reference README.md:8; Ni carried at
    ShaderTypes.h:105)."""
    import dataclasses

    s = Scene(width, height, default_lights=False)
    s.name = "glass_sphere"
    s.lights = [area_light(position=(0.0, 4.0, 2.0), forward=(0.0, -1.0, 0.0),
                           right=(0.8, 0.0, 0.0), up=(0.0, 0.0, 0.8),
                           color=(12.0, 12.0, 12.0))]
    sphere = resolve_model("sphere")
    glass = dataclasses.replace(sphere, submeshes=[
        dataclasses.replace(sub, material=dataclasses.replace(
            sub.material, base_color=(0.99, 0.99, 0.99),
            refraction_index=1.5, dissolve=0.15))
        for sub in sphere.submeshes])
    s.add_instance(glass, position=(0.35, 0.75, 1.2), scale=0.75)
    s.add_instance(resolve_model("sphere"), position=(-1.2, 1.0, -1.2),
                   scale=1.0)
    s.add_instance(resolve_model("plane"), position=(0.0, 0.0, 0.0),
                   scale=10.0)
    return s


def teapot_scene(width: int = 512, height: int = 512) -> Scene:
    """BASELINE configs[1]: diffuse teapot, area + sun lights, shadows.

    The sun parameters reuse the reference's (commented-out) construction
    ``Light.sunLight(direction: [-1, -2, 0], color: [1,1,1])``
    (reference: Scene.swift:28)."""
    s = Scene(width, height, default_lights=False)
    s.name = "teapot"
    s.lights = [
        area_light(position=(0.0, 1.98, 0.0), forward=(0.0, -1.0, 0.0),
                   right=(0.25, 0.0, 0.0), up=(0.0, 0.0, 0.25),
                   color=(4.0, 4.0, 4.0)),
        sun_light(direction=(-1.0, -2.0, 0.0), color=(1.0, 1.0, 1.0)),
    ]
    teapot = resolve_model("teapot")
    scale, lo, _ = _fit(teapot, 2.0)
    s.add_instance(teapot, position=(0.0, -float(lo[1]) * scale, 0.5),
                   scale=scale)
    s.add_instance(resolve_model("plane"), position=(0.0, 0.0, 0.0), scale=10.0)
    return s


def bunny_env_scene(width: int = 512, height: int = 512) -> Scene:
    """BASELINE configs[2]: bunny with a spotlight + HDR environment map."""
    s = Scene(width, height, default_lights=False)
    s.name = "bunny_env"
    s.lights = [spot_light(position=(2.0, 1.0, 4.0),
                           direction=(-1.5, -0.5, -1.5),
                           cone_angle=25.0 / 180.0 * np.pi,
                           color=(4.0, 4.0, 4.0))]
    bunny = resolve_model("bunny")
    scale, lo, _ = _fit(bunny, 1.4)
    s.add_instance(bunny, position=(0.0, -float(lo[1]) * scale, 1.0),
                   scale=scale)
    s.add_instance(resolve_model("plane"), position=(0.0, 0.0, 0.0), scale=10.0)
    s.env_map = resolve_env_map("vulture_hide_4k")
    return s


def coatball_scene(width: int = 1024, height: int = 768) -> Scene:
    """BASELINE configs[4]: specular/metallic material test ball."""
    s = Scene(width, height)
    s.name = "coatball"
    coatball = resolve_model("coatball")
    scale, lo, _ = _fit(coatball, 1.6)
    s.add_instance(coatball, position=(0.0, -float(lo[1]) * scale, 1.5),
                   scale=scale)
    s.add_instance(resolve_model("plane"), position=(0.0, 0.0, 0.0), scale=10.0)
    s.add_instance(resolve_model("plane-back"), position=(0.0, 0.0, -1.5),
                   scale=10.0)
    return s


SCENES: Dict[str, Callable[..., Scene]] = {
    "dragon": dragon_scene,
    "plane_sphere": plane_sphere_scene,
    "uv_test": uv_test_scene,
    "glass_sphere": glass_sphere_scene,
    "teapot": teapot_scene,
    "bunny_env": bunny_env_scene,
    "coatball": coatball_scene,
}


def get_scene(name: str, width: int = None, height: int = None) -> Scene:
    try:
        fn = SCENES[name]
    except KeyError:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    kwargs = {}
    if width is not None:
        kwargs["width"] = width
    if height is not None:
        kwargs["height"] = height
    return fn(**kwargs)
