"""Shared scene types as PyTorch tensors.

The port's counterpart of ``metal_raytracing_tpu.types``: the camera, light
and material records the renderer reads, as dataclasses of ``torch.Tensor``
(float32 / int32), and the frozen ``RenderConfig``.  Tables the reference
stores as arrays of structs (lights, materials) stay structs of arrays.

``RenderConfig`` carries only the fields the port implements.  A knob of the
JAX package's config that the port lacks (``compaction``,
``enable_specular``, ``rank_trace``, ...) is a ``TypeError`` at construction
rather than a silent no-op; ROADMAP.md lists what is still to port.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


class LightType(enum.IntEnum):
    """Light type tags (reference: ShaderTypes.h:67-74)."""

    UNUSED = 0
    SUN = 1
    SPOT = 2
    POINT = 3
    AREA = 4


@dataclasses.dataclass
class Camera:
    """Pinhole camera basis; ``right``/``up`` are pre-scaled by the image-plane
    half extents (reference: Scene.swift:40-57)."""

    position: torch.Tensor  # (3,) f32
    right: torch.Tensor  # (3,) f32
    up: torch.Tensor  # (3,) f32
    forward: torch.Tensor  # (3,) f32

    def to(self, device) -> "Camera":
        return Camera(*(getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)))


def make_camera(position=(0.0, 1.0, 5.38), right=(1.0, 0.0, 0.0),
                up=(0.0, 1.0, 0.0), forward=(0.0, 0.0, -1.0),
                fov_degrees: float = 45.0, aspect: float = 1.0) -> Camera:
    """Camera with image-plane scaled basis vectors (same float32 rounding
    as ``metal_raytracing_tpu.types.make_camera``)."""
    half_h = float(np.tan(np.radians(fov_degrees) / 2.0))
    half_w = aspect * half_h
    return Camera(
        position=_f32(position),
        right=_f32(np.asarray(right, np.float32) * np.float32(half_w)),
        up=_f32(np.asarray(up, np.float32) * np.float32(half_h)),
        forward=_f32(forward),
    )


@dataclasses.dataclass
class Light:
    """One light of any type (reference: ShaderTypes.h:76-87): one record
    with a type tag, so the light table is a rectangular struct of arrays."""

    type: torch.Tensor  # () i32, LightType value
    position: torch.Tensor  # (3,) f32
    color: torch.Tensor  # (3,) f32
    forward: torch.Tensor  # (3,) f32, area light emitter normal
    right: torch.Tensor  # (3,) f32, area light half-extent
    up: torch.Tensor  # (3,) f32, area light half-extent
    cone_angle: torch.Tensor  # () f32, spot light
    direction: torch.Tensor  # (3,) f32, spot / sun


def _light(type_, position=(0, 0, 0), color=(0, 0, 0), forward=(0, 0, 0),
           right=(0, 0, 0), up=(0, 0, 0), cone_angle=0.0,
           direction=(0, 0, 0)) -> Light:
    return Light(type=torch.tensor(int(type_), dtype=torch.int32),
                 position=_f32(position), color=_f32(color),
                 forward=_f32(forward), right=_f32(right), up=_f32(up),
                 cone_angle=_f32(cone_angle), direction=_f32(direction))


def area_light(position, forward, right, up, color) -> Light:
    """Mirrors ``Light.areaLight`` (reference: Scene.swift:71-81)."""
    return _light(LightType.AREA, position=position, color=color,
                  forward=forward, right=right, up=up)


def sun_light(direction, color) -> Light:
    """Mirrors ``Light.sunLight`` (reference: Scene.swift:83-89)."""
    return _light(LightType.SUN, direction=direction, color=color)


def point_light(position, color) -> Light:
    """Mirrors ``Light.pointLight`` (reference: Scene.swift:91-97)."""
    return _light(LightType.POINT, position=position, color=color)


def spot_light(position, direction, cone_angle, color) -> Light:
    """Mirrors ``Light.spotLight`` (reference: Scene.swift:99-107)."""
    return _light(LightType.SPOT, position=position, direction=direction,
                  cone_angle=cone_angle, color=color)


@dataclasses.dataclass
class LightTable:
    """Struct-of-arrays light table (reference: Scene.swift:32-33)."""

    type: torch.Tensor  # (L,) i32
    position: torch.Tensor  # (L, 3) f32
    color: torch.Tensor  # (L, 3) f32
    forward: torch.Tensor  # (L, 3) f32
    right: torch.Tensor  # (L, 3) f32
    up: torch.Tensor  # (L, 3) f32
    cone_angle: torch.Tensor  # (L,) f32
    direction: torch.Tensor  # (L, 3) f32

    @property
    def count(self) -> int:
        return int(self.type.shape[0])

    def to(self, device) -> "LightTable":
        return LightTable(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def pack_lights(lights: Sequence[Light]) -> LightTable:
    """Stack individual lights into the struct-of-arrays table."""
    if not lights:
        raise ValueError("scene needs at least one light")
    return LightTable(*(torch.stack([getattr(l, f.name) for l in lights])
                        for f in dataclasses.fields(Light)))


@dataclasses.dataclass(frozen=True)
class Material:
    """Host-side material record (reference: ShaderTypes.h:100-108); the
    same frozen, hashable record as ``metal_raytracing_tpu.types.Material``
    (identical materials deduplicate across instances)."""

    base_color: tuple = (0.0, 0.0, 0.0)
    specular: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    specular_exponent: float = 0.0
    refraction_index: float = 0.0
    dissolve: float = 1.0
    name: str = ""
    texture: str = ""  # textures are not ported yet (ROADMAP.md)


@dataclasses.dataclass
class MaterialTable:
    """Struct-of-arrays material table indexed by per-triangle material id."""

    base_color: torch.Tensor  # (M, 3) f32
    specular: torch.Tensor  # (M, 3) f32
    emission: torch.Tensor  # (M, 3) f32
    specular_exponent: torch.Tensor  # (M,) f32
    refraction_index: torch.Tensor  # (M,) f32
    dissolve: torch.Tensor  # (M,) f32

    @property
    def count(self) -> int:
        return int(self.base_color.shape[0])

    def to(self, device) -> "MaterialTable":
        return MaterialTable(*(getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)))


def pack_materials(materials: Sequence[Material]) -> MaterialTable:
    if not materials:
        materials = [Material(base_color=(1.0, 1.0, 1.0))]
    col = lambda name: _f32([getattr(m, name) for m in materials])
    return MaterialTable(
        base_color=col("base_color"), specular=col("specular"),
        emission=col("emission"), specular_exponent=col("specular_exponent"),
        refraction_index=col("refraction_index"), dissolve=col("dissolve"))


TRACERS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration, at the JAX package's defaults for every
    field the port carries (``metal_raytracing_tpu.types.RenderConfig``).

    ``tracer``: ``"cuda"`` runs the hand-written kernels (CUDA tensors
    only), ``"torch"`` their plain PyTorch versions on any device, and
    ``"auto"`` follows the renderer's device.  ``host_seed`` folds the
    global set's shadow occlusion into the shadow mask before the any-hit
    pass (the closest pass is always seeded on the host side; either value
    gives the same image).  ``fused_broadphase`` computes the global set's
    closest seed and shadow occlusion in the broad-phase kernel
    (``ops.broadphase_cuda.broadphase_keys``, on ``broadphase_block``
    threads per block) instead of the two plain passes; the image is the
    same.  The port runs the ``compaction=False`` wavefront, which gives the
    reference's image (the reference's compaction is a pure permutation of
    the rays)."""

    width: int = 512
    height: int = 512
    spp: int = 1
    max_bounces: int = 3
    rand_offset_bits: int = 20
    seed: int = 0
    tracer: str = "auto"
    cluster_size: int = 384
    bvh_builder: str = "sah_free"
    ray_block: int = 128
    primary_ray_block: Optional[int] = 512
    shadow_ray_block: Optional[int] = 512
    host_seed: bool = True
    fused_broadphase: bool = False
    broadphase_block: int = 256

    def __post_init__(self):
        if self.tracer not in TRACERS:
            raise ValueError(
                f"tracer must be one of {TRACERS}, got {self.tracer!r}")
        if self.broadphase_block % 32 or not 0 < self.broadphase_block <= 1024:
            raise ValueError(f"broadphase_block must be a multiple of 32 in "
                             f"[32, 1024], got {self.broadphase_block}")
