"""Shared scene types as PyTorch tensors.

The port's counterpart of ``metal_raytracing_tpu.types``: the camera, light
and material records the renderer reads, as dataclasses of ``torch.Tensor``
(float32 / int32), and the frozen ``RenderConfig``.  Tables the reference
stores as arrays of structs (lights, materials) stay structs of arrays.

``RenderConfig`` carries only the fields the port implements.  A knob of the
JAX package's config that the port lacks (``live_widths``,
``carry_seed``, ...: ROADMAP.md's list of what is deliberately not ported)
is a ``TypeError`` at construction rather than a silent no-op,
and a value the port does not carry for a knob it has (a ``rank_trace``
depth, an unknown ``tracer``) a ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np
import torch

from .accel import BUILDERS


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
    texture: str = ""  # assets.load_texture spec: a path or "checker:N"


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


TRACERS = ("auto", "cuda", "torch", "bvh", "bruteforce")
TEXTURE_FILTERS = ("nearest", "bilinear")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration, at the JAX package's defaults for every
    field the port carries (``metal_raytracing_tpu.types.RenderConfig``).

    ``tracer``: ``"cuda"`` runs the hand-written cluster kernels (CUDA
    tensors only), ``"torch"`` their plain PyTorch versions on any device,
    and ``"auto"`` follows the renderer's device (``cuda`` on a CUDA
    device, ``torch`` elsewhere; the JAX package's ``auto`` means ``bvh``
    off a TPU).  ``"bvh"`` and ``"bruteforce"`` are the JAX package's exact
    tracers (``ops.trace``): the BVH walk, through ``closest_bvh_kernel`` /
    ``any_bvh_kernel`` on a CUDA device and their plain packet versions on
    the CPU, and the brute-force oracle, plain PyTorch on any device.  They
    test the global set themselves and return the exact hit distance, so
    the renderer takes the JAX package's non-Pallas path with them: no
    host-side global passes, the ``dir_major`` bounce key and the
    light-major shadow key under ``compaction``, and ``fused_broadphase``,
    ``cluster_miss_fold``, ``pair_broadphase`` and ``rank_trace`` silently
    off.  ``host_seed`` folds the
    global set's shadow occlusion into the shadow mask before the any-hit
    pass (the closest pass is always seeded on the host side; either value
    gives the same image).  ``fused_broadphase`` computes the global set's
    closest seed and shadow occlusion in the broad-phase kernel
    (``ops.broadphase_cuda.broadphase_keys``, on ``broadphase_block``
    threads per block) instead of the two plain passes; the image is the
    same.

    ``bake_primary`` traces the primary pass (every ray leaves the camera)
    against tables with the camera's position moved into them
    (``ops.trace_cuda.bake_origin``), through the hierarchical closest
    kernel's baked-origin form, which drops every origin term; flat scenes
    and the exact tracers ignore it.  The image is the same up to the
    ~1-ulp re-association of the barycentrics.

    ``compaction`` permutes the rays of bounces >= 1 so live rays pack
    together (a pure permutation: the image is unchanged).  With
    ``sort_bounces`` the bounce rays are sorted by one key, the JAX
    renderer's ``cluster2`` layout: the id of the nearest slab-hit cluster
    from the exact broad phase (``ops.broadphase_cuda.nearest_cluster``,
    or K5's keys under ``fused_broadphase``), the second nearest's id
    below it, a 64-cone direction, then the origin's Morton code.  The exact tracers and builds above 4,095 padded clusters
    take the ``dir_major`` key instead: the octant, then Morton.
    ``sort_pack_f16`` carries the throughput and radiance through each
    bounce sort as f16 pairs packed in int32 words (one gather of three
    words in place of six floats): the only sort knob that changes the
    image, by rounding those six values to f16 once a sort.  Without
    ``sort_bounces`` live rays are only partitioned to the front, in stable
    order.  ``cluster_miss_fold`` keeps rays whose nearest cluster is
    entered beyond their global-set hit (or that overlap no cluster) out of
    the closest kernel: they sort into one group and take the host-side
    global hit.  ``shadow_sort`` re-sorts the shadow rays of bounces >= 1
    by (nearest cluster of the segment, light, origin Morton) and drops
    segments that overlap no cluster; at the last bounce the key is the
    hit triangle's own cluster and the fold tests the super boxes.
    ``pair_broadphase`` computes a bounce's shadow key and the next
    bounce's sort keys in one sweep over their shared origins
    (``nearest_cluster_pair``).  ``rank_trace=2`` hands the sorted bounce
    passes to the rank-directed closest kernel (``ops.rank_cuda
    .trace_closest_rank``): each ray's two nearest candidate clusters ride
    the sort as packed keys, the walk tests only those, a certificate
    against the third-nearest entry decides which rays are resolved, and
    the rest go to the hierarchical kernel seeded with the walk's best; it
    is silently off on flat scenes and wherever the sort emits no rank keys
    (as in the JAX package).

    The shading extensions go beyond the reference's diffuse shading, each
    as in the JAX package: ``enable_specular`` picks per ray between the
    diffuse lobe and a Phong lobe about the mirror direction (Ks/Ns),
    ``enable_emission`` adds the hit material's Ke, ``env_map`` lights
    escaped rays from the scene's lat-long map, ``enable_textures``
    modulates the albedo by the material's texture (``texture_filter``
    ``"nearest"`` or ``"bilinear"``), and ``enable_refraction`` sends a
    (1 - dissolve) share of the rays that hit a dielectric (Ni > 0,
    dissolve < 1) through it by Snell and Schlick, which also turns the
    pair sweep off (shadow and bounce origins differ).

    The scene build: ``bvh_builder`` names the leaf clustering of
    ``accel.build_cluster_bvh`` (``BUILDERS``), ``bvh_alpha`` is
    ``sah_chunk``'s per-visit cost in 128-slot chunk tests and
    ``bvh_presplit`` the SBVH-style reference pre-split budget (extra
    references as a share of the triangles; 0 is off).  ``chunk_skip``
    hands the kernels each cluster's real triangle count, so a partly full
    cluster's leaf test stops at its last real slot (only where the build
    marks ``partial_clusters``; the image is the same).

    Telemetry: ``telemetry`` adds to the render stats, per bounce b, the
    live rays entering it (``live_b{b}``), its shadow rays
    (``shadow_b{b}``) and the occluded ones (``shadow_occn_b{b}``), and
    for the cluster tracers the clusters each ray dense-tested
    (``visits_b{b}``, ``shadow_visits_b{b}``; (N,) int32 per ray, in the
    pass's ray order, where the JAX package counts per 128-ray tile).
    ``export_rays = k`` adds every k-th closest ray (``rays_b{b}``) and
    shadow segment (``srays_b{b}``) as (M, 8) rows ``[ox oy oz dx dy dz
    max_t live]``, the sample the ``sah_rays`` builder reads
    (``Renderer.refine``).  Neither changes the image.

    ``samples_per_dispatch``: the samples ``Renderer.step`` renders by
    default, 0 for the JAX package's auto tiers (8 for images up to 256x256
    pixels, 4 up to 512x512, else 2).  On a CUDA device the renderer runs
    them as one CUDA graph replay where ``renderer.graphs_apply`` allows;
    the image is the same.

    Every default is the JAX package's but one: ``compaction`` is False
    here.  On a CUDA device the sort keys' exact broad phase is one kernel
    (``nearest_cluster_kernel``); with it, the compaction path runs about
    as fast as the ``compaction=False`` path with K5's keys
    (``fused_broadphase=True``) and slower without them (PERF.md has the
    measurement, ROADMAP.md the conditions that flip the default)."""

    width: int = 512
    height: int = 512
    spp: int = 1
    max_bounces: int = 3
    rand_offset_bits: int = 20
    seed: int = 0
    tracer: str = "auto"
    cluster_size: int = 384
    bvh_builder: str = "sah_free"
    bvh_alpha: float = 2.0
    chunk_skip: bool = False
    bvh_presplit: float = 0.0
    ray_block: int = 128
    primary_ray_block: Optional[int] = 512
    shadow_ray_block: Optional[int] = 512
    host_seed: bool = True
    bake_primary: bool = False
    fused_broadphase: bool = False
    broadphase_block: int = 256
    compaction: bool = False
    sort_bounces: bool = True
    sort_pack_f16: bool = False
    cluster_miss_fold: bool = True
    shadow_sort: bool = True
    pair_broadphase: bool = True
    rank_trace: int = 0
    enable_specular: bool = False
    enable_emission: bool = False
    enable_refraction: bool = False
    enable_textures: bool = False
    texture_filter: str = "nearest"
    env_map: bool = False
    samples_per_dispatch: int = 0
    telemetry: bool = False
    export_rays: int = 0

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def __post_init__(self):
        if self.tracer not in TRACERS:
            raise ValueError(
                f"tracer must be one of {TRACERS}, got {self.tracer!r}")
        if self.rank_trace not in (0, 2):
            raise ValueError("rank_trace takes 0 (off) or 2 (two candidate "
                             f"clusters a ray), got {self.rank_trace!r}")
        if self.texture_filter not in TEXTURE_FILTERS:
            raise ValueError(f"texture_filter must be one of "
                             f"{TEXTURE_FILTERS}, got {self.texture_filter!r}")
        if self.bvh_builder not in BUILDERS:
            raise ValueError(f"bvh_builder must be one of {BUILDERS}, "
                             f"got {self.bvh_builder!r}")
        if self.samples_per_dispatch < 0:
            raise ValueError(f"samples_per_dispatch is a count >= 0 (0: "
                             f"auto), got {self.samples_per_dispatch}")
        if self.export_rays < 0:
            raise ValueError(f"export_rays is a stride >= 0, got "
                             f"{self.export_rays}")
        if self.broadphase_block % 32 or not 0 < self.broadphase_block <= 1024:
            raise ValueError(f"broadphase_block must be a multiple of 32 in "
                             f"[32, 1024], got {self.broadphase_block}")
