"""Scene assembly: host-side scene graph -> flat tensors on one device.

The port's counterpart of ``metal_raytracing_tpu.scene``.  All instances are
pre-transformed to world space and concatenated into one triangle table with
a per-triangle material id; the cluster BVH is built on the host (numpy) and
the kernel layouts (cluster boxes, triangle planes, shade rows) are packed
with PyTorch on the CPU, then moved to the requested device, so a scene's
tables are the same bits on every device.  Every builder of ``accel`` and
the ``max_edge_frac`` longest-edge subdivision build as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import accel, math_utils
from .assets import load_texture
from .io.obj import LoadedModel
from .ops.trace_cuda import fma, pack_scene_planes
from .types import (Camera, Light, LightTable, Material, MaterialTable,
                    area_light, make_camera, pack_lights, pack_materials,
                    spot_light)
from .utils.profiling import named_scope

__all__ = ["GeometryTable", "SceneData", "SceneSpec", "Instance", "Scene",
           "flatten_instances", "subdivide_oversized", "build_scene_data",
           "scene_data_arrays", "scene_data_from_reference"]


@dataclasses.dataclass
class GeometryTable:
    """World-space triangle table in leaf-slot order (padding slots are
    degenerate triangles with material 0); corner normals pre-gathered."""

    v0: torch.Tensor  # (T, 3) f32
    e1: torch.Tensor  # (T, 3) f32
    e2: torch.Tensor  # (T, 3) f32
    n0: torch.Tensor  # (T, 3) f32
    n1: torch.Tensor  # (T, 3) f32
    n2: torch.Tensor  # (T, 3) f32
    material_id: torch.Tensor  # (T,) i32


@dataclasses.dataclass
class SceneData:
    """Every tensor a render step reads, all on one device."""

    geometry: GeometryTable
    node_lo: torch.Tensor  # (num_nodes, 3) f32 implicit BVH AABBs
    node_hi: torch.Tensor  # (num_nodes, 3) f32
    lights: LightTable
    materials: MaterialTable
    camera: Camera
    sup_planes: torch.Tensor  # (nsp, 6) f32 super boxes
    clu_planes: torch.Tensor  # (NS, S, 6) f32 per-super cluster boxes
    tri_planes: torch.Tensor  # (12, T) f32 Baldwin-Weber triangle planes
    # Per-triangle shade rows [M(9) m0(3) kd(3) mat_id n(3) n.v0]: the affine
    # normal map ns(p) = M p + m0 (M stored by column), albedo, material id,
    # and the geometric plane the renderer recomputes exact t from.
    shade_table: torch.Tensor  # (T, 20) f32
    # Leaf slot -> source triangle (-1 padding).  With the SBVH pre-split a
    # source triangle may own several slots, whose rows are identical.
    tri_src: torch.Tensor  # (T,) i32
    clu_counts: torch.Tensor  # (NS*S,) i32 real triangles per cluster slot
    env_map: Optional[torch.Tensor] = None  # (He, We, 3) f32 or None
    # Texture extension (None when no material has a texture): per-triangle
    # affine UV rows uv(p) = A p + b packed [A00 A10 A01 A11 A02 A12 b0 b1],
    # the materials' images padded to common dims (an untextured material
    # is 1x1 white), and each material's (h, w).
    uv_table: Optional[torch.Tensor] = None  # (T, 8) f32
    tex_stack: Optional[torch.Tensor] = None  # (M, Hm, Wm, 3) f32
    tex_hw: Optional[torch.Tensor] = None  # (M, 2) i32

    @property
    def device(self) -> torch.device:
        return self.tri_planes.device


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static scene metadata."""

    bvh: accel.BVHSpec
    light_count: int
    material_count: int
    has_env_map: bool = False
    has_textures: bool = False


@dataclasses.dataclass
class Instance:
    """One placed model with its T @ R(euler xyz) @ S transform."""

    model: LoadedModel
    transform: np.ndarray  # (4, 4) f32

    @classmethod
    def place(cls, model: LoadedModel, position=(0.0, 0.0, 0.0),
              rotation=(0.0, 0.0, 0.0), scale=1.0) -> "Instance":
        return cls(model=model,
                   transform=math_utils.trs(position, rotation, scale))


def flatten_instances(instances: Sequence[Instance]):
    """Pre-transform and concatenate all instances into world-space arrays.

    Returns (v0, e1, e2, n0, n1, n2, material_id, materials, uvc), as
    ``metal_raytracing_tpu.scene.flatten_instances`` does; identical
    materials are deduplicated across instances and submeshes."""
    v0s, e1s, e2s = [], [], []
    n0s, n1s, n2s = [], [], []
    uvcs = []
    mids = []
    materials: List[Material] = []
    mat_index: dict = {}

    for inst in instances:
        m = inst.transform
        world_pos = math_utils.transform_points(m, inst.model.positions)
        world_nrm = math_utils.transform_directions(m, inst.model.normals)
        for sub in inst.model.submeshes:
            mat_id = mat_index.get(sub.material)
            if mat_id is None:
                mat_id = len(materials)
                materials.append(sub.material)
                mat_index[sub.material] = mat_id
            tp = sub.tri_pos_idx
            tn = sub.tri_norm_idx
            v0 = world_pos[tp[:, 0]]
            v0s.append(v0)
            e1s.append(world_pos[tp[:, 1]] - v0)
            e2s.append(world_pos[tp[:, 2]] - v0)
            n0s.append(world_nrm[tn[:, 0]])
            n1s.append(world_nrm[tn[:, 1]])
            n2s.append(world_nrm[tn[:, 2]])
            tu = getattr(sub, "tri_uv_idx", None)
            uvsrc = inst.model.texcoords
            if tu is not None and uvsrc is not None:
                uvcs.append(uvsrc[tu].astype(np.float32))
            else:
                uvcs.append(np.zeros((tp.shape[0], 3, 2), np.float32))
            mids.append(np.full(tp.shape[0], mat_id, np.int32))

    cat = lambda xs: np.concatenate(xs, axis=0).astype(np.float32)
    return (cat(v0s), cat(e1s), cat(e2s), cat(n0s), cat(n1s), cat(n2s),
            np.concatenate(mids), materials, cat(uvcs))


def subdivide_oversized(v0, e1, e2, n0, n1, n2, mid,
                        max_edge_frac: float = 0.1, max_rounds: int = 24):
    """Longest-edge bisection of triangles larger than ``max_edge_frac`` of
    the scene extent (``metal_raytracing_tpu.scene.subdivide_oversized``,
    line for line).  Midpoint splits with averaged corner normals leave the
    interpolated shading normal unchanged; only the clusters change."""
    a, b, c = v0, v0 + e1, v0 + e2
    scene_lo = np.minimum(np.minimum(a, b), c).min(axis=0)
    scene_hi = np.maximum(np.maximum(a, b), c).max(axis=0)
    max_edge = float((scene_hi - scene_lo).max()) * max_edge_frac
    na, nb, nc = n0, n1, n2
    for _ in range(max_rounds):
        lab = np.linalg.norm(b - a, axis=1)
        lbc = np.linalg.norm(c - b, axis=1)
        lca = np.linalg.norm(a - c, axis=1)
        longest = np.stack([lab, lbc, lca], axis=1)
        which = np.argmax(longest, axis=1)
        lmax = longest[np.arange(len(which)), which]
        over = lmax > max_edge
        if not over.any():
            break
        keep = ~over
        parts_v = [(a[keep], b[keep], c[keep])]
        parts_n = [(na[keep], nb[keep], nc[keep])]
        parts_m = [mid[keep]]
        for w, (i0, i1, i2) in enumerate(((0, 1, 2), (1, 2, 0), (2, 0, 1))):
            s = over & (which == w)
            if not s.any():
                continue
            vs = [a[s], b[s], c[s]]
            ns_ = [na[s], nb[s], nc[s]]
            vm = 0.5 * (vs[i0] + vs[i1])
            nm = 0.5 * (ns_[i0] + ns_[i1])
            # split edge (i0, i1): (v0', m, v2') and (m, v1', v2')
            parts_v.append((vs[i0], vm, vs[i2]))
            parts_n.append((ns_[i0], nm, ns_[i2]))
            parts_m.append(mid[s])
            parts_v.append((vm, vs[i1], vs[i2]))
            parts_n.append((nm, ns_[i1], ns_[i2]))
            parts_m.append(mid[s])
        a = np.concatenate([p[0] for p in parts_v])
        b = np.concatenate([p[1] for p in parts_v])
        c = np.concatenate([p[2] for p in parts_v])
        na = np.concatenate([p[0] for p in parts_n])
        nb = np.concatenate([p[1] for p in parts_n])
        nc = np.concatenate([p[2] for p in parts_n])
        mid = np.concatenate(parts_m)
    return (a.astype(np.float32), (b - a).astype(np.float32),
            (c - a).astype(np.float32), na.astype(np.float32),
            nb.astype(np.float32), nc.astype(np.float32), mid)


def _shade_table(geometry: GeometryTable, tri: torch.Tensor,
                 base_color: torch.Tensor) -> torch.Tensor:
    """(T, 20) shade rows; the barycentric corner-normal interpolation
    folded into an affine map of the hit point, ns(p) = M p + m0, with
    M = (n1-n0) (x) U + (n2-n0) (x) V and m0 = n0 + uw(n1-n0) + vw(n2-n0)
    (``metal_raytracing_tpu.scene._pack_device``)."""
    uvec, uw = tri[4:7].T, tri[7][:, None]
    vvec, vw = tri[8:11].T, tri[11][:, None]
    bn = geometry.n1 - geometry.n0
    cn = geometry.n2 - geometry.n0
    # fused multiply-adds where the JAX package's jitted build has them
    # (see ops.trace_cuda), so the rows agree bit for bit
    m_cols = [fma(bn, uvec[:, j:j + 1], cn * vvec[:, j:j + 1])
              for j in range(3)]
    m0 = fma(vw, cn, fma(uw, bn, geometry.n0))
    kd = base_color[geometry.material_id.long()]
    return torch.cat(m_cols + [m0, kd,
                               geometry.material_id[:, None].float(),
                               tri[0:4].T], dim=1)


def _pack_uv_table(uvc: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """(T, 3, 2) per-corner texcoords -> (T, 8) affine rows uv(p) = A p + b
    by the shade table's plane substitution: A[:, j] = du U[j] + dv V[j],
    b = uv0 + uw du + vw dv (``metal_raytracing_tpu.scene._pack_uv_table``,
    with its build's fused multiply-adds)."""
    uv0 = uvc[:, 0]
    du = uvc[:, 1] - uv0  # (T, 2)
    dv = uvc[:, 2] - uv0
    uvec, uw = tri[4:7].T, tri[7][:, None]
    vvec, vw = tri[8:11].T, tri[11][:, None]
    cols = [fma(du, uvec[:, j:j + 1], dv * vvec[:, j:j + 1])
            for j in range(3)]
    b = fma(vw, dv, fma(uw, du, uv0))
    return torch.cat(cols + [b], dim=1)


def _pack_textures(materials: Sequence[Material]):
    """(tex_stack (M, Hm, Wm, 3) f32, tex_hw (M, 2) i32) of the materials'
    textures, each image at the top left of its slot."""
    images = [load_texture(m.texture) if m.texture
              else np.ones((1, 1, 3), np.float32) for m in materials]
    hm = max(im.shape[0] for im in images)
    wm = max(im.shape[1] for im in images)
    stack = np.zeros((len(images), hm, wm, 3), np.float32)
    for i, im in enumerate(images):
        stack[i, :im.shape[0], :im.shape[1]] = im
    hw = np.array([im.shape[:2] for im in images], np.int32)
    return torch.from_numpy(stack), torch.from_numpy(hw)


@named_scope("scene build")
def build_scene_data(instances: Sequence[Instance], lights: Sequence[Light],
                     camera: Camera, cluster_size: int = 384,
                     branching: int = 8, env_map: Optional[np.ndarray] = None,
                     max_edge_frac: float = 0.0, builder: str = "sah_free",
                     presplit: float = 0.0, builder_alpha: float = 2.0,
                     rays: Optional[np.ndarray] = None, *,
                     device) -> Tuple[SceneData, SceneSpec]:
    """Flatten, cluster and pack a scene onto ``device``: with
    ``max_edge_frac`` the oversized triangles subdivided first
    (:func:`subdivide_oversized`), then ``accel.build_cluster_bvh`` with
    ``builder``, ``presplit``, ``builder_alpha`` and ``rays``."""
    v0, e1, e2, n0, n1, n2, mid, materials, uvc = flatten_instances(
        instances)
    has_textures = any(m.texture for m in materials)
    if max_edge_frac:
        if has_textures:  # as the JAX package refuses it
            raise ValueError(
                "max_edge_frac subdivision drops per-corner texcoords but "
                "this scene has textured materials")
        v0, e1, e2, n0, n1, n2, mid = subdivide_oversized(
            v0, e1, e2, n0, n1, n2, mid, max_edge_frac=max_edge_frac)
        uvc = np.zeros((v0.shape[0], 3, 2), np.float32)
    order, node_lo, node_hi, bvh_spec = accel.build_cluster_bvh(
        v0, e1, e2, cluster_size=cluster_size, branching=branching,
        builder=builder, presplit=presplit, builder_alpha=builder_alpha,
        rays=rays)

    # Leaf-slot permutation; padding slots (-1) become degenerate triangles.
    def permute(a: np.ndarray) -> torch.Tensor:
        out = np.zeros((order.shape[0],) + a.shape[1:], a.dtype)
        valid = order >= 0
        out[valid] = a[order[valid]]
        return torch.from_numpy(out)

    geometry = GeometryTable(v0=permute(v0), e1=permute(e1), e2=permute(e2),
                             n0=permute(n0), n1=permute(n1), n2=permute(n2),
                             material_id=permute(mid))
    light_table = pack_lights(list(lights))
    material_table = pack_materials(materials)
    node_lo_t = torch.from_numpy(node_lo)
    node_hi_t = torch.from_numpy(node_hi)
    sup, clu, tri = pack_scene_planes(geometry.v0, geometry.e1, geometry.e2,
                                      node_lo_t, node_hi_t, bvh_spec)
    shade_table = _shade_table(geometry, tri, material_table.base_color)
    nc, c = bvh_spec.num_clusters, bvh_spec.cluster_size
    clu_counts = np.zeros((clu.shape[0] * clu.shape[1],), np.int32)
    clu_counts[:nc] = (order[:nc * c].reshape(nc, c) >= 0).sum(1)
    uv_table = tex_stack = tex_hw = None
    if has_textures:
        uv_table = _pack_uv_table(permute(uvc), tri)
        tex_stack, tex_hw = _pack_textures(materials)

    to = lambda x: None if x is None else x.to(device)
    with named_scope("upload"):
        data = SceneData(
            geometry=GeometryTable(*(to(getattr(geometry, f.name))
                                     for f in dataclasses.fields(geometry))),
            node_lo=to(node_lo_t), node_hi=to(node_hi_t),
            lights=light_table.to(device),
            materials=material_table.to(device), camera=camera.to(device),
            sup_planes=to(sup), clu_planes=to(clu), tri_planes=to(tri),
            shade_table=to(shade_table),
            tri_src=to(torch.from_numpy(order.astype(np.int32))),
            clu_counts=to(torch.from_numpy(clu_counts)),
            env_map=(None if env_map is None else
                     to(torch.from_numpy(np.asarray(env_map, np.float32)))),
            uv_table=to(uv_table), tex_stack=to(tex_stack),
            tex_hw=to(tex_hw))
    spec = SceneSpec(bvh=bvh_spec, light_count=light_table.count,
                     material_count=material_table.count,
                     has_env_map=env_map is not None,
                     has_textures=has_textures)
    return data, spec


def scene_data_arrays(data: SceneData) -> Dict[str, np.ndarray]:
    """Flatten ``data`` into numpy arrays keyed ``"field"`` or
    ``"table.field"`` (``"geometry.v0"``, ``"lights.color"``, ...) — the
    key layout :func:`scene_data_from_reference` reads."""
    out: Dict[str, np.ndarray] = {}
    for f in dataclasses.fields(data):
        value = getattr(data, f.name)
        if value is None:
            continue
        if dataclasses.is_dataclass(value):
            for g in dataclasses.fields(value):
                out[f"{f.name}.{g.name}"] = (
                    getattr(value, g.name).cpu().numpy())
        else:
            out[f.name] = value.cpu().numpy()
    return out


def scene_data_from_reference(arrays: Dict[str, np.ndarray], spec,
                              device) -> Tuple[SceneData, SceneSpec]:
    """Turn a scene built by the JAX package (its ``SceneData`` flattened
    into numpy arrays under :func:`scene_data_arrays`' keys) and its
    ``SceneSpec`` into the port's, on ``device`` — so one build can feed
    both renderers."""
    def t(key: str) -> torch.Tensor:
        return torch.from_numpy(np.array(arrays[key])).to(device)

    def opt(key: str) -> Optional[torch.Tensor]:
        return t(key) if key in arrays else None

    def table(cls, prefix: str):
        return cls(*(t(f"{prefix}.{f.name}") for f in dataclasses.fields(cls)))

    data = SceneData(
        geometry=table(GeometryTable, "geometry"),
        node_lo=t("node_lo"), node_hi=t("node_hi"),
        lights=table(LightTable, "lights"),
        materials=table(MaterialTable, "materials"),
        camera=table(Camera, "camera"),
        sup_planes=t("sup_planes"), clu_planes=t("clu_planes"),
        tri_planes=t("tri_planes"), shade_table=t("shade_table"),
        tri_src=t("tri_src"), clu_counts=t("clu_counts"),
        env_map=opt("env_map"), uv_table=opt("uv_table"),
        tex_stack=opt("tex_stack"), tex_hw=opt("tex_hw"))
    bvh = accel.BVHSpec(**{f.name: getattr(spec.bvh, f.name)
                           for f in dataclasses.fields(accel.BVHSpec)})
    port_spec = SceneSpec(bvh=bvh, light_count=int(spec.light_count),
                          material_count=int(spec.material_count),
                          has_env_map=bool(spec.has_env_map),
                          has_textures=bool(spec.has_textures))
    return data, port_spec


class Scene:
    """Host-side scene: camera + lights + instances (reference
    Scene.swift:10-34).  Default lights are the reference's area light at
    the ceiling and its spotlight."""

    name = "scene"

    def __init__(self, width: int = 512, height: int = 512,
                 default_lights: bool = True):
        self.width = width
        self.height = height
        self.instances: List[Instance] = []
        self.lights: List[Light] = []
        self.env_map: Optional[np.ndarray] = None
        self.camera_position = (0.0, 1.0, 5.38)
        self.camera_right = (1.0, 0.0, 0.0)
        self.camera_up = (0.0, 1.0, 0.0)
        self.camera_forward = (0.0, 0.0, -1.0)
        self.fov_degrees = 45.0
        if default_lights:
            self.lights = [
                area_light(position=(0.0, 1.98, 0.0), forward=(0.0, -1.0, 0.0),
                           right=(0.25, 0.0, 0.0), up=(0.0, 0.0, 0.25),
                           color=(4.0, 4.0, 4.0)),
                spot_light(position=(2.0, 1.0, 4.0),
                           direction=(-1.5, -0.5, -1.5),
                           cone_angle=25.0 / 180.0 * np.pi,
                           color=(4.0, 4.0, 4.0)),
            ]

    def add_instance(self, model: LoadedModel, position=(0.0, 0.0, 0.0),
                     rotation=(0.0, 0.0, 0.0), scale=1.0) -> None:
        self.instances.append(Instance.place(model, position, rotation, scale))

    @property
    def aspect(self) -> float:
        return float(self.width) / float(self.height)

    def camera(self) -> Camera:
        return make_camera(position=self.camera_position,
                           right=self.camera_right, up=self.camera_up,
                           forward=self.camera_forward,
                           fov_degrees=self.fov_degrees, aspect=self.aspect)

    @property
    def triangle_count(self) -> int:
        return sum(i.model.triangle_count for i in self.instances)

    def build(self, cluster_size: int = 384, branching: int = 8,
              builder: str = "sah_free", presplit: float = 0.0,
              builder_alpha: float = 2.0, rays=None, *, device):
        return build_scene_data(
            self.instances, self.lights, self.camera(),
            cluster_size=cluster_size, branching=branching,
            env_map=self.env_map, builder=builder, presplit=presplit,
            builder_alpha=builder_alpha, rays=rays, device=device)
