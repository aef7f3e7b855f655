"""The reference's scene: a configuration's instances placed in world
space, with their materials, lights and camera, as float32 tensors.

Each instance's transform is ``T @ Rx @ Ry @ Rz @ S`` (``Mesh.swift:21-24``,
``Utilities.swift:113-165``), applied to positions and, as the reference
shader does, with the plain matrix to normals (``Raytracing.metal:267``).
The camera's right and up vectors are scaled by the image plane's half
extents (``Scene.swift:40-57``).  An environment map is decoded from the
same ``.hdr`` bytes the program reads (:func:`decode_hdr`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["RefScene", "build_scene", "decode_hdr"]

AREA, SPOT, POINT, SUN = 4, 2, 3, 1
_TYPES = {"area": AREA, "spot": SPOT, "point": POINT, "sun": SUN}


def _rot(axis: int, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m = np.eye(4)
    m[i, i], m[j, j] = c, c
    m[i, j], m[j, i] = (-s, s) if axis != 1 else (s, -s)
    return m.astype(np.float32)


def transform(position, rotation, scale) -> np.ndarray:
    """The (4, 4) float32 matrix ``T @ Rx @ Ry @ Rz @ S``."""
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(position, np.float32)
    rx, ry, rz = (float(np.float32(a)) for a in rotation)
    s = np.eye(4, dtype=np.float32)
    s[0, 0] = s[1, 1] = s[2, 2] = np.float32(scale)
    return t @ (_rot(0, rx) @ _rot(1, ry) @ _rot(2, rz)) @ s


@dataclasses.dataclass
class RefScene:
    """World-space triangles and their shading data, on one device."""

    v0: torch.Tensor  # (T, 3)
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor  # (T, 3) corner normals
    n1: torch.Tensor
    n2: torch.Tensor
    mat: torch.Tensor  # (T,) int64 material index
    kd: torch.Tensor  # (M, 3) base color
    ks: torch.Tensor  # (M, 3) specular color
    ke: torch.Tensor  # (M, 3) emission
    ns: torch.Tensor  # (M,) specular exponent
    ni: torch.Tensor  # (M,) index of refraction
    dissolve: torch.Tensor  # (M,) opacity: a dielectric has < 1
    lights: Dict[str, torch.Tensor]  # each (L, ...)
    cam_pos: torch.Tensor  # (3,)
    cam_right: torch.Tensor  # (3,) scaled by the half width
    cam_up: torch.Tensor  # (3,) scaled by the half height
    cam_forward: torch.Tensor  # (3,)
    width: int
    height: int
    env: Optional[torch.Tensor] = None  # (He, We, 3) lat-long radiance


def decode_hdr(data: bytes) -> np.ndarray:
    """(H, W, 3) float32 texels of a flat Radiance RGBE file: each
    channel's mantissa m and the texel's exponent e give m x 2^(e - 136),
    0 where e is 0."""
    _, _, rest = data.partition(b"\n\n")
    dims, _, body = rest.partition(b"\n")
    y, h, x, w = dims.split()
    if (y, x) != (b"-Y", b"+X"):
        raise ValueError(f"not a top-down, left-right map: {dims!r}")
    rgbe = np.frombuffer(body, np.uint8).reshape(int(h), int(w), 4)
    e = rgbe[..., 3:].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale


def _f32(x, dev):
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def build_scene(config: dict, models: Dict[str, dict], device,
                width: int = None, height: int = None,
                env_hdr: Optional[bytes] = None) -> RefScene:
    """The scene of ``config`` (its instances of ``models``, its
    environment map from the ``.hdr`` bytes ``env_hdr``), at the
    configuration's image size unless ``width`` / ``height`` are given."""
    w = width or config["width"]
    h = height or config["height"]
    v0s, e1s, e2s, n0s, n1s, n2s, mids = [], [], [], [], [], [], []
    mats: List[tuple] = []
    index: Dict[tuple, int] = {}
    for inst in config["instances"]:
        model = models[inst["model"]]
        m = transform(inst["position"], inst["rotation"], inst["scale"])
        pos = model["positions"] @ m[:3, :3].T + m[:3, 3]
        nrm = model["normals"] @ m[:3, :3].T
        for sub in model["submeshes"]:
            mt = sub["material"]
            key = (mt["base_color"], mt["specular"], mt["emission"],
                   mt["specular_exponent"], mt["refraction_index"],
                   mt["dissolve"])
            mid = index.setdefault(key, len(mats))
            if mid == len(mats):
                mats.append(key)
            tri = sub["tris"]
            a = pos[tri[:, 0]]
            v0s.append(a)
            e1s.append(pos[tri[:, 1]] - a)
            e2s.append(pos[tri[:, 2]] - a)
            n0s.append(nrm[tri[:, 0]])
            n1s.append(nrm[tri[:, 1]])
            n2s.append(nrm[tri[:, 2]])
            mids.append(np.full(len(tri), mid, np.int64))
    cat = lambda xs: _f32(np.concatenate(xs), device)
    lights = config["lights"]

    def col(name, default):
        return _f32([lt.get(name, default) for lt in lights], device)

    cam = config["camera"]
    half_h = np.float32(np.tan(np.radians(cam["fov_degrees"]) / 2.0))
    half_w = np.float32(float(w) / float(h)) * half_h
    return RefScene(
        v0=cat(v0s), e1=cat(e1s), e2=cat(e2s), n0=cat(n0s), n1=cat(n1s),
        n2=cat(n2s),
        mat=torch.as_tensor(np.concatenate(mids), device=device),
        kd=_f32([k[0] for k in mats], device),
        ks=_f32([k[1] for k in mats], device),
        ke=_f32([k[2] for k in mats], device),
        ns=_f32([k[3] for k in mats], device),
        ni=_f32([k[4] for k in mats], device),
        dissolve=_f32([k[5] for k in mats], device),
        lights={"type": torch.tensor([_TYPES[lt["type"]] for lt in lights],
                                     device=device),
                "position": col("position", (0.0, 0.0, 0.0)),
                "color": col("color", (0.0, 0.0, 0.0)),
                "forward": col("forward", (0.0, 0.0, 0.0)),
                "right": col("right", (0.0, 0.0, 0.0)),
                "up": col("up", (0.0, 0.0, 0.0)),
                "cone_angle": col("cone_angle", 0.0),
                "direction": col("direction", (0.0, 0.0, 0.0))},
        cam_pos=_f32(cam["position"], device),
        cam_right=_f32(np.asarray(cam["right"], np.float32) * half_w, device),
        cam_up=_f32(np.asarray(cam["up"], np.float32) * half_h, device),
        cam_forward=_f32(cam["forward"], device),
        width=w, height=h,
        env=None if env_hdr is None else _f32(decode_hdr(env_hdr), device))
