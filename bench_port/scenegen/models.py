"""Frozen procedural models: the meshes the benchmark's scenes are made of.

A copy, frozen with the benchmark, of the procedural stand-ins the path
tracer renders when the reference's OBJ files are absent (dragon, train,
treefir, plane, plane-back, sphere, coatball; materials after the
reference's ``.mtl`` files, JaapWijnen/metal-raytracing ``Resources/``).
Pure numpy and deterministic: a later change to the program's own
generators cannot move the yardstick.

A model is a dict: ``positions`` (V, 3) and ``normals`` (V, 3) float32,
and ``submeshes``, a list of ``{"material": {...}, "tris": (T, 3) int32}``
whose triangles index both arrays.  A material dict holds ``name``,
``base_color``, ``specular``, ``emission`` (3-tuples), ``specular_exponent``,
``refraction_index`` and ``dissolve``; a dielectric (glass) has
``refraction_index`` > 0 and ``dissolve`` < 1.

The seven meshes above are :data:`MODELS`.  A configuration that needs
another brings it as a file of its own, ``scenegen/extra/<name>.py``,
which defines ``make() -> dict`` (a model as above, pure numpy and
deterministic; :func:`material`, :func:`from_parts` and
:func:`uv_sphere` are there to build it); :func:`make_model` finds it by
the name an instance gives.
"""

from __future__ import annotations

import importlib.util
import os
import re
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["MODELS", "make_model", "material", "from_parts", "uv_sphere",
           "load_generator"]

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def material(name: str, base_color=(0.0, 0.0, 0.0), specular=(0.0, 0.0, 0.0),
             emission=(0.0, 0.0, 0.0), specular_exponent: float = 0.0,
             refraction_index: float = 0.0, dissolve: float = 1.0) -> dict:
    return {"name": name, "base_color": tuple(base_color),
            "specular": tuple(specular), "emission": tuple(emission),
            "specular_exponent": float(specular_exponent),
            "refraction_index": float(refraction_index),
            "dissolve": float(dissolve)}


def _smooth_vertex_normals(pos: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted smooth per-vertex normals."""
    n = np.zeros_like(pos)
    if len(tris):
        t = tris.astype(np.int64)
        v0, v1, v2 = pos[t[:, 0]], pos[t[:, 1]], pos[t[:, 2]]
        face_n = np.cross(v1 - v0, v2 - v0)  # magnitude ~ 2 * area
        for c in range(3):
            np.add.at(n, t[:, c], face_n)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(lens, 1e-20)).astype(np.float32)


def from_parts(parts: Sequence[Tuple[dict, np.ndarray, np.ndarray]]) -> dict:
    """One model from (material, positions (V, 3), tris (T, 3)) parts that
    share one vertex array, with smooth synthesized normals."""
    all_pos: List[np.ndarray] = []
    offsets = []
    total = 0
    for _, pos, _ in parts:
        offsets.append(total)
        all_pos.append(pos.astype(np.float32))
        total += pos.shape[0]
    positions = np.concatenate(all_pos, axis=0)
    subs = [{"material": mat, "tris": (tris + off).astype(np.int32)}
            for (mat, _, tris), off in zip(parts, offsets)]
    every = np.concatenate([s["tris"] for s in subs], axis=0)
    return {"positions": positions,
            "normals": _smooth_vertex_normals(positions, every),
            "submeshes": subs}


def uv_sphere(segments: int = 50, rings: int = 50,
              radius: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """A UV sphere of radius ``radius`` about the origin, the layout of
    the reference's ``sphere.obj`` (a 50 x 50 Blender UV sphere)."""
    th = np.linspace(0.0, np.pi, rings + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    pos = np.stack([
        radius * np.sin(tt) * np.sin(pp),
        radius * np.cos(tt),
        -radius * np.sin(tt) * np.cos(pp),
    ], axis=-1).reshape(-1, 3)
    tris = []
    for i in range(rings):
        for j in range(segments):
            a = i * segments + j
            b = i * segments + (j + 1) % segments
            c = (i + 1) * segments + (j + 1) % segments
            d = (i + 1) * segments + j
            if i > 0:
                tris.append((a, b, c))
            if i < rings - 1:
                tris.append((a, c, d))
    return pos.astype(np.float32), np.asarray(tris, np.int32)


def _box(center, size) -> Tuple[np.ndarray, np.ndarray]:
    cx, cy, cz = center
    sx, sy, sz = (s / 2.0 for s in size)
    corners = np.array([
        [cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
        [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
        [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
        [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz],
    ], np.float32)
    quads = [(0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7), (1, 5, 6, 2),
             (3, 2, 6, 7), (4, 5, 1, 0)]
    tris = []
    for q in quads:
        tris.append((q[0], q[1], q[2]))
        tris.append((q[0], q[2], q[3]))
    return corners, np.asarray(tris, np.int32)


def _cylinder(center, radius, height, segments=24, bottom_cap=True):
    cx, cy, cz = center
    ph = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([cx + radius * np.cos(ph), np.zeros_like(ph),
                     cz + radius * np.sin(ph)], axis=-1)
    pos = [ring + np.array([0, cy, 0]), ring + np.array([0, cy + height, 0]),
           np.array([[cx, cy, cz], [cx, cy + height, cz]], np.float32)]
    n = 2 * segments
    tris = []
    for j in range(segments):
        a, b = j, (j + 1) % segments
        tris += [(a, b, segments + b), (a, segments + b, segments + a)]
    for j in range(segments):
        a, b = j, (j + 1) % segments
        if bottom_cap:
            tris.append((b, a, n))
        tris.append((segments + a, segments + b, n + 1))  # top cap
    return (np.concatenate(pos, 0).astype(np.float32),
            np.asarray(tris, np.int32))


def _cone(center, radius, height, segments=24):
    cx, cy, cz = center
    ph = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([cx + radius * np.cos(ph), np.full_like(ph, cy),
                     cz + radius * np.sin(ph)], axis=-1)
    pos = np.concatenate(
        [ring, [[cx, cy + height, cz], [cx, cy, cz]]], 0).astype(np.float32)
    apex, base = segments, segments + 1
    tris = []
    for j in range(segments):
        a, b = j, (j + 1) % segments
        tris.append((a, apex, b))
        tris.append((b, base, a))
    return pos, np.asarray(tris, np.int32)


def _plane() -> dict:
    # plane.obj: a unit quad at y = 0 facing +Y; plane.mtl Kd 0.5
    pos = np.array([[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]],
                   np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    mat = material("None", base_color=(0.5, 0.5, 0.5), specular_exponent=30.0,
                   refraction_index=1.0)
    return from_parts([(mat, pos, tris)])


def _plane_back() -> dict:
    # plane-back.obj: a near-vertical backdrop; plane-back.mtl Kd (1, 1,
    # 0.5), Ks 0.8
    pos = np.array([[-1, 0, 0], [1, 0, 0],
                    [-1, 1.999695, 0.034905], [1, 1.999695, 0.034905]],
                   np.float32)
    tris = np.array([[0, 1, 3], [0, 3, 2]], np.int32)
    mat = material("None", base_color=(1.0, 1.0, 0.5),
                   specular=(0.8, 0.8, 0.8), specular_exponent=32.0)
    return from_parts([(mat, pos, tris)])


def _sphere() -> dict:
    pos, tris = uv_sphere(50, 50, 1.0)
    mat = material("None", base_color=(0.8, 0.8, 0.8), specular_exponent=32.0)
    return from_parts([(mat, pos, tris)])


def _treefir() -> dict:
    # a fir ~2.2 tall on y = 0: trunk and three cone tiers, two materials
    bark = material("bark", base_color=(0.35, 0.2, 0.1))
    leaves = material("leaves", base_color=(0.05, 0.35, 0.08))
    trunk = _cylinder((0, 0, 0), 0.08, 0.5, segments=12)
    tiers = [_cone((0, 0.35, 0), 0.55, 0.8, segments=20),
             _cone((0, 0.85, 0), 0.42, 0.7, segments=20),
             _cone((0, 1.35, 0), 0.28, 0.85, segments=20)]
    tier_tris = []
    off = 0
    for p, t in tiers:
        tier_tris.append(t + off)
        off += p.shape[0]
    return from_parts([
        (bark,) + trunk,
        (leaves, np.concatenate([p for p, _ in tiers], axis=0),
         np.concatenate(tier_tris, axis=0)),
    ])


def _train() -> dict:
    # a toy train ~2.4 long on y = 0 with six materials
    body = material("body", base_color=(0.7, 0.12, 0.1))
    cab = material("cab", base_color=(0.15, 0.3, 0.6))
    chimney = material("chimney", base_color=(0.2, 0.2, 0.2))
    wheels = material("wheels", base_color=(0.1, 0.1, 0.1))
    trim = material("trim", base_color=(0.9, 0.8, 0.2))
    cow = material("cowcatcher", base_color=(0.6, 0.6, 0.6))
    parts = [(body,) + _box((-0.45, 0.5, 0), (1.1, 0.55, 0.55)),
             (cab,) + _box((0.55, 0.7, 0), (0.7, 0.95, 0.6)),
             (trim,) + _box((0.55, 1.22, 0), (0.8, 0.08, 0.7)),
             (chimney,) + _cylinder((-0.75, 0.77, 0), 0.09, 0.45,
                                    segments=14)]
    for wx in (-0.65, -0.1, 0.45):
        for wz in (-0.3, 0.3):
            parts.append((wheels,) + _cylinder((wx, 0.0, wz), 0.18, 0.08,
                                               segments=16))
    parts.append((cow,) + _cone((-1.05, 0.15, 0), 0.2, 0.35, segments=10))
    return from_parts(parts)


def _dragon() -> dict:
    """The ~100k-triangle stand-in of dragon.obj: a closed displaced
    ellipsoid; dragon.mtl's Kd red, Ks 0.2, Ns 37.25."""
    pos, tris = uv_sphere(224, 224, 0.5)
    rng = np.random.RandomState(42)
    freqs = rng.normal(size=(12, 3)) * np.array([6.0, 9.0, 6.0])
    phases = rng.uniform(0, 2 * np.pi, size=12)
    amps = 0.22 / (1.0 + np.arange(12.0)) ** 0.7
    disp = np.zeros(pos.shape[0], np.float64)
    for f, ph, a in zip(freqs, phases, amps):
        disp += a * np.sin(pos @ f + ph)
    pos = pos * (1.0 + 0.35 * disp[:, None])
    pos = pos * np.array([1.5, 0.8, 0.9], np.float32)
    pos[:, 1] -= pos[:, 1].min()
    mat = material("Dragon", base_color=(1.0, 0.0, 0.0),
                   specular=(0.2, 0.2, 0.2), specular_exponent=37.254902,
                   refraction_index=1.0)
    return from_parts([(mat, pos.astype(np.float32), tris)])


def _coatball() -> dict:
    # coatball.obj's stand-in: a glossy ball on a faintly glowing base
    coat = material("coat", base_color=(0.9, 0.55, 0.1),
                    specular=(0.9, 0.9, 0.9), specular_exponent=200.0)
    base = material("base", base_color=(0.2, 0.2, 0.22),
                    emission=(0.25, 0.1, 0.05))
    ball_p, ball_t = uv_sphere(80, 80, 0.5)
    ball_p[:, 1] += 0.62
    # no bottom cap: it would lie in the floor's plane, where exact ties
    # between two surfaces make the answer depend on the tie-break
    base_p, base_t = _cylinder((0, 0, 0), 0.45, 0.12, segments=32,
                               bottom_cap=False)
    return from_parts([(coat, ball_p, ball_t), (base, base_p, base_t)])


MODELS: Dict[str, Callable[[], dict]] = {
    "plane": _plane,
    "plane-back": _plane_back,
    "sphere": _sphere,
    "treefir": _treefir,
    "train": _train,
    "dragon": _dragon,
    "coatball": _coatball,
}


def load_generator(folder: str, name: str):
    """The module ``scenegen/<folder>/<name>.py``: a generator that a
    configuration brings as a file of its own."""
    path = os.path.join(HERE, folder, f"{name}.py")
    if not (NAME.match(name) and os.path.isfile(path)):
        raise KeyError(f"no generator {name!r}: scenegen/{folder}/{name}.py "
                       f"is not there")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_scenegen_{folder}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_model(name: str) -> dict:
    """The named model (deterministic): one of :data:`MODELS`, else the
    one ``scenegen/extra/<name>.py`` makes."""
    if name in MODELS:
        return MODELS[name]()
    return load_generator("extra", name).make()
