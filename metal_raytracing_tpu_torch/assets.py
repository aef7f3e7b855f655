"""Asset resolution: locate OBJ files or fall back to procedural stand-ins.

The reference loads assets strictly from its app bundle via ModelIO
(reference: Model.swift:14-16).  Here, models resolve through a search path —
``$MRT_RESOURCES``, then the repo's ``assets/`` directory — and fall back to
the deterministic procedural generators in :mod:`.io.procedural`, so every
scene renders on a machine with no assets at all.  The port's copy of
``metal_raytracing_tpu.assets``; point ``$MRT_RESOURCES`` at an asset mirror
to load the real OBJ files (through the native parser, ``io/native.py``,
unless ``$MRT_NO_NATIVE`` is set).  Textures are ``"checker:N"`` procedural
checkerboards (what the procedural stand-ins carry) or image files, which
need PIL.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np

from .io import procedural
from .io.obj import LoadedModel, load_obj

__all__ = ["search_paths", "find_obj", "resolve_model", "resolve_env_map",
           "load_texture"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def search_paths() -> List[str]:
    paths = []
    env = os.environ.get("MRT_RESOURCES")
    if env:
        paths.extend(env.split(os.pathsep))
    paths.append(os.path.join(_REPO_ROOT, "assets"))
    return [p for p in paths if os.path.isdir(p)]


def find_obj(name: str) -> Optional[str]:
    """Find ``name.obj`` (or ``name/name.obj``) along the search path."""
    for root in search_paths():
        for rel in (f"{name}.obj", os.path.join(name, f"{name}.obj")):
            path = os.path.join(root, rel)
            if os.path.isfile(path):
                return path
    return None


@functools.lru_cache(maxsize=None)
def resolve_model(name: str, prefer_file: bool = True) -> LoadedModel:
    """Load ``name`` from disk if available, else generate procedurally."""
    if prefer_file:
        path = find_obj(name)
        if path is not None:
            return load_obj(path)
    return procedural.make_model(name)


def resolve_env_map(name: str = "vulture_hide_4k") -> np.ndarray:
    """Load the named .hdr along the search path, else a procedural sky."""
    for root in search_paths():
        path = os.path.join(root, f"{name}.hdr")
        if os.path.isfile(path):
            from .io.image import read_hdr

            return read_hdr(path)
    return procedural.procedural_env_map()


@functools.lru_cache(maxsize=None)
def load_texture(spec: str) -> np.ndarray:
    """Decode a ``Material.texture`` spec into an (H, W, 3) float32 linear
    image in [0, 1], as ``metal_raytracing_tpu.assets.load_texture`` does.

    ``spec`` is ``"checker:N"`` (an N x N-cell checkerboard of 8-pixel
    cells, the no-assets fallback) or an image path, decoded through PIL;
    8-bit images count as sRGB and are linearized with gamma 2.2."""
    if spec.startswith("checker:"):
        n = max(1, int(spec.split(":", 1)[1]))
        cells = 2 * n
        px = 8  # pixels per cell
        yy, xx = np.mgrid[0:cells * px, 0:cells * px]
        check = ((yy // px + xx // px) % 2).astype(np.float32)
        img = np.stack([0.1 + 0.8 * check,  # dark/light squares
                        0.1 + 0.6 * check,
                        0.4 - 0.3 * check], axis=-1)
        return np.clip(img, 0.0, 1.0)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"texture {spec!r} needs PIL, which is unavailable") from e
    with Image.open(spec) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return arr ** 2.2
