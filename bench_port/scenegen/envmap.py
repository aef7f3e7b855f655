"""Environment maps: generated from a file of their own, written as a
flat Radiance RGBE (``.hdr``) file.

A configuration names its map as ``"env_map": {"generator": <name>,
"height": H, "width": W}``; ``scenegen/env/<name>.py`` defines
``make(height, width) -> (H, W, 3) float32``, a lat-long map of linear
radiance (row 0 up), pure numpy and deterministic.  :func:`encode_hdr`
gives the bytes that the program's ``.hdr`` reader and the reference's
decoder both read: each texel a shared exponent ``e`` and three 8-bit
mantissas ``m``, the value ``m x 2^(e - 136)``, and 0 where ``e`` is 0.
"""

from __future__ import annotations

import numpy as np

from .models import load_generator

__all__ = ["make_env", "encode_hdr"]


def make_env(name: str, height: int, width: int) -> np.ndarray:
    """(height, width, 3) float32: the map ``scenegen/env/<name>.py``
    makes."""
    img = np.asarray(load_generator("env", name).make(height, width),
                     np.float32)
    if img.shape != (height, width, 3):
        raise ValueError(f"env generator {name!r} made {img.shape}, not "
                         f"{(height, width, 3)}")
    return img


def encode_hdr(img: np.ndarray) -> bytes:
    """A flat (not run-length encoded) Radiance RGBE file of ``img``
    (H, W, 3), each value in [0, 2^127).  The largest channel of a texel
    keeps 8 bits (its mantissa 128-255), so no texel can read as a
    run-length marker; the others are truncated."""
    img = np.asarray(img, np.float64)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"an environment map is (H, W, 3), not {img.shape}")
    if not ((img >= 0.0).all() and (img < 2.0 ** 127).all()):
        raise ValueError("an environment map lies in [0, 2^127)")
    h, w, _ = img.shape
    peak = img.max(axis=2)
    _, exp = np.frexp(peak)  # peak = f 2^exp, f in [0.5, 1)
    lit = peak >= 2.0 ** -120
    exp = np.where(lit, exp, 0)
    mant = np.floor(img * np.ldexp(1.0, 8 - exp)[..., None])
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.where(lit[..., None], np.clip(mant, 0, 255), 0)
    rgbe[..., 3] = np.where(lit, exp + 128, 0)
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)
    return head + rgbe.tobytes()
