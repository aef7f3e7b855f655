"""A clear sky over a dark ground, with a sun: a lat-long map of linear
radiance, row 0 straight up, the shape of an outdoor HDR probe.  The sky
brightens toward the zenith; the sun, 40 times the sky, stands 36 degrees
above the horizon at u = 0.3 and spans about 6 degrees."""

import numpy as np


def make(height: int, width: int) -> np.ndarray:
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    up = np.cos(vv * np.pi)  # the y of the texel's direction
    sky = np.stack([0.35 + 0.25 * up, 0.45 + 0.35 * up, 0.9 + 0.1 * up], -1)
    ground = np.array([0.18, 0.15, 0.12])
    img = np.where(up[..., None] > 0.0, sky, ground)
    d2 = (uu - 0.3) ** 2 + (vv - 0.3) ** 2
    img = img + np.exp(-d2 / 0.001)[..., None] * np.array([30.0, 27.0, 22.0])
    return img.astype(np.float32)
