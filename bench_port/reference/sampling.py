"""The reference's sampling: the Halton sequence, the per-pixel index
offsets, and the hemisphere maps of the reference shader.

Written after JaapWijnen/metal-raytracing ``Raytracing.metal:27-147``
(halton, ``sampleCosineWeightedHemisphere``,
``alignHemisphereWithNormal``) and ``Renderer.swift:249-274`` (a random
offset a pixel).  The offsets follow the ``jax.random.randint`` stream
that the path tracer draws them from, a Threefry-2x32 counter stream in
numpy; the Halton digits are a float32 loop, two digits a base-b^2 step.
Plain PyTorch and numpy; nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRIMES", "halton", "bounce_dim", "pixel_offsets",
           "cosine_hemisphere", "align_with_normal", "norm"]

# the first 100 primes: dimensions 0-99
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
          67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137,
          139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211,
          223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283,
          293, 307, 311, 313, 317, 331, 337, 347, 349, 353, 359, 367, 373, 379,
          383, 389, 397, 401, 409, 419, 421, 431, 433, 439, 443, 449, 457, 461,
          463, 467, 479, 487, 491, 499, 503, 509, 521, 523, 541)

# Offsets stay below 2^20 and sample indices below 2^21: every index
# below 2^22.
_INDEX_BITS = 22
_U32 = 0xFFFFFFFF


def bounce_dim(bounce: int, k: int) -> int:
    """The Halton dimension of draw ``k`` of ``bounce`` (0 light select,
    1-2 the light's surface, 3-4 the bounce direction); 0 and 1 jitter the
    pixel."""
    return 2 + 5 * bounce + k


def _base2(i: torch.Tensor) -> torch.Tensor:
    v = i.to(torch.int64) & _U32
    v = ((v & 0x55555555) << 1) | ((v >> 1) & 0x55555555)
    v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    v = ((v << 16) | (v >> 16)) & _U32
    return (v >> (32 - _INDEX_BITS)).to(torch.float32) * 2.0 ** -_INDEX_BITS


def _divmod(x, inv: float, base: float):
    q = torch.floor(x * inv)
    rem = x - q * base
    low = rem < 0.0
    q = torch.where(low, q - 1.0, q)
    rem = torch.where(low, rem + base, rem)
    high = rem >= base
    q = torch.where(high, q + 1.0, q)
    rem = torch.where(high, rem - base, rem)
    return q, rem


def halton(i: torch.Tensor, dim: int) -> torch.Tensor:
    """Radical inverse of the indices ``i`` in the base of prime ``dim``."""
    b = PRIMES[dim]
    if b == 2:
        return _base2(i)
    n_digits = int(np.ceil(np.log(1 << _INDEX_BITS) / np.log(b)))
    inv = np.float32(1.0) / np.float32(b)
    fs, f = [], np.float32(1.0)
    for _ in range(n_digits):
        f = np.float32(f * inv)
        fs.append(float(f))
    inv_b2 = float(np.float32(1.0) / np.float32(b * b))
    x = i.to(torch.float32)
    r = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    for k in range(0, n_digits, 2):
        if k + 1 < n_digits:
            x, big = _divmod(x, inv_b2, float(b * b))
            d1, d0 = _divmod(big, float(inv), float(b))
            r = r + fs[k] * d0
            r = r + fs[k + 1] * d1
        else:
            x, d0 = _divmod(x, float(inv), float(b))
            r = r + fs[k] * d0
    return r


def _threefry2x32(k1, k2, x1, x2):
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in rot[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _block(key, n: int):
    return _threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                         np.arange(n, dtype=np.uint32))


def pixel_offsets(seed: int, n: int, bits: int = 20) -> np.ndarray:
    """(n,) int32 Halton index offsets in [0, 2^bits): the stream of
    ``jax.random.randint(PRNGKey(seed), (n,), 0, 2^bits)``."""
    maxval = 1 << bits
    with np.errstate(over="ignore"):
        key = (np.uint32(0), np.uint32(seed & _U32))
        s1, s2 = _block(key, 2)
        higher = np.bitwise_xor(*_block((s1[0], s2[0]), n))
        lower = np.bitwise_xor(*_block((s1[1], s2[1]), n))
        span = np.uint32(maxval)
        mult = (1 << 16) % maxval
        mult = np.uint32(((mult * mult) & _U32) % maxval)
        offset = (higher % span) * mult + (lower % span)
    return (offset % span).astype(np.int32)


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """(N, 2) uniforms -> cosine-weighted directions about +Y."""
    phi = 2.0 * math.pi * u[..., 0]
    cos_t = torch.sqrt(u[..., 1])
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([sin_t * torch.cos(phi), cos_t,
                        sin_t * torch.sin(phi)], -1)


def align_with_normal(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Rotate +Y-hemisphere samples onto normals ``n`` by the shader's
    fixed tangent seed (0.0072, 1, 0.0034)."""
    seed = torch.tensor([0.0072, 1.0, 0.0034], dtype=n.dtype,
                        device=n.device).expand_as(n)
    right = _cross(n, seed)
    right = right / norm(right)
    forward = _cross(right, n)
    return s[..., 0:1] * right + s[..., 1:2] * n + s[..., 2:3] * forward
