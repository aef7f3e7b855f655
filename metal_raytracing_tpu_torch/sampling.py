"""Low-discrepancy sampling: Halton sequence and hemisphere mapping.

The port's counterpart of ``metal_raytracing_tpu.sampling``
(reference: MetalRaytracing/Raytracing.metal:27-147).  ``halton`` is bit for
bit the JAX package's: the base-2 dimension by bit reversal, every other
base by the same paired-digit float32 loop.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# First 100 primes (reference: Raytracing.metal:27-33).
PRIMES = np.array([
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
    157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
    239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313, 317,
    331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397, 401, 409, 419,
    421, 431, 433, 439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499, 503,
    509, 521, 523, 541,
], dtype=np.int32)

# Halton indices (offset < 2^20 plus the sample index) stay below 2^22; the
# float32 digit loop relies on it (see metal_raytracing_tpu.sampling).
_MAX_INDEX_BITS = 22
_MAX_INDEX = 1 << _MAX_INDEX_BITS
_U32 = 0xFFFFFFFF


def _halton_base2(i: torch.Tensor) -> torch.Tensor:
    """Base-2 radical inverse by 32-bit reversal, done in int64 with the
    upper half masked off (torch has no general uint32 shifts)."""
    v = i.to(torch.int64) & _U32
    v = ((v & 0x55555555) << 1) | ((v >> 1) & 0x55555555)
    v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    v = ((v << 16) | (v >> 16)) & _U32
    v = v >> (32 - _MAX_INDEX_BITS)
    return v.to(torch.float32) * (2.0 ** -_MAX_INDEX_BITS)


def _divmod_f32(x, inv: float, base: float):
    """Floor-divide exact float32 integers by ``base`` through a multiply
    by its rounded reciprocal, with a one-step correction either way."""
    q = torch.floor(x * inv)
    rem = x - q * base
    low = rem < 0.0
    q = torch.where(low, q - 1.0, q)
    rem = torch.where(low, rem + base, rem)
    high = rem >= base
    q = torch.where(high, q + 1.0, q)
    rem = torch.where(high, rem - base, rem)
    return q, rem


def halton(i: torch.Tensor, d: int) -> torch.Tensor:
    """Radical inverse of index tensor ``i`` in the base of the d'th prime
    (reference: Raytracing.metal:41-56): float32 accumulation of one
    ``f_k * digit_k`` per digit, two digits per base-b^2 division."""
    b = int(PRIMES[d])
    if b == 2:
        return _halton_base2(i)
    n_digits = int(np.ceil(np.log(_MAX_INDEX) / np.log(b)))
    fs = []
    f_np = np.float32(1.0)
    inv_np = np.float32(1.0) / np.float32(b)
    for _ in range(n_digits):
        f_np = np.float32(f_np * inv_np)
        fs.append(float(f_np))
    inv_b = float(inv_np)
    inv_b2 = float(np.float32(1.0) / np.float32(b * b))

    x = i.to(torch.float32)
    r = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    for k in range(0, n_digits, 2):
        if k + 1 < n_digits:
            x, big = _divmod_f32(x, inv_b2, float(b * b))
            d1, d0 = _divmod_f32(big, inv_b, float(b))
            r = r + fs[k] * d0
            r = r + fs[k + 1] * d1
        else:
            x, d0 = _divmod_f32(x, inv_b, float(b))
            r = r + fs[k] * d0
    return r


# Dimension schedule (reference: Raytracing.metal:202-203, 272, 284-285,
# 384-385): d=0,1 pixel jitter; per bounce b the block 2 + 5*b + k with
# k=0 light select, k=1,2 light surface uv, k=3,4 bounce direction uv.
DIM_PIXEL_X = 0
DIM_PIXEL_Y = 1


def bounce_dim(bounce: int, k: int) -> int:
    return 2 + 5 * bounce + k


def sample_cosine_weighted_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Map uniform (N, 2) to cosine-weighted directions about +Y
    (reference: Raytracing.metal:78-88)."""
    phi = 2.0 * math.pi * u[..., 0]
    cos_theta = torch.sqrt(u[..., 1])
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack([sin_theta * torch.cos(phi), cos_theta,
                        sin_theta * torch.sin(phi)], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, keepdim (sqrt of the sum of
    squares, as ``jnp.linalg.norm``)."""
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True))


@functools.lru_cache(maxsize=None)
def _tangent_seed(device: torch.device) -> torch.Tensor:
    """The reference's fixed tangent seed on ``device``, made once: a copy
    from host memory at every call would wait for the card and cannot sit
    in a CUDA graph."""
    return torch.tensor([0.0072, 1.0, 0.0034], dtype=torch.float32,
                        device=device)


def align_hemisphere_with_normal(sample: torch.Tensor,
                                 normal: torch.Tensor) -> torch.Tensor:
    """Rotate +Y-hemisphere samples onto the surface normal using the
    reference's fixed tangent seed (0.0072, 1, 0.0034)
    (reference: Raytracing.metal:132-147)."""
    right = _cross(normal, _tangent_seed(normal.device).expand_as(normal))
    right = right / norm(right)
    forward = _cross(right, normal)
    return (sample[..., 0:1] * right + sample[..., 1:2] * normal
            + sample[..., 2:3] * forward)


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 numpy arrays:
    counters ``(x1, x2)`` under key ``(k1, k2)``; uint32 arithmetic wraps."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _threefry_block(key, n: int):
    """``n`` output pairs of ``key`` at counters ``(0, 0) .. (0, n-1)``: the
    partitionable counter layout (``iota_2x32_shape``) of ``jax.random``."""
    hi = np.zeros(n, np.uint32)
    lo = np.arange(n, dtype=np.uint32)
    return _threefry2x32(key[0], key[1], hi, lo)


def jax_randint(seed: int, n: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(jax.random.PRNGKey(seed), (n,), 0, maxval,
    jnp.int32)`` bit for bit, in numpy, for ``0 < maxval < 2^31``.

    Reproduces the default ``threefry2x32`` implementation with
    ``jax_threefry_partitionable=True`` (the default since JAX 0.5, and the
    setting of the JAX package's environment): the key of a 32-bit seed is
    ``(0, seed)``; ``split`` hashes counters ``(0, 0)`` and ``(0, 1)``;
    ``random_bits`` XORs the two output words of counters ``(0, i)``; and
    ``randint`` folds a high and a low draw into ``[0, maxval)`` by its
    two-draw span arithmetic."""
    if not 0 < maxval < (1 << 31):
        raise ValueError(f"maxval {maxval} outside (0, 2^31)")
    key = (np.uint32(0), np.uint32(seed & 0xFFFFFFFF))
    s1, s2 = _threefry_block(key, 2)  # split: two new keys
    higher = np.bitwise_xor(*_threefry_block((s1[0], s2[0]), n))
    lower = np.bitwise_xor(*_threefry_block((s1[1], s2[1]), n))
    span = np.uint32(maxval)
    mult = (1 << 16) % maxval
    mult = np.uint32(((mult * mult) & 0xFFFFFFFF) % maxval)  # uint32 product
    offset = (higher % span) * mult + (lower % span)  # wraps as in uint32
    return (offset % span).astype(np.int32)


def pixel_decorrelation_offsets(seed: int, n: int, bits: int = 20,
                                device="cpu") -> torch.Tensor:
    """Per-pixel random Halton index offsets in ``[0, 2^bits)`` — the
    reference's ``arc4random() % (1 << 20)`` texture
    (reference: Renderer.swift:249-274) — equal bit for bit to the JAX
    package's ``jax.random.randint(PRNGKey(seed), (n,), 0, 2^bits)``
    (:func:`jax_randint`), so a checkpoint moves between the two packages
    and goes on with the same offsets."""
    if bits > 21:
        raise ValueError(
            f"rand_offset_bits {bits} leaves no sample-index headroom under "
            f"the Halton digit/exactness bound 2^{_MAX_INDEX_BITS}")
    return torch.from_numpy(jax_randint(seed, n, 1 << bits)).to(device)
