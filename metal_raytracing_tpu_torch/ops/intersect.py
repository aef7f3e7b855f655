"""Intersection primitives, constants and the hit record of the tracers.

The port's counterpart of ``metal_raytracing_tpu.ops.intersect``
(``safe_inverse``, ``ray_aabb``, ``moller_trumbore``, ``BIG_T``) and of
``Hit`` (``metal_raytracing_tpu.ops.trace``).  The primitives broadcast over
any leading batch shape and are NaN-safe: a degenerate (padding) triangle or
an inverted (padding) box never reports a hit.  Every dot product and cross
product is written out left to right, the op order of
``csrc/trace_bvh.cu``, so the CUDA kernels (built without fused
multiply-add) and these functions round alike."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["BIG_T", "Hit", "safe_inverse", "ray_aabb", "moller_trumbore"]

# Stand-in for the reference's INFINITY max ray distance
# (Raytracing.metal:220) that stays finite under f32 arithmetic.
BIG_T = 1e30


@dataclasses.dataclass
class Hit:
    t: torch.Tensor  # (N,) f32 distance (BIG_T, chopped, when missed)
    u: torch.Tensor  # (N,) f32 barycentric (corner 1 weight)
    v: torch.Tensor  # (N,) f32 barycentric (corner 2 weight)
    tri: torch.Tensor  # (N,) i32 triangle slot (-1 = miss)

    @property
    def found(self) -> torch.Tensor:
        return self.tri >= 0


def safe_inverse(d: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """1/d with zero components mapped to a huge finite value of matching
    sign, keeping slab arithmetic free of inf*0 NaNs."""
    tiny = d.abs() < eps
    safe_d = torch.where(tiny, torch.where(d < 0, -eps, eps).to(d.dtype), d)
    return 1.0 / safe_d


def ray_aabb(o, inv_d, lo, hi, t_max, t_min=0.0):
    """Slab test of rays ``o`` (..., 3) with ``inv_d`` (:func:`safe_inverse`)
    against boxes ``lo``/``hi`` (..., 3), broadcast against each other.
    Returns ``(t_near, hit)`` of shape (...).

    Inverted boxes (``hi < lo``), the empty-leaf sentinel of the BVH build,
    are rejected explicitly: a bare min/max slab test would accept them."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    valid = hi[..., 0] >= lo[..., 0]
    hit = (t_near <= t_far) & (t_far >= t_min) & (t_near <= t_max) & valid
    return t_near, hit


def _cross(a, b):
    """The three components of a x b (a, b (..., 3))."""
    return (a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])


def _dot(a, c):
    """a . c for a (..., 3) and c a triple of components."""
    return a[..., 0] * c[0] + a[..., 1] * c[1] + a[..., 2] * c[2]


def moller_trumbore(o, d, v0, e1, e2, t_min=1e-6, t_max=BIG_T):
    """Double-sided Moller-Trumbore ray/triangle test of rays ``o``, ``d``
    against triangles ``v0``, ``e1``, ``e2`` (all (..., 3), broadcast).

    Returns ``(t, u, v, hit)``: the point is v0 + u e1 + v e2, so u weighs
    corner 1 and v corner 2 (reference: Raytracing.metal:60-73).  A hit
    needs ``|det| > 1e-12``, u, v >= 0, u + v <= 1 and t in
    ``(t_min, t_max]``; triangles are opaque and have no back face
    (Raytracing.metal:232-233)."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / det  # det == 0 -> inf: the comparisons reject it
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ((det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t <= t_max))
    return t, u, v, hit
