"""The reference's ray/triangle queries: Moller-Trumbore over every
triangle of the scene.

:func:`closest_brute` and :func:`any_brute` test every ray against every
triangle.  :class:`Binned` gives the same answers faster: it sorts the
triangles by the Morton code of their centroids into bins of ``bin_size``,
tests each ray against the bins' boxes (padded, so no hit is lost to
rounding), and runs the very same Moller-Trumbore test only on the
triangles of the bins a ray's segment enters.  The closest hit is the
least ``(t, triangle index)`` pair, so ties go to the lowest index in both,
and both return the same bits.

A hit needs ``|det| > 1e-12``, ``u, v >= 0``, ``u + v <= 1`` and ``t`` in
``(1e-6, t_max]``: double-sided, opaque triangles, as the reference
shader's intersector takes them.  ``rnd`` rounds each stored intermediate
(identity in float32; the control's lower precision passes its rounding).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["moller_trumbore", "closest_brute", "any_brute", "Binned"]

T_MIN = 1e-6
_NO_KEY = torch.iinfo(torch.int64).max


def _ident(x):
    return x


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def moller_trumbore(o, d, v0, e1, e2, t_max, rnd=_ident):
    """(t, u, v, hit) of rays (o, d) against triangles (v0, e1, e2), all
    broadcast; ``t_max`` broadcasts against the result."""
    pvec = rnd(_cross(d, e2))
    det = rnd(_dot(e1, pvec))
    inv_det = 1.0 / det
    tvec = rnd(o - v0)
    u = rnd(_dot(tvec, pvec) * inv_det)
    qvec = rnd(_cross(tvec, e1))
    v = rnd(_dot(d, qvec) * inv_det)
    t = rnd(_dot(e2, qvec) * inv_det)
    hit = ((det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > T_MIN) & (t <= t_max))
    return t, u, v, hit


def _key(t, idx, hit):
    """Sortable (t, index) keys: the bits of a positive float32 order as
    its value."""
    k = (t.contiguous().view(torch.int32).to(torch.int64) << 32) | idx
    return torch.where(hit, k, torch.full_like(k, _NO_KEY))


def _decode(o, d, key, v0, e1, e2, rnd):
    """(t, tri, u, v) of the winning keys; misses: t inf, tri -1."""
    found = key != _NO_KEY
    tri = torch.where(found, key & 0xFFFFFFFF, torch.full_like(key, -1))
    safe = tri.clamp(min=0)
    t, u, v, _ = moller_trumbore(o, d, v0[safe], e1[safe], e2[safe],
                                 float("inf"), rnd)
    inf = torch.full_like(t, float("inf"))
    return torch.where(found, t, inf), tri, u, v


def closest_brute(o, d, v0, e1, e2, chunk: int = 4096, rnd=_ident):
    """(t, tri, u, v) of the closest hit of each ray over every triangle
    (tri -1 and t inf where a ray hits nothing)."""
    n, tris = o.shape[0], v0.shape[0]
    best = torch.full((n,), _NO_KEY, dtype=torch.int64, device=o.device)
    idx = torch.arange(tris, device=o.device)
    for c0 in range(0, tris, chunk):
        cs = slice(c0, c0 + chunk)
        t, _, _, hit = moller_trumbore(o[:, None], d[:, None], v0[None, cs],
                                       e1[None, cs], e2[None, cs],
                                       float("inf"), rnd)
        best = torch.minimum(best, _key(t, idx[None, cs], hit).amin(1))
    return _decode(o, d, best, v0, e1, e2, rnd)


def any_brute(o, d, t_max, v0, e1, e2, chunk: int = 4096, rnd=_ident):
    """(N,) bool: a triangle lies within (1e-6, t_max] along each ray."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for c0 in range(0, v0.shape[0], chunk):
        cs = slice(c0, c0 + chunk)
        hit = moller_trumbore(o[:, None], d[:, None], v0[None, cs],
                              e1[None, cs], e2[None, cs], t_max[:, None],
                              rnd)[3]
        occ |= hit.any(1)
    return occ


def _morton30(c: np.ndarray) -> np.ndarray:
    lo, hi = c.min(0), c.max(0)
    q = np.clip((c - lo) / np.maximum(hi - lo, 1e-30) * 1024.0, 0,
                1023).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + (2 - axis))
    return code


class Binned:
    """The triangles (v0, e1, e2) in Morton-ordered bins with padded
    boxes; :meth:`closest` and :meth:`any` answer as the brute force does.

    ``pad`` widens each box on every side, in the scene's units; the
    float32 test needs far less than the default, the control's rounding
    more.  ``ray_batch`` rays are tested against all boxes at a time and
    ``pair_batch`` (ray, bin) pairs run the triangle test at a time."""

    def __init__(self, v0, e1, e2, bin_size: int = 256, pad: float = 1e-4,
                 ray_batch: int = 65536, pair_batch: int = 32768,
                 rnd=_ident):
        dev = v0.device
        self.v0, self.e1, self.e2, self.rnd = v0, e1, e2, rnd
        a = v0.double().cpu().numpy()
        b, c = a + e1.double().cpu().numpy(), a + e2.double().cpu().numpy()
        order = np.argsort(_morton30((a + b + c) / 3.0), kind="stable")
        nb = -(-len(order) // bin_size)
        slots = np.full(nb * bin_size, -1, np.int64)
        slots[:len(order)] = order
        self.idx = torch.from_numpy(slots.reshape(nb, bin_size)).to(dev)
        safe = self.idx.clamp(min=0)
        real = (self.idx >= 0)[..., None]
        zero = torch.zeros((), dtype=v0.dtype, device=dev)
        # padding slots: degenerate triangles (det 0: never a hit)
        self.bv0 = torch.where(real, v0[safe], zero)
        self.be1 = torch.where(real, e1[safe], zero)
        self.be2 = torch.where(real, e2[safe], zero)
        corners = np.stack([a, b, c], 1)[slots.clip(min=0)].reshape(
            nb, bin_size * 3, 3)
        keep = np.repeat(slots.reshape(nb, bin_size) >= 0, 3, axis=1)
        lo = np.where(keep[..., None], corners, np.inf).min(1) - pad
        hi = np.where(keep[..., None], corners, -np.inf).max(1) + pad
        self.lo = torch.from_numpy(lo.astype(np.float32)).to(dev)
        self.hi = torch.from_numpy(hi.astype(np.float32)).to(dev)
        self.ray_batch, self.pair_batch = ray_batch, pair_batch

    def _pairs(self, o, d, t_max):
        """(ray, bin) pairs whose padded box the segment [0, t_max] of
        the ray enters."""
        tiny = d.abs() < 1e-12
        inv = 1.0 / torch.where(tiny, torch.where(d < 0, -1e-12, 1e-12), d)
        t0 = (self.lo[None] - o[:, None]) * inv[:, None]
        t1 = (self.hi[None] - o[:, None]) * inv[:, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        ok = (near <= far) & (far >= 0.0) & (near <= t_max[:, None])
        return ok.nonzero(as_tuple=True)

    def _sweep(self, o, d, t_max, occlusion: bool):
        n = o.shape[0]
        dev = o.device
        out = (torch.zeros(n, dtype=torch.int32, device=dev) if occlusion
               else torch.full((n,), _NO_KEY, dtype=torch.int64, device=dev))
        for r0 in range(0, n, self.ray_batch):
            rs = slice(r0, r0 + self.ray_batch)
            ray, bin_ = self._pairs(o[rs], d[rs], t_max[rs])
            ray = ray + r0
            for p0 in range(0, ray.shape[0], self.pair_batch):
                r = ray[p0:p0 + self.pair_batch]
                c = bin_[p0:p0 + self.pair_batch]
                t, _, _, hit = moller_trumbore(
                    o[r][:, None], d[r][:, None], self.bv0[c], self.be1[c],
                    self.be2[c], t_max[r][:, None], self.rnd)
                if occlusion:
                    out.scatter_reduce_(0, r, hit.any(1).to(torch.int32),
                                        "amax")
                else:
                    out.scatter_reduce_(0, r, _key(t, self.idx[c], hit)
                                        .amin(1), "amin")
        return out

    def closest(self, o, d):
        """(t, tri, u, v), as :func:`closest_brute` gives them."""
        inf = torch.full((o.shape[0],), float("inf"), device=o.device)
        key = self._sweep(o, d, inf, occlusion=False)
        return _decode(o, d, key, self.v0, self.e1, self.e2, self.rnd)

    def any(self, o, d, t_max):
        """(N,) bool, as :func:`any_brute` gives it."""
        return self._sweep(o, d, t_max, occlusion=True) > 0
