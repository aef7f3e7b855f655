"""The fused per-ray broad phase on Hopper.

The port's counterpart of ``trace_pallas.broadphase_keys`` and its TPU
kernel ``_broadphase_kernel``: :func:`broadphase_keys` launches
``broadphase_kernel`` (``csrc/broadphase.cu``) for tensors on a CUDA device,
where it never falls back, and runs the plain PyTorch version
:func:`broadphase_ref` for tensors on the CPU.  ``broadphase_keys.launches``
counts the kernel's launches.

Per ray it gives the packed ``(bits(t_entry) & ~0xFFF) | cluster id`` keys
of the nearest and second-nearest slab-hit cluster (:data:`NC_SENT` where
there is none; :func:`decode_cluster_key` turns a key into a cluster id),
and the global set's closest-hit seed key (the :func:`global_seed_keys`
layout, t from the Newton-refined reciprocal of the plane test) or, in
``any_mode``, its 0/1 occlusion flag.  The renderer's
``fused_broadphase=True`` takes the global results in place of
``global_seed_keys`` and ``global_any_hit``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel import BVHSpec
from .intersect import BIG_T
from .trace_cuda import (IDX_MASK, N_TRI_PLANES, _INIT_KEY, _check_rays,
                         _check_tables, _plane_hits, _ptr, _raise_on,
                         _ray_chunks, _stream)

__all__ = ["broadphase_keys", "broadphase_ref", "decode_cluster_key",
           "slab_entry", "NC_SENT", "BROADPHASE_MAX_CLUSTERS"]

# Packed broad-phase keys keep 12 cluster-id bits (trace_pallas._NC_IDM).
NC_IDM = (1 << 12) - 1
NC_SENT = int((np.float32(BIG_T).view(np.int32).item() & ~NC_IDM) | NC_IDM)
BROADPHASE_MAX_CLUSTERS = 4096


def _safe_inv(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    tiny = torch.where(v < 0, -eps, eps).to(v.dtype)
    return 1.0 / torch.where(v.abs() < eps, tiny, v)


def slab_entry(o, d, boxes, t_max=None):
    """Slab test of rays (n, 3) against boxes (B, 6) ``[lo(3), hi(3)]`` in
    ``trace_pallas._slab_cols``' op order: ``(max(t_entry, 0) (n, B), hit
    (n, B))``; inverted padding boxes never hit.  ``t_max`` (n,) bounds the
    entry, else BIG_T does."""
    inv = _safe_inv(d)
    lo, hi = boxes[None, :, 0:3], boxes[None, :, 3:6]
    t0 = (lo - o[:, None, :]) * inv[:, None, :]
    t1 = (hi - o[:, None, :]) * inv[:, None, :]
    lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo_t[..., 0], lo_t[..., 1]), lo_t[..., 2])
    tf = torch.minimum(torch.minimum(hi_t[..., 0], hi_t[..., 1]), hi_t[..., 2])
    bound = BIG_T if t_max is None else t_max[:, None]
    hit = ((tn <= tf) & (tf >= 0.0) & (tn <= bound)
           & (boxes[None, :, 3] >= boxes[None, :, 0]))
    return torch.clamp(tn, min=0.0), hit


def broadphase_ref(o, d, mask, clu, tri, spec: BVHSpec, max_t=None,
                   want2: bool = False, with_clusters: bool = True,
                   any_mode: bool = False):
    """Plain version of ``broadphase_kernel``; returns ``(key1, key2, g)``
    as :func:`broadphase_keys`.  The global test runs the kernels' plane
    test (:func:`trace_cuda._plane_hits`, a Newton-refined reciprocal), not
    the exact divide of ``global_seed_keys``."""
    n = o.shape[0]
    dev = o.device
    key1 = key2 = g = None
    if with_clusters:
        boxes = clu.reshape(-1, 6)
        key1 = torch.full((n,), NC_SENT, dtype=torch.int32, device=dev)
        key2 = torch.full_like(key1, NC_SENT) if want2 else None
        cid = torch.arange(boxes.shape[0], dtype=torch.int32, device=dev)
        for s, e in _ray_chunks(n, boxes.shape[0]):
            tn, hit = slab_entry(o[s:e], d[s:e], boxes,
                                 max_t[s:e] if any_mode else None)
            key = (tn.view(torch.int32) & ~NC_IDM) | cid[None, :]
            key = torch.where(hit & mask[s:e, None], key,
                              torch.full_like(key, NC_SENT))
            k1 = key.amin(dim=1)
            key1[s:e] = k1
            if want2:
                key2[s:e] = torch.where(key == k1[:, None], NC_SENT,
                                        key).amin(dim=1)
    ng = spec.num_global
    if ng:
        rows = tri[:, spec.global_base:spec.global_base + ng]
        t, hit = _plane_hits(o, d, rows)
        hit &= mask[:, None]
        if any_mode:
            g = (hit & (t <= max_t[:, None])).any(dim=1).to(torch.int32)
        else:
            lane = torch.arange(ng, dtype=torch.int32, device=dev)
            key = (t.view(torch.int32) & ~IDX_MASK) | lane[None, :]
            g = torch.where(hit, key, torch.full_like(key, _INIT_KEY))
            g = g.amin(dim=1)
    return key1, key2, g


def broadphase_keys(o, d, mask, clu, tri, spec: BVHSpec, max_t=None,
                    want2: bool = False, with_clusters: bool = True,
                    any_mode: bool = False, block: int = 256):
    """Fused broad phase (``trace_pallas.broadphase_keys``): per-ray packed
    nearest-cluster key(s) plus the global-set result, in one pass.

    Returns ``(key1, key2, g)``, each (N,) int32 or None: ``key1`` the
    nearest slab-hit cluster's key (None when ``with_clusters=False``),
    ``key2`` the second-nearest's (``want2``), ``g`` the global seed key or,
    with ``any_mode=True``, the global occlusion flag (None when the scene
    has no global set).  ``max_t`` bounds the cluster slab and the global
    test and requires ``any_mode=True``.  ``block`` is the kernel's thread
    count per block (``RenderConfig.broadphase_block``)."""
    n = o.shape[0]
    if (max_t is None) == any_mode:
        raise ValueError("any_mode=True takes max_t, and only it does")
    if not (with_clusters or spec.num_global):
        raise ValueError("the kernel would have no output")
    ncp = clu.shape[0] * clu.shape[1]
    if ncp > BROADPHASE_MAX_CLUSTERS:
        raise ValueError(f"{ncp} clusters exceed the broad phase's "
                         f"{BROADPHASE_MAX_CLUSTERS}")
    extra = () if max_t is None else (
        ("max_t", max_t, (n,), torch.float32),)
    _check_rays(o, d, mask, extra)
    if o.device.type == "cpu":
        return broadphase_ref(o, d, mask, clu, tri, spec, max_t, want2,
                              with_clusters, any_mode)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_tables(o.device, clu=clu, tri=tri)
    if (clu.dim() != 3 or clu.shape[2] != 6 or tri.dim() != 2
            or tri.shape[0] != N_TRI_PLANES
            or tri.shape[1] < spec.global_base + spec.num_global):
        raise ValueError(f"bad plane tables: clu {tuple(clu.shape)}, tri "
                         f"{tuple(tri.shape)}")
    from ._build import load_library

    lib = load_library()

    def out(wanted):
        return (torch.empty((n,), dtype=torch.int32, device=o.device)
                if wanted else None)

    key1 = out(with_clusters)
    key2 = out(with_clusters and want2)
    g = out(spec.num_global > 0)
    if n:
        o_c, d_c, m_c = o.contiguous(), d.contiguous(), mask.contiguous()
        mt_c = None if max_t is None else max_t.contiguous()
        clu_c, tri_c = clu.contiguous(), tri.contiguous()
        err = lib.launch_broadphase(
            _ptr(o_c), _ptr(d_c), _ptr(m_c), _ptr(mt_c), _ptr(clu_c),
            _ptr(tri_c), n, ncp, tri_c.shape[1], spec.global_base,
            spec.num_global, int(any_mode), _ptr(key1), _ptr(key2), _ptr(g),
            block, _stream(o.device))
        _raise_on(err, lib, "broadphase_kernel")
        broadphase_keys.launches += 1
    return key1, key2, g


broadphase_keys.launches = 0


def decode_cluster_key(key: torch.Tensor, ncp: int) -> torch.Tensor:
    """(N,) packed broad-phase key -> (N,) cluster id in [0, ncp], where ncp
    means no overlap (``trace_pallas.decode_cluster_key``)."""
    return torch.where(key == NC_SENT, torch.full_like(key, ncp),
                       key & NC_IDM)
