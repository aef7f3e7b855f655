"""The fused per-ray broad phase on Hopper.

The port's counterpart of ``trace_pallas.broadphase_keys`` and its TPU
kernel ``_broadphase_kernel``: :func:`broadphase_keys` launches
``broadphase_kernel`` (``csrc/broadphase.cu``) for tensors on a CUDA device,
where it never falls back, and runs the plain PyTorch version
:func:`broadphase_ref` for tensors on the CPU.  ``broadphase_keys.launches``
counts the kernel's launches, ``broadphase_keys.launches_clusters`` those of
them that sweep the cluster boxes (:data:`BROADPHASE_MODES` names the four
modes the renderer calls).

Per ray it gives the packed ``(bits(t_entry) & ~0xFFF) | cluster id`` keys
of the nearest and second-nearest slab-hit cluster (:data:`NC_SENT` where
there is none; :func:`decode_cluster_key` turns a key into a cluster id),
and the global set's closest-hit seed key (the :func:`global_seed_keys`
layout, t from the Newton-refined reciprocal of the plane test) or, in
``any_mode``, its 0/1 occlusion flag.  The renderer's
``fused_broadphase=True`` takes the global results in place of
``global_seed_keys`` and ``global_any_hit``, and under ``compaction`` the
cluster keys for its sort keys.

:func:`nearest_cluster` and :func:`nearest_cluster_pair` are the exact
broad phase of the compaction sort keys, the counterparts of the functions
of those names in ``trace_pallas``.  The reference leaves them to XLA,
which fuses their (rays x clusters) slab chain into one reduce.  Here, for
tensors on a CUDA device, they launch ``nearest_cluster_kernel``
(``csrc/broadphase.cu``), one pass a ray over the box table in shared
memory that keeps each ray's smallest keys in registers, and never fall
back; for tensors on the CPU they run the plain chain of sub, mul, min and
max (:func:`nearest_cluster_ref`, :func:`nearest_cluster_pair_ref`), whose
int32 keys equal the reference's and the kernel's bit for bit.
``nearest_cluster.launches`` counts the kernel's single-direction launches,
``nearest_cluster.launches_pair`` its pair launches.
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
           "slab_entry", "nearest_cluster", "nearest_cluster_pair",
           "nearest_cluster_ref", "nearest_cluster_pair_ref", "NC_SENT",
           "NC_IDM", "BROADPHASE_MAX_CLUSTERS", "BROADPHASE_MODES"]

# Packed broad-phase keys keep 12 cluster-id bits (trace_pallas._NC_IDM).
NC_IDM = (1 << 12) - 1
NC_SENT = int((np.float32(BIG_T).view(np.int32).item() & ~NC_IDM) | NC_IDM)
BROADPHASE_MAX_CLUSTERS = 4096
# The kernel's modes as the renderer calls them: (name, the pass whose rays
# it takes, want2, with_clusters, any_mode).
BROADPHASE_MODES = (
    ("keys", "closest", False, True, False),
    ("keys+second", "closest", True, True, False),
    ("closest global", "closest", False, False, False),
    ("any global", "any", False, False, True),
)
# Bytes of one (rays x clusters) float32 temporary of the exact broad phase:
# a full-frame pass runs in a few ray chunks of this size (1M rays x 344
# clusters: 6), each a fixed number of launches.
_SWEEP_CHUNK_BYTES = 1 << 28
NEAREST_CLUSTER_BLOCK = 256  # threads a block of nearest_cluster_kernel


def _safe_inv(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    tiny = torch.where(v < 0, -eps, eps).to(v.dtype)
    return 1.0 / torch.where(v.abs() < eps, tiny, v)


def slab_entry(o, d, boxes, t_max=None):
    """Slab test of rays (n, 3) against boxes (B, 6) ``[lo(3), hi(3)]``
    shared by all rays, or (n, B, 6) gathered per ray, in
    ``trace_pallas._slab_cols``' op order: ``(max(t_entry, 0) (n, B), hit
    (n, B))``; inverted padding boxes never hit.  ``t_max`` (n,) bounds the
    entry, else BIG_T does."""
    inv = _safe_inv(d)
    if boxes.dim() == 2:
        boxes = boxes[None]
    lo, hi = boxes[..., 0:3], boxes[..., 3:6]
    t0 = (lo - o[:, None, :]) * inv[:, None, :]
    t1 = (hi - o[:, None, :]) * inv[:, None, :]
    lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo_t[..., 0], lo_t[..., 1]), lo_t[..., 2])
    tf = torch.minimum(torch.minimum(hi_t[..., 0], hi_t[..., 1]), hi_t[..., 2])
    bound = BIG_T if t_max is None else t_max[:, None]
    hit = ((tn <= tf) & (tf >= 0.0) & (tn <= bound)
           & (boxes[..., 3] >= boxes[..., 0]))
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
        for s, e in _ray_chunks(n, boxes.shape[0], dev):
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
        broadphase_keys.launches_clusters += int(with_clusters)
    return key1, key2, g


broadphase_keys.launches = 0
broadphase_keys.launches_clusters = 0


def decode_cluster_key(key: torch.Tensor, ncp: int) -> torch.Tensor:
    """(N,) packed broad-phase key -> (N,) cluster id in [0, ncp], where ncp
    means no overlap (``trace_pallas.decode_cluster_key``)."""
    return torch.where(key == NC_SENT, torch.full_like(key, ncp),
                       key & NC_IDM)


# ---------------------------------------------------------------------------
# The exact broad phase of the compaction sort keys
# ---------------------------------------------------------------------------


def _sweep_chunks(n: int, nc: int):
    step = max(1, _SWEEP_CHUNK_BYTES // (4 * max(nc, 1)))
    for s in range(0, max(n, 1), step):
        yield s, min(n, s + step)


def _box_subs(o, boxes):
    """Per axis the two (n, NC) differences ``box lo - o`` and ``box hi - o``
    (per-axis 2-D chains, as the reference, never an (n, NC, 3) tensor)."""
    return [(boxes[None, :, a] - o[:, a:a + 1],
             boxes[None, :, a + 3] - o[:, a:a + 1]) for a in range(3)]


def _packed_slab_keys(subs, d, mask, max_t, boxes, ids):
    """(n, NC) packed ``(bits(max(t_entry, 0)) & ~0xFFF) | cluster id`` keys
    of one ray set against every box, NC_SENT where the slab test fails, in
    ``trace_pallas.nearest_cluster``'s op order."""
    inv = _safe_inv(d)
    tn = tf = None
    for a in range(3):
        t0 = subs[a][0] * inv[:, a:a + 1]
        t1 = subs[a][1] * inv[:, a:a + 1]
        lo_a, hi_a = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo_a if tn is None else torch.maximum(tn, lo_a)
        tf = hi_a if tf is None else torch.minimum(tf, hi_a)
    hit = ((tn <= tf) & (tf >= 0.0) & (boxes[:, 3] >= boxes[:, 0])[None, :]
           & mask[:, None])
    if max_t is not None:
        hit &= tn <= max_t[:, None]
    ti = torch.clamp(tn, min=0.0).view(torch.int32)
    return torch.where(hit, (ti & ~NC_IDM) | ids, NC_SENT)


def _smallest_keys(key, ranks: int):
    """The ``ranks`` smallest keys of each row, ascending.  Real keys are
    distinct (unique id bits), so each further rank is the minimum of what
    lies above the last; a row that runs out gives NC_SENT."""
    out = [key.amin(dim=1)]
    for _ in range(ranks - 1):
        key = torch.where(key == out[-1][:, None], NC_SENT, key)
        out.append(key.amin(dim=1))
    return out


def nearest_cluster_ref(o, d, mask, boxes, max_t=None, ranks: int = 1):
    """The plain chain of ``nearest_cluster_kernel``: per ray the ``ranks``
    smallest packed slab keys over the (NC, 6) ``boxes``, ascending, as a
    list of (N,) int32 (NC_SENT where there are fewer); ``max_t`` bounds
    the entry.  The CPU path of :func:`nearest_cluster`."""
    n, nc = o.shape[0], boxes.shape[0]
    ids = torch.arange(nc, dtype=torch.int32, device=o.device)[None, :]
    keys = [torch.empty((n,), dtype=torch.int32, device=o.device)
            for _ in range(ranks)]
    for s, e in _sweep_chunks(n, nc):
        key = _packed_slab_keys(_box_subs(o[s:e], boxes), d[s:e], mask[s:e],
                                None if max_t is None else max_t[s:e], boxes,
                                ids)
        for out, k in zip(keys, _smallest_keys(key, ranks)):
            out[s:e] = k
    return keys


def nearest_cluster_pair_ref(o, d_sh, max_t_sh, mask_sh, d_nb, mask_nb,
                             boxes, ranks: int):
    """The plain chain of the pair form of ``nearest_cluster_kernel``:
    ``(shadow rank-1 keys, [the next bounce's ranks keys])``, the ``box -
    o`` differences computed once for both.  The CPU path of
    :func:`nearest_cluster_pair`."""
    n, nc = o.shape[0], boxes.shape[0]
    ids = torch.arange(nc, dtype=torch.int32, device=o.device)[None, :]
    skey1 = torch.empty((n,), dtype=torch.int32, device=o.device)
    bkeys = [torch.empty_like(skey1) for _ in range(ranks)]
    for s, e in _sweep_chunks(n, nc):
        subs = _box_subs(o[s:e], boxes)
        skey1[s:e] = _packed_slab_keys(subs, d_sh[s:e], mask_sh[s:e],
                                       max_t_sh[s:e], boxes, ids).amin(dim=1)
        bkey = _packed_slab_keys(subs, d_nb[s:e], mask_nb[s:e], None, boxes,
                                 ids)
        for out, k in zip(bkeys, _smallest_keys(bkey, ranks)):
            out[s:e] = k
    return skey1, bkeys


def _box_table(o, clu):
    """The (NC, 6) boxes of an (NS, S, 6) table, checked for the kernel."""
    if clu.dim() != 3 or clu.shape[2] != 6:
        raise ValueError(f"the box table must be (NS, S, 6), got "
                         f"{tuple(clu.shape)}")
    _check_tables(o.device, clu=clu)
    nc = clu.shape[0] * clu.shape[1]
    if nc > BROADPHASE_MAX_CLUSTERS:
        raise ValueError(f"{nc} boxes exceed the broad phase's "
                         f"{BROADPHASE_MAX_CLUSTERS}")
    return clu.reshape(nc, 6)


def _device_path(o) -> bool:
    """Does this call launch ``nearest_cluster_kernel``?  (CPU tensors take
    the plain chain.)"""
    if o.device.type == "cpu":
        return False
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    return True


def _launch_nearest(o, d, mask, max_t, boxes, ranks, shadow=None):
    """Launch ``nearest_cluster_kernel``: ``ranks`` (N,) int32 key tensors
    and, with ``shadow = (d_sh, max_t_sh, mask_sh)`` (the pair), the shadow
    segments' rank-1 keys."""
    from ._build import load_library

    lib = load_library()
    n = o.shape[0]
    keys = [torch.empty((n,), dtype=torch.int32, device=o.device)
            for _ in range(ranks)]
    skey = None if shadow is None else torch.empty_like(keys[0])
    if n:
        d_sh, mt_sh, m_sh = (None, None, None) if shadow is None else shadow
        ins = [None if x is None else x.contiguous()
               for x in (o, d, mask, max_t, d_sh, m_sh, mt_sh, boxes)]
        outs = keys + [None] * (3 - ranks) + [skey]
        err = lib.launch_nearest_cluster(
            *(_ptr(x) for x in ins), n, boxes.shape[0], ranks,
            *(_ptr(x) for x in outs), NEAREST_CLUSTER_BLOCK,
            _stream(o.device))
        _raise_on(err, lib, "nearest_cluster_kernel")
        if shadow is None:
            nearest_cluster.launches += 1
        else:
            nearest_cluster.launches_pair += 1
    return keys, skey


def nearest_cluster(o, d, mask, clu, spec: BVHSpec, max_t=None,
                    return_key: bool = False, return_second: int = 0,
                    return_packed: bool = False):
    """Per-ray id of the nearest slab-hit cluster, (N,) int32 in [0, NC]
    where NC (the padded cluster count) means no overlap;
    ``trace_pallas.nearest_cluster``, with its return forms.

    ``clu`` is the (NS, S, 6) box table (the shadow fold of the last bounce
    passes the super boxes as ``sup[:, None, :]``), at most 4,096 boxes.
    With ``max_t`` only clusters entered before it count.  ``return_key``
    adds the winner's packed key after the id; ``return_second`` (1 or 2)
    adds the second (and third) nearest, as ids or with ``return_packed``
    as packed keys.  ``nearest_cluster_kernel`` on a CUDA device,
    :func:`nearest_cluster_ref` on the CPU."""
    del spec  # the reference's signature; the box table says it all
    if return_second not in (0, 1, 2):
        raise ValueError(f"return_second must be 0, 1 or 2, got "
                         f"{return_second}")
    extra = () if max_t is None else (
        ("max_t", max_t, (o.shape[0],), torch.float32),)
    _check_rays(o, d, mask, extra)
    boxes = _box_table(o, clu)
    ranks = 1 + int(return_second)
    if _device_path(o):
        keys, _ = _launch_nearest(o, d, mask, max_t, boxes, ranks)
    else:
        keys = nearest_cluster_ref(o, d, mask, boxes, max_t, ranks)
    nc = boxes.shape[0]
    cid = decode_cluster_key(keys[0], nc)
    extras = [k if return_packed else decode_cluster_key(k, nc)
              for k in keys[1:]]
    if return_key:
        return (cid, keys[0], *extras)
    return (cid, *extras) if extras else cid


nearest_cluster.launches = 0  # single-direction launches of the kernel
nearest_cluster.launches_pair = 0  # its pair launches


def nearest_cluster_pair(o, d_sh, max_t_sh, mask_sh, d_nb, mask_nb, clu,
                         spec: BVHSpec, ranks: int = 2,
                         return_packed: bool = False):
    """The shadow segments' nearest cluster and the next bounce rays'
    ``ranks`` nearest clusters in one sweep over their shared origins
    (``trace_pallas.nearest_cluster_pair``): the ``box - o`` differences are
    computed once for both chains.  Returns ``(scid, cid, nckey, cid2[,
    cid3])``, equal to ``nearest_cluster(o, d_sh, mask_sh, clu, spec,
    max_t=max_t_sh)`` followed by ``nearest_cluster(o, d_nb, mask_nb, clu,
    spec, return_key=True, return_second=ranks - 1,
    return_packed=return_packed)``.  The pair form of
    ``nearest_cluster_kernel`` on a CUDA device,
    :func:`nearest_cluster_pair_ref` on the CPU."""
    del spec
    if ranks not in (2, 3):
        raise ValueError(f"ranks must be 2 or 3, got {ranks}")
    n = o.shape[0]
    _check_rays(o, d_sh, mask_sh, (
        ("max_t_sh", max_t_sh, (n,), torch.float32),
        ("d_nb", d_nb, (n, 3), torch.float32),
        ("mask_nb", mask_nb, (n,), torch.bool)))
    boxes = _box_table(o, clu)
    if _device_path(o):
        bkeys, skey1 = _launch_nearest(o, d_nb, mask_nb, None, boxes, ranks,
                                       shadow=(d_sh, max_t_sh, mask_sh))
    else:
        skey1, bkeys = nearest_cluster_pair_ref(o, d_sh, max_t_sh, mask_sh,
                                                d_nb, mask_nb, boxes, ranks)
    nc = boxes.shape[0]
    extras = [k if return_packed else decode_cluster_key(k, nc)
              for k in bkeys[1:]]
    return (decode_cluster_key(skey1, nc), decode_cluster_key(bkeys[0], nc),
            bkeys[0], *extras)
