"""Cluster traversal on Hopper: the closest-hit and any-hit kernels.

The port's counterpart of ``metal_raytracing_tpu.ops.trace_pallas``.  It
holds the scene-plane packing the kernels read, the packed-key helpers, the
host-side global-set passes, and two kernel wrappers that pick the flat or
the hierarchical walk as ``trace_pallas._use_flat`` does (flat up to 128
padded clusters, or as ``flat=`` says):

- :func:`trace_closest` launches ``closest_flat_kernel``
  (``csrc/trace_flat.cu``, the TPU kernel ``_closest_flat_kernel``) or
  ``closest_hier_kernel`` (``csrc/trace_hier.cu``, ``_closest_kernel``);
- :func:`trace_any` launches ``any_flat_kernel`` (``_any_flat_kernel``) or
  ``any_hier_kernel`` (``_any_kernel``).

All four kernels keep a walk per lane and share each requested cluster's
leaf test among the 32 lanes of a warp (``csrc/trace_warp.cuh``): a walk of
one level over every cluster box in the flat kernels, of two (supers, then
their clusters) in the hierarchical ones.  Each wrapper runs its plain
PyTorch version (:func:`closest_flat_ref`, :func:`any_flat_ref`, which
compute the function of both walks by brute force) for tensors on the CPU,
and launches a kernel for tensors on a CUDA device, where it never falls
back.  :func:`closest_flat_walk_ref`, :func:`any_flat_walk_ref`,
:func:`closest_hier_ref` and :func:`any_hier_ref` are plain versions that
walk as the kernels do and count each ray's cluster visits; tests and
``chip_smoke.py`` hold the kernels against them on every ray.  Each wrapper
keeps plain integer launch counts that grow by one per kernel launch:
``trace_closest.launches`` and ``trace_any.launches`` (flat),
``trace_closest.launches_hier`` and ``trace_any.launches_hier``;
``trace_closest.launches_wide`` and ``trace_any.launches_wide`` count the
hierarchical launches (baked ones too) of the wide instances, those of
supers of more than ``SHARED_PER_SUPER`` clusters.

**Options of the TPU kernels.**  ``counts`` (``SceneData.clu_counts``, the
real triangles of each cluster slot, used only where the build marks
``partial_clusters``, as in ``trace_pallas``) ends each cluster's leaf test
at its last real slot; padding slots are zero planes that never hit, so the
result is the same.  ``count_visits`` also returns each ray's cluster
visits, (N,) int32: the clusters it dense-tested (the any-hit kernels'
global test is not a visit).  The TPU kernels count per 128-ray tile; these
walk a ray per lane and count per ray, as the walking plain versions do,
which are what the wrappers run on the CPU when visits are asked for.  The
hierarchical kernels take supers of up to ``MAX_PER_SUPER`` clusters
(builders that make many small clusters: dragon's ``ploc`` build gives 232
a super); above ``SHARED_PER_SUPER`` they read the cluster boxes from device
memory in place of shared memory (``csrc/trace_hier.cu``).

**The baked origin** (the TPU kernel's ``baked=True``, for
``RenderConfig.bake_primary``): rays that all leave one origin (the camera's,
on the primary pass) run against the tables of :func:`bake_origin`, which
moves that origin into the boxes and the plane constants, and
:func:`trace_closest` with ``baked_origin=True`` launches the hierarchical
closest kernel's baked form (``launch_closest_hier_baked``), which reads only
the directions and drops every origin term of its tests; its plain versions
take ``baked=True``.  Its launches are ``trace_closest.launches_baked``.

**Outputs follow the TPU kernels' contract.**  A closest hit is the minimum
over packed keys ``(bits(t) & ~IDX_MASK) | in-cluster index``: positive
float bits order like their values, so the minimum is the nearest hit with t
chopped to 512 ulp, and ties go to the smaller in-cluster index.  The walk
starts from the host seed key (the global set's best hit) with base
``global_base``, or with the per-ray ``seed_base`` the hierarchical walk
takes (the rank-directed walk's best so far, ``ops.rank_cuda``); a cluster's
result replaces the running best only when its key is strictly smaller.  A
miss returns ``t = key_to_t(INIT)`` (BIG_T chopped) and ``tri = -1``; a dead
lane returns what its seed says.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel import BVHSpec
from ..utils.profiling import named_scope
from .intersect import BIG_T, Hit

__all__ = ["pack_triangle_planes", "pack_scene_planes", "super_layout",
           "trace_closest", "trace_any", "closest_flat_ref", "any_flat_ref",
           "closest_hier_ref", "any_hier_ref", "closest_flat_walk_ref",
           "any_flat_walk_ref", "closest_walk_ref", "any_walk_ref",
           "active_counts", "bake_origin",
           "global_seed_keys", "global_any_hit", "recompute_tuv",
           "reset_launch_counts", "IDX_BITS", "IDX_MASK"]

NSP = 128  # maximum super count (the level-0 fan-out bound)
# Clusters per super the hierarchical kernels take, and up to which they
# keep the cluster boxes in shared memory.
MAX_PER_SUPER = 4096
SHARED_PER_SUPER = 32
# Largest padded cluster count the flat kernels take (trace_pallas.py:2043).
FLAT_MAX_CLUSTERS = 128
N_TRI_PLANES = 12

IDX_BITS = 9  # cluster_size <= 512
IDX_MASK = (1 << IDX_BITS) - 1
_MISS_KEY = int(np.float32(BIG_T).view(np.int32)) & ~IDX_MASK
_INIT_KEY = _MISS_KEY | IDX_MASK

# Elements per (rays x triangles) temporary in the plain versions: 16 MB of
# float32 on the card, so a full-frame call stays small; 2 MB on the host,
# where a temporary that stays in a core's cache streams faster.
_REF_CHUNK_ELEMS = 1 << 22
_REF_CHUNK_ELEMS_HOST = 1 << 19
# Elements of one gathered (12, rays, cluster_size) plane block of the
# walking plain versions and of the rank walk's: 64 MB of float32.
_REF_GATHER_ELEMS = 1 << 24


def _key_to_t(key: torch.Tensor) -> torch.Tensor:
    """Chopped hit distance of a packed key (a <= 512-ulp underestimate)."""
    return (key & ~IDX_MASK).view(torch.float32)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` as a fused multiply-add: the float64 product of
    two float32 values is exact, and the sum is rounded to float32 (through
    float64, which rounds twice only in rare halfway cases)."""
    return (a.double() * b.double() + c.double()).float()


# The scene packing rounds like the JAX package's jitted scene build, in
# which XLA contracts the multiply feeding each add into a fused
# multiply-add; the two packages' tables then agree bit for bit.


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([fma(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])),
                        fma(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                        fma(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))], dim=1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fma(a[:, 2], b[:, 2], fma(a[:, 1], b[:, 1], a[:, 0] * b[:, 0]))


def pack_triangle_planes(v0: torch.Tensor, e1: torch.Tensor,
                         e2: torch.Tensor) -> torch.Tensor:
    """(12, T) f32 Baldwin-Weber triangle planes: rows ``[n(3), n.v0,
    U(3), uw, V(3), vw]`` with ``n = e1 x e2`` and ``u = U.p + uw``,
    ``v = V.p + vw`` for a point p on the plane.  Degenerate (padding)
    triangles have n = 0, so their hit test is never true.  Computed on the
    host, once per scene."""
    n = _cross(e1, e2)
    nn = _dot(n, n)[:, None]
    nn = torch.where(nn < 1e-30, torch.ones_like(nn), nn)
    u3 = _cross(e2, n) / nn
    v3 = _cross(n, e1) / nn
    d_const = _dot(n, v0)[:, None]
    uw = -_dot(u3, v0)[:, None]
    vw = -_dot(v3, v0)[:, None]
    return torch.cat([n, d_const, u3, uw, v3, vw], dim=1).T.contiguous()


def bake_origin(sup, clu, tri, origin):
    """The plane tables for rays that all leave ``origin`` (3,)
    (``trace_pallas.bake_origin``): boxes move by ``-origin``, and the
    triangle constants absorb the origin's dots, ``n.v0' = n.v0 - n.o``,
    ``uw' = uw + U.o``, ``vw' = vw + V.o``, so that ``t = n.v0' / n.d`` and
    ``u = t (U.d) + uw'`` for a ray from 0 along d.  Each dot rounds as XLA
    contracts the jitted JAX function on the CPU, ``fma(a_z, o_z, fma(a_x,
    o_x, a_y * o_y))``, so the two packages' tables agree bit for bit.
    Returns ``(sup', clu', tri')``."""
    origin = origin.to(torch.float32)
    shift = torch.cat([origin, origin])
    ox, oy, oz = origin[0], origin[1], origin[2]

    def odot(r0: int) -> torch.Tensor:
        return fma(tri[r0 + 2], oz, fma(tri[r0], ox, tri[r0 + 1] * oy))

    tri_b = tri.clone()
    tri_b[3] = tri[3] - odot(0)
    tri_b[7] = tri[7] + odot(4)
    tri_b[11] = tri[11] + odot(8)
    return sup - shift, clu - shift, tri_b


def _super_size(nc: int) -> int:
    """Clusters per super, sized so the super count fits one 128-vector."""
    s = max(8, -(-nc // NSP))
    return -(-s // 8) * 8


def super_layout(spec: BVHSpec):
    """(clusters_per_super, num_supers) for this BVH."""
    s = _super_size(spec.num_clusters)
    return s, -(-spec.num_clusters // s)


def _use_flat(spec: BVHSpec, flat=None) -> bool:
    """True when the scene takes the flat kernels (<= 128 padded clusters),
    as ``trace_pallas._use_flat`` decides."""
    if flat is not None:
        return bool(flat)
    s, ns = super_layout(spec)
    return s * ns <= FLAT_MAX_CLUSTERS


@named_scope("pack planes")
def pack_scene_planes(v0, e1, e2, node_lo, node_hi, spec: BVHSpec):
    """Scene repack into the kernel layouts: ``(sup (nsp, 6), clu (NS, S, 6),
    tri (12, T))``.  Boxes are ``[lo(3), hi(3)]`` rows; padding clusters and
    supers are inverted ``[BIG_T, -BIG_T]`` boxes that no slab test accepts.
    """
    nc = spec.num_clusters
    leaf0 = spec.first_leaf
    s = _super_size(nc)
    ns = -(-nc // s)
    pad = ns * s - nc
    big = torch.full((pad, 3), BIG_T, dtype=torch.float32)
    cl_lo = torch.cat([node_lo[leaf0:leaf0 + nc], big])
    cl_hi = torch.cat([node_hi[leaf0:leaf0 + nc], -big])
    sup_lo = cl_lo.reshape(ns, s, 3).amin(dim=1)
    sup_hi = cl_hi.reshape(ns, s, 3).amax(dim=1)
    nsp = max(8, -(-ns // 8) * 8)
    sbig = torch.full((nsp - ns, 3), BIG_T, dtype=torch.float32)
    sup = torch.cat([torch.cat([sup_lo, sbig]), torch.cat([sup_hi, -sbig])],
                    dim=1)
    clu = torch.cat([cl_lo.reshape(ns, s, 3), cl_hi.reshape(ns, s, 3)], dim=2)
    return sup, clu, pack_triangle_planes(v0, e1, e2)


def _dot3(v: torch.Tensor, rows: torch.Tensor, r0: int) -> torch.Tensor:
    """(N, 3) x three (T,) plane-row components -> (N, T)."""
    return (v[:, 0:1] * rows[r0][None, :] + v[:, 1:2] * rows[r0 + 1][None, :]
            + v[:, 2:3] * rows[r0 + 2][None, :])


def _global_tuv(o, d, rows):
    den = _dot3(d, rows, 0)
    num = rows[3][None, :] - _dot3(o, rows, 0)
    safe = torch.where(den.abs() < 1e-20,
                       torch.where(den < 0, -1e-20, 1e-20).to(den.dtype), den)
    t = num / safe
    u = _dot3(o, rows, 4) + t * _dot3(d, rows, 4) + rows[7][None, :]
    v = _dot3(o, rows, 8) + t * _dot3(d, rows, 8) + rows[11][None, :]
    return t, u, v


def global_seed_keys(o, d, mask, tri, spec: BVHSpec) -> torch.Tensor:
    """Per-ray packed closest-hit keys against the global set, computed on
    the host side of the kernel (plain PyTorch, exact divide); ``INIT`` where
    a ray hits none.  ``trace_pallas.global_seed_keys``."""
    gb, ng = spec.global_base, spec.num_global
    if ng == 0:
        return torch.full((o.shape[0],), _INIT_KEY, dtype=torch.int32,
                          device=o.device)
    t, u, v = _global_tuv(o, d, tri[:, gb:gb + ng])
    hit = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
           & mask[:, None])
    lane = torch.arange(ng, dtype=torch.int32, device=o.device)
    key = (t.view(torch.int32) & ~IDX_MASK) | lane[None, :]
    key = torch.where(hit, key, torch.full_like(key, _INIT_KEY))
    return key.amin(dim=1)


def global_any_hit(o, d, max_t, mask, tri, spec: BVHSpec) -> torch.Tensor:
    """Occlusion against the global set within ``(1e-6, max_t]``; the
    renderer folds it into the shadow mask.  ``trace_pallas.global_any_hit``.
    Returns (N,) bool."""
    gb, ng = spec.global_base, spec.num_global
    if ng == 0:
        return torch.zeros_like(mask)
    t, u, v = _global_tuv(o, d, tri[:, gb:gb + ng])
    hit = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
           & (t <= max_t[:, None]) & mask[:, None])
    return hit.any(dim=1)


def recompute_tuv(o, d, rows, eps: float = 1e-20):
    """Exact f32 (t, u, v) for known ray/triangle pairings; ``rows`` is the
    (N, 12) gather of the winners' plane rows.  ``trace_pallas.recompute_tuv``.
    """
    den = (rows[:, 0:3] * d).sum(-1)
    num = rows[:, 3] - (rows[:, 0:3] * o).sum(-1)
    safe = torch.where(den.abs() < eps, torch.full_like(den, eps), den)
    t = num / safe
    p = o + t[:, None] * d
    u = (rows[:, 4:7] * p).sum(-1) + rows[:, 7]
    v = (rows[:, 8:11] * p).sum(-1) + rows[:, 11]
    return t, u, v


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the two kernels
# ---------------------------------------------------------------------------


def _plane_hits(o, d, rows, baked: bool = False):
    """(n, C) hit distance and hit mask of rays (n, 3) against plane rows
    (12, C) shared by all rays, or (12, n, C) gathered per ray, in the
    kernels' op order: ``rcp = 1/den`` refined by one Newton step,
    ``t = (n.v0 - n.o) * rcp``, barycentrics at ``p = o + t d``
    (``trace_pallas._mt_block``).  ``baked``: rows of :func:`bake_origin`
    and rays from 0 (``o`` is not read), ``t = n.v0' * rcp``, ``u = t (U.d)
    + uw'``, ``v = t (V.d) + vw'``."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    nx, ny, nz, dc, ux, uy, uz, uw, vx, vy, vz, vw = (
        r if r.dim() == 2 else r[None, :] for r in rows)
    den = nx * dx + ny * dy + nz * dz
    rcp = 1.0 / den
    rcp = rcp * (2.0 - den * rcp)
    if baked:
        t = dc * rcp
        u = t * (ux * dx + uy * dy + uz * dz) + uw
        v = t * (vx * dx + vy * dy + vz * dz) + vw
    else:
        ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
        t = (dc - (nx * ox + ny * oy + nz * oz)) * rcp
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        u = ux * px + uy * py + uz * pz + uw
        v = vx * px + vy * py + vz * pz + vw
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
    return t, hit


def _ray_chunks(n: int, width: int, device):
    elems = (_REF_CHUNK_ELEMS if torch.device(device).type == "cuda"
             else _REF_CHUNK_ELEMS_HOST)
    step = max(1, elems // max(width, 1))
    for s in range(0, n, step):
        yield s, min(n, s + step)


def closest_flat_ref(o, d, mask, tri, spec: BVHSpec, seed_key=None,
                     seed_base=None, baked: bool = False):
    """Plain version of ``closest_flat_kernel`` and ``closest_hier_kernel``:
    both compute the minimum packed key over every clustered triangle from
    the seed, which this takes by brute force with the kernels' packed key,
    seed and hit test.  ``seed_base`` (N,) int32 is the slot base the seed
    key's index counts from (``closest_hier_kernel`` only; default
    ``global_base``).  Returns ``(t_chop (N,) f32, tri (N,) i32)``.

    Ties: the seed wins a tie with a cluster, and the lower cluster index
    wins among clusters.  The kernels walk clusters nearest-first instead
    (through supers, for the hierarchical one), so a kernel and this can
    pick different winners only among keys that tie after the 512-ulp chop,
    where the walk may skip a cluster whose entry is not below the running
    best.  ``baked``: ``tri`` from :func:`bake_origin` and the rays from its
    origin (the kernel's baked-origin form; ``o`` is not read)."""
    n = o.shape[0]
    c, nc = spec.cluster_size, spec.num_clusters
    dev = o.device
    key0 = (torch.full((n,), _INIT_KEY, dtype=torch.int32, device=dev)
            if seed_key is None else seed_key.to(torch.int32))
    best_key = key0.clone()
    best_base = (torch.full((n,), spec.global_base, dtype=torch.int32,
                            device=dev)
                 if seed_base is None else seed_base.to(torch.int32).clone())
    rows = tri[:, :nc * c]
    lane = torch.arange(c, dtype=torch.int32, device=dev).repeat(nc)
    live = mask.nonzero()[:, 0]  # a dead ray keeps its seed
    for s, e in _ray_chunks(live.shape[0], nc * c, dev):
        r = live[s:e]
        t, hit = _plane_hits(o[r], d[r], rows, baked)
        key = (t.view(torch.int32) & ~IDX_MASK) | lane[None, :]
        key = torch.where(hit, key, torch.full_like(key, _INIT_KEY))
        kmin, kidx = key.view(e - s, nc, c).amin(dim=2).min(dim=1)
        take = kmin < key0[r]
        best_key[r] = torch.where(take, kmin, key0[r])
        best_base[r] = torch.where(take, kidx.to(torch.int32) * c,
                                   best_base[r])
    found = best_key < _MISS_KEY
    tri_id = torch.where(found, best_base + (best_key & IDX_MASK),
                         torch.full_like(best_base, -1))
    return _key_to_t(best_key), tri_id


def any_flat_ref(o, d, max_t, mask, tri, spec: BVHSpec):
    """Plain version of ``any_flat_kernel`` and ``any_hier_kernel``, which
    both compute whether any triangle slot is hit within ``(1e-6, max_t]``.
    The slots include the global set, which the TPU kernels also dense-test
    (ROADMAP.md, Queue 3).  Returns (N,) bool."""
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    live = mask.nonzero()[:, 0]
    for s, e in _ray_chunks(live.shape[0], spec.padded_triangles,
                            o.device):
        r = live[s:e]
        t, hit = _plane_hits(o[r], d[r], tri)
        occ[r] = (hit & (t <= max_t[r, None])).any(dim=1)
    return occ


def _pick(o, d, boxes, t_max, bound, visited):
    """``pick_box`` of ``csrc/trace_common.cuh`` for every ray at once: the
    index (n,) of the nearest box of ``boxes`` ((B, 6) shared, or (n, B, 6)
    per ray) that is not ``visited`` (n, B), is slab-hit within ``t_max``
    and enters strictly below ``bound`` (n,); -1 where there is none.  Ties
    go to the lower index (``torch.min`` returns the first minimum)."""
    from .broadphase_cuda import slab_entry

    tn, hit = slab_entry(o, d, boxes, t_max)
    ok = hit & ~visited & (tn < bound[:, None])
    best, idx = torch.where(ok, tn, torch.inf).min(dim=1)
    return torch.where(best < torch.inf, idx, -1)


def _next_requests(o, d, t_max, bound, sup, clu, cur, svis, cvis):
    """One step of every ray's walk, as the kernels take it.  Two levels
    (the hierarchical kernels): the nearest unvisited cluster of the ray's
    current super ``cur`` (-1: none yet), else the nearest unvisited super
    and then its nearest cluster, until the ray has a cluster or its supers
    are drained; ``svis`` (n, NS) and ``cvis`` (n, S) are the visited masks.
    One level (the flat kernels, ``sup`` None): the nearest unvisited box of
    ``clu`` (NCP, 6), ``cvis`` (n, NCP) its visited mask.  Updates ``cur``,
    ``svis`` and ``cvis`` in place and returns the requested cluster id
    (n,), -1 for a ray whose walk has ended."""
    if sup is None:
        k = _pick(o, d, clu, t_max, bound, cvis)
        r = (k >= 0).nonzero()[:, 0]
        cvis[r, k[r]] = True
        return k
    s_per = clu.shape[1]
    req = torch.full_like(cur, -1)
    todo = torch.ones_like(cur, dtype=torch.bool)
    tm = (lambda r: None) if t_max is None else (lambda r: t_max[r])
    while bool(todo.any()):
        r = (todo & (cur < 0)).nonzero()[:, 0]
        if r.numel():
            s = _pick(o[r], d[r], sup, tm(r), bound[r], svis[r])
            got = s >= 0
            todo[r[~got]] = False
            r, s = r[got], s[got]
            svis[r, s] = True  # a super is never re-entered
            cur[r] = s
            cvis[r] = False
        r = (todo & (cur >= 0)).nonzero()[:, 0]
        if r.numel():
            k = _pick(o[r], d[r], clu[cur[r]], tm(r), bound[r], cvis[r])
            got = k >= 0
            cur[r[~got]] = -1  # the super's clusters are drained
            r, k = r[got], k[got]
            cvis[r, k] = True
            req[r] = cur[r] * s_per + k
            todo[r] = False
    return req


def _cluster_hits(o, d, tri, cbase, c: int, n_real=None, baked=False):
    """(t, hit) (n, c) of each ray against the ``c`` slots of its own
    cluster, from slot ``cbase`` (n,) on; with ``n_real`` (n,) only the
    first ``n_real`` slots of each (the ``counts`` option); ``baked`` as
    :func:`_plane_hits`."""
    lane = torch.arange(c, device=o.device)
    t, hit = _plane_hits(o, d, tri[:, cbase[:, None].long() + lane[None, :]],
                         baked)
    if n_real is not None:
        hit = hit & (lane[None, :] < n_real[:, None])
    return t, hit


def _walk_state(mask, sup, clu):
    """The walking rays' indices and their fresh (cur, svis, cvis), for the
    walk :func:`_next_requests` takes with these ``sup`` and ``clu``."""
    live = mask.nonzero()[:, 0]
    k, dev = live.shape[0], mask.device
    n_sup = 0 if sup is None else sup.shape[0]
    return (live, torch.full((k,), -1, dtype=torch.long, device=dev),
            torch.zeros((k, n_sup), dtype=torch.bool, device=dev),
            torch.zeros((k, clu.shape[-2]), dtype=torch.bool, device=dev))


def _note_round(rounds, n, rays, req) -> None:
    """Append one round's per-ray cluster requests (N,), -1 for none."""
    if rounds is not None:
        full = torch.full((n,), -1, dtype=torch.long, device=req.device)
        full[rays] = req
        rounds.append(full)


def _walk_closest(o, d, mask, sup, clu, tri, spec: BVHSpec, seed_key,
                  seed_base, rounds, counts=None, baked=False):
    """The closest walk of :func:`closest_hier_ref` (``sup`` the real
    supers, ``clu`` (NS, S, 6)) or :func:`closest_flat_walk_ref` (``sup``
    None, ``clu`` (NCP, 6)); ``counts`` (NCP,) as the kernels take it;
    ``baked``: the tables of :func:`bake_origin`, the rays from 0."""
    if baked:  # lo - 0 == lo: the slab test of the kernel's baked form
        o = torch.zeros_like(d)
    n, c, dev = o.shape[0], spec.cluster_size, o.device
    key = (torch.full((n,), _INIT_KEY, dtype=torch.int32, device=dev)
           if seed_key is None else seed_key.to(torch.int32).clone())
    base = (torch.full((n,), spec.global_base, dtype=torch.int32, device=dev)
            if seed_base is None else seed_base.to(torch.int32).clone())
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    rays, cur, svis, cvis = _walk_state(mask, sup, clu)
    step = max(1, _REF_GATHER_ELEMS // (N_TRI_PLANES * c))
    lane = torch.arange(c, dtype=torch.int32, device=dev)
    while rays.numel():
        req = _next_requests(o[rays], d[rays], None, _key_to_t(key[rays]),
                             sup, clu, cur, svis, cvis)
        go = req >= 0
        rays, cur, svis, cvis, req = (rays[go], cur[go], svis[go], cvis[go],
                                      req[go])
        if not rays.numel():
            break
        _note_round(rounds, n, rays, req)
        for s in range(0, rays.shape[0], step):
            r = rays[s:s + step]
            cbase = (req[s:s + step] * c).to(torch.int32)
            t, hit = _cluster_hits(o[r], d[r], tri, cbase, c,
                                   None if counts is None
                                   else counts[req[s:s + step]], baked)
            vkey = (t.view(torch.int32) & ~IDX_MASK) | lane[None, :]
            vkey = torch.where(hit, vkey, _INIT_KEY).amin(dim=1)
            take = vkey < key[r]
            key[r] = torch.where(take, vkey, key[r])
            base[r] = torch.where(take, cbase, base[r])
        visits[rays] += 1
    found = key < _MISS_KEY
    tri_id = torch.where(found, base + (key & IDX_MASK),
                         torch.full_like(base, -1))
    return _key_to_t(key), tri_id, visits


def _walk_any(o, d, max_t, mask, sup, clu, tri, spec: BVHSpec, g_slots: int,
              rounds, counts=None):
    """The occlusion walk of :func:`any_hier_ref` or
    :func:`any_flat_walk_ref` (``sup``, ``clu``, ``counts`` as
    :func:`_walk_closest`), after the global test over ``g_slots`` slots
    from ``global_base``."""
    n, c, dev = o.shape[0], spec.cluster_size, o.device
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    live = mask.nonzero()[:, 0]
    gb = spec.global_base
    for s, e in _ray_chunks(live.shape[0], g_slots, dev):
        r = live[s:e]
        t, hit = _plane_hits(o[r], d[r], tri[:, gb:gb + g_slots])
        occ[r] = (hit & (t <= max_t[r, None])).any(dim=1)
    rays, cur, svis, cvis = _walk_state(mask & ~occ, sup, clu)
    big = torch.full((n,), BIG_T, dtype=torch.float32, device=dev)
    step = max(1, _REF_GATHER_ELEMS // (N_TRI_PLANES * c))
    while rays.numel():
        req = _next_requests(o[rays], d[rays], max_t[rays], big[rays], sup,
                             clu, cur, svis, cvis)
        go = req >= 0
        rays, cur, svis, cvis, req = (rays[go], cur[go], svis[go], cvis[go],
                                      req[go])
        if not rays.numel():
            break
        _note_round(rounds, n, rays, req)
        for s in range(0, rays.shape[0], step):
            r = rays[s:s + step]
            t, hit = _cluster_hits(o[r], d[r], tri, req[s:s + step] * c, c,
                                   None if counts is None
                                   else counts[req[s:s + step]])
            occ[r] = (hit & (t <= max_t[r, None])).any(dim=1)
        visits[rays] += 1
        go = ~occ[rays]
        rays, cur, svis, cvis = rays[go], cur[go], svis[go], cvis[go]
    return occ, visits


def closest_hier_ref(o, d, mask, sup, clu, tri, spec: BVHSpec, seed_key=None,
                     seed_base=None, rounds=None, counts=None, baked=False):
    """Plain version of ``closest_hier_kernel`` that walks as the kernel
    does, every ray at once: in each round every walking ray takes the
    nearest unvisited super and cluster whose slab entry lies strictly below
    its chopped best (:func:`_next_requests`), gathers that cluster's slots,
    takes their minimum packed key, and replaces its best only on a strictly
    smaller key; a ray stops when its supers are drained.  Each ray visits
    exactly the clusters the kernel visits for it, so this shows the walk's
    cull, which the brute force of :func:`closest_flat_ref` cannot.

    ``sup`` (>= NS, 6), ``clu`` (NS, S, 6), ``tri`` (12, T) as
    :func:`trace_closest` takes them; ``seed_key`` / ``seed_base`` as there.
    ``rounds``: a list that receives each round's (N,) requested cluster id
    per ray (-1: none), the schedule a warp of the kernel serves.
    ``counts`` (NCP,) i32: test only each cluster's first ``counts`` slots
    (the kernels' option; the result is the same).  Returns ``(t_chop (N,)
    f32, tri (N,) i32, visits (N,) i32)``, ``visits`` the clusters each ray
    dense-tested.  ``baked``: the tables of :func:`bake_origin` and rays
    from its origin, as the kernel's baked form walks them (``o`` is not
    read).  The CPU path of :func:`trace_closest` with ``count_visits``;
    without, it stays :func:`closest_flat_ref`."""
    return _walk_closest(o, d, mask, sup[:clu.shape[0]], clu, tri, spec,
                         seed_key, seed_base, rounds, counts, baked)


def any_hier_ref(o, d, max_t, mask, sup, clu, tri, spec: BVHSpec,
                 rounds=None, counts=None):
    """Plain version of ``any_hier_kernel`` that walks as the kernel does:
    every live ray tests the ``padded_global`` global slots first, then the
    unoccluded ones walk supers and clusters in entry order under the
    ``max_t`` slab bound (:func:`_next_requests`), each leaving at its
    first occluder.  ``rounds`` and ``counts`` as :func:`closest_hier_ref`
    (the global test is not a round).  Returns ``(occluded (N,) bool,
    visits (N,) i32)``, ``visits`` the clusters each ray dense-tested.  The
    CPU path of :func:`trace_any` with ``count_visits``; without, it stays
    :func:`any_flat_ref`."""
    return _walk_any(o, d, max_t, mask, sup[:clu.shape[0]], clu, tri, spec,
                     spec.padded_global, rounds, counts)


def closest_flat_walk_ref(o, d, mask, clu, tri, spec: BVHSpec, seed_key=None,
                          rounds=None, counts=None):
    """Plain version of ``closest_flat_kernel`` that walks as the kernel
    does: :func:`closest_hier_ref`'s rounds on a walk of one level, each
    walking ray taking the nearest unvisited box of all ``clu`` (NS, S, 6)
    cluster boxes whose slab entry lies strictly below its chopped best.
    ``seed_key``, ``rounds`` and ``counts`` as there (the seed's base is
    ``global_base``).  Returns ``(t_chop, tri, visits)``."""
    return _walk_closest(o, d, mask, None, clu.reshape(-1, 6), tri, spec,
                         seed_key, None, rounds, counts)


def any_flat_walk_ref(o, d, max_t, mask, clu, tri, spec: BVHSpec,
                      rounds=None, counts=None):
    """Plain version of ``any_flat_kernel`` that walks as the kernel does:
    every live ray tests the ``num_global`` real global slots first, then
    the unoccluded ones walk all ``clu`` (NS, S, 6) cluster boxes in entry
    order under the ``max_t`` slab bound, each leaving at its first
    occluder.  ``rounds`` and ``counts`` as :func:`closest_hier_ref`.
    Returns ``(occluded, visits)``."""
    return _walk_any(o, d, max_t, mask, None, clu.reshape(-1, 6), tri, spec,
                     spec.num_global, rounds, counts)


def closest_walk_ref(o, d, mask, sup, clu, tri, spec: BVHSpec, seed_key=None,
                     seed_base=None, flat=None, rounds=None, counts=None,
                     baked=False):
    """The walking plain version of the closest kernel the route picks
    (``flat`` as :func:`trace_closest`): :func:`closest_flat_walk_ref` or
    :func:`closest_hier_ref` (``baked`` as there).  Returns ``(t_chop, tri,
    visits)``."""
    if _use_flat(spec, flat):
        if seed_base is not None or baked:
            raise ValueError("seed_base and baked require the hierarchical "
                             "walk")
        return closest_flat_walk_ref(o, d, mask, clu, tri, spec, seed_key,
                                     rounds, counts)
    return closest_hier_ref(o, d, mask, sup, clu, tri, spec, seed_key,
                            seed_base, rounds, counts, baked)


def any_walk_ref(o, d, max_t, mask, sup, clu, tri, spec: BVHSpec, flat=None,
                 rounds=None, counts=None):
    """The walking plain version of the any-hit kernel the route picks:
    :func:`any_flat_walk_ref` or :func:`any_hier_ref`.  Returns
    ``(occluded, visits)``."""
    if _use_flat(spec, flat):
        return any_flat_walk_ref(o, d, max_t, mask, clu, tri, spec, rounds,
                                 counts)
    return any_hier_ref(o, d, max_t, mask, sup, clu, tri, spec, rounds,
                        counts)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _check_rays(o, d, mask, extra=()):
    n = o.shape[0]
    for name, x, shape, dtype in (("o", o, (n, 3), torch.float32),
                                  ("d", d, (n, 3), torch.float32),
                                  ("mask", mask, (n,), torch.bool)) + extra:
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")


def _check_tables(device, **tables) -> None:
    for name, x in tables.items():
        if x.dtype != torch.float32 or x.device != device:
            raise ValueError(f"{name} must be float32 on {device}, got "
                             f"{x.dtype} on {x.device}")


def _kernel_tables(spec: BVHSpec, sup, clu, tri, flat=None):
    """``(hier, sup, clu, tri)``: the route :func:`_use_flat` picks and the
    contiguous plane tables its kernel reads (the flat kernels read every
    cluster box, the hierarchical ones the real supers and their
    clusters).  Raises on tables the kernels do not take."""
    hier = not _use_flat(spec, flat)
    if spec.cluster_size > (1 << IDX_BITS):
        raise ValueError(f"cluster_size {spec.cluster_size} does not fit the "
                         f"{IDX_BITS}-bit in-cluster index of the packed key")
    _check_tables(tri.device, sup=sup, clu=clu)
    if (clu.dim() != 3 or clu.shape[2] != 6 or sup.dim() != 2
            or sup.shape[1] != 6 or sup.shape[0] < clu.shape[0]
            or clu.shape[0] * clu.shape[1] < spec.num_clusters
            or tri.dim() != 2 or tri.shape[0] != N_TRI_PLANES
            or tri.shape[1] < spec.global_base + spec.padded_global):
        raise ValueError(f"bad plane tables: sup {tuple(sup.shape)}, clu "
                         f"{tuple(clu.shape)}, tri {tuple(tri.shape)}")
    ns, s_per = clu.shape[0], clu.shape[1]
    if hier and (ns > NSP or s_per > MAX_PER_SUPER):
        raise ValueError(f"the hierarchical kernels take <= {NSP} supers of "
                         f"<= {MAX_PER_SUPER} clusters, got {ns} x "
                         f"{s_per}")
    if not hier and ns * s_per > FLAT_MAX_CLUSTERS:
        raise ValueError(f"the flat kernels take <= {FLAT_MAX_CLUSTERS} "
                         f"clusters, got {ns * s_per}")
    return (hier, sup[:ns].contiguous(), clu.contiguous(), tri.contiguous())


def active_counts(spec: BVHSpec, counts):
    """``counts`` where the kernels use it: only on builds that mark
    ``partial_clusters``, as ``trace_pallas`` decides; else None."""
    return counts if counts is not None and spec.partial_clusters else None


def _check_counts(counts, clu, device) -> None:
    ncp = clu.shape[0] * clu.shape[1]
    if counts is not None and (
            counts.dtype != torch.int32 or counts.device != device
            or counts.dim() != 1 or counts.shape[0] < ncp):
        raise ValueError(f"counts must be int32 (>= {ncp},) on {device}, got "
                         f"{counts.dtype} {tuple(counts.shape)} on "
                         f"{counts.device}")


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.kernels_error_string(err).decode()}")


def _wide(clu) -> int:
    """1 where the hierarchical launchers pick the wide instance for these
    cluster tables (supers of more than ``SHARED_PER_SUPER`` clusters)."""
    return int(clu.shape[1] > SHARED_PER_SUPER)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def trace_closest(o, d, mask, sup, clu, tri, spec: BVHSpec, seed_key=None,
                  flat=None, seed_base=None, count_visits=False, counts=None,
                  baked_origin=False):
    """Closest hit of each ray: ``closest_flat_kernel`` or
    ``closest_hier_kernel`` on a CUDA device (``flat`` as
    ``trace_pallas.trace_closest``: None picks by cluster count),
    :func:`closest_flat_ref` on the CPU.

    ``sup`` (nsp, 6), ``clu`` (NS, S, 6) and ``tri`` (12, T) are the packed
    planes of :func:`pack_scene_planes`; ``seed_key`` the per-ray host seed
    of :func:`global_seed_keys` (computed here when the scene has a global
    set and none is given).  ``seed_base`` (N,) int32 gives each ray the
    slot base of its seed key in place of ``global_base`` (the rank-directed
    walk's best as the seed); it needs ``seed_key`` and the hierarchical
    kernel, as in the reference.  ``counts`` and ``count_visits``: the
    kernels' options (module docstring).  Returns a :class:`Hit` whose
    ``t`` is the chopped distance of the packed key (``u``/``v`` are zeros:
    the renderer recomputes the exact t from the shade row), with
    ``count_visits`` ``(Hit, visits (N,) int32)``.

    ``baked_origin=True``: ``sup``, ``clu`` and ``tri`` are the tables of
    :func:`bake_origin` for the origin every ray leaves from, and the
    hierarchical kernel's baked form traces them (a flat scene raises, as in
    the reference).  ``o`` is then the zero origin of the shifted frame:
    the kernel does not read it, and the seed computed here when none is
    given uses 0.  The hit distances are the same in both frames."""
    if seed_base is not None:
        if seed_key is None:
            raise ValueError("seed_base needs the seed_key it belongs to")
        if _use_flat(spec, flat):
            raise ValueError("seed_base requires the hierarchical kernel "
                             "(pass flat=False)")
    if baked_origin:
        if _use_flat(spec, flat):
            raise ValueError("baked_origin requires the hierarchical kernel "
                             "(pass flat=False or gate on _use_flat)")
        if seed_key is None and spec.num_global:
            # from the rays' origin in the shifted frame
            seed_key = global_seed_keys(torch.zeros_like(d), d, mask, tri,
                                        spec)
    if seed_key is None and spec.num_global:
        seed_key = global_seed_keys(o, d, mask, tri, spec)
    n = o.shape[0]
    extra = tuple((name, x, (n,), torch.int32)
                  for name, x in (("seed_key", seed_key),
                                  ("seed_base", seed_base)) if x is not None)
    _check_rays(o, d, mask, extra)
    counts = active_counts(spec, counts)
    visits = None
    if o.device.type == "cpu":
        if count_visits:
            t, tri_id, visits = closest_walk_ref(
                o, d, mask, sup, clu, tri, spec, seed_key, seed_base, flat,
                counts=counts, baked=baked_origin)
        else:
            t, tri_id = closest_flat_ref(o, d, mask, tri, spec, seed_key,
                                         seed_base, baked_origin)
    elif o.device.type == "cuda":
        from ._build import load_library

        _check_tables(o.device, tri=tri)
        hier, sup_c, clu_c, tri_c = _kernel_tables(spec, sup, clu, tri, flat)
        _check_counts(counts, clu_c, o.device)
        lib = load_library()
        o_c, d_c, m_c = o.contiguous(), d.contiguous(), mask.contiguous()
        s_c = None if seed_key is None else seed_key.contiguous()
        sb_c = None if seed_base is None else seed_base.contiguous()
        t = torch.empty((n,), dtype=torch.float32, device=o.device)
        tri_id = torch.empty((n,), dtype=torch.int32, device=o.device)
        if count_visits:
            visits = torch.zeros((n,), dtype=torch.int32, device=o.device)
        if n and baked_origin:
            err = lib.launch_closest_hier_baked(
                _ptr(d_c), _ptr(m_c), _ptr(s_c), _ptr(sb_c), _ptr(sup_c),
                _ptr(clu_c), _ptr(tri_c), n, clu_c.shape[0], clu_c.shape[1],
                spec.cluster_size, tri_c.shape[1], spec.global_base,
                _ptr(counts), _ptr(t), _ptr(tri_id), _ptr(visits),
                _stream(o.device))
            _raise_on(err, lib, "closest_hier_kernel (baked origin)")
            trace_closest.launches_baked += 1
            trace_closest.launches_wide += _wide(clu_c)
        elif n and hier:
            err = lib.launch_closest_hier(
                _ptr(o_c), _ptr(d_c), _ptr(m_c), _ptr(s_c), _ptr(sb_c),
                _ptr(sup_c), _ptr(clu_c), _ptr(tri_c), n, clu_c.shape[0],
                clu_c.shape[1], spec.cluster_size, tri_c.shape[1],
                spec.global_base, _ptr(counts), _ptr(t), _ptr(tri_id),
                _ptr(visits), _stream(o.device))
            _raise_on(err, lib, "closest_hier_kernel")
            trace_closest.launches_hier += 1
            trace_closest.launches_wide += _wide(clu_c)
        elif n:
            err = lib.launch_closest_flat(
                _ptr(o_c), _ptr(d_c), _ptr(m_c), _ptr(s_c), _ptr(clu_c),
                _ptr(tri_c), n, clu_c.shape[0] * clu_c.shape[1],
                spec.cluster_size, tri_c.shape[1], spec.global_base,
                _ptr(counts), _ptr(t), _ptr(tri_id), _ptr(visits),
                _stream(o.device))
            _raise_on(err, lib, "closest_flat_kernel")
            trace_closest.launches += 1
    else:
        raise ValueError(f"unsupported device {o.device}")
    z = torch.zeros_like(t)
    hit = Hit(t=t, u=z, v=z, tri=tri_id)
    return (hit, visits) if count_visits else hit


trace_closest.launches = 0
trace_closest.launches_hier = 0
trace_closest.launches_baked = 0
trace_closest.launches_wide = 0


def trace_any(o, d, max_t, mask, sup, clu, tri, spec: BVHSpec, flat=None,
              count_visits=False, counts=None):
    """Occlusion of each ray segment ``(1e-6, max_t]``: ``any_flat_kernel``
    or ``any_hier_kernel`` on a CUDA device (``flat`` as
    :func:`trace_closest`), :func:`any_flat_ref` on the CPU.  Returns (N,)
    bool, with ``count_visits`` ``(occluded, visits (N,) int32)``;
    ``counts`` as :func:`trace_closest`.

    Like the TPU kernels with ``seed_global=False``, both kernels still
    test the global slots before their cluster walk: ``any_flat_kernel``
    the ``num_global`` real ones, each lane its own ray;
    ``any_hier_kernel`` all ``padded_global`` (the TPU kernels' 128-slot
    chunks, whose padding is never hit), through its warp-shared leaf test
    as one group of every live lane."""
    n = o.shape[0]
    _check_rays(o, d, mask, (("max_t", max_t, (n,), torch.float32),))
    counts = active_counts(spec, counts)
    if o.device.type == "cpu":
        if count_visits:
            return any_walk_ref(o, d, max_t, mask, sup, clu, tri, spec, flat,
                                counts=counts)
        return any_flat_ref(o, d, max_t, mask, tri, spec)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    from ._build import load_library

    _check_tables(o.device, tri=tri)
    hier, sup_c, clu_c, tri_c = _kernel_tables(spec, sup, clu, tri, flat)
    _check_counts(counts, clu_c, o.device)
    lib = load_library()
    o_c, d_c = o.contiguous(), d.contiguous()
    mt_c, m_c = max_t.contiguous(), mask.contiguous()
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)
    visits = (torch.zeros((n,), dtype=torch.int32, device=o.device)
              if count_visits else None)
    if n and hier:
        err = lib.launch_any_hier(
            _ptr(o_c), _ptr(d_c), _ptr(mt_c), _ptr(m_c), _ptr(sup_c),
            _ptr(clu_c), _ptr(tri_c), n, clu_c.shape[0], clu_c.shape[1],
            spec.cluster_size, tri_c.shape[1], spec.global_base,
            spec.padded_global, _ptr(counts), _ptr(occ), _ptr(visits),
            _stream(o.device))
        _raise_on(err, lib, "any_hier_kernel")
        trace_any.launches_hier += 1
        trace_any.launches_wide += _wide(clu_c)
    elif n:
        err = lib.launch_any_flat(
            _ptr(o_c), _ptr(d_c), _ptr(mt_c), _ptr(m_c), _ptr(clu_c),
            _ptr(tri_c), n, clu_c.shape[0] * clu_c.shape[1],
            spec.cluster_size, tri_c.shape[1], spec.global_base,
            spec.num_global, _ptr(counts), _ptr(occ), _ptr(visits),
            _stream(o.device))
        _raise_on(err, lib, "any_flat_kernel")
        trace_any.launches += 1
    return (occ, visits) if count_visits else occ


trace_any.launches = 0
trace_any.launches_hier = 0
trace_any.launches_wide = 0


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counts (the broad phase's, the
    rank walk's and the BVH tracers' too)."""
    from . import trace
    from .broadphase_cuda import broadphase_keys, nearest_cluster
    from .rank_cuda import trace_closest_rank

    trace_closest.launches = trace_closest.launches_hier = 0
    trace_closest.launches_baked = trace_closest.launches_wide = 0
    trace_any.launches = trace_any.launches_hier = 0
    trace_any.launches_wide = 0
    broadphase_keys.launches = broadphase_keys.launches_clusters = 0
    nearest_cluster.launches = nearest_cluster.launches_pair = 0
    trace_closest_rank.launches = 0
    trace.trace_closest.launches = trace.trace_any.launches = 0
