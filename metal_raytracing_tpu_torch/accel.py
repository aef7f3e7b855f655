"""Acceleration structure: cluster BVH with an implicit B-ary tree (numpy).

The port's counterpart of ``metal_raytracing_tpu.accel``: a one-time host
build at scene load.  Triangles are grouped into leaf clusters of at most
``cluster_size`` by the unquantized cluster-granular SAH (``sah_free``, the
default builder), a few scene-spanning triangles go to a separate *global
set*, and an implicit complete B-ary tree of AABBs sits above the clusters.

Every builder of the JAX package is here: ``sah_free`` (the default),
``sah`` (binned SAH at cluster quantization), ``median``, ``morton``,
``sah_chunk`` (chunk-granular cost, partly full clusters), ``ploc``
(bottom-up agglomeration), ``sah_rays`` (splits scored by a measured ray
sample, ``RenderConfig.export_rays``), and the SBVH-style reference
pre-split (``presplit``).  The build is the port's own copy of the JAX
package's numpy code, so the two packages produce the same clusters, node
boxes and ``BVHSpec`` (whose ``repr`` feeds the checkpoint fingerprint)
bit for bit.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from .utils.profiling import named_scope

__all__ = ["BVHSpec", "BUILDERS", "morton_codes_3d", "build_cluster_bvh",
           "sah_split_order", "median_split_order", "sah_free_clusters",
           "ploc_clusters", "presplit_references"]

# The builders of build_cluster_bvh (the JAX package's).
BUILDERS = ("sah", "sah_free", "sah_chunk", "median", "morton", "ploc",
            "sah_rays")


@dataclasses.dataclass(frozen=True)
class BVHSpec:
    """Static traversal metadata; field for field the JAX package's
    ``BVHSpec`` (same class name, field order and ``repr``)."""

    num_triangles: int  # real triangles (pre-padding)
    padded_triangles: int  # num_clusters * cluster_size + padded_global
    cluster_size: int  # triangles per leaf cluster
    num_clusters: int  # real clusters
    branching: int  # tree fan-out B
    levels: int  # tree depth (0 => root is the only leaf)
    num_nodes: int  # total implicit nodes
    first_leaf: int  # index of first leaf node in heap order
    # Global set: the few scene-spanning triangles, pulled out of the
    # clusters into dedicated slots at the end of the padded tables.
    num_global: int = 0  # real global triangles
    padded_global: int = 0  # global slots (128-multiple, 0 when none)
    # Baldwin-Weber plane rows [n(3), n.v0, U(3), uw, V(3), vw] of the
    # global triangles as plain floats.
    global_planes: tuple = ()
    # True when enough clusters are partially full to make a chunk skip pay.
    partial_clusters: bool = False

    @property
    def global_base(self) -> int:
        """First global slot = end of the clustered slot region."""
        return self.num_clusters * self.cluster_size

    @property
    def max_stack(self) -> int:
        """Stack slots of a walk over the implicit tree: each internal
        visit pops 1 and pushes <= B, and the depth bounds the growth."""
        return (self.branching - 1) * max(self.levels, 1) + 2


def _expand_bits_10(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of each int so they occupy every 3rd bit."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton_codes_3d(points: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points quantized to a 1024^3 grid over [lo, hi]."""
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip(((points - lo) / extent) * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (
        (_expand_bits_10(q[:, 0]) << np.uint32(2))
        | (_expand_bits_10(q[:, 1]) << np.uint32(1))
        | _expand_bits_10(q[:, 2])
    ).astype(np.uint32)


def median_split_order(centroids: np.ndarray, cluster_size: int) -> np.ndarray:
    """Recursive longest-axis median split with cluster-quantized partition
    sizes: returns a triangle permutation where each consecutive
    ``cluster_size`` slice is a spatially tight cluster.

    Tighter leaf AABBs than raw Morton ordering (a Morton-run cluster can
    straddle large curve jumps), which directly cuts the number of candidate
    clusters a traversal block must test.  Split counts are rounded to
    multiples of ``cluster_size`` so leaves are exactly full — no padding
    waste in the dense (rays x cluster) leaf tests.
    """
    t = centroids.shape[0]
    c = cluster_size
    out = np.empty(t, np.int64)
    pos = 0
    stack = [np.arange(t, dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if len(ids) <= c:
            out[pos:pos + len(ids)] = ids
            pos += len(ids)
            continue
        pts = centroids[ids]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        # left count: half the clusters, in whole clusters
        n_clusters = -(-len(ids) // c)
        k = (n_clusters // 2) * c
        part = np.argpartition(pts[:, axis], k if k < len(ids) else len(ids) - 1)
        stack.append(ids[part[k:]])  # right pushed first -> left emitted first
        stack.append(ids[part[:k]])
    assert pos == t
    return out


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Half surface area of AABBs; empty (inverted) boxes score 0."""
    ext = np.maximum(hi - lo, 0.0)
    return ext[..., 0] * ext[..., 1] + ext[..., 1] * ext[..., 2] + ext[..., 2] * ext[..., 0]


def sah_split_order(
    tri_lo: np.ndarray,
    tri_hi: np.ndarray,
    centroids: np.ndarray,
    cluster_size: int,
    n_bins: int = 32,
) -> np.ndarray:
    """Recursive binned-SAH split with cluster-quantized partition sizes.

    Same output contract as :func:`median_split_order` (a triangle
    permutation whose consecutive ``cluster_size`` slices are leaves), but
    each split minimizes the surface-area heuristic over ``n_bins`` centroid
    bins per axis instead of blindly halving the longest axis.  Split counts
    snap to the nearest ``cluster_size`` multiple so leaves stay exactly
    full.  SAH-quality splits directly cut the clusters-visited count that
    dominates bounce-pass traversal (the reference gets this quality from
    Metal's closed-source AS build, Renderer.swift:185-191).
    """
    t = centroids.shape[0]
    c = cluster_size
    out = np.empty(t, np.int64)
    pos = 0
    stack = [np.arange(t, dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if len(ids) <= c:
            out[pos:pos + len(ids)] = ids
            pos += len(ids)
            continue
        pts = centroids[ids]
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        ext = hi - lo
        n_here = len(ids)
        max_k = ((n_here - 1) // c) * c  # leave >= 1 triangle on the right

        best_cost = np.inf
        best_axis = -1
        best_k = 0
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            rel = np.clip(((pts[:, axis] - lo[axis]) / ext[axis]
                           * n_bins).astype(np.int64), 0, n_bins - 1)
            counts = np.bincount(rel, minlength=n_bins)
            bl = np.full((n_bins, 3), np.inf)
            bh = np.full((n_bins, 3), -np.inf)
            np.minimum.at(bl, rel, tri_lo[ids])
            np.maximum.at(bh, rel, tri_hi[ids])
            # prefix (left-of-boundary) and suffix sweeps over bins
            pre_lo = np.minimum.accumulate(bl, axis=0)
            pre_hi = np.maximum.accumulate(bh, axis=0)
            suf_lo = np.minimum.accumulate(bl[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(bh[::-1], axis=0)[::-1]
            pre_n = np.cumsum(counts)
            # boundary b: left = bins [0, b], right = bins [b+1, n_bins)
            left_cost = _surface_area(pre_lo[:-1], pre_hi[:-1]) * pre_n[:-1]
            right_cost = (_surface_area(suf_lo[1:], suf_hi[1:])
                          * (n_here - pre_n[:-1]))
            # quantize each boundary's left count to whole clusters
            ks = np.clip(np.rint(pre_n[:-1] / c).astype(np.int64) * c,
                         c, max(max_k, c))
            cost = left_cost + right_cost
            valid = (ks >= c) & (ks <= max_k)
            if not valid.any():
                continue
            cost = np.where(valid, cost, np.inf)
            b = int(np.argmin(cost))
            if cost[b] < best_cost:
                best_cost = cost[b]
                best_axis = axis
                best_k = int(ks[b])
        if best_axis < 0:
            # degenerate spread: halve on the longest axis
            best_axis = int(np.argmax(ext))
            best_k = max((n_here // (2 * c)) * c, c)
        part = np.argpartition(pts[:, best_axis], best_k)
        stack.append(ids[part[best_k:]])  # right pushed first -> left first
        stack.append(ids[part[:best_k]])
    assert pos == t
    return out


def sah_free_clusters(
    tri_lo: np.ndarray,
    tri_hi: np.ndarray,
    centroids: np.ndarray,
    cluster_size: int,
    n_bins: int = 32,
    chunk: int = 0,
    alpha: float = 1.0,
    rays: Optional[np.ndarray] = None,
    ray_min: int = 48,
) -> list:
    """Unquantized cluster-granular SAH: a list of per-cluster
    reference-index arrays, each of length <= ``cluster_size``.

    Unlike :func:`sah_split_order`, split positions are not snapped to
    ``cluster_size`` multiples, so clusters may be partly full (the leaf
    test pads them with degenerate never-hit slots).  A cluster visit costs
    one dense test however full the cluster is, so each candidate split is
    scored ``SA(left) * ceil(n_left / c) + SA(right) * ceil(n_right / c)``:
    the surface-area-weighted number of clusters a ray can enter.
    Depth-first emission keeps consecutive clusters spatially close, which
    the super level relies on.

    ``chunk > 0`` switches to the chunk-granular cost model (the
    ``sah_chunk`` builder): with the kernels' partial-cluster chunk skip a
    visit costs ``alpha + ceil(n / chunk)`` chunk units (``alpha``: the
    per-visit pick and slab work in chunk tests), so splits are scored
    ``SA * (alpha * clusters + chunks)`` a side, and a node may keep
    splitting below ``cluster_size`` while a split lowers that cost.

    ``rays`` (the ``sah_rays`` builder): an (M, 8) row table ``[ox oy oz
    dx dy dz max_t live]`` of measured rays, the strided sample a render
    exported (``RenderConfig.export_rays``).  Splits are then scored
    ``R(box) * ceil(n / c)``, ``R`` the sample rays whose slab interval
    meets the candidate box (a cluster visit happens iff a ray's slab hits
    the cluster box), with surface area as the fallback once a subtree sees
    fewer than ``ray_min`` samples.  Each child inherits only the rays that
    hit its box, so the scoring work follows the sample's visits.
    ``metal_raytracing_tpu.accel.sah_free_clusters``, line for line.
    """
    c = cluster_size

    if rays is not None:
        live = rays[:, 7] > 0.0
        r_o = np.ascontiguousarray(rays[live, 0:3], np.float64)
        r_d = rays[live, 3:6].astype(np.float64)
        r_inv = 1.0 / np.where(np.abs(r_d) < 1e-12,
                               np.copysign(1e-12, r_d), r_d)
        r_maxt = rays[live, 6].astype(np.float64)
        if r_o.shape[0] == 0:
            rays = None

    def _ray_hits(ri, blo, bhi):
        """(len(ri), B) bool: does sample ray i's slab interval hit box b
        (the slab test of ops.broadphase_cuda.nearest_cluster)."""
        t0 = (blo[None, :, :] - r_o[ri, None, :]) * r_inv[ri, None, :]
        t1 = (bhi[None, :, :] - r_o[ri, None, :]) * r_inv[ri, None, :]
        tn = np.minimum(t0, t1).max(axis=2)
        tf = np.maximum(t0, t1).min(axis=2)
        return (tn <= tf) & (tf >= 0.0) & (tn <= r_maxt[ri, None])

    def side_cost(sa, n):
        ncl = np.ceil(n / c)
        if chunk:
            return sa * (alpha * ncl + np.ceil(n / chunk))
        return sa * ncl

    clusters: list = []
    all_rays = (np.arange(r_o.shape[0], dtype=np.int64)
                if rays is not None else None)
    stack = [(np.arange(centroids.shape[0], dtype=np.int64), all_rays)]
    while stack:
        ids, rsub = stack.pop()
        if len(ids) <= (chunk if chunk else c):
            clusters.append(ids)
            continue
        pts = centroids[ids]
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        ext = hi - lo
        n_here = len(ids)
        use_rays = rays is not None and len(rsub) >= ray_min

        best_cost = np.inf
        best_axis = -1
        best_k = 0
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            rel = np.clip(((pts[:, axis] - lo[axis]) / ext[axis]
                           * n_bins).astype(np.int64), 0, n_bins - 1)
            counts = np.bincount(rel, minlength=n_bins)
            bl = np.full((n_bins, 3), np.inf)
            bh = np.full((n_bins, 3), -np.inf)
            np.minimum.at(bl, rel, tri_lo[ids])
            np.maximum.at(bh, rel, tri_hi[ids])
            pre_lo = np.minimum.accumulate(bl, axis=0)
            pre_hi = np.maximum.accumulate(bh, axis=0)
            suf_lo = np.minimum.accumulate(bl[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(bh[::-1], axis=0)[::-1]
            pre_n = np.cumsum(counts)
            ln = pre_n[:-1]
            rn = n_here - ln
            if use_rays:
                # measured-ray visit counts of every candidate side box
                # (+1 Laplace so zero-sample sides still prefer fewer
                # clusters); empty sides keep inverted boxes out via ln/rn
                rl = _ray_hits(rsub, pre_lo[:-1], pre_hi[:-1]).sum(axis=0)
                rr = _ray_hits(rsub, suf_lo[1:], suf_hi[1:]).sum(axis=0)
                cost = ((rl + 1.0) * np.ceil(ln / c)
                        + (rr + 1.0) * np.ceil(rn / c))
            else:
                # SA-weighted cluster counts (or chunk-units, see
                # side_cost)
                cost = (side_cost(_surface_area(pre_lo[:-1], pre_hi[:-1]),
                                  ln)
                        + side_cost(_surface_area(suf_lo[1:], suf_hi[1:]),
                                    rn))
            valid = (ln >= 1) & (rn >= 1)
            if not valid.any():
                continue
            cost = np.where(valid, cost, np.inf)
            b = int(np.argmin(cost))
            if cost[b] < best_cost:
                best_cost = cost[b]
                best_axis = axis
                best_k = int(ln[b])
        if chunk and n_here <= c and best_axis >= 0:
            # below cluster_size a split is optional: keep it only when it
            # beats this node's own no-split cost
            no_split = side_cost(
                float(_surface_area(tri_lo[ids].min(axis=0)[None],
                                    tri_hi[ids].max(axis=0)[None])[0]),
                n_here)
            if best_cost >= no_split:
                clusters.append(ids)
                continue
        if best_axis < 0:
            if n_here <= c:
                # chunk mode reaches here when every axis is degenerate
                clusters.append(ids)
                continue
            # degenerate spread (all centroids coincident): halve by count
            best_axis = int(np.argmax(ext))
            best_k = n_here // 2
        part = np.argpartition(pts[:, best_axis], best_k)
        ids_l = ids[part[:best_k]]
        ids_r = ids[part[best_k:]]
        if rays is not None:
            # children inherit only the sample rays that hit their box
            rs_l = rs_r = rsub
            if len(rsub):
                lb = np.stack([tri_lo[ids_l].min(axis=0),
                               tri_lo[ids_r].min(axis=0)])
                hb = np.stack([tri_hi[ids_l].max(axis=0),
                               tri_hi[ids_r].max(axis=0)])
                h = _ray_hits(rsub, lb, hb)
                rs_l = rsub[h[:, 0]]
                rs_r = rsub[h[:, 1]]
            stack.append((ids_r, rs_r))  # right first -> left emitted first
            stack.append((ids_l, rs_l))
        else:
            stack.append((ids_r, None))
            stack.append((ids_l, None))
    return clusters


def ploc_clusters(
    tri_lo: np.ndarray,
    tri_hi: np.ndarray,
    cluster_size: int,
    window: int = 16,
) -> list:
    """Bottom-up agglomerative (PLOC-style) clustering into groups of
    <= ``cluster_size`` references.

    Where :func:`sah_free_clusters` carves clusters TOP-DOWN with binned
    axis-aligned splits, this builds them BOTTOM-UP: every reference starts
    as its own group; each round, groups find their best merge partner
    within a ``window``-wide neighborhood of the Morton-sorted group order
    (the PLOC search structure — Meister & Bittner, "Parallel Locally-
    Ordered Clustering", TVCG 2018 — public algorithm, re-implemented here
    in numpy), scored by MERGED-box half-surface-area, and mutual best
    pairs whose combined size fits ``cluster_size`` merge.  Rounds repeat
    until no feasible mutual pair remains.

    The traversal cost unit this optimizes is the same one sah_free's
    model uses: a cluster VISIT costs a full dense test regardless of
    occupancy, and a ray enters a cluster with probability ~ its box
    surface area — so the objective is Σ SA(cluster) at bounded size.
    Agglomeration can realize groupings axis-aligned splits cannot
    (diagonal/curved shells), at the cost of less-balanced fill; padding
    slots are degenerate never-hit triangles either way (scene.permute).

    Returns a list of per-group reference-index arrays in Morton order of
    the group centroids (consecutive cluster ids stay spatially local —
    the implicit B-ary super level unions consecutive id ranges).
    """
    n = int(tri_lo.shape[0])
    c = int(cluster_size)
    if n == 0:
        return []
    lo = tri_lo.astype(np.float64).copy()
    hi = tri_hi.astype(np.float64).copy()
    cnt = np.ones(n, np.int64)
    groups = [np.array([i], np.int64) for i in range(n)]
    scene_lo = lo.min(axis=0)
    scene_hi = hi.max(axis=0)

    while len(groups) > 1:
        k = len(groups)
        cen = 0.5 * (lo + hi)
        order = np.argsort(morton_codes_3d(cen, scene_lo, scene_hi),
                           kind="stable")
        lo, hi, cnt = lo[order], hi[order], cnt[order]
        groups = [groups[i] for i in order]
        w = min(window, k - 1)
        # forward-offset merged SA: cost[i, dj] = SA(union(i, i + dj + 1))
        cost = np.full((k, w), np.inf)
        for dj in range(1, w + 1):
            mlo = np.minimum(lo[:-dj], lo[dj:])
            mhi = np.maximum(hi[:-dj], hi[dj:])
            sa_m = _surface_area(mlo, mhi)
            # feasible and beneficial: a visit costs the same dense test
            # either way and a ray enters a box with probability ~ SA, so
            # merging pays only while SA(union) < SA(a) + SA(b); without
            # this, end-game merges of distant leftovers build giant boxes
            feas = ((cnt[:-dj] + cnt[dj:]) <= c) & (
                sa_m < _surface_area(lo[:-dj], hi[:-dj])
                + _surface_area(lo[dj:], hi[dj:]))
            cost[: k - dj, dj - 1] = np.where(feas, sa_m, np.inf)
        # per-group best partner over forward AND backward offsets
        best = np.full(k, -1, np.int64)
        bestc = np.full(k, np.inf)
        fwd_j = np.arange(k)[:, None] + np.arange(1, w + 1)[None, :]
        fi = np.argmin(cost, axis=1)
        fc = cost[np.arange(k), fi]
        upd = fc < bestc
        bestc = np.where(upd, fc, bestc)
        best = np.where(upd, np.take_along_axis(
            fwd_j, fi[:, None], 1)[:, 0].clip(max=k - 1), best)
        # backward: group j = i + dj sees the same pair cost
        for dj in range(1, w + 1):
            cc = cost[: k - dj, dj - 1]
            tgt = np.arange(dj, k)
            upd = cc < bestc[tgt]
            bestc[tgt] = np.where(upd, cc, bestc[tgt])
            best[tgt] = np.where(upd, np.arange(0, k - dj), best[tgt])
        # mutual best pairs merge (the PLOC round rule)
        has = (best >= 0) & np.isfinite(bestc)
        mutual = has & (best[best.clip(min=0)] == np.arange(k))
        first = mutual & (np.arange(k) < best)
        srcs = np.nonzero(first)[0]
        if len(srcs) == 0:
            break
        dsts = best[srcs]
        lo[srcs] = np.minimum(lo[srcs], lo[dsts])
        hi[srcs] = np.maximum(hi[srcs], hi[dsts])
        cnt[srcs] += cnt[dsts]
        for s, dd in zip(srcs, dsts):
            groups[s] = np.concatenate([groups[s], groups[dd]])
        keep = np.ones(k, bool)
        keep[dsts] = False
        lo, hi, cnt = lo[keep], hi[keep], cnt[keep]
        groups = [g for g, kp in zip(groups, keep) if kp]

    cen = 0.5 * (lo + hi)
    order = np.argsort(morton_codes_3d(cen, scene_lo, scene_hi),
                       kind="stable")
    return [groups[i] for i in order]


def _clip_polygon_axis(poly: np.ndarray, axis: int, value: float,
                       keep_below: bool) -> np.ndarray:
    """Sutherland-Hodgman clip of a convex 3-D polygon against an
    axis-aligned plane.  ``poly`` is (K, 3) float64; returns the clipped
    (K', 3) polygon (possibly empty)."""
    if len(poly) == 0:
        return poly
    d = poly[:, axis] - value
    if not keep_below:
        d = -d
    inside = d <= 0.0
    out = []
    k = len(poly)
    for i in range(k):
        j = (i + 1) % k
        if inside[i]:
            out.append(poly[i])
        if inside[i] != inside[j]:
            f = d[i] / (d[i] - d[j])
            out.append(poly[i] + f * (poly[j] - poly[i]))
    return np.asarray(out).reshape(-1, 3)


def presplit_references(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    tri_lo: np.ndarray,
    tri_hi: np.ndarray,
    budget_frac: float = 0.3,
    stop_area_factor: float = 4.0,
):
    """SBVH-style spatial pre-split: oversized triangles become multiple
    *references* with clipped sub-AABBs (reference duplication: the
    triangle itself is never cut, unlike the geometric subdivision of
    ``scene.subdivide_oversized``).

    A handful of huge triangles (the reference DragonScene's scale-10
    ground/back planes, DragonScene.swift:17-22) otherwise force every
    cluster containing them to span the whole scene.  Greedy loop: repeatedly
    take the largest-area reference box, clip its polygon at the box's
    longest-axis midpoint, emit two tight child references.  Stops when
    the split budget (``budget_frac`` x triangle count extra refs) is
    spent or the largest box is within ``stop_area_factor`` x the median
    triangle-box area.

    Correctness does not depend on the clip quality: a reference's dense
    test evaluates the FULL triangle plane, so any hit it reports is
    genuine; coverage holds because the union of a triangle's reference
    boxes contains the whole triangle.  Duplicate references of one
    source triangle produce identical (t, u, v) — the closest-hit min is
    idempotent over them.

    Returns ``(src, ref_lo, ref_hi)``: source-triangle index per
    reference plus the clipped reference AABBs (float64).
    """
    t = v0.shape[0]
    budget = int(t * budget_frac)
    areas = _surface_area(tri_lo, tri_hi)
    if budget <= 0 or t < 2:
        return np.arange(t, dtype=np.int64), tri_lo.copy(), tri_hi.copy()
    stop_area = float(np.median(areas)) * stop_area_factor

    # refs[i] = (src, lo, hi, polygon); heap orders by -area
    refs = [(int(i), tri_lo[i].copy(), tri_hi[i].copy(),
             np.stack([v0[i], v0[i] + e1[i], v0[i] + e2[i]]).astype(
                 np.float64))
            for i in range(t)]
    heap = [(-float(areas[i]), i) for i in range(t)
            if float(areas[i]) > stop_area]
    heapq.heapify(heap)

    while heap and budget > 0:
        neg_area, i = heapq.heappop(heap)
        if -neg_area <= stop_area:
            break
        src, lo, hi, poly = refs[i]
        axis = int(np.argmax(hi - lo))
        if hi[axis] - lo[axis] <= 1e-9:
            continue
        mid = 0.5 * (lo[axis] + hi[axis])
        left = _clip_polygon_axis(poly, axis, mid, keep_below=True)
        right = _clip_polygon_axis(poly, axis, mid, keep_below=False)
        if len(left) < 3 or len(right) < 3:
            continue  # degenerate clip: the polygon hugs the plane
        budget -= 1
        for k, p in ((i, left), (None, right)):
            # child box = clipped polygon's AABB, kept inside the parent
            plo = np.maximum(p.min(axis=0), lo)
            phi = np.minimum(p.max(axis=0), hi)
            entry = (src, plo, phi, p)
            if k is None:
                refs.append(entry)
                k = len(refs) - 1
            else:
                refs[k] = entry
            a = float(_surface_area(plo[None], phi[None])[0])
            if a > stop_area:
                heapq.heappush(heap, (-a, k))

    src = np.asarray([r[0] for r in refs], np.int64)
    ref_lo = np.stack([r[1] for r in refs])
    ref_hi = np.stack([r[2] for r in refs])
    # Guard the f32 cast downstream: clipped planes are exact in f64, but
    # the node boxes are stored f32 — inflate by 1 ulp-ish margin so the
    # boxes still CONTAIN their surface pieces after rounding.
    pad = np.maximum(ref_hi - ref_lo, 1e-7) * 1e-6
    return src, ref_lo - pad, ref_hi + pad


@named_scope("bvh build")
def build_cluster_bvh(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    cluster_size: int = 384,
    branching: int = 8,
    builder: str = "sah_free",
    presplit: float = 0.0,
    global_sa_frac: float = 0.02,
    max_global: int = 128,
    builder_alpha: float = 2.0,
    rays: Optional[np.ndarray] = None,
):
    """Build the cluster BVH over world-space triangles (v0, v0+e1, v0+e2).

    Returns ``(order, node_lo, node_hi, spec)`` where ``order`` maps each
    padded leaf slot to its SOURCE triangle (length
    ``spec.padded_triangles``; padding entries are ``-1``), and
    ``node_lo``/``node_hi`` are the implicit heap-ordered node AABBs,
    ``(num_nodes, 3) float32``.  Empty leaf slots (cluster index >=
    num_clusters) carry inverted AABBs ``[+inf, -inf]`` so traversal can
    never enter them.

    ``builder`` is one of :data:`BUILDERS`; ``builder_alpha`` is
    ``sah_chunk``'s per-visit cost and ``rays`` ``sah_rays``' measured
    sample (without one ``sah_rays`` builds what ``sah_free`` builds).
    ``presplit > 0`` enables SBVH-style spatial pre-splitting
    (:func:`presplit_references`): ``order`` may then repeat a source
    triangle (reference duplication), and cluster AABBs bound the clipped
    reference pieces, tight boxes around huge triangles instead of
    scene-spanning ones.

    ``global_sa_frac``: triangles whose AABB half-surface-area exceeds
    this fraction of the scene box's go to the GLOBAL set (up to
    ``max_global``, largest first): excluded from clustering (their
    scene-spanning boxes would otherwise dominate every cluster they
    touch) and placed in dedicated 128-aligned slots at the END of the
    padded tables, where tracers dense-test them once per ray (tile)
    before traversal.
    """
    t = int(v0.shape[0])
    if t == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    c = int(cluster_size)
    b = int(branching)

    p0 = v0.astype(np.float64)
    p1 = p0 + e1
    p2 = p0 + e2
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)

    # Global-set extraction (largest-first, bounded).
    tri_ids = np.arange(t, dtype=np.int64)
    global_ids = np.empty((0,), np.int64)
    if global_sa_frac > 0.0 and t > 1:
        areas = _surface_area(tri_lo, tri_hi)
        scene_sa = float(_surface_area(
            tri_lo.min(axis=0)[None], tri_hi.max(axis=0)[None])[0])
        big = np.nonzero(areas > global_sa_frac * scene_sa)[0]
        if len(big) > max_global:
            big = big[np.argsort(-areas[big])[:max_global]]
        if len(big) and len(big) < t:  # never globalize the whole scene
            global_ids = np.sort(big.astype(np.int64))
            keep = np.ones(t, bool)
            keep[global_ids] = False
            tri_ids = tri_ids[keep]
    n_global = len(global_ids)
    padded_global = -(-n_global // 128) * 128 if n_global else 0

    tl, th = tri_lo[tri_ids], tri_hi[tri_ids]
    if presplit > 0.0:
        sub, ref_lo, ref_hi = presplit_references(
            p0[tri_ids], e1[tri_ids].astype(np.float64),
            e2[tri_ids].astype(np.float64), tl, th, budget_frac=presplit)
        src = tri_ids[sub]
    else:
        src = tri_ids
        ref_lo, ref_hi = tl, th
    n_refs = src.shape[0]
    centroids = 0.5 * (ref_lo + ref_hi)

    scene_lo = ref_lo.min(axis=0)
    scene_hi = ref_hi.max(axis=0)
    if builder in ("sah_free", "sah_chunk", "ploc", "sah_rays"):
        # Cluster-granular builders: a list of (possibly partly full)
        # clusters; every cluster's tail pads with -1 (degenerate never-hit
        # slots).  sah_chunk scores in chunk units and splits below
        # cluster_size when that pays (it pairs with the kernels' chunk
        # skip); ploc agglomerates bottom-up by merged-box surface area;
        # sah_rays scores splits by measured ray hits (``rays``, from
        # RenderConfig.export_rays) instead of surface area, and builds
        # sah_free's clusters without a sample.
        if builder == "ploc":
            groups = ploc_clusters(ref_lo, ref_hi, c)
        else:
            groups = sah_free_clusters(
                ref_lo, ref_hi, np.ascontiguousarray(centroids), c,
                chunk=128 if builder == "sah_chunk" else 0,
                alpha=builder_alpha,
                rays=rays if builder == "sah_rays" else None)
        num_clusters = len(groups)
        padded = num_clusters * c
        order_padded = np.full(padded + padded_global, -1, np.int64)
        cluster_lo = np.full((num_clusters, 3), np.inf)
        cluster_hi = np.full((num_clusters, 3), -np.inf)
        for ci, ids in enumerate(groups):
            order_padded[ci * c : ci * c + len(ids)] = src[ids]
            cluster_lo[ci] = ref_lo[ids].min(axis=0)
            cluster_hi[ci] = ref_hi[ids].max(axis=0)
        order_padded[padded:padded + n_global] = global_ids
    else:
        if builder == "sah":
            order = sah_split_order(ref_lo, ref_hi,
                                    np.ascontiguousarray(centroids), c)
        elif builder == "median":
            order = median_split_order(np.ascontiguousarray(centroids), c)
        elif builder == "morton":
            codes = morton_codes_3d(centroids, scene_lo, scene_hi)
            order = np.argsort(codes, kind="stable").astype(np.int64)
        else:
            raise ValueError(f"unknown builder {builder!r}; the builders "
                             f"are {BUILDERS}")

        num_clusters = -(-n_refs // c)
        padded = num_clusters * c
        # slot layout: [clustered refs (num_clusters * c) | global slots]
        order_padded = np.full(padded + padded_global, -1, np.int64)
        order_padded[:n_refs] = src[order]
        order_padded[padded:padded + n_global] = global_ids

        # Per-cluster AABBs over the sorted references; padding is empty.
        lo_sorted = np.full((padded, 3), np.inf)
        hi_sorted = np.full((padded, 3), -np.inf)
        lo_sorted[:n_refs] = ref_lo[order]
        hi_sorted[:n_refs] = ref_hi[order]
        cluster_lo = lo_sorted.reshape(num_clusters, c, 3).min(axis=1)
        cluster_hi = hi_sorted.reshape(num_clusters, c, 3).max(axis=1)

    # Implicit complete B-ary tree sizing.
    levels = 0
    while b**levels < num_clusters:
        levels += 1
    num_leaf_slots = b**levels
    num_nodes = (b ** (levels + 1) - 1) // (b - 1)
    first_leaf = (b**levels - 1) // (b - 1)

    node_lo = np.full((num_nodes, 3), np.inf)
    node_hi = np.full((num_nodes, 3), -np.inf)
    node_lo[first_leaf : first_leaf + num_clusters] = cluster_lo
    node_hi[first_leaf : first_leaf + num_clusters] = cluster_hi

    # Reduce level by level: node g's children are g*B+1 .. g*B+B.
    for level in range(levels - 1, -1, -1):
        start = (b**level - 1) // (b - 1)
        count = b**level
        child_start = start * b + 1
        child_lo = node_lo[child_start : child_start + count * b]
        child_hi = node_hi[child_start : child_start + count * b]
        node_lo[start : start + count] = child_lo.reshape(count, b, 3).min(axis=1)
        node_hi[start : start + count] = child_hi.reshape(count, b, 3).max(axis=1)

    # Host-side Baldwin-Weber plane rows of the global set (the same f32 op
    # order as the JAX package, so the spec's repr matches it).
    g_planes = ()
    if n_global:
        gv0 = v0[global_ids].astype(np.float32)
        ge1 = e1[global_ids].astype(np.float32)
        ge2 = e2[global_ids].astype(np.float32)
        gn = np.cross(ge1, ge2).astype(np.float32)
        nn = np.sum(gn * gn, axis=-1, keepdims=True, dtype=np.float32)
        nn = np.where(nn < 1e-30, np.float32(1.0), nn)
        u3 = (np.cross(ge2, gn).astype(np.float32) / nn).astype(np.float32)
        v3 = (np.cross(gn, ge1).astype(np.float32) / nn).astype(np.float32)
        dc = np.sum(gn * gv0, axis=-1, keepdims=True, dtype=np.float32)
        uw = -np.sum(u3 * gv0, axis=-1, keepdims=True, dtype=np.float32)
        vw = -np.sum(v3 * gv0, axis=-1, keepdims=True, dtype=np.float32)
        rows = np.concatenate([gn, dc, u3, uw, v3, vw], axis=1)
        g_planes = tuple(tuple(float(x) for x in r) for r in rows)

    # Chunk-skip eligibility: the share of 128-wide dense-test chunks that
    # hold only padding (more than a tenth marks partial_clusters).
    counts = (order_padded[:padded].reshape(num_clusters, c) >= 0).sum(1)
    full_chunks = num_clusters * (c // 128)
    real_chunks = int(np.ceil(counts / 128).sum())
    partial_clusters = (full_chunks - real_chunks) > 0.1 * full_chunks

    spec = BVHSpec(
        num_triangles=t,
        padded_triangles=padded + padded_global,
        cluster_size=c,
        num_clusters=num_clusters,
        branching=b,
        levels=levels,
        num_nodes=num_nodes,
        first_leaf=first_leaf,
        num_global=n_global,
        padded_global=padded_global,
        global_planes=g_planes,
        partial_clusters=partial_clusters,
    )
    return (
        order_padded,
        node_lo.astype(np.float32),
        node_hi.astype(np.float32),
        spec,
    )
