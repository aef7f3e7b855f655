"""Acceleration structure: cluster BVH with an implicit B-ary tree (numpy).

The port's counterpart of ``metal_raytracing_tpu.accel``: a one-time host
build at scene load.  Triangles are grouped into leaf clusters of at most
``cluster_size`` by the unquantized cluster-granular SAH (``sah_free``, the
default builder), a few scene-spanning triangles go to a separate *global
set*, and an implicit complete B-ary tree of AABBs sits above the clusters.

Only the ``sah_free`` builder is ported; the others (``sah``,
``sah_chunk``, ``sah_rays``, ``ploc``, ``median``, ``morton``, the SBVH
pre-split) are listed in ROADMAP.md.  The build is the JAX package's numpy
code, so the port and the reference produce the same clusters, node boxes and
``BVHSpec`` (whose ``repr`` feeds the checkpoint fingerprint).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BVHSpec", "build_cluster_bvh", "sah_free_clusters"]


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


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Half surface area of AABBs; empty (inverted) boxes score 0."""
    ext = np.maximum(hi - lo, 0.0)
    return (ext[..., 0] * ext[..., 1] + ext[..., 1] * ext[..., 2]
            + ext[..., 2] * ext[..., 0])


def sah_free_clusters(tri_lo: np.ndarray, tri_hi: np.ndarray,
                      centroids: np.ndarray, cluster_size: int,
                      n_bins: int = 32) -> list:
    """Unquantized cluster-granular SAH: a list of per-cluster triangle
    index arrays, each of length <= ``cluster_size``.

    Each candidate split is scored ``SA(left) * ceil(n_left / c) +
    SA(right) * ceil(n_right / c)`` (a cluster visit costs one dense test
    however full the cluster is); depth-first emission keeps consecutive
    clusters spatially close.  The surface-area path of
    ``metal_raytracing_tpu.accel.sah_free_clusters``."""
    c = cluster_size
    clusters: list = []
    stack = [np.arange(centroids.shape[0], dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if len(ids) <= c:
            clusters.append(ids)
            continue
        pts = centroids[ids]
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        ext = hi - lo
        n_here = len(ids)

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
            cost = (_surface_area(pre_lo[:-1], pre_hi[:-1]) * np.ceil(ln / c)
                    + _surface_area(suf_lo[1:], suf_hi[1:]) * np.ceil(rn / c))
            valid = (ln >= 1) & (rn >= 1)
            if not valid.any():
                continue
            cost = np.where(valid, cost, np.inf)
            b = int(np.argmin(cost))
            if cost[b] < best_cost:
                best_cost = cost[b]
                best_axis = axis
                best_k = int(ln[b])
        if best_axis < 0:
            # degenerate spread (all centroids coincident): halve by count
            best_axis = int(np.argmax(ext))
            best_k = n_here // 2
        part = np.argpartition(pts[:, best_axis], best_k)
        stack.append(ids[part[best_k:]])  # right first -> left emitted first
        stack.append(ids[part[:best_k]])
    return clusters


def build_cluster_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                      cluster_size: int = 384, branching: int = 8,
                      builder: str = "sah_free",
                      global_sa_frac: float = 0.02, max_global: int = 128):
    """Build the cluster BVH over world-space triangles (v0, v0+e1, v0+e2).

    Returns ``(order, node_lo, node_hi, spec)``: ``order`` maps each padded
    leaf slot to its source triangle (``-1`` for padding), and
    ``node_lo``/``node_hi`` are the heap-ordered node AABBs,
    ``(num_nodes, 3) float32`` (empty leaf slots are inverted boxes).

    Triangles whose AABB half-surface-area exceeds ``global_sa_frac`` of the
    scene box's (at most ``max_global``, largest first) form the global set:
    they are kept out of the clusters and take 128-aligned slots at the end
    of the padded tables."""
    if builder != "sah_free":
        raise ValueError(
            f"builder {builder!r} is not ported yet (only 'sah_free'); the "
            "other builders are listed in ROADMAP.md")
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

    ref_lo, ref_hi = tri_lo[tri_ids], tri_hi[tri_ids]
    centroids = 0.5 * (ref_lo + ref_hi)
    groups = sah_free_clusters(ref_lo, ref_hi,
                               np.ascontiguousarray(centroids), c)
    num_clusters = len(groups)
    padded = num_clusters * c
    order_padded = np.full(padded + padded_global, -1, np.int64)
    cluster_lo = np.full((num_clusters, 3), np.inf)
    cluster_hi = np.full((num_clusters, 3), -np.inf)
    for ci, ids in enumerate(groups):
        order_padded[ci * c: ci * c + len(ids)] = tri_ids[ids]
        cluster_lo[ci] = ref_lo[ids].min(axis=0)
        cluster_hi[ci] = ref_hi[ids].max(axis=0)
    order_padded[padded:padded + n_global] = global_ids

    # Implicit complete B-ary tree sizing.
    levels = 0
    while b ** levels < num_clusters:
        levels += 1
    num_nodes = (b ** (levels + 1) - 1) // (b - 1)
    first_leaf = (b ** levels - 1) // (b - 1)

    node_lo = np.full((num_nodes, 3), np.inf)
    node_hi = np.full((num_nodes, 3), -np.inf)
    node_lo[first_leaf:first_leaf + num_clusters] = cluster_lo
    node_hi[first_leaf:first_leaf + num_clusters] = cluster_hi
    # Reduce level by level: node g's children are g*B+1 .. g*B+B.
    for level in range(levels - 1, -1, -1):
        start = (b ** level - 1) // (b - 1)
        count = b ** level
        child_start = start * b + 1
        child_lo = node_lo[child_start:child_start + count * b]
        child_hi = node_hi[child_start:child_start + count * b]
        node_lo[start:start + count] = child_lo.reshape(count, b, 3).min(1)
        node_hi[start:start + count] = child_hi.reshape(count, b, 3).max(1)

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

    # Share of 128-wide chunks that hold only padding (spec metadata).
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
    return (order_padded, node_lo.astype(np.float32),
            node_hi.astype(np.float32), spec)
