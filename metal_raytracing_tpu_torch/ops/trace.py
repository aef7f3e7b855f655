"""The exact tracers: brute force and the packet BVH walk, closest and any
hit.

The port's counterpart of ``metal_raytracing_tpu.ops.trace`` (the JAX
package's ``tracer="bvh"`` and ``"bruteforce"``).  Both walk the triangles
themselves with :func:`moller_trumbore` on the ``v0``/``e1``/``e2`` table of
the scene's geometry and return the exact hit distance, unlike the cluster
kernels of ``ops.trace_cuda`` with their packed keys and plane tables.

- :func:`trace_closest_bruteforce` and :func:`trace_any_bruteforce` test
  every ray against every triangle slot, in chunks; ties go to the lowest
  slot.  They are plain PyTorch on every device, as the JAX package's are
  plain ``jnp``.
- :func:`closest_packet_ref` and :func:`any_packet_ref` are the plain
  versions of the JAX package's packet walk (``_packet_closest``,
  ``_packet_any``): blocks of ``block`` rays share a stack over the
  implicit B-ary heap (children of ``node`` at ``node*B+1 ..``, leaves from
  ``first_leaf``), all blocks stepping in lockstep until every stack is
  empty.
- :func:`closest_bvh_walk_ref` and :func:`any_bvh_walk_ref` walk as the
  kernels do, each ray with its own stack: the plain versions that the
  kernels equal bit for bit (the tests and ``chip_smoke.py`` use them).
- :func:`trace_closest` and :func:`trace_any` run the packet versions for
  tensors on the CPU and launch ``closest_bvh_kernel`` / ``any_bvh_kernel``
  (``csrc/trace_bvh.cu``: a walk per lane, each leaf served to every lane
  of the warp that asks for it) for tensors on a CUDA device, where they
  never fall back.  Each counts its launches in ``trace_closest.launches``
  / ``trace_any.launches``.

The JAX packet walk runs as a ``lax.while_loop`` on the device; in eager
PyTorch each of its steps would wait for the host, so on the card it is a
kernel, though the JAX package has no Pallas kernel for it.

**What the walks agree on.**  The global set (``BVHSpec.num_global`` real
slots at ``global_base``; the padding slots are zero triangles that never
hit) is tested first; afterwards only a strictly smaller t replaces the
best, so the global set wins an exact tie, and inside a leaf the first
slot wins.  A child is entered when its slab test passes with the best t
so far as bound; the packet pushes a block's children far first by the
block's least entry t (a stable sort), the kernel a ray's own children by
its own entry.  Every walk therefore finds the same hit distance, and two
of them can pick different triangles only where two hits tie exactly.
"""

from __future__ import annotations

import torch

from ..accel import BVHSpec
from .intersect import BIG_T, Hit, moller_trumbore, ray_aabb, safe_inverse

__all__ = ["Hit", "trace_closest_bruteforce", "trace_any_bruteforce",
           "closest_packet_ref", "any_packet_ref", "closest_bvh_walk_ref",
           "any_bvh_walk_ref", "trace_closest", "trace_any", "MAX_STACK"]

# The kernels' per-thread stack (csrc/trace_bvh.cu kMaxStack):
# BVHSpec.max_stack must fit.
MAX_STACK = 64
# Elements per (rays x triangles) temporary of the plain versions: 16 MB of
# float32 on the card, 2 MB on the host (as ops.trace_cuda).
_CHUNK_ELEMS = 1 << 22
_CHUNK_ELEMS_HOST = 1 << 19


def _chunk_elems(device) -> int:
    return (_CHUNK_ELEMS if torch.device(device).type == "cuda"
            else _CHUNK_ELEMS_HOST)


def _min_update(best, t, u, v, hit, tri_base):
    """Fold (..., C) intersections into the per-ray best records
    ``(t, u, v, tri)`` (...): the first slot wins a tie inside the block,
    and only a strictly smaller t replaces the best
    (``metal_raytracing_tpu.ops.trace._min_update``).  ``tri_base`` is the
    slot of column 0, an int or a (...) tensor."""
    best_t, best_u, best_v, best_tri = best
    tt = torch.where(hit, t, BIG_T)
    tj, j = tt.min(dim=-1)  # the first minimum
    upd = tj < best_t
    take = lambda a: a.gather(-1, j[..., None])[..., 0]
    return (torch.where(upd, tj, best_t),
            torch.where(upd, take(u), best_u),
            torch.where(upd, take(v), best_v),
            torch.where(upd, (tri_base + j).to(torch.int32), best_tri))


def _init_best(shape, device):
    return (torch.full(shape, BIG_T, device=device),
            torch.zeros(shape, device=device),
            torch.zeros(shape, device=device),
            torch.full(shape, -1, dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# Brute force (the oracle)
# ---------------------------------------------------------------------------


def trace_closest_bruteforce(o, d, mask, geometry, chunk: int = 2048) -> Hit:
    """Closest hit of every ray against every triangle slot, scanned in
    triangle chunks of ``chunk`` (and in ray chunks that bound each
    temporary); ties go to the lowest slot.  The correctness oracle
    (``metal_raytracing_tpu.ops.trace.trace_closest_bruteforce``)."""
    n = o.shape[0]
    t_total = geometry.v0.shape[0]
    chunk = max(1, min(chunk, t_total))
    rstep = max(1, _chunk_elems(o.device) // chunk)
    t_out, u_out, v_out, tri_out = _init_best((n,), o.device)
    for r0 in range(0, n, rstep):
        rs = slice(r0, min(n, r0 + rstep))
        oo, dd, mm = o[rs, None, :], d[rs, None, :], mask[rs, None]
        best = _init_best((oo.shape[0],), o.device)
        for c0 in range(0, t_total, chunk):
            cs = slice(c0, min(t_total, c0 + chunk))
            t, u, v, hit = moller_trumbore(oo, dd, geometry.v0[None, cs],
                                           geometry.e1[None, cs],
                                           geometry.e2[None, cs])
            best = _min_update(best, t, u, v, hit & mm, c0)
        t_out[rs], u_out[rs], v_out[rs], tri_out[rs] = best
    return Hit(t=t_out, u=u_out, v=v_out, tri=tri_out)


def trace_any_bruteforce(o, d, max_t, mask, geometry, chunk: int = 2048):
    """Occlusion oracle: True where a triangle lies within (1e-6, max_t]."""
    hit = trace_closest_bruteforce(o, d, mask, geometry, chunk=chunk)
    return hit.found & (hit.t <= max_t)


# ---------------------------------------------------------------------------
# The packet walk, plain PyTorch
# ---------------------------------------------------------------------------


def _blocked(block: int, o, d, *per_ray):
    """Rays padded to whole blocks (padding masked off; ``per_ray``'s last
    entry is the mask) and reshaped to (blocks, block, ...)."""
    n = o.shape[0]
    nb = max(1, -(-n // block))
    pad = nb * block - n
    out = []
    for a in (o, d) + per_ray:
        if pad:
            a = torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                          dtype=a.dtype, device=a.device)])
        out.append(a.reshape((nb, block) + tuple(a.shape[1:])))
    return nb, out


def _leaf_rows(geometry, spec: BVHSpec, node):
    """(v0, e1, e2), each (L, C, 3), of the clusters of leaf nodes ``node``
    (L,), and their first slots (L,)."""
    c = spec.cluster_size
    base = (node - spec.first_leaf) * c
    slots = (base[:, None] + torch.arange(c, device=node.device)).long()
    return (geometry.v0[slots], geometry.e1[slots], geometry.e2[slots],
            base)


def _children(node_lo, node_hi, spec: BVHSpec, node):
    """Boxes (I, B, 3) and ids (I, B) of the children of nodes ``node``."""
    kids = node[:, None] * spec.branching + 1 + torch.arange(
        spec.branching, device=node.device)
    return node_lo[kids.long()], node_hi[kids.long()], kids


def _global_pass(o, d, mask, geometry, spec: BVHSpec, fold):
    """Test the ``num_global`` real global slots for every ray, in ray
    chunks; ``fold(rows, t, u, v, hit)`` consumes each (rows, G) block."""
    gb, g = spec.global_base, spec.num_global
    gv0, ge1, ge2 = (geometry.v0[gb:gb + g], geometry.e1[gb:gb + g],
                     geometry.e2[gb:gb + g])
    n = o.shape[0]
    step = max(1, _chunk_elems(o.device) // g)
    for r0 in range(0, n, step):
        rs = slice(r0, min(n, r0 + step))
        fold(rs, *moller_trumbore(o[rs, None], d[rs, None], gv0[None],
                                  ge1[None], ge2[None]))


def _block_groups(nb: int, block: int, width: int, device):
    """Groups of blocks whose (group, block, width) temporaries stay within
    the chunk size; each group walks in lockstep."""
    step = max(1, _chunk_elems(device) // (block * max(width, 1)))
    for b0 in range(0, nb, step):
        yield slice(b0, min(nb, b0 + step))


def closest_packet_ref(o, d, mask, geometry, node_lo, node_hi,
                       spec: BVHSpec, block: int = 128) -> Hit:
    """Plain version of ``closest_bvh_kernel``, the JAX package's packet
    closest-hit walk (``metal_raytracing_tpu.ops.trace._packet_closest``)
    for every block of ``block`` rays at once.  ``geometry`` has the
    ``v0``, ``e1``, ``e2`` slot tables (T, 3); ``node_lo``/``node_hi`` are
    the heap-ordered node boxes (num_nodes, 3).  Any ray count: the last
    block is padded with masked rays."""
    n = o.shape[0]
    dev = o.device
    nb, (bo, bd, bm) = _blocked(block, o, d, mask)
    binv = safe_inverse(bd)
    bt, bu, bv, btri = _init_best((nb, block), dev)
    if spec.num_global:
        flat = [x.reshape(-1) for x in (bt, bu, bv, btri)]
        fo, fd, fm = bo.reshape(-1, 3), bd.reshape(-1, 3), bm.reshape(-1)

        def fold(rs, t, u, v, hit):
            best = _min_update(tuple(x[rs] for x in flat), t, u, v,
                               hit & fm[rs, None], spec.global_base)
            for x, y in zip(flat, best):
                x[rs] = y

        _global_pass(fo, fd, fm, geometry, spec, fold)
    c, b = spec.cluster_size, spec.branching

    def leaf(blocks, node):
        """Leaf test of node (L,) for blocks (L,): the block's best is
        updated in place."""
        v0, e1, e2, base = _leaf_rows(geometry, spec, node)
        t, u, v, hit = moller_trumbore(bo[blocks][:, :, None],
                                       bd[blocks][:, :, None], v0[:, None],
                                       e1[:, None], e2[:, None])
        best = tuple(x[blocks] for x in (bt, bu, bv, btri))
        hit = hit & bm[blocks][:, :, None] & (t < best[0][:, :, None])
        new = _min_update(best, t, u, v, hit, base[:, None])
        for x, y in zip((bt, bu, bv, btri), new):
            x[blocks] = y

    if spec.levels == 0:  # the root is the only (leaf) node
        leaf(torch.arange(nb, device=dev),
             torch.zeros(nb, dtype=torch.long, device=dev))
    else:
        size = spec.max_stack
        for g in _block_groups(nb, block, max(c, b), dev):
            ids = torch.arange(g.start, g.stop, device=dev)
            sp = torch.ones(ids.shape[0], dtype=torch.long, device=dev)
            stack = torch.zeros((ids.shape[0], size + 1), dtype=torch.long,
                                device=dev)
            while True:
                walking = (sp > 0).nonzero()[:, 0]
                if walking.numel() == 0:
                    break
                sp[walking] -= 1
                node = stack[walking, sp[walking]]
                is_leaf = node >= spec.first_leaf
                if bool(is_leaf.any()):
                    leaf(ids[walking[is_leaf]], node[is_leaf])
                inner = walking[~is_leaf]
                if inner.numel() == 0:
                    continue
                blocks = ids[inner]
                lo, hi, kids = _children(node_lo, node_hi, spec,
                                         node[~is_leaf])
                tn, hit = ray_aabb(bo[blocks][:, :, None],
                                   binv[blocks][:, :, None], lo[:, None],
                                   hi[:, None], bt[blocks][:, :, None])
                hit = hit & bm[blocks][:, :, None]  # (I, R, B)
                push = hit.any(dim=1)  # (I, B)
                t_entry = torch.where(hit, tn, BIG_T).amin(dim=1)
                # far children first, so that the nearest is popped first
                order = torch.argsort(-t_entry, dim=1, stable=True)
                push_sorted = push.gather(1, order)
                kids_sorted = kids.gather(1, order)
                cnt = push_sorted.long().cumsum(dim=1)
                pos = torch.where(push_sorted,
                                  sp[inner, None] + cnt - 1, size)
                rows = stack[inner]
                rows.scatter_(1, pos, kids_sorted)
                stack[inner] = rows
                sp[inner] += cnt[:, -1]
    flat = lambda x: x.reshape(-1)[:n]
    return Hit(t=flat(bt), u=flat(bu), v=flat(bv), tri=flat(btri))


def any_packet_ref(o, d, max_t, mask, geometry, node_lo, node_hi,
                   spec: BVHSpec, block: int = 128) -> torch.Tensor:
    """Plain version of ``any_bvh_kernel``, the JAX package's packet
    any-hit walk (``metal_raytracing_tpu.ops.trace._packet_any``): True where
    a triangle lies within (1e-6, max_t].  A block's walk ends when every
    masked ray of it is occluded."""
    n = o.shape[0]
    dev = o.device
    nb, (bo, bd, bmt, bm) = _blocked(block, o, d, max_t, mask)
    binv = safe_inverse(bd)
    occ = torch.zeros((nb, block), dtype=torch.bool, device=dev)
    if spec.num_global:
        focc = occ.reshape(-1)
        fo, fd, fm = bo.reshape(-1, 3), bd.reshape(-1, 3), bm.reshape(-1)
        fmt = bmt.reshape(-1)

        def fold(rs, t, u, v, hit):
            hit = hit & (t <= fmt[rs, None]) & fm[rs, None]
            focc[rs] = hit.any(dim=1)

        _global_pass(fo, fd, fm, geometry, spec, fold)
    c, b = spec.cluster_size, spec.branching

    def leaf(blocks, node, active):
        v0, e1, e2, _ = _leaf_rows(geometry, spec, node)
        _, _, _, hit = moller_trumbore(
            bo[blocks][:, :, None], bd[blocks][:, :, None], v0[:, None],
            e1[:, None], e2[:, None], t_max=bmt[blocks][:, :, None])
        occ[blocks] |= (hit & active[:, :, None]).any(dim=2)

    if spec.levels == 0:
        leaf(torch.arange(nb, device=dev),
             torch.zeros(nb, dtype=torch.long, device=dev), bm)
    else:
        size = spec.max_stack
        for g in _block_groups(nb, block, max(c, b), dev):
            ids = torch.arange(g.start, g.stop, device=dev)
            sp = torch.ones(ids.shape[0], dtype=torch.long, device=dev)
            stack = torch.zeros((ids.shape[0], size + 1), dtype=torch.long,
                                device=dev)
            while True:
                active = bm[ids] & ~occ[ids]
                walking = ((sp > 0) & active.any(dim=1)).nonzero()[:, 0]
                if walking.numel() == 0:
                    break
                sp[walking] -= 1
                node = stack[walking, sp[walking]]
                is_leaf = node >= spec.first_leaf
                if bool(is_leaf.any()):
                    sel = walking[is_leaf]
                    leaf(ids[sel], node[is_leaf], active[sel])
                inner = walking[~is_leaf]
                if inner.numel() == 0:
                    continue
                blocks = ids[inner]
                lo, hi, kids = _children(node_lo, node_hi, spec,
                                         node[~is_leaf])
                _, hit = ray_aabb(bo[blocks][:, :, None],
                                  binv[blocks][:, :, None], lo[:, None],
                                  hi[:, None], bmt[blocks][:, :, None])
                push = (hit & active[inner][:, :, None]).any(dim=1)
                cnt = push.long().cumsum(dim=1)
                pos = torch.where(push, sp[inner, None] + cnt - 1, size)
                rows = stack[inner]
                rows.scatter_(1, pos, kids)
                stack[inner] = rows
                sp[inner] += cnt[:, -1]
    return occ.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# The per-ray walk of the kernels, plain PyTorch
# ---------------------------------------------------------------------------


def _leaf_chunks(geometry, spec: BVHSpec, rays, node):
    """Rays ``rays`` (L,) at leaf nodes ``node`` (L,), in chunks whose
    (rays x cluster_size) temporaries stay within the chunk size: yields
    each chunk's rays and :func:`_leaf_rows`."""
    step = max(1, _chunk_elems(rays.device) // spec.cluster_size)
    for r0 in range(0, rays.shape[0], step):
        yield (rays[r0:r0 + step],
               *_leaf_rows(geometry, spec, node[r0:r0 + step]))


def _pop(stack, sp, walking):
    """Pop the top of each walking ray's stack: its node (long)."""
    sp[walking] -= 1
    return stack[walking, sp[walking]].long(), sp[walking]


def _push(stack, sp, rays, push, items, *columns):
    """Push ``items`` (I, B) where ``push`` (I, B), in column order, onto
    the stacks of ``rays`` (I,); ``columns`` are (tensor, values) pairs
    stacked beside the nodes.  The last stack column takes the rest."""
    size = stack.shape[1] - 1
    pos = torch.where(push, sp[rays, None] + push.long().cumsum(dim=1) - 1,
                      size)
    for table, values in ((stack, items.to(stack.dtype)),) + columns:
        rows = table[rays]
        rows.scatter_(1, pos, values)
        table[rays] = rows
    sp[rays] += push.sum(dim=1)


def closest_bvh_walk_ref(o, d, mask, geometry, node_lo, node_hi,
                         spec: BVHSpec) -> Hit:
    """The closest walk of ``closest_bvh_kernel``, ray by ray: the plain
    version that ``chip_smoke.py`` and the tests hold the kernel against bit
    for bit.  Each ray keeps its own stack of (node, entry t), all rays
    stepping in lockstep, one pop a step: the ``num_global`` global slots
    first; a popped node whose entry lies beyond the best is culled; a leaf
    replaces the best only with a strictly smaller t (the first slot wins a
    tie); an internal node's children are slab-tested against the best and
    pushed far first by the ray's own entry, equal entries in index order,
    so the nearest is popped first.  Returns the exact :class:`Hit`."""
    n, dev = o.shape[0], o.device
    best = list(_init_best((n,), dev))
    if spec.num_global:
        def fold(rs, t, u, v, hit):
            new = _min_update(tuple(x[rs] for x in best), t, u, v,
                              hit & mask[rs, None], spec.global_base)
            for x, y in zip(best, new):
                x[rs] = y

        _global_pass(o, d, mask, geometry, spec, fold)
    inv = safe_inverse(d)
    size = spec.max_stack
    stack = torch.zeros((n, size + 1), dtype=torch.int32, device=dev)
    entry = torch.full((n, size + 1), -BIG_T, device=dev)
    sp = mask.long()  # the root, with entry -BIG_T
    while True:
        walking = (sp > 0).nonzero()[:, 0]
        if walking.numel() == 0:
            break
        node, top = _pop(stack, sp, walking)
        kept = ~(entry[walking, top] > best[0][walking])  # else culled
        walking, node = walking[kept], node[kept]
        leaf = node >= spec.first_leaf
        for rays, v0, e1, e2, base in _leaf_chunks(geometry, spec,
                                                   walking[leaf], node[leaf]):
            t, u, v, hit = moller_trumbore(o[rays, None], d[rays, None], v0,
                                           e1, e2)
            new = _min_update(tuple(x[rays] for x in best), t, u, v, hit,
                              base)
            for x, y in zip(best, new):
                x[rays] = y
        inner, node = walking[~leaf], node[~leaf]
        if inner.numel() == 0:
            continue
        lo, hi, kids = _children(node_lo, node_hi, spec, node)
        tn, hit = ray_aabb(o[inner, None], inv[inner, None], lo, hi,
                           best[0][inner, None])
        # far first; a stable sort keeps equal entries in index order
        order = torch.argsort(torch.where(hit, -tn, float("inf")), dim=1,
                              stable=True)
        _push(stack, sp, inner, hit.gather(1, order), kids.gather(1, order),
              (entry, tn.gather(1, order)))
    return Hit(t=best[0], u=best[1], v=best[2], tri=best[3])


def any_bvh_walk_ref(o, d, max_t, mask, geometry, node_lo, node_hi,
                     spec: BVHSpec) -> torch.Tensor:
    """The any walk of ``any_bvh_kernel``, ray by ray (as
    :func:`closest_bvh_walk_ref`): the global slots, then a depth-first
    walk with the children slab-tested against ``max_t`` and pushed in
    index order, each ray leaving at its first occluder within (1e-6,
    max_t].  Returns (N,) bool."""
    n, dev = o.shape[0], o.device
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    if spec.num_global:
        def fold(rs, t, u, v, hit):
            occ[rs] = (hit & (t <= max_t[rs, None]) & mask[rs, None]).any(1)

        _global_pass(o, d, mask, geometry, spec, fold)
    inv = safe_inverse(d)
    stack = torch.zeros((n, spec.max_stack + 1), dtype=torch.int32,
                        device=dev)
    sp = (mask & ~occ).long()  # the root
    while True:
        walking = ((sp > 0) & ~occ).nonzero()[:, 0]
        if walking.numel() == 0:
            break
        node, _ = _pop(stack, sp, walking)
        leaf = node >= spec.first_leaf
        for rays, v0, e1, e2, _ in _leaf_chunks(geometry, spec,
                                                walking[leaf], node[leaf]):
            hit = moller_trumbore(o[rays, None], d[rays, None], v0, e1, e2,
                                  t_max=max_t[rays, None])[3]
            occ[rays] = hit.any(dim=1)
        inner, node = walking[~leaf], node[~leaf]
        if inner.numel() == 0:
            continue
        lo, hi, kids = _children(node_lo, node_hi, spec, node)
        _, hit = ray_aabb(o[inner, None], inv[inner, None], lo, hi,
                          max_t[inner, None])
        _push(stack, sp, inner, hit, kids)
    return occ


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(o, d, mask, geometry, node_lo, node_hi, spec: BVHSpec,
           max_t=None):
    n = o.shape[0]
    rays = [("o", o, (n, 3), torch.float32), ("d", d, (n, 3), torch.float32),
            ("mask", mask, (n,), torch.bool)]
    if max_t is not None:
        rays.append(("max_t", max_t, (n,), torch.float32))
    t_slots = spec.padded_triangles
    tables = [(name, x, shape) for name, x, shape in (
        ("geometry.v0", geometry.v0, (t_slots, 3)),
        ("geometry.e1", geometry.e1, (t_slots, 3)),
        ("geometry.e2", geometry.e2, (t_slots, 3)),
        ("node_lo", node_lo, (spec.num_nodes, 3)),
        ("node_hi", node_hi, (spec.num_nodes, 3)))]
    for name, x, shape, dtype in rays + [t + (torch.float32,)
                                         for t in tables]:
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {o.device}")


def _launch_args(o, d, mask, geometry, node_lo, node_hi, spec: BVHSpec):
    """The contiguous tensors and the ints the two kernels share."""
    from .trace_cuda import _ptr

    if spec.max_stack > MAX_STACK:
        raise ValueError(f"the BVH kernels keep a stack of {MAX_STACK}, this "
                         f"tree needs {spec.max_stack}")
    keep = [x.contiguous() for x in (o, d, mask, geometry.v0, geometry.e1,
                                     geometry.e2, node_lo, node_hi)]
    ints = (o.shape[0], spec.branching, spec.levels, spec.first_leaf,
            spec.cluster_size, spec.global_base, spec.num_global)
    return keep, [_ptr(x) for x in keep], ints


def trace_closest(o, d, mask, geometry, node_lo, node_hi, spec: BVHSpec,
                  block: int = 128) -> Hit:
    """Closest hit of each ray through the BVH: ``closest_bvh_kernel`` on a
    CUDA device, :func:`closest_packet_ref` (with packets of ``block``
    rays) on the CPU.  Returns the exact :class:`Hit` (t, u, v, slot)."""
    _check(o, d, mask, geometry, node_lo, node_hi, spec)
    if o.device.type == "cpu":
        return closest_packet_ref(o, d, mask, geometry, node_lo, node_hi,
                                  spec, block)
    from ._build import load_library
    from .trace_cuda import _ptr, _raise_on, _stream

    n = o.shape[0]
    t, u, v = (torch.empty((n,), dtype=torch.float32, device=o.device)
               for _ in range(3))
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n:
        lib = load_library()
        keep, ptrs, ints = _launch_args(o, d, mask, geometry, node_lo,
                                        node_hi, spec)
        err = lib.launch_closest_bvh(*ptrs, *ints, _ptr(t), _ptr(u), _ptr(v),
                                     _ptr(tri), _stream(o.device))
        _raise_on(err, lib, "closest_bvh_kernel")
        trace_closest.launches += 1
    return Hit(t=t, u=u, v=v, tri=tri)


trace_closest.launches = 0


def trace_any(o, d, max_t, mask, geometry, node_lo, node_hi, spec: BVHSpec,
              block: int = 128) -> torch.Tensor:
    """Occlusion of each ray segment (1e-6, max_t] through the BVH:
    ``any_bvh_kernel`` on a CUDA device, :func:`any_packet_ref` on the CPU.
    Returns (N,) bool."""
    _check(o, d, mask, geometry, node_lo, node_hi, spec, max_t)
    if o.device.type == "cpu":
        return any_packet_ref(o, d, max_t, mask, geometry, node_lo, node_hi,
                              spec, block)
    from ._build import load_library
    from .trace_cuda import _ptr, _raise_on, _stream

    n = o.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)
    if n:
        lib = load_library()
        keep, ptrs, ints = _launch_args(o, d, mask, geometry, node_lo,
                                        node_hi, spec)
        mt = max_t.contiguous()
        err = lib.launch_any_bvh(*ptrs[:3], _ptr(mt), *ptrs[3:], *ints,
                                 _ptr(occ), _stream(o.device))
        _raise_on(err, lib, "any_bvh_kernel")
        trace_any.launches += 1
    return occ


trace_any.launches = 0
