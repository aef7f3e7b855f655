"""The rank-directed closest walk on Hopper.

The port's counterpart of ``trace_pallas.trace_closest_rank`` and its TPU
kernel ``_rank_closest_kernel``: :func:`trace_closest_rank` launches
``closest_rank_kernel`` (``csrc/trace_rank.cu``) for tensors on a CUDA
device, where it never falls back, and runs the plain PyTorch version
:func:`closest_rank_ref` for tensors on the CPU.
``trace_closest_rank.launches`` counts the kernel's launches.

Each ray brings its K nearest candidate clusters as packed
``(bits(t_entry) & ~0xFFF) | cluster id`` keys, rank 1 first
(``broadphase_cuda.nearest_cluster(..., return_packed=True)``; the
renderer carries them through its compaction sort), and the walk takes the
minimum packed hit key ``(bits(t) & ~0x1FF) | in-cluster index`` over the
seed and those clusters only, near to far, skipping a candidate whose
chopped entry is not below the chopped best.  The result covers ranks 1..K:
:func:`rank_certificate` says which rays that settles (the best lies a chop
step below the rank-(K+1) entry, or there is no such candidate), and the
caller re-traces the others with ``trace_cuda.trace_closest``, seeded with
this walk's key and base.

The kernel walks a ray per lane and lets the 32 lanes of a warp share the
leaf test of each cluster that some of them asked for in the same round;
:func:`closest_rank_walk_ref` replays those rounds for the tests and the
card's checks.  Against the TPU kernel: that one dense-tests each popped
cluster against all 128 rays of its tile, so a lane may also get hits from
clusters only its neighbours asked for.  On certified rays the two agree;
elsewhere the TPU key can be the smaller one, and after the fallback both
equal the full walk.
"""

from __future__ import annotations

import torch

from ..accel import BVHSpec
from .broadphase_cuda import NC_IDM, NC_SENT
from .trace_cuda import (IDX_BITS, IDX_MASK, N_TRI_PLANES, _INIT_KEY,
                         _REF_GATHER_ELEMS, _check_rays, _check_tables,
                         _key_to_t, _plane_hits, _ptr, _raise_on, _stream,
                         active_counts)

__all__ = ["trace_closest_rank", "closest_rank_ref", "closest_rank_walk_ref",
           "rank_certificate"]


def _entry_t(pk: torch.Tensor) -> torch.Tensor:
    """Chopped slab-entry distance of a packed broad-phase key."""
    return (pk & ~NC_IDM).view(torch.float32)


def _start(n, spec: BVHSpec, seed_key, device):
    """(key, base) a ray starts from: the seed with base ``global_base``,
    or without a seed the init key with base 0, as the TPU kernel."""
    if seed_key is None:
        return (torch.full((n,), _INIT_KEY, dtype=torch.int32, device=device),
                torch.zeros((n,), dtype=torch.int32, device=device))
    return (seed_key.to(torch.int32).clone(),
            torch.full((n,), spec.global_base, dtype=torch.int32,
                       device=device))


def _serve(o, d, r, cid, tri, c, lane, counts):
    """(cluster bases, minimum packed keys) of rays ``r`` against their
    clusters ``cid``: every slot of each, or its first ``counts``."""
    cbase = (cid * c).to(torch.int32)
    t, hit = _plane_hits(o[r], d[r],
                         tri[:, (cbase[:, None] + lane[None, :]).long()])
    if counts is not None:
        hit = hit & (lane[None, :] < counts[cid.long()][:, None])
    vkey = (t.view(torch.int32) & ~IDX_MASK) | lane[None, :]
    return cbase, torch.where(hit, vkey, _INIT_KEY).amin(dim=1)


def closest_rank_ref(o, d, mask, rank_keys, tri, spec: BVHSpec,
                     seed_key=None, counts=None):
    """Plain version of ``closest_rank_kernel``: rank by rank, the rays
    whose candidate survives the cull gather its ``cluster_size`` plane
    columns (with ``counts``, its first ``counts[c]``) and take the minimum
    packed key, with the kernels' plane test.  Returns ``(key (N,) i32,
    base (N,) i32)``."""
    n = o.shape[0]
    c = spec.cluster_size
    key, base = _start(n, spec, seed_key, o.device)
    lane = torch.arange(c, dtype=torch.int32, device=o.device)
    step = max(1, _REF_GATHER_ELEMS // (N_TRI_PLANES * c))
    for pk in rank_keys:
        go = mask & (pk != NC_SENT) & (_entry_t(pk) < _key_to_t(key))
        rays = go.nonzero()[:, 0]
        for s in range(0, rays.shape[0], step):
            r = rays[s:s + step]
            cbase, vkey = _serve(o, d, r, pk[r] & NC_IDM, tri, c, lane,
                                 counts)
            take = vkey < key[r]
            key[r] = torch.where(take, vkey, key[r])
            base[r] = torch.where(take, cbase, base[r])
    return key, base


def closest_rank_walk_ref(o, d, mask, rank_keys, tri, spec: BVHSpec,
                          seed_key=None, rounds=None, counts=None):
    """Plain version of ``closest_rank_kernel`` that walks as its warps do.
    In each round every live ray takes its next candidate that survives
    the cull (not the sentinel, chopped entry below its chopped best), the
    rays of each 32-ray group in ray order (a warp) that asked for the same
    cluster form one group, and each requesting ray takes that cluster's
    minimum packed key when strictly smaller; a ray stops when its ranks
    run out.  Key and base equal :func:`closest_rank_ref`'s bit for bit;
    ``counts`` as there.

    ``rounds``: a list that receives each round's (N,) requested cluster
    id per ray (-1: none).  Returns ``(key (N,) i32, base (N,) i32, visits
    (N,) i32, sizes (G,) i64)``: ``visits`` the clusters each ray
    dense-tested, ``sizes`` the lanes of each group a warp served, over all
    rounds.  The CPU path of :func:`trace_closest_rank` with
    ``count_visits``; without, it stays :func:`closest_rank_ref`."""
    n, c, dev = o.shape[0], spec.cluster_size, o.device
    key, base = _start(n, spec, seed_key, dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    nxt = torch.zeros((n,), dtype=torch.long, device=dev)  # next rank
    warp = torch.arange(n, device=dev) // 32
    lane = torch.arange(c, dtype=torch.int32, device=dev)
    step = max(1, _REF_GATHER_ELEMS // (N_TRI_PLANES * c))
    sizes = []
    while True:
        req = torch.full((n,), -1, dtype=torch.long, device=dev)
        for k, pk in enumerate(rank_keys):
            go = (mask & (req < 0) & (nxt <= k) & (pk != NC_SENT)
                  & (_entry_t(pk) < _key_to_t(key)))
            req = torch.where(go, (pk & NC_IDM).long(), req)
            nxt = torch.where(go, k + 1, nxt)
        rays = (req >= 0).nonzero()[:, 0]
        if not rays.numel():
            break
        if rounds is not None:
            rounds.append(req)
        groups = warp[rays] * (NC_IDM + 1) + req[rays]
        sizes.append(torch.unique(groups, return_counts=True)[1])
        for s in range(0, rays.shape[0], step):
            r = rays[s:s + step]
            cbase, vkey = _serve(o, d, r, req[r], tri, c, lane, counts)
            take = vkey < key[r]
            key[r] = torch.where(take, vkey, key[r])
            base[r] = torch.where(take, cbase, base[r])
        visits[rays] += 1
    sizes = (torch.cat(sizes) if sizes
             else torch.zeros((0,), dtype=torch.long, device=dev))
    return key, base, visits, sizes


def trace_closest_rank(o, d, mask, rank_keys, tri, spec: BVHSpec,
                       seed_key=None, count_visits=False, counts=None):
    """Rank-directed closest walk over each ray's candidate clusters:
    ``closest_rank_kernel`` on a CUDA device, :func:`closest_rank_ref` on
    the CPU (``trace_pallas.trace_closest_rank``).

    ``rank_keys``: K >= 1 (N,) int32 packed candidate keys, ranks 1..K.
    ``seed_key``: the (N,) int32 host seed of ``global_seed_keys``; a scene
    with a global set needs it, for the walk has no global test of its own.
    ``counts`` and ``count_visits``: the kernel's options, as
    ``trace_cuda.trace_closest`` takes them.
    Returns ``(key, base)``: the packed best key and the slot base it counts
    from; decode with ``found = key < MISS``, ``t = key_to_t(key)``,
    ``tri = base + (key & IDX_MASK)``; with ``count_visits`` ``(key, base,
    visits (N,) int32)``."""
    rank_keys = list(rank_keys)
    if not rank_keys:
        raise ValueError("the rank walk needs at least one candidate key")
    if spec.num_global > 0 and seed_key is None:
        raise ValueError("trace_closest_rank needs the host global seed on "
                         "scenes with a global set")
    if spec.cluster_size > (1 << IDX_BITS):
        raise ValueError(f"cluster_size {spec.cluster_size} does not fit the "
                         f"{IDX_BITS}-bit in-cluster index of the packed key")
    n = o.shape[0]
    named = [(f"rank_keys[{k}]", x) for k, x in enumerate(rank_keys)]
    if seed_key is not None:
        named.append(("seed_key", seed_key))
    _check_rays(o, d, mask, tuple((name, x, (n,), torch.int32)
                                  for name, x in named))
    counts = active_counts(spec, counts)
    if o.device.type == "cpu":
        if count_visits:
            return closest_rank_walk_ref(o, d, mask, rank_keys, tri, spec,
                                         seed_key, counts=counts)[:3]
        return closest_rank_ref(o, d, mask, rank_keys, tri, spec, seed_key,
                                counts)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_tables(o.device, tri=tri)
    if (tri.dim() != 2 or tri.shape[0] != N_TRI_PLANES
            or tri.shape[1] < spec.num_clusters * spec.cluster_size):
        raise ValueError(f"bad plane table: tri {tuple(tri.shape)}")
    from ._build import load_library

    if counts is not None and (counts.dtype != torch.int32
                               or counts.device != o.device
                               or counts.shape[0] < spec.num_clusters):
        raise ValueError(f"counts must be int32 (>= {spec.num_clusters},) "
                         f"on {o.device}")
    lib = load_library()
    key = torch.empty((n,), dtype=torch.int32, device=o.device)
    base = torch.empty((n,), dtype=torch.int32, device=o.device)
    visits = (torch.zeros((n,), dtype=torch.int32, device=o.device)
              if count_visits else None)
    if n:
        o_c, d_c, m_c = o.contiguous(), d.contiguous(), mask.contiguous()
        s_c = None if seed_key is None else seed_key.contiguous()
        keys_c = torch.stack(rank_keys)  # (K, N), rank 1 first
        tri_c = tri.contiguous()
        args = (_ptr(o_c), _ptr(d_c), _ptr(m_c), _ptr(s_c), _ptr(keys_c),
                _ptr(tri_c), n, len(rank_keys), spec.cluster_size,
                tri_c.shape[1], spec.global_base)
        err = lib.launch_closest_rank(*args, _ptr(counts), _ptr(key),
                                      _ptr(base), _ptr(visits),
                                      _stream(o.device))
        _raise_on(err, lib, "closest_rank_kernel")
        trace_closest_rank.launches += 1
    return (key, base, visits) if count_visits else (key, base)


trace_closest_rank.launches = 0


def rank_certificate(key, rank_next_key):
    """Which rays the rank walk has settled (``trace_pallas
    .rank_certificate``): the chopped best plus one chop step is not above
    the rank-(K+1) candidate's chopped entry (candidates come sorted by
    entry, and a hit inside a box lies at or beyond its entry), or there is
    no such candidate.  Both sides are chopped down, at 9 and 12 bits; the
    one-step margin keeps the compare on the safe side, so a wrong "no" only
    sends one more ray to the fallback."""
    t_plus = ((key & ~IDX_MASK) + (1 << IDX_BITS)).view(torch.float32)
    return (rank_next_key == NC_SENT) | (t_plus <= _entry_t(rank_next_key))
