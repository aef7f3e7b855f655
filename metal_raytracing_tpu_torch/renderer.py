"""Wavefront path-tracing pipeline + progressive renderer, in PyTorch.

The port's counterpart of ``metal_raytracing_tpu.renderer``
(reference: MetalRaytracing/Raytracing.metal:156-405, Renderer.swift:284-351).
For each bounce, every ray is traced (closest hit), shaded from one shade-row
gather with branchless masked math, given one light sample and a shadow ray
(any hit), and re-emitted along a cosine-weighted bounce direction.  Samples
fold into a progressive average.

With ``compaction=False`` (the port's default) rays keep their pixel (tile)
order through every bounce.  With ``compaction=True`` the rays of bounces
>= 1 are sorted by a cluster key from the exact broad phase (the
``dir_major`` key where cluster keys do not apply), the shadow rays are
re-sorted by their own, rays that the broad phase proves can
only hit the global set skip the closest kernel, and with ``rank_trace=2``
the sorted bounce passes take the rank-directed walk (``ops.rank_cuda``)
with the hierarchical kernel as its fallback.  All of that is a permutation
of the rays plus exact shortcuts: the image is unchanged (``sort_pack_f16``
aside, which rounds what rides the sort to f16).  The reference's
multi-operand ``lax.sort`` is one ``torch.sort`` of the key and a gather of
the per-ray state by its permutation.  Nothing on the path waits for the
device.  With ``bake_primary`` the primary pass runs against tables that
hold the camera's position (``trace_cuda.bake_origin``), through the
hierarchical closest kernel's baked-origin form.

The shading extensions of the JAX package (environment map, emission,
textures, a specular Phong lobe, refraction; ``RenderConfig``) are plain
PyTorch between the trace passes, in the JAX package's order and on its
Halton dimensions, and each is off unless its flag is set.

The cluster tracers, the CUDA kernels (``tracer="cuda"``) and their plain
PyTorch versions (``"torch"``), return the packed key's chopped hit
distance, so the renderer recomputes the exact t from the winner's plane in
the shade row, as the reference does after its Pallas tracer.  The exact
tracers (``"bvh"``, ``"bruteforce"``; ``ops.trace``) take the reference's
path for its own exact tracers: their t as it is, the global set tested
inside the tracer, and under ``compaction`` the ``dir_major`` bounce key
and the light-major shadow key in place of the cluster keys.

``Renderer.step(k)`` renders ``k`` samples, by default the JAX package's
dispatch batch (``RenderConfig.samples_per_dispatch``).  Its counterpart of
the JAX package's one jitted dispatch of k samples is one replay of a CUDA
graph that holds them, on a CUDA device wherever :func:`graphs_apply`
allows: the same kernels in the same order, so the same image.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import sampling
from .lights import sample_lights, select_light
from .ops import rank_cuda, trace, trace_cuda
from .ops.broadphase_cuda import (BROADPHASE_MAX_CLUSTERS, NC_IDM,
                                  broadphase_keys, broadphase_ref,
                                  decode_cluster_key, nearest_cluster,
                                  nearest_cluster_pair)
from .ops.intersect import Hit
from .scene import Scene, SceneData, SceneSpec
from .types import RenderConfig
from .utils import profiling
from .utils.profiling import named_scope

__all__ = ["render_sample", "render_rays", "pixel_coords", "accumulate",
           "Renderer", "make_pixel_offsets", "make_tracers",
           "make_closest_rank", "resolve_tracer", "bake_tables",
           "graphs_apply"]

# Sort keys stay below this; dead rays take it and sort last.
_DEAD_KEY = 1 << 30
# The cluster sort keys hold a cluster id in at most 12 bits.
_MAX_KEY_CLUSTERS = 4095
# The JAX package's exact tracers (ops.trace): they test the global set
# themselves and return the exact t.
EXACT_TRACERS = ("bvh", "bruteforce")


def make_pixel_offsets(cfg: RenderConfig, device="cpu") -> torch.Tensor:
    """Per-pixel Halton index offsets, (H*W,) int32 in [0, 2^bits)."""
    with named_scope("pixel offsets"):
        return sampling.pixel_decorrelation_offsets(
            cfg.seed, cfg.height * cfg.width, bits=cfg.rand_offset_bits,
            device=device)


def _normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp(sampling.norm(v), min=eps)


def _env_lookup(env: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Nearest sample of a lat-long environment map along unit directions
    (``metal_raytracing_tpu.renderer._env_lookup``)."""
    he, we = env.shape[0], env.shape[1]
    u = torch.atan2(d[:, 0], -d[:, 2]) / (2.0 * math.pi) + 0.5
    v = torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    xi = torch.clamp((u * we).to(torch.int32), 0, we - 1)
    yi = torch.clamp((v * he).to(torch.int32), 0, he - 1)
    return env[yi.long(), xi.long()]


def _texel(data: SceneData, mid: torch.Tensor, u: torch.Tensor,
           v: torch.Tensor, bilinear: bool) -> torch.Tensor:
    """(N, 3) texel of material ``mid`` (int64) at texcoords (u, v): wrap
    at the UV square, OBJ's bottom-left origin (v flipped), clamp at the
    texel grid; nearest, or bilinear about texel centres (the JAX
    package's texture extension)."""
    fu = u - torch.floor(u)
    fv = v - torch.floor(v)
    hw = data.tex_hw[mid]  # (N, 2)
    hmax, wmax = hw[:, 0] - 1, hw[:, 1] - 1

    def at(yi, xi):
        return data.tex_stack[mid, yi.long(), xi.long()]

    def clip(i, hi):
        return torch.minimum(torch.clamp(i, min=0), hi)

    if not bilinear:
        xi = clip((fu * hw[:, 1]).to(torch.int32), wmax)
        yi = clip(((1.0 - fv) * hw[:, 0]).to(torch.int32), hmax)
        return at(yi, xi)
    # sample at (u W - 0.5, v H - 0.5) and lerp the 2x2 neighbourhood
    x = fu * hw[:, 1] - 0.5
    y = (1.0 - fv) * hw[:, 0] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    x0i, y0i = x0.to(torch.int32), y0.to(torch.int32)
    x1i, y1i = clip(x0i + 1, wmax), clip(y0i + 1, hmax)
    x0i, y0i = clip(x0i, wmax), clip(y0i, hmax)
    return ((at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx) * (1 - wy)
            + (at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx) * wy)


def resolve_tracer(cfg: RenderConfig, device) -> str:
    """The tracer the renderer runs: ``"auto"`` becomes ``"cuda"`` on a
    CUDA device and ``"torch"`` elsewhere, and ``"cuda"`` needs a CUDA
    device; ``"torch"``, ``"bvh"`` and ``"bruteforce"`` run on any device
    (``"bvh"`` through its kernels on a CUDA device)."""
    device = torch.device(device)
    if cfg.tracer == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if cfg.tracer == "cuda" and device.type != "cuda":
        raise ValueError(
            f"tracer='cuda' runs the CUDA kernels and needs a CUDA device, "
            f"got {device}; use tracer='torch' for their plain versions")
    return cfg.tracer


def graphs_apply(cfg: RenderConfig, device, tracer: str,
                 sharded: bool = False) -> bool:
    """Does ``Renderer.step`` run its samples as CUDA graph replays?  Only
    on a CUDA device, and only where a sample makes no host sync and its
    stats are not read: not with ``tracer="torch"`` (its plain versions
    call ``nonzero``), ``telemetry`` or ``export_rays``, and not for a
    ``parallel.ShardedRenderer`` (``sharded``: gloo stages every
    ``all_reduce`` through the host).  Everywhere else the samples run
    eagerly."""
    return (torch.device(device).type == "cuda" and tracer != "torch"
            and not cfg.telemetry and not cfg.export_rays and not sharded)


def _bakes(spec: SceneSpec, cfg: RenderConfig, tracer: str) -> bool:
    """Does the primary pass run on baked tables?  Under
    ``cfg.bake_primary``, but not for the exact tracers nor on flat scenes,
    as in the reference."""
    return (cfg.bake_primary and tracer not in EXACT_TRACERS
            and not trace_cuda._use_flat(spec.bvh))


def bake_tables(data: SceneData, spec: SceneSpec, cfg: RenderConfig,
                tracer: str):
    """The plane tables of ``cfg.bake_primary``'s primary pass, the
    scene's with the camera's position moved into them
    (``trace_cuda.bake_origin``), or None where the bake is off
    (:func:`_bakes`)."""
    if not _bakes(spec, cfg, tracer):
        return None
    with named_scope("bake"):
        return trace_cuda.bake_origin(data.sup_planes, data.clu_planes,
                                      data.tri_planes, data.camera.position)


def make_tracers(data: SceneData, spec: SceneSpec, tracer: str,
                 block: int = 128, count_visits: bool = False, counts=None,
                 baked=None):
    """(closest(o, d, mask, seed, seed_base=None, baked=False) -> Hit,
    any_hit(o, d, max_t, mask) -> bool): over the scene's packed planes,
    the kernel wrappers for ``tracer="cuda"`` and their plain versions for
    ``"torch"``; over its geometry and node boxes, the exact tracers of
    ``ops.trace`` for ``"bvh"`` (packets of ``block`` rays on the CPU) and
    ``"bruteforce"``, which take no seed.

    For the cluster tracers, ``counts`` (``SceneData.clu_counts``) turns
    on the kernels' chunk skip, and ``count_visits`` makes each return
    ``(result, visits)``, the clusters each ray dense-tested (the plain
    versions that walk, for ``"torch"``); the exact tracers ignore both.
    ``baked`` holds the tables of :func:`bake_tables`: ``closest(...,
    baked=True)`` traces rays that leave the camera against them, through
    the hierarchical kernel's baked-origin form or its plain versions."""
    if tracer in EXACT_TRACERS:
        g, lo, hi, bvh = data.geometry, data.node_lo, data.node_hi, spec.bvh

        if tracer == "bvh":
            def closest(o, d, m, seed=None, seed_base=None, baked=False):
                return trace.trace_closest(o, d, m, g, lo, hi, bvh, block)

            def any_hit(o, d, mt, m):
                return trace.trace_any(o, d, mt, m, g, lo, hi, bvh, block)
        else:
            def closest(o, d, m, seed=None, seed_base=None, baked=False):
                return trace.trace_closest_bruteforce(o, d, m, g)

            def any_hit(o, d, mt, m):
                return trace.trace_any_bruteforce(o, d, mt, m, g)
        return closest, any_hit
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    btabs = None if baked is None else (*baked, spec.bvh)
    if tracer == "cuda":
        def closest(o, d, m, seed, seed_base=None, baked=False):
            return trace_cuda.trace_closest(o, d, m,
                                            *(btabs if baked else tabs), seed,
                                            seed_base=seed_base,
                                            count_visits=count_visits,
                                            counts=counts,
                                            baked_origin=baked)

        def any_hit(o, d, mt, m):
            return trace_cuda.trace_any(o, d, mt, m, *tabs,
                                        count_visits=count_visits,
                                        counts=counts)
    elif count_visits:
        counts = trace_cuda.active_counts(spec.bvh, counts)

        def closest(o, d, m, seed, seed_base=None, baked=False):
            t, tri, visits = trace_cuda.closest_walk_ref(
                o, d, m, *(btabs if baked else tabs), seed, seed_base,
                counts=counts, baked=baked)
            z = torch.zeros_like(t)
            return Hit(t=t, u=z, v=z, tri=tri), visits

        def any_hit(o, d, mt, m):
            return trace_cuda.any_walk_ref(o, d, mt, m, *tabs, counts=counts)
    else:
        def closest(o, d, m, seed, seed_base=None, baked=False):
            t, tri = trace_cuda.closest_flat_ref(
                o, d, m, (btabs if baked else tabs)[2], spec.bvh, seed,
                seed_base, baked)
            z = torch.zeros_like(t)
            return Hit(t=t, u=z, v=z, tri=tri)

        def any_hit(o, d, mt, m):
            return trace_cuda.any_flat_ref(o, d, mt, m, data.tri_planes,
                                           spec.bvh)
    return closest, any_hit


def make_closest_rank(data: SceneData, spec: SceneSpec, cfg: RenderConfig,
                      tracer: str, closest):
    """``closest_rank(o, d, mask, rank_keys, seed) -> (Hit, unresolved
    count)`` for ``cfg.rank_trace``, or None where the walk is off: on a
    flat scene, on a scene with more padded clusters than the sort keys
    hold, and on a scene with a global set unless the miss fold's global
    pass gives the walk its seed (``host_seed`` and ``cluster_miss_fold``),
    as in the reference.  With ``cfg.telemetry`` it returns ``(Hit,
    unresolved, visits)`` (the walk's visits plus the fallback's) and
    ``closest`` must return ``(Hit, visits)``; ``cfg.chunk_skip`` hands the
    walk the cluster counts.

    ``rank_keys`` are the K + 1 packed candidate keys of ranks 1..K+1 in
    this call's ray order.  The walk (the kernel for ``tracer="cuda"``, its
    plain version otherwise) tests ranks 1..K; :func:`rank_cuda
    .rank_certificate` holds its best against rank K + 1; ``closest`` (the
    hierarchical tracer of :func:`make_tracers`) re-traces the uncertified
    rays, seeded per ray with the walk's key and base.  The reference sorts
    those stragglers to the front and back again so that whole TPU tiles
    die; the CUDA kernel's masked lanes ask for no cluster and cost their
    warp nothing, so the fallback runs in place (on an H100, packing dragon
    1024x1024's stragglers to the front first made the fallback no faster;
    PERF.md)."""
    bvh = spec.bvh
    if (not cfg.rank_trace or tracer in EXACT_TRACERS
            or trace_cuda._use_flat(bvh) or not _cluster_keys_fit(data)
            or not (bvh.num_global == 0
                    or (cfg.host_seed and cfg.cluster_miss_fold))):
        return None
    tele = cfg.telemetry
    counts = data.clu_counts if cfg.chunk_skip else None

    def walk(o, d, m, rank_keys, seed):
        if tracer == "cuda":
            return rank_cuda.trace_closest_rank(
                o, d, m, rank_keys, data.tri_planes, bvh, seed,
                count_visits=tele, counts=counts)
        counts_on = trace_cuda.active_counts(bvh, counts)
        if tele:
            return rank_cuda.closest_rank_walk_ref(
                o, d, m, rank_keys, data.tri_planes, bvh, seed,
                counts=counts_on)[:3]
        return rank_cuda.closest_rank_ref(o, d, m, rank_keys,
                                          data.tri_planes, bvh, seed,
                                          counts_on)

    def closest_rank(o, d, m, rank_keys, seed):
        k = len(rank_keys) - 1
        res = walk(o, d, m, list(rank_keys[:k]), seed)
        key, base = res[0], res[1]
        unresolved = m & ~rank_cuda.rank_certificate(key, rank_keys[k])
        fb = closest(o, d, unresolved, key, base)
        if tele:
            fb, fb_visits = fb
        found = key < trace_cuda._MISS_KEY
        tri_r = torch.where(found, base + (key & trace_cuda.IDX_MASK), -1)
        t = torch.where(unresolved, fb.t, trace_cuda._key_to_t(key))
        tri = torch.where(unresolved, fb.tri, tri_r)
        z = torch.zeros_like(t)
        hit = Hit(t=t, u=z, v=z, tri=tri)
        if tele:
            return hit, unresolved.sum(), res[2] + fb_visits
        return hit, unresolved.sum()

    return closest_rank


def _cluster_keys_fit(data: SceneData) -> bool:
    """Do the padded cluster ids fit the 12 bits of the cluster sort keys?
    Above that the compaction sorts take the ``dir_major`` bounce key and
    the light-major shadow key, as the reference does (its ``nc_tot <=
    4095``), and the rank walk, the pair sweep and the miss folds are off."""
    return data.clu_planes.shape[0] * data.clu_planes.shape[1] \
        <= _MAX_KEY_CLUSTERS


def _fused_keys(tracer: str, cfg: RenderConfig, data: SceneData, bvh,
                o, d, mask, **kw):
    """``(key1, key2, g)`` of the fused broad phase
    (``cfg.fused_broadphase``): the kernel for ``tracer="cuda"``, its plain
    version otherwise; ``kw`` as :func:`broadphase_keys` takes it."""
    if tracer == "cuda":
        return broadphase_keys(o, d, mask, data.clu_planes, data.tri_planes,
                               bvh, block=cfg.broadphase_block, **kw)
    return broadphase_ref(o, d, mask, data.clu_planes, data.tri_planes, bvh,
                          **kw)


def _expand_bits_9(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 9 bits so they occupy every 3rd bit (Morton)."""
    v = v & 0x1FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _morton_512(points: torch.Tensor, data: SceneData) -> torch.Tensor:
    """(N,) int32 27-bit Morton codes of points on a 512^3 grid over the
    root box: the origin part of the bounce and shadow sort keys."""
    root_lo = data.node_lo[0]
    root_ext = torch.clamp(data.node_hi[0] - root_lo, min=1e-12)
    q = torch.clamp(((points - root_lo) / root_ext) * 512.0, 0.0,
                    511.0).to(torch.int32)
    return (_expand_bits_9(q[:, 0]) << 2 | _expand_bits_9(q[:, 1]) << 1
            | _expand_bits_9(q[:, 2]))


def _octant(d: torch.Tensor) -> torch.Tensor:
    """(N,) int32 direction octant, x lowest."""
    return ((d[:, 0] > 0).to(torch.int32) + 2 * (d[:, 1] > 0).to(torch.int32)
            + 4 * (d[:, 2] > 0).to(torch.int32))


def _dir_cone(d: torch.Tensor, bits: int) -> torch.Tensor:
    """(N,) int32 direction cone: each axis of the unit direction quantized
    to ``bits`` bits, x highest."""
    lvl = 1 << (bits - 1)
    q = torch.clamp(((d + 1.0) * lvl).to(torch.int32), 0, 2 * lvl - 1)
    return (q[:, 0] << (2 * bits)) | (q[:, 1] << bits) | q[:, 2]


def _pack2f16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float32 arrays rounded to f16, their bits packed into one int32
    word, ``a`` high (``RenderConfig.sort_pack_f16``)."""
    def bits(x):
        return x.half().view(torch.int16).to(torch.int32) & 0xFFFF

    return (bits(a) << 16) | bits(b)


def _unpack2f16(w: torch.Tensor):
    """Inverse of :func:`_pack2f16` (exact on the stored f16 values)."""
    def value(x):
        return x.to(torch.int16).view(torch.float16).float()

    return value(w >> 16), value(w & 0xFFFF)


def cluster_key_bits(nc_tot: int):
    """The bit budget of the cluster bounce key's 30 bits (the reference's
    ``renderer.py:563-575`` for its ``cluster2`` layout): ``(cbits,
    c2bits, mbits)``, the bits of the nearest and second nearest cluster
    ids and the Morton bits left below the cone's 2 bits an axis."""
    cbits = max(1, nc_tot.bit_length())
    avail = 30 - cbits - 3 * 2
    c2bits = min(cbits, max(0, avail))
    return cbits, c2bits, max(0, avail - c2bits)


def cluster_key(bits, cid, cid2, d, m) -> torch.Tensor:
    """The cluster bounce key (``renderer.py:684-706``): the nearest
    cluster's id on top, the second nearest below it, the 2-bit-an-axis
    direction cone, then the top Morton bits, by ``bits`` of
    :func:`cluster_key_bits`."""
    cbits, c2bits, mbits = bits
    shift = 30 - cbits - c2bits
    key = (cid << (30 - cbits)) | ((cid2 & ((1 << c2bits) - 1)) << shift)
    key = key | (_dir_cone(d, 2) << (shift - 3 * 2))
    return key | (m >> max(0, 27 - mbits))


def direction_key(d, m) -> torch.Tensor:
    """The ``dir_major`` bounce key (``renderer.py:728-759``), where the
    cluster keys do not apply: the direction octant, then ``m``, the
    origins' Morton codes."""
    return (_octant(d) << 27) | m


def shadow_cluster_key(scid, light_idx, m, nc_tot: int,
                       bits_l: int) -> torch.Tensor:
    """The cluster shadow key (``renderer.py:1306-1316``): the segment's
    nearest cluster, the light (``bits_l`` bits), then the top Morton bits
    of the origin."""
    cbits_s = max(1, nc_tot.bit_length())
    mbits_s = max(0, 30 - cbits_s - bits_l)
    return ((scid << (30 - cbits_s)) | (light_idx << mbits_s)
            | (m >> max(0, 27 - mbits_s)))


def pixel_coords(cfg: RenderConfig, device="cpu"):
    """Flat (H*W,) pixel x/y coordinates in row-major order."""
    xs = torch.arange(cfg.width, dtype=torch.float32, device=device)
    ys = torch.arange(cfg.height, dtype=torch.float32, device=device)
    return xs.repeat(cfg.height), ys.repeat_interleave(cfg.width)


# Tile shapes per ray-block size: each block of rays covers a compact image
# tile (reference: Renderer.swift:295-300; Raytracing.metal:156).
_TILE_SHAPES = {64: (8, 8), 128: (8, 16), 256: (16, 16), 512: (16, 32),
                1024: (32, 32)}


def tile_shape(cfg: RenderConfig) -> Optional[Tuple[int, int]]:
    """(tile_h, tile_w) of the primary ray block when the image divides
    evenly, else None."""
    th_tw = _TILE_SHAPES.get(cfg.primary_ray_block or cfg.ray_block)
    if th_tw is None:
        return None
    th, tw = th_tw
    if cfg.height % th or cfg.width % tw:
        return None
    return th, tw


def _tile_flatten(img2d: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(H, W, ...) -> flat (H*W, ...) in tile-major order."""
    h, w = img2d.shape[0], img2d.shape[1]
    rest = tuple(img2d.shape[2:])
    t = img2d.reshape((h // th, th, w // tw, tw) + rest)
    return t.movedim(2, 1).reshape((h * w,) + rest)


def _tile_unflatten(flat: torch.Tensor, h: int, w: int, th: int,
                    tw: int) -> torch.Tensor:
    """Inverse of :func:`_tile_flatten`."""
    rest = tuple(flat.shape[1:])
    t = flat.reshape((h // th, w // tw, th, tw) + rest)
    return t.movedim(1, 2).reshape((h, w) + rest)


def render_rays(data: SceneData, spec: SceneSpec, cfg: RenderConfig,
                px: torch.Tensor, py: torch.Tensor, offsets: torch.Tensor,
                frame_index, tracer: str = "torch", tracers=None,
                baked_tables=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Path-trace one sample for a flat set of pixels.

    ``frame_index``: the sample index, an int or a 0-d int32 tensor on the
    rays' device (what a CUDA graph reads); the two give the same bits.

    ``baked_tables``: :func:`bake_tables`' result, computed here when the
    config bakes and it is not given (a renderer keeps its own); ignored
    where the config does not bake.  Where the primary pass bakes it calls
    ``closest(..., baked=True)``.

    ``tracers`` overrides the (closest, any_hit) pair of
    :func:`make_tracers`, or with a third entry also the ``closest_rank``
    of :func:`make_closest_rank` (a caller may wrap them to record each
    pass's rays; with ``cfg.telemetry`` they return visits as
    :func:`make_tracers` says).  Returns ((N, 3) radiance, stats);
    ``stats`` counts the traced rays for the Mrays/s metric,
    ``closest_rays`` and ``shadow_rays``, and where the rank walk ran the
    rays it left to the fallback, ``rank_unresolved_b<bounce>`` (all 0-d
    integer tensors, left on the device).  With ``cfg.telemetry`` also
    ``live_b<b>``, ``shadow_b<b>``, ``shadow_occn_b<b>`` and, for the
    cluster tracers, each ray's cluster visits ``visits_b<b>`` and
    ``shadow_visits_b<b>`` ((N,) int32 in the pass's ray order); with
    ``cfg.export_rays`` the strided ray rows ``rays_b<b>`` and
    ``srays_b<b>`` (``RenderConfig``).  None of it waits for the device."""
    w, h = cfg.width, cfg.height
    n = px.shape[0]
    dev = px.device
    block = cfg.ray_block
    pblock = cfg.primary_ray_block or block
    sblock = cfg.shadow_ray_block or block
    # rays padded to a common multiple of all block sizes, as the reference
    pad_to = math.lcm(block, pblock, sblock)
    if cfg.fused_broadphase:
        pad_to = math.lcm(pad_to, cfg.broadphase_block)
    p = -(-n // pad_to) * pad_to
    pad = p - n
    lcount = spec.light_count
    bvh = spec.bvh
    # The exact tracers take the JAX package's non-Pallas path: they test
    # the global set themselves (no host-side global passes), the bounce
    # and shadow sorts use the dir_major and light-major keys, and the
    # cluster-key knobs are off.
    exact = tracer in EXACT_TRACERS
    fold_global = cfg.host_seed and bvh.num_global > 0 and not exact
    nc_tot = data.clu_planes.shape[0] * data.clu_planes.shape[1]
    # The exact tracers, and the cluster tracers on a build whose padded
    # cluster ids do not fit the sort keys' 12 bits, sort by the dir_major
    # and light-major keys (no cluster keys, miss folds, pair sweep or rank
    # walk), as the reference does.
    dir_keys = exact or not _cluster_keys_fit(data)
    fused_keys = (cfg.fused_broadphase and not dir_keys
                  and nc_tot <= BROADPHASE_MAX_CLUSTERS)
    tele = cfg.telemetry and not exact  # visits: the cluster tracers only
    last = cfg.max_bounces - 1
    shade_ext = (cfg.enable_specular or cfg.enable_emission
                 or cfg.enable_textures or cfg.enable_refraction)

    with named_scope("raygen"):
        px = torch.nn.functional.pad(px, (0, pad))
        py = torch.nn.functional.pad(py, (0, pad))
        alive = torch.arange(p, device=dev) < n
        idx = torch.nn.functional.pad(offsets.to(torch.int32), (0, pad)) \
            + frame_index

        # Camera ray generation (reference: Raytracing.metal:201-218).
        jitter_x = sampling.halton(idx, sampling.DIM_PIXEL_X)
        jitter_y = sampling.halton(idx, sampling.DIM_PIXEL_Y)
        uv_x = (px + jitter_x) / w * 2.0 - 1.0
        uv_y = (py + jitter_y) / h * 2.0 - 1.0
        cam = data.camera
        d = _normalize(uv_x[:, None] * cam.right[None]
                       + uv_y[:, None] * cam.up[None] + cam.forward[None])
        o = cam.position[None].expand(p, 3)

    if not _bakes(spec, cfg, tracer):
        baked_tables = None
    elif baked_tables is None:
        baked_tables = bake_tables(data, spec, cfg, tracer)
    tracers = tuple(tracers or make_tracers(
        data, spec, tracer, block, count_visits=tele,
        counts=data.clu_counts if cfg.chunk_skip else None,
        baked=baked_tables))
    closest_fn, any_fn = tracers[:2]
    closest_rank_fn = (tracers[2] if len(tracers) > 2 else
                       make_closest_rank(data, spec, cfg, tracer, closest_fn))
    color = torch.ones((p, 3), device=dev)  # path throughput (:226)
    accum = torch.zeros((p, 3), device=dev)
    # ``cur`` maps the current (compacted) ray order back to the padded
    # pixel slot; the radiance scatters through it at the end.
    cur = torch.arange(p, dtype=torch.int32, device=dev)
    stats: Dict[str, torch.Tensor] = {
        "closest_rays": torch.zeros((), dtype=torch.int64, device=dev),
        "shadow_rays": torch.zeros((), dtype=torch.int64, device=dev)}
    # The bounce sorts emit the packed rank 1..3 keys for the rank-directed
    # walk behind the exact broad phase (the fused kernel gives no third
    # rank).
    rank_sort = (closest_rank_fn is not None and cfg.sort_bounces
                 and not fused_keys)
    # One nearest_cluster_pair sweep gives a bounce's shadow key and the
    # next bounce's sort keys where both come from the exact broad phase
    # over the shared origin, which refraction breaks (a refracted ray
    # starts inside the surface).
    pair_sweep = (cfg.pair_broadphase and not cfg.fused_broadphase
                  and not dir_keys and not cfg.enable_refraction
                  and cfg.sort_bounces)

    def sorts_at(bounce: int) -> bool:
        """Do this bounce's rays go through the compaction sort?"""
        return cfg.compaction and bounce > 0

    def shadow_sorts_at(bounce: int) -> bool:
        return cfg.shadow_sort and sorts_at(bounce)

    def pair_at(bounce: int) -> bool:
        """Does ``bounce_tail(bounce)`` take its keys from the pair sweep?
        Not at the last bounce, whose shadow key is the hit's cluster and
        which has no next bounce."""
        return pair_sweep and shadow_sorts_at(bounce) and bounce < last

    def cluster_sort_key(o, d, alive, carried_bp):
        """The cluster key of the reference's ``bounce_sort``
        (``renderer.py:542-727``, its ``cluster2`` layout): the nearest
        cluster's id (the no-cluster group ``nc_tot`` for rays the miss
        fold proves can only hit the global set), the second nearest below
        it as the 30-bit budget allows, a direction cone, then as much
        origin Morton as fits.  Returns (key, id bits, rank keys or
        None)."""
        bits = cluster_key_bits(nc_tot)
        gk_fused = rank_keys = None
        if carried_bp is not None:
            cid, nckey = carried_bp[0], carried_bp[1]
            if len(carried_bp) >= 4:  # packed ranks 2 and 3
                cid2 = decode_cluster_key(carried_bp[2], nc_tot)
                rank_keys = (nckey, carried_bp[2], carried_bp[3])
            else:
                cid2 = carried_bp[2]
        elif rank_sort:
            # ranks 1..2 drive the walk, rank 3 is its certificate
            cid, nckey, k2p, k3p = nearest_cluster(
                o, d, alive, data.clu_planes, bvh, return_key=True,
                return_second=2, return_packed=True)
            cid2 = decode_cluster_key(k2p, nc_tot)
            rank_keys = (nckey, k2p, k3p)
        elif fused_keys:
            nckey, k2f, gk_fused = _fused_keys(
                tracer, cfg, data, bvh, o, d, alive, want2=True)
            cid = decode_cluster_key(nckey, nc_tot)
            cid2 = decode_cluster_key(k2f, nc_tot)
        else:
            cid, nckey, cid2 = nearest_cluster(o, d, alive, data.clu_planes,
                                               bvh, return_key=True,
                                               return_second=1)
        if cfg.cluster_miss_fold and bvh.num_global > 0:
            # A ray whose nearest cluster is entered beyond its global-set
            # hit finds nothing closer in any cluster: it joins the
            # no-cluster group.  One chop step of margin covers both keys'
            # truncated mantissas, one more the fused kernel's
            # Newton-refined t (a quarter step off the exact divide); the
            # margin only ever folds fewer rays.
            gk = (gk_fused if gk_fused is not None
                  else trace_cuda.global_seed_keys(o, d, alive,
                                                   data.tri_planes, bvh))
            tn_f = (nckey & ~NC_IDM).view(torch.float32)
            g_plus = ((gk & ~trace_cuda.IDX_MASK)
                      + ((2 if gk_fused is not None else 1)
                         << trace_cuda.IDX_BITS)).view(torch.float32)
            beats = (gk < trace_cuda._MISS_KEY) & (tn_f >= g_plus)
            cid = torch.where(beats, nc_tot, cid)
        key = cluster_key(bits, cid, cid2, d, _morton_512(o, data))
        return key, bits[0], rank_keys

    def bounce_sort(o, d, color, accum, idx, cur, alive, carried_bp):
        """Compaction-sort one bounce's rays.  ``carried_bp`` holds this
        bounce's keys where the previous tail's pair sweep computed them.
        Returns the permuted per-ray state, ``known_miss`` (live rays the
        broad phase proved can hit no cluster; None when the fold is off)
        and the sorted rank keys (None unless ``rank_sort``)."""
        rank_keys = cbits = None
        if cfg.sort_bounces and not dir_keys:
            key, cbits, rank_keys = cluster_sort_key(o, d, alive, carried_bp)
        elif cfg.sort_bounces:
            # the exact tracers and builds past 4,095 padded clusters take
            # dir_major, as the reference does
            key = direction_key(d, _morton_512(o, data))
        if cfg.sort_bounces:
            key = torch.where(alive, key, _DEAD_KEY)
            skey, perm = torch.sort(key)  # tie order is free
        else:
            # Partition only: live rays first, in their (tile) order.
            key = torch.where(alive, 0, _DEAD_KEY).to(torch.int32)
            skey, perm = torch.sort(key, stable=True)
        o, d, idx, cur = o[perm], d[perm], idx[perm], cur[perm]
        if cfg.sort_pack_f16:
            # throughput and radiance ride the sort as three f16-pair words
            words = torch.stack([_pack2f16(color[:, 0], color[:, 1]),
                                 _pack2f16(color[:, 2], accum[:, 0]),
                                 _pack2f16(accum[:, 1], accum[:, 2])], 1)
            words = words[perm]
            c0, c1 = _unpack2f16(words[:, 0])
            c2, a0 = _unpack2f16(words[:, 1])
            a1, a2 = _unpack2f16(words[:, 2])
            color = torch.stack([c0, c1, c2], dim=1)
            accum = torch.stack([a0, a1, a2], dim=1)
        else:
            color, accum = color[perm], accum[perm]
        alive = skey < _DEAD_KEY
        if rank_keys is not None:
            rank_keys = tuple(k[perm] for k in rank_keys)
        known_miss = None
        if cbits is not None and cfg.cluster_miss_fold:
            # the no-cluster group sits just below the dead sentinel
            known_miss = alive & ((skey >> (30 - cbits)) == nc_tot)
        return o, d, color, accum, idx, cur, alive, known_miss, rank_keys

    def shadow_trace(bounce, shadow_o, sdir, sdist, light_idx, tri,
                     kernel_shadow, sk, pair_scid):
        """The any-hit pass of one bounce, through the shadow re-sort where
        it applies; ``sk`` holds the fused broad phase's nearest cluster
        key where it ran, ``pair_scid`` the pair sweep's nearest cluster
        where that ran.  Returns the (N,) occlusion in
        the caller's ray order, the mask the pass traced (after the
        re-sort's fold) in that order, and with telemetry the pass's visits
        in its own ray order."""
        if not shadow_sorts_at(bounce):
            res = any_fn(shadow_o, sdir, sdist, kernel_shadow)
            return ((res[0], kernel_shadow, res[1]) if tele
                    else (res, kernel_shadow, None))
        # Shadow origins are this bounce's scattered hit points and the
        # direction follows from the origin (it points at the light), so the
        # key is (nearest cluster the segment can hit, light, origin
        # Morton), or (light, origin Morton) where the cluster keys do not
        # apply.  A segment that overlaps no cluster is clear: with the fold
        # it skips the kernel (global-set occlusion is already out of
        # ``kernel_shadow``).
        m = _morton_512(shadow_o, data)
        bits_l = max(1, (lcount - 1).bit_length())
        if dir_keys:
            # light-major: light, then origin Morton
            shift = 29 - bits_l
            skey = (light_idx << shift) | (m if shift >= 27
                                           else m >> (27 - shift))
        elif bounce == last:
            # The ray starts on this bounce's hit triangle, inside its
            # cluster's box: that cluster is the key, for free (hits on the
            # global set form a group of their own), and the fold tests the
            # super boxes (no super overlap, no cluster overlap).
            scid = torch.where(
                tri >= bvh.global_base, nc_tot,
                torch.clamp(tri // bvh.cluster_size, max=nc_tot - 1))
            if cfg.cluster_miss_fold:
                sid = nearest_cluster(shadow_o, sdir, kernel_shadow,
                                      data.sup_planes[:, None, :], bvh,
                                      max_t=sdist)
                kernel_shadow = kernel_shadow & (
                    sid < data.sup_planes.shape[0])
        else:
            if sk is not None:  # the fused pass already ran
                scid = decode_cluster_key(sk, nc_tot)
            elif pair_scid is not None:  # so did the pair sweep
                scid = pair_scid
            else:
                scid = nearest_cluster(shadow_o, sdir, kernel_shadow,
                                       data.clu_planes, bvh, max_t=sdist)
            if cfg.cluster_miss_fold:
                kernel_shadow = kernel_shadow & (scid < nc_tot)
        if not dir_keys:
            skey = shadow_cluster_key(scid, light_idx, m, nc_tot, bits_l)
        skey = torch.where(kernel_shadow, skey, _DEAD_KEY)
        skey, perm = torch.sort(skey)
        res = any_fn(shadow_o[perm], sdir[perm], sdist[perm],
                     skey < _DEAD_KEY)
        visits = None
        if tele:
            res, visits = res
        occluded = torch.empty_like(res)
        occluded[perm] = res  # back to the caller's order
        return occluded, kernel_shadow, visits

    def bounce_tail(bounce, o, d, color, accum, idx, alive, known_miss,
                    rank_keys):
        """Closest hit, shading, the light sample and its shadow ray, and
        the bounce continuation: everything after the compaction sort.
        Returns the per-ray state and the next bounce's carried keys (None
        unless :func:`pair_at`)."""
        n_alive = alive.sum()
        stats["closest_rays"] += n_alive
        if cfg.telemetry:
            stats[f"live_b{bounce}"] = n_alive
        if cfg.export_rays:
            # a strided sample of this pass's rays for the sah_rays builder
            st = cfg.export_rays
            stats[f"rays_b{bounce}"] = torch.cat(
                [o[::st], d[::st],
                 torch.full((o[::st].shape[0], 1), math.inf, device=dev),
                 alive[::st, None].float()], dim=1)
        mats = data.materials
        # The cluster tracers' closest pass is always seeded on the host
        # side: the port's cluster kernels have no in-kernel global-set
        # test.
        with named_scope("global passes"):
            m_kernel = alive
            gkey = seed = None
            if known_miss is not None:
                m_kernel = alive & ~known_miss
                if bvh.num_global:
                    # one global pass seeds the kernel (folded rays start from
                    # the init key) and gives the folded rays their hits below
                    gkey = trace_cuda.global_seed_keys(o, d, alive,
                                                       data.tri_planes, bvh)
                    seed = torch.where(known_miss, trace_cuda._INIT_KEY, gkey)
            elif exact:
                pass  # the exact tracers test the global set themselves
            elif bvh.num_global and cfg.fused_broadphase:
                seed = _fused_keys(tracer, cfg, data, bvh, o, d, alive,
                                   with_clusters=False)[2]
            elif bvh.num_global:
                seed = trace_cuda.global_seed_keys(o, d, alive,
                                                   data.tri_planes, bvh)
        with named_scope("closest trace"):
            if rank_keys is not None:
                res = closest_rank_fn(o, d, m_kernel, rank_keys, seed)
                hit = res[0]
                stats[f"rank_unresolved_b{bounce}"] = res[1]
                if tele:
                    stats[f"visits_b{bounce}"] = res[2]
            elif bounce == 0 and baked_tables is not None:
                # every primary ray leaves the camera: the baked tables
                hit = closest_fn(o, d, m_kernel, seed, baked=True)
                if tele:
                    hit, stats[f"visits_b{bounce}"] = hit
            else:
                hit = closest_fn(o, d, m_kernel, seed)
                if tele:
                    hit, stats[f"visits_b{bounce}"] = hit
            if gkey is not None:
                # Global-set hits of the folded rays, in the packing the kernel
                # would have returned; sky rays stay misses.
                gfound = known_miss & (gkey < trace_cuda._MISS_KEY)
                hit = Hit(t=torch.where(gfound, trace_cuda._key_to_t(gkey),
                                        hit.t),
                          u=hit.u, v=hit.v,
                          tri=torch.where(
                              gfound,
                              bvh.global_base + (gkey & trace_cuda.IDX_MASK),
                              hit.tri))
        with named_scope("shade"):
            if cfg.env_map and spec.has_env_map:
                escaped = alive & ~hit.found
                env = _env_lookup(data.env_map, d)
                accum = accum + torch.where(escaped[:, None], color * env,
                                            0.0)
            # the megakernel's break on miss (:246-247)
            alive = alive & hit.found
            tri = hit.tri.clamp(min=0)
            row = data.shade_table[tri.long()]
            mid = row[:, 15].long() if shade_ext else None  # hit material

            if exact:
                t_hit = hit.t
            else:
                # Exact hit distance from the winner's plane [n, n.v0] in the
                # shade row: t = (n.v0 - n.o) / (n.d); the tracer's t is
                # chopped.
                nrow = row[:, 16:19]
                den = (nrow * d).sum(-1)
                num = row[:, 19] - (nrow * o).sum(-1)
                tiny = torch.where(den < 0, -1e-20, 1e-20).to(den.dtype)
                t_hit = num / torch.where(den.abs() < 1e-20, tiny, den)
            # Dead lanes keep pos = o (no BIG_T overflow into the light math).
            pos = o + d * torch.where(alive, t_hit, 0.0)[:, None]
            # ns = M pos + m0: barycentric corner-normal interpolation
            # (reference: Raytracing.metal:60-73).
            ns = (row[:, 0:3] * pos[:, 0:1] + row[:, 3:6] * pos[:, 1:2]
                  + row[:, 6:9] * pos[:, 2:3] + row[:, 9:12])
            ns = _normalize(ns)
            base_color = row[:, 12:15]
            if cfg.enable_textures and spec.has_textures:
                # uv(p) = A p + b from the triangle's affine UV row
                uvrow = data.uv_table[tri.long()]
                u_t = (uvrow[:, 0] * pos[:, 0] + uvrow[:, 2] * pos[:, 1]
                       + uvrow[:, 4] * pos[:, 2] + uvrow[:, 6])
                v_t = (uvrow[:, 1] * pos[:, 0] + uvrow[:, 3] * pos[:, 1]
                       + uvrow[:, 5] * pos[:, 2] + uvrow[:, 7])
                base_color = base_color * _texel(
                    data, mid, u_t, v_t, cfg.texture_filter == "bilinear")
            if cfg.enable_emission:
                accum = accum + torch.where(alive[:, None],
                                            color * mats.emission[mid], 0.0)

            # One uniformly random light per ray (reference: :272-275).
            lu = sampling.halton(idx, sampling.bounce_dim(bounce, 0))
            light_idx = select_light(lu, lcount)
            r_light = torch.stack(
                [sampling.halton(idx, sampling.bounce_dim(bounce, 1)),
                 sampling.halton(idx, sampling.bounce_dim(bounce, 2))], dim=-1)
            ls = sample_lights(data.lights, light_idx, r_light, pos)

            ndotl = torch.clamp((ns * ls.direction).sum(-1), 0.0, 1.0)
            lcolor = ls.color * ndotl[:, None] * lcount  # :331-335
            # Diffuse throughput for this vertex's light sample (:339).
            dcolor = torch.where(alive[:, None], color * base_color, color)
            do_shadow = alive & (sampling.norm(lcolor)[:, 0] > 1e-4)  # :341
            n_shadow = do_shadow.sum()
            stats["shadow_rays"] += n_shadow
            shadow_o = pos + ns * 1e-3  # :350
            sdist = ls.distance - 1e-3
        with named_scope("global passes"):
            # Global-set occlusion on the host side of the kernel: rays the
            # scene-spanning planes occlude leave the kernel's mask (they still
            # count as traced shadow rays).  The fused pass also gives the
            # shadow sort's cluster key where that is the exact one.
            sk = None
            want_skey = (fused_keys and shadow_sorts_at(bounce)
                         and bounce < last)
            if cfg.fused_broadphase and (want_skey or fold_global):
                sk1, _, socc = _fused_keys(
                    tracer, cfg, data, bvh, shadow_o, ls.direction, do_shadow,
                    max_t=sdist, with_clusters=want_skey, any_mode=True)
                if want_skey:
                    sk = sk1
                g_occ = (socc > 0 if fold_global
                         else torch.zeros_like(do_shadow))
            elif fold_global:
                g_occ = trace_cuda.global_any_hit(shadow_o, ls.direction,
                                                  sdist, do_shadow,
                                                  data.tri_planes, bvh)
            else:
                g_occ = torch.zeros_like(do_shadow)
            kernel_shadow = do_shadow & ~g_occ

        with named_scope("bounce + accumulate"):
            # The bounce continuation (reference: :384-391, a cosine-weighted
            # diffuse bounce), before the shadow trace: the next direction
            # feeds the pair sweep.  Without refraction the next origin is the
            # shadow origin, bit for bit.
            r_bounce = torch.stack(
                [sampling.halton(idx, sampling.bounce_dim(bounce, 3)),
                 sampling.halton(idx, sampling.bounce_dim(bounce, 4))], dim=-1)
            local = sampling.sample_cosine_weighted_hemisphere(r_bounce)
            d_next = sampling.align_hemisphere_with_normal(local, ns)
            color_next, o_next, nee_w = dcolor, shadow_o, None
            # The extensions' Halton dimensions lie past the reference's
            # schedule, so the shared ones keep their values.
            ext_dim = 2 + 5 * cfg.max_bounces + bounce
            if cfg.enable_specular:
                # per ray, the diffuse lobe or a Phong lobe about the mirror
                # direction, chosen by Ks against Kd
                spec_color = mats.specular[mid]
                shininess = mats.specular_exponent[mid][:, None]
                kd_max = base_color.amax(dim=-1)
                ks_max = spec_color.amax(dim=-1)
                p_spec = ks_max / torch.clamp(kd_max + ks_max, min=1e-6)
                take_spec = (alive & (sampling.halton(idx, ext_dim) < p_spec)
                             & (ks_max > 0.0))
                refl = d - 2.0 * (d * ns).sum(-1, keepdim=True) * ns
                cos_a = r_bounce[:, 1:2] ** (1.0 / (shininess + 1.0))
                sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
                phi = 2.0 * math.pi * r_bounce[:, 0:1]
                lobe = torch.cat([sin_a * torch.cos(phi), cos_a,
                                  sin_a * torch.sin(phi)], dim=-1)
                d_spec = sampling.align_hemisphere_with_normal(lobe, refl)
                # keep specular samples above the surface
                below = (d_spec * ns).sum(-1, keepdim=True) <= 0.0
                d_spec = torch.where(below, refl, d_spec)
                p_spec_c = torch.clamp(p_spec, 1e-6, 1.0 - 1e-6)[:, None]
                spec_tp = color * spec_color / p_spec_c
                diff_tp = torch.where(alive[:, None],
                                      color * base_color / (1.0 - p_spec_c),
                                      color)
                d_next = torch.where(take_spec[:, None], d_spec, d_next)
                color_next = torch.where(take_spec[:, None], spec_tp, diff_tp)
            if cfg.enable_refraction:
                # A dielectric (dissolve < 1, Ni > 0) transmits with
                # probability 1 - dissolve by Snell, reflecting by Schlick's
                # Fresnel or total internal reflection, on the side-aware
                # normal; its diffuse layer, this vertex's light sample
                # included, carries the dissolve share.  Shadow rays still
                # take glass as an occluder (as in the JAX package).
                ni_r = mats.refraction_index[mid]
                dvis = mats.dissolve[mid]
                transmissive = alive & (dvis < 1.0) & (ni_r > 0.0)
                nee_w = torch.where(transmissive, dvis, 1.0)[:, None]
                take_t = transmissive & (
                    sampling.halton(idx, ext_dim + cfg.max_bounces) >= dvis)
                inside = (d * ns).sum(-1) > 0.0  # a back-face hit
                n_eff = torch.where(inside[:, None], -ns, ns)
                ci = torch.clamp(-(d * n_eff).sum(-1), 0.0, 1.0)
                ni_s = torch.clamp(ni_r, min=1.0 + 1e-6)
                eta = torch.where(inside, ni_s, 1.0 / ni_s)
                sin2_t = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
                tir = sin2_t > 1.0
                cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
                d_refr = _normalize(eta[:, None] * d
                                    + (eta * ci - cos_t)[:, None] * n_eff)
                d_refl = _normalize(d + 2.0 * ci[:, None] * n_eff)
                f0 = ((ni_s - 1.0) / (ni_s + 1.0)) ** 2
                c1 = 1.0 - ci
                c2 = c1 * c1  # (1 - ci)^5 by the JAX package's integer power
                fr = torch.where(tir, 1.0, f0 + (1.0 - f0) * (c1 * (c2 * c2)))
                refl_t = sampling.halton(
                    idx, ext_dim + 2 * cfg.max_bounces) < fr
                d_next = torch.where(
                    take_t[:, None],
                    torch.where(refl_t[:, None], d_refl, d_refr), d_next)
                # glass is tinted by Kd where it has one ("clear" otherwise)
                tinted = base_color.amax(dim=-1, keepdim=True) > 1e-4
                tint = torch.where(tinted, base_color, 1.0)
                t_tp = torch.where(alive[:, None], color * tint, color)
                color_next = torch.where(take_t[:, None], t_tp, color_next)
                # a refracted ray goes on through the surface
                off_n = torch.where(
                    take_t[:, None],
                    torch.where(refl_t[:, None], n_eff, -n_eff), ns)
                o_next = pos + off_n * 1e-3

        pair_scid = pair_bp = None
        if pair_at(bounce):
            with named_scope("sort keys"):
                res = nearest_cluster_pair(
                    shadow_o, ls.direction, sdist, kernel_shadow, d_next,
                    alive, data.clu_planes, bvh, ranks=3 if rank_sort else 2,
                    return_packed=rank_sort)
                pair_scid, pair_bp = res[0], res[1:]

        with named_scope("shadow trace"):
            occluded, kernel_shadow, svisits = shadow_trace(
                bounce, shadow_o, ls.direction, sdist, light_idx, tri,
                kernel_shadow, sk, pair_scid)
        if tele:
            stats[f"shadow_visits_b{bounce}"] = svisits
        if cfg.export_rays:
            # a strided sample of this pass's shadow segments
            st = cfg.export_rays
            stats[f"srays_b{bounce}"] = torch.cat(
                [shadow_o[::st], ls.direction[::st], sdist[::st, None],
                 kernel_shadow[::st, None].float()], dim=1)
        if cfg.telemetry:
            # shadow rays occluded, by the global set or the pass
            stats[f"shadow_b{bounce}"] = n_shadow
            stats[f"shadow_occn_b{bounce}"] = (
                do_shadow & (occluded | g_occ)).sum()
        with named_scope("bounce + accumulate"):
            visible = do_shadow & ~occluded & ~g_occ
            nee = lcolor * dcolor if nee_w is None else lcolor * dcolor * nee_w
            accum = accum + torch.where(visible[:, None], nee,
                                        torch.zeros_like(accum))  # :371-373
        return o_next, d_next, color_next, accum, alive, pair_bp

    carried_bp = None
    for bounce in range(cfg.max_bounces):
        profiling.mark_bounce(bounce)
        known_miss = rank_keys = None
        if sorts_at(bounce):
            with named_scope("sort keys"):
                (o, d, color, accum, idx, cur, alive, known_miss,
                 rank_keys) = bounce_sort(o, d, color, accum, idx, cur,
                                          alive, carried_bp)
        o, d, color, accum, alive, carried_bp = bounce_tail(
            bounce, o, d, color, accum, idx, alive, known_miss, rank_keys)

    # a sort runs only with more than one bounce, where the reference too
    # un-permutes
    if any(sorts_at(b) for b in range(cfg.max_bounces)):
        with named_scope("bounce + accumulate"):
            radiance = torch.empty_like(accum)
            radiance[cur.long()] = accum  # back to pixel order
    else:
        radiance = accum
    return radiance[:n], stats


def render_sample(data: SceneData, spec: SceneSpec, cfg: RenderConfig,
                  offsets: torch.Tensor, frame_index,
                  tracer: str = "torch", tracers=None, baked_tables=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render one full-frame sample; returns ((H, W, 3) radiance, stats).

    Pixels are traced in tile-major order when the image divides into
    primary-block tiles, then restored to row-major order.
    ``frame_index``, ``tracers`` and ``baked_tables`` as
    :func:`render_rays`."""
    px, py = pixel_coords(cfg, offsets.device)
    tiles = tile_shape(cfg)
    if tiles is not None:
        th, tw = tiles
        px = _tile_flatten(px.reshape(cfg.height, cfg.width), th, tw)
        py = _tile_flatten(py.reshape(cfg.height, cfg.width), th, tw)
        offsets = _tile_flatten(offsets.reshape(cfg.height, cfg.width),
                                th, tw)
    radiance, stats = render_rays(data, spec, cfg, px, py, offsets,
                                  frame_index, tracer, tracers, baked_tables)
    if tiles is not None:
        return _tile_unflatten(radiance, cfg.height, cfg.width, th, tw), stats
    return radiance.reshape(cfg.height, cfg.width, 3), stats


def accumulate(prev: torch.Tensor, sample: torch.Tensor,
               frame_index) -> torch.Tensor:
    """Progressive average (reference: Raytracing.metal:395-401).

    ``frame_index`` is an int or a 0-d integer tensor on ``prev``'s device;
    either way the weight is a 0-d float32 tensor there, so the two forms
    give the same bits (a Python float divisor would make the division a
    multiply by its reciprocal on a CUDA device)."""
    if torch.is_tensor(frame_index):
        fi = frame_index.float()
    else:
        fi = torch.full((), float(np.float32(frame_index)),
                        device=prev.device)
    return (prev * fi + sample) / (fi + 1.0)


class Renderer:
    """Progressive renderer: owns the scene tensors on ``device`` and the
    accumulation state (reference: Renderer.swift:12-357, headless).

    The (accumulation image, sample count, seed) triple is the checkpoint
    state; checkpoints use the JAX package's npz keys and fingerprint, so
    they load across the two packages.

    Where ``graphed`` (:func:`graphs_apply`), :meth:`step` replays one CUDA
    graph of its k samples, captured at the first step of k samples (all
    graphs in one memory pool) after one eager warm-up sample on a side
    stream that builds the kernels.  A graph reads and writes the state in
    place: ``accum``, ``ray_totals`` and ``frame``, the device copy of the
    host's ``frame_index``.  :meth:`reset` and the checkpoint loads write
    them in place; :meth:`refine` rebuilds the tables the graphs read, so
    it drops them.  A failed capture raises.

    With :meth:`set_marks` on, each graph also records a device timestamp
    at the entry and the exit of every layer scope of its samples
    (``utils.profiling.LayerMarks``, kept with the graph), and
    :meth:`layer_ms` reads the layers' device ms of the last replay.

    Set-up runs inside the scopes ``cuda init`` (the first touch of a CUDA
    device, before the upload), ``scene build``, ``bake``, ``pixel
    offsets``, ``warm-up sample`` and ``graph capture``, which
    ``utils.profiling.span_log`` logs where one is open."""

    def __init__(self, scene: Scene, cfg: RenderConfig, device="cuda"):
        self.scene = scene
        self.cfg = cfg
        self.device = torch.device(device)
        self.tracer = resolve_tracer(cfg, self.device)
        if self.device.type == "cuda":
            with named_scope("cuda init"):
                torch.empty((1,), device=self.device)
                torch.cuda.synchronize(self.device)
        self.data, self.spec = scene.build(
            cluster_size=cfg.cluster_size, builder=cfg.bvh_builder,
            presplit=cfg.bvh_presplit, builder_alpha=cfg.bvh_alpha,
            device=self.device)
        # the primary pass's tables under bake_primary, once a build
        self.baked = bake_tables(self.data, self.spec, cfg, self.tracer)
        self.offsets = make_pixel_offsets(cfg, self.device)
        # samples a step by default (the JAX package's auto tiers)
        self.samples_per_dispatch = cfg.samples_per_dispatch or (
            8 if cfg.num_pixels <= 256 * 256
            else 4 if cfg.num_pixels <= 512 * 512 else 2)
        self.graphed = graphs_apply(cfg, self.device, self.tracer)
        self.graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}
        self._pool = None
        self.marked = False  # graphs captured from now on carry marks
        self.graph_marks: Dict[int, profiling.LayerMarks] = {}
        self._last_k: Optional[int] = None
        self.accum = torch.zeros((cfg.height, cfg.width, 3),
                                 dtype=torch.float32, device=self.device)
        self.ray_totals = torch.zeros((2,), dtype=torch.float32,
                                      device=self.device)
        self.frame = torch.zeros((), dtype=torch.int32, device=self.device)
        self.frame_index = 0

    def reset(self) -> None:
        """Restart progressive accumulation (reference:
        Renderer.swift:353-355)."""
        self.frame_index = 0
        for x in (self.accum, self.ray_totals, self.frame):
            x.zero_()

    def step(self, k: Optional[int] = None) -> None:
        """Render ``k`` samples (default: ``samples_per_dispatch``) for
        every pixel and fold them into the average, as one graph replay
        where ``graphed``.  Nothing here waits for the device (but the
        capture at the first step of k samples)."""
        k = self.samples_per_dispatch if k is None else k
        if self.graphed:
            with torch.cuda.device(self.device):
                self.graph(k).replay()
            self._last_k = k
        else:
            for _ in range(k):
                self._sample()
        self.frame_index += k

    def _sample(self) -> None:
        """One sample folded into the state in place: what a graph holds."""
        sample, stats = render_sample(self.data, self.spec, self.cfg,
                                      self.offsets, self.frame, self.tracer,
                                      baked_tables=self.baked)
        self.accum.copy_(accumulate(self.accum, sample, self.frame))
        self.ray_totals.add_(torch.stack(
            [stats["closest_rays"], stats["shadow_rays"]]).float())
        self.frame.add_(1)

    def graph(self, k: int) -> "torch.cuda.CUDAGraph":
        """The CUDA graph of ``k`` samples, captured at its first use
        (capturing runs nothing on the card).  Before the first capture
        into a pool, one eager sample on scratch state warms up on a side
        stream (PyTorch's whole-network recipe): it builds and loads the
        kernels, whose launches then hold no first-use work.  It ends with
        a fence, so its device time stays in its own span (the capture
        would wait for it anyway)."""
        if k in self.graphs:
            return self.graphs[k]
        with torch.cuda.device(self.device):
            if self._pool is None:
                with named_scope("warm-up sample"):
                    side = torch.cuda.Stream()
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        sample, _ = render_sample(
                            self.data, self.spec, self.cfg, self.offsets,
                            self.frame, self.tracer, baked_tables=self.baked)
                        accumulate(self.accum, sample, self.frame)
                    torch.cuda.current_stream().wait_stream(side)
                    torch.cuda.synchronize(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            marks = profiling.LayerMarks() if self.marked else None
            with (named_scope("graph capture"),
                  torch.cuda.graph(graph, pool=self._pool),
                  profiling.marking(marks)):
                for i in range(k):
                    if marks is not None:
                        marks.sample, marks.bounce = i, 0
                    self._sample()
        self.graphs[k] = graph
        if marks is not None:
            self.graph_marks[k] = marks
        return graph

    def drop_graphs(self) -> None:
        """Forget the captured graphs (and their marks): the next step of
        each k captures anew (after a warm-up sample), with the kernels and
        tables bound then."""
        self.graphs, self._pool, self.graph_marks = {}, None, {}

    def set_marks(self, on: bool = True) -> None:
        """Capture the graphs from now on with layer marks (``on``) or
        without: the graphs captured before are dropped where this changes
        anything.  Without marks a graph holds the samples' kernels alone;
        with them it also holds an event-record node at the entry and the
        exit of every layer scope.  Only a ``graphed`` renderer captures
        graphs: elsewhere turning them on raises ``ValueError``."""
        if on and not self.graphed:
            raise ValueError("layer marks live in captured CUDA graphs; "
                             "this renderer runs its samples eagerly")
        if on != self.marked:
            self.marked = on
            self.drop_graphs()

    def layer_ms(self) -> Dict[str, float]:
        """Device ms a sample of each layer in the last replay, from its
        graph's marks: each stretch between two marks goes to the
        innermost layer scope open there, bubbles included, and
        ``"unmarked"`` holds what no layer scope covers.  What a viewer
        would print after a step.  Waits for the device to finish that
        replay.  Raises ``RuntimeError`` where the last step replayed no
        marked graph."""
        marks = self.graph_marks.get(self._last_k)
        if marks is None:
            raise RuntimeError("no marked replay to read: set_marks(True), "
                               "then step()")
        return marks.layer_ms()

    def refine(self, stride: int = 64) -> bool:
        """Rebuild the clusters to this render's measured rays, then go on
        progressively (``Renderer.refine`` of the JAX package).

        Renders one extra sample with ``RenderConfig.export_rays=stride``,
        not folded into the average, to take every ``stride``-th bounce ray
        and shadow segment the frame traces, and rebuilds with the
        ``sah_rays`` builder, which scores splits by those rays' slab hits.
        The image is the same (clustering only moves work).  The
        fingerprint is pinned first, so checkpoints written after a refine
        load in unrefined renderers of either package.  Returns False when
        the sample holds no live ray (nothing is rebuilt)."""
        ecfg = dataclasses.replace(self.cfg, export_rays=stride)
        _, stats = render_sample(self.data, self.spec, ecfg, self.offsets,
                                 self.frame_index, self.tracer,
                                 baked_tables=self.baked)
        rows = [v.cpu().numpy() for k, v in sorted(stats.items())
                if k.startswith(("rays_b", "srays_b"))]
        if not rows:
            return False
        rays = np.concatenate(rows, axis=0)
        if not (rays[:, 7] > 0).any():
            return False
        self.fingerprint()  # pin the identity the checkpoints carry
        self.data, self.spec = self.scene.build(
            cluster_size=self.cfg.cluster_size, builder="sah_rays",
            presplit=self.cfg.bvh_presplit, builder_alpha=self.cfg.bvh_alpha,
            rays=rays, device=self.device)
        self.baked = bake_tables(self.data, self.spec, self.cfg, self.tracer)
        self.drop_graphs()  # they read the old tables
        return True

    @property
    def total_closest_rays(self) -> int:
        """Total closest-hit rays traced (waits for the device)."""
        return int(self.ray_totals[0])

    @property
    def total_shadow_rays(self) -> int:
        """Total shadow rays traced (waits for the device)."""
        return int(self.ray_totals[1])

    def render(self, spp: Optional[int] = None) -> np.ndarray:
        """Render ``spp`` more samples (default cfg.spp); returns the
        (H, W, 3) float32 average.  Steps in ``samples_per_dispatch``
        batches with an exact remainder step, so ``total_samples``
        advances by exactly ``spp``."""
        spp = self.cfg.spp if spp is None else spp
        target = self.total_samples + spp
        while self.total_samples < target:
            self.step(min(self.samples_per_dispatch,
                          target - self.total_samples))
        return self.image

    @property
    def image(self) -> np.ndarray:
        """A copy of the average (the state itself changes in place)."""
        return self.accum.to("cpu", copy=True).numpy()

    # -- checkpoint / resume -------------------------------------------------
    def fingerprint(self) -> str:
        """Scene + config identity baked into checkpoints (the JAX
        package's string, so checkpoints load across the two packages).
        The tracer is not part of it: the tracers give the same image.
        Pinned at first use, as in the JAX package: :meth:`refine` changes
        the clusters, not the image."""
        if getattr(self, "_fingerprint", None) is None:
            s = (f"{self.spec.bvh}|L{self.spec.light_count}"
                 f"|M{self.spec.material_count}|E{int(self.spec.has_env_map)}"
                 f"|{self.cfg.width}x{self.cfg.height}"
                 f"|b{self.cfg.max_bounces}|seed{self.cfg.seed}")
            self._fingerprint = hashlib.sha1(s.encode()).hexdigest()[:16]
        return self._fingerprint

    @property
    def total_samples(self) -> int:
        """Samples folded into ``accum`` so far: the checkpoints' portable
        unit of progress.  ``parallel.ShardedRenderer`` overrides this and
        :meth:`_set_total_samples`."""
        return self.frame_index

    def _set_total_samples(self, total: int) -> None:
        self.frame_index = int(total)
        self.frame.fill_(self.frame_index)

    def state_dict(self) -> dict:
        return {
            "accum": self.image,
            "total_samples": self.total_samples,
            "seed": self.cfg.seed,
            "fingerprint": self.fingerprint(),
            "total_closest_rays": self.total_closest_rays,
            "total_shadow_rays": self.total_shadow_rays,
        }

    def load_state(self, state: dict) -> None:
        if int(state["seed"]) != self.cfg.seed:
            raise ValueError("checkpoint seed does not match config seed")
        if "fingerprint" in state:
            fp = state["fingerprint"]
            got = str(np.asarray(fp).item() if hasattr(fp, "item") else fp)
            if got != self.fingerprint():
                raise ValueError(
                    "checkpoint scene/config fingerprint does not match: "
                    f"checkpoint {got}, this renderer {self.fingerprint()}")
        total = int(state["total_samples"] if "total_samples" in state
                    else state["frame_index"])
        self.accum.copy_(torch.as_tensor(np.asarray(state["accum"],
                                                    np.float32)))
        self._set_total_samples(total)
        self.ray_totals.copy_(torch.tensor(
            [float(state.get("total_closest_rays", 0)),
             float(state.get("total_shadow_rays", 0))]))

    @staticmethod
    def checkpoint_path(path: str) -> str:
        """``np.savez`` appends ``.npz`` when absent; both save and load
        normalize so ``--checkpoint ckpt`` round-trips."""
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        np.savez(self.checkpoint_path(path), **self.state_dict())

    def load(self, path: str) -> None:
        with np.load(self.checkpoint_path(path)) as f:
            self.load_state({k: f[k] for k in f.files})
