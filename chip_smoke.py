#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, and the build of every CUDA source in ``csrc/`` with nvcc
   (registers and spills from ``-Xptxas -v``);
2. K1/K2 (the flat kernels) against their plain PyTorch versions on the
   card, on coatball 1024x768's primary and bounce-1 passes, with both times
   and each pass's bound (the least time the card could take); then against
   the plain versions that walk (``closest_flat_walk_ref``,
   ``any_flat_walk_ref``) on every ray of the primary, bounce-1 and bounce-2
   passes, with the visits a ray makes, the group-size shares and the bound
   of the walk's own work, each ms beside the one-thread-per-ray kernels'
   recorded ms; and K3/K4 forced onto the same rays (``flat=False``)
   against K1/K2, both timed;
3. the coatball main path: ``Renderer(coatball 1024x768, RenderConfig())`` on
   ``device="cuda"``: 1 warm-up and 4 timed samples, the image checked, the
   launch counts read, then 2 samples under ``torch.profiler`` (device time
   by kernel, and the device's busy share of the unprofiled wall time);
4. a coatball cross-check at 128x96: the kernels' image against the plain
   versions';
5. K3/K4 (the hierarchical kernels) against their plain versions on dragon
   1024x1024's primary and bounce-1 passes, on every 16th ray (the plain
   versions are brute force over 132k triangle slots); the kernels are timed
   on the full passes;
6. K5 (the broad phase) in four modes against its plain version on dragon's
   primary and shadow rays: cluster keys, cluster keys with the second
   nearest, the global seed key, the global occlusion flag; each mode's
   kernel ms by CUDA events beside its device ms from the profiler (ten
   host calls between two events also time the wrapper's Python) and the
   one-thread-per-ray kernel's recorded ms; then every mode again on the
   first 1,000,003 rays (a ragged count that fills no block);
7. the dragon main path: ``Renderer(dragon 1024x1024, RenderConfig())``,
   then with ``fused_broadphase=True``: as phase 3 for each, with the launch
   counts of K3/K4/K5; before it, each recorded pass's kernel ms beside its
   bound, and K3/K4 against the plain versions that walk
   (``closest_hier_ref``, ``any_hier_ref``) on every ray of the primary,
   bounce-1 and bounce-2 passes, with the visits a ray makes (mean, p50,
   p90, max), the share of visits served in groups of 1, 2-8 and 9-32 rays
   of a warp, and the bound of the work the walk really does;
8. a dragon cross-check at 128x128: the kernels' image against the plain
   versions';
9. K6 (the rank-directed closest walk) against its plain version and the
   plain version that walks as its warps do (``closest_rank_walk_ref``,
   bit for bit) on every ray of the sorted bounce-1 and bounce-2 passes of
   one dragon sample at ``compaction=True, rank_trace=2`` (the plain
   versions gather only each ray's candidate clusters, so no stride), with
   both times, the bound, the visits a ray makes and the share of visits
   served in groups of 1, 2-8 and 9-32 rays, each ms beside the
   one-thread-per-ray kernel's recorded ms;
10. K3 with a per-ray ``seed_base`` against its plain version on the rays
    K6's certificate leaves open, and K6 + certificate + seeded K3 against
    K3 alone on the whole passes; K3 and K4 timed on the sorted rays and on
    the same rays in random order, and held against the walking plain
    versions on every ray of the sorted and the seeded passes;
11. the exact broad phase's kernel (``nearest_cluster_kernel``, behind
    ``nearest_cluster`` / ``nearest_cluster_pair``) against its plain chain
    on the same card, bit for bit, in every form (ranks 1-3, packed,
    bounded, the super boxes, the pair with ranks 2 and 3) on the slice's
    bounce-1 rays and shadow segments, with its registers, each form's
    kernel ms by events and device ms from the profiler beside the plain
    chain's and its bound, and its ranks 1-2 against K5's keys;
12. the dragon main path in four configs inside one call, in turns, two
    rounds: ``compaction=False``, ``compaction=True``, ``compaction=True,
    rank_trace=2`` (through ``Renderer.render``), ``compaction=True,
    fused_broadphase=True``; launch counts per sample, each image against
    the first config's, and a profile of the third;
13. a dragon cross-check at 128x128 with ``compaction=True, rank_trace=2``;
    then dragon 1024x1024 at ``compaction=True`` and at ``rank_trace=2``
    through the graphed main path with the exact broad phase's kernel and
    with its plain chain forced: the images ``torch.equal``, ms/sample of
    each, and the kernel's launches a sample (2 in one direction, 1 pair);
14. the shading extensions on the scenes whose CLI turns one on (coatball
    specular, bunny_env the environment map, glass_sphere refraction,
    uv_test textures), through K1/K2, each scene at its own default size
    with the CLI's config: one sample's K1/K2 passes (refracted rays from
    inside the glass, Phong-lobe bounces) held bit for bit against the
    walking plain versions on every ray, that sample's image through the
    kernels equal to its image through the walking plain versions, and the
    image against the brute-force plain versions' (``tracer="torch"``);
    glass_sphere's ``compaction=True`` image against its
    ``compaction=False`` one; then each scene with the CLI's config and
    with the extensions off, in turns: ms/sample, launches of K1/K2 and of
    all kernels a sample, device ms/sample (profiler) and the device's idle
    share of the median and of the fastest round's wall;
15. the exact tracers (``tracer="bvh"``, the JAX package's own path off a
    TPU): ``closest_bvh_kernel`` and ``any_bvh_kernel`` (``csrc/
    trace_bvh.cu``, warp-cooperative, no Pallas counterpart: the jnp
    packet walk of ``metal_raytracing_tpu/ops/trace.py``), with no spill
    (on phase 1's ptxas lines), on dragon's and coatball's recorded primary and bounce-1
    passes: bit for bit (t, u, v and slot; the flags) against the plain
    versions that walk as they do (``closest_bvh_walk_ref``,
    ``any_bvh_walk_ref``) on every ray, against their plain packet
    versions and the brute force on every 16th ray and against K1-K4 on
    every ray (found masks and flags equal, t within rtol 1e-5, sources
    equal on >= 99.9% of live rays apart from ties with the global set,
    every mismatch a near-tie), each kernel's ms beside the
    one-thread-per-ray kernels' recorded ms and the cluster kernel's on the
    same pass, its bound, the walking plain version's ms and the plain
    packet walk's ms on the strided rays; then dragon 1024x1024 with
    ``tracer="cuda"``, ``tracer="bvh", compaction=True`` and
    ``tracer="bvh"`` in turns, two rounds of 3 samples (ms/sample, device
    ms/sample, each bvh image against the cuda image at the golden gate,
    the BVH kernels' launches), and a 128x128 cross-check: the kernels'
    image equal to the walking plain versions' and against the plain
    packet walk's;
16. the cluster builders and the traversal telemetry, on dragon 1024x1024
    and coatball 1024x768: every builder (``sah_free``, ``sah``,
    ``median``, ``morton``, ``sah_chunk``, ``ploc``, and ``sah_free`` with
    the pre-split at 0.3) with its build seconds, clusters, super layout
    and ``partial_clusters``; one sample's K1-K4 passes with
    ``count_visits`` and, where the build marks partial clusters, with and
    without ``counts``, bit-equal to the kernels without options on every
    ray and, with the visits, to the walking plain versions on every 16th
    (dragon) or 4th (coatball) ray, dragon's ``ploc`` build taking K3/K4
    on wide supers (S = 232); each build's image after 7 samples against
    ``sah_free``'s (RMSE < 1e-3, < 0.1% of pixels beyond 0.05); K6 on the
    sorted bounce passes of ``compaction=True, rank_trace=2``, on the
    ``sah_free`` build with visits and on the ``sah_chunk`` build (partly
    full clusters) with visits, without and with ``counts``: the key and
    base equal to K6 without options, and key, base and visits equal to
    the walking plain version's with the same counts on every ray; ``ploc`` under ``compaction=True`` against ``False`` (the sort
    keys' fallback above 4,095 padded clusters); ``Renderer.refine``
    between two pairs of samples against the unrefined render; the
    telemetry (``visit_percentiles``, ``wavefront_stats``) and a
    ``profiling.trace`` holding the renderer's scope names; every dragon
    build, and ``sah_chunk`` / ``ploc`` with ``chunk_skip``, in turns (two
    rounds of 3 samples: ms/sample, device ms/sample, idle share,
    launches);
17. K3's baked-origin primary pass (``RenderConfig.bake_primary``) on
    dragon 1024x1024: on the ``sah_chunk`` build (partly full clusters)
    and the default ``sah_free`` build, the baked K3 against its walking
    plain version (``closest_hier_ref(baked=True)``) on every ray of the
    primary pass, bit for bit with the visits, with ``counts`` off and (on
    ``sah_chunk``) on, and without options the same bits; against the
    unbaked K3 on the same rays, ids equal on >= 99.9% and every mismatch a
    near-tie or an edge hit (the baked barycentrics re-associate); the two
    passes timed in turns beside the baked bound; the main path with
    ``bake_primary=True`` (one baked launch a sample) and its image
    against config A's (RMSE < 1e-3, < 0.1% of pixels beyond 0.05);
18. ``parallel.ShardedRenderer`` on ``torch.distributed`` with several
    ranks sharing cuda:0: two and four gloo ranks (NCCL refuses two ranks
    on one card) in spp, tile and 2-D meshes, each image against the plain
    ``Renderer``'s (RMSE < 1e-5), and NCCL at world size 1; ms a step and
    aggregate samples/s of one process, the whole mesh and two of its ranks
    in turns, and one image ``all_reduce`` alone;
19. the sort key on dragon 1024x1024 at ``compaction=True``, plain and
    with ``sort_pack_f16``: each image against config A's (RMSE < 1e-6;
    ``sort_pack_f16``, which rounds to f16, at the golden gate), with its
    ms/sample and profiled device ms/sample;
20. ``samples_per_dispatch`` as CUDA graphs: dragon 1024x1024 A,
    ``bake_primary``, D and ``tracer="bvh"``, coatball 1024x768 and
    plane_sphere 256x256 (and, untimed, plane_sphere 64x64 with
    ``tracer="bruteforce"``), each renderer (which steps its batch as one graph
    replay) against an eager twin over the same build: one eager sample
    under ``torch.cuda.set_sync_debug_mode("error")``, the capture's
    launch counts against an eager sample's, ms/sample in turns, device
    ms/sample (the graph's read twice around the eager one, and by
    back-to-back graph turns), kernels and host launch calls a sample,
    capture seconds and pool bytes, and the two images equal bit for bit; graph batches of 1,
    2 and 4 in turns on dragon A and coatball; ``refine`` between two
    batches, a checkpoint resumed in a fresh renderer, and the CLI's
    ``render --spp 6 --save-every 4`` checkpointing at samples 4 and 6;
21. the native OBJ parser (``io/native.py``: ``native/objparse.cpp`` built
    with the host's C++ compiler): its build seconds and the compiler's
    version line; each model of the dragon scene written to an OBJ file
    (``io.obj.write_obj``) and parsed natively and in Python in turns,
    the two models equal; the dragon scene 1024x1024 loaded from the
    procedural stand-ins and from the files natively and in Python
    (``MRT_RESOURCES``, ``MRT_NO_NATIVE``), two rounds in turns (load and
    renderer build seconds); each scene rendered through the graphed main
    path, the three images equal bit for bit.

The renderers replay CUDA graphs, so the kernel wrappers' launch counts
count a graph's launches once, when it is captured, and a replay's not at
all.  A run's counts (each phase resets them before its run: the warm-up
render, which captures the graphs the timed renders replay, and the timed
renders) are the wrapper calls of its warm-up sample and captures, and
each main path checks them against one eager sample of the renderer's
config (``sample_launches``): (1 + the samples its graphs captured) times
that sample's counts (``graphed_run``), so a kernel missing from a graph
fails the phase; the profiled replay of a timed graph must run each
kernel as often a sample as the eager sample (``checked_profile``).  The
kernels line's ``launches_of`` says what each row's ``launches`` hold.

A bound is the larger of the pass's bytes (rays in, results out, plane
tables once) over 3.35 TB/s, the H100 SXM's published HBM rate, and its
FP32 work over the card's own FP32 rates.  The card issues at most 128
FP32 lanes an SM a clock: times the SMs
(``torch.cuda.get_device_properties``) and the maximum SM clock
(``nvidia-smi --query-gpu=clocks.max.sm``), 33.5e12 instructions a second
on an H100 SXM at 1,980 MHz.  A fused multiply-add does a multiply and an
add in one such instruction, so the multiplies, adds and subtracts are
charged at twice that rate, the FMA peak (the data sheet's 67 TFLOP/s),
and the min/max, compares, clamp and division, which do not fuse, at the
issue rate.  The kernels are built with ``-fmad=false`` to stay bit-equal
to the plain versions, but the function does not need that, and the bound
is the function's.  A slab test is 12 multiply/add flops and 15 other
operations, a plane test 34 and 5: 21 and 22 issue slots (``SLAB_OPS``,
``PLANE_OPS``).  The division counts one slot though its reciprocal runs
on a slower pipe, so the bound stays a lower bound.  The operations count only the work the pass's
rays need, from the plain versions' results where they ran on the whole
pass (coatball, K5, and dragon's primary passes, where the plain versions
are timed) and from the kernels' results where they did not (dragon's
bounce passes, which the plain versions matched on every 16th ray):
for a closest ray, every cluster whose slab entry lies below its final hit
t (for K6: each candidate cluster that survives the cull of its walk),
dense-tested at 39 operations per triangle slot (``tri_hit`` in
``csrc/trace_common.cuh``), plus 27 operations per slab test (the boxes a
walk must test to find those clusters); for an unoccluded shadow ray every
cluster its segment overlaps, for an occluded one a single triangle.  The
BVH kernels' bounds count the same way over their own tests
(``bvh_work``): the global set, ``B`` slab tests of 20 issue slots
(``ray_aabb``) for every node a ray must open (the root, and each inner
node it enters below its final t or within its segment), and
``cluster_size`` Moller-Trumbore tests of 30 (``moller_trumbore``: 45
multiplies and adds, a division, an abs and six compares) for each leaf
it enters so; a single triangle for an occluded shadow ray.

It prints one JSON line of per-kernel results (K5 twice: its closest
global mode with the launches of ``fused_broadphase=True`` at
``compaction=False``, and its cluster-key mode with those of phase 12's
``compaction=True, fused_broadphase=True``; the two BVH kernels with
phase 15's bvh launches, ``pallas_counterpart`` null and ``plain_ms`` of
the plain packet walk on the ``plain_rays`` strided rays; K3/K4 on wide
supers with phase 16's ploc launches, ``plain_ms`` of the walking plain
version on its ``plain_rays``, and a bound whose operations are counted on
two samples of every 61st ray, scaled to all rays; K1-K4 and K6 with
``options_ms``, each option set's ms (``off``, ``visits``, and on the
``sah_chunk`` build also ``visits+counts``) on phase 16's sah_free and
sah_chunk primary passes (K6: their sorted bounce 1)); last the baked K3
(``closest_hier_kernel baked``) with phase 17's main-path launches, its
ms and the unbaked K3's in turns, ``plain_ms`` of the walking plain
version (``plain_kind``), and the bound with the origin terms taken out
(``SLAB_OPS_BAKED``, ``PLANE_OPS_BAKED``, no ray origins read); and last
the line
``{"ok": true, "device": {...}}``.  Without CUDA it exits with an error and
renders nothing (there is no CPU fallback).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

COATBALL = (1024, 768)
DRAGON = (1024, 1024)
TIMED_SAMPLES = 4
CHECK_STRIDE = 16
# Section-4 tolerances of the port's tests: ids (occlusion flags) equal on
# >= 99.9% of live rays, and every closest-hit mismatch a near-tie whose two
# winners' exact t agree within 2^-13 relative.  Broad-phase keys: equal on
# >= 99.9%, any other within one chop step of the entry t.
MIN_MATCH = 0.999
NEAR_TIE_REL = 2.0 ** -13
IMAGE_RMSE = 1e-3
# Compaction permutes the rays and takes exact shortcuts: its image equals
# the compaction=False image up to the order of float32 sums (none here).
SAME_IMAGE_RMSE = 1e-6
SLICE = dict(compaction=True, rank_trace=2)
ROUNDS = 2
ROUND_SAMPLES = 3
# The scenes whose CLI config turns a shading extension on, each at its own
# default size (the scene constructors' defaults).
EXTENSION_SCENES = (("coatball", COATBALL), ("bunny_env", (512, 512)),
                    ("glass_sphere", (512, 512)), ("uv_test", (256, 256)))
EXTENSION_ROUNDS = 4
# H100 SXM HBM bytes/s (NVIDIA's data sheet); the FP32 issue rate is the
# card's own, from fp32_issue_rate() (see the docstring).
HBM_BYTES_PER_S = 3.35e12
FP32_LANES_PER_SM = 128
# FP32 issue slots of one test: a multiply/add flop takes half a slot (two
# fuse into one FMA), any other operation a whole one.
SLAB_OPS = 12 // 2 + 15  # slab(): 6 sub, 6 mul; 10 min/max, clamp, 4 cmp
PLANE_OPS = 34 // 2 + 5  # plane_hit(): 34 mul/add/sub (3 in the Newton
#                          step); 1 div, 4 compares
# The baked-origin forms (K3's primary pass under bake_primary) drop the
# origin terms: the slab's 6 subtractions, the plane test's n.o (5), its
# n.v0 - n.o (1) and the hit point (6), and take the direction dots in
# place of the point dots (U.d, V.d: the same 10 and 2 more multiplies).
SLAB_OPS_BAKED = 6 // 2 + 15  # 6 mul; 10 min/max, clamp, 4 cmp
PLANE_OPS_BAKED = 24 // 2 + 5  # 24 mul/add/sub; 1 div, 4 compares
# The same for the exact BVH walk's tests (ops/intersect.py):
BVH_SLAB_OPS = 12 // 2 + 14  # ray_aabb: 6 sub, 6 mul; 10 min/max, 4 compares
MT_OPS = 45 // 2 + 8  # moller_trumbore: 45 mul/add/sub; div, abs, 6 compares
CSRC = "metal_raytracing_tpu_torch/csrc/"
PALLAS = "metal_raytracing_tpu/ops/trace_pallas.py"
# The jnp packet walk that the BVH kernels take to the card (no Pallas
# kernel): _packet_closest and _packet_any.
TRACE_PY = "metal_raytracing_tpu/ops/trace.py"
BVH_CONFIGS = (  # phase 15's dragon configs, in turns: (label, keywords)
    ("cuda compaction=False", dict(tracer="cuda")),
    ("bvh compaction=True", dict(tracer="bvh", compaction=True)),
    ("bvh compaction=False", dict(tracer="bvh")),
)
GOLDEN_MAX = 5e-2  # the golden gate's max pixel difference
# Distance from an edge, relative to |o| + t, within which the exact
# tracers' hit test and K1-K4's may disagree on a hit: 16 float32 ulps
# (both tests round a point that sits that close to the edge).
EDGE_REL = 2.0 ** -20
LIBRARY = None  # no PyTorch call computes a packed-key BVH walk
WARP = 32
# Kernel ms of the one-thread-per-ray kernels that the warp-cooperative ones
# replaced, on the same passes (NVIDIA H100 80GB HBM3, 700 W), printed
# beside this run's: primary / bounce 1 / bounce 2 at the default config
# (K1/K2 on coatball 1024x768, K2 testing 128 global slots; K3/K4 on dragon
# 1024x1024), then the sorted bounce passes and K3 seeded on the
# uncertified rays; K6 on the sorted bounce passes; K5 in the four modes of
# broadphase_cuda.BROADPHASE_MODES, one ray a thread.
ONE_THREAD_MS = {"K1": (0.855, 2.441, 2.215), "K2": (1.466, 2.477, 1.730),
                 "K3": (4.983, 10.616, 7.696), "K4": (4.351, 6.405, 4.784),
                 "K3 sorted": (6.059, 3.800), "K4 sorted": (2.340, 1.900),
                 "K3 seeded": (5.371, 3.140), "K6": (1.353, 0.662),
                 "K5": (0.667, 0.673, 0.040, 0.042),
                 # the exact tracers' kernels before their redesign
                 # (variant_bench.py --bvh): dragon primary / bounce 1,
                 # coatball primary / bounce 1
                 "BVH closest": (2.723, 8.015, 0.981, 3.019),
                 "BVH any": (4.080, 5.482, 1.395, 2.259)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@functools.cache
def fp32_issue_rate():
    """(FP32 instructions a second, SMs, maximum SM clock in MHz) of card
    0: every SM issues at most 128 FP32 lanes a clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(out.stdout.split()[0])
    return sms * FP32_LANES_PER_SM * mhz * 1e6, sms, mhz


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_call(fn):
    """(milliseconds, result) of one call of ``fn()`` on the card, by CUDA
    events, with no warm-up (for the brute-force plain versions, which take
    seconds)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def bound(nbytes: int, ops: int):
    """(bound ms, what binds) of a pass: bytes over the HBM rate or FP32
    issue slots over the card's issue rate, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / fp32_issue_rate()[0] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live_chunks(mask, width: int):
    """Index chunks of the live rays, sized for (chunk, width, 3) slabs."""
    live = mask.nonzero()[:, 0]
    step = max(1, (1 << 22) // max(width, 1))
    for s in range(0, live.shape[0], step):
        yield live[s:s + step]


def trace_work(o, d, mask, data, spec, hier, t_final=None, max_t=None,
               occ=None, baked=False):
    """(bytes, operations) a closest (``t_final``: each ray's final chopped
    hit t) or shadow (``max_t``, ``occ``) pass needs; see the docstring.
    ``baked``: the closest pass's baked-origin form, its tests without the
    origin terms and its rays without their origins."""
    from metal_raytracing_tpu_torch.ops.broadphase_cuda import slab_entry

    bvh = spec.bvh
    ns, s_per = data.clu_planes.shape[0], data.clu_planes.shape[1]
    boxes = data.clu_planes.reshape(-1, 6)
    sup = data.sup_planes[:ns]
    n = o.shape[0]
    table = data.tri_planes[:, :bvh.num_clusters * bvh.cluster_size]
    nbytes = table.numel() * 4 + boxes.numel() * 4 + (sup.numel() * 4 if hier
                                                      else 0)
    if t_final is not None:  # rays + seed, t + tri
        nbytes += n * ((0 if baked else 12) + 12 + 1 + 4) + n * (4 + 4)
    else:
        nbytes += n * (12 + 12 + 4 + 1) + n * 1  # rays + max_t, flag
    slabs = planes = 0
    walking = mask if occ is None else mask & ~occ
    for r in _live_chunks(walking, boxes.shape[0]):
        tn, hit = slab_entry(o[r], d[r], boxes,
                             None if max_t is None else max_t[r])
        if t_final is not None:
            hit &= tn < t_final[r, None]
        planes += int(hit.sum()) * bvh.cluster_size
        if hier:
            tn_s, hit_s = slab_entry(o[r], d[r], sup,
                                     None if max_t is None else max_t[r])
            if t_final is not None:
                hit_s &= tn_s < t_final[r, None]
            slabs += r.shape[0] * ns + int(hit_s.sum()) * s_per
        else:
            slabs += r.shape[0] * boxes.shape[0]
    if occ is not None:  # one triangle for each occluded ray, and the
        planes += int((mask & occ).sum())  # global set for the others
        planes += int((mask & ~occ).sum()) * bvh.num_global
    if baked:
        return nbytes, slabs * SLAB_OPS_BAKED + planes * PLANE_OPS_BAKED
    return nbytes, slabs * SLAB_OPS + planes * PLANE_OPS


def broadphase_work(n, n_live, ncp, n_global, with_clusters, want2,
                    any_mode):
    """(bytes, operations) of one broad-phase pass."""
    outs = int(with_clusters) + int(with_clusters and want2) + int(
        n_global > 0)
    nbytes = n * (12 + 12 + 1 + (4 if any_mode else 0)) + n * 4 * outs
    nbytes += (ncp * 24 if with_clusters else 0) + 48 * n_global
    ops = n_live * ((ncp * SLAB_OPS if with_clusters else 0)
                    + n_global * PLANE_OPS)
    return nbytes, ops


def record_passes(renderer):
    """Render one sample through the kernels, recording the rays of every
    closest and any-hit pass (these recording launches are not the main
    path's; the counts are reset before it)."""
    import torch

    from metal_raytracing_tpu_torch import renderer as R

    closest, any_hit = R.make_tracers(renderer.data, renderer.spec, "cuda",
                                      baked=renderer.baked)
    calls = {"closest": [], "any": [], "baked": []}

    rank = R.make_closest_rank(renderer.data, renderer.spec, renderer.cfg,
                               "cuda", closest)
    calls["rank"] = []

    def rec_closest(o, d, m, seed, seed_base=None, baked=False):
        calls["closest"].append((o.contiguous(), d.clone(), m.clone(),
                                 None if seed is None else seed.clone()))
        calls["baked"].append(baked)  # this pass ran on the baked tables
        return closest(o, d, m, seed, seed_base, baked=baked)

    def rec_rank(o, d, m, rank_keys, seed):
        calls["rank"].append((o.contiguous(), d.contiguous(), m.clone(),
                              tuple(rank_keys), seed))
        return rank(o, d, m, rank_keys, seed)

    def rec_any(o, d, mt, m):
        calls["any"].append((o.clone(), d.clone(), mt.clone(), m.clone()))
        return any_hit(o, d, mt, m)

    calls["image"], _ = R.render_sample(
        renderer.data, renderer.spec, renderer.cfg, renderer.offsets, 0,
        tracers=(rec_closest, rec_any, rank and rec_rank),
        baked_tables=renderer.baked)
    torch.cuda.synchronize()
    return calls


def _strided(args, stride):
    return tuple(None if a is None else a[::stride].contiguous()
                 for a in args)


def near_ties(o, d, m, tri, ref_tri, planes):
    """(ids-equal share of live rays, mismatches, worst exact-t relative
    difference of a mismatch's two winners)."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    n_live = int(m.sum())
    same = (tri == ref_tri) & m
    bad = m & ~same
    worst = 0.0
    if bool(bad.any()):
        ia, ib = tri[bad], ref_tri[bad]
        assert bool((ia >= 0).all() and (ib >= 0).all()), (
            "a hit/miss disagreement is not a near-tie")
        ta, _, _ = TC.recompute_tuv(o[bad], d[bad], planes[:, ia.long()].T)
        tb, _, _ = TC.recompute_tuv(o[bad], d[bad], planes[:, ib.long()].T)
        worst = float(((ta - tb).abs() / tb.abs()).max())
    return int(same.sum()) / max(n_live, 1), int(bad.sum()), worst


def check_closest(name, args, data, spec, stride=1, time_plain=True):
    """K1 or K3 (as the scene's size picks) against the plain version on
    every ``stride``-th ray; kernel time on all rays, and with
    ``time_plain`` the plain version's time on all rays, whose results give
    the work the bound counts (else the kernel's results do).  Returns a
    result dict."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    o, d, m, seed = args
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    hier = not TC._use_flat(spec.bvh)
    hit = TC.trace_closest(o, d, m, *tabs, seed)
    so, sd, sm, sseed = _strided(args, stride)
    sub = TC.trace_closest(so, sd, sm, *tabs, sseed)
    plain_ms, (t_ref, tri_ref) = cuda_call(lambda: TC.closest_flat_ref(
        so, sd, sm, data.tri_planes, spec.bvh, sseed))
    match, n_bad, worst = near_ties(so, sd, sm, sub.tri, tri_ref,
                                    data.tri_planes)
    both = sm & (sub.tri == tri_ref) & (tri_ref >= 0)
    err = float((sub.t - t_ref)[both].abs().max()) if bool(both.any()) else 0.0
    ms = cuda_ms(lambda: TC.trace_closest(o, d, m, *tabs, seed), 10)
    # the work these rays need: from the plain version's final t where it
    # ran on every ray, else the kernel's (which it matched above)
    t_final = t_ref
    if stride > 1 and time_plain:
        plain_ms, (t_final, _) = cuda_call(lambda: TC.closest_flat_ref(
            o, d, m, data.tri_planes, spec.bvh, seed))
    elif stride > 1:
        plain_ms, t_final = None, hit.t
    bnd = bound(*trace_work(o, d, m, data, spec, hier, t_final=t_final))
    plain_txt = "not timed" if plain_ms is None else f"{plain_ms:.3f} ms"
    log(f"  {name}: {int(m.sum())} live rays; checked every {stride}: "
        f"{int(sm.sum())} live, ids equal {match:.6f}, {n_bad} near-ties "
        f"(worst exact-t rel {worst:.3e}), max |t - t_plain| {err:.3e}; "
        f"kernel {ms:.3f} ms (all rays), plain {plain_txt}, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]})")
    assert match >= MIN_MATCH, f"{name}: ids equal on only {match:.6f}"
    assert worst <= NEAR_TIE_REL, f"{name}: mismatch is not a near-tie"
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bnd}


def check_any(name, args, data, spec, stride=1, time_plain=True):
    """K2 or K4 against the plain version, as :func:`check_closest`."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    o, d, mt, m = args
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    hier = not TC._use_flat(spec.bvh)
    occ = TC.trace_any(o, d, mt, m, *tabs)
    so, sd, smt, sm = _strided(args, stride)
    sub = TC.trace_any(so, sd, smt, sm, *tabs)
    plain_ms, ref = cuda_call(lambda: TC.any_flat_ref(
        so, sd, smt, sm, data.tri_planes, spec.bvh))
    n_live = int(sm.sum())
    match = 1.0 - int(((sub != ref) & sm).sum()) / max(n_live, 1)
    err = float((sub.int() - ref.int()).abs().max()) if len(sub) else 0.0
    ms = cuda_ms(lambda: TC.trace_any(o, d, mt, m, *tabs), 10)
    occ_final = ref
    if stride > 1 and time_plain:
        plain_ms, occ_final = cuda_call(lambda: TC.any_flat_ref(
            o, d, mt, m, data.tri_planes, spec.bvh))
    elif stride > 1:
        plain_ms, occ_final = None, occ
    bnd = bound(*trace_work(o, d, m, data, spec, hier, max_t=mt,
                            occ=occ_final))
    plain_txt = "not timed" if plain_ms is None else f"{plain_ms:.3f} ms"
    log(f"  {name}: {int(m.sum())} live rays, occluded "
        f"{int((occ & m).sum())}; checked every {stride}: {n_live} live, "
        f"flags equal {match:.6f}; kernel {ms:.3f} ms (all rays), plain "
        f"{plain_txt}, bound {bnd[0]:.4f} ms ({bnd[1]})")
    assert match >= MIN_MATCH, f"{name}: flags equal on only {match:.6f}"
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bnd}


def compare_walks(name, calls, data, spec, before):
    """K3/K4 forced onto a flat scene (``flat=False``) against K1/K2 on
    every recorded pass: the two walks must agree as a kernel and its plain
    version do.  Prints each kernel's ms beside ``before`` (the
    one-thread-per-ray K1/K2's)."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    for b in range(len(calls["closest"])):
        o, d, m, seed = calls["closest"][b]
        closest = {f: (lambda f=f: TC.trace_closest(o, d, m, *tabs, seed,
                                                    flat=f))
                   for f in (True, False)}
        o2, d2, mt, m2 = calls["any"][b]
        any_ = {f: (lambda f=f: TC.trace_any(o2, d2, mt, m2, *tabs, flat=f))
                for f in (True, False)}
        flat, hier = closest[True](), closest[False]()
        aflat, ahier = any_[True](), any_[False]()
        torch.cuda.synchronize()
        match, n_bad, worst = near_ties(o, d, m, hier.tri, flat.tri,
                                        data.tri_planes)
        amatch = 1.0 - int(((aflat != ahier) & m2).sum()) / max(
            int(m2.sum()), 1)
        ms = {k: cuda_ms(fn, 10) for k, fn in (
            ("K1", closest[True]), ("K3", closest[False]),
            ("K2", any_[True]), ("K4", any_[False]))}
        log(f"  {name} bounce {b}: K3 vs K1 ids equal {match:.6f} "
            f"({n_bad} near-ties, worst {worst:.3e}); K4 vs K2 flags equal "
            f"{amatch:.6f}; K1 {ms['K1']:.3f} ms (one thread per ray: "
            f"{before['K1'][b]:.3f}), K3 {ms['K3']:.3f}; K2 {ms['K2']:.3f} ms "
            f"(one thread per ray: {before['K2'][b]:.3f}), K4 "
            f"{ms['K4']:.3f}")
        assert match >= MIN_MATCH and worst <= NEAR_TIE_REL, name
        assert amatch >= MIN_MATCH, name


def group_sizes(rounds, ncp):
    """The rays of each group a warp served: per round, the rays of one
    32-ray warp that asked for the same cluster."""
    import torch

    out = []
    for req in rounds:
        r = (req >= 0).nonzero()[:, 0]
        keys = torch.sort((r // WARP) * ncp + req[r]).values
        out.append(torch.unique_consecutive(keys, return_counts=True)[1])
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.long)


def visit_stats(visits, mask, sizes, n_rounds):
    """Text of the visits a live ray makes and of how the warps' requests
    group: the share of visits served in a group of 1, 2-8 or 9-32 rays
    that asked for the same cluster in the same round (``sizes``, one
    entry a group)."""
    import torch

    v = visits[mask].float()
    if not v.numel():
        return "no live rays"
    q = torch.quantile(v, torch.tensor([0.5, 0.9], device=v.device))
    total = max(int(sizes.sum()), 1)
    shares = [int(sizes[(sizes >= lo) & (sizes <= hi)].sum()) / total
              for lo, hi in ((1, 1), (2, 8), (9, WARP))]
    return (f"visits a live ray mean {float(v.mean()):.3f}, p50 "
            f"{float(q[0]):.0f}, p90 {float(q[1]):.0f}, max "
            f"{int(v.max())}, {n_rounds} rounds; visits in groups of 1 / "
            f"2-8 / 9-32 rays: " + " / ".join(f"{x:.3f}" for x in shares))


def walk_bound(visits, n, n_live, data, spec, closest):
    """Bound of the work the walk does for these rays; bytes as
    :func:`trace_work`.  Two levels: every live ray one pick over the
    supers, every visit one pick over its super's clusters and one dense
    test of a cluster.  One level (the flat kernels): every live ray one
    pick over all ``ncp`` cluster boxes more than it makes visits (the last
    pick finds none), every visit one dense test, and for a shadow ray the
    global set's real slots."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    bvh = spec.bvh
    ns, s_per = data.clu_planes.shape[0], data.clu_planes.shape[1]
    n_visits = int(visits.sum())
    nbytes = 4 * (bvh.num_clusters * bvh.cluster_size * 12 + ns * (1 + s_per)
                  * 6) + n * (37 if closest else 30)
    if TC._use_flat(bvh):
        ncp = ns * s_per
        ops = ((n_live + n_visits) * ncp * SLAB_OPS
               + n_visits * bvh.cluster_size * PLANE_OPS
               + (0 if closest else n_live * bvh.num_global * PLANE_OPS))
    else:
        ops = (n_live * ns * SLAB_OPS + n_visits * (
            s_per * SLAB_OPS + bvh.cluster_size * PLANE_OPS))
    return bound(nbytes, ops)


def walk_tracers(data, spec):
    """``make_tracers``' (closest, any_hit) pair on the plain versions that
    walk as the scene's kernels do."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.ops.intersect import Hit

    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)

    def closest(o, d, m, seed, seed_base=None):
        t, tri, _ = TC.closest_walk_ref(o, d, m, *tabs, seed, seed_base)
        z = torch.zeros_like(t)
        return Hit(t=t, u=z, v=z, tri=tri)

    def any_hit(o, d, mt, m):
        return TC.any_walk_ref(o, d, mt, m, *tabs)[0]

    return closest, any_hit


def _was(before) -> str:
    """The one-thread-per-ray kernel's recorded ms, for a log line."""
    return "" if before is None else f" (one thread per ray: {before:.3f} ms)"


def check_walk_closest(name, args, data, spec, seed_base=None, before=None):
    """K1 or K3 against the plain version that walks, on every ray."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    o, d, m, seed = args
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    ncp = data.clu_planes.shape[0] * data.clu_planes.shape[1]
    run = lambda: TC.trace_closest(o, d, m, *tabs, seed, seed_base=seed_base)
    hit = run()
    rounds = []
    plain_ms, (t_ref, tri_ref, visits) = cuda_call(
        lambda: TC.closest_walk_ref(o, d, m, *tabs, seed, seed_base,
                                    rounds=rounds))
    match, n_bad, worst = near_ties(o, d, m, hit.tri, tri_ref,
                                    data.tri_planes)
    both = m & (hit.tri == tri_ref) & (tri_ref >= 0)
    err = float((hit.t - t_ref)[both].abs().max()) if bool(both.any()) else 0.0
    dead_same = bool((hit.tri == tri_ref)[~m].all())
    # the walk is the kernel's, ray by ray: equal bits, not only near-ties
    same_bits = bool(torch.equal(hit.tri, tri_ref) and torch.equal(
        hit.t.view(torch.int32), t_ref.view(torch.int32)))
    ms = cuda_ms(run, 10)
    bnd = walk_bound(visits, o.shape[0], int(m.sum()), data, spec, True)
    log(f"  {name}: {int(m.sum())} live rays of {o.shape[0]}, every ray "
        f"checked: ids equal {match:.6f}, {n_bad} near-ties (worst exact-t "
        f"rel {worst:.3e}), max |t - t_plain| {err:.3e}, bit-equal "
        f"{same_bits}; kernel {ms:.3f} ms{_was(before)}, walking plain "
        f"{plain_ms:.3f} ms, bound of the walk's own work {bnd[0]:.4f} ms "
        f"({bnd[1]}); "
        + visit_stats(visits, m, group_sizes(rounds, ncp), len(rounds)))
    assert match >= MIN_MATCH, f"{name}: ids equal on only {match:.6f}"
    assert worst <= NEAR_TIE_REL, f"{name}: mismatch is not a near-tie"
    assert dead_same, f"{name}: masked rays differ"
    assert same_bits, f"{name}: not bit-equal to the walking plain version"
    return {"err": err, "ms": ms, "plain_walk_ms": plain_ms, "walk_bound": bnd}


def check_walk_any(name, args, data, spec, before=None):
    """K2 or K4 against the plain version that walks, on every ray."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    o, d, mt, m = args
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    ncp = data.clu_planes.shape[0] * data.clu_planes.shape[1]
    run = lambda: TC.trace_any(o, d, mt, m, *tabs)
    occ = run()
    rounds = []
    plain_ms, (ref, visits) = cuda_call(
        lambda: TC.any_walk_ref(o, d, mt, m, *tabs, rounds=rounds))
    n_live = int(m.sum())
    n_bad = int(((occ != ref) & m).sum())
    match = 1.0 - n_bad / max(n_live, 1)
    dead_same = not bool(occ[~m].any())
    same_bits = bool(torch.equal(occ, ref))
    ms = cuda_ms(run, 10)
    bnd = walk_bound(visits, o.shape[0], n_live, data, spec, False)
    log(f"  {name}: {n_live} live rays of {o.shape[0]}, occluded "
        f"{int((ref & m).sum())}, every ray checked: flags equal "
        f"{match:.6f}, bit-equal {same_bits}; kernel {ms:.3f} "
        f"ms{_was(before)}, walking plain "
        f"{plain_ms:.3f} ms, bound of the walk's own work {bnd[0]:.4f} ms "
        f"({bnd[1]}); " + visit_stats(visits, m, group_sizes(rounds, ncp),
                                      len(rounds)))
    assert match >= MIN_MATCH, f"{name}: flags equal on only {match:.6f}"
    assert dead_same, f"{name}: masked rays differ"
    assert same_bits, f"{name}: not bit-equal to the walking plain version"
    return {"err": float(n_bad > 0), "ms": ms, "plain_walk_ms": plain_ms,
            "walk_bound": bnd}


def _key_t(key, idm):
    import torch

    return (key & ~idm).view(torch.float32)


def compare_broadphase(name, got, ref, m, any_mode):
    """(worst share of live rays on which one of K5's outputs equals the
    plain version's, max |t - t_plain|); every key mismatch must lie within
    one chop step."""
    from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    n_live = int(m.sum())
    err, worst_share = 0.0, 1.0
    for label, g, r in zip(("key1", "key2", "g"), got, ref):
        assert (g is None) == (r is None), (name, label)
        if g is None:
            continue
        share = 1.0 - int(((g != r) & m).sum()) / max(n_live, 1)
        worst_share = min(worst_share, share)
        if label == "g" and any_mode:
            err = max(err, float((g - r).abs().max()))
            continue
        idm = BP.NC_IDM if label != "g" else TC.IDX_MASK
        sent = BP.NC_SENT if label != "g" else TC._INIT_KEY
        real = m & (g != sent) & (r != sent)
        if bool(real.any()):
            err = max(err, float((_key_t(g, idm) - _key_t(r, idm))[real]
                                 .abs().max()))
        step = (idm + 1)
        off = ((g & ~idm).long() - (r & ~idm).long()).abs()[m & (g != r)]
        assert bool((off <= step).all()), f"K5 {name} {label}: not 1 step"
    return worst_share, err


RAGGED = 1_000_003  # rays of phase 6's ragged check: fills no block


def check_broadphase(calls, data, spec):
    """K5 against its plain version in every mode on all rays of dragon's
    primary pass (shadow pass for any mode), and on the first ``RAGGED``
    of them; returns each mode's result."""
    import torch

    from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
    from metal_raytracing_tpu_torch.utils.metrics import kernel_device_ms

    bvh = spec.bvh
    clu, tri = data.clu_planes, data.tri_planes
    ncp = clu.shape[0] * clu.shape[1]
    out = {}
    for i, (name, kind, want2, with_clusters, any_mode) in enumerate(
            BP.BROADPHASE_MODES):
        if kind == "any":
            o, d, mt, m = calls["any"][0]
        else:
            (o, d, m, _), mt = calls["closest"][0], None
        kw = dict(want2=want2, with_clusters=with_clusters,
                  any_mode=any_mode)
        run = lambda: BP.broadphase_keys(o, d, m, clu, tri, bvh, max_t=mt,
                                         **kw)
        got = run()
        ref = BP.broadphase_ref(o, d, m, clu, tri, bvh, max_t=mt, **kw)
        torch.cuda.synchronize()
        share, err = compare_broadphase(name, got, ref, m, any_mode)
        ro, rd, rm = (x[:RAGGED].contiguous() for x in (o, d, m))
        rmt = None if mt is None else mt[:RAGGED].contiguous()
        rshare, rerr = compare_broadphase(
            name, BP.broadphase_keys(ro, rd, rm, clu, tri, bvh, max_t=rmt,
                                     **kw),
            BP.broadphase_ref(ro, rd, rm, clu, tri, bvh, max_t=rmt, **kw), rm,
            any_mode)
        ms = cuda_ms(run, 10)
        dev_ms = kernel_device_ms(run, "broadphase_kernel", 10)
        plain_ms = cuda_ms(lambda: BP.broadphase_ref(o, d, m, clu, tri, bvh,
                                                     max_t=mt, **kw), 1)
        n_live = int(m.sum())
        bnd = bound(*broadphase_work(o.shape[0], n_live, ncp, bvh.num_global,
                                     with_clusters, want2, any_mode))
        log(f"  K5 {name}: {n_live} live rays, outputs equal {share:.6f}, "
            f"max |t - t_plain| {err:.3e}; first {RAGGED} rays: outputs "
            f"equal {rshare:.6f}; kernel {ms:.3f} ms by events ({dev_ms:.4f} "
            f"ms device time, profiler; one thread per ray: "
            f"{ONE_THREAD_MS['K5'][i]:.3f} ms by events), plain "
            f"{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        assert share >= MIN_MATCH, f"K5 {name}: {share:.6f}"
        assert rshare >= MIN_MATCH, f"K5 {name} ragged: {rshare:.6f}"
        out[name] = {"err": max(err, rerr), "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "bound": bnd}
    return out


def _tri_of(key, base):
    """Triangle slot of a rank walk's (key, base); -1 on a miss."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    return torch.where(key < TC._MISS_KEY, base + (key & TC.IDX_MASK), -1)


def check_rank(name, rec, data, spec, before):
    """K6 against its plain version and, bit for bit, against the plain
    version that walks as its warps do, on every ray of one recorded sorted
    pass; ``before`` is the one-thread-per-ray kernel's recorded ms.
    Returns a result dict with the walk's (key, base)."""
    import torch

    from metal_raytracing_tpu_torch.ops import rank_cuda as RK
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    o, d, m, keys, seed = rec
    tri, bvh = data.tri_planes, spec.bvh
    cand = list(keys[:2])
    run = lambda: RK.trace_closest_rank(o, d, m, cand, tri, bvh, seed)
    key, base = run()
    plain_ms, (rkey, rbase) = cuda_call(lambda: RK.closest_rank_ref(
        o, d, m, cand, tri, bvh, seed))
    rounds = []
    walk_ms, (wkey, wbase, visits, sizes) = cuda_call(
        lambda: RK.closest_rank_walk_ref(o, d, m, cand, tri, bvh, seed,
                                         rounds=rounds))
    same_bits = bool(torch.equal(key, wkey) and torch.equal(base, wbase))
    n_live = int(m.sum())
    equal = int(((key == rkey) & (base == rbase) & m).sum()) / max(n_live, 1)
    dead_same = bool(((key == rkey) & (base == rbase))[~m].all())
    match, n_bad, worst = near_ties(o, d, m, _tri_of(key, base),
                                    _tri_of(rkey, rbase), tri)
    both = m & (key == rkey) & (key < TC._MISS_KEY)
    err = float((TC._key_to_t(key) - TC._key_to_t(rkey))[both].abs().max()
                ) if bool(both.any()) else 0.0
    ms = cuda_ms(run, 10)
    # the clusters this walk dense-tests: each candidate that survives its
    # cull, as the walking plain version counts them
    n = o.shape[0]
    nbytes = (n * (12 + 12 + 1 + 4 + 8) + n * 8
              + 48 * bvh.num_clusters * bvh.cluster_size)
    bnd = bound(nbytes, int(visits.sum()) * bvh.cluster_size * PLANE_OPS)
    unresolved = m & ~RK.rank_certificate(key, keys[2])
    n_open = int(unresolved.sum())
    log(f"  {name}: {n_live} live rays of {n}, key and base equal "
        f"{equal:.6f} (ids {match:.6f}, {n_bad} near-ties, worst exact-t rel "
        f"{worst:.3e}), max |t - t_plain| {err:.3e}, bit-equal to the "
        f"walking plain version {same_bits}; kernel {ms:.3f} ms (one thread "
        f"per ray: {before:.3f}), plain {plain_ms:.3f} ms, walking plain "
        f"{walk_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); uncertified "
        f"{n_open} ({n_open / max(n_live, 1):.4f} of live); "
        + visit_stats(visits, m, sizes, len(rounds)))
    assert equal >= MIN_MATCH and match >= MIN_MATCH, f"{name}: {equal:.6f}"
    assert worst <= NEAR_TIE_REL, f"{name}: mismatch is not a near-tie"
    assert dead_same, f"{name}: masked rays differ"
    assert same_bits, f"{name}: not bit-equal to the walking plain version"
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bnd,
            "plain_walk_ms": walk_ms, "walk_bound": bnd, "key": key,
            "base": base, "unresolved": unresolved}


def check_fallback(name, rec, walk, data, spec):
    """K3 seeded per ray with K6's key and base, against its plain version
    on the uncertified rays; then K6 + certificate + seeded K3 against K3
    alone on the whole pass.  Returns the seeded K3's max |t - t_plain|."""
    import torch

    from metal_raytracing_tpu_torch import renderer as R
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    o, d, m, keys, seed = rec
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    open_ = walk["unresolved"].nonzero()[:, 0]
    uo, ud = o[open_].contiguous(), d[open_].contiguous()
    um = walk["unresolved"][open_]
    ukey, ubase = walk["key"][open_], walk["base"][open_]
    got = TC.trace_closest(uo, ud, um, *tabs, ukey, seed_base=ubase)
    plain_ms, (t_ref, tri_ref) = cuda_call(lambda: TC.closest_flat_ref(
        uo, ud, um, data.tri_planes, spec.bvh, ukey, ubase))
    match, n_bad, worst = near_ties(uo, ud, um, got.tri, tri_ref,
                                    data.tri_planes)
    both = um & (got.tri == tri_ref) & (tri_ref >= 0)
    err = float((got.t - t_ref)[both].abs().max()) if bool(both.any()) else 0.0
    ms = cuda_ms(lambda: TC.trace_closest(o, d, walk["unresolved"], *tabs,
                                          walk["key"],
                                          seed_base=walk["base"]), 10)
    # the reference packs the stragglers to the front before its fallback:
    # what that would buy here (the sort and gathers not counted)
    order = torch.argsort(walk["unresolved"].to(torch.uint8), descending=True,
                          stable=True)
    po, pd, pm, pkey, pbase = (x[order].contiguous() for x in (
        o, d, walk["unresolved"], walk["key"], walk["base"]))
    ms_packed = cuda_ms(lambda: TC.trace_closest(po, pd, pm, *tabs, pkey,
                                                 seed_base=pbase), 10)
    log(f"  {name} seeded K3 on {open_.shape[0]} uncertified rays: ids equal "
        f"{match:.6f}, {n_bad} near-ties (worst {worst:.3e}), max |t - "
        f"t_plain| {err:.3e}; kernel {ms:.3f} ms (in place, whole pass "
        f"masked; {ms_packed:.3f} ms with those rays packed to the front), "
        f"plain {plain_ms:.3f} ms")
    assert match >= MIN_MATCH and worst <= NEAR_TIE_REL, name
    closest = R.make_tracers(data, spec, "cuda")[0]
    rank = R.make_closest_rank(data, spec, R.RenderConfig(**SLICE), "cuda",
                               closest)
    hit, _ = rank(o, d, m, keys, seed)
    alone = TC.trace_closest(o, d, m, *tabs, seed)
    match, n_bad, worst = near_ties(o, d, m, hit.tri, alone.tri,
                                    data.tri_planes)
    ms_rank = cuda_ms(lambda: rank(o, d, m, keys, seed), 10)
    ms_alone = cuda_ms(lambda: TC.trace_closest(o, d, m, *tabs, seed), 10)
    log(f"  {name} K6 + certificate + seeded K3 vs K3 alone: ids equal "
        f"{match:.6f}, {n_bad} near-ties (worst {worst:.3e}); {ms_rank:.3f} "
        f"ms against {ms_alone:.3f} ms")
    assert match >= MIN_MATCH and worst <= NEAR_TIE_REL, name
    return err


def sorted_against_shuffled(name, fn, args):
    """Kernel ms on a recorded sorted pass and on the same rays in a random
    order (what the sort is worth to a one-thread-per-ray kernel)."""
    import torch

    n = args[0].shape[0]
    perm = torch.randperm(n, device=args[0].device,
                          generator=torch.Generator(args[0].device)
                          .manual_seed(0))
    mixed = tuple(a[perm].contiguous() for a in args)
    ms_sorted = cuda_ms(lambda: fn(*args), 10)
    ms_mixed = cuda_ms(lambda: fn(*mixed), 10)
    log(f"    {name}: {ms_sorted:.3f} ms sorted, {ms_mixed:.3f} ms in random "
        f"order ({int(args[-1].sum())} live of {n})")
    return ms_sorted, ms_mixed


# The exact broad phase's forms timed and checked by phase 11: (label,
# nearest_cluster keywords; "max_t": bounded, "sup": the super boxes,
# "pair": nearest_cluster_pair with those ranks)
EXACT_FORMS = (
    ("ranks 1", dict(return_key=True)),
    ("ranks 1-2", dict(return_key=True, return_second=1)),
    ("ranks 1-2 packed", dict(return_key=True, return_second=1,
                              return_packed=True)),
    ("ranks 1-3", dict(return_key=True, return_second=2)),
    ("ranks 1-3 packed", dict(return_key=True, return_second=2,
                              return_packed=True)),
    ("bounded rank 1", dict(max_t=True)),
    ("bounded ranks 1-2", dict(max_t=True, return_second=1)),
    ("super level bounded", dict(sup=True, max_t=True)),
    ("pair ranks 2", dict(pair=2)),
    ("pair ranks 3 packed", dict(pair=3, return_packed=True)),
)
# FP32 issue slots of the top-k update a ray and box: min for rank 1, then
# max and min for each further rank
TOPK_OPS = {1: 1, 2: 3, 3: 5}


def exact_broadphase_work(n, nc, ranks, live, live_sh=None, bounded=False):
    """(bytes, operations) of one ``nearest_cluster_kernel`` launch over
    ``nc`` boxes: a slab test of every live ray against every box
    (``SLAB_OPS``) and its top-k update; the pair (``live_sh``: the shadow
    segments' live rays) adds the shadow's test less the six shared
    subtractions and its rank-1 update, and the pair's reads and key."""
    nbytes = n * (12 + 12 + 1 + (4 if bounded else 0) + 4 * ranks) + 24 * nc
    ops = live * nc * (SLAB_OPS + TOPK_OPS[ranks])
    if live_sh is not None:
        nbytes += n * (12 + 1 + 4 + 4)
        ops += live_sh * nc * (SLAB_OPS - 6 // 2 + TOPK_OPS[1])
    return nbytes, ops


def nearest_cluster_registers():
    """Log each ``nearest_cluster_kernel`` instance's registers and spill
    line from this process's build (phase 1); fails on a spill.  Returns
    {instance: registers} (empty for a build loaded from the cache)."""
    from metal_raytracing_tpu_torch.ops import _build

    regs, name = {}, None
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            name = (line.split("'")[1] if "nearest_cluster_kernel" in line
                    else None)
        elif name and "spill" in line:
            assert "0 bytes spill stores, 0 bytes spill loads" in line, (
                f"{name} spills: {line.strip()}")
        elif name and "Used" in line and "registers" in line:
            regs[name] = int(line.split("Used")[1].split()[0])
    for inst, r in regs.items():
        log(f"  {inst}: {r} registers, no spill")
    assert not _build.build_log or len(regs) == 8, regs
    return regs


def _exact_call(kw, rays, data, spec):
    """A closure that runs one form of the exact broad phase."""
    from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP

    o, d, m, mt, d_nb, m_nb = rays
    kw = dict(kw)
    if "pair" in kw:
        ranks = kw.pop("pair")
        return lambda: BP.nearest_cluster_pair(
            o, d, mt, m, d_nb, m_nb, data.clu_planes, spec.bvh, ranks=ranks,
            **kw)
    table = (data.sup_planes[:, None, :] if kw.pop("sup", False)
             else data.clu_planes)
    bound_t = mt if kw.pop("max_t", False) else None
    return lambda: BP.nearest_cluster(o, d, m, table, spec.bvh,
                                      max_t=bound_t, **kw)


@contextlib.contextmanager
def plain_chain():
    """Inside it the exact broad phase's wrappers run the plain chain on
    the card (for the comparisons; the port never does)."""
    from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP

    saved = BP._device_path
    BP._device_path = lambda o: False
    try:
        yield
    finally:
        BP._device_path = saved


def check_exact_broadphase(rec, any_rec, data, spec):
    """``nearest_cluster_kernel`` against the plain chain on the same card
    in every form (``EXACT_FORMS``), bit for bit, on the slice's sorted
    bounce-1 rays (the unbounded forms) and its bounce-1 shadow segments
    (the bounded forms and the pair, with the bounce rays' directions);
    the kernel's ranks 1-2 against K5's keys; each form's kernel ms by
    events (twenty host calls between two events also time the wrapper's
    Python) and its device ms from the profiler, beside the plain chain's
    ms and its bound.  Returns the kernel's results by form."""
    import torch

    from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
    from metal_raytracing_tpu_torch.utils.metrics import kernel_device_ms

    o, d, m, _, _ = rec
    so, sd, smt, sm = any_rec
    clu, tri, bvh = data.clu_planes, data.tri_planes, spec.bvh
    nregs = nearest_cluster_registers()
    out = {}
    for label, kw in EXACT_FORMS:
        bounded = "max_t" in kw or "pair" in kw
        rays = ((so, sd, sm, smt, d, m) if bounded
                else (o, d, m, smt, d, m))
        run = _exact_call(kw, rays, data, spec)
        got = run()
        with plain_chain():
            ref = run()
            plain_ms = cuda_ms(run, 2)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        n = rays[0].shape[0]
        same = torch.ones(n, dtype=torch.bool, device=o.device)
        for g, r in zip(got, ref):
            same &= g == r
        share = float(same.float().mean())
        equal = all(torch.equal(g, r) for g, r in zip(got, ref))
        ms = cuda_ms(run, 20)
        dev_ms = kernel_device_ms(run, "nearest_cluster_kernel", 10)
        nc = (data.sup_planes.shape[0] if kw.get("sup")
              else clu.shape[0] * clu.shape[1])
        ranks = kw.get("pair", 1 + kw.get("return_second", 0))
        if "pair" in kw:
            work = exact_broadphase_work(n, nc, ranks, int(m.sum()),
                                         int(sm.sum()))
        else:
            work = exact_broadphase_work(n, nc, ranks, int(rays[2].sum()),
                                         bounded=bounded)
        bnd = bound(*work)
        log(f"  {label}: {n} rays x {nc} boxes, kernel vs plain chain equal "
            f"{share:.6f} (torch.equal {equal}); kernel {ms:.4f} ms by "
            f"events ({dev_ms:.4f} ms device time, profiler), plain chain "
            f"{plain_ms:.3f} ms ({plain_ms / dev_ms:.1f}x), bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}, {100 * bnd[0] / dev_ms:.1f}% of "
            f"the device time)")
        assert equal, f"nearest_cluster_kernel {label}: {share:.6f}"
        out[label] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound": bnd, "err": 0.0}
    fused = BP.broadphase_keys(o, d, m, clu, tri, bvh, want2=True)
    _, k1, k2 = BP.nearest_cluster(o, d, m, clu, bvh, return_key=True,
                                   return_second=1, return_packed=True)
    k5_equal = bool(torch.equal(k1, fused[0]) and torch.equal(k2, fused[1]))
    ms_fused = cuda_ms(lambda: BP.broadphase_keys(o, d, m, clu, tri, bvh,
                                                  want2=True), 20)
    log(f"  ranks 1-2 equal to K5's keys+second {k5_equal} (K5 "
        f"{ms_fused:.4f} ms with its global seed); registers "
        f"{sorted(set(nregs.values()))}")
    assert k5_equal, "nearest_cluster_kernel vs K5"
    return out


def exact_broadphase_images(card, size):
    """Dragon at config B (``compaction=True``) and at ``rank_trace=2``
    through the graphed main path, with the kernel's keys and with the
    plain chain forced, in turns: the images ``torch.equal``, ms/sample of
    each, and the kernel's launches in one eager sample."""
    import torch

    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    w, h = size
    for label, kw in (("config B", dict(compaction=True)),
                      ("rank_trace=2", SLICE)):
        images, ms = [], []
        for plain in (False, True):
            cfg = RenderConfig(width=w, height=h, **kw)
            with plain_chain() if plain else contextlib.nullcontext():
                r = Renderer(get_scene("dragon", w, h), cfg, device="cuda")
                k = r.samples_per_dispatch
                r.render(k)  # the warm-up sample and the graph's capture
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.render(k * ROUND_SAMPLES)  # replays
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) / (k * ROUND_SAMPLES) * 1e3)
            images.append(r.accum.clone())
            if not plain:
                per = sample_launches(r)
        equal = bool(torch.equal(images[0], images[1]))
        log(f"  dragon {w}x{h} {label}: kernel {ms[0]:.3f} ms/sample, plain "
            f"chain {ms[1]:.3f} ms/sample; images torch.equal {equal}; "
            f"launches a sample: nearest_cluster {per['nearest_cluster']} "
            f"(pair {per['nearest_cluster_pair']}); on {card}")
        assert equal, label
        assert (per["nearest_cluster"], per["nearest_cluster_pair"]) == (
            2, 1), per


CONFIGS = (  # (label, config keywords)
    ("compaction=False", {}),
    ("compaction=True", dict(compaction=True)),
    ("compaction=True rank_trace=2", SLICE),
    ("compaction=True fused_broadphase=True",
     dict(compaction=True, fused_broadphase=True)),
)


def four_configs(card, size):
    """The dragon main path in four configs in turns (A B C D, twice).
    Returns each config's launch counts over its run (the warm-up render,
    which captures the graphs, and the timed renders, which replay them;
    checked by :func:`graphed_run`) and what they hold."""
    import torch

    from metal_raytracing_tpu_torch.io.image import rmse
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    w, h = size
    scene = get_scene("dragon", w, h)
    rs = [Renderer(scene, RenderConfig(width=w, height=h, **kw),
                   device="cuda") for _, kw in CONFIGS]
    totals = {}
    for (label, _), r in zip(CONFIGS, rs):
        # warm-up: the timed renders' steps, so their graphs are captured
        TC.reset_launch_counts()
        r.render(ROUND_SAMPLES)
        totals[label] = launch_counts()
    torch.cuda.synchronize()
    rows = {label: [] for label, _ in CONFIGS}
    for _ in range(ROUNDS):
        for (label, kw), r in zip(CONFIGS, rs):
            rays0 = r.total_closest_rays + r.total_shadow_rays
            TC.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(ROUND_SAMPLES)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            totals[label] = {k: v + launch_counts()[k]
                             for k, v in totals[label].items()}
            rays = r.total_closest_rays + r.total_shadow_rays - rays0
            rows[label].append((sec / ROUND_SAMPLES * 1e3, rays / sec / 1e6))
    per_sample, notes = {}, {}
    for (label, _), r in zip(CONFIGS, rs):
        per_sample[label], notes[label] = graphed_run(label, r,
                                                      totals[label])
    ref = rs[0].image
    for (label, _), r in zip(CONFIGS, rs):
        img = r.image
        assert img.shape == (h, w, 3) and bool(np.isfinite(img).all())
        assert float(img.min()) >= 0.0 and float(img.max()) > 0.01
        err = rmse(img, ref)
        per = {k: v for k, v in per_sample[label].items() if v}
        log(f"  {label}: " + " / ".join(f"{ms:.3f}" for ms, _ in
                                        rows[label])
            + " ms/sample, " + " / ".join(f"{mr:.3f}" for _, mr in
                                          rows[label])
            + f" Mrays/s; launches/sample {per}; RMSE vs compaction=False "
            f"after {r.total_samples} samples {err:.3e} (gate < "
            f"{SAME_IMAGE_RMSE}); on {card}")
        assert err < SAME_IMAGE_RMSE, (label, err)
    per = per_sample[CONFIGS[2][0]]
    assert per["closest_rank"] == 2 and per["closest_hier"] == 3, per
    assert per["any_hier"] == 3 and per["closest_flat"] == 0, per
    fused = per_sample[CONFIGS[3][0]]
    assert fused["broadphase"] == 6, fused
    assert fused["broadphase_clusters"] >= 1, fused
    sl = rs[2]
    wall_ms = rows[CONFIGS[2][0]][-1][0]
    prof = checked_profile(CONFIGS[2][0], sl, 2, per_sample[CONFIGS[2][0]])
    busy = prof.device_ms_per_sample / wall_ms
    log(f"  slice profiled 2 samples: device {prof.device_ms_per_sample:.3f} "
        f"ms/sample in {prof.launches // prof.samples} kernels/sample; busy "
        f"{busy:.3f} of the unprofiled wall (idle {1 - busy:.3f})")
    for name, ms, n in prof.kernels[:8]:
        log(f"    {ms / prof.device_ms:.3f} {ms / prof.samples:.3f} "
            f"ms/sample {n // prof.samples}/sample {name[:90]}")
    return totals, notes


def main_path(renderer, card, label, size):
    """Time the renderer's main path (``TIMED_SAMPLES`` steps of its batch
    after one warm-up step) and check its image; returns (bench, samples,
    the run's launch counts, one sample's launch counts, what the run's
    counts hold).  The run's counts are the wrapper calls of the warm-up
    and timed steps: the renderer's eager warm-up sample and the samples
    of the graph it captures (a replay launches the captured kernels
    without the wrappers), checked against one eager sample's
    (:func:`graphed_run`).  A profiled replay of that graph follows (where
    the device time goes), which must run each kernel as often as an
    eager sample (:func:`checked_profile`)."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.utils.metrics import benchmark_renderer

    assert renderer.tracer == "cuda", renderer.tracer
    assert renderer.graphed
    TC.reset_launch_counts()
    bench = benchmark_renderer(renderer, samples=TIMED_SAMPLES, warmup=1)
    img = renderer.image
    w, h = size
    assert img.shape == (h, w, 3), img.shape
    assert bool(np.isfinite(img).all()), "image has non-finite values"
    assert float(img.min()) >= 0.0, "image has negative values"
    assert float(img.max()) > 0.01, "image is not lit"
    log(f"  {label} {w}x{h} 3 bounces: "
        f"{bench.per_sample_seconds * 1e3:.3f} ms/sample, "
        f"{bench.mrays_per_sec:.3f} Mrays/s (primary+shadow, "
        f"{bench.rays} rays in {bench.samples} samples), warm-up "
        f"{bench.warmup_seconds:.2f} s, on {card}")
    samples = renderer.total_samples
    counts = launch_counts()
    per, note = graphed_run(label, renderer, counts)
    log(f"  one sample's launches (eager): "
        f"{ {k: v for k, v in per.items() if v} }; the run's ({note}): "
        f"{ {k: v for k, v in counts.items() if v} }")
    prof = checked_profile(label, renderer, renderer.samples_per_dispatch,
                           per)
    busy = prof.device_ms_per_sample / (bench.per_sample_seconds * 1e3)
    log(f"  profiled 2 samples: device {prof.device_ms_per_sample:.3f} "
        f"ms/sample in {prof.launches // prof.samples} kernels/sample; busy "
        f"{busy:.3f} of the unprofiled wall (idle {1 - busy:.3f})")
    for name, ms, n in prof.kernels[:6]:
        log(f"    {ms / prof.device_ms:.3f} {ms / prof.samples:.3f} "
            f"ms/sample {n // prof.samples}/sample {name[:90]}")
    return bench, samples, counts, per, note


def sample_launches(r):
    """Each kernel wrapper's launches in one sample of renderer ``r``'s
    config, from one eager sample through ``render_sample``, not folded
    into ``r``: the wrappers count a graph's launches once, at its
    capture, and a replay's not at all."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import render_sample

    TC.reset_launch_counts()
    render_sample(r.data, r.spec, r.cfg, r.offsets, r.frame_index, r.tracer,
                  baked_tables=r.baked)
    return launch_counts()


# the launch counters of each kernel (``launch_counts``' keys; a kernel's
# forms sum to its launches)
KERNEL_COUNTERS = {
    "closest_flat_kernel": ("closest_flat",),
    "any_flat_kernel": ("any_flat",),
    "closest_hier_kernel": ("closest_hier", "closest_hier_baked"),
    "any_hier_kernel": ("any_hier",),
    "broadphase_kernel": ("broadphase",),
    "nearest_cluster_kernel": ("nearest_cluster", "nearest_cluster_pair"),
    "closest_rank_kernel": ("closest_rank",),
    "closest_bvh_kernel": ("closest_bvh",),
    "any_bvh_kernel": ("any_bvh",),
}


def graphed_run(label, r, counts):
    """Check the launch counts of a graphed renderer's run that began with
    no graph: its warm-up sample and the samples its graphs captured, each
    with one eager sample's launches (a replay passes through no
    wrapper), so a kernel missing from a captured graph fails here.
    Returns (one sample's counts, what the run's counts hold)."""
    per = sample_launches(r)
    captured = sum(r.graphs)
    want = {k: (1 + captured) * v for k, v in per.items()}
    assert r.graphed and counts == want, (label, counts, want)
    return per, f"warm-up sample + capture of {captured} samples"


PROFILE_TRIES = 3  # profiled windows checked_profile may take


def checked_profile(label, r, k, per, steps=1):
    """``profile_renderer(r, k, steps)`` (on a graphed renderer, replays of
    its graph of ``k`` samples), checked: the window must hold each
    kernel's records as often a sample as one eager sample (``per``)
    launches it.  More records fail at once.  Fewer are the profiler's
    loss, not the card's: the captures hold every launch
    (:func:`graphed_run`) and the graphed images equal the eager ones, but
    a full run has seen a replay of ``bake_primary``'s graph record 5 of
    its 6 ``any_hier_kernel`` launches, which also lowers the window's
    device time.  Such a window is discarded, logged and taken again, up to
    ``PROFILE_TRIES`` windows."""
    from metal_raytracing_tpu_torch.utils.metrics import profile_renderer

    for _ in range(PROFILE_TRIES):
        prof = profile_renderer(r, k, steps)
        short = {}
        for kernel, keys in KERNEL_COUNTERS.items():
            want = sum(per[c] for c in keys) * prof.samples
            got = sum(n for name, _, n in prof.kernels if kernel in name)
            assert got <= want, (label, kernel, got, want)
            if got < want:
                short[kernel] = (got, want)
        if not short:
            return prof
        log(f"    {label}: a profiled window discarded, it holds fewer "
            f"kernel records than launches (recorded, launched): {short}, "
            f"device {prof.device_ms_per_sample:.3f} ms/sample")
    raise AssertionError((label, "the profiler lost records in every "
                          "window", short))


def launch_counts():
    from metal_raytracing_tpu_torch.ops import trace as PT
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.ops.broadphase_cuda import (
        broadphase_keys, nearest_cluster)
    from metal_raytracing_tpu_torch.ops.rank_cuda import trace_closest_rank

    return {"closest_bvh": PT.trace_closest.launches,
            "any_bvh": PT.trace_any.launches,
            "closest_flat": TC.trace_closest.launches,
            "any_flat": TC.trace_any.launches,
            "closest_hier": TC.trace_closest.launches_hier,
            "closest_hier_baked": TC.trace_closest.launches_baked,
            "any_hier": TC.trace_any.launches_hier,
            # the wide instances' share of the hierarchical launches above
            "closest_wide": TC.trace_closest.launches_wide,
            "any_wide": TC.trace_any.launches_wide,
            "broadphase": broadphase_keys.launches,
            "broadphase_clusters": broadphase_keys.launches_clusters,
            "nearest_cluster": nearest_cluster.launches,
            "nearest_cluster_pair": nearest_cluster.launches_pair,
            "closest_rank": trace_closest_rank.launches}


def cross_check(scene, size, spp, **cfg_kw):
    from metal_raytracing_tpu_torch.io.image import rmse
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    w, h = size
    imgs = {}
    for tracer in ("cuda", "torch"):
        r = Renderer(get_scene(scene, w, h),
                     RenderConfig(width=w, height=h, tracer=tracer, **cfg_kw),
                     device="cuda")
        imgs[tracer] = r.render(spp)
    err = rmse(imgs["cuda"], imgs["torch"])
    log(f"  {scene} {w}x{h} {spp} spp {cfg_kw or ''}: RMSE cuda vs torch "
        f"tracer {err:.3e} (gate < {IMAGE_RMSE})")
    assert err < IMAGE_RMSE, err


def cli_config(name, size):
    """(scene, the CLI's config for it at ``size``, the same with every
    shading extension off)."""
    from metal_raytracing_tpu_torch.cli import build_parser, render_config
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    w, h = size
    scene = get_scene(name, w, h)
    args = build_parser().parse_args(["render", "--scene", name, "--size",
                                      f"{w}x{h}"])
    return scene, render_config(args, scene), RenderConfig(width=w, height=h)


def extension_scenes(card):
    """Phase 14; returns the K1/K2 launches of the extension scenes' runs
    with their extensions on (the warm-up renders capture the graphs that
    the timed renders replay)."""
    import dataclasses

    import torch

    from metal_raytracing_tpu_torch import renderer as R
    from metal_raytracing_tpu_torch.io.image import rmse
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import Renderer

    # The walking plain versions visit the clusters in the kernels' order,
    # so the kernels' passes and image equal theirs bit for bit.  The
    # brute-force plain versions break an exact tie between two clusters
    # in their own order (phase 2 meets one such ray on coatball's primary
    # pass), so their image is held at the image gate.
    for name, size in EXTENSION_SCENES:
        scene, cfg, _ = cli_config(name, size)
        r = Renderer(scene, cfg, device="cuda")
        assert TC._use_flat(r.spec.bvh), name
        on = sorted(f for f in ("enable_specular", "env_map",
                                "enable_textures", "enable_refraction")
                    if getattr(cfg, f))
        assert on, name
        log(f"  {name} {size[0]}x{size[1]} {on}, one sample's passes vs the "
            f"walking plain versions:")
        calls = record_passes(r)
        for b, args in enumerate(calls["closest"]):
            check_walk_closest(f"K1 closest bounce {b}", args, r.data, r.spec)
        for b, args in enumerate(calls["any"]):
            check_walk_any(f"K2 any bounce {b}", args, r.data, r.spec)
        walked, _ = R.render_sample(r.data, r.spec, r.cfg, r.offsets, 0,
                                    tracers=(*walk_tracers(r.data, r.spec),
                                             None))
        same = bool(torch.equal(calls["image"], walked))
        log(f"    sample through the kernels equal to the sample through "
            f"the walking plain versions: {same}")
        assert same, name
        del calls, walked, r
        imgs = [Renderer(scene, dataclasses.replace(cfg, tracer=t),
                         device="cuda").render(1) for t in ("cuda", "torch")]
        err = rmse(imgs[0], imgs[1])
        worst = float(np.abs(imgs[0] - imgs[1]).max())
        n_px = int((np.abs(imgs[0] - imgs[1]).max(axis=-1) > 0).sum())
        log(f"    1 spp: RMSE cuda vs torch tracer {err:.3e} (gate < "
            f"{IMAGE_RMSE}), max {worst:.3e}, {n_px} pixels differ")
        assert err < IMAGE_RMSE, (name, err)
        torch.cuda.empty_cache()
    scene, cfg, _ = cli_config("glass_sphere", dict(EXTENSION_SCENES)[
        "glass_sphere"])
    imgs = [Renderer(scene, dataclasses.replace(cfg, compaction=c),
                     device="cuda").render(2) for c in (False, True)]
    err = rmse(imgs[0], imgs[1])
    log(f"  glass_sphere refraction 2 spp: RMSE compaction=True vs False "
        f"{err:.3e} (gate < {SAME_IMAGE_RMSE})")
    assert err < SAME_IMAGE_RMSE, err

    launches = {"K1": 0, "K2": 0}
    counts = {}
    log(f"  each scene at its default size, extensions off / on in turns, "
        f"{EXTENSION_ROUNDS} rounds of {ROUND_SAMPLES} samples, on {card}:")
    for name, size in EXTENSION_SCENES:
        scene, cfg, off = cli_config(name, size)
        rs = {"off": Renderer(scene, off, device="cuda"),
              "on": Renderer(scene, cfg, device="cuda")}
        for k, r in rs.items():
            # warm-up: the timed renders' steps, so their graphs are captured
            TC.reset_launch_counts()
            r.render(ROUND_SAMPLES)
            counts[k] = launch_counts()
            if k == "on":
                launches["K1"] += counts[k]["closest_flat"]
                launches["K2"] += counts[k]["any_flat"]
        ms = {k: [] for k in rs}
        for _ in range(EXTENSION_ROUNDS):
            for k, r in rs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.render(ROUND_SAMPLES)
                torch.cuda.synchronize()
                ms[k].append((time.perf_counter() - t0) / ROUND_SAMPLES * 1e3)
        for k, r in rs.items():
            img = r.image
            assert img.shape == (size[1], size[0], 3), img.shape
            assert bool(np.isfinite(img).all()) and float(img.min()) >= 0.0
            assert float(img.max()) > 0.01, (name, k)
            c, _ = graphed_run(f"{name} {k}", r, counts[k])
            assert c["closest_flat"] >= 3 and c["any_flat"] >= 3, (name, k, c)
            prof = checked_profile(f"{name} {k}", r, max(r.graphs), c)
            dev = prof.device_ms_per_sample
            log(f"    {name} {size[0]}x{size[1]} {k}: "
                + " / ".join(f"{m:.3f}" for m in ms[k])
                + f" ms/sample (median {statistics.median(ms[k]):.3f}); K1 "
                f"{c['closest_flat']} K2 {c['any_flat']} launches/sample; "
                f"device {dev:.3f} ms/sample in "
                f"{prof.launches // prof.samples} kernels/sample; idle "
                f"{1 - dev / statistics.median(ms[k]):.3f} of the median "
                f"round, {1 - dev / min(ms[k]):.3f} of the fastest")
        del rs
        torch.cuda.empty_cache()
    return launches


def bvh_work(o, d, mask, data, spec, t_final=None, max_t=None, occ=None):
    """(bytes, operations) a pass of the exact BVH walk needs: for a
    closest ray (``t_final``: its final hit t) the global set, the slab
    tests of every node it must open (the root, and each internal node it
    enters below its final t) and ``cluster_size`` Moller-Trumbore tests
    of each leaf it enters below its final t; for an unoccluded shadow ray
    (``max_t``, ``occ``) the same with every node and leaf its segment
    overlaps; for an occluded one a single triangle."""
    import torch

    from metal_raytracing_tpu_torch.ops.intersect import (ray_aabb,
                                                          safe_inverse)

    bvh = spec.bvh
    geo = data.geometry
    n = o.shape[0]
    nbytes = 3 * geo.v0.numel() * 4 + 2 * data.node_lo.numel() * 4
    if t_final is not None:
        nbytes += n * (12 + 12 + 1) + n * 16  # rays in; t, u, v, tri out
    else:
        nbytes += n * (12 + 12 + 4 + 1) + n  # rays and max_t in; flag out
    walking = mask if occ is None else mask & ~occ
    n_walk = int(walking.sum())
    planes = n_walk * bvh.num_global
    slabs = 0
    if bvh.levels == 0:
        planes += n_walk * bvh.cluster_size
    else:
        slabs += n_walk * bvh.branching  # the root is always opened
        nodes = torch.arange(1, bvh.first_leaf + bvh.num_clusters,
                             device=o.device)
        lo, hi = data.node_lo[nodes], data.node_hi[nodes]
        leaf = nodes >= bvh.first_leaf
        for r in _live_chunks(walking, nodes.shape[0]):
            lim = (t_final if t_final is not None else max_t)[r, None]
            tn, hit = ray_aabb(o[r, None], safe_inverse(d[r, None]),
                               lo[None], hi[None], lim)
            if t_final is not None:
                hit &= tn < lim
            opened = hit.sum(0)
            slabs += int(opened[~leaf].sum()) * bvh.branching
            planes += int(opened[leaf].sum()) * bvh.cluster_size
    if occ is not None:
        planes += int((mask & occ).sum())
    return nbytes, slabs * BVH_SLAB_OPS + planes * MT_OPS


def mt_t(o, d, geo, tri):
    """Moller-Trumbore t of each ray against its slot ``tri`` (-1: BIG_T),
    the exact tracers' arithmetic."""
    import torch

    from metal_raytracing_tpu_torch.ops.intersect import BIG_T, moller_trumbore

    j = tri.clamp(min=0).long()
    t = moller_trumbore(o, d, geo.v0[j], geo.e1[j], geo.e2[j])[0]
    return torch.where(tri >= 0, t, BIG_T)


def margins(o, d, data, tri):
    """Signed distances of each ray's hit on slot ``tri`` (>= 0) from the
    nearest edge of the triangle, positive inside, under the two hit tests
    (Moller-Trumbore, the exact tracers'; the plane rows of K1-K6), each
    over |o| + t (the scale the tests round at)."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.ops.intersect import moller_trumbore

    geo, j = data.geometry, tri.long()
    t, u, v, _ = moller_trumbore(o, d, geo.v0[j], geo.e1[j], geo.e2[j])
    rows = data.tri_planes[:, j].T
    _, u2, v2 = TC.recompute_tuv(o, d, rows)
    gu, gv = rows[:, 4:7], rows[:, 8:11]
    norms = [g.norm(dim=-1).clamp(min=1e-30) for g in (gu, gv, gu + gv)]
    scale = o.abs().amax(dim=-1) + t.abs()

    def dist(u, v):
        return torch.stack([u / norms[0], v / norms[1],
                            (1.0 - u - v) / norms[2]]).amin(dim=0) / scale

    return dist(u, v), dist(u2, v2)


def on_edge(o, d, data, tri):
    """Rays whose hit on slot ``tri`` lies within EDGE_REL of an edge of
    the triangle under both hit tests."""
    mt, pl = margins(o, d, data, tri.clamp(min=0))
    return (tri >= 0) & (mt.abs() <= EDGE_REL) & (pl.abs() <= EDGE_REL)


def bvh_gate(name, o, d, m, t, tri, ref_t, ref_tri, data, global_base,
             cross=False):
    """The gate of the exact tracers against another tracer on the live
    rays ``m``: found masks equal, t within rtol 1e-5, the source triangle
    equal on >= 99.9% of them and every mismatch a near-tie.

    A mismatch where one winner lies in the global set is a contact tie
    (dragon and coatball stand on the floor, ROADMAP Queue 3 item 5): the
    walk gives an exact tie to the global set, tested first, the brute
    force to the lowest slot, and the packed key of K1-K4 gives every tie
    within its chop to the global seed, while the walk takes a cluster hit
    an ulp nearer.  Such a mismatch must be a near-tie too, but it is
    counted apart from the 99.9%.

    ``cross``: the reference is K1-K4, whose hit test is another
    arithmetic (plane rows, a Newton-refined reciprocal).  Where the two
    tests disagree on a hit that lies on an edge, the two tracers find
    different triangles, or one finds none: a ray that is neither equal
    nor a near-tie must then have its nearer winner within EDGE_REL of an
    edge under both tests; such rays count against the 99.9% with the
    near-ties.  Returns (the share of equal source triangles, mismatches,
    max |t - ref_t| where the slots agree)."""
    import torch

    src = data.tri_src
    same = (src[tri.clamp(min=0).long()] == src[ref_tri.clamp(min=0).long()]
            ) & ((tri >= 0) == (ref_tri >= 0))
    found, rfound = (tri >= 0) & m, (ref_tri >= 0) & m
    bad = m & ~same
    both = bad & found & rfound
    rel = torch.zeros_like(t)
    if bool(both.any()):
        ta = mt_t(o[both], d[both], data.geometry, tri[both])
        tb = mt_t(o[both], d[both], data.geometry, ref_tri[both])
        rel[both] = (ta - tb).abs() / tb.abs()
    tie = both & (rel <= NEAR_TIE_REL)
    contact = tie & ((tri >= global_base) | (ref_tri >= global_base))
    edge = bad & ~tie
    if bool(edge.any()):
        nearer = torch.where(t <= ref_t, tri, ref_tri)
        for i in edge.nonzero()[:12, 0].tolist():
            mt, pl = margins(o[i:i + 1], d[i:i + 1], data,
                             nearer[i:i + 1].clamp(min=0))
            log(f"      ray {i}: t {float(t[i]):.9g} slot {int(tri[i])} / "
                f"reference t {float(ref_t[i]):.9g} slot {int(ref_tri[i])}; "
                f"the nearer's distance from an edge over |o| + t "
                f"{float(mt[0]):.3e} (Moller-Trumbore) {float(pl[0]):.3e} "
                f"(plane rows; gate {EDGE_REL:.3e})")
        assert cross, f"{name}: {int(edge.sum())} mismatches are not ties"
        explained = on_edge(o[edge], d[edge], data, nearer[edge])
        assert bool(explained.all()), (
            f"{name}: {int((~explained).sum())} mismatches are neither "
            "near-ties nor edge hits")
    agree = found & (tri == ref_tri)
    t_rel = float(((t - ref_t).abs() / ref_t.abs())[agree].max()
                  ) if bool(agree.any()) else 0.0
    tie_rel = float(rel[tie].max()) if bool(tie.any()) else 0.0
    err = float((t - ref_t)[agree].abs().max()) if bool(agree.any()) else 0.0
    n_live = max(int(m.sum()), 1)
    share = 1.0 - int(bad.sum()) / n_live
    n_contact, n_edge = int(contact.sum()), int(edge.sum())
    log(f"    {name}: {int(m.sum())} live rays ({int(found.sum())} hits), "
        f"sources equal {share:.6f}: {int(tie.sum())} near-ties ({n_contact} "
        f"with the global set; winners' t rel max {tie_rel:.3e}, gate "
        f"{NEAR_TIE_REL:.3e}), {n_edge} edge hits; on equal slots t rel max "
        f"{t_rel:.3e} (gate 1e-5), max |t - t_ref| {err:.3e}")
    assert t_rel <= 1e-5, f"{name}: t off by {t_rel}"
    assert 1.0 - (int(bad.sum()) - n_contact) / n_live >= MIN_MATCH, (
        f"{name}: sources equal on {share}")
    return share, int(bad.sum()), err


def flags_gate(name, args, occ, ref, data, spec, cross=False):
    """Occlusion flags equal on every live ray of ``args`` (o, d, max_t,
    mask).  ``cross`` (the reference is K2 or K4): a ray whose flags differ
    must have its occluder (the nearest hit within max_t under the test
    that found one) within EDGE_REL of an edge, or within EDGE_REL
    relative of max_t, and such rays stay under 0.1%."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace as PT
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    o, d, mt, m = args
    diff = (occ != ref) & m
    n_diff = int(diff.sum())
    if n_diff:
        i = diff.nonzero()[:, 0]
        ours = occ[i]  # the walk found the occluder, else the reference
        hit = PT.trace_closest_bruteforce(o[i], d[i], ours, data.geometry)
        _, k_tri = TC.closest_flat_ref(o[i], d[i], ~ours, data.tri_planes,
                                       spec.bvh)
        occluder = torch.where(ours, hit.tri, k_tri)
        t_occ = mt_t(o[i], d[i], data.geometry, occluder)
        for k in range(min(12, n_diff)):
            a, b = margins(o[i[k:k + 1]], d[i[k:k + 1]], data,
                           occluder[k:k + 1].clamp(min=0))
            log(f"      ray {int(i[k])}: occluded by the "
                f"{'walk' if bool(ours[k]) else 'reference'}, slot "
                f"{int(occluder[k])} at t {float(t_occ[k]):.9g} of max_t "
                f"{float(mt[i[k]]):.9g}; distance from an edge over |o| + t "
                f"{float(a[0]):.3e} (Moller-Trumbore) {float(b[0]):.3e} "
                f"(plane rows)")
        assert cross, f"{name}: flags differ on {n_diff} rays"
        at_end = (t_occ - mt[i]).abs() <= EDGE_REL * mt[i]
        explained = on_edge(o[i], d[i], data, occluder) | at_end
        assert bool(explained.all()), (
            f"{name}: {int((~explained).sum())} flags differ off an edge")
        assert n_diff <= (1.0 - MIN_MATCH) * max(int(m.sum()), 1), name
    log(f"    {name}: flags equal on {int(m.sum()) - n_diff} of "
        f"{int(m.sum())} live rays ({n_diff} edge or segment-end hits; "
        f"{int((occ & m).sum())} occluded)")


def assert_bvh_no_spill() -> None:
    """Fails when this process's kernel build (phase 1 logs its ptxas lines)
    shows the BVH kernels spilling; a build loaded from the cache has no
    log and passes."""
    from metal_raytracing_tpu_torch.ops import _build

    _build.load_library()
    name, seen = None, set()
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in ("closest_bvh_kernel", "any_bvh_kernel")
                         if k in line), None)
        elif name and "spill" in line:
            seen.add(name)
            assert "0 bytes spill stores, 0 bytes spill loads" in line, (
                f"{name} spills: {line.strip()}")
    assert not _build.build_log or len(seen) == 2, seen


def check_bvh_closest(name, args, data, spec, before=None):
    """closest_bvh_kernel on one recorded closest pass: bit for bit against
    the walking plain version on every ray; against the plain packet walk
    and the brute force on every CHECK_STRIDE-th ray, and against K1 or K3
    (the scene's cluster kernel, with the pass's seed) on every ray; the
    kernel's and the cluster kernel's ms on the whole pass (``before``: the
    one-thread-per-ray kernel's recorded ms), the walking plain version's,
    the plain packet walk's on the strided rays, and the bound."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace as PT
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    o, d, m, seed = args
    geo, bvh = data.geometry, spec.bvh
    tabs = (geo, data.node_lo, data.node_hi, bvh)
    hit = PT.trace_closest(o, d, m, *tabs)
    walk_ms, walk = cuda_call(lambda: PT.closest_bvh_walk_ref(o, d, m, *tabs))
    bits = lambda h: [h.tri] + [x.view(torch.int32) for x in (h.t, h.u, h.v)]
    same = [torch.equal(a, b) for a, b in zip(bits(hit), bits(walk))]
    so, sd, sm, _ = _strided(args, CHECK_STRIDE)
    sub = PT.trace_closest(so, sd, sm, *tabs)
    plain_ms, ref = cuda_call(lambda: PT.closest_packet_ref(so, sd, sm,
                                                            *tabs))
    brute = PT.trace_closest_bruteforce(so, sd, sm, geo)
    log(f"  {name}: {int(m.sum())} live rays ({int(walk.found.sum())} hits)")
    log(f"    vs the walking plain version (every ray): slot, t, u, v "
        f"bit-equal {same}")
    assert all(same), f"{name}: not bit-equal to the walking plain version"
    _, _, err = bvh_gate(f"vs plain packet (every {CHECK_STRIDE}th)", so,
                         sd, sm, sub.t, sub.tri, ref.t, ref.tri, data,
                         bvh.global_base)
    uv_same = bool(((sub.u == ref.u) & (sub.v == ref.v))[
        sm & (sub.tri == ref.tri)].all())
    assert uv_same, f"{name}: u, v differ from the plain version's"
    bvh_gate(f"vs brute force (every {CHECK_STRIDE}th)", so, sd, sm, sub.t,
             sub.tri, brute.t, brute.tri, data, bvh.global_base)
    cluster = TC.trace_closest(o, d, m, data.sup_planes, data.clu_planes,
                               data.tri_planes, bvh, seed)
    k_name = "K1" if TC._use_flat(bvh) else "K3"
    bvh_gate(f"vs {k_name} (every ray)", o, d, m, hit.t, hit.tri,
             mt_t(o, d, geo, cluster.tri), cluster.tri, data,
             bvh.global_base, cross=True)
    ms = cuda_ms(lambda: PT.trace_closest(o, d, m, *tabs), 5)
    k_ms = cuda_ms(lambda: TC.trace_closest(o, d, m, data.sup_planes,
                                            data.clu_planes, data.tri_planes,
                                            bvh, seed), 5)
    bnd = bound(*bvh_work(o, d, m, data, spec, t_final=hit.t))
    log(f"    closest_bvh_kernel {ms:.3f} ms{_was(before)} ({k_name} "
        f"{k_ms:.3f} ms on the same pass), bound {bnd[0]:.4f} ms ({bnd[1]}, "
        f"{bnd[0] / ms:.1%} of it); walking plain version {walk_ms:.3f} ms; "
        f"plain packet walk {plain_ms:.3f} ms on the {int(sm.shape[0])} "
        f"strided rays")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bnd,
            "k_ms": k_ms, "plain_rays": int(sm.shape[0]),
            "plain_walk_ms": walk_ms}


def check_bvh_any(name, args, data, spec, before=None):
    """any_bvh_kernel on one recorded shadow pass, as
    :func:`check_bvh_closest` (K2 or K4 as the cluster kernel)."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace as PT
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    o, d, mt, m = args
    geo, bvh = data.geometry, spec.bvh
    tabs = (geo, data.node_lo, data.node_hi, bvh)
    occ = PT.trace_any(o, d, mt, m, *tabs)
    walk_ms, walk = cuda_call(lambda: PT.any_bvh_walk_ref(o, d, mt, m,
                                                          *tabs))
    same = torch.equal(occ, walk)
    so, sd, smt, sm = _strided(args, CHECK_STRIDE)
    sub = PT.trace_any(so, sd, smt, sm, *tabs)
    plain_ms, ref = cuda_call(lambda: PT.any_packet_ref(so, sd, smt, sm,
                                                        *tabs))
    brute = PT.trace_any_bruteforce(so, sd, smt, sm, geo)
    log(f"  {name}: {int(m.sum())} live rays ({int(walk.sum())} occluded)")
    log(f"    vs the walking plain version (every ray): flags equal {same}")
    assert same, f"{name}: not bit-equal to the walking plain version"
    strided = (so, sd, smt, sm)
    flags_gate(f"vs plain packet (every {CHECK_STRIDE}th)", strided, sub,
               ref, data, spec)
    flags_gate(f"vs brute force (every {CHECK_STRIDE}th)", strided, sub,
               brute, data, spec)
    cluster = TC.trace_any(o, d, mt, m, data.sup_planes, data.clu_planes,
                           data.tri_planes, bvh)
    k_name = "K2" if TC._use_flat(bvh) else "K4"
    flags_gate(f"vs {k_name} (every ray)", args, occ, cluster, data, spec,
               cross=True)
    ms = cuda_ms(lambda: PT.trace_any(o, d, mt, m, *tabs), 5)
    k_ms = cuda_ms(lambda: TC.trace_any(o, d, mt, m, data.sup_planes,
                                        data.clu_planes, data.tri_planes,
                                        bvh), 5)
    bnd = bound(*bvh_work(o, d, m, data, spec, max_t=mt, occ=occ))
    log(f"    any_bvh_kernel {ms:.3f} ms{_was(before)} ({k_name} {k_ms:.3f} "
        f"ms on the same pass), bound {bnd[0]:.4f} ms ({bnd[1]}, "
        f"{bnd[0] / ms:.1%} of it); walking plain version {walk_ms:.3f} ms; "
        f"plain packet walk {plain_ms:.3f} ms on the {int(sm.shape[0])} "
        f"strided rays")
    return {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound": bnd,
            "k_ms": k_ms, "plain_rays": int(sm.shape[0]),
            "plain_walk_ms": walk_ms}


def bvh_kernels():
    """Phase 15 (a): the two BVH kernels on coatball's and dragon's recorded
    primary and bounce-1 passes.  Returns {kernel: [per-pass result]},
    dragon's primary pass first."""
    import torch

    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    assert_bvh_no_spill()
    out = {"closest": [], "any": []}
    for scene, (w, h) in (("dragon", DRAGON), ("coatball", COATBALL)):
        r = Renderer(get_scene(scene, w, h), RenderConfig(width=w, height=h),
                     device="cuda")
        calls = record_passes(r)
        for b in (0, 1):
            i = len(out["closest"])
            out["closest"].append(check_bvh_closest(
                f"{scene} {w}x{h} closest bounce {b}", calls["closest"][b],
                r.data, r.spec, ONE_THREAD_MS["BVH closest"][i]))
            out["any"].append(check_bvh_any(
                f"{scene} {w}x{h} any bounce {b}", calls["any"][b], r.data,
                r.spec, ONE_THREAD_MS["BVH any"][i]))
        del calls, r
        torch.cuda.empty_cache()
    return out


def bvh_main_path(card, size):
    """Phase 15 (b): the JAX CLI's GPU path, dragon with ``tracer="bvh"``
    under ``compaction=True`` and ``False`` beside ``tracer="cuda"``, in
    turns; each bvh image against the cuda image at the golden gate.
    Returns the BVH kernels' launches over the bvh configs' runs (the
    warm-up renders capture the graphs that the timed renders replay)."""
    import torch

    from metal_raytracing_tpu_torch.io.image import rmse
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    w, h = size
    scene = get_scene("dragon", w, h)
    rs = [Renderer(scene, RenderConfig(width=w, height=h, **kw),
                   device="cuda") for _, kw in BVH_CONFIGS]
    launches = {"closest_bvh": 0, "any_bvh": 0}
    runs = []
    for r in rs:
        # warm-up: the timed renders' steps, so their graphs are captured
        TC.reset_launch_counts()
        r.render(ROUND_SAMPLES)
        runs.append(launch_counts())
        if r.tracer == "bvh":
            for k in launches:
                launches[k] += runs[-1][k]
    torch.cuda.synchronize()
    ms = {label: [] for label, _ in BVH_CONFIGS}
    for _ in range(ROUNDS):
        for (label, _), r in zip(BVH_CONFIGS, rs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(ROUND_SAMPLES)
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) / ROUND_SAMPLES * 1e3)
    pers, notes = [], []
    for (label, _), r, run in zip(BVH_CONFIGS, rs, runs):
        counts, note = graphed_run(label, r, run)
        pers.append(counts)
        if r.tracer == "bvh":
            notes.append(note)
        cluster = sum(v for k, v in counts.items() if not k.endswith("_bvh"))
        if r.tracer == "bvh":
            assert counts["closest_bvh"] == counts["any_bvh"] == 3, counts
            assert cluster == 0, (label, counts)
        else:
            assert counts["closest_bvh"] == counts["any_bvh"] == 0
            assert counts["closest_hier"] == 3, counts
    # The two bvh configs trace each ray alike (the kernels walk per ray),
    # so their images agree at the golden gate.  Against the cuda image
    # only the rays whose two winners tie differ (phase 15 (a): the floor
    # contact, the packed key's seed against the exact walk's ulp-nearer
    # cluster hit), but such a ray takes another path and moves its pixel
    # by up to its whole radiance over the sample count: the RMSE holds,
    # and the pixels beyond the golden max stay under 0.1%.
    ref = rs[0].image
    bvh_ref = rs[1].image
    for (label, _), r, per in zip(BVH_CONFIGS, rs, pers):
        img = r.image
        assert img.shape == (h, w, 3) and bool(np.isfinite(img).all())
        assert float(img.min()) >= 0.0 and float(img.max()) > 0.01
        err = rmse(img, ref)
        worst = float(np.abs(img - ref).max())
        over = float((np.abs(img - ref).max(axis=-1) >= GOLDEN_MAX).mean())
        b_err = rmse(img, bvh_ref)
        b_worst = float(np.abs(img - bvh_ref).max())
        prof = checked_profile(label, r, max(r.graphs), per)
        dev = prof.device_ms_per_sample
        kern = {k: v / prof.samples for name, v, _ in prof.kernels
                for k in ("closest_bvh_kernel", "any_bvh_kernel",
                          "closest_hier_kernel", "any_hier_kernel")
                if k in name}
        log(f"  dragon {w}x{h} {label}: " + " / ".join(
            f"{x:.3f}" for x in ms[label]) + f" ms/sample; device {dev:.3f} "
            f"ms/sample ({prof.launches // prof.samples} kernels/sample; "
            + ", ".join(f"{k} {v:.3f}" for k, v in kern.items())
            + f" ms/sample); idle {1 - dev / min(ms[label]):.3f} of the "
            f"fastest round; after {r.total_samples - prof.samples} samples: "
            f"image vs "
            f"cuda RMSE {err:.3e} (gate < {IMAGE_RMSE}), max {worst:.3e}, "
            f"{over:.2e} of the pixels >= {GOLDEN_MAX} (gate < "
            f"{1 - MIN_MATCH:.0e}); vs bvh compaction=True RMSE "
            f"{b_err:.3e} max {b_worst:.3e} (gate < {IMAGE_RMSE}, < "
            f"{GOLDEN_MAX}); on {card}")
        assert err < IMAGE_RMSE and over < 1 - MIN_MATCH, (label, err, over)
        if r.tracer == "bvh":
            assert b_err < IMAGE_RMSE and b_worst < GOLDEN_MAX, (label, b_err)
    del rs
    torch.cuda.empty_cache()
    return launches, "the bvh configs' runs, each " + " / ".join(notes)


def bvh_cross_check(size):
    """Phase 15 (c): one sample's image through the BVH kernels equal to
    its image through the walking plain versions, and against the image
    through the plain packet versions, on the card."""
    import torch

    from metal_raytracing_tpu_torch import renderer as R
    from metal_raytracing_tpu_torch.io.image import rmse
    from metal_raytracing_tpu_torch.ops import trace as PT
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    w, h = size
    cfg = RenderConfig(width=w, height=h, tracer="bvh", compaction=True)
    r = R.Renderer(get_scene("dragon", w, h), cfg, device="cuda")
    img = r.render(1)
    tabs = (r.data.geometry, r.data.node_lo, r.data.node_hi, r.spec.bvh)
    kern, _ = R.render_sample(r.data, r.spec, cfg, r.offsets, 0, "bvh")
    before = launch_counts()
    walk, _ = R.render_sample(
        r.data, r.spec, cfg, r.offsets, 0, "bvh",
        (lambda o, d, m, seed=None, seed_base=None: PT.closest_bvh_walk_ref(
            o, d, m, *tabs),
         lambda o, d, mt, m: PT.any_bvh_walk_ref(o, d, mt, m, *tabs)))
    same = torch.equal(kern, walk)
    log(f"  dragon {w}x{h} 1 spp bvh compaction=True: kernels' sample equal "
        f"to the walking plain versions' {same}")
    assert same, "the kernels' sample differs from the walking versions'"
    plain, _ = R.render_sample(
        r.data, r.spec, cfg, r.offsets, 0, "bvh",
        (lambda o, d, m, seed=None, seed_base=None: PT.closest_packet_ref(
            o, d, m, *tabs, cfg.ray_block),
         lambda o, d, mt, m: PT.any_packet_ref(o, d, mt, m, *tabs,
                                               cfg.ray_block)))
    assert launch_counts() == before  # the plain run launched no kernel
    plain = plain.cpu().numpy()
    err = rmse(img, plain)
    log(f"  dragon {w}x{h} 1 spp bvh compaction=True: RMSE kernels vs plain "
        f"packet walk {err:.3e} (gate < {IMAGE_RMSE}), max "
        f"{float(np.abs(img - plain).max()):.3e}")
    assert err < IMAGE_RMSE, err


# Phase 16's builds: (label, RenderConfig keywords), the default first.
BUILDS = (
    ("sah_free", {}),
    ("sah", dict(bvh_builder="sah")),
    ("median", dict(bvh_builder="median")),
    ("morton", dict(bvh_builder="morton")),
    ("sah_chunk", dict(bvh_builder="sah_chunk")),
    ("ploc", dict(bvh_builder="ploc")),
    ("sah_free presplit 0.3", dict(bvh_presplit=0.3)),
)
# Every BUILD_STRIDE-th ray of a pass is held against the walking plain
# versions (a ploc pass walks thousands of clusters a warp).  The bounds of
# the wide kernels count the operations on two samples of every
# BOUND_STRIDE-th ray, at offsets 0 and BOUND_STRIDE // 2 (a stride prime to
# the image width, so that a sample is not a set of fixed columns), each
# scaled by N / its rays; the bound takes their mean and the log prints
# their spread.
BUILD_STRIDE = {"dragon": 16, "coatball": 4}
BOUND_STRIDE = 61
BUILD_SAMPLES = 7  # samples of each build's image, held against sah_free's


def _same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def check_options(name, calls, data, spec, stride):
    """Phase 16: every recorded closest and any-hit pass of one sample
    through the kernels with ``count_visits`` and, on a build that marks
    ``partial_clusters``, with and without ``counts``: the results bit-equal
    to the kernels without options on every ray, and results and visits
    equal to the walking plain versions (with the same counts) on every
    ``stride``-th ray.  Returns each option set's ms on the primary pass
    ({"off", "visits", "visits+counts"} for closest and any)."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    bvh = spec.bvh
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, bvh)
    cset = (None, data.clu_counts) if bvh.partial_clusters else (None,)
    ms = {}
    for kind in ("closest", "any"):
        for b, args in enumerate(calls[kind]):
            sl = _strided(args, stride)
            if kind == "closest":
                o, d, m, seed = args
                plain = lambda **kw: TC.trace_closest(o, d, m, *tabs, seed,
                                                      **kw)
            else:
                o, d, mt, m = args
                plain = lambda **kw: TC.trace_any(o, d, mt, m, *tabs, **kw)
            ref = plain()
            ref = (ref.t, ref.tri) if kind == "closest" else (ref,)
            line = []
            for cnt in cset:
                res, vis = plain(count_visits=True, counts=cnt)
                got = (res.t, res.tri) if kind == "closest" else (res,)
                assert all(_same_bits(x, y) for x, y in zip(got, ref)), (
                    name, kind, b, "options changed the result")
                if kind == "closest":
                    w = TC.closest_walk_ref(*sl[:3], *tabs, sl[3],
                                            counts=TC.active_counts(bvh, cnt))
                else:
                    w = TC.any_walk_ref(*sl, *tabs,
                                        counts=TC.active_counts(bvh, cnt))
                got_s = tuple(x[::stride] for x in got) + (vis[::stride],)
                assert all(_same_bits(x, y) for x, y in zip(got_s, w)), (
                    name, kind, b, "not equal to the walking plain version")
                tag = "visits" if cnt is None else "visits+counts"
                if b == 0:
                    ms[f"{kind} off"] = cuda_ms(plain, 5)
                    ms[f"{kind} {tag}"] = cuda_ms(
                        lambda: plain(count_visits=True, counts=cnt), 5)
                live = m.nonzero()[:, 0]
                v = vis[live].float()
                line.append(f"{tag}: bit-equal, visits equal on "
                            f"{int(sl[2 if kind == 'closest' else 3].sum())}"
                            f" strided live rays, mean {float(v.mean()):.3f}"
                            f" max {int(v.max()) if v.numel() else 0}")
            log(f"    {name} {kind} bounce {b} ({int(m.sum())} live): "
                + "; ".join(line))
    return ms


def _sampled_ops(work, n, args):
    """Operations of a whole pass of ``n`` rays from two strided samples of
    ``args`` (BOUND_STRIDE, offsets 0 and BOUND_STRIDE // 2):
    ``work(*sample)`` gives (bytes, operations) of one sample.  Returns
    (the samples' bytes at offset 0, the rays of that sample, the mean of
    the two scaled operation counts, their spread over the mean)."""
    scaled = []
    for off in (0, BOUND_STRIDE // 2):
        sample = tuple(a[off::BOUND_STRIDE].contiguous() for a in args)
        nb, ops = work(*sample)
        scaled.append(ops * n / sample[0].shape[0])
        if off == 0:
            nb0, rays0 = nb, sample[0].shape[0]
    mean = sum(scaled) / 2
    return nb0, rays0, mean, abs(scaled[1] - scaled[0]) / max(mean, 1.0)


def wide_kernel_rows(calls, data, spec, counts):
    """The kernels line's rows of K3/K4 on wide supers: the primary
    passes of dragon's ploc build, with the walking plain versions timed
    on every BUILD_STRIDE-th ray and the bound's operations counted on two
    strided samples (:func:`_sampled_ops`)."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    bvh = spec.bvh
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, bvh)
    st = BUILD_STRIDE["dragon"]
    rows = {}
    o, d, m, seed = calls["closest"][0]
    n = o.shape[0]
    hit = TC.trace_closest(o, d, m, *tabs, seed)
    ms = cuda_ms(lambda: TC.trace_closest(o, d, m, *tabs, seed), 5)
    sl = _strided((o, d, m, seed), st)
    plain_ms, _ = cuda_call(lambda: TC.closest_walk_ref(*sl[:3], *tabs,
                                                        sl[3]))
    nb, rays, ops, spread = _sampled_ops(
        lambda so, sd, sm, st_: trace_work(so, sd, sm, data, spec, True,
                                           t_final=st_),
        n, (o, d, m, hit.t))
    nb += (n - rays) * (12 + 12 + 1 + 4 + 4 + 4)
    rows["closest"] = {"ms": ms, "plain_ms": plain_ms,
                       "plain_rays": int(sl[0].shape[0]),
                       "bound": bound(nb, ops), "spread": spread,
                       "launches": counts["closest_hier"], "err": 0.0}
    o, d, mt, m = calls["any"][0]
    occ = TC.trace_any(o, d, mt, m, *tabs)
    ms = cuda_ms(lambda: TC.trace_any(o, d, mt, m, *tabs), 5)
    sl = _strided((o, d, mt, m), st)
    plain_ms, _ = cuda_call(lambda: TC.any_walk_ref(*sl, *tabs))
    nb, rays, ops, spread = _sampled_ops(
        lambda so, sd, smt, sm, socc: trace_work(so, sd, sm, data, spec,
                                                 True, max_t=smt, occ=socc),
        n, (o, d, mt, m, occ))
    nb += (n - rays) * (12 + 12 + 4 + 1 + 1)
    rows["any"] = {"ms": ms, "plain_ms": plain_ms,
                   "plain_rays": int(sl[0].shape[0]),
                   "bound": bound(nb, ops), "spread": spread,
                   "launches": counts["any_hier"], "err": 0.0}
    for k, r in rows.items():
        log(f"  K{3 if k == 'closest' else 4} on wide supers (S = "
            f"{data.clu_planes.shape[1]}), dragon ploc primary pass: "
            f"{r['ms']:.3f} ms, walking plain {r['plain_ms']:.3f} ms on "
            f"{r['plain_rays']} rays, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}; operations from one ray in {BOUND_STRIDE} "
            f"at two offsets, scaled to all rays, spread "
            f"{r['spread']:.4f})")
    return rows


def gate_image(label, img, ref, card, rmse_gate=IMAGE_RMSE):
    """Phase 16's image gate against sah_free's: RMSE, and the share of
    pixels beyond the golden max under 0.1% (the two builds break contact
    ties apart, as phase 15's tracers do)."""
    from metal_raytracing_tpu_torch.io.image import rmse

    assert bool(np.isfinite(img).all()) and float(img.max()) > 0.01, label
    err = rmse(img, ref)
    over = float((np.abs(img - ref).max(axis=-1) >= GOLDEN_MAX).mean())
    log(f"    {label}: RMSE {err:.3e} (gate < {rmse_gate}), max "
        f"{float(np.abs(img - ref).max()):.3e}, {over:.2e} of the pixels >= "
        f"{GOLDEN_MAX} (gate < {1 - MIN_MATCH:.0e}); on {card}")
    assert err < rmse_gate and over < 1 - MIN_MATCH, (label, err, over)


def with_config(renderer, **kw):
    """A renderer over the same build with other config fields, and with
    state and CUDA graphs of its own (a graph reads and writes its
    renderer's state in place)."""
    from metal_raytracing_tpu_torch.renderer import graphs_apply

    r = copy.copy(renderer)
    r.cfg = dataclasses.replace(renderer.cfg, **kw)
    r.graphed = graphs_apply(r.cfg, r.device, r.tracer)
    r.drop_graphs()
    r.accum, r.ray_totals, r.frame = (
        x.clone() for x in (r.accum, r.ray_totals, r.frame))
    r.reset()
    return r


def builders(card):
    """Phase 16: the cluster builders and the traversal telemetry.  Returns
    (the kernels line's wide rows, with K3/K4's launches in the ploc
    build's render of ``BUILD_SAMPLES`` samples: its warm-up sample and
    the captures of its graphs; each K's option ms on dragon's sah_free
    primary pass; K6's option ms)."""
    import torch

    from metal_raytracing_tpu_torch import renderer as R
    from metal_raytracing_tpu_torch.ops import rank_cuda as RK
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig
    from metal_raytracing_tpu_torch.utils import profiling
    from metal_raytracing_tpu_torch.utils.metrics import (profile_renderer,
                                                          visit_percentiles,
                                                          wavefront_stats)

    kept = {}
    option_ms = {}
    wide = None
    for name, (w, h) in (("dragon", DRAGON), ("coatball", COATBALL)):
        log(f"  {name} {w}x{h}: builds, each build's passes with the "
            f"options, its image after {BUILD_SAMPLES} samples vs sah_free's")
        ref = None
        for label, kw in BUILDS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = R.Renderer(get_scene(name, w, h),
                           RenderConfig(width=w, height=h, **kw),
                           device="cuda")
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            bvh = r.spec.bvh
            s_per, ns = TC.super_layout(bvh)
            log(f"   {label}: build {sec:.2f} s, {bvh.num_clusters} clusters "
                f"({bvh.num_triangles} triangles), S {s_per} x {ns} supers, "
                f"flat {TC._use_flat(bvh)}, partial_clusters "
                f"{bvh.partial_clusters}")
            calls = record_passes(r)
            ms = check_options(f"{name} {label}", calls, r.data, r.spec,
                               BUILD_STRIDE[name])
            if label in ("sah_free", "sah_chunk"):  # the kernels line's
                pre = "" if label == "sah_free" else f"{label} "
                option_ms.setdefault(name, {}).update({
                    k.replace(" ", f" {pre}", 1): v for k, v in ms.items()})
            log(f"    primary-pass ms: " + ", ".join(
                f"{k} {v:.3f}" for k, v in ms.items()))
            TC.reset_launch_counts()
            img = r.render(BUILD_SAMPLES)  # captures the build's graphs
            if ref is None:
                ref = img
            else:
                gate_image(f"{name} {label} vs sah_free", img, ref, card)
            if name == "dragon" and label == "ploc":
                ploc_calls = calls
                ploc_counts = launch_counts()
                _, ploc_note = graphed_run("dragon ploc", r, ploc_counts)
            del calls
            if name == "dragon":
                kept[label] = r
            else:
                del r
            torch.cuda.empty_cache()

    w, h = DRAGON
    base = kept["sah_free"]
    ploc = kept["ploc"]
    # K6 on the sorted bounce passes: on sah_free's build with visits
    # against K6 without; on sah_chunk's (partly full clusters) with visits,
    # with counts off and on; each against the walking plain version with
    # the same counts, key, base and visits on every ray
    k6_ms = {}
    for label in ("sah_free", "sah_chunk"):
        r = kept[label]
        pre = "" if label == "sah_free" else f"{label} "
        bvh = r.spec.bvh
        cset = (None, r.data.clu_counts) if bvh.partial_clusters else (None,)
        calls = record_passes(with_config(r, **SLICE))
        assert calls["rank"], (label, "the rank walk did not run")
        for b, (o, d, m, keys, seed) in enumerate(calls["rank"], start=1):
            args = (o, d, m, list(keys[:2]), r.data.tri_planes, bvh, seed)
            key, kbase = RK.trace_closest_rank(*args)
            line = []
            for cnt in cset:
                got = RK.trace_closest_rank(*args, count_visits=True,
                                            counts=cnt)
                wk = RK.closest_rank_walk_ref(
                    *args, counts=TC.active_counts(bvh, cnt))
                assert torch.equal(got[0], key) and torch.equal(
                    got[1], kbase), (label, b, "options changed K6")
                assert all(torch.equal(x, y) for x, y in zip(got, wk[:3])), (
                    label, b, cnt is not None, "K6 vs the walking plain")
                tag = "visits" if cnt is None else "visits+counts"
                if b == 1:
                    k6_ms[pre + tag] = cuda_ms(
                        lambda: RK.trace_closest_rank(
                            *args, count_visits=True, counts=cnt), 10)
                line.append(f"{tag}: key, base and visits equal to the "
                            f"walking plain version's on every ray (mean "
                            f"{float(got[2][m].float().mean()):.3f} a live "
                            f"ray)")
            if b == 1:
                k6_ms[pre + "off"] = cuda_ms(
                    lambda: RK.trace_closest_rank(*args), 10)
            log(f"    K6 {label} sorted bounce {b} ({int(m.sum())} live): "
                + "; ".join(line))
        del calls
    log("    K6 sorted bounce 1 ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in k6_ms.items()))

    # the 4,095-cluster fallback: ploc under compaction=True and False
    nc_tot = ploc.data.clu_planes.shape[0] * ploc.data.clu_planes.shape[1]
    imgs = []
    for comp in (False, True):
        cfg = dataclasses.replace(ploc.cfg, compaction=comp)
        acc = None
        for i in range(2):
            img, _ = R.render_sample(ploc.data, ploc.spec, cfg, ploc.offsets,
                                     i, "cuda")
            acc = img if acc is None else R.accumulate(acc, img, i)
        imgs.append(acc.cpu().numpy())
    from metal_raytracing_tpu_torch.io.image import rmse

    err = rmse(imgs[1], imgs[0])
    log(f"  the fallback above 4,095 padded clusters: dragon ploc "
        f"({nc_tot} padded) compaction=True vs False, 2 samples: RMSE "
        f"{err:.3e} (gate < {SAME_IMAGE_RMSE})")
    assert nc_tot > 4095 and err < SAME_IMAGE_RMSE, err

    # feedback: 2 samples, refine, 2 more, against the unrefined render
    fb = R.Renderer(get_scene("dragon", w, h),
                    RenderConfig(width=w, height=h), device="cuda")
    before = profile_renderer(fb, 2)
    t0 = time.perf_counter()
    ok = fb.refine()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    after = profile_renderer(fb, 2)
    assert ok
    acc = None
    for i in range(4):
        img, _ = R.render_sample(base.data, base.spec, fb.cfg, fb.offsets, i,
                                 "cuda")
        acc = img if acc is None else R.accumulate(acc, img, i)
    log(f"  feedback: refine() {ref_s:.2f} s, {base.spec.bvh.num_clusters} "
        f"-> {fb.spec.bvh.num_clusters} clusters (sah_rays, partial "
        f"{fb.spec.bvh.partial_clusters}); device "
        f"{before.device_ms_per_sample:.3f} ms/sample before, "
        f"{after.device_ms_per_sample:.3f} after; on {card}")
    gate_image("refined vs unrefined, 4 samples", fb.image,
               acc.cpu().numpy(), card)
    del fb

    # telemetry and the profiler's scopes
    tcfg = dataclasses.replace(base.cfg, telemetry=True)
    _, stats = R.render_sample(base.data, base.spec, tcfg, base.offsets, 0,
                               "cuda")
    log(f"  visit_percentiles: {visit_percentiles(stats, w * h)}")
    wave = wavefront_stats(base.data, base.spec, base.cfg, base.offsets,
                           "cuda")
    log(f"  wavefront_stats: {wave}")
    trace_dir = "build/phase16_trace"
    with profiling.trace(trace_dir):  # compaction=True: every layer runs
        R.render_sample(base.data, base.spec,
                        dataclasses.replace(base.cfg, compaction=True),
                        base.offsets, 0, "cuda")
    with open(f"{trace_dir}/{profiling.TRACE_FILE}") as f:
        text = f.read()
    missing = [sc for sc in profiling.SCOPES if f'"{sc}"' not in text]
    log(f"  profiling.trace wrote {len(text)} bytes to {trace_dir}/"
        f"{profiling.TRACE_FILE}; scopes present: "
        f"{[sc for sc in profiling.SCOPES if sc not in missing]}")
    assert not missing, missing

    # timing: every build, and sah_chunk / ploc with chunk_skip, in turns
    runs = [(label, r) for label, r in kept.items()] + [
        (f"{label} chunk_skip", with_config(kept[label], chunk_skip=True))
        for label in ("sah_chunk", "ploc")]
    for _, r in runs:
        # warm-up: captures the graphs that the timed renders replay
        r.render(ROUND_SAMPLES)
    torch.cuda.synchronize()
    ms = {label: [] for label, _ in runs}
    for _ in range(ROUNDS):
        for label, r in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(ROUND_SAMPLES)
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) / ROUND_SAMPLES * 1e3)
    per = {}
    for label, r in runs:
        counts = sample_launches(r)  # one eager sample
        per[label] = {k: v for k, v in counts.items() if v}
        assert counts["closest_hier"] == counts["any_hier"] == 3, \
            (label, counts)
    for label, r in runs:
        prof = profile_renderer(r, 2)
        dev = prof.device_ms_per_sample
        kern = {k: v / prof.samples for name, v, _ in prof.kernels
                for k in ("closest_hier_kernel", "any_hier_kernel")
                if k in name}
        log(f"  dragon {w}x{h} {label}: " + " / ".join(
            f"{x:.3f}" for x in ms[label]) + f" ms/sample; device {dev:.3f} "
            f"ms/sample ({prof.launches // prof.samples} kernels/sample; "
            + ", ".join(f"{k} {v:.3f}" for k, v in kern.items())
            + f" ms/sample); idle {1 - dev / min(ms[label]):.3f} of the "
            f"fastest round; launches/sample {per[label]}; on {card}")
    wide = wide_kernel_rows(ploc_calls, ploc.data, ploc.spec, ploc_counts)
    for row in wide.values():
        row["launches_of"] = f"the ploc build's run: {ploc_note}"
    del kept, runs, base, ploc, ploc_calls
    torch.cuda.empty_cache()
    return wide, option_ms, k6_ms


# ---------------------------------------------------------------------------
# Phase 17: K3's baked-origin primary pass (bake_primary)
# ---------------------------------------------------------------------------

BAKE_SAMPLES = 4  # samples of the baked and the unbaked image


def _bake_checks(label, renderer):
    """The baked K3 on the recorded primary pass of ``renderer`` (built with
    ``bake_primary=True``): bit-equal, visits included, to the walking plain
    version on every ray with ``counts`` off and, on a build that marks
    ``partial_clusters``, on; the same bits without visits; against the
    unbaked K3 on the same rays, near-ties only.  Returns (hit, the pass's
    args, the unbaked and baked tables, the walking plain ms)."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    data, spec = renderer.data, renderer.spec
    bvh = spec.bvh
    calls = record_passes(renderer)
    assert calls["baked"][0] and not any(calls["baked"][1:]), calls["baked"]
    o, d, m, seed = calls["closest"][0]
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, bvh)
    btabs = (*renderer.baked, bvh)
    cset = (None, data.clu_counts) if bvh.partial_clusters else (None,)
    ref0 = TC.trace_closest(o, d, m, *btabs, seed, baked_origin=True)
    walk_ms = None
    for cnt in cset:
        hit, vis = TC.trace_closest(o, d, m, *btabs, seed, baked_origin=True,
                                    count_visits=True, counts=cnt)
        ms, (t_ref, tri_ref, v_ref) = cuda_call(lambda: TC.closest_walk_ref(
            o, d, m, *btabs, seed, counts=TC.active_counts(bvh, cnt),
            baked=True))
        walk_ms = walk_ms if walk_ms is not None else ms
        same = (_same_bits(hit.t, t_ref) and _same_bits(hit.tri, tri_ref)
                and _same_bits(vis, v_ref))
        opts = _same_bits(hit.t, ref0.t) and _same_bits(hit.tri, ref0.tri)
        tag = "visits" if cnt is None else "visits+counts"
        log(f"  {label} baked K3 ({tag}) vs the walking plain version, every "
            f"ray of {int(m.sum())} live: bit-equal {same} (visits a live "
            f"ray {float(vis[m].float().mean()):.3f}, max {int(vis.max())}); "
            f"the same bits without options {opts}; walking plain "
            f"{ms:.3f} ms")
        assert same and opts, (label, tag)
    unbaked = TC.trace_closest(o, d, m, *tabs, seed)
    baked_gate(label, o, d, m, ref0, unbaked, data)
    return ref0, (o, d, m, seed), tabs, btabs, walk_ms


def baked_gate(label, o, d, m, hit, ref, data):
    """The baked K3's ids (``hit``) against the unbaked K3's (``ref``) on
    the live rays ``m``: equal on >= 99.9% of them, t within 2^-13
    relative where they agree, and every mismatch a near-tie (both winners'
    exact t within 2^-13 relative) or an edge hit: the baked test takes u
    and v as t (U.d) + uw', the unbaked one as U.(o + t d) + uw, so the two
    round apart by about an ulp, and a hit that lies on an edge may be in
    under one and out under the other.  The nearer winner of such a ray
    lies within EDGE_REL of an edge of its triangle (the plane rows'
    barycentrics, over |o| + t)."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    bad = m & (hit.tri != ref.tri)
    both = bad & (hit.tri >= 0) & (ref.tri >= 0)
    rel = torch.zeros_like(hit.t)
    planes = data.tri_planes
    if bool(both.any()):
        ta, _, _ = TC.recompute_tuv(o[both], d[both],
                                    planes[:, hit.tri[both].long()].T)
        tb, _, _ = TC.recompute_tuv(o[both], d[both],
                                    planes[:, ref.tri[both].long()].T)
        rel[both] = (ta - tb).abs() / tb.abs()
    tie = both & (rel <= NEAR_TIE_REL)
    edge = bad & ~tie
    worst_edge = 0.0
    if bool(edge.any()):
        nearer = torch.where(hit.t <= ref.t, hit.tri, ref.tri)[edge]
        plane_margin = margins(o[edge], d[edge], data, nearer.clamp(min=0))[1]
        worst_edge = float(plane_margin.abs().max())
        for k, i in enumerate(edge.nonzero()[:8, 0].tolist()):
            log(f"    ray {i}: baked t {float(hit.t[i]):.9g} slot "
                f"{int(hit.tri[i])} / unbaked t {float(ref.t[i]):.9g} slot "
                f"{int(ref.tri[i])}; the nearer's edge distance "
                f"{float(plane_margin[k]):.3e}")
        assert bool((nearer >= 0).all()) and worst_edge <= EDGE_REL, (
            f"{label}: {int(edge.sum())} mismatches, neither near-ties nor "
            f"edge hits (worst edge distance {worst_edge:.3e})")
    agree = m & (hit.tri == ref.tri) & (hit.tri >= 0)
    t_rel = float(((hit.t - ref.t).abs() / ref.t.abs())[agree].max())
    n_live = max(int(m.sum()), 1)
    share = 1.0 - int(bad.sum()) / n_live
    log(f"  {label} baked vs unbaked K3: ids equal {share:.6f}: "
        f"{int(tie.sum())} near-ties (worst exact-t rel "
        f"{float(rel[tie].max()) if bool(tie.any()) else 0.0:.3e}), "
        f"{int(edge.sum())} edge hits (nearer winner's edge distance over "
        f"|o| + t at most {worst_edge:.3e}, gate {EDGE_REL:.3e}); chopped t "
        f"rel max {t_rel:.3e} on equal ids (gate {NEAR_TIE_REL:.3e})")
    assert share >= MIN_MATCH and t_rel <= NEAR_TIE_REL, (label, share,
                                                           t_rel)


def bake_phase(card):
    """Phase 17: dragon 1024x1024 with ``bake_primary=True``.  Returns the
    kernels-line row of the baked K3."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    w, h = DRAGON
    chunk = Renderer(get_scene("dragon", w, h),
                     RenderConfig(width=w, height=h, bake_primary=True,
                                  bvh_builder="sah_chunk"), device="cuda")
    assert chunk.spec.bvh.partial_clusters
    _bake_checks("sah_chunk", chunk)
    del chunk
    r = Renderer(get_scene("dragon", w, h),
                 RenderConfig(width=w, height=h, bake_primary=True),
                 device="cuda")
    hit, (o, d, m, seed), tabs, btabs, walk_ms = _bake_checks("sah_free", r)
    # the primary pass, unbaked and baked, in turns
    plain = lambda: TC.trace_closest(o, d, m, *tabs, seed)
    baked = lambda: TC.trace_closest(o, d, m, *btabs, seed,
                                     baked_origin=True)
    turns = [cuda_ms(f, 10) for f in (plain, baked, baked, plain)]
    bnd = bound(*trace_work(o, d, m, r.data, r.spec, True, t_final=hit.t,
                            baked=True))
    bnd_u = bound(*trace_work(o, d, m, r.data, r.spec, True, t_final=hit.t))
    log(f"  primary pass in turns (unbaked, baked, baked, unbaked): "
        f"{', '.join(f'{t:.3f}' for t in turns)} ms; baked bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}), unbaked {bnd_u[0]:.4f} ms; on {card}")
    # the main path, then the same build unbaked (config A), same samples
    _, samples, counts, per, note = main_path(
        r, card, "dragon bake_primary=True", DRAGON)
    assert counts["closest_hier_baked"] > 0, counts
    assert per["closest_hier_baked"] == 1, per
    assert per["closest_hier"] == 2, per
    img = r.image
    a = with_config(r, bake_primary=False)
    a.render(samples + 2)  # as many samples as the baked image holds
    gate_image("bake_primary vs A", img, a.image, card)
    return {"name": "closest_hier_kernel baked", "route": "cuda",
            "source": CSRC + "trace_hier.cu",
            "replaces": f"{PALLAS}:1139", "form": "baked=True",
            "launches": counts["closest_hier_baked"],
            "launches_of": f"the main path's run: {note}", "max_abs_err": 0.0,
            "ms": (turns[1] + turns[2]) / 2, "plain_ms": walk_ms,
            "plain_kind": "walking", "unbaked_ms": (turns[0] + turns[3]) / 2,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": LIBRARY}


# ---------------------------------------------------------------------------
# Phase 18: spp / tile sharding on torch.distributed, several ranks a card
# ---------------------------------------------------------------------------

SHARD_SAMPLES = 4  # samples of each sharded image (whole steps of 1, 2, 4)
SHARD_TIMED = 3  # steps of each timed turn


SHARD_DEVICE = "cuda:0"
SHARD_DEADLINE = 240  # seconds a spawn of phase 18 may take


def _shard_rank(rank, world, init, out, backend):
    """One rank of phase 18 on cuda:0 (see :func:`sharding_phase`)."""
    import torch
    import torch.distributed as dist

    from metal_raytracing_tpu_torch.parallel import ShardedRenderer, make_mesh
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    device = SHARD_DEVICE
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            **({"device_id": torch.device(device)}
                               if backend == "nccl" else {}))
    w, h = DRAGON
    scene = get_scene("dragon", w, h)
    cfg = RenderConfig(width=w, height=h)
    results = {}
    meshes = ((("spp", 1, world), ("tile", world, 1))
              + ((("tile", 2, 2),) if world == 4 else ()))
    for mode, tile, spp in meshes:
        sr = ShardedRenderer(scene, cfg, make_mesh(world, tile=tile, spp=spp),
                             mode=mode, device=device)
        img = sr.render(SHARD_SAMPLES)
        if rank == 0:
            np.save(f"{out}/{mode}_{tile}x{spp}.npy", img)
    # ms per step, in turns: rank 0 alone (the others wait), then the whole
    # mesh in spp mode, then a mesh of two, and back
    timed = {}
    solo = Renderer(scene, cfg, device=device) if rank == 0 else None
    spp_all = ShardedRenderer(scene, cfg, make_mesh(world, tile=1, spp=world),
                              mode="spp", device=device)
    pair = make_mesh(2, tile=1, spp=2) if world > 2 else None
    spp_two = (ShardedRenderer(scene, cfg, pair, mode="spp", device=device)
               if pair is not None and pair.coord is not None else None)
    turns = ["solo", "all"] + (["pair", "pair"] if pair else []) + [
        "all", "solo"]
    who = {"solo": solo, "all": spp_all, "pair": spp_two}
    for tag in ["warm"] + turns:
        for r in (solo, spp_all, spp_two) if tag == "warm" else (who[tag],):
            dist.barrier()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            if r is not None:
                # the solo renderer's warm-up takes the timed steps' size,
                # so that its graph is captured before the timed turns
                r.step(SHARD_TIMED if tag != "warm" or r is solo else 1)
                torch.cuda.synchronize(device)
            dist.barrier()
            wall = time.perf_counter() - t0
        if tag != "warm":
            timed.setdefault(tag, []).append(wall)
    # the spp step's collective alone: one all_reduce of an image
    img = torch.zeros((h, w, 3), device=device)
    walls = []
    for _ in range(4):
        dist.barrier()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dist.all_reduce(img, group=spp_all.mesh.spp_group)
        torch.cuda.synchronize(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    if rank == 0:
        results["all_reduce of one image, ms"] = walls[1:]
        samples = {"solo": 1, "all": world, "pair": 2}
        label = {"solo": "one process", "all": f"{world} ranks, spp",
                 "pair": "2 of the ranks, spp"}
        for tag, walls in timed.items():
            results[label[tag]] = {
                "ms_per_step": [x / SHARD_TIMED * 1e3 for x in walls],
                "samples_per_s": [samples[tag] * SHARD_TIMED / x
                                  for x in walls]}
        with open(f"{out}/timing.json", "w") as f:
            json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def sharding_phase(card):
    """Phase 18: ``parallel.ShardedRenderer`` with two and four gloo ranks
    on cuda:0 (NCCL refuses two ranks on one card), spp, tile and 2-D
    meshes, each image against the plain ``Renderer``'s; NCCL at world size
    1; ms a step and aggregate samples/s against one process, in turns.
    The ranks share one card: the aggregate shows how far several host
    processes fill it, not a scaling across cards."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    from metal_raytracing_tpu_torch.io.image import rmse
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    w, h = DRAGON
    ref = Renderer(get_scene("dragon", w, h), RenderConfig(width=w, height=h),
                   device=SHARD_DEVICE).render(SHARD_SAMPLES)
    os.makedirs("build", exist_ok=True)
    for backend, world in (("gloo", 2), ("gloo", 4), ("nccl", 1)):
        out = tempfile.mkdtemp(prefix=f"phase18_{backend}{world}_",
                               dir=os.path.join(os.getcwd(), "build"))
        t0 = time.perf_counter()
        ranks = mp.start_processes(_shard_rank, nprocs=world, join=False,
                                   start_method="spawn",
                                   args=(world, f"file://{out}/rendezvous",
                                         out, backend))
        while not ranks.join(timeout=5):
            if time.perf_counter() - t0 > SHARD_DEADLINE:
                for proc in ranks.processes:
                    proc.kill()
                raise RuntimeError(f"phase 18: {backend} x {world} did not "
                                   f"end in {SHARD_DEADLINE} s")
        log(f"  {backend}, {world} rank(s) on {SHARD_DEVICE}: "
            f"{time.perf_counter() - t0:.1f} s")
        for name in sorted(os.listdir(out)):
            if name.endswith(".npy"):
                img = np.load(os.path.join(out, name))
                err = rmse(img, ref)
                log(f"    {name[:-4]} ({SHARD_SAMPLES} samples) vs the plain "
                    f"Renderer: RMSE {err:.3e} (gate < 1e-5)")
                assert np.isfinite(img).all() and err < 1e-5, (name, err)
        with open(os.path.join(out, "timing.json")) as f:
            timing = json.load(f)
        def fmt(xs, digits=3):
            return ", ".join(f"{x:.{digits}f}" for x in xs)

        reduce_ms = timing.pop("all_reduce of one image, ms")
        log(f"    all_reduce of one {w}x{h}x3 float32 image over {world} "
            f"rank(s): {fmt(reduce_ms)} ms")
        for tag, t in timing.items():
            log(f"    {tag}: ms a step {fmt(t['ms_per_step'])}; samples/s "
                f"{fmt(t['samples_per_s'], 2)}; on {card}")


# ---------------------------------------------------------------------------
# Phase 19: the sort keys on dragon, compaction=True
# ---------------------------------------------------------------------------

# (label, config keywords on top of compaction=True)
SORT_LAYOUTS = (
    ("cluster2", {}),
    ("cluster2 sort_pack_f16", dict(sort_pack_f16=True)),
)
SORT_SAMPLES = 2


def sort_layouts_phase(card):
    """Phase 19: the sorted image, plain and packed, against config A's
    after ``SORT_SAMPLES`` samples (the same image: RMSE < 1e-6; the golden
    gate for ``sort_pack_f16``, which rounds to f16), and its ms a sample
    and device ms a sample (``torch.profiler``, 1 sample)."""
    from metal_raytracing_tpu_torch.io.image import rmse
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig
    from metal_raytracing_tpu_torch.utils.metrics import profile_renderer

    import torch

    w, h = DRAGON
    a = Renderer(get_scene("dragon", w, h), RenderConfig(width=w, height=h),
                 device="cuda")
    a.step(SORT_SAMPLES)
    ref = a.image
    for label, kw in SORT_LAYOUTS:
        r = with_config(a, compaction=True, **kw)
        r.graph(SORT_SAMPLES)  # warm-up and capture, not in the image
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step(SORT_SAMPLES)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / SORT_SAMPLES * 1e3
        img = r.image
        prof = profile_renderer(r, SORT_SAMPLES)
        err = rmse(img, ref)
        gate = IMAGE_RMSE if kw.get("sort_pack_f16") else SAME_IMAGE_RMSE
        log(f"  {label}: RMSE vs A {err:.3e} (gate < {gate}), "
            f"{ms:.3f} ms/sample, device {prof.device_ms_per_sample:.3f} "
            f"ms/sample in {prof.launches // prof.samples} kernels; on {card}")
        assert np.isfinite(img).all() and err < gate, (label, err)
        if kw.get("sort_pack_f16"):
            gate_image(label, img, ref, card)


# ---------------------------------------------------------------------------
# Phase 20: samples_per_dispatch as CUDA graphs
# ---------------------------------------------------------------------------

# (label, scene, size, config keywords): each graphed renderer against an
# eager twin over the same build
DISPATCH_CONFIGS = (
    ("dragon A", "dragon", DRAGON, {}),
    ("dragon bake_primary", "dragon", DRAGON, dict(bake_primary=True)),
    ("dragon D", "dragon", DRAGON, dict(compaction=True,
                                        fused_broadphase=True)),
    ("dragon bvh", "dragon", DRAGON, dict(tracer="bvh")),
    ("coatball", "coatball", COATBALL, {}),
    ("plane_sphere", "plane_sphere", (256, 256), {}),
)
# graphed against eager without the timing: the brute force's chunk loops
# put ~4,800 kernels in a 64x64 sample (~24,000 at 256x256), which the
# profiler takes minutes over
DISPATCH_UNTIMED = (
    ("plane_sphere bruteforce", "plane_sphere", (64, 64),
     dict(tracer="bruteforce")),
)
DISPATCH_ROUNDS = 3
DISPATCH_STEPS = 2  # steps of the renderer's batch a timed turn
DISPATCH_KS = (1, 2, 4)  # graph batches timed in turns (dragon A, coatball)
DISPATCH_K_SAMPLES = 4  # samples a turn of the batch sweep
DISPATCH_PROFILE_STEPS = 2  # steps of the batch a profiled window


def timed_steps(r, steps, k):
    """Wall ms a sample of ``steps`` steps of ``k`` samples, fenced."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        r.step(k)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (steps * k) * 1e3


def capture(r, k):
    """(seconds, reserved bytes gained) of capturing ``r``'s graph of ``k``
    samples (with the warm-up sample where it is the pool's first)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    r.graph(k)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cuda.memory_reserved() - before


def dispatch_config(card, label, name, size, kw, timed=True):
    """One config of phase 20: the graphed renderer against its eager
    twin (without ``timed``, only the sync check, the capture and the
    image).  Returns the graphed path's launch counts (the capture)."""
    import torch

    from metal_raytracing_tpu_torch import renderer as R
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    w, h = size
    g = R.Renderer(get_scene(name, w, h),
                   RenderConfig(width=w, height=h, **kw), device="cuda")
    e = with_config(g)  # the same build, eager
    e.graphed = False
    assert g.graphed, label
    k = g.samples_per_dispatch
    TC.reset_launch_counts()  # the graphed path's run starts here
    cap_s, pool = capture(g, k)
    captured = launch_counts()
    # no host sync in a sample: one eager sample, not folded
    torch.cuda.set_sync_debug_mode("error")
    try:
        R.render_sample(g.data, g.spec, g.cfg, g.offsets, g.frame, g.tracer,
                        baked_tables=g.baked)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    per = sample_launches(g)
    # the capture holds k samples' launches, the warm-up sample one more
    assert captured == {key: (k + 1) * v for key, v in per.items()}, \
        (label, captured, per)
    e.step()
    g.step()
    if not timed:
        same = bool(torch.equal(g.accum, e.accum))
        log(f"  {label} {w}x{h}, batch {k}: no host sync in a sample; image "
            f"after {g.total_samples} samples graph == eager: {same}; first "
            f"capture {cap_s:.3f} s, pool {pool / 2**20:.1f} MiB; on {card}")
        assert same, label
        return captured
    ms = {"graph": [], "eager": []}
    for i in range(DISPATCH_ROUNDS):
        for mode in ("graph", "eager") if i % 2 == 0 else ("eager", "graph"):
            ms[mode].append(timed_steps(g if mode == "graph" else e,
                                        DISPATCH_STEPS, k))
    profs = [(mode, checked_profile(f"{label} {mode}", r, k, per,
                                    DISPATCH_PROFILE_STEPS))
             for mode, r in (("graph", g), ("eager", e))]
    # a window that checked_profile discards and takes again steps its
    # renderer once more: step the other to the same sample count
    for r, other in ((g, e), (e, g)):
        while r.total_samples < other.total_samples:
            r.step()
    same = (bool(torch.equal(g.accum, e.accum))
            and bool(torch.equal(g.ray_totals, e.ray_totals))
            and g.total_samples == e.total_samples)
    # the graph's device time read again after the eager reading, and as
    # the wall of back-to-back graph turns
    profs.append(("graph", checked_profile(f"{label} graph", g, k, per,
                                           DISPATCH_PROFILE_STEPS)))
    b2b = [timed_steps(g, DISPATCH_STEPS, k) for _ in range(2)]
    prof = dict(profs[:2])
    names = {mode: sorted(n for n, _, _ in p.kernels)
             for mode, p in prof.items()}
    img = g.image
    assert img.shape == (h, w, 3) and bool(np.isfinite(img).all())
    assert float(img.max()) > 0.01, label
    diff = sorted(set(names["graph"]) ^ set(names["eager"]))
    # the wide counts are a part of the hierarchical ones
    launches = sum(v for n, v in per.items() if not n.endswith("_wide"))
    log(f"  {label} {w}x{h}, batch {k}: image after {e.total_samples} "
        f"samples graph == eager: {same}; the profiles' kernels by name "
        f"equal: {not diff} {[n[:80] for n in diff[:4]]}; first capture "
        f"{cap_s:.3f} s (warm-up sample + capture), pool {pool / 2**20:.1f} "
        f"MiB; one sample's launches {launches} through the wrappers "
        f"{({n: v for n, v in per.items() if v})}; on {card}")
    for mode in ("graph", "eager"):
        p = prof[mode]
        dev = p.device_ms_per_sample
        log(f"    {mode}: " + " / ".join(f"{x:.3f}" for x in ms[mode])
            + f" ms/sample (median {statistics.median(ms[mode]):.3f}); "
            f"device {dev:.3f} ms/sample in {p.launches / p.samples:.0f} "
            f"kernels/sample; idle {1 - dev / statistics.median(ms[mode]):.3f}"
            f" of the median; host launch calls "
            f"{p.launch_calls / p.samples:.2f} a sample")
    by_kernel = [{n: t / p.samples for n, t, _ in p.kernels} for _, p in profs]
    moved = sorted(by_kernel[0], key=lambda n: -abs(
        by_kernel[0][n] - by_kernel[1].get(n, 0.0)))[:3]
    log(f"    graph device ms/sample read twice: "
        f"{profs[0][1].device_ms_per_sample:.3f} / "
        f"{profs[2][1].device_ms_per_sample:.3f} ({DISPATCH_PROFILE_STEPS} "
        f"profiled steps each); back-to-back graph turns " + " / ".join(
            f"{x:.3f}" for x in b2b) + " ms/sample; the kernels whose "
        "device time differs most, graph / eager / graph ms/sample: "
        + "; ".join(f"{n[:60]} " + " / ".join(
            f"{bk.get(n, 0.0):.4f}" for bk in by_kernel) for n in moved))
    assert same, label
    if label in ("dragon A", "coatball"):
        caps = {kk: capture(g, kk) for kk in DISPATCH_KS}
        sweep = {kk: [] for kk in DISPATCH_KS}
        for i in range(DISPATCH_ROUNDS):
            for kk in DISPATCH_KS[i % 3:] + DISPATCH_KS[:i % 3]:
                sweep[kk].append(timed_steps(g, DISPATCH_K_SAMPLES // kk, kk))
        log(f"    graph batches in turns: " + "; ".join(
            f"k={kk} " + " / ".join(f"{x:.3f}" for x in sweep[kk])
            + f" ms/sample (capture {caps[kk][0]:.3f} s, +"
            f"{caps[kk][1] / 2**20:.1f} MiB)" for kk in DISPATCH_KS))
    return captured


def dispatch_phase(card):
    """Phase 20: ``samples_per_dispatch`` as CUDA graphs.  Each config of
    ``DISPATCH_CONFIGS`` graphed against its eager twin (the same build):
    one eager sample under ``torch.cuda.set_sync_debug_mode("error")``,
    the capture's launch counts against an eager sample's, ms/sample in
    turns, device ms/sample and kernels by name from the profiler (a replay
    shows its kernels as an eager step does), host launch calls a sample,
    capture seconds and pool bytes, and the images equal bit for bit; on
    dragon A and coatball the graph batches 1, 2 and 4 in turns; each of
    ``DISPATCH_UNTIMED`` with the sync check, the capture and the image
    alone.  Then ``refine`` between two batches against the eager renderer with the
    same refine, a mid-render checkpoint resumed in a fresh renderer
    against a straight render, and the CLI's ``render --spp 6
    --save-every 4`` saving at samples 4 and 6.  Returns dragon A's launch
    counts (its capture: the graphed path's run)."""
    import os

    import torch

    from metal_raytracing_tpu_torch import cli
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    counts = {}
    for label, name, size, kw in DISPATCH_CONFIGS:
        counts[label] = dispatch_config(card, label, name, size, kw)
        torch.cuda.empty_cache()
    for label, name, size, kw in DISPATCH_UNTIMED:
        dispatch_config(card, label, name, size, kw, timed=False)
        torch.cuda.empty_cache()

    # a mid-render checkpoint, resumed in a fresh renderer (the same build)
    w, h = COATBALL
    g = Renderer(get_scene("coatball", w, h),
                 RenderConfig(width=w, height=h), device="cuda")
    os.makedirs("build/phase20", exist_ok=True)
    straight = with_config(g)
    straight.render(6)
    mid = with_config(g)
    mid.render(3)
    mid.save("build/phase20/mid.npz")
    fresh = Renderer(get_scene("coatball", w, h),
                     RenderConfig(width=w, height=h), device="cuda")
    fresh.load("build/phase20/mid.npz")
    fresh.render(3)
    same = bool(torch.equal(fresh.accum, straight.accum))
    log(f"  coatball 3 samples, checkpoint, 3 more in a fresh renderer == "
        f"6 straight: {same}")
    assert same and fresh.total_samples == 6
    # refine() between two batches: the graphs are dropped and recaptured
    e = with_config(g)
    e.graphed = False
    k = g.samples_per_dispatch
    g.step()
    old = g.graphs[k]
    for r in (g, e):
        if r is e:
            r.step()
        assert r.refine()
        r.step()
    recaptured = list(g.graphs) == [k] and g.graphs[k] is not old
    same = bool(torch.equal(g.accum, e.accum))
    log(f"  coatball step, refine, step: graph recaptured {recaptured}, "
        f"image graph == eager: {same}")
    assert recaptured and same
    del g, e, straight, mid, fresh
    torch.cuda.empty_cache()

    # the CLI: --spp 6 --save-every 4 saves at samples 4 and 6
    saves = []
    save = Renderer.save

    def recording_save(self, path):
        saves.append(self.total_samples)
        save(self, path)

    argv = ["render", "--spp", "6", "--save-every", "4", "--checkpoint",
            "build/phase20/cli.npz", "--out", "build/phase20/cli.png",
            "--quiet"]
    Renderer.save = recording_save
    try:
        assert cli.main(argv) == 0
    finally:
        Renderer.save = save
    args = cli.build_parser().parse_args(argv)
    scene = get_scene(args.scene, *args.size)
    ref = Renderer(scene, cli.render_config(args, scene, spp=6),
                   device="cuda")
    ref.render(6)
    ck = Renderer(scene, ref.cfg, device="cuda")
    ck.load("build/phase20/cli.npz")
    same = bool(torch.equal(ck.accum, ref.accum))
    log(f"  CLI render --spp 6 --save-every 4 ({args.scene} "
        f"{args.size[0]}x{args.size[1]}, batch {ref.samples_per_dispatch}):"
        f" checkpoints at samples {saves}, the last == a straight render of "
        f"6: {same}")
    assert saves == [4, 6] and same and ck.total_samples == 6, saves
    return counts["dragon A"]


# ---------------------------------------------------------------------------
# Phase 21: the native OBJ parser on the scene load
# ---------------------------------------------------------------------------

# the models of the dragon scene (scenes/library.py dragon_scene)
DRAGON_MODELS = ("train", "dragon", "treefir", "plane", "sphere", "plane-back")
PARSE_ROUNDS = 3  # parses of each model by each parser, in turns
LOAD_SAMPLES = 4  # samples of each dragon render (its graph captures 2)


def models_equal(a, b) -> bool:
    """Every field of two ``LoadedModel``s, bit for bit."""
    def arrays(m):
        return [m.positions, m.normals, m.texcoords] + [
            getattr(s, f) for s in m.submeshes
            for f in ("tri_pos_idx", "tri_norm_idx", "tri_uv_idx")]

    def fields(m):
        return (m.name, m.face_count, [(s.material_name, s.material)
                                       for s in m.submeshes])

    pairs = list(zip(arrays(a), arrays(b)))
    return fields(a) == fields(b) and len(pairs) == len(arrays(a)) and all(
        (x is None and y is None) or (
            x is not None and y is not None and x.dtype == y.dtype
            and np.array_equal(x, y)) for x, y in pairs)


def host_cpu() -> str:
    """The host CPU's model name (``lscpu``), machine and logical CPUs."""
    import os
    import platform

    try:
        out = subprocess.run(["lscpu"], capture_output=True,
                             text=True).stdout
    except OSError:
        out = ""
    names = [line.split(":", 1)[1].strip() for line in out.splitlines()
             if line.startswith("Model name")]
    return (f"{names[0] if names else 'unknown CPU'} "
            f"({platform.machine()}), {os.cpu_count()} logical CPUs")


def dragon_from(res, mode):
    """The dragon scene 1024x1024 with its models from ``mode``:
    ``"procedural"`` (no ``MRT_RESOURCES``), or the OBJ files in ``res``
    through ``load_obj``'s ``"native"`` or ``"python"`` parser.  Returns
    (seconds to load the models, seconds to build the renderer on the card,
    the renderer, the paths the native parser read)."""
    import os

    import torch

    from metal_raytracing_tpu_torch import assets
    from metal_raytracing_tpu_torch.io import native
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    env = {"MRT_RESOURCES": None if mode == "procedural" else res,
           "MRT_NO_NATIVE": "1" if mode == "python" else None}
    saved = {k: os.environ.get(k) for k in env}
    parsed, parse = [], native.parse_obj_native

    def counted(path):
        parsed.append(path)
        return parse(path)

    def set_env(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    set_env(env)
    native.parse_obj_native = counted
    assets.resolve_model.cache_clear()
    try:
        w, h = DRAGON
        t0 = time.perf_counter()
        scene = get_scene("dragon", w, h)
        t1 = time.perf_counter()
        r = Renderer(scene, RenderConfig(width=w, height=h), device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        native.parse_obj_native = parse
        set_env(saved)
        assets.resolve_model.cache_clear()
    return t1 - t0, t2 - t1, r, parsed


def parse_phase(card):
    """Phase 21: the native OBJ parser (``io/native.py``, built from
    ``native/objparse.cpp`` with the host's C++ compiler) against the
    pure-Python one on the dragon scene's models written to OBJ files:
    the build's seconds and the compiler, each model's parse by both in
    turns and the two models equal; the dragon scene 1024x1024 loaded from
    the stand-ins, from the files natively and in Python, in turns (load
    and build seconds); each rendered through the graphed main path, the
    images equal bit for bit.  Returns the launch counts of the native
    scene's render (its warm-up sample and capture)."""
    import os
    import tempfile

    import torch

    from metal_raytracing_tpu_torch.io import native, procedural
    from metal_raytracing_tpu_torch.io.obj import load_obj, write_obj
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.utils import profiling

    with profiling.span_log() as spans:
        native.load_library()
    cxx = native.compiler()  # $CXX, else c++, else g++
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    log(f"  parser build+load {spans.seconds('parser load'):.3f} s "
        f"(compile {spans.seconds('parser build'):.3f} s) -> "
        f"{native.BUILD_DIR}; {cxx} "
        f"(CXX={os.environ.get('CXX')}): "
        f"{version}; host {host_cpu()}; {card}")
    with tempfile.TemporaryDirectory() as res:
        for name in DRAGON_MODELS:
            path = os.path.join(res, f"{name}.obj")
            write_obj(procedural.make_model(name), path)
            secs, got = {"native": [], "python": []}, {}
            for i in range(PARSE_ROUNDS):
                for mode in (("native", "python") if i % 2 == 0
                             else ("python", "native")):
                    t = time.perf_counter()
                    got[mode] = load_obj(path, use_native=mode == "native")
                    secs[mode].append(time.perf_counter() - t)
            same = models_equal(got["native"], got["python"])
            med = {m: statistics.median(v) for m, v in secs.items()}
            log(f"    {name}: {got['native'].triangle_count} triangles, "
                f"{os.path.getsize(path) / 2**20:.2f} MiB; parse s native "
                + " / ".join(f"{x:.4f}" for x in secs["native"])
                + ", python " + " / ".join(f"{x:.4f}" for x in secs["python"])
                + f" (python / native {med['python'] / med['native']:.1f}x);"
                f" models equal: {same}")
            assert same, name

        modes = ("procedural", "native", "python")
        loads, renderers = {m: [] for m in modes}, {}
        for i in range(2):
            for mode in modes if i == 0 else modes[::-1]:
                load_s, build_s, r, parsed = dragon_from(res, mode)
                loads[mode].append((load_s, build_s))
                assert len(parsed) == (len(DRAGON_MODELS)
                                       if mode == "native" else 0), parsed
                renderers.setdefault(mode, r)  # the first round's
                del r
        log(f"    dragon {DRAGON[0]}x{DRAGON[1]} scene, load s + renderer "
            "build s, 2 rounds in turns: " + "; ".join(
                f"{m} " + " / ".join(f"{a:.3f} + {b:.3f}"
                                     for a, b in loads[m]) for m in modes))

        images, counts = {}, None
        for mode in modes:
            r = renderers[mode]
            assert r.graphed and r.tracer == "cuda"
            TC.reset_launch_counts()
            r.render(LOAD_SAMPLES)
            run = launch_counts()
            per, note = graphed_run(f"dragon {mode}", r, run)
            assert run["closest_hier"] > 0 and run["any_hier"] > 0, run
            if mode == "native":
                counts = run
            ms = timed_steps(r, 1, r.samples_per_dispatch)
            images[mode] = r.accum.clone()
            log(f"    {mode}: {r.total_samples} samples graphed, the last "
                f"step of {r.samples_per_dispatch} timed: {ms:.3f} ms/sample;"
                f" launches ({note}) {({k: v for k, v in run.items() if v})}")
        img = images["native"].cpu().numpy()
        assert img.shape == (DRAGON[1], DRAGON[0], 3)
        assert bool(np.isfinite(img).all()) and float(img.max()) > 0.01
        same = {m: bool(torch.equal(images[m], images["native"]))
                for m in ("python", "procedural")}
        log(f"    dragon images after {r.total_samples} samples: native == "
            f"python {same['python']}, native == procedural "
            f"{same['procedural']}; on {card}")
        assert all(same.values()), same
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1

    from metal_raytracing_tpu_torch.ops import _build
    from metal_raytracing_tpu_torch.ops import rank_cuda as RK
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig
    from metal_raytracing_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    # ---- phase 1: card, versions, kernel build
    card = card_line()
    rate, sms, mhz = fp32_issue_rate()
    log(card)
    log(f"FP32 issue rate {rate:.4e} instructions/s ({sms} SMs x "
        f"{FP32_LANES_PER_SM} lanes x {mhz:.0f} MHz maximum SM clock), FMA "
        f"peak {2 * rate:.4e} FLOP/s; the bound charges a test {SLAB_OPS} "
        f"(slab) or {PLANE_OPS} (plane) issue slots")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {kind}")
    with profiling.span_log() as spans:
        _build.load_library()
    log(f"kernel build+load {spans.seconds('kernel load'):.2f} s "
        f"(nvcc {spans.seconds('kernel build'):.2f} s, "
        f"{len(_build.sources())} sources in parallel) -> "
        f"{_build.BUILD_DIR}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- phase 2: K1/K2 against their plain versions on coatball
    w, h = COATBALL
    probe = Renderer(get_scene("coatball", w, h),
                     RenderConfig(width=w, height=h), device="cuda")
    bvh = probe.spec.bvh
    log(f"coatball {w}x{h}: {bvh.num_triangles} triangles, "
        f"{bvh.num_clusters} clusters, {bvh.num_global} global, flat "
        f"{TC._use_flat(bvh)}")
    coat_calls = record_passes(probe)
    res = {}
    log("phase 2: K1/K2 vs plain version")
    for b in (0, 1):
        res.setdefault("K1", []).append(check_closest(
            f"K1 closest bounce {b}", coat_calls["closest"][b], probe.data,
            probe.spec))
        res.setdefault("K2", []).append(check_any(
            f"K2 any bounce {b}", coat_calls["any"][b], probe.data,
            probe.spec))
    log("  K1/K2 vs the walking plain versions (every ray):")
    walked = {"K1": [], "K2": [], "K3": [], "K4": []}
    for b in range(len(coat_calls["closest"])):
        walked["K1"].append(check_walk_closest(
            f"K1 closest bounce {b}", coat_calls["closest"][b], probe.data,
            probe.spec, before=ONE_THREAD_MS["K1"][b]))
        walked["K2"].append(check_walk_any(
            f"K2 any bounce {b}", coat_calls["any"][b], probe.data,
            probe.spec, before=ONE_THREAD_MS["K2"][b]))
        res["K1"].append(walked["K1"][-1])
        res["K2"].append(walked["K2"][-1])
    log("  K3/K4 forced onto the same rays (flat=False) vs K1/K2:")
    compare_walks("coatball", coat_calls, probe.data, probe.spec,
                  ONE_THREAD_MS)
    del coat_calls, probe
    torch.cuda.empty_cache()

    # ---- phase 3: the coatball main path
    log("phase 3: coatball main path")
    renderer = Renderer(get_scene("coatball", w, h),
                        RenderConfig(width=w, height=h), device="cuda")
    _, samples, counts, per, note = main_path(renderer, card, "coatball",
                                              COATBALL)
    launches = {"K1": counts["closest_flat"], "K2": counts["any_flat"]}
    # what each kernel's launches in the kernels line hold
    launches_of = {"K1": note, "K2": note}
    for k, name in (("K1", "closest_flat"), ("K2", "any_flat")):
        assert launches[k] > 0 and per[name] >= 3, (k, counts, per)
    del renderer

    # ---- phase 4: coatball image through the kernels vs the plain versions
    log("phase 4: coatball cross-check")
    cross_check("coatball", (128, 96), 2)

    # ---- phase 5: K3/K4 against their plain versions on dragon
    w, h = DRAGON
    dragon = Renderer(get_scene("dragon", w, h),
                      RenderConfig(width=w, height=h), device="cuda")
    bvh = dragon.spec.bvh
    log(f"dragon {w}x{h}: {bvh.num_triangles} triangles, "
        f"{bvh.num_clusters} clusters, supers {TC.super_layout(bvh)}, "
        f"{bvh.num_global} global, flat {TC._use_flat(bvh)}")
    assert not TC._use_flat(bvh)
    calls = record_passes(dragon)
    log(f"phase 5: K3/K4 vs plain version (every {CHECK_STRIDE}th ray)")
    for b in (0, 1):
        res.setdefault("K3", []).append(check_closest(
            f"K3 closest bounce {b}", calls["closest"][b], dragon.data,
            dragon.spec, CHECK_STRIDE, time_plain=b == 0))
        res.setdefault("K4", []).append(check_any(
            f"K4 any bounce {b}", calls["any"][b], dragon.data, dragon.spec,
            CHECK_STRIDE, time_plain=b == 0))

    # ---- phase 6: K5 against its plain version on dragon
    log("phase 6: K5 vs plain version (all rays)")
    bp = check_broadphase(calls, dragon.data, dragon.spec)

    # every recorded pass of the dragon sample: kernel ms beside its bound
    log("  dragon passes (kernel ms by CUDA events; bound):")
    for b in range(len(calls["closest"])):
        o, d, m, seed = calls["closest"][b]
        tabs = (dragon.data.sup_planes, dragon.data.clu_planes,
                dragon.data.tri_planes, bvh)
        hit = TC.trace_closest(o, d, m, *tabs, seed)
        ms = cuda_ms(lambda: TC.trace_closest(o, d, m, *tabs, seed), 5)
        bnd = bound(*trace_work(o, d, m, dragon.data, dragon.spec, True,
                                t_final=hit.t))
        o2, d2, mt, m2 = calls["any"][b]
        occ = TC.trace_any(o2, d2, mt, m2, *tabs)
        ms2 = cuda_ms(lambda: TC.trace_any(o2, d2, mt, m2, *tabs), 5)
        bnd2 = bound(*trace_work(o2, d2, m2, dragon.data, dragon.spec, True,
                                 max_t=mt, occ=occ))
        log(f"    bounce {b}: K3 {ms:.3f} ms ({int(m.sum())} live, bound "
            f"{bnd[0]:.4f} ms, {bnd[1]}); K4 {ms2:.3f} ms ({int(m2.sum())} "
            f"live, bound {bnd2[0]:.4f} ms, {bnd2[1]})")
    log("  K3/K4 vs the walking plain versions (every ray):")
    for b in range(len(calls["closest"])):
        walked["K3"].append(check_walk_closest(
            f"K3 closest bounce {b}", calls["closest"][b], dragon.data,
            dragon.spec, before=ONE_THREAD_MS["K3"][b]))
        walked["K4"].append(check_walk_any(
            f"K4 any bounce {b}", calls["any"][b], dragon.data, dragon.spec,
            before=ONE_THREAD_MS["K4"][b]))
        res["K3"].append(walked["K3"][-1])
        res["K4"].append(walked["K4"][-1])
    del calls, dragon
    torch.cuda.empty_cache()

    # ---- phase 7: the dragon main path, default and fused broad phase
    log("phase 7: dragon main path")
    for fused in (False, True):
        r = Renderer(get_scene("dragon", w, h),
                     RenderConfig(width=w, height=h, fused_broadphase=fused),
                     device="cuda")
        _, samples, counts, per, note = main_path(
            r, card, "dragon fused_broadphase=True" if fused else "dragon",
            DRAGON)
        for k in ("closest_hier", "any_hier") + (
                ("broadphase",) if fused else ()):
            assert counts[k] > 0 and per[k] >= 3, (k, counts, per)
        if fused:
            launches["K5"] = counts["broadphase"]
            launches_of["K5"] = note
        else:
            launches["K3"] = counts["closest_hier"]
            launches["K4"] = counts["any_hier"]
            launches_of["K3"] = launches_of["K4"] = note
        del r

    # ---- phase 8: dragon image through the kernels vs the plain versions
    log("phase 8: dragon cross-check")
    cross_check("dragon", (128, 128), 1)

    # ---- phase 9: K6 against its plain version on the sorted bounce passes
    sl = Renderer(get_scene("dragon", w, h),
                  RenderConfig(width=w, height=h, **SLICE), device="cuda")
    calls = record_passes(sl)
    assert len(calls["rank"]) == 2 and len(calls["any"]) == 3
    log("phase 9: K6 vs plain version and walking plain version (all rays)")
    walks = []
    for b, rec in enumerate(calls["rank"], start=1):
        walks.append(check_rank(f"K6 bounce {b}", rec, sl.data, sl.spec,
                                ONE_THREAD_MS["K6"][b - 1]))
        res.setdefault("K6", []).append(walks[-1])
    walked["K6"] = walks

    # ---- phase 10: the seeded K3, the composition, and what the sort buys
    log("phase 10: K3 with seed_base, and K6 + certificate + K3 vs K3 alone")
    for b, (rec, walk) in enumerate(zip(calls["rank"], walks), start=1):
        res["K3"].append({"err": check_fallback(f"bounce {b}", rec, walk,
                                                sl.data, sl.spec)})
    log("  K3 / K4 on the slice's sorted passes:")
    tabs = (sl.data.sup_planes, sl.data.clu_planes, sl.data.tri_planes,
            sl.spec.bvh)
    for b, (o, d, m, _, seed) in enumerate(calls["rank"], start=1):
        sorted_against_shuffled(
            f"K3 bounce {b}", lambda o, d, seed, m: TC.trace_closest(
                o, d, m, *tabs, seed), (o, d, seed, m))
        sorted_against_shuffled(
            f"K6 bounce {b}", lambda o, d, seed, k1, k2, m:
            RK.trace_closest_rank(o, d, m, [k1, k2], tabs[2], tabs[3], seed),
            (o, d, seed, calls["rank"][b - 1][3][0],
             calls["rank"][b - 1][3][1], m))
    log("  K3 / K4 vs the walking plain versions on the sorted and the "
        "seeded passes (every ray):")
    for b, ((o, d, m, _, seed), wk) in enumerate(zip(calls["rank"], walks),
                                                 start=1):
        res["K3"].append(check_walk_closest(
            f"K3 sorted bounce {b}", (o, d, m, seed), sl.data, sl.spec,
            before=ONE_THREAD_MS["K3 sorted"][b - 1]))
        res["K3"].append(check_walk_closest(
            f"K3 seeded bounce {b}", (o, d, wk["unresolved"], wk["key"]),
            sl.data, sl.spec, seed_base=wk["base"],
            before=ONE_THREAD_MS["K3 seeded"][b - 1]))
        o2, d2, mt, m2 = calls["any"][b]
        res["K4"].append(check_walk_any(
            f"K4 sorted bounce {b}", (o2.contiguous(), d2.contiguous(), mt,
                                      m2), sl.data, sl.spec,
            before=ONE_THREAD_MS["K4 sorted"][b - 1]))
    for b in (1, 2):
        o2, d2, mt, m2 = calls["any"][b]
        sorted_against_shuffled(
            f"K4 bounce {b}", lambda o, d, mt, m: TC.trace_any(
                o, d, mt, m, *tabs), (o2.contiguous(), d2.contiguous(), mt,
                                      m2))

    # ---- phase 11: the exact broad phase's kernel vs its plain chain
    log("phase 11: nearest_cluster_kernel vs the plain chain, every form")
    exact = check_exact_broadphase(calls["rank"][0], calls["any"][1],
                                   sl.data, sl.spec)
    del calls, walks, sl
    torch.cuda.empty_cache()

    # ---- phase 12: four configs in turns
    log(f"phase 12: dragon main path, four configs in turns, {ROUNDS} rounds "
        f"of {ROUND_SAMPLES} samples")
    totals, notes = four_configs(card, DRAGON)
    slice_counts, fused_counts = totals[CONFIGS[2][0]], totals[CONFIGS[3][0]]
    log(f"  the runs' launches (warm-up samples and captures): slice "
        f"{slice_counts}; {CONFIGS[3][0]}: {fused_counts}")
    launches["K6"] = slice_counts["closest_rank"]
    assert launches["K6"] > 0
    # K5's cluster sweep runs under compaction with fused_broadphase=True
    launches["K5 keys"] = fused_counts["broadphase_clusters"]
    launches_of["K6"] = notes[CONFIGS[2][0]]
    launches_of["K5 keys"] = notes[CONFIGS[3][0]]
    # the exact broad phase's kernel under compaction=True
    nc_launches = {k: totals[CONFIGS[1][0]][k]
                   for k in ("nearest_cluster", "nearest_cluster_pair")}
    assert nc_launches["nearest_cluster_pair"] > 0, nc_launches

    # ---- phase 13: the slice's image through the kernels vs plain versions
    log("phase 13: dragon cross-check, compaction=True rank_trace=2")
    cross_check("dragon", (128, 128), 1, **SLICE)
    log("  the exact broad phase's kernel against the plain chain, images:")
    exact_broadphase_images(card, DRAGON)

    # ---- phase 14: the shading extensions through K1/K2
    log("phase 14: the shading extensions (coatball, bunny_env, "
        "glass_sphere, uv_test) through K1/K2")
    ext_launches = extension_scenes(card)
    log(f"  K1/K2 launches of the runs with the extensions on: "
        f"{ext_launches}")

    # ---- phase 15: the exact BVH tracers' kernels
    t15 = time.perf_counter()
    log(f"phase 15: closest_bvh_kernel / any_bvh_kernel vs their plain "
        f"versions, the brute force and K1-K4")
    bvh = bvh_kernels()
    log("  the JAX CLI's GPU path (tracer=bvh), dragon, configs in turns, "
        f"{ROUNDS} rounds of {ROUND_SAMPLES} samples:")
    bvh_launches, bvh_note = bvh_main_path(card, DRAGON)
    log(f"  BVH kernel launches of the bvh runs: {bvh_launches}")
    bvh_cross_check((128, 128))
    log(f"phase 15: {time.perf_counter() - t15:.1f} s")

    # ---- phase 16: the cluster builders and the traversal telemetry
    t16 = time.perf_counter()
    log("phase 16: every cluster builder on dragon and coatball, the "
        "kernels' counts and visits, wide supers, the fallback above 4,095 "
        "clusters, feedback, telemetry")
    wide, option_ms, k6_ms = builders(card)
    log(f"phase 16: {time.perf_counter() - t16:.1f} s")

    # ---- phase 17: K3's baked-origin primary pass
    t17 = time.perf_counter()
    log("phase 17: dragon bake_primary=True: the baked K3 vs its walking "
        "plain version and the unbaked K3, timed in turns; the image vs A's")
    baked_row = bake_phase(card)
    log(f"phase 17: {time.perf_counter() - t17:.1f} s")
    torch.cuda.empty_cache()

    # ---- phase 18: sharding on torch.distributed, ranks sharing the card
    t18 = time.perf_counter()
    log("phase 18: ShardedRenderer, 2 and 4 gloo ranks and 1 NCCL rank on "
        "cuda:0 (the ranks share one card)")
    sharding_phase(card)
    log(f"phase 18: {time.perf_counter() - t18:.1f} s")

    # ---- phase 19: the sort key, plain and packed
    t19 = time.perf_counter()
    log(f"phase 19: the sort key on dragon compaction=True, plain and "
        f"packed, {SORT_SAMPLES} samples each vs A")
    sort_layouts_phase(card)
    log(f"phase 19: {time.perf_counter() - t19:.1f} s")

    # ---- phase 20: samples_per_dispatch as CUDA graphs
    t20 = time.perf_counter()
    log("phase 20: samples_per_dispatch, a batch of samples as one CUDA "
        "graph replay, against the eager renderer")
    graphed = dispatch_phase(card)
    log(f"  dragon A's graphed run (warm-up sample and capture): "
        f"{ {k: v for k, v in graphed.items() if v} }")
    assert graphed["closest_hier"] > 0 and graphed["any_hier"] > 0, graphed
    log(f"phase 20: {time.perf_counter() - t20:.1f} s")

    # ---- phase 21: the native OBJ parser on the scene load
    t21 = time.perf_counter()
    log("phase 21: the native OBJ parser against the Python one on the "
        "dragon scene's models as OBJ files, and the dragon scene loaded "
        "each way through the graphed main path")
    loaded = parse_phase(card)
    log(f"  the native-loaded scene's run (warm-up sample and capture): "
        f"{ {k: v for k, v in loaded.items() if v} }")
    log(f"phase 21: {time.perf_counter() - t21:.1f} s")

    kernels = []
    modes = {"K5": "closest global", "K5 keys": "keys"}  # K5's two entries
    for key, name, src, line, first in (
            ("K1", "closest_flat_kernel", "trace_flat.cu", 1848, res["K1"][0]),
            ("K2", "any_flat_kernel", "trace_flat.cu", 1957, res["K2"][0]),
            ("K3", "closest_hier_kernel", "trace_hier.cu", 1139,
             res["K3"][0]),
            ("K4", "any_hier_kernel", "trace_hier.cu", 1653, res["K4"][0]),
            ("K5", "broadphase_kernel", "broadphase.cu", 960,
             bp[modes["K5"]]),
            ("K5 keys", "broadphase_kernel keys", "broadphase.cu", 960,
             bp[modes["K5 keys"]]),
            ("K6", "closest_rank_kernel", "trace_rank.cu", 1424,
             res["K6"][0])):
        errs = ([r["err"] for r in res[key]] if key in res
                else [r["err"] for r in bp.values()])
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": f"{PALLAS}:{line}", "launches": launches[key],
            "launches_of": f"the main path's run: {launches_of[key]}",
            "max_abs_err": max(errs), "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound"][0],
            "bound_by": first["bound"][1], "library_ms": LIBRARY})
        if key in modes:  # K5: its mode and the profiler's device time
            kernels[-1].update(mode=modes[key], device_ms=first["device_ms"])
        if key in walked:  # the walking plain version on the same pass
            kernels[-1]["plain_walk_ms"] = walked[key][0]["plain_walk_ms"]
            kernels[-1]["walk_bound_ms"] = walked[key][0]["walk_bound"][0]
        # phase 16: the same pass's ms without and with the visits output
        scene, kind = {"K1": ("coatball", "closest"),
                       "K2": ("coatball", "any"),
                       "K3": ("dragon", "closest"),
                       "K4": ("dragon", "any")}.get(key, (None, None))
        if scene:
            kernels[-1]["options_ms"] = {
                k.split(" ", 1)[1]: v for k, v in option_ms[scene].items()
                if k.startswith(kind)}
        elif key == "K6":
            kernels[-1]["options_ms"] = k6_ms
    for label, line in (("ranks 1-2", 675), ("pair ranks 3 packed", 811)):
        first = exact[label]  # phase 11: the slice's bounce-1 rays
        kernels.append({
            "name": "nearest_cluster_kernel", "form": label, "route": "cuda",
            "source": CSRC + "broadphase.cu",
            "replaces": f"{PALLAS}:{line}", "pallas_counterpart": None,
            "launches": sum(nc_launches.values()),
            "launches_pair": nc_launches["nearest_cluster_pair"],
            "launches_of": notes[CONFIGS[1][0]],
            "max_abs_err": 0.0, "ms": first["ms"],
            "device_ms": first["device_ms"],
            "plain_ms": first["plain_ms"], "plain_kind": "the plain chain",
            "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
            "library_ms": None})
    for query, name, line in (("closest", "closest_bvh_kernel", 125),
                              ("any", "any_bvh_kernel", 219)):
        first = bvh[query][0]  # dragon's primary pass
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + "trace_bvh.cu",
            "replaces": f"{TRACE_PY}:{line}", "pallas_counterpart": None,
            "launches": bvh_launches[f"{query}_bvh"],
            "launches_of": bvh_note,
            "max_abs_err": max(r["err"] for r in bvh[query]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "plain_rays": first["plain_rays"],
            "plain_walk_ms": first["plain_walk_ms"],
            "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
            "library_ms": None})
    for query, name, line in (("closest", "closest_hier_kernel", 1139),
                              ("any", "any_hier_kernel", 1653)):
        r = wide[query]  # phase 16: dragon's ploc build, S > 32
        kernels.append({
            "name": f"{name} wide", "route": "cuda",
            "source": CSRC + "trace_hier.cu",
            "replaces": f"{PALLAS}:{line}", "launches": r["launches"],
            "launches_of": r["launches_of"],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "plain_rays": r["plain_rays"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": LIBRARY})
    kernels.append(baked_row)  # phase 17
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
