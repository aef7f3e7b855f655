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
   and each pass's bound (the least time the card could take);
3. the coatball main path: ``Renderer(coatball 1024x768, RenderConfig())`` on
   ``device="cuda"``: 1 warm-up and 4 timed samples, the image checked, the
   launch counts read, then 2 samples under ``torch.profiler`` (device time
   by kernel, and the device's busy share of the unprofiled wall time);
4. a coatball cross-check at 128x96: the kernels' image against the plain
   versions';
5. K3/K4 (the hierarchical kernels) against their plain versions on dragon
   1024x1024's primary and bounce-1 passes, on every 16th ray (the plain
   versions are brute force over 132k triangle slots); the kernels are timed
   on the full passes.  Then K3/K4 with ``flat=False`` against K1/K2 on
   coatball's passes;
6. K5 (the broad phase) in four modes against its plain version on dragon's
   primary and shadow rays: cluster keys, cluster keys with the second
   nearest, the global seed key, the global occlusion flag;
7. the dragon main path: ``Renderer(dragon 1024x1024, RenderConfig())``,
   then with ``fused_broadphase=True``: as phase 3 for each, with the launch
   counts of K3/K4/K5; before it, each recorded pass's kernel ms beside its
   bound;
8. a dragon cross-check at 128x128: the kernels' image against the plain
   versions'.

A bound is the larger of the pass's bytes (rays in, results out, plane
tables once) over 3.35 TB/s and its FP32 operations over 67 TFLOP/s, the
H100 SXM's published peaks.  The operations count only the work the pass's
rays need, from the plain versions' results where they ran on the whole
pass (coatball, K5, and dragon's primary passes, where the plain versions
are timed) and from the kernels' results where they did not (dragon's
bounce passes, which the plain versions matched on every 16th ray):
for a closest ray, every cluster whose slab entry lies below its final hit
t, dense-tested at 39 operations per triangle slot (``tri_hit`` in
``csrc/trace_common.cuh``), plus 27 operations per slab test (the boxes a
walk must test to find those clusters); for an unoccluded shadow ray every
cluster its segment overlaps, for an occluded one a single triangle.

It prints one JSON line of per-kernel results, and last the line
``{"ok": true, "device": {...}}``.  Without CUDA it exits with an error and
renders nothing (there is no CPU fallback).
"""

from __future__ import annotations

import json
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
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and FP32 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SLAB_OPS = 27  # slab(): 6 sub, 6 mul, 10 min/max, 1 clamp, 4 compares
PLANE_OPS = 39  # tri_hit(): 29 mul/add/sub, 1 div, 4 Newton/t, 5 compares
CSRC = "metal_raytracing_tpu_torch/csrc/"
PALLAS = "metal_raytracing_tpu/ops/trace_pallas.py"
LIBRARY = None  # no PyTorch call computes a packed-key BVH walk


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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
    operations over the peak rate, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live_chunks(mask, width: int):
    """Index chunks of the live rays, sized for (chunk, width, 3) slabs."""
    live = mask.nonzero()[:, 0]
    step = max(1, (1 << 22) // max(width, 1))
    for s in range(0, live.shape[0], step):
        yield live[s:s + step]


def trace_work(o, d, mask, data, spec, hier, t_final=None, max_t=None,
               occ=None):
    """(bytes, operations) a closest (``t_final``: each ray's final chopped
    hit t) or shadow (``max_t``, ``occ``) pass needs; see the docstring."""
    from metal_raytracing_tpu_torch.ops.broadphase_cuda import slab_entry

    bvh = spec.bvh
    ns, s_per = data.clu_planes.shape[0], data.clu_planes.shape[1]
    boxes = data.clu_planes.reshape(-1, 6)
    sup = data.sup_planes[:ns]
    n = o.shape[0]
    table = data.tri_planes[:, :bvh.num_clusters * bvh.cluster_size]
    nbytes = table.numel() * 4 + boxes.numel() * 4 + (sup.numel() * 4 if hier
                                                      else 0)
    if t_final is not None:
        nbytes += n * (12 + 12 + 1 + 4) + n * (4 + 4)  # rays + seed, t + tri
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

    closest, any_hit = R.make_tracers(renderer.data, renderer.spec, "cuda")
    calls = {"closest": [], "any": []}

    def rec_closest(o, d, m, seed):
        calls["closest"].append((o.contiguous(), d.clone(), m.clone(),
                                 None if seed is None else seed.clone()))
        return closest(o, d, m, seed)

    def rec_any(o, d, mt, m):
        calls["any"].append((o.clone(), d.clone(), mt.clone(), m.clone()))
        return any_hit(o, d, mt, m)

    R.render_sample(renderer.data, renderer.spec, renderer.cfg,
                    renderer.offsets, 0, tracers=(rec_closest, rec_any))
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


def compare_walks(name, calls, data, spec):
    """K3/K4 forced onto a flat scene (``flat=False``) against K1/K2 on the
    same rays: the two walks must agree as a kernel and its plain version
    do."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    for b in (0, 1):
        o, d, m, seed = calls["closest"][b]
        flat = TC.trace_closest(o, d, m, *tabs, seed, flat=True)
        hier = TC.trace_closest(o, d, m, *tabs, seed, flat=False)
        o2, d2, mt, m2 = calls["any"][b]
        aflat = TC.trace_any(o2, d2, mt, m2, *tabs, flat=True)
        ahier = TC.trace_any(o2, d2, mt, m2, *tabs, flat=False)
        torch.cuda.synchronize()
        match, n_bad, worst = near_ties(o, d, m, hier.tri, flat.tri,
                                        data.tri_planes)
        amatch = 1.0 - int(((aflat != ahier) & m2).sum()) / max(
            int(m2.sum()), 1)
        log(f"  {name} bounce {b}: K3 vs K1 ids equal {match:.6f} "
            f"({n_bad} near-ties, worst {worst:.3e}); K4 vs K2 flags equal "
            f"{amatch:.6f}")
        assert match >= MIN_MATCH and worst <= NEAR_TIE_REL, name
        assert amatch >= MIN_MATCH, name


BP_MODES = (  # (name, pass, want2, with_clusters, any_mode)
    ("keys", "closest", False, True, False),
    ("keys+second", "closest", True, True, False),
    ("closest global", "closest", False, False, False),
    ("any global", "any", False, False, True),
)


def _key_t(key, idm):
    import torch

    return (key & ~idm).view(torch.float32)


def check_broadphase(calls, data, spec):
    """K5 against its plain version in every mode on all rays of dragon's
    primary pass (shadow pass for any mode); returns the closest-global
    mode's result (the fused path's seed pass)."""
    import torch

    from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    bvh = spec.bvh
    clu, tri = data.clu_planes, data.tri_planes
    ncp = clu.shape[0] * clu.shape[1]
    out = {}
    for name, kind, want2, with_clusters, any_mode in BP_MODES:
        if kind == "any":
            o, d, mt, m = calls["any"][0]
        else:
            (o, d, m, _), mt = calls["closest"][0], None
        kw = dict(max_t=mt, want2=want2, with_clusters=with_clusters,
                  any_mode=any_mode)
        got = BP.broadphase_keys(o, d, m, clu, tri, bvh, **kw)
        ref = BP.broadphase_ref(o, d, m, clu, tri, bvh, **kw)
        torch.cuda.synchronize()
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
        ms = cuda_ms(lambda: BP.broadphase_keys(o, d, m, clu, tri, bvh, **kw),
                     10)
        plain_ms = cuda_ms(lambda: BP.broadphase_ref(o, d, m, clu, tri, bvh,
                                                     **kw), 1)
        bnd = bound(*broadphase_work(o.shape[0], n_live, ncp, bvh.num_global,
                                     with_clusters, want2, any_mode))
        log(f"  K5 {name}: {n_live} live rays, outputs equal "
            f"{worst_share:.6f}, max |t - t_plain| {err:.3e}; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]})")
        assert worst_share >= MIN_MATCH, f"K5 {name}: {worst_share:.6f}"
        out[name] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound": bnd}
    return out


def main_path(renderer, card, label, size):
    """Time the renderer's main path and check its image; returns (bench,
    samples).  The launch counts cover the timed run only; a profiled
    window of 2 more samples follows (where the device time goes)."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.utils.metrics import (benchmark_renderer,
                                                          profile_renderer)

    assert renderer.tracer == "cuda", renderer.tracer
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
    prof = profile_renderer(renderer, 2)
    busy = prof.device_ms_per_sample / (bench.per_sample_seconds * 1e3)
    log(f"  profiled 2 samples: device {prof.device_ms_per_sample:.3f} "
        f"ms/sample in {prof.launches // prof.samples} kernels/sample; busy "
        f"{busy:.3f} of the unprofiled wall (idle {1 - busy:.3f})")
    for name, ms, n in prof.kernels[:6]:
        log(f"    {ms / prof.device_ms:.3f} {ms / prof.samples:.3f} "
            f"ms/sample {n // prof.samples}/sample {name[:90]}")
    return bench, samples, counts


def launch_counts():
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.ops.broadphase_cuda import \
        broadphase_keys

    return {"closest_flat": TC.trace_closest.launches,
            "any_flat": TC.trace_any.launches,
            "closest_hier": TC.trace_closest.launches_hier,
            "any_hier": TC.trace_any.launches_hier,
            "broadphase": broadphase_keys.launches}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1

    from metal_raytracing_tpu_torch.ops import _build
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    t_start = time.perf_counter()
    # ---- phase 1: card, versions, kernel build
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {kind}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernel build+load {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s, {len(_build.sources())} "
        f"sources in parallel) -> {_build.BUILD_DIR}")
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

    # ---- phase 3: the coatball main path
    log("phase 3: coatball main path")
    renderer = Renderer(get_scene("coatball", w, h),
                        RenderConfig(width=w, height=h), device="cuda")
    _, samples, counts = main_path(renderer, card, "coatball", COATBALL)
    launches = {"K1": counts["closest_flat"], "K2": counts["any_flat"]}
    log(f"  launches over {samples} samples: {counts}")
    for k in ("K1", "K2"):
        assert launches[k] >= 3 * samples, (k, launches[k], samples)
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
    compare_walks("coatball flat=False", coat_calls, probe.data, probe.spec)
    del coat_calls, probe

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
    del calls, dragon
    torch.cuda.empty_cache()

    # ---- phase 7: the dragon main path, default and fused broad phase
    log("phase 7: dragon main path")
    for fused in (False, True):
        r = Renderer(get_scene("dragon", w, h),
                     RenderConfig(width=w, height=h, fused_broadphase=fused),
                     device="cuda")
        _, samples, counts = main_path(
            r, card, "dragon fused_broadphase=True" if fused else "dragon",
            DRAGON)
        log(f"  launches over {samples} samples: {counts}")
        for k in ("closest_hier", "any_hier") + (
                ("broadphase",) if fused else ()):
            assert counts[k] >= 3 * samples, (k, counts[k], samples)
        if fused:
            launches["K5"] = counts["broadphase"]
        else:
            launches["K3"] = counts["closest_hier"]
            launches["K4"] = counts["any_hier"]
        del r

    # ---- phase 8: dragon image through the kernels vs the plain versions
    log("phase 8: dragon cross-check")
    cross_check("dragon", (128, 128), 1)

    kernels = []
    for key, name, src, line, first in (
            ("K1", "closest_flat_kernel", "trace_flat.cu", 1848, res["K1"][0]),
            ("K2", "any_flat_kernel", "trace_flat.cu", 1957, res["K2"][0]),
            ("K3", "closest_hier_kernel", "trace_hier.cu", 1139,
             res["K3"][0]),
            ("K4", "any_hier_kernel", "trace_hier.cu", 1653, res["K4"][0]),
            ("K5", "broadphase_kernel", "broadphase.cu", 960,
             bp["closest global"])):
        errs = ([r["err"] for r in res[key]] if key in res
                else [r["err"] for r in bp.values()])
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": f"{PALLAS}:{line}", "launches": launches[key],
            "max_abs_err": max(errs), "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound"][0],
            "bound_by": first["bound"][1], "library_ms": LIBRARY})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
