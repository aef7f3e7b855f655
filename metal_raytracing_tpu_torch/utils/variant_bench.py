#!/usr/bin/env python3
"""Time kernels built from other source directories beside this checkout's,
in turns inside one process on one CUDA GPU.

    python3 metal_raytracing_tpu_torch/utils/variant_bench.py \\
        [--flat | --rank | --broadphase | --bvh] [--render] \\
        [--padded NAME ...] [--no-options NAME ...] [NAME=DIR ...]

By default the hierarchical kernels K3/K4: each ``DIR`` holds a
``trace_hier.cu`` and the headers it includes, and the passes are dragon
1024x1024's.  With ``--flat`` the flat kernels K1/K2: each ``DIR`` holds a
``trace_flat.cu`` and its headers, and the passes are coatball 1024x768's.
With ``--rank`` the rank walk K6 (``trace_rank.cu``) on dragon's sorted
bounce-1 and bounce-2 passes at ``compaction=True, rank_trace=2``; with
``--broadphase`` the broad phase K5 (``broadphase.cu``) in its four modes
on dragon's primary closest and shadow passes; with ``--bvh`` the exact
tracers' kernels ``closest_bvh_kernel`` / ``any_bvh_kernel``
(``trace_bvh.cu``) on dragon 1024x1024's and coatball 1024x768's passes.
A ``DIR`` is the ``csrc/`` of an earlier commit unpacked with ``git
archive``, or an edited copy of this checkout's.  Every variant is built
with the checkout's nvcc flags into ``build/variants/NAME.so`` and must
export the checkout's entry points (``launch_closest_hier`` /
``launch_any_hier``, ``launch_closest_flat`` / ``launch_any_flat``,
``launch_closest_rank``, ``launch_broadphase`` or ``launch_closest_bvh`` /
``launch_any_bvh``); ``tree`` names the checkout's own kernels.
``--padded NAME`` gives variant NAME's K2 the global set's 128-slot padded
width (the TPU kernel's chunk) in place of the real slot count that the
wrapper passes.
``--no-options NAME``: variant NAME's K1-K4 / K6 entry points take no
``counts`` and ``visits`` arguments (the signatures before the kernels had
those options, as in an older commit's ``csrc/``); the swap drops the two
arguments, which the timed passes leave null.  The script prints

- the registers and spills of each variant's two kernels (``-Xptxas -v``);
- for every recorded pass of one sample (the default config's primary,
  bounce-1 and bounce-2 closest and shadow passes; for dragon also, with
  ``compaction=True, rank_trace=2``, the sorted bounce passes, the same rays
  in a random order, and K3 seeded per ray on the rays the rank walk's
  certificate leaves open): the share of rays on which a variant's output
  equals the checkout's, and each variant's ms by CUDA events, forwards
  through the variants and then backwards (two readings each); with
  ``--rank`` also the rays each variant's keys leave uncertified and the
  ms of the variant + certificate + the checkout's seeded K3, beside K3
  alone; with ``--broadphase`` also each variant's device ms from the
  profiler (CUDA events around ten host calls of a few-microsecond kernel
  time the wrapper too);
- with ``--render``, ms/sample and profiled device ms/sample of the main
  path with each variant's kernels swapped in, forwards and backwards
  (each turn captures its own CUDA graphs, with its variant's kernels,
  before its timed window):
  dragon at ``compaction=False`` and at ``compaction=True,
  fused_broadphase=True`` (K3/K4), at ``compaction=True, rank_trace=2``
  (K6) or at ``compaction=True, fused_broadphase=True`` (K5), coatball
  at the default config (K1/K2), or dragon at ``tracer="bvh"`` (the BVH
  kernels).  Each turn restarts the image, so every turn's image holds the
  same samples: the script prints whether it equals the first turn's, and
  with ``--bvh`` raises when it does not.

Two cards or two calls differ by more than most variants do: compare only
the numbers of one run.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SIZE = 1024
COATBALL = (1024, 768)
SLICE = dict(compaction=True, rank_trace=2)
FUSED = dict(compaction=True, fused_broadphase=True)
# source and entry points of each kernel family
KERNELS = {
    "hier": ("trace_hier.cu", ("launch_closest_hier", "launch_any_hier")),
    "flat": ("trace_flat.cu", ("launch_closest_flat", "launch_any_flat")),
    "rank": ("trace_rank.cu", ("launch_closest_rank",)),
    "broadphase": ("broadphase.cu", ("launch_broadphase",)),
    "bvh": ("trace_bvh.cu", ("launch_closest_bvh", "launch_any_bvh")),
}
# the main-path configs --render times for each family
RENDERS = {
    "hier": (("compaction=False", {}),
             ("compaction=True fused_broadphase=True", FUSED)),
    "flat": (("default config", {}),),
    "rank": (("compaction=True rank_trace=2", SLICE),),
    "broadphase": (("compaction=True fused_broadphase=True", FUSED),),
    "bvh": (("tracer=bvh", dict(tracer="bvh")),),
}
G_SLOTS_ARG = 11  # launch_any_flat's g_slots
# the argument indexes of `counts` and `visits` in each entry point that
# takes them
OPTION_ARGS = {"launch_closest_flat": (11, 14), "launch_any_flat": (12, 14),
               "launch_closest_hier": (14, 17), "launch_any_hier": (14, 16),
               "launch_closest_rank": (11, 14)}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10) -> float:
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


def build_variants(variants: dict, source: str) -> dict:
    """nvcc every variant's ``source`` (all started together) and load the
    libraries; returns name -> CDLL."""
    from metal_raytracing_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, src_dir in variants.items():
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so,
             os.path.join(src_dir, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(so)
    return libs


def padded_global(fn):
    """``launch_any_flat`` with its global slot count rounded up to the
    128-slot chunk of the TPU kernel's lane layout."""
    def call(*args):
        args = list(args)
        args[G_SLOTS_ARG] = -(-args[G_SLOTS_ARG] // 128) * 128
        return fn(*args)
    return call


def without_options(fn, name):
    """Entry point ``name`` of a variant without the ``counts`` / ``visits``
    arguments, called with the checkout's signature: drops the two, which
    must be null."""
    drop = OPTION_ARGS[name]

    def call(*args):
        if any(args[i].value is not None for i in drop):
            raise ValueError(f"{name}: this variant takes no counts or "
                             "visits")
        return fn(*(a for i, a in enumerate(args) if i not in drop))
    return call


@contextlib.contextmanager
def swapped_in(lib, entries, variant, padded=False, no_options=False):
    """The wrappers' ``entries`` replaced by ``variant``'s (None: the
    checkout's own stay); with ``padded`` its K2 through
    :func:`padded_global`, with ``no_options`` each entry point through
    :func:`without_options`."""
    saved = {name: getattr(lib, name) for name in entries}
    if variant is not None:
        for name in entries:
            fn = getattr(variant, name)
            types = saved[name].argtypes
            if no_options and name in OPTION_ARGS:
                types = [t for i, t in enumerate(types)
                         if i not in OPTION_ARGS[name]]
                fn.argtypes, fn.restype = types, ctypes.c_int
                fn = without_options(fn, name)
            else:
                fn.argtypes, fn.restype = types, ctypes.c_int
            setattr(lib, name, padded_global(fn)
                    if padded and name == "launch_any_flat" else fn)
    try:
        yield
    finally:
        for name in entries:
            setattr(lib, name, saved[name])


def record_passes(renderer):
    """The rays of every closest, rank and shadow pass of one sample."""
    import torch

    from metal_raytracing_tpu_torch import renderer as R

    closest, any_hit = R.make_tracers(renderer.data, renderer.spec, "cuda")
    rank = R.make_closest_rank(renderer.data, renderer.spec, renderer.cfg,
                               "cuda", closest)
    calls = {"closest": [], "any": [], "rank": []}

    def rec_closest(o, d, m, seed, seed_base=None):
        if seed_base is None:
            calls["closest"].append((o.contiguous(), d.contiguous(),
                                     m.clone(), seed.clone()))
        return closest(o, d, m, seed, seed_base)

    def rec_rank(o, d, m, rank_keys, seed):
        calls["rank"].append((o.contiguous(), d.contiguous(), m.clone(),
                              tuple(rank_keys), seed))
        return rank(o, d, m, rank_keys, seed)

    def rec_any(o, d, mt, m):
        calls["any"].append((o.contiguous(), d.contiguous(), mt.clone(),
                             m.clone()))
        return any_hit(o, d, mt, m)

    R.render_sample(renderer.data, renderer.spec, renderer.cfg,
                    renderer.offsets, 0,
                    tracers=(rec_closest, rec_any, rank and rec_rank))
    torch.cuda.synchronize()
    return calls


def shuffled(args):
    import torch

    n = args[0].shape[0]
    perm = torch.randperm(n, device=args[0].device,
                          generator=torch.Generator(args[0].device)
                          .manual_seed(0))
    return tuple(a[perm].contiguous() for a in args)


def gather_bvh_passes():
    """name -> (kind, args, tables) of dragon 1024x1024's and coatball
    1024x768's recorded passes for the BVH kernels: ``closest`` args (o, d,
    mask), ``any`` args (o, d, max_t, mask); tables (geometry, node_lo,
    node_hi, spec)."""
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    passes = {}
    for scene, (w, h) in (("dragon", (SIZE, SIZE)), ("coatball", COATBALL)):
        r = Renderer(get_scene(scene, w, h), RenderConfig(width=w, height=h),
                     device="cuda")
        tabs = (r.data.geometry, r.data.node_lo, r.data.node_hi, r.spec.bvh)
        calls = record_passes(r)
        for b, (o, d, m, _) in enumerate(calls["closest"]):
            passes[f"{scene} closest bounce {b}"] = ("closest", (o, d, m),
                                                     tabs)
        for b, args in enumerate(calls["any"]):
            passes[f"{scene} any bounce {b}"] = ("any", args, tabs)
    return passes


def gather_passes(flat: bool):
    """name -> (kind, args): ``closest`` args (o, d, mask, seed, seed_base),
    ``any`` args (o, d, max_t, mask); and the plane tables."""
    from metal_raytracing_tpu_torch.ops import rank_cuda as RK
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    passes = {}
    w, h = COATBALL if flat else (SIZE, SIZE)
    scene = get_scene("coatball" if flat else "dragon", w, h)
    plain = Renderer(scene, RenderConfig(width=w, height=h), device="cuda")
    tabs = (plain.data.sup_planes, plain.data.clu_planes,
            plain.data.tri_planes, plain.spec.bvh)
    closest, any_ = ("K1", "K2") if flat else ("K3", "K4")
    calls = record_passes(plain)
    for b, (o, d, m, seed) in enumerate(calls["closest"]):
        passes[f"{closest} bounce {b}"] = ("closest", (o, d, m, seed, None))
    for b, args in enumerate(calls["any"]):
        passes[f"{any_} bounce {b}"] = ("any", args)
    if flat:
        return passes, tabs
    sl = Renderer(scene, RenderConfig(width=SIZE, height=SIZE, **SLICE),
                  device="cuda")
    calls = record_passes(sl)
    for b, (o, d, m, keys, seed) in enumerate(calls["rank"], start=1):
        passes[f"K3 sorted bounce {b}"] = ("closest", (o, d, m, seed, None))
        so, sd, sm, sseed = shuffled((o, d, m, seed))
        passes[f"K3 random bounce {b}"] = ("closest", (so, sd, sm, sseed,
                                                       None))
        key, base = RK.trace_closest_rank(o, d, m, list(keys[:2]),
                                          sl.data.tri_planes, sl.spec.bvh,
                                          seed)
        unresolved = m & ~RK.rank_certificate(key, keys[2])
        passes[f"K3 seeded bounce {b}"] = ("closest", (o, d, unresolved, key,
                                                       base))
    for b in (1, 2):
        args = calls["any"][b]
        passes[f"K4 sorted bounce {b}"] = ("any", args)
        passes[f"K4 random bounce {b}"] = ("any", shuffled(args))
    return passes, tabs


def in_turns(lib, libs, entries, measure, padded=(), no_options=()):
    """``measure()`` with each variant's kernels swapped in (the checkout's
    first), forwards through the variants and then backwards: a list of
    (name, value), forwards then backwards."""
    names = [None] + list(libs)
    cells = []
    for name in names + names[::-1]:
        with swapped_in(lib, entries, libs.get(name), name in padded,
                        name in no_options):
            cells.append((name or "tree", measure()))
    return cells


def _cells_text(cells, extra):
    """One variant a cell, forwards / backwards, from :func:`in_turns`'
    cells; ``extra(name, fwd, bwd)`` gives the text after the name."""
    half = len(cells) // 2
    return "; ".join(f"{n} " + extra(n, fwd, cells[2 * half - 1 - i][1])
                     for i, (n, fwd) in enumerate(cells[:half]))


def _pass_runs(family):
    """label -> (live mask, run): each recorded pass of the family's kernels
    as a function of no arguments that returns the outputs' bits."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace as PT
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    runs = {}
    if family == "bvh":
        for label, (kind, args, tabs) in gather_bvh_passes().items():
            if kind == "closest":
                def run(args=args, tabs=tabs):
                    hit = PT.trace_closest(*args, *tabs)
                    return torch.stack([hit.tri] + [
                        x.view(torch.int32) for x in (hit.t, hit.u, hit.v)],
                        dim=1)
            else:
                run = lambda args=args, tabs=tabs: PT.trace_any(*args, *tabs)
            runs[label] = (args[-1] if kind == "any" else args[2], run)
        return runs
    passes, tabs = gather_passes(family == "flat")
    for label, (kind, args) in passes.items():
        if kind == "closest":
            o, d, m, seed, sbase = args

            def run(o=o, d=d, m=m, seed=seed, sbase=sbase):
                hit = TC.trace_closest(o, d, m, *tabs, seed, seed_base=sbase)
                return torch.stack([hit.tri, hit.t.view(torch.int32)], dim=1)
        else:
            o, d, mt, m = args
            run = lambda o=o, d=d, mt=mt, m=m: TC.trace_any(o, d, mt, m, *tabs)
        runs[label] = (m, run)
    return runs


def time_passes(lib, libs, card, entries, padded, family, no_options=()):
    for label, (m, run) in _pass_runs(family).items():
        ref = run()

        def equal_share():
            same = run() == ref
            return float((same.all(dim=1) if same.dim() > 1 else same)
                         .float().mean())

        cells = in_turns(lib, libs, entries, lambda: (
            equal_share(), cuda_ms(run)), padded, no_options)
        text = _cells_text(cells, lambda n, f, bk: (
            f"{f[1]:.3f} / {bk[1]:.3f} ms"
            + ("" if n == "tree" else f" (equal {f[0]:.6f})")))
        log(f"  {label} ({int(m.sum())} live of {m.shape[0]}): {text}; on "
            f"{card}")


def time_rank(lib, libs, card, entries, no_options=()):
    """K6 variants on dragon's sorted bounce passes: equality with the
    checkout's key and base, uncertified rays, K6 ms, and K6 + certificate
    + the checkout's seeded K3 against K3 alone."""
    import torch

    from metal_raytracing_tpu_torch import renderer as R
    from metal_raytracing_tpu_torch.ops import rank_cuda as RK
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig

    sl = Renderer(get_scene("dragon", SIZE, SIZE),
                  RenderConfig(width=SIZE, height=SIZE, **SLICE),
                  device="cuda")
    tabs = (sl.data.sup_planes, sl.data.clu_planes, sl.data.tri_planes,
            sl.spec.bvh)
    closest = R.make_tracers(sl.data, sl.spec, "cuda")[0]
    rank = R.make_closest_rank(sl.data, sl.spec, sl.cfg, "cuda", closest)
    for b, (o, d, m, keys, seed) in enumerate(record_passes(sl)["rank"],
                                              start=1):
        walk = lambda: torch.stack(RK.trace_closest_rank(
            o, d, m, list(keys[:2]), tabs[2], tabs[3], seed), dim=1)
        ref = walk()

        def measure():
            got = walk()
            return (float((got == ref).all(dim=1).float().mean()),
                    int((m & ~RK.rank_certificate(got[:, 0], keys[2])).sum()),
                    cuda_ms(walk),
                    cuda_ms(lambda: rank(o, d, m, keys, seed)))

        cells = in_turns(lib, libs, entries, measure,
                         no_options=no_options)
        ms_alone = cuda_ms(lambda: TC.trace_closest(o, d, m, *tabs, seed))
        text = _cells_text(cells, lambda n, f, bk: (
            f"{f[2]:.3f} / {bk[2]:.3f} ms, with certificate and seeded K3 "
            f"{f[3]:.3f} / {bk[3]:.3f} ms, uncertified {f[1]}"
            + ("" if n == "tree" else f", equal {f[0]:.6f}")))
        log(f"  K6 sorted bounce {b} ({int(m.sum())} live of {m.shape[0]}):"
            f" {text}; K3 alone {ms_alone:.3f} ms; on {card}")


def time_broadphase(lib, libs, card, entries):
    """K5 variants in the four modes on dragon's primary closest pass (the
    shadow pass for the any mode): equality with the checkout's outputs, ms
    by CUDA events and device ms from the profiler."""
    import torch

    from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig
    from metal_raytracing_tpu_torch.utils.metrics import kernel_device_ms

    r = Renderer(get_scene("dragon", SIZE, SIZE),
                 RenderConfig(width=SIZE, height=SIZE), device="cuda")
    calls = record_passes(r)
    clu, tri, bvh = r.data.clu_planes, r.data.tri_planes, r.spec.bvh
    for label, kind, want2, with_clusters, any_mode in BP.BROADPHASE_MODES:
        if kind == "any":
            o, d, mt, m = calls["any"][0]
        else:
            (o, d, m, _), mt = calls["closest"][0], None

        def run():
            out = BP.broadphase_keys(o, d, m, clu, tri, bvh, max_t=mt,
                                     want2=want2,
                                     with_clusters=with_clusters,
                                     any_mode=any_mode)
            return torch.stack([x for x in out if x is not None], dim=1)

        ref = run()
        cells = in_turns(lib, libs, entries, lambda: (
            float((run() == ref).all(dim=1).float().mean()), cuda_ms(run),
            kernel_device_ms(run, "broadphase_kernel")))
        text = _cells_text(cells, lambda n, f, bk: (
            f"{f[1]:.3f} / {bk[1]:.3f} ms, device {f[2]:.4f} / {bk[2]:.4f} "
            "ms" + ("" if n == "tree" else f" (equal {f[0]:.6f})")))
        log(f"  K5 {label} ({int(m.sum())} live of {m.shape[0]}): {text}; "
            f"on {card}")


def time_renders(lib, libs, card, samples: int, entries, padded, family,
                 no_options=()):
    import torch

    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.scenes import get_scene
    from metal_raytracing_tpu_torch.types import RenderConfig
    from metal_raytracing_tpu_torch.utils.metrics import profile_renderer

    flat = family == "flat"
    w, h = COATBALL if flat else (SIZE, SIZE)
    scene = get_scene("coatball" if flat else "dragon", w, h)
    for label, kw in RENDERS[family]:
        r = Renderer(scene, RenderConfig(width=w, height=h, **kw),
                     device="cuda")
        seen = []  # every earlier turn's graphs (reset: they hold no pool)
        images = []  # each turn's image of its first `samples` samples

        def measure():
            # A graph holds the kernels it was captured with, so each turn
            # drops the last turn's and captures its own, with the
            # variant's kernels, before its timed window: the warm-up
            # render takes the timed render's steps.
            r.drop_graphs()
            r.reset()
            images.append(r.render(samples))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(samples)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / samples * 1e3
            prof = profile_renderer(r, 2)
            graphs = list(r.graphs.values())
            if any(g is old for g in graphs for old in seen):
                raise RuntimeError("a turn replayed another turn's graph")
            for g in graphs:
                g.reset()
            seen.extend(graphs)
            return ms, prof

        cells = in_turns(lib, libs, entries, measure, padded, no_options)
        for (name, (ms, prof)), img in zip(cells, images):
            top = ", ".join(f"{k[:24]} {v / prof.samples:.3f}"
                            for k, v, _ in prof.kernels[:3])
            same = bool(np.array_equal(img, images[0]))
            log(f"  {label}, {name}: {ms:.3f} ms/sample, device "
                f"{prof.device_ms_per_sample:.3f} ms/sample ({top}); image "
                f"of {samples} samples equal to the first turn's: {same}; "
                f"on {card}")
            if family == "bvh" and not same:
                raise RuntimeError(f"{label}, {name}: the image differs from "
                                   "the first turn's")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="NAME=DIR")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--flat", action="store_const", dest="family",
                       const="flat", default="hier",
                       help="K1/K2 on coatball 1024x768 (default: K3/K4 on "
                       "dragon 1024x1024)")
    which.add_argument("--rank", action="store_const", dest="family",
                       const="rank", help="K6 on dragon's sorted passes")
    which.add_argument("--broadphase", action="store_const", dest="family",
                       const="broadphase", help="K5 in its four modes")
    which.add_argument("--bvh", action="store_const", dest="family",
                       const="bvh", help="the exact tracers' kernels on "
                       "dragon's and coatball's passes")
    ap.add_argument("--render", action="store_true",
                    help="also time the main path with each variant")
    ap.add_argument("--padded", action="append", default=[], metavar="NAME",
                    help="give variant NAME's K2 the padded global width")
    ap.add_argument("--no-options", action="append", default=[],
                    metavar="NAME", help="variant NAME's entry points take "
                    "no counts / visits arguments")
    ap.add_argument("--samples", type=int, default=4)
    args = ap.parse_intermixed_args()
    if not torch.cuda.is_available():
        print("variant_bench: needs a CUDA GPU", file=sys.stderr)
        return 1
    from metal_raytracing_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    source, entries = KERNELS[args.family]
    lib = _build.load_library()
    for line in _build.build_log.splitlines():
        if "Compiling" in line or "registers" in line or "spill" in line:
            log(f"  ptxas tree: {line.strip()}")
    variants = dict(v.split("=", 1) for v in args.variants)
    padded, no_options = set(args.padded), set(args.no_options)
    for flag, names in (("--padded", padded), ("--no-options", no_options)):
        if not names <= set(variants):
            ap.error(f"{flag} names no variant: "
                     f"{sorted(names - set(variants))}")
    libs = build_variants(variants, source)
    log("per pass, forwards / backwards:")
    if args.family == "rank":
        time_rank(lib, libs, card, entries, no_options)
    elif args.family == "broadphase":
        time_broadphase(lib, libs, card, entries)
    else:
        time_passes(lib, libs, card, entries, padded, args.family,
                    no_options)
    if args.render:
        log("main path, forwards then backwards:")
        time_renders(lib, libs, card, args.samples, entries, padded,
                     args.family, no_options)
    return 0


if __name__ == "__main__":
    sys.exit(main())
