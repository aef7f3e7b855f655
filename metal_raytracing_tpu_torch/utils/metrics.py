"""Metrics & timing: Mrays/s and wall clock per sample.

The port's counterpart of ``metal_raytracing_tpu.utils.metrics``.  Rays per
second count closest-hit plus shadow rays actually traced (the two
intersector call sites of the reference, Raytracing.metal:244 and :367), as
the reference does.  The timed window is fenced with
``torch.cuda.synchronize()`` on a CUDA device: PyTorch returns before the
card finishes its work.  :func:`wavefront_stats` and :func:`visit_percentiles`
read the traversal telemetry (``RenderConfig.telemetry``) with the JAX
package's keys; the port's visits are per ray where the JAX package's are
per 128-ray tile.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

__all__ = ["BenchResult", "benchmark_renderer", "ProfileResult",
           "profile_renderer", "kernel_device_ms", "wavefront_stats",
           "visit_percentiles"]


@dataclasses.dataclass
class BenchResult:
    scene: str
    width: int
    height: int
    samples: int
    rays: int  # closest + shadow rays actually traced
    seconds: float  # wall clock over the timed samples
    warmup_seconds: float  # the untimed warm-up samples (first-use builds)
    device: str  # the device the samples ran on

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / max(self.seconds, 1e-12) / 1e6

    @property
    def per_sample_seconds(self) -> float:
        return self.seconds / max(self.samples, 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_renderer(renderer, samples: int = 4,
                       warmup: int = 1) -> BenchResult:
    """Time ``samples`` progressive steps after ``warmup`` untimed ones
    (the first builds the kernels and, where the renderer runs CUDA graphs,
    captures its batch's); ray counts come from the renderer's own
    traced-ray totals.  A step renders the renderer's dispatch batch
    (``samples_per_dispatch``, or a sharded step's samples), so the samples
    are counted from ``total_samples``, as in the JAX package."""
    dev = renderer.device
    t0 = time.perf_counter()
    for _ in range(warmup):
        renderer.step()
    _sync(dev)
    warmup_s = time.perf_counter() - t0

    rays_before = renderer.total_closest_rays + renderer.total_shadow_rays
    samples_before = renderer.total_samples
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(samples):
        renderer.step()
    _sync(dev)
    seconds = time.perf_counter() - t0
    rays = (renderer.total_closest_rays + renderer.total_shadow_rays
            - rays_before)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    return BenchResult(
        scene=getattr(renderer.scene, "name", "scene"),
        width=renderer.cfg.width, height=renderer.cfg.height,
        samples=renderer.total_samples - samples_before, rays=rays,
        seconds=seconds, warmup_seconds=warmup_s, device=name)


@dataclasses.dataclass
class ProfileResult:
    samples: int
    device_ms: float  # kernel time on the card over the window
    launches: int  # kernels the card ran over the window
    kernels: list  # (name, device ms, launches), most device time first
    launch_calls: int  # host calls that launched them (or a graph of them)

    @property
    def device_ms_per_sample(self) -> float:
        return self.device_ms / max(self.samples, 1)


def _kernel_rows(prof):
    """The profiler's averaged device rows of the kernels themselves: the
    renderer's named scopes (``utils.profiling.named_scope``) also show on
    the device timeline as user annotations spanning their kernels, which
    would count those kernels twice."""
    from torch.autograd import DeviceType

    from .profiling import SCOPES

    return [evt for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and evt.key not in SCOPES
            and not getattr(evt, "is_user_annotation", False)]


def profile_renderer(renderer, samples: int = 2,
                     steps: int = 1) -> ProfileResult:
    """Device time by kernel over ``steps`` steps of ``samples`` samples on
    a CUDA device (``torch.profiler``, CUPTI): each kernel's device time and
    launch count, from the kernel events alone (an operator's row repeats
    its kernels' time, and the named scopes are left out), and the host's
    launch calls, the runtime rows whose name holds "Launch"
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``).
    Where the renderer runs CUDA graphs, the graph of ``samples`` samples
    is captured before the window, which then holds its replays.  The
    profiler slows the host, so read a device busy share against the wall
    time of an unprofiled run."""
    from torch.profiler import ProfilerActivity, profile

    if renderer.graphed:
        renderer.graph(samples)
    torch.cuda.synchronize(renderer.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            renderer.step(samples)
        torch.cuda.synchronize(renderer.device)
    rows = [(evt.key, evt.device_time_total / 1e3, evt.count)
            for evt in _kernel_rows(prof)]
    rows.sort(key=lambda r: -r[1])
    calls = sum(evt.count for evt in prof.key_averages()
                if evt.key.startswith("cu") and "Launch" in evt.key)
    return ProfileResult(samples=samples * steps,
                         device_ms=sum(r[1] for r in rows),
                         launches=sum(r[2] for r in rows), kernels=rows,
                         launch_calls=calls)


def kernel_device_ms(fn, kernel: str, iters: int = 10) -> float:
    """Mean device milliseconds of one launch of the CUDA kernel whose name
    holds ``kernel``, over ``iters`` calls of ``fn()`` after one warm-up
    call (``torch.profiler``, CUPTI): the device's own time, which CUDA
    events around a few-microsecond kernel cannot tell apart from the
    host's launch cost.  Averaged over the launches the profiler recorded,
    so a record it dropped does not count as zero time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(evt.device_time_total, evt.count) for evt in _kernel_rows(prof)
            if kernel in evt.key]
    launches = sum(n for _, n in rows)
    if not launches:
        raise RuntimeError(f"the profiler recorded no launch of {kernel}")
    return sum(t for t, _ in rows) / 1e3 / launches


def wavefront_stats(data, spec, cfg, offsets,
                    tracer=None) -> Dict[str, object]:
    """Per-bounce wavefront occupancy (live-ray share) and shadow rays of
    one sample, from the renderer's ray counters at depths 1..max_bounces
    (``metal_raytracing_tpu.utils.metrics.wavefront_stats``, the same
    keys).  ``tracer`` as ``render_sample`` takes it (default: the one
    ``cfg`` resolves to on the scene's device).  Waits for the device."""
    from ..renderer import render_sample, resolve_tracer

    tracer = tracer or resolve_tracer(cfg, data.device)
    counts: List[int] = []
    shadows: List[int] = []
    prev_c = prev_s = 0
    for b in range(1, cfg.max_bounces + 1):
        cfg_b = dataclasses.replace(cfg, max_bounces=b)
        _, stats = render_sample(data, spec, cfg_b, offsets, 0, tracer)
        c, s = int(stats["closest_rays"]), int(stats["shadow_rays"])
        counts.append(c - prev_c)
        shadows.append(s - prev_s)
        prev_c, prev_s = c, s
    n = cfg.width * cfg.height
    return {
        "pixels": n,
        "closest_per_bounce": counts,
        "shadow_per_bounce": shadows,
        "occupancy_per_bounce": [c / n for c in counts],
        "total_rays": prev_c + prev_s,
        "rays_per_pixel": (prev_c + prev_s) / n,
    }


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def visit_percentiles(stats: Dict[str, object],
                      pixels: int = 0) -> Dict[str, object]:
    """Cluster-visit percentiles from telemetry render stats, with the keys
    and empty-stats guards of ``metal_raytracing_tpu.utils.metrics
    .visit_percentiles``; {} without ``visits_*`` keys (the exact tracers).
    Visits are per ray here: rays with no visit (dead, or settled by the
    global set) are left out of the bounce and shadow figures, and their
    share is reported.  With ``pixels`` also the per-bounce live-ray and
    shadow-ray shares."""
    def _bounce_order(prefix):
        keys = [k for k in stats if k.startswith(prefix)]
        return sorted(keys, key=lambda k: int(k[len(prefix):]))

    def _mean_visited(a):
        return round(float(a[a > 0].mean()), 2) if (a > 0).any() else 0.0

    out: Dict[str, object] = {}
    if pixels:
        lkeys = _bounce_order("live_b")
        if lkeys:
            out["live_frac_by_bounce"] = [
                round(int(stats[k]) / pixels, 4) for k in lkeys]
        skeys_n = _bounce_order("shadow_b")
        if skeys_n:
            out["shadow_frac_by_bounce"] = [
                round(int(stats[k]) / pixels, 4) for k in skeys_n]
    vkeys = _bounce_order("visits_b")
    if vkeys:
        prim = _host(stats[vkeys[0]])
        out["visits_primary_p50_p90"] = [
            round(float(np.percentile(prim, 50)), 1),
            round(float(np.percentile(prim, 90)), 1)]
        if len(vkeys) > 1:
            ball = np.concatenate([_host(stats[k]) for k in vkeys[1:]])
            b = ball[ball > 0]
            if b.size:
                out["visits_bounce_p50_p90"] = [
                    round(float(np.percentile(b, 50)), 1),
                    round(float(np.percentile(b, 90)), 1)]
                out["bounce_visits_mean"] = round(float(b.mean()), 2)
                out["bounce_zero_visit_frac"] = round(
                    float((ball == 0).mean()), 3)
                out["bounce_visits_mean_by_bounce"] = [
                    _mean_visited(_host(stats[k])) for k in vkeys[1:]]
    okeys = _bounce_order("shadow_occn_b")
    if okeys:
        # the occluded share of the rays that took a shadow test
        out["shadow_occluded_frac_by_bounce"] = [
            round(int(stats[k])
                  / max(1, int(stats.get(k.replace("occn_", ""), 0))), 4)
            for k in okeys]
    skeys = _bounce_order("shadow_visits_b")
    if skeys:
        sall = np.concatenate([_host(stats[k]) for k in skeys])
        sv = sall[sall > 0]
        if sv.size:
            out["shadow_visits_p50_p90_mean"] = [
                round(float(np.percentile(sv, 50)), 1),
                round(float(np.percentile(sv, 90)), 1),
                round(float(sv.mean()), 2)]
            out["shadow_zero_visit_frac"] = round(
                float((sall == 0).mean()), 3)
            out["shadow_visits_mean_by_bounce"] = [
                _mean_visited(_host(stats[k])) for k in skeys]
    return out
