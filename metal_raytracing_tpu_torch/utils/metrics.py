"""Metrics & timing: Mrays/s and wall clock per sample.

The port's counterpart of ``metal_raytracing_tpu.utils.metrics``.  Rays per
second count closest-hit plus shadow rays actually traced (the two
intersector call sites of the reference, Raytracing.metal:244 and :367), as
the reference does.  The timed window is fenced with
``torch.cuda.synchronize()`` on a CUDA device: PyTorch returns before the
card finishes its work.
"""

from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["BenchResult", "benchmark_renderer", "ProfileResult",
           "profile_renderer", "kernel_device_ms"]


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
    (the first builds the kernels); ray counts come from the renderer's own
    traced-ray totals."""
    dev = renderer.device
    t0 = time.perf_counter()
    renderer.step(warmup)
    _sync(dev)
    warmup_s = time.perf_counter() - t0

    rays_before = renderer.total_closest_rays + renderer.total_shadow_rays
    samples_before = renderer.total_samples
    _sync(dev)
    t0 = time.perf_counter()
    renderer.step(samples)
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

    @property
    def device_ms_per_sample(self) -> float:
        return self.device_ms / max(self.samples, 1)


def profile_renderer(renderer, samples: int = 2) -> ProfileResult:
    """Device time by kernel over ``samples`` progressive steps on a CUDA
    device (``torch.profiler``, CUPTI): each kernel's device time and
    launch count, from the kernel events alone (an operator's row repeats
    its kernels' time).  The profiler slows the host, so read a device busy
    share against the wall time of an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(renderer.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        renderer.step(samples)
        torch.cuda.synchronize(renderer.device)
    rows = [(evt.key, evt.device_time_total / 1e3, evt.count)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return ProfileResult(samples=samples,
                         device_ms=sum(r[1] for r in rows),
                         launches=sum(r[2] for r in rows), kernels=rows)


def kernel_device_ms(fn, kernel: str, iters: int = 10) -> float:
    """Mean device milliseconds of one launch of the CUDA kernel whose name
    holds ``kernel``, over ``iters`` calls of ``fn()`` after one warm-up
    call (``torch.profiler``, CUPTI): the device's own time, which CUDA
    events around a few-microsecond kernel cannot tell apart from the
    host's launch cost.  Averaged over the launches the profiler recorded,
    so a record it dropped does not count as zero time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(evt.device_time_total, evt.count) for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and kernel in evt.key]
    launches = sum(n for _, n in rows)
    if not launches:
        raise RuntimeError(f"the profiler recorded no launch of {kernel}")
    return sum(t for t, _ in rows) / 1e3 / launches
