"""Profiling harness: ``torch.profiler`` traces, named scopes and fenced
timing.

The port's counterpart of ``metal_raytracing_tpu.utils.profiling``.  The
renderer wraps its layers in :func:`named_scope` under the layer names of
PERF.md (``raygen``, ``global passes``, ``sort keys``, ``closest trace``,
``shade``, ``shadow trace``, ``bounce + accumulate``), so a trace taken with
:func:`trace` shows each layer's host span and, through the profiler's
correlation, the kernels it launched; with CUDA up each scope is also an
NVTX range.  A scope launches nothing and waits for nothing.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable

import torch

__all__ = ["trace", "named_scope", "timed", "sync", "TRACE_FILE", "SCOPES"]

TRACE_FILE = "trace.json"  # the Chrome trace :func:`trace` writes
# The renderer's scope names, one a layer of PERF.md.
SCOPES = ("raygen", "global passes", "sort keys", "closest trace", "shade",
          "shadow trace", "bounce + accumulate")


@functools.cache
def _cuda_up() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and, with CUDA up, device activity) and
    write a Chrome trace to ``log_dir/trace.json`` (Perfetto,
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if _cuda_up() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def named_scope(name: str):
    """A named span: a ``torch.profiler.record_function`` range and, with
    CUDA up, an NVTX range of the same name."""
    with torch.profiler.record_function(name):
        if _cuda_up():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def sync() -> None:
    """Fence: wait for the card's work (a no-op without CUDA)."""
    if _cuda_up() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1):
    """(seconds a call, last output) of ``fn(*args)``: ``warmup`` untimed
    calls, then ``iters`` calls back to back, fenced once, so the per-call
    launch cost amortizes as in a progressive render loop.  Timed by CUDA
    events on the card, by a fenced ``perf_counter`` without CUDA."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    sync()
    if _cuda_up() and torch.cuda.is_initialized():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters, out
