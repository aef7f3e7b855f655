"""Profiling harness: ``torch.profiler`` traces, named scopes, a span log,
layer marks inside captured CUDA graphs, and fenced timing.

The port's counterpart of ``metal_raytracing_tpu.utils.profiling``.  The
renderer wraps its layers in :func:`named_scope` under the layer names of
PERF.md (``raygen``, ``global passes``, ``sort keys``, ``closest trace``,
``shade``, ``shadow trace``, ``bounce + accumulate``), so a trace taken
with :func:`trace` shows each layer's host span and, through the profiler's
correlation, the kernels it launched; with CUDA up each scope is also an
NVTX range.  A scope launches nothing and waits for nothing.  Set-up runs
under scopes of its own: ``obj parse`` (``parser load``, ``parser
build``), ``cuda init``, ``scene build`` (``bvh build``, ``pack planes``,
``upload``), ``bake``, ``pixel offsets``, ``kernel load`` (``kernel
build``), ``warm-up sample`` and ``graph capture``.

Two recorders hang off the same scopes, each off until a caller opens it:

- :func:`span_log` keeps every scope entered while it is open as a
  :class:`Span` (name, parent, start and end) on the clock of the profiler's
  host events, so a logged span lines up with a device trace taken at the
  same time;
- :func:`marking` (which ``Renderer.set_marks`` arranges around a graph
  capture) records a timing event on the device at the entry and the exit
  of every scope, so the replays of the captured graph time their layers.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["trace", "named_scope", "timed", "sync", "TRACE_FILE", "SCOPES",
           "UNMARKED", "clock_ns", "Span", "SpanLog", "span_log", "Mark",
           "LayerMarks", "marking", "mark_bounce"]

TRACE_FILE = "trace.json"  # the Chrome trace :func:`trace` writes
# The renderer's scope names, one a layer of PERF.md.
SCOPES = ("raygen", "global passes", "sort keys", "closest trace", "shade",
          "shadow trace", "bounce + accumulate")
# layer_ms's key for the time of a step no layer scope covers
UNMARKED = "unmarked"

_log: contextvars.ContextVar[Optional["SpanLog"]] = contextvars.ContextVar(
    "span_log", default=None)
_marks: contextvars.ContextVar[Optional["LayerMarks"]] = (
    contextvars.ContextVar("layer_marks", default=None))


@functools.cache
def _cuda_up() -> bool:
    return torch.cuda.is_available()


def clock_ns() -> int:
    """Now, in ns, on the clock that ``torch.profiler``'s host events carry:
    the Unix clock (``CLOCK_REALTIME``), not ``perf_counter_ns``'s
    ``CLOCK_MONOTONIC``.  Kineto's events read ``time.time_ns`` on Linux in
    torch 2.13 (CPU build) and 2.11 (CUDA build)."""
    return time.time_ns()


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
    CUDA up, an NVTX range of the same name; also a :class:`Span` of the
    open :func:`span_log` and a pair of :class:`Mark` s of the open
    :func:`marking`, where either is open."""
    log, marks = _log.get(), _marks.get()
    i = log.enter(name) if log is not None else None
    if marks is not None:
        marks.mark(name, True)
    try:
        with torch.profiler.record_function(name):
            if _cuda_up():
                torch.cuda.nvtx.range_push(name)
                try:
                    yield
                finally:
                    torch.cuda.nvtx.range_pop()
            else:
                yield
    finally:
        if marks is not None:
            marks.mark(name, False)
        if log is not None:
            log.exit(i)


# -- the span log --------------------------------------------------------

@dataclasses.dataclass
class Span:
    """One scope entered while a log was open: ``parent`` is the index in
    the log of the span open around it (None at the top level); times in ns
    on :func:`clock_ns` (``end_ns`` None while it is open)."""

    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class SpanLog:
    """The spans of one :func:`span_log`, in the order they were entered."""

    def __init__(self):
        self.spans: List[Span] = []
        self._open: List[int] = []

    def enter(self, name: str) -> int:
        self.spans.append(Span(name, self._open[-1] if self._open else None,
                               clock_ns()))
        self._open.append(len(self.spans) - 1)
        return self._open[-1]

    def exit(self, i: int) -> None:
        self.spans[i].end_ns = clock_ns()
        self._open.pop()  # scopes close innermost first

    def parent_name(self, span: Span) -> Optional[str]:
        return None if span.parent is None else self.spans[span.parent].name

    def top_level(self) -> List[Span]:
        return [s for s in self.spans if s.parent is None]

    def self_s(self, span: Span) -> float:
        """``span``'s seconds less those of its children."""
        i = next(j for j, s in enumerate(self.spans) if s is span)
        return span.seconds - sum(c.seconds for c in self.spans
                                  if c.parent == i)

    def seconds(self, name: str) -> float:
        """Seconds of every span called ``name``, summed."""
        return sum(s.seconds for s in self.spans if s.name == name)


@contextlib.contextmanager
def span_log() -> Iterator[SpanLog]:
    """Log every :func:`named_scope` entered inside the block, in this
    thread; yields the :class:`SpanLog`.  Nothing is logged while none is
    open, and each span costs a clock read at each end while one is."""
    log = SpanLog()
    token = _log.set(log)
    try:
        yield log
    finally:
        _log.reset(token)


# -- layer marks in a captured graph -------------------------------------

@dataclasses.dataclass
class Mark:
    """A device timestamp taken at a scope's entry (``entering``) or exit:
    the scope (None for the step's own bracket), the sample's index within
    the step and the bounce, and the timing event recorded there."""

    scope: Optional[str]
    entering: bool
    sample: int
    bounce: int
    event: Any


class LayerMarks:
    """The marks of one captured step of a graph: each scope's entry and
    exit records a timing event (``torch.cuda.Event(enable_timing=True,
    external=True)``, an event-record node of the graph), so every replay
    sets their device times anew.  ``sample`` and ``bounce`` label the
    marks taken from then on."""

    def __init__(self):
        self.marks: List[Mark] = []
        self.sample = 0
        self.bounce = 0

    def mark(self, scope: Optional[str], entering: bool) -> None:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self.marks.append(Mark(scope, entering, self.sample, self.bounce,
                               event))

    def segments(self) -> List[Tuple[Optional[str], int, int, float]]:
        """(innermost scope open, sample, bounce, device ms) of each stretch
        between two marks of the last replay, in order; the scope is None
        where only the step's bracket is open.  Waits for the device to
        finish that replay."""
        self.marks[-1].event.synchronize()
        first = self.marks[0].event
        t = [first.elapsed_time(m.event) for m in self.marks]
        out, stack = [], []
        for i, m in enumerate(self.marks[:-1]):
            if m.entering:
                stack.append(m.scope)
            else:
                stack.pop()
            out.append((stack[-1] if stack else None, m.sample, m.bounce,
                        t[i + 1] - t[i]))
        return out

    def layer_ms(self) -> Dict[str, float]:
        """Device ms a sample of each scope in the last replay, a stretch to
        its innermost scope, bubbles included; :data:`UNMARKED` holds the
        stretches no layer scope covers.  Waits for the device."""
        samples = max(m.sample for m in self.marks) + 1
        out: Dict[str, float] = {}
        for scope, _, _, ms in self.segments():
            key = UNMARKED if scope is None else scope
            out[key] = out.get(key, 0.0) + ms / samples
        return out


@contextlib.contextmanager
def marking(marks: Optional[LayerMarks]):
    """Record ``marks`` in every :func:`named_scope` of the block, between
    a bracket mark at its start and one at its end (a no-op for None).  The
    block is a CUDA graph's capture: the marks become its nodes."""
    if marks is None:
        yield
        return
    token = _marks.set(marks)
    marks.mark(None, True)
    try:
        yield
    finally:
        marks.mark(None, False)
        _marks.reset(token)


def mark_bounce(bounce: int) -> None:
    """Label the open :func:`marking`'s next marks with ``bounce``."""
    marks = _marks.get()
    if marks is not None:
        marks.bounce = bounce


# -- timing ---------------------------------------------------------------

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
