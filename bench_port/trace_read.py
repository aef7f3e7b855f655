"""Reduce a ``torch.profiler`` trace to what the per-layer readers read.

Works on the profiler's ``FunctionEvent`` list (``prof.events()``), or on
any objects with the same attributes (``name``, ``id``, ``device_type``,
``is_user_annotation``, ``time_range``), so the reduction is tested on
canned records.  A device operation and the host runtime call that
launched it share their ``id`` (the CUDA correlation id).  Times are microseconds, as
the profiler gives them.

The renderer's layer spans (``named_scope``) show twice in a trace: as
host ranges, and on the device as user annotations that span their
kernels.  The annotations are left out of every device sum, or the time
of those kernels would count twice.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

from torch.autograd import DeviceType

__all__ = ["scope_device_us", "device_rows", "kernel_table", "busy_us",
           "launch_calls", "idle_gaps", "short_name", "is_memory_op"]

_DEVICE = (DeviceType.CUDA,)


def _is_annotation(e, scopes) -> bool:
    """A device-side span (``record_function`` ranges are user annotations
    on the host side too, where they are the spans themselves)."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name in scopes


def is_memory_op(name: str) -> bool:
    """A copy or set the device ran (CUPTI names them ``Memcpy ...`` /
    ``Memset ...``; inside a CUDA graph replay they are not recorded)."""
    return name.startswith(("Memcpy", "Memset"))


def scope_device_us(events: Iterable, scopes: Tuple[str, ...]
                    ) -> Dict[Optional[str], float]:
    """Device microseconds of the operations each layer span launched:
    each device operation goes, through the host runtime call that
    launched it (the same correlation ``id``), to the innermost host span
    named in ``scopes`` open at that call (key None: no span, or no
    runtime call found).  Kernels launched through ``ctypes`` have no
    PyTorch operator around them, so the call's time, not the operator
    tree, places them."""
    events = list(events)
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in events
                    if e.device_type not in _DEVICE and e.name in scopes),
                   key=lambda s: s[0])
    runtime = {e.id: e for e in events
               if e.device_type not in _DEVICE and e.name.startswith("cu")}
    out: Dict[Optional[str], float] = {}
    for e in events:
        if e.device_type not in _DEVICE or _is_annotation(e, scopes):
            continue
        call = runtime.get(e.id)
        scope = None
        if call is not None:
            ts = call.time_range.start
            for t0, t1, name in spans:
                if t0 > ts:
                    break
                if ts < t1:
                    scope = name  # later starts are the inner spans
        dur = e.time_range.end - e.time_range.start
        out[scope] = out.get(scope, 0.0) + dur
    return out


def device_rows(events: Iterable, scopes: Tuple[str, ...]
                ) -> List[Tuple[str, float, float]]:
    """(name, start, end) of every device operation (kernels, copies,
    sets), the layer annotations left out, in start order."""
    rows = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type in _DEVICE and not _is_annotation(e, scopes)]
    return sorted(rows, key=lambda r: r[1])


def kernel_table(rows) -> Dict[str, List[float]]:
    """name -> [device microseconds, records]."""
    out: Dict[str, List[float]] = {}
    for name, t0, t1 in rows:
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += t1 - t0
        acc[1] += 1
    return out


def _merged(rows):
    spans: List[List[float]] = []
    for _, t0, t1 in rows:
        if spans and t0 <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], t1)
        else:
            spans.append([t0, t1])
    return spans


def busy_us(rows) -> float:
    """Microseconds in which some device operation ran (their union)."""
    return sum(t1 - t0 for t0, t1 in _merged(rows))


def launch_calls(events: Iterable) -> int:
    """Host calls that launched device work: the runtime rows whose name
    starts with ``cu`` and holds ``Launch`` (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaGraphLaunch``, ...)."""
    return sum(1 for e in events
               if e.device_type not in _DEVICE and e.name.startswith("cu")
               and "Launch" in e.name)


def idle_gaps(rows, events: Iterable, top: int = 10
              ) -> List[Tuple[str, float]]:
    """The ``top`` longest gaps between device operations, each named by
    the innermost host event running when it began ("host" if none), in
    microseconds, longest first."""
    spans = _merged(rows)
    gaps = [(spans[i][1], spans[i + 1][0]) for i in range(len(spans) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.device_type not in _DEVICE]
    out = []
    for g0, g1 in gaps[:top]:
        inner = None
        for e in host:
            if e.time_range.start <= g0 < e.time_range.end and (
                    inner is None or e.time_range.start
                    >= inner.time_range.start):
                inner = e
        out.append((inner.name if inner is not None else "host", g1 - g0))
    return out


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:limit]
