"""kernels.wide_trace_ms: device milliseconds a sample of the wide
instances of the hierarchical kernels in a profiled window of graph
replays: ``closest_hier_kernel<true, ...>`` and ``any_hier_kernel<true>``
(``csrc/trace_hier.cu``), which the launchers pick for supers of more than
32 clusters and which read the cluster boxes from device memory.  The
profiler's kernel name carries the template arguments; the first, true,
tells a wide instance from a shared one."""

import re

WIDE = re.compile(r"\b(?:closest|any)_hier_kernel<true\b")


def wide_kernels(graphed):
    """(device seconds, records) of the wide instances in the window."""
    rows = [v for name, v in graphed["kernels"].items() if WIDE.search(name)]
    return sum(s for s, _ in rows), sum(c for _, c in rows)


def read(record):
    t = record["trace"]
    if not t:
        return None
    g = t["graphed"]
    s, _ = wide_kernels(g)
    return 1e3 * s / g["samples"] if s > 0 else None
