"""kernels.wide_launches_per_sample: records of the wide hierarchical
instances (``kernels.wide_trace_ms``) in a profiled window of graph
replays over its samples; the program's own count of them is
``trace_closest.launches_wide`` + ``trace_any.launches_wide`` on an eager
sample."""

from bench_port.harness import load_reader


def read(record):
    t = record["trace"]
    if not t:
        return None
    g = t["graphed"]
    _, records = load_reader("kernels.wide_trace_ms").wide_kernels(g)
    return records / g["samples"] if records else None
