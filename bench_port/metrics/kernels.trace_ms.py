"""kernels.trace_ms: device milliseconds a sample of the traversal kernels
(``csrc/trace_flat.cu``, ``trace_hier.cu``, ``trace_rank.cu``,
``trace_bvh.cu``) in a profiled window of graph replays."""

KERNELS = ("closest_flat_kernel", "any_flat_kernel", "closest_hier_kernel",
           "any_hier_kernel", "closest_rank_kernel", "closest_bvh_kernel",
           "any_bvh_kernel")


def trace_s(graphed):
    """Device seconds of the traversal kernels in the window."""
    return sum(s for name, (s, _) in graphed["kernels"].items()
               if any(k in name for k in KERNELS))


def read(record):
    t = record["trace"]
    if not t:
        return None
    g = t["graphed"]
    s = trace_s(g)
    return 1e3 * s / g["samples"] if s > 0 else None
