"""kernels.wide_trace_roofline_pct: the least time of the window's
traversal work (``bench_port.yardstick.trace_least_s``, as
``kernels.trace_roofline_pct`` counts it) over the device time of the wide
hierarchical instances (``kernels.wide_trace_ms``), in percent.  Read in
cells whose every traced ray the wide instances trace: the yardstick is
the same work whatever implements it."""

from bench_port.harness import load_reader
from bench_port.yardstick import trace_least_s


def read(record):
    t = record["trace"]
    card = record["card"]
    if not t or not card:
        return None
    g = t["graphed"]
    spent, _ = load_reader("kernels.wide_trace_ms").wide_kernels(g)
    if spent <= 0:
        return None
    least = trace_least_s(g["closest_rays"], g["shadow_rays"],
                          card["issue_rate"], card["hbm_bytes_per_s"])
    return 100.0 * least / spent
