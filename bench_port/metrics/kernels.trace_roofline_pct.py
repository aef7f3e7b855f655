"""kernels.trace_roofline_pct: the least time of the window's traversal
work over the traversal kernels' device time, in percent.  The least time
(``bench_port.yardstick.trace_least_s``) is the larger of each traced
ray's bytes (in once, out once) over HBM's rate and one Moller-Trumbore
test a ray over the card's FP32 issue rate; the rays are the renderer's
own counters over the same window."""

from bench_port.harness import load_reader
from bench_port.yardstick import trace_least_s


def read(record):
    t = record["trace"]
    card = record["card"]
    if not t or not card:
        return None
    g = t["graphed"]
    spent = load_reader("kernels.trace_ms").trace_s(g)
    if spent <= 0:
        return None
    least = trace_least_s(g["closest_rays"], g["shadow_rays"],
                          card["issue_rate"], card["hbm_bytes_per_s"])
    return 100.0 * least / spent
