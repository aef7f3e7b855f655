"""step_mfu: the whole step's share of the card's peak, in percent: the
least time of the traversal work a sample needs (as
``kernels.trace_roofline_pct`` counts it) over the wall time a sample of
the profiled window of graph replays.  It takes no kernel names, so it
still reads, and still bounds the traversal's share, where the traversal
moves to kernels that ``kernels.trace_ms`` does not list."""

from bench_port.yardstick import trace_least_s


def read(record):
    t = record["trace"]
    card = record["card"]
    if not t or not card:
        return None
    g = t["graphed"]
    if g["window_s"] <= 0 or g["closest_rays"] <= 0:
        return None
    least = trace_least_s(g["closest_rays"], g["shadow_rays"],
                          card["issue_rate"], card["hbm_bytes_per_s"])
    return 100.0 * least / g["window_s"]
