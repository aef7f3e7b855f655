"""device.idle_pct: 100 x (1 - the device's busy time over the wall time)
of a profiled window of graph replays; busy is the union of the device
operations' spans."""


def read(record):
    t = record["trace"]
    if not t or t["graphed"]["busy_s"] <= 0:
        return None
    g = t["graphed"]
    return 100.0 * (1.0 - g["busy_s"] / g["window_s"])
