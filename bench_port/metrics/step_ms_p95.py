"""step_ms_p95: the 95th percentile (nearest rank) of the wall times of
every step of the window, each fenced by a synchronize, in milliseconds
(host clock)."""

import math


def read(record):
    steps = sorted(record["window"]["step_s"])
    if not steps:
        return None
    return 1e3 * steps[math.ceil(0.95 * len(steps)) - 1]
