"""dispatch.launch_calls_per_sample: host calls that launched device work
(the profiler's runtime rows ``cu*Launch*``: kernel and graph launches)
over the samples of a profiled window of graph replays."""


def read(record):
    t = record["trace"]
    if not t or not t["graphed"]["launch_calls"]:
        return None
    g = t["graphed"]
    return g["launch_calls"] / g["samples"]
