"""ms_per_sample: the window's whole wall time over the samples completed
in it, in milliseconds (host clock)."""


def read(record):
    w = record["window"]
    if not w["samples"]:
        return None
    return 1e3 * w["wall_s"] / w["samples"]
