"""layer.global_passes.ms: device milliseconds a sample of the kernels launched
inside the renderer's "global passes" span, from one eager sample under the
profiler (each kernel to the innermost span that launched it)."""

SCOPE = "global passes"


def read(record):
    t = record["trace"]
    ms = t and t["scopes_ms"].get(SCOPE)
    return ms or None
