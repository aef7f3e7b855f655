"""layer.closest_trace.ms: device milliseconds a sample of the kernels launched
inside the renderer's "closest trace" span, from one eager sample under the
profiler (each kernel to the innermost span that launched it)."""

SCOPE = "closest trace"


def read(record):
    t = record["trace"]
    ms = t and t["scopes_ms"].get(SCOPE)
    return ms or None
