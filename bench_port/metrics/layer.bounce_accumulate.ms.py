"""layer.bounce_accumulate.ms: device milliseconds a sample of the kernels launched
inside the renderer's "bounce + accumulate" span, from one eager sample under the
profiler (each kernel to the innermost span that launched it)."""

SCOPE = "bounce + accumulate"


def read(record):
    t = record["trace"]
    ms = t and t["scopes_ms"].get(SCOPE)
    return ms or None
