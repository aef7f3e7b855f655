"""setup_s: process start to the first timed step, in seconds: imports,
scene generation and load, the renderer's build, kernel load, the warm-up
step and its graph capture (host clock)."""


def read(record):
    return record["setup"]["setup_s"]
