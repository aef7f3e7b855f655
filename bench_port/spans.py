"""One cell's set-up spans and its graph's layer marks: the program's span
log (``utils.profiling.span_log``) read over set-up, and the layer marks
(``Renderer.set_marks``) read over a window of graph replays.

    python3 bench_port/spans.py --workload <name> --seed <n> \\
        --seconds <s> [--log 0|1]

from the root of a checkout, on a card.  Set-up is the harness's
(``harness.run_cell``), with the span log open from its first line unless
``--log 0``.  Then, in turns: windows of ``--seconds`` of unmarked, marked
and unmarked steps; the harness's traced stage (the eager layer times);
a marked window of 0.25 s, where the harness would run the stage, after
its traced part; one more unmarked window.  The last line of
standard output is one JSON object: the set-up's metrics
(:func:`setup_metrics`), the marked window's (:func:`marked_window`),
the eager layers, each window's ms a sample, the cost of a span with the
log closed and open, and the card.  ``run.py`` does not run this stage.
"""

import time

T0 = time.perf_counter()  # set-up counts from here, as in run.py

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a marked window spans at least this much host time (the traced stage's)
MARKED_WINDOW_S = 0.25
# scopes a side in the measure of a span's host cost
SCOPE_COST_ROUNDS = 20000
# the scope names of the graph's layer metrics: graph.<metric>.ms
GRAPH_LAYERS = {"raygen": "raygen", "global passes": "global_passes",
                "sort keys": "sort_keys", "closest trace": "closest_trace",
                "shade": "shade", "shadow trace": "shadow_trace",
                "bounce + accumulate": "bounce_accumulate"}


def setup_metrics(log, setup_s: float) -> Dict[str, float]:
    """Seconds of set-up by span: ``cuda init``, ``bvh build``, ``kernel
    load``, the ``warm-up sample`` less the kernel load inside it, ``graph
    capture``, and ``setup_s`` less every top-level span
    (``outside_spans_s``: interpreter start, imports, the harness's own
    model generation and OBJ writing); ``top_level`` sums the top-level
    spans by name."""
    def within(inner, outer):
        return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns

    loads = [s for s in log.spans if s.name == "kernel load"]
    warmups = [s for s in log.spans if s.name == "warm-up sample"]
    top: Dict[str, float] = {}
    for s in log.top_level():
        top[s.name] = top.get(s.name, 0.0) + s.seconds
    return {"setup.cuda_init_s": log.seconds("cuda init"),
            "setup.bvh_build_s": log.seconds("bvh build"),
            "setup.kernel_load_s": log.seconds("kernel load"),
            "setup.warmup_s": sum(w.seconds - sum(k.seconds for k in loads
                                                  if within(k, w))
                                  for w in warmups),
            "setup.capture_s": log.seconds("graph capture"),
            "setup.outside_spans_s": setup_s - sum(top.values()),
            "top_level": top}


def marked_window(r, k: int, seconds: float, sync) -> dict:
    """Capture the step's graph with layer marks, then step (each step
    fenced and timed on the host clock, its marks read after it) for at
    least ``seconds``.  Each stretch between two marks of a replay goes to
    the innermost layer scope open there (``LayerMarks.segments``).
    ``graph.<layer>.ms``: each layer's device ms a sample averaged over the
    replays, bubbles included; ``unmarked_ms``: the device ms a sample
    inside the graph no layer scope covers; ``between_ms``: the wall a
    sample less the graph's device span (launch and fence)."""
    r.set_marks(True)
    r.step(k)  # captures the marked graph
    sync()
    sums: Dict[str, float] = {}
    walls: List[float] = []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds or not walls:
        t = time.perf_counter()
        r.step(k)
        sync()
        walls.append(time.perf_counter() - t)
        for scope, _, _, ms in r.graph_marks[k].segments():
            sums[scope] = sums.get(scope, 0.0) + ms
    n = len(walls)
    layers = {scope: ms / (n * k) for scope, ms in sums.items()}
    wall_ms = 1e3 * sum(walls) / (n * k)
    out = {f"graph.{GRAPH_LAYERS[s]}.ms": ms for s, ms in layers.items()
           if s in GRAPH_LAYERS}
    out.update({"unmarked_ms": layers.get(None, 0.0),
                "wall_ms_per_sample": wall_ms,
                "between_ms": wall_ms - sum(layers.values()),
                "replays": n})
    r.set_marks(False)
    return out


def _window(r, k: int, seconds: float, sync) -> float:
    """ms a sample of a closed loop of fenced steps, after one untimed
    step (which captures the graph where none is captured)."""
    r.step(k)
    sync()
    n, start = 0, time.perf_counter()
    while time.perf_counter() - start < seconds or n == 0:
        r.step(k)
        sync()
        n += 1
    return 1e3 * (time.perf_counter() - start) / (n * k)


def _scope_cost_us() -> Dict[str, float]:
    """Host microseconds a ``named_scope`` costs, the log closed and
    open."""
    from metal_raytracing_tpu_torch.utils import profiling as P

    def rounds():
        t = time.perf_counter()
        for _ in range(SCOPE_COST_ROUNDS):
            with P.named_scope("cost"):
                pass
        return 1e6 * (time.perf_counter() - t) / SCOPE_COST_ROUNDS

    closed = rounds()
    with P.span_log():
        opened = rounds()
    return {"closed_us": closed, "open_us": opened}


def _clock_check_us(dev) -> Dict[str, float]:
    """Each end of a logged span against its event in a
    ``torch.profiler`` trace taken at the same time (median of 7, us)."""
    from torch.profiler import ProfilerActivity, profile

    from metal_raytracing_tpu_torch.utils import profiling as P

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof, P.span_log() as log:
        for i in range(8):
            with P.named_scope(f"clock {i}"):
                time.sleep(0.001)
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    starts = [(ev[s.name].start_ns() - s.start_ns) / 1e3
              for s in log.spans[1:]]
    ends = [(ev[s.name].start_ns() + ev[s.name].duration_ns() - s.end_ns)
            / 1e3 for s in log.spans[1:]]
    return {"start_us": statistics.median(starts),
            "end_us": statistics.median(ends)}


def run(cell_name: str, seed: int, seconds: float, t0: float,
        log_open: bool = True, device: str = "cuda",
        overrides=None) -> dict:
    """Set-up as ``harness.run_cell``'s (``overrides`` as there), then the
    windows the module's docstring lists; on a device without graphs the
    set-up alone."""
    import contextlib

    import torch

    from metal_raytracing_tpu_torch.renderer import Renderer
    from metal_raytracing_tpu_torch.utils import profiling as P

    from bench_port import harness as H
    from bench_port import yardstick
    from bench_port.scenegen import scene_inputs

    overrides = overrides or {}
    t_log = time.perf_counter()
    with (P.span_log() if log_open else contextlib.nullcontext()) as log:
        cell = H.resolve(H.load_benchmark(ROOT), cell_name)
        config = cell["config"]
        width = overrides.get("width", config["width"])
        height = overrides.get("height", config["height"])
        k = cell["traffic"]["samples_per_step"]
        dev = torch.device(device)
        times: Dict[str, float] = {}
        tg = time.perf_counter()
        models, env_hdr = scene_inputs(config)
        times["generate_s"] = time.perf_counter() - tg
        scene = H._port_scene(config, models, width, height, times,
                              env_hdr)
        cfg = H._render_config(cell, seed, width, height,
                               overrides.get("render_config"))
        tb = time.perf_counter()
        r = Renderer(scene, cfg, device=dev)
        times["build_s"] = time.perf_counter() - tb
        times["scene_build_s"] = times["parse_s"] + times["build_s"]
        r.step(k)
        H._sync(dev)
        times["setup_s"] = time.perf_counter() - t0
    times["before_log_s"] = t_log - t0
    out = {"cell": cell_name, "seed": seed, "log_open": log_open,
           "setup": times}
    if log is not None:
        out["setup_spans"] = setup_metrics(log, times["setup_s"])
        out["span_log"] = [[s.name, log.parent_name(s),
                            (s.start_ns - log.spans[0].start_ns) / 1e9,
                            s.seconds] for s in log.spans]
    out["scope_cost"] = _scope_cost_us()
    out["clock_check"] = _clock_check_us(dev)
    if not r.graphed:
        return out

    def sync():
        H._sync(dev)

    out["unmarked_ms_a"] = _window(r, k, seconds, sync)
    out["marked"] = marked_window(r, k, max(seconds, MARKED_WINDOW_S), sync)
    out["unmarked_ms_b"] = _window(r, k, seconds, sync)
    step_s = [out["unmarked_ms_b"] * k / 1e3]
    traced = H._traced(r, k, step_s)
    out["eager_layers_ms"] = traced["scopes_ms"]
    out["eager_unattributed_ms"] = traced["unattributed_ms"]
    # where the harness would put the stage: after its traced part
    out["marked_after_trace"] = marked_window(r, k, MARKED_WINDOW_S, sync)
    out["unmarked_ms_c"] = _window(r, k, seconds, sync)
    out["image_finite"] = bool(torch.isfinite(r.accum).all())
    out["card"] = yardstick.card()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--log", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_port", sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("spans: no CUDA device; nothing is timed", file=sys.stderr)
        return 3
    out = run(args.workload, args.seed, args.seconds, T0, bool(args.log))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
