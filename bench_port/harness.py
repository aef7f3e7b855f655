"""One run of one cell of the port's benchmark.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``: the scene as data) and a traffic mix
(``traffic/<traffic>.json``: the ``RenderConfig`` fields it sets and the
samples a step); its check (``checks/<cell>.json``) holds the limits of
the comparison that decides ``correct``.  Every metric is read by its own
reader, ``metrics/<name>.py``, from the run's record.  Nothing here names
a cell, a configuration or a metric: new ones are new files and entries.

The run: set-up (generate the scene's models from the frozen generators,
and its environment map where the configuration has one, write them as
OBJ + MTL files and a ``.hdr`` file under ``TMPDIR``, load them with the
program's OBJ and HDR readers, build ``Renderer(scene, cfg)``, then one
step, which captures the step's CUDA graph), then a
closed loop of ``Renderer.step(k)`` + ``torch.cuda.synchronize()`` for
``--seconds`` seconds, each step timed on the host clock.  With ``--trace 1`` one eager
sample is profiled after the window for the layer times, and a short
window of graph replays for the kernel, device and dispatch metrics.
Last, the program's state is freed and the reference traces the sampled
pixels' samples.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "metal_raytracing_tpu")
# graphed windows whose records fall short are taken again up to this often
PROFILE_TRIES = 4
# a traced window of replays spans at least this much host time
TRACE_WINDOW_S = 0.25

__all__ = ["load_benchmark", "resolve", "load_reader", "run_cell",
           "forbidden_modules", "result_line"]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def resolve(bench: dict, cell: str) -> dict:
    """The cell's entry, configuration, traffic, check and metric entries
    (end-to-end, then per-layer, those the cell reports)."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if cell not in by_name:
        raise KeyError(f"no workload {cell!r}; the benchmark has "
                       f"{sorted(by_name)}")
    w = by_name[cell]

    def mine(ms):
        return [m for m in ms if cell in m.get("workloads", [cell])]

    return {"workload": w,
            "config": _json("configs", f"{w['config']}.json"),
            "traffic": _json("traffic", f"{w['traffic']}.json"),
            "check": _json("checks", f"{cell}.json"),
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def load_reader(name: str):
    """The module ``metrics/<name>.py``; it defines ``read(record)``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# -- set-up --------------------------------------------------------------

def _port_scene(config: dict, models: Dict[str, dict], width: int,
                height: int, times: dict, env_hdr: Optional[bytes] = None):
    """The program's ``Scene`` of the configuration: the models written as
    OBJ + MTL files and loaded through the program's OBJ loader, the
    environment map (``.hdr`` bytes) written beside them and read by the
    program's HDR reader."""
    from metal_raytracing_tpu_torch import types as T
    from metal_raytracing_tpu_torch.io.image import read_hdr
    from metal_raytracing_tpu_torch.io.obj import load_obj
    from metal_raytracing_tpu_torch.scene import Scene

    from .scenegen import write_obj

    with tempfile.TemporaryDirectory(prefix="bench_port_scene_") as tmp:
        paths = {name: write_obj(model, os.path.join(tmp, f"{name}.obj"))
                 for name, model in models.items()}
        env_path = os.path.join(tmp, "env.hdr")
        if env_hdr is not None:
            with open(env_path, "wb") as f:
                f.write(env_hdr)
        t0 = time.perf_counter()
        loaded = {name: load_obj(path) for name, path in paths.items()}
        env = read_hdr(env_path) if env_hdr is not None else None
        times["parse_s"] = time.perf_counter() - t0
    scene = Scene(width, height, default_lights=False)
    scene.name = config["name"]
    if env is not None:
        scene.env_map = env
    make = {"area": lambda l: T.area_light(l["position"], l["forward"],
                                           l["right"], l["up"], l["color"]),
            "spot": lambda l: T.spot_light(l["position"], l["direction"],
                                           l["cone_angle"], l["color"]),
            "point": lambda l: T.point_light(l["position"], l["color"]),
            "sun": lambda l: T.sun_light(l["direction"], l["color"])}
    scene.lights = [make[l["type"]](l) for l in config["lights"]]
    cam = config["camera"]
    scene.camera_position = tuple(cam["position"])
    scene.camera_right = tuple(cam["right"])
    scene.camera_up = tuple(cam["up"])
    scene.camera_forward = tuple(cam["forward"])
    scene.fov_degrees = cam["fov_degrees"]
    for inst in config["instances"]:
        scene.add_instance(loaded[inst["model"]],
                           position=tuple(inst["position"]),
                           rotation=tuple(inst["rotation"]),
                           scale=inst["scale"])
    return scene


def _render_config(cell: dict, seed: int, width: int, height: int,
                   overrides: Optional[dict]):
    from metal_raytracing_tpu_torch.types import RenderConfig

    fields = dict(cell["traffic"]["render_config"])
    fields.update(overrides or {})
    return RenderConfig(width=width, height=height, seed=seed,
                        samples_per_dispatch=cell["traffic"]
                        ["samples_per_step"], **fields)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- traced part ---------------------------------------------------------

def _profile(fn, dev):
    """(events, host seconds of ``fn`` and the fence after it) under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    return prof.events(), wall


def _traced(r, k: int, step_s: List[float]) -> dict:
    """The layer times of one eager sample (not folded into the image),
    then a checked window of graph replays (kernels, busy time, launch
    calls, rays)."""
    from metal_raytracing_tpu_torch.renderer import render_sample
    from metal_raytracing_tpu_torch.utils.profiling import SCOPES

    from . import trace_read as TR

    dev = r.device
    scopes = tuple(SCOPES)
    eager, _ = _profile(lambda: render_sample(
        r.data, r.spec, r.cfg, r.offsets, r.frame, r.tracer,
        baked_tables=r.baked), dev)
    by_scope = TR.scope_device_us(eager, scopes)
    eager_table = TR.kernel_table(TR.device_rows(eager, scopes))
    out = {"scopes_ms": {s: us / 1e3 for s, us in by_scope.items()
                         if s is not None},
           "unattributed_ms": by_scope.get(None, 0.0) / 1e3}
    med = float(np.median(step_s)) if step_s else 0.0
    steps = max(2, math.ceil(TRACE_WINDOW_S / med)) if med > 0 else 2
    samples = steps * k
    for attempt in range(PROFILE_TRIES):
        before = r.ray_totals.clone()
        _sync(dev)
        events, wall = _profile(lambda: [r.step(k) for _ in range(steps)],
                                dev)
        rays = (r.ray_totals - before).tolist()
        rows = TR.device_rows(events, scopes)
        table = TR.kernel_table(rows)
        short = {TR.short_name(n): (table.get(n, [0, 0])[1], c * samples)
                 for n, (_, c) in eager_table.items()
                 if not TR.is_memory_op(n)
                 and table.get(n, [0, 0])[1] < c * samples}
        if not short:
            break
        _log(f"bench: a traced window dropped (attempt {attempt + 1}): "
             f"records, launches of {len(short)} kernels: "
             f"{json.dumps(dict(list(short.items())[:4]))}")
    out["graphed"] = {
        "samples": samples, "window_s": wall,
        "busy_s": TR.busy_us(rows) / 1e6,
        "kernels": {n: [us / 1e6, c] for n, (us, c) in table.items()},
        "launch_calls": TR.launch_calls(events),
        "closest_rays": rays[0], "shadow_rays": rays[1],
        "complete": not short,
        "device_ops": [[TR.short_name(n), us / 1e6] for n, (us, _) in
                       sorted(table.items(), key=lambda kv: -kv[1][0])[:10]],
        "idle_gaps": [[n, us / 1e6] for n, us in
                      TR.idle_gaps(rows, events)]}
    return out


# -- the run -------------------------------------------------------------

def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", chips: int = 1,
             bench: Optional[dict] = None,
             overrides: Optional[dict] = None) -> dict:
    """One run of ``cell_name``; returns the result object.  ``overrides``
    (``width``, ``height``, ``pixels``, ``render_config``) shrink a run for
    the CPU tests; a benchmark run gives none."""
    import torch

    from metal_raytracing_tpu_torch.renderer import Renderer

    from . import check as CK
    from . import yardstick
    from .reference import Binned, build_scene, render_pixels
    from .scenegen import scene_inputs

    overrides = overrides or {}
    bench = bench or load_benchmark()
    cell = resolve(bench, cell_name)
    config, traffic = cell["config"], cell["traffic"]
    width = overrides.get("width", config["width"])
    height = overrides.get("height", config["height"])
    k = traffic["samples_per_step"]
    dev = torch.device(device)
    times: Dict[str, float] = {}

    # set-up: scene, build, the first step
    tg = time.perf_counter()
    models, env_hdr = scene_inputs(config)
    times["generate_s"] = time.perf_counter() - tg
    scene = _port_scene(config, models, width, height, times, env_hdr)
    cfg = _render_config(cell, seed, width, height,
                         overrides.get("render_config"))
    tb = time.perf_counter()
    r = Renderer(scene, cfg, device=dev)
    times["build_s"] = time.perf_counter() - tb
    times["scene_build_s"] = times["parse_s"] + times["build_s"]
    tw = time.perf_counter()
    r.step(k)  # builds and loads the kernels, captures the graph
    _sync(dev)
    times["first_step_s"] = time.perf_counter() - tw
    times["setup_s"] = time.perf_counter() - t0

    # the window: a closed loop of steps
    step_s: List[float] = []
    failed = 0
    rays0 = r.ray_totals.clone()
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        ta = time.perf_counter()
        try:
            r.step(k)
            _sync(dev)
        except Exception as e:  # a failed step is counted, the loop goes on
            failed += 1
            _log(f"bench: step {len(step_s)} raised {type(e).__name__}: {e}")
        end = time.perf_counter()
        step_s.append(end - ta)
    rays = (r.ray_totals - rays0).tolist()
    # The average keeps a non-finite value once a step has left one, and
    # which step did is not known: then every step counts as failed.  (A
    # check after each step slowed the steps by ~2 ms on the card.)
    if not bool(torch.isfinite(r.accum).all()):
        failed = len(step_s)
    if step_s:
        q = np.percentile(step_s, [0, 50, 95, 100])
        slow = [i for i, x in enumerate(step_s) if x > 1.03 * q[1]]
        _log(f"bench: {len(step_s)} steps, ms min / median / p95 / max "
             f"{' / '.join(f'{1e3 * x:.3f}' for x in q)}; {len(slow)} over "
             f"1.03 x the median, at steps {slow[:40]}")
    record = {"cell": cell_name, "samples_per_step": k, "setup": times,
              "window": {"step_s": step_s, "samples": len(step_s) * k,
                         "wall_s": end - start, "closest_rays": rays[0],
                         "shadow_rays": rays[1]},
              "trace": None,
              "card": yardstick.card() if dev.type == "cuda" else None}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if trace:
        record["trace"] = _traced(r, k, step_s)
        g = record["trace"]["graphed"]
        _log(f"bench: layers (device ms, one eager sample): "
             f"{json.dumps(record['trace']['scopes_ms'])}; device ms no "
             f"layer span covers: {record['trace']['unattributed_ms']!r}")
        _log(f"bench: traced window {g['samples']} samples, "
             f"{g['window_s']!r} s, busy {g['busy_s']!r} s, records "
             f"complete {g['complete']}")

    # correctness: the sampled pixels of the accumulated image
    _sync(dev)
    samples = r.frame_index
    pixels = CK.sample_pixels(seed, width, height,
                              overrides.get("pixels",
                                            cell["check"]["pixels"]))
    flat = r.accum.reshape(-1, 3)
    program = flat[torch.as_tensor(pixels, device=dev)].double().cpu().numpy()
    del r, flat
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tr = time.perf_counter()
    rs = build_scene(config, models, dev, width, height, env_hdr)
    opts = {**traffic["render_config"],
            **overrides.get("render_config", {}), "seed": seed}
    reference = render_pixels(rs, Binned(rs.v0, rs.e1, rs.e2), opts, pixels,
                              samples)
    times["reference_s"] = time.perf_counter() - tr
    numbers = CK.gap_numbers(program, reference)
    limits = cell["check"]["limits"]
    correct = CK.judge(numbers, limits) and failed == 0
    _log(f"bench: set-up {json.dumps(times)}")
    _log(f"bench: {samples} samples at {len(pixels)} pixels; the gaps "
         f"{json.dumps(numbers)}")

    # the metrics
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(step_s),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": chips, "memory_peak_bytes": int(peak)}}
    if record["card"]:
        result["device"]["power_limit_w"] = record["card"]["power_limit_w"]
    if trace:
        g = record["trace"]["graphed"]
        result["device"]["busy_s"] = g["busy_s"]
        result["device"]["window_s"] = g["window_s"]
        result["breakdown"] = {"device_ops": g["device_ops"],
                               "idle_gaps": g["idle_gaps"]}
    result["check"] = {name: {"value": numbers[name], "limit": lim}
                       for name, lim in limits.items()}
    return result


def result_line(result: dict) -> str:
    """The result as one JSON line, its ``check`` key last."""
    check = result.pop("check")
    result["check"] = check
    return json.dumps(result)
