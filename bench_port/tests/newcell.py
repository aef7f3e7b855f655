"""A copy of the benchmark that gains a configuration of its own by new
files and entries alone: ``glass_sky/`` holds them, laid out as in a
checkout (a glass mesh, a sky map generator, the configuration, three
traffic mixes and their checks) and the entries ``BENCHMARK.json`` gains
(``glass_sky/benchmark.json``).

Run as a script from the root of such a copy, it runs cases there on the
CPU and prints one JSON line a case:

    python3 <this file> '<cases as JSON>'

A case is ``{"cell", "seed", "size": [w, h]}``, with ``"seconds"`` for a
run of ``harness.run_cell`` through the program's plain tracer, every
pixel compared, and ``"fault"`` to break the timed path first
(:data:`FAULTS`); or with ``"control": true`` and ``"samples"`` for
``control.control_numbers``, the reference in TF32 in the program's
place.  The program is imported from this checkout.
"""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OVERLAY = os.path.join(HERE, "glass_sky")


def copy_benchmark(dst) -> None:
    """The benchmark's own files (``BENCHMARK.json`` and ``bench_port/``)
    copied into ``dst``."""
    shutil.copytree(os.path.join(ROOT, "bench_port"),
                    os.path.join(dst, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)


def add_glass_sky(dst) -> list:
    """Add ``glass_sky/``'s files to the copy in ``dst``, none of which it
    had, and its entries to the copy's ``BENCHMARK.json``; returns the
    files added."""
    added = []
    src = os.path.join(OVERLAY, "bench_port")
    for base, _, files in os.walk(src):
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), OVERLAY)
            target = os.path.join(dst, rel)
            if os.path.exists(target):
                raise FileExistsError(rel)
            os.makedirs(os.path.dirname(target), exist_ok=True)
            shutil.copy(os.path.join(base, f), target)
            added.append(rel)
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    with open(os.path.join(OVERLAY, "benchmark.json")) as f:
        entries = json.load(f)
    for key, new in entries.items():
        bench[key] += new
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return added


def probe(dst, cases: list, timeout: float = 1800) -> list:
    """The results of ``cases`` run in the copy ``dst``, in order."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          json.dumps(cases)], cwd=dst, capture_output=True,
                         text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-4000:])
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


# -- the faults, planted in the program ------------------------------------

def _env_ignored(R, H, bounces, patch):
    real = R._env_lookup
    patch(R, "_env_lookup", lambda env, d: real(env, d) * 0.0)


def _env_half_turn(R, H, bounces, patch):
    import torch

    real = R._env_lookup
    patch(R, "_env_lookup", lambda env, d: real(
        torch.roll(env, env.shape[1] // 2, dims=1), d))


def _refraction_off(R, H, bounces, patch):
    import dataclasses

    real = H._render_config
    patch(H, "_render_config", lambda *a: dataclasses.replace(
        real(*a), enable_refraction=False))


def _fresnel_off(R, H, bounces, patch):
    """The Fresnel draw always lands past the reflectance: every ray that
    goes into the glass's transmission is refracted."""
    import torch

    real = R.sampling.halton
    fresnel = {2 + 7 * bounces + b for b in range(bounces)}
    patch(R.sampling, "halton", lambda i, d: (
        torch.ones(i.shape) if d in fresnel else real(i, d)))


FAULTS = {"env_ignored": _env_ignored, "env_half_turn": _env_half_turn,
          "refraction_off": _refraction_off, "fresnel_off": _fresnel_off}


def _run(case: dict) -> dict:
    import time

    from bench_port import check as CK
    from bench_port import harness as H
    from bench_port.control import control_numbers
    from metal_raytracing_tpu_torch import renderer as R

    w, h = case["size"]
    cell = H.resolve(H.load_benchmark(), case["cell"])
    if case.get("control"):
        numbers = control_numbers(case["cell"], case["seed"],
                                  case["samples"], "cpu", w, h, w * h)
        return {"correct": CK.judge(numbers, cell["check"]["limits"]),
                "check": numbers}
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if case.get("fault"):
        bounces = cell["traffic"]["render_config"].get("max_bounces", 3)
        FAULTS[case["fault"]](R, H, bounces, patch)
    try:
        res = H.run_cell(case["cell"], case["seed"], case["seconds"], False,
                         time.perf_counter(), device="cpu",
                         overrides={"width": w, "height": h,
                                    "pixels": w * h,
                                    "render_config": {"tracer": "torch"}})
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
    return {"correct": res["correct"], "check": res["check"],
            "samples": res["attempted"] * cell["traffic"]["samples_per_step"]
            + cell["traffic"]["samples_per_step"]}


def main(argv) -> int:
    sys.path.insert(0, os.getcwd())  # the copy's bench_port
    sys.path.append(ROOT)  # the program
    for case in json.loads(argv[0]):
        print(json.dumps({**case, **_run(case)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
