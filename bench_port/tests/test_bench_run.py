"""``run.py`` as a benchmark run calls it: no result and a nonzero exit without
a card or in a directory that holds only the benchmark; no JAX module
loaded by a run; and, on a card, a short run of each cell."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

from bench_port import harness

RUN = [sys.executable, "bench_port/run.py"]


def _run(args, cwd=ROOT, env=None, timeout=600):
    return subprocess.run(RUN + args, cwd=cwd, capture_output=True,
                          text=True, timeout=timeout, env=env)


def test_refuses_to_time_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(["--workload", "dragon-1024.default", "--seed", "1",
                "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["--workload", "dragon-1024.default", "--seed", "1",
                "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_a_run_loads_no_jax():
    """A tiny CPU run through the harness, in a fresh process: no module
    whose top-level name is jax, jaxlib, flax or the JAX package."""
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from bench_port import harness as H; "
            "H.run_cell('coatball-1024x768.specular', 5, 0.2, True, "
            "time.perf_counter(), device='cpu', overrides={'width': 8, "
            "'height': 6, 'pixels': 8, 'render_config': {'tracer': "
            "'torch'}}); print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "metal_raytracing_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_benchmark(ROOT)["workloads"]])
def test_a_short_run_on_the_card(cell, cuda_device):
    out = _run(["--workload", cell, "--seed", "4242", "--seconds", "2",
                "--trace", "1"])
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "check"
