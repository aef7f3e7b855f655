"""BENCHMARK.json against the benchmark's contract, and every piece found
by name: each cell's configuration, traffic and check file, each metric's
reader.  Adding a cell or a metric takes new files and entries only."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

from conftest import ROOT
from newcell import add_glass_sky, copy_benchmark, probe

from bench_port import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    return harness.load_benchmark(ROOT)


def one_line(s):
    return isinstance(s, str) and 0 < len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if m in b["end_to_end"] else
                    {"layer", "moves"})
        assert set(m) <= allowed and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [x["name"] for x in b["configs"] + b["workloads"] + metrics]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_every_cell_resolves_and_every_metric_has_a_reader():
    b = bench()
    for w in b["workloads"]:
        cell = harness.resolve(b, w["name"])
        cfg = cell["config"]
        assert cfg["name"] == w["config"] and cfg["reduced"] == next(
            c["reduced"] for c in b["configs"] if c["name"] == w["config"])
        assert cell["traffic"]["samples_per_step"] >= 1
        assert cell["check"]["limits"] and cell["check"]["pixels"] > 0
        assert cell["end_to_end"] and cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in {e["name"] for e in cell["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in b["workloads"]}


def _digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in base:
                continue
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell, its check and a
    metric by new files and new entries; the copy's harness finds them,
    and no file it had changes."""
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = _digest(tmp_path / "bench_port")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (tmp_path / "bench_port/traffic/four-bounces.json").write_text(json.dumps(
        {"why": "t", "render_config": {"max_bounces": 4},
         "samples_per_step": 2}))
    (tmp_path / "bench_port/checks/dragon-1024.four-bounces.json").write_text(
        json.dumps({"pixels": 8, "limits": {"gap_median": 1e-3}}))
    (tmp_path / "bench_port/metrics/window.steps.py").write_text(
        "def read(record):\n    return len(record['window']['step_s'])\n")
    b["workloads"].append({"name": "dragon-1024.four-bounces",
                           "config": "dragon-1024", "traffic": "four-bounces",
                           "chips": 1, "why": "t"})
    b["per_layer"].append({"name": "window.steps", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "host dispatch",
                           "moves": "ms_per_sample"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("from bench_port import harness as H; "
            "c = H.resolve(H.load_benchmark(), 'dragon-1024.four-bounces'); "
            "assert c['traffic']['render_config'] == {'max_bounces': 4}; "
            "assert 'window.steps' in [m['name'] for m in c['per_layer']]; "
            "print(H.load_reader('window.steps').read("
            "{'window': {'step_s': [1, 2, 3]}}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3"
    after = _digest(tmp_path / "bench_port")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_configuration_with_its_own_mesh_map_and_glass_is_new_files_only(
        tmp_path):
    """A copy of the benchmark gains, by new files and entries alone
    (``tests/glass_sky/``), a configuration with a glass mesh of its own
    and a generated sky map at 64 x 32, traffic with ``env_map`` and
    ``enable_refraction``, and the cell's check; ``run_cell`` runs the cell
    on the CPU at 16 x 16 through the program's plain tracer, and no file
    the copy had changes."""
    copy_benchmark(tmp_path)
    before = _digest(tmp_path / "bench_port")
    added = add_glass_sky(tmp_path)
    assert {"bench_port/scenegen/extra/glass-ball.py",
            "bench_port/scenegen/env/sky.py",
            "bench_port/configs/glass-sky.json",
            "bench_port/traffic/env-glass.json",
            "bench_port/checks/glass-sky.env-glass.json"} <= set(added)
    config = json.loads((tmp_path / "bench_port/configs/glass-sky.json")
                        .read_text())
    assert config["env_map"] == {"generator": "sky", "height": 32,
                                 "width": 64}
    traffic = json.loads((tmp_path / "bench_port/traffic/env-glass.json")
                         .read_text())
    assert traffic["render_config"] == {"env_map": True,
                                        "enable_refraction": True}
    (res,) = probe(tmp_path, [{"cell": "glass-sky.env-glass", "seed": 5,
                               "size": [16, 16], "seconds": 0.3}])
    assert res["correct"], res["check"]
    after = _digest(tmp_path / "bench_port")
    assert {k: v for k, v in after.items() if k in before} == before
