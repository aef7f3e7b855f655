"""The reference's environment map and refraction held against the
program's: ``glass-sky`` (``tests/glass_sky/``: a glass ball and a
diffuse sphere on the floor under a generated sky), added to a copy of
the benchmark by new files alone, cut to 32 x 32, every pixel, the
samples of a 0.5 s window, through the program's plain tracer.  Three
scenes: the map alone, the glass alone, both.  Under the same limits the
TF32 control and four faults planted in the program come out not
correct: the map ignored, the map turned half a turn in u, refraction off
(the glass shaded as its diffuse layer), Fresnel off (every ray that goes
into the glass refracted).  The limits and their readings:
``tests/glass_sky/bench_port/checks/``."""

import pytest

from newcell import add_glass_sky, copy_benchmark, probe

SIZE = [32, 32]
SCENES = ["glass-sky.env", "glass-sky.glass", "glass-sky.env-glass"]
FAULTS = [("glass-sky.env", "env_ignored"), ("glass-sky.env", "env_half_turn"),
          ("glass-sky.glass", "refraction_off"),
          ("glass-sky.glass", "fresnel_off")] + [
    ("glass-sky.env-glass", f) for f in ("env_ignored", "env_half_turn",
                                         "refraction_off", "fresnel_off")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's result, from one process in the copy."""
    root = tmp_path_factory.mktemp("glass_sky")
    copy_benchmark(root)
    add_glass_sky(root)
    cases = ([{"cell": c, "seed": 2024, "size": SIZE, "seconds": 0.5}
              for c in SCENES]
             + [{"cell": c, "seed": 2024, "size": SIZE, "samples": 4,
                 "control": True} for c in SCENES]
             + [{"cell": c, "seed": 2024, "size": SIZE, "seconds": 0.5,
                 "fault": f} for c, f in FAULTS])
    out = {}
    for r in probe(root, cases):
        key = "control" if r.get("control") else r.get("fault", "sound")
        out[r["cell"], key] = r
    return out


@pytest.mark.parametrize("cell", SCENES)
def test_the_program_agrees_with_the_reference(cell, results):
    r = results[cell, "sound"]
    assert r["correct"] and r["samples"] >= 2, r


@pytest.mark.parametrize("cell", SCENES)
def test_the_tf32_control_is_not_correct(cell, results):
    r = results[cell, "control"]
    assert not r["correct"], r


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_is_not_correct(cell, fault, results):
    r = results[cell, fault]
    assert not r["correct"], r
