"""The controls come out not correct under each cell's limits, at a size a
test run holds (the readings at the cells' own sizes are in PERF.md): the
reference computed in TF32 and put in the program's place, and, in the
cells that sort (``compaction``), the program's own lower-precision path,
``sort_pack_f16``."""

import time

import pytest

from bench_port import check as CK
from bench_port import harness
from bench_port.control import control_numbers

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SORTING = [c for c in CELLS if harness.resolve(BENCH, c)["traffic"]
           ["render_config"].get("compaction")]


def limits(cell):
    return harness.resolve(BENCH, cell)["check"]["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_reference_is_not_correct(cell):
    numbers = control_numbers(cell, 31, 4, "cpu", 24, 18, 96)
    assert not CK.judge(numbers, limits(cell)), numbers


@pytest.mark.parametrize("cell", SORTING)
def test_the_program_in_f16_is_not_correct(cell):
    res = harness.run_cell(cell, 31, 0.3, False, time.perf_counter(),
                           device="cpu",
                           overrides={"width": 16, "height": 16,
                                      "pixels": 256,
                                      "render_config": {
                                          "tracer": "torch",
                                          "sort_pack_f16": True}})
    assert not res["correct"], res["check"]
