"""The rest of a run, with the timed path broken underneath, comes out
``correct`` false: a step that leaves the image unchanged, half of each
step's samples left out with the mean taken over the rest, every answer
altered where it is produced, and an eighth of them.  Small CPU runs through the program's plain
tracer; the look for a card is skipped."""

import time

import pytest

from bench_port import harness
from metal_raytracing_tpu_torch import renderer as R

BENCH = harness.load_benchmark()
# a 16-pixel-wide cut of each cell's image, its aspect kept
SIZE = {w["name"]: (16, 16 * c["height"] // c["width"])
        for w in BENCH["workloads"]
        for c in [harness.resolve(BENCH, w["name"])["config"]]}


def unchanged(self):
    time.sleep(0.02)  # as long as a small sample takes: a few steps a run
    self.frame.add_(1)  # the step counts, the image stays as it was


def half(self):
    kept = getattr(self, "_kept", 0)
    if int(self.frame) % 2 == 0:
        sample, stats = R.render_sample(self.data, self.spec, self.cfg,
                                        self.offsets, self.frame, self.tracer,
                                        baked_tables=self.baked)
        self.accum.copy_(R.accumulate(self.accum, sample, kept))
        self._kept = kept + 1
    self.frame.add_(1)


def altered(monkeypatch):
    real = R.render_sample

    def render_sample(*a, **k):
        sample, stats = real(*a, **k)
        return sample * (1.0 + 2.0 ** -4), stats

    monkeypatch.setattr(R, "render_sample", render_sample)


def some_altered(monkeypatch):
    """An eighth of the pixels doubled, as when the compaction or the
    un-permute loses the hits or occluders of some rays: a fault in fewer
    than half of the pixels, which a median cannot see."""
    real = R.render_sample

    def render_sample(*a, **k):
        sample, stats = real(*a, **k)
        flat = sample.reshape(-1, 3).clone()
        flat[::8] *= 2.0
        return flat.reshape(sample.shape), stats

    monkeypatch.setattr(R, "render_sample", render_sample)


FAULTS = {"unchanged": lambda mp: mp.setattr(R.Renderer, "_sample",
                                             unchanged),
          "half": lambda mp: mp.setattr(R.Renderer, "_sample", half),
          "altered": altered,
          "some_altered": some_altered}


def run(cell):
    w, h = SIZE[cell]
    return harness.run_cell(cell, 99, 0.3, False, time.perf_counter(),
                            device="cpu",
                            overrides={"width": w, "height": h,
                                       "pixels": w * h,
                                       "render_config": {"tracer": "torch"}})


@pytest.mark.parametrize("cell", sorted(SIZE))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run(cell)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", sorted(SIZE))
def test_the_same_run_unbroken_is_correct(cell):
    assert run(cell)["correct"]
