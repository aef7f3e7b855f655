"""The port's span log and layer marks (``utils/profiling.py``).

On the CPU: the log's nesting, parents and self time; a closed log records
nothing; a logged span lines up with its ``record_function`` event in a
``torch.profiler`` trace (one clock); the layer marks' reduction to per-layer
ms on a counting clock; a CPU renderer's set-up spans.  On a CUDA device
only: a graph captured with marks renders the same image, bit for bit, as
one captured without.  The file imports no JAX, so the card's test runs on
the card: ``python -m pytest --noconftest tests/test_torch_spans.py``.
"""

import os
import statistics
import time

import pytest
import torch

from metal_raytracing_tpu_torch.io import procedural
from metal_raytracing_tpu_torch.io.obj import load_obj, write_obj
from metal_raytracing_tpu_torch.renderer import Renderer
from metal_raytracing_tpu_torch.scene import Scene
from metal_raytracing_tpu_torch.scenes import get_scene
from metal_raytracing_tpu_torch.types import RenderConfig
from metal_raytracing_tpu_torch.utils import profiling as P


def test_log_nesting_parents_and_self_time():
    with P.span_log() as log:
        with P.named_scope("outer"):
            time.sleep(0.002)
            with P.named_scope("inner"):
                time.sleep(0.003)
            with P.named_scope("inner"):
                with P.named_scope("leaf"):
                    time.sleep(0.001)
        with P.named_scope("second"):
            pass
    names = [(s.name, log.parent_name(s)) for s in log.spans]
    assert names == [("outer", None), ("inner", "outer"), ("inner", "outer"),
                     ("leaf", "inner"), ("second", None)]
    assert [s.name for s in log.top_level()] == ["outer", "second"]
    outer, in1, in2, leaf, _ = log.spans
    for s in log.spans:
        assert s.end_ns >= s.start_ns
    for child in (in1, in2):
        assert outer.start_ns <= child.start_ns <= child.end_ns <= outer.end_ns
    assert log.self_s(outer) == pytest.approx(
        outer.seconds - in1.seconds - in2.seconds)
    assert log.self_s(in2) == pytest.approx(in2.seconds - leaf.seconds)
    assert log.self_s(leaf) == leaf.seconds
    assert log.self_s(outer) >= 0.002 and in1.seconds >= 0.003
    assert log.seconds("inner") == pytest.approx(in1.seconds + in2.seconds)


def test_closed_log_records_nothing():
    with P.named_scope("before"):
        pass
    with P.span_log() as log:
        pass
    with P.named_scope("after"):
        pass
    assert log.spans == []
    with P.span_log() as log:
        with P.named_scope("inside"):
            pass
    with P.named_scope("after"):
        pass
    assert [s.name for s in log.spans] == ["inside"]


def test_log_shares_the_profilers_clock():
    """Each end of a logged span within 50 us of its profiler event (the
    median over seven spans, after one to warm the profiler's path up)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            P.span_log() as log:
        for i in range(8):
            with P.named_scope(f"span {i}"):
                time.sleep(0.001)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("span ")}
    starts, ends = [], []
    for s in log.spans[1:]:
        e = events[s.name]
        starts.append(abs(e.start_ns() - s.start_ns))
        ends.append(abs(e.start_ns() + e.duration_ns() - s.end_ns))
    assert statistics.median(starts) < 50_000, starts
    assert statistics.median(ends) < 50_000, ends


class CountingMarks(P.LayerMarks):
    """Layer marks on a counting clock: the n-th mark reads ``n * n`` ms,
    so each stretch has its own length."""

    class Event:
        def __init__(self, ms):
            self.ms = ms

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return other.ms - self.ms

    def mark(self, scope, entering):
        n = len(self.marks)
        self.marks.append(P.Mark(scope, entering, self.sample, self.bounce,
                                 self.Event(float(n * n))))


def test_layer_marks_give_each_stretch_to_its_innermost_scope():
    marks = CountingMarks()
    P.mark_bounce(5)  # no marking open: nothing to label
    with P.named_scope("outside"):  # before the marking: no mark
        pass
    with P.marking(marks):  # mark 0 (the step's bracket)
        for i in range(2):
            marks.sample, marks.bounce = i, 0
            with P.named_scope("raygen"):  # marks 1, 2 / 9, 10
                pass
            P.mark_bounce(1)
            with P.named_scope("shadow trace"):  # 3 / 11
                with P.named_scope("sort keys"):  # 4, 5 / 12, 13
                    pass
            # 6 / 14: shadow trace's exit
            with P.named_scope("shade"):  # 7, 8 / 15, 16
                pass
    # mark 17: the bracket's exit
    assert len(marks.marks) == 18
    assert [m.scope for m in marks.marks[:4]] == [None, "raygen", "raygen",
                                                  "shadow trace"]
    assert [m.bounce for m in marks.marks[9:12]] == [0, 0, 1]
    assert {m.sample for m in marks.marks[9:17]} == {1}
    seg = marks.segments()
    assert seg[0] == (None, 0, 0, 1.0)  # bracket to raygen's entry
    assert seg[1] == ("raygen", 0, 0, 3.0)
    assert seg[3] == ("shadow trace", 0, 1, 7.0)
    assert seg[4] == ("sort keys", 0, 1, 9.0)
    assert seg[5] == ("shadow trace", 0, 1, 11.0)
    got = marks.layer_ms()
    sq = [n * n for n in range(18)]

    def stretch(*ns):  # the stretches that start at marks ns, per sample
        return sum(sq[n + 1] - sq[n] for n in ns) / 2

    assert got == pytest.approx({
        "raygen": stretch(1, 9), "shadow trace": stretch(3, 5, 11, 13),
        "sort keys": stretch(4, 12), "shade": stretch(7, 15),
        P.UNMARKED: stretch(0, 2, 6, 8, 10, 14, 16)})
    assert sum(got.values()) == pytest.approx(sq[-1] / 2)


def test_cpu_renderer_logs_its_set_up(tmp_path):
    """A CPU renderer's set-up spans, in order, with their parents: the
    parse, the scene build with its three phases, the pixel offsets; no
    CUDA init, bake, warm-up or capture without a card."""
    path = os.path.join(tmp_path, "sphere.obj")
    write_obj(procedural.make_model("sphere"), path)
    cfg = RenderConfig(width=8, height=8, max_bounces=1)
    with P.span_log() as log:
        model = load_obj(path, use_native=False)
        scene = Scene(8, 8)
        scene.add_instance(model)
        r = Renderer(scene, cfg, device="cpu")
    got = [(s.name, log.parent_name(s)) for s in log.spans
           if s.name not in P.SCOPES]
    assert got == [("obj parse", None), ("scene build", None),
                   ("bvh build", "scene build"),
                   ("pack planes", "scene build"),
                   ("upload", "scene build"), ("pixel offsets", None)]
    assert all(s.end_ns is not None for s in log.spans)
    with pytest.raises(ValueError, match="eagerly"):
        r.set_marks(True)
    with pytest.raises(RuntimeError, match="no marked replay"):
        r.layer_ms()


def test_marked_graph_renders_the_same_image():
    """A graph captured with layer marks renders the image of one captured
    without, bit for bit, and reads a time for every layer it ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: layer marks live in CUDA graphs")
    cfg = RenderConfig(width=256, height=192)
    images, layers = [], None
    for marked in (False, True):
        r = Renderer(get_scene("coatball", 256, 192), cfg, device="cuda")
        r.set_marks(marked)
        for _ in range(2):
            r.step(2)
        if marked:
            layers = r.layer_ms()
        torch.cuda.synchronize()
        images.append(r.accum.clone())
    assert torch.equal(images[0], images[1])
    assert set(layers) <= set(P.SCOPES) | {P.UNMARKED}
    assert {"raygen", "closest trace", "shade", "shadow trace"} <= set(layers)
    assert all(ms >= 0 for ms in layers.values())
