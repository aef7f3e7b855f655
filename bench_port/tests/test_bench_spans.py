"""The span stage's arithmetic (``spans.py``) on canned records: the set-up
metrics from a span log, and the marked window's per-layer ms from the
stretches of a fake renderer's marked replays."""

import pytest

from metal_raytracing_tpu_torch.utils.profiling import Span, SpanLog

from bench_port import spans

S = 1_000_000_000  # ns a second


def _log(rows):
    """A closed log of (name, parent index, start s, end s) rows."""
    log = SpanLog()
    log.spans = [Span(n, p, int(a * S), int(b * S)) for n, p, a, b in rows]
    return log


def test_setup_metrics():
    log = _log([("obj parse", None, 0.0, 0.5),
                ("parser load", 0, 0.1, 0.4),
                ("cuda init", None, 0.5, 0.8),
                ("scene build", None, 0.8, 2.0),
                ("bvh build", 3, 0.9, 1.7),
                ("warm-up sample", None, 2.0, 3.5),
                ("closest trace", 5, 2.2, 3.0),
                ("kernel load", 6, 2.3, 2.9),
                ("graph capture", None, 3.5, 3.75)])
    got = spans.setup_metrics(log, 10.0)
    assert got["setup.cuda_init_s"] == pytest.approx(0.3)
    assert got["setup.bvh_build_s"] == pytest.approx(0.8)
    assert got["setup.kernel_load_s"] == pytest.approx(0.6)
    assert got["setup.warmup_s"] == pytest.approx(1.5 - 0.6)
    assert got["setup.capture_s"] == pytest.approx(0.25)
    assert got["setup.outside_spans_s"] == pytest.approx(10.0 - 3.75)
    assert got["top_level"] == pytest.approx(
        {"obj parse": 0.5, "cuda init": 0.3, "scene build": 1.2,
         "warm-up sample": 1.5, "graph capture": 0.25})


class FakeMarks:
    def segments(self):  # one replay of 2 samples, ms
        return [(None, 0, 0, 0.5), ("raygen", 0, 0, 1.0),
                ("shade", 0, 1, 3.0), ("raygen", 1, 0, 1.0),
                ("sort keys", 1, 1, 2.0), (None, 1, 1, 0.5)]


class FakeRenderer:
    def __init__(self):
        self.graph_marks, self.marked, self.steps = {}, [], 0

    def set_marks(self, on):
        self.marked.append(on)
        self.graph_marks = {2: FakeMarks()} if on else {}

    def step(self, k):
        self.steps += 1


def test_marked_window():
    r = FakeRenderer()
    got = spans.marked_window(r, 2, 0.0, lambda: None)
    assert r.marked == [True, False] and r.steps == 2  # capture + 1 replay
    assert got["replays"] == 1
    assert got["graph.raygen.ms"] == pytest.approx(1.0)
    assert got["graph.shade.ms"] == pytest.approx(1.5)
    assert got["graph.sort_keys.ms"] == pytest.approx(1.0)
    assert "graph.closest_trace.ms" not in got
    assert got["unmarked_ms"] == pytest.approx(0.5)
    assert got["between_ms"] == pytest.approx(
        got["wall_ms_per_sample"] - 4.0)
