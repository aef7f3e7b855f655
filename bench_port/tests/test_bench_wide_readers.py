"""The readers of the wide hierarchical instances on a canned record:
``kernels.wide_trace_ms``, ``kernels.wide_trace_roofline_pct`` and
``kernels.wide_launches_per_sample`` pick the instances whose first
template argument is true, and read nothing where the window ran none (a
scene of narrow supers) or where the run was not traced."""

import pytest

from bench_port import harness
from bench_port.yardstick import trace_least_s

WIDE_CLOSEST = ("void (anonymous namespace)::closest_hier_kernel<true, "
                "false>(float const*, float const*, int)")
WIDE_ANY = "void (anonymous namespace)::any_hier_kernel<true>(float const*)"
NARROW = "void (anonymous namespace)::closest_hier_kernel<false, false>(x)"


def record(kernels):
    return {"trace": {"graphed": {"samples": 4, "window_s": 0.2,
                                  "closest_rays": 4.0e6,
                                  "shadow_rays": 2.0e6,
                                  "kernels": kernels}},
            "card": {"issue_rate": 3.3454e13, "hbm_bytes_per_s": 3.35e12}}


def read(name, rec):
    return harness.load_reader(name).read(rec)


def test_the_wide_instances_are_read_by_their_template_argument():
    rec = record({WIDE_CLOSEST: [0.012, 12], WIDE_ANY: [0.008, 12],
                  NARROW: [0.5, 12], "void any_flat_kernel(y)": [0.25, 4],
                  "elementwise": [0.1, 900]})
    assert read("kernels.wide_trace_ms", rec) == pytest.approx(5.0)
    assert read("kernels.wide_launches_per_sample", rec) == 6.0
    least = trace_least_s(4.0e6, 2.0e6, 3.3454e13)
    pct = read("kernels.wide_trace_roofline_pct", rec)
    assert pct == pytest.approx(100.0 * least / 0.020)
    assert 0 < pct <= 100


@pytest.mark.parametrize("rec", [
    record({NARROW: [0.5, 12], "void any_hier_kernel<false>(y)": [0.4, 12]}),
    dict(record({WIDE_CLOSEST: [0.012, 12]}), trace=None)])
def test_nothing_to_read(rec):
    for name in ("kernels.wide_trace_ms", "kernels.wide_trace_roofline_pct",
                 "kernels.wide_launches_per_sample"):
        assert read(name, rec) is None
