"""Every metric reader on a canned record, and the trace reduction on
canned profiler events: scope attribution through ``cpu_parent``, the
layer annotations left out, busy time, launch calls, idle gaps, and the
roofline arithmetic on given ray counts."""

import types

import pytest
from torch.autograd import DeviceType

from bench_port import harness
from bench_port import trace_read as TR
from bench_port.yardstick import trace_least_s

SCOPES = ("raygen", "global passes", "sort keys", "closest trace", "shade",
          "shadow trace", "bounce + accumulate")


def ev(name, start, end, device=False, annotation=None, id_=0):
    return types.SimpleNamespace(
        name=name, id=id_,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        # record_function ranges are user annotations on both sides
        is_user_annotation=(name in SCOPES if annotation is None
                            else annotation),
        time_range=types.SimpleNamespace(start=start, end=end))


def canned_events():
    """A sample's trace: aten ops under spans (one nested inside another
    op), a kernel launched through ctypes inside a span with no operator
    around it, one launch outside every span, the span annotations on the
    device, a graph launch and a fence."""
    host = [ev("shade", 0, 100),
            ev("aten::mul", 10, 20), ev("cudaLaunchKernel", 12, 13, id_=1),
            ev("aten::to", 25, 45), ev("aten::copy_", 30, 40),
            ev("cudaMemcpyAsync", 31, 32, id_=2),
            ev("closest trace", 100, 200),
            ev("cuLaunchKernel", 150, 151, id_=3),
            ev("aten::add", 210, 220), ev("cudaLaunchKernel", 211, 212,
                                          id_=4),
            ev("cudaGraphLaunch", 205, 206, id_=5),
            ev("cudaDeviceSynchronize", 221, 400)]
    dev = [ev("vectorized_elementwise_kernel", 300, 307, True, id_=1),
           ev("Memcpy DtoD", 305, 308, True, id_=2),
           ev("void (anonymous namespace)::closest_hier_kernel<false>"
              "(float*)", 320, 370, True, id_=3),
           ev("closest trace", 300, 390, True, id_=3),
           ev("add_kernel", 380, 382, True, id_=4)]
    return host + dev


def test_scope_attribution_by_launch_time():
    got = TR.scope_device_us(canned_events(), SCOPES)
    assert got == {"shade": 10.0, "closest trace": 50.0, None: 2.0}


def test_device_rows_busy_launches_and_gaps():
    events = canned_events()
    rows = TR.device_rows(events, SCOPES)
    kname = "void (anonymous namespace)::closest_hier_kernel<false>(float*)"
    assert [r[0] for r in rows] == [
        "vectorized_elementwise_kernel", "Memcpy DtoD", kname, "add_kernel"]
    table = TR.kernel_table(rows)
    assert table["Memcpy DtoD"] == [3.0, 1]
    # 300-308 overlapping, 320-370, 380-382
    assert TR.busy_us(rows) == pytest.approx(8 + 50 + 2)
    assert TR.launch_calls(events) == 4
    gaps = TR.idle_gaps(rows, events)
    assert gaps == [("cudaDeviceSynchronize", 12.0),
                    ("cudaDeviceSynchronize", 10.0)]
    assert TR.short_name(kname) == "closest_hier_kernel<false>"


def record():
    return {
        "setup": {"setup_s": 12.5, "scene_build_s": 1.25},
        "window": {"step_s": [0.05] * 19 + [0.09], "samples": 40,
                   "wall_s": 2.0, "closest_rays": 3.0e6,
                   "shadow_rays": 1.0e6},
        "trace": {
            "scopes_ms": {"raygen": 0.5, "shade": 4.0, "closest trace": 3.0},
            "unattributed_ms": 0.1,
            "graphed": {"samples": 4, "window_s": 0.2, "busy_s": 0.19,
                        "launch_calls": 2,
                        "kernels": {"void closest_hier_kernel<0>(x)":
                                    [0.004, 4],
                                    "void any_flat_kernel(y)": [0.002, 4],
                                    "elementwise": [0.1, 900]},
                        "closest_rays": 4.0e6, "shadow_rays": 2.0e6}},
        "card": {"issue_rate": 3.3454e13, "hbm_bytes_per_s": 3.35e12}}


def read(name, rec=None):
    return harness.load_reader(name).read(rec or record())


def test_end_to_end_readers():
    assert read("ms_per_sample") == pytest.approx(50.0)
    assert read("step_ms_p95") == pytest.approx(50.0)  # 19th of 20
    assert read("setup_s") == 12.5
    assert read("scene_build_s") == 1.25
    assert read("render.mrays_per_s") == pytest.approx(2.0)


def test_layer_readers():
    assert read("layer.raygen.ms") == 0.5
    assert read("layer.shade.ms") == 4.0
    assert read("layer.closest_trace.ms") == 3.0
    assert read("layer.sort_keys.ms") is None  # nothing to read
    assert read("layer.shadow_trace.ms") is None


def test_kernel_device_and_dispatch_readers():
    assert read("kernels.trace_ms") == pytest.approx(1.5)  # 6 ms / 4
    assert read("device.idle_pct") == pytest.approx(5.0)
    assert read("dispatch.launch_calls_per_sample") == pytest.approx(0.5)


def test_roofline_arithmetic_on_given_rays():
    # 4e6 closest rays x 32 B + 2e6 shadow rays x 29 B = 1.86e8 B -> 55.5
    # us at 3.35e12 B/s; 6e6 rays x 30 slots = 1.8e8 -> 5.38 us
    least = trace_least_s(4.0e6, 2.0e6, 3.3454e13)
    assert least == pytest.approx(1.86e8 / 3.35e12)
    assert read("kernels.trace_roofline_pct") == pytest.approx(
        100 * least / 0.006)
    assert read("step_mfu") == pytest.approx(100 * least / 0.2)
    assert 0 < read("kernels.trace_roofline_pct") <= 100


def test_untraced_run_reads_nothing_per_layer():
    rec = dict(record(), trace=None)
    for name in ("layer.raygen.ms", "kernels.trace_ms", "device.idle_pct",
                 "kernels.trace_roofline_pct", "step_mfu",
                 "dispatch.launch_calls_per_sample"):
        assert read(name, rec) is None
