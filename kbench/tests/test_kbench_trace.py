"""The device trace: busy time is the union of the device's activity inside
the window, kernels are summed by name, idle gaps are named by the host
spans open across them."""

import pytest

from kbench.trace import WINDOW_SPAN, DeviceTrace, short_name


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    _ev(WINDOW_SPAN, "user_annotation", 100.0, 1000.0),
    _ev("kbench.job.index", "user_annotation", 100.0, 1000.0),
    _ev("verify", "user_annotation", 700.0, 300.0),
    _ev("void sweep_sorted_kernel<int>(unsigned char*, long, int const*, long)", "kernel",
        150.0, 100.0),
    _ev("void sweep_sorted_kernel<int>(unsigned char*, long, int const*, long)", "kernel",
        200.0, 100.0),  # overlaps the first: the union counts 150..300 once
    _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 500.0, 100.0),
    _ev("encode_packed_kernel", "kernel", 50.0, 100.0),  # half outside the window
    _ev("aten::sort", "cpu_op", 0.0, 2000.0),
    {"ph": "i", "name": "marker", "ts": 300.0},
]}


def test_busy_window_and_kernels():
    t = DeviceTrace(TRACE)
    assert t.window_s == pytest.approx(1000e-6)
    # 100..150 (encode, cut at the window), 150..300, 500..600
    assert t.busy_s == pytest.approx(300e-6)
    assert t.kernel_seconds("sweep_sorted_kernel") == pytest.approx(200e-6)
    assert t.kernel_seconds("encode_packed_kernel") == pytest.approx(50e-6)
    assert t.kernel_seconds("") == pytest.approx(250e-6)


def test_top_ops_and_idle_gaps():
    t = DeviceTrace(TRACE)
    assert t.top_ops()[0] == ["sweep_sorted_kernel<int>", pytest.approx(200e-6)]
    gaps = dict((k, v) for k, v in t.idle_gaps())
    # idle: 300..500 and 600..700 in the job, 700..1000 in verify, 1000..1100 in the job
    assert gaps["verify"] == pytest.approx(300e-6)
    assert gaps["kbench.job.index"] == pytest.approx(400e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_short_names():
    assert short_name("void sweep_sorted_kernel<int>(unsigned char*, long)") \
        == "sweep_sorted_kernel<int>"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert short_name("void at::native::(anonymous namespace)::fill_kernel(long*)") \
        == "at::native::fill_kernel"
