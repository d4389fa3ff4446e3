"""The trace arithmetic on a synthetic Chrome trace."""

import pytest

from mdbench import trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _ev("user_annotation", "Simulation.run", 0, 100),
    _ev("user_annotation", "Simulation.rebuild", 0, 30),
    _ev("user_annotation", "Simulation.block", 30, 70),
    _ev("kernel", "k_sort", 10, 10),  # 10-20
    _ev("kernel", "k_force", 35, 20),  # 35-55, gap 20-35 opened under rebuild
    _ev("gpu_memcpy", "copy", 50, 10),  # overlaps the kernel: 35-60 busy
    _ev("kernel", "k_force", 80, 10),  # gap 60-80 under block
    _ev("cpu_op", "aten::add", 0, 5),
]


def test_device_window_counts_overlaps_once():
    span, busy = trace.device_window(EVENTS)
    assert span == 80.0  # 10 .. 90
    assert busy == 10 + 25 + 10


def test_kernel_count_and_gaps():
    assert trace.kernel_count(EVENTS) == 3
    assert trace.idle_gaps(EVENTS) == [(20.0, 35.0), (60.0, 80.0)]


def test_breakdown_names_gaps_by_innermost_span():
    b = trace.breakdown(EVENTS)
    assert b["device_ops"][0] == ["k_force", pytest.approx(30e-6)]
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "Simulation.rebuild": pytest.approx(15e-6),
        "Simulation.block": pytest.approx(20e-6),
    }


def test_empty_trace_has_no_device_window():
    with pytest.raises(ValueError):
        trace.device_window([_ev("cpu_op", "x", 0, 1)])


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _kernel(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_device_seconds_under_a_span_follow_the_launches():
    events = [
        _ev("user_annotation", "force", 0, 10),
        _ev("user_annotation", "force", 20, 10),
        _ev("user_annotation", "other", 40, 10),
        _launch(2, 1), _launch(5, 2),  # in the first span
        _launch(12, 3),  # between the spans
        _launch(25, 4),  # in the second span
        _launch(45, 5),  # in another span
        _kernel(30, 7, 1), _kernel(37, 3, 2), _kernel(40, 50, 3), _kernel(90, 4, 4),
        _kernel(94, 9, 5),
    ]
    seconds, spans = trace.device_seconds_under(events, "force")
    assert spans == 2
    assert seconds == pytest.approx((7 + 3 + 4) * 1e-6)
    assert trace.device_seconds_under(events, "absent") == (0.0, 0)
