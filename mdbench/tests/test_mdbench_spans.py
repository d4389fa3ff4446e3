"""The program-span arithmetic (``mdbench.spans``) and the readers built on
it, on a synthetic Chrome trace of one block, two steps, a flag read and a
cell read."""

import types

import pytest

from mdbench import spans
from mdbench.metrics import (
    integrator_ms,
    nl_build_ms,
    rebuilds_per_step,
    sync_idle_share,
    verlet_check_ms,
)


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _device(ts, dur, corr=None, cat="kernel"):
    e = {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _launched(launch_ts, ts, dur, corr, cat="kernel"):
    return [_launch(launch_ts, corr), _device(ts, dur, corr, cat)]


EVENTS = [
    _span("Simulation.block", 0, 200),  # the benchmark's own: passed over
    _span("md.block", 0, 200),
    _span("nl.build", 0, 40),
    _span("nl.sort", 0, 20), *_launched(2, 5, 10, 1),
    _span("nl.rows", 20, 15), *_launched(22, 25, 10, 2),
    *_launched(36, 36, 4, 3),  # nl.build's own
    _span("md.steps", 40, 160),
    _span("md.integrate", 40, 50), *_launched(41, 42, 5, 4),
    _span("force", 50, 30),  # the benchmark's, between md.integrate and mtp.forces
    *_launched(51, 76, 2, 6),  # under force but outside mtp.forces: md.integrate's
    _span("mtp.forces", 52, 26), *_launched(53, 55, 20, 5),
    _span("md.verlet_check", 90, 10), *_launched(91, 92, 3, 7),
    _span("md.integrate", 100, 50), *_launched(101, 102, 4, 8),
    _span("mtp.forces", 110, 30), *_launched(111, 112, 20, 9),
    _span("md.verlet_check", 150, 10), *_launched(151, 198, 5, 10),
    _span("md.read_flags", 200, 60), *_launched(201, 250, 5, 11, "gpu_memcpy"),
    _span("md.read_cell", 260, 10), *_launched(261, 262, 1, 12, "gpu_memcpy"),
    _span("md.block", 270, 130), *_launched(271, 300, 10, 13),
    _device(320, 10),  # no correlation: no owner, but the device was busy
    _launch(280, 99),  # a launch whose device event is not in the trace
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 5},
]

US = 1e-6


def test_device_time_goes_to_the_innermost_program_span():
    got = spans.device_seconds_by_span(EVENTS)
    assert got == pytest.approx({
        "nl.sort": 10 * US, "nl.rows": 10 * US, "nl.build": 4 * US,
        "md.integrate": (5 + 2 + 4) * US,  # its mtp.forces children excluded
        "mtp.forces": 40 * US, "md.verlet_check": 8 * US,
        "md.read_flags": 5 * US, "md.read_cell": 1 * US, "md.block": 10 * US,
    })
    assert "Simulation.block" not in got and "force" not in got


def test_idle_gaps_go_to_the_span_open_when_they_began():
    got = spans.idle_seconds_by_span(EVENTS)
    assert got == pytest.approx({
        "nl.sort": 10 * US, "nl.build": 1 * US, "md.integrate": (2 + 8 + 14 + 6) * US,
        "mtp.forces": (1 + 66) * US, "md.verlet_check": 7 * US,
        "md.read_flags": (47 + 7) * US, "md.read_cell": 37 * US, "md.block": 10 * US,
    })


def test_span_counts_and_innermost():
    counts = spans.span_counts(EVENTS)
    assert counts["md.block"] == 2 and counts["md.integrate"] == 2 and counts["nl.build"] == 1
    assert "force" not in counts
    s = spans.program_spans(EVENTS)
    # a span is open from its start up to, not including, its end
    assert spans.innermost(s, [40.0, 0.0, 20.0, 35.0, 500.0]) == [
        "md.integrate", "nl.sort", "nl.rows", "nl.build", None]


def _ctx(events, steps=2, cuda=True):
    return types.SimpleNamespace(events=events, trace_steps=steps, cuda=cuda)


def test_readers_on_the_synthetic_trace():
    ctx = _ctx(EVENTS)
    assert integrator_ms.read(ctx) == pytest.approx(11 * US / 2 * 1e3)
    assert verlet_check_ms.read(ctx) == pytest.approx(8 * US / 2 * 1e3)
    assert nl_build_ms.read(ctx) == pytest.approx(24 * US * 1e3)
    assert rebuilds_per_step.read(ctx) == pytest.approx(0.5)
    # idle begun under the reads (47 + 7 + 37 us) over the device span (5 .. 330 us)
    assert sync_idle_share.read(ctx) == pytest.approx(100.0 * 91 / 325)


def test_a_gap_is_sync_idle_only_when_it_begins_under_a_read():
    # the flag read now opens at 256, after both gaps it held have begun
    moved = [dict(e, ts=256, dur=4) if e.get("name") == "md.read_flags" else e for e in EVENTS]
    idle = spans.idle_seconds_by_span(moved)
    assert "md.read_flags" not in idle
    assert sum(idle.values()) == pytest.approx((216 - 47 - 7) * US)  # the two under no span
    assert sync_idle_share.read(_ctx(moved)) == pytest.approx(100.0 * 37 / 325)


ALL = (integrator_ms, verlet_check_ms, nl_build_ms, rebuilds_per_step, sync_idle_share)


@pytest.mark.parametrize("reader", ALL, ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_readers_find_nothing_without_program_spans(reader):
    """A program that opens no spans of its own (a checkout older than
    them): each reader returns None and raises nothing; so on the CPU."""
    bare = [e for e in EVENTS if not e.get("name", "").startswith(spans.PREFIXES)]
    assert reader.WHEN == "after_trace"
    assert reader.read(_ctx(bare)) is None
    assert reader.read(_ctx(EVENTS, cuda=False)) is None
