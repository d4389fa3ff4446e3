"""Arithmetic on a ``torch.profiler`` Chrome trace.

``device_window`` and ``kernel_count`` are frozen copies of the program's
``utils/prof.py``; ``breakdown`` adds the two lists the result line
carries: the device operations that took most time, and the device's idle
gaps summed by the host span that was open when each began;
``device_seconds_under`` the device time of what a named host span
launched.
"""

from __future__ import annotations

import bisect

# Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_events(trace_events):
    return [e for e in trace_events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def device_window(trace_events):
    """(span_us, busy_us) of the device events of one Chrome trace: the span
    from the first event's start to the last one's end, and the part of it
    in which at least one event ran (overlaps counted once)."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in _device_events(trace_events))
    if not iv:
        raise ValueError("the trace holds no device events")
    busy = 0.0
    lo, hi = iv[0]
    for s, e in iv[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return max(e for _, e in iv) - iv[0][0], busy


def kernel_count(trace_events) -> int:
    """Kernels that ran on the device in one Chrome trace."""
    return sum(1 for e in trace_events if e.get("ph") == "X" and e.get("cat") == "kernel")


# Chrome-trace categories of the host's launch calls
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def device_seconds_under(trace_events, label: str):
    """(seconds, spans): the device time of the operations launched while a
    host span named `label` (``record_function``, not nested in itself) was
    open, and the number of such spans. A device event is tied to the host
    call that launched it by the trace's ``correlation`` id."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in trace_events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") == label)
    starts = [s for s, _ in spans]

    def inside(t):
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t < spans[k][1]

    launched = {e["args"]["correlation"] for e in trace_events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {}) and inside(float(e["ts"]))}
    busy = sum(float(e["dur"]) for e in _device_events(trace_events)
               if e.get("args", {}).get("correlation") in launched)
    return busy * 1e-6, len(spans)


def idle_gaps(trace_events):
    """[(start_us, end_us)] of the intervals between device events in which
    no device event ran."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in _device_events(trace_events))
    gaps, hi = [], iv[0][1] if iv else 0.0
    for s, e in iv[1:]:
        if s > hi:
            gaps.append((hi, s))
        hi = max(hi, e)
    return gaps


def breakdown(trace_events, top: int = 10) -> dict:
    """``device_ops``: [name, seconds] of the device operations with the
    most time in all; ``idle_gaps``: [name, seconds] of the device's idle
    time, each gap put under the innermost host span (``user_annotation``,
    the benchmark's ``record_function`` spans) open when it began, or
    ``"no span"``."""
    ops = {}
    for e in _device_events(trace_events):
        ops[e["name"][:120]] = ops.get(e["name"][:120], 0.0) + float(e["dur"]) * 1e-6
    spans = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in trace_events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
    )
    idle = {}
    for g0, g1 in idle_gaps(trace_events):
        inner = [s for s in spans if s[0] <= g0 < s[1]]
        name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "no span"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
