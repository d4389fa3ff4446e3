"""The program's own spans in a ``torch.profiler`` Chrome trace.

The program opens ``record_function`` spans at its layer boundaries, each
name with its layer as a prefix (``md.``, ``nl.``, ``mtp.``, ``al.``; the
program's ``utils/tracing.py``). The benchmark's own spans (``Simulation.run``,
``force``, the observer, the traffic's methods) carry no such prefix and are
passed over here, so a program span is the innermost one even where a
benchmark span sits between it and its parent.

``device_seconds_by_span`` puts each device operation under the innermost
program span open when its launch call ran, tied by the trace's
``correlation`` id as ``trace.device_seconds_under`` does; a device event
without a correlation, or whose launch is not in the trace, is left out.
``idle_seconds_by_span`` puts each gap of ``trace.idle_gaps`` under the
innermost program span open when the gap began. A program without these
spans gives empty results, and the readers of ``mdbench/metrics/`` then
return None.
"""

from __future__ import annotations

import collections

from mdbench.trace import DEVICE_CATS, LAUNCH_CATS, idle_gaps

PREFIXES = ("md.", "nl.", "mtp.", "al.")


def program_spans(trace_events) -> list:
    """[(start_us, end_us, name)] of the program's spans, by start, the outer
    of two that start together first."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in trace_events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIXES)]
    return sorted(spans, key=lambda s: (s[0], -s[1]))


def span_counts(trace_events) -> collections.Counter:
    """How many times each program span was opened."""
    return collections.Counter(name for _, _, name in program_spans(trace_events))


def innermost(spans, times) -> list:
    """For each time in `times`, the name of the innermost span of `spans`
    (nested, as ``program_spans`` gives them) open at it, or None. A span
    is open from its start up to, not including, its end."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    stack, k = [], 0
    for i in order:
        t = times[i]
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] <= spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def device_seconds_by_span(trace_events) -> dict:
    """{program span: device seconds of the operations launched while it
    was the innermost program span open}."""
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in trace_events
                 if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    device = [e for e in trace_events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and e.get("args", {}).get("correlation") in launch_ts]
    names = innermost(program_spans(trace_events),
                      [launch_ts[e["args"]["correlation"]] for e in device])
    out = collections.defaultdict(float)
    for e, name in zip(device, names):
        if name is not None:
            out[name] += float(e["dur"]) * 1e-6
    return dict(out)


def idle_seconds_by_span(trace_events) -> dict:
    """{program span: seconds of device idle gaps that began while it was
    the innermost program span open}."""
    gaps = idle_gaps(trace_events)
    names = innermost(program_spans(trace_events), [g0 for g0, _ in gaps])
    out = collections.defaultdict(float)
    for (g0, g1), name in zip(gaps, names):
        if name is not None:
            out[name] += (g1 - g0) * 1e-6
    return dict(out)
