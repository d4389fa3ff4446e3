"""Device milliseconds per traced step of the Verlet staleness check (the
top-2 displacement test of ``md/simulation.py``): the operations launched
under the program span ``md.verlet_check`` (``mdbench.spans``), over the
traced window's steps. None where the program opens no such span."""

from mdbench.spans import device_seconds_by_span, span_counts

WHEN = "after_trace"


def read(ctx):
    if not ctx.cuda or not ctx.trace_steps or not span_counts(ctx.events)["md.verlet_check"]:
        return None
    return device_seconds_by_span(ctx.events).get("md.verlet_check", 0.0) / ctx.trace_steps * 1e3
