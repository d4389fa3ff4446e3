"""Device milliseconds per traced step of the integrator: the operations
launched while ``md.integrate`` (one integrator step of
``md/integrators.py``) was the innermost program span open, so not the
force call (``mtp.forces``) that nests inside it (``mdbench.spans``), over
the traced window's steps. None where the program opens no such span."""

from mdbench.spans import device_seconds_by_span, span_counts

WHEN = "after_trace"


def read(ctx):
    if not ctx.cuda or not ctx.trace_steps or not span_counts(ctx.events)["md.integrate"]:
        return None
    return device_seconds_by_span(ctx.events).get("md.integrate", 0.0) / ctx.trace_steps * 1e3
