"""Share of the traced window's device span in which no device operation
ran: 100 * (1 - busy / span) of the trace's device events (``prof.py``'s
``device_window``)."""

from mdbench.trace import device_window

WHEN = "after_trace"


def read(ctx):
    if not ctx.cuda:
        return None
    span, busy = device_window(ctx.events)
    return 100.0 * (1.0 - busy / span)
