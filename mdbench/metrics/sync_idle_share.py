"""Share of the traced window's device span in which the device was idle
while the host waited in a blocking read: 100 x the idle gaps that began
while ``md.read_flags`` (a block's or segment's flags), ``md.read_cell``
(the cell, for the bin grid) or ``al.read_grade`` (the max grade) was the
innermost program span open (``mdbench.spans``), over the span of the
trace's device events (``trace.device_window``). None where the program
opens none of these spans."""

from mdbench.spans import idle_seconds_by_span, span_counts
from mdbench.trace import device_window

WHEN = "after_trace"

READS = ("md.read_flags", "md.read_cell", "al.read_grade")


def read(ctx):
    if not ctx.cuda:
        return None
    counts = span_counts(ctx.events)
    if not any(counts[name] for name in READS):
        return None
    idle = idle_seconds_by_span(ctx.events)
    span_us, _ = device_window(ctx.events)
    return 100.0 * sum(idle.get(name, 0.0) for name in READS) / (span_us * 1e-6)
