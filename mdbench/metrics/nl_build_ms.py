"""Device milliseconds per neighbor rebuild in the traced window: the
operations launched under the program span ``nl.build`` and its ``nl.*``
children (bin sort, row phases, mirror; ``mdbench.spans``), over the number
of ``nl.build`` spans. The in-window counterpart of ``rebuild_ms``, which
times rebuilds by the host clock outside the window. None where the
program opens no such span."""

from mdbench.spans import device_seconds_by_span, span_counts

WHEN = "after_trace"


def read(ctx):
    if not ctx.cuda:
        return None
    builds = span_counts(ctx.events)["nl.build"]
    if not builds:
        return None
    seconds = sum(s for name, s in device_seconds_by_span(ctx.events).items()
                  if name.startswith("nl."))
    return seconds / builds * 1e3
