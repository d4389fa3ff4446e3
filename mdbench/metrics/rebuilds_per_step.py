"""Neighbor rebuilds per MD step in the traced window: the program's
``nl.build`` spans over the traced steps. Retried blocks' rebuilds and the
active-learning driver's list for its first grade step count. None where
the program opens no such span."""

from mdbench.spans import span_counts

WHEN = "after_trace"


def read(ctx):
    if not ctx.cuda or not ctx.trace_steps:
        return None
    builds = span_counts(ctx.events)["nl.build"]
    return builds / ctx.trace_steps if builds else None
