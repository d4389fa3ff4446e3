"""Kernels launched per MD step in the traced window (``prof.py``'s count):
every kernel event of the trace over the steps the traced calls ran."""

from mdbench.trace import kernel_count

WHEN = "after_trace"


def read(ctx):
    if not ctx.cuda:
        return None
    return kernel_count(ctx.events) / ctx.trace_steps if ctx.trace_steps else None
