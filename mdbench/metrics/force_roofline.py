"""Share of the roofline of the force path: the least time the chip could
take for the work of K1 + K2 + K3 (``mdbench.work``, live pairs counted by
the benchmark's own search at the traced window's end) in every call of
the Simulation's force closure in the traced window, over the device time
of the operations those calls launched (``force`` spans, read from the
trace by ``mdbench.trace.device_seconds_under``). The count is of the
function's work, so it reads the same whatever kernels implement it."""

from mdbench import work
from mdbench.trace import device_seconds_under

WHEN = "after_trace"


def read(ctx):
    if not ctx.cuda:
        return None
    seconds, calls = device_seconds_under(ctx.events, "force")
    if not calls or seconds <= 0.0:
        return None
    bound = work.bound_seconds(work.STEP, ctx.pot, ctx.n_atoms, ctx.prog.sim.max_neighbors,
                               ctx.live_pairs())
    return 100.0 * calls * bound / seconds
