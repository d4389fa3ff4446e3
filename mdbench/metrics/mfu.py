"""Model FLOP utilisation of the measured window: the model's work in the
blocks the window completed (``mdbench.work``: K1 + K2 + K3 per step, K4
per block, and in a graded mix K1 + K5 + K3 per grade step), each kernel's
operations at the peak rate of their type, over the window's wall time.
Retried blocks, refreshed forces and the rebuild count as time, not work."""

from mdbench import work

WHEN = "before_trace"


def read(ctx):
    if not ctx.cuda:
        return None
    w = ctx.window
    j, n, live = ctx.prog.sim.max_neighbors, ctx.n_atoms, ctx.live_pairs()
    seconds = (w["steps"] * work.peak_seconds(work.STEP, ctx.pot, n, j, live)
               + w["blocks"] * work.peak_seconds(work.BLOCK, ctx.pot, n, j, live))
    if ctx.traffic.get("al_every"):
        seconds += w["blocks"] * work.peak_seconds(work.GRADE, ctx.pot, n, j, live)
    return 100.0 * seconds / w["seconds"]
