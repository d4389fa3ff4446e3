"""One grade step (``ExtrapolationMonitor.evaluate``) at the window's last
state on the Simulation's list there, by the host clock between
synchronisations, mean of 10 after one more for warm-up. None in a mix
that does not grade."""

import time

import torch

WHEN = "before_trace"


def read(ctx):
    if not ctx.cuda:
        return None
    monitor = getattr(ctx.prog, "monitor", None)
    if monitor is None:
        return None
    sim, state = ctx.prog.sim, ctx.prog.state
    nl = sim.rebuild(state, grid=sim.grid_for(state.cell), max_neighbors=sim.max_neighbors)
    monitor.evaluate(state, nl=nl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        monitor.evaluate(state, nl=nl)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 10 * 1e3
