"""One neighbor rebuild (``Simulation.rebuild``) at the window's last state
and list width, by the host clock between synchronisations, mean of 5
after one more for warm-up."""

import time

import torch

WHEN = "before_trace"


def read(ctx):
    if not ctx.cuda:
        return None
    sim, state = ctx.prog.sim, ctx.prog.state
    grid = sim.grid_for(state.cell)
    sim.rebuild(state, grid=grid, max_neighbors=sim.max_neighbors)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        sim.rebuild(state, grid=grid, max_neighbors=sim.max_neighbors)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 5 * 1e3
