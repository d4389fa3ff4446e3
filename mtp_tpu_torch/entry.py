"""Entry points of the port: a single-device force step and a multi-rank dry
run (twins of the JAX package's ``__graft_entry__.py``).

    python -m mtp_tpu_torch.entry [N_RANKS] [--device cpu]

runs :func:`entry`'s force step once on the card (``--device cpu``: on the
CPU, through the kernels' plain twins) and prints the energy, then
:func:`dryrun_multichip` on `N_RANKS` CPU ranks (default 8).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

SKIN = 0.2  # the dry run's Verlet skin [A]


def _flagship(device, dtype):
    """The flagship configuration: a level-16 potential, a 256-atom fcc box."""
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.md.simulation import make_lattice
    from mtp_tpu_torch.models.mtp import MTPModel

    model = MTPModel.from_data(make_mtp(16, species_count=1, seed=0), device=device, dtype=dtype)
    pos, types, cell = make_lattice("fcc", 4.0, (4, 4, 4))
    return model, pos, types, cell


def entry(device="cuda"):
    """Returns ``(fn, example_args)``: ``fn(positions) -> (energy, forces)``,
    one fp32 force evaluation on the window path (K1, K4 with its gradient
    K2's stages, K3 on the card) against a list built once at the example
    positions."""
    from mtp_tpu_torch.models.mtp import mtp_energy_forces_window, window_constants
    from mtp_tpu_torch.ops.neighbors import build_sorted_neighbor_list, grid_shape

    model, pos, types, cell = _flagship(device, torch.float32)
    dev = model.coeffs.radial_coeffs.device
    p = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    c = torch.as_tensor(cell, dtype=torch.float32, device=dev)
    t = torch.as_tensor(types, dtype=torch.int32, device=dev)
    swl = build_sorted_neighbor_list(p, c, model.cutoff, max_neighbors=64,
                                     grid=grid_shape(cell, model.cutoff))
    consts = window_constants(model, t, swl)

    def fn(positions):
        out = mtp_energy_forces_window(model, positions, c, swl, compute_virial=False, **consts)
        return out["energy"], out["forces"]

    return fn, (p,)


def _reps_x(n_ranks: int) -> int:
    """Cells along x: one per rank, as the JAX dry run has it; on one or two
    ranks, where that box would break the width guards (a slab of 2 ranks
    >= 2 x (cutoff + skin), a cell >= 2 x (cutoff + skin)), two per rank."""
    return 2 * n_ranks if n_ranks <= 2 else n_ranks


def _dryrun_rank(rank, world):
    """One rank of :func:`dryrun_multichip`: the JAX dry run's sequence on
    its tiny shapes, in fp32, every rank with the same data. Returns the
    numbers it checked."""
    from mtp_tpu_torch.al.driver import ShardedExtrapolationMonitor, run_sharded_with_extrapolation
    from mtp_tpu_torch.al.maxvol import build_mvs
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.md.simulation import make_lattice
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.neighbors import grid_shape
    from mtp_tpu_torch.parallel.comm import Comm
    from mtp_tpu_torch.parallel.domain import partition_bricks, partition_slabs
    from mtp_tpu_torch.parallel.sharded_md import (
        ShardedState,
        make_sharded_grades,
        make_sharded_md_block,
    )
    from mtp_tpu_torch.parallel.sharded_window import ShardedSimulation

    n = world
    comm = Comm()
    f32 = dict(dtype=torch.float32, device="cpu")
    # small cutoff so slabs stay tiny: fcc a = 3.2, cutoff 2.8 (12 NN at 2.26)
    m = make_mtp(8, species_count=1, seed=0, min_dist=1.2, max_dist=2.8, r0=2.12)
    model = MTPModel.from_data(m, device="cpu", dtype=torch.float32)
    w_cut = model.cutoff + SKIN
    rng = np.random.default_rng(0)

    def capacity(n_atoms, headroom):
        return int(np.ceil((n_atoms / n * headroom + 16) / 8) * 8)

    # the row-gather block on a box 2 bins across y and z
    pos, types, cell = make_lattice("fcc", 3.2, (_reps_x(n), 2, 2))
    pos = pos + rng.normal(scale=0.03, size=pos.shape)
    masses = np.full(len(pos), 58.693)
    part = partition_slabs(pos, np.zeros_like(pos), types, masses, cell, n, cutoff=w_cut)
    state = ShardedState.from_partition(part, cell, rank, **f32)
    block = make_sharded_md_block(model, comm, capacity=part.capacity, max_neighbors=24,
                                  grid=grid_shape(cell, w_cut), skin=SKIN, n_steps=1, dt=0.001)
    state, flags = block(state)
    assert not bool(flags.any()), f"sharded-block flags set in dryrun: {flags}"
    e = float(state.potential_energy)
    assert math.isfinite(e), "non-finite energy in dryrun"
    assert bool(state.forces[state.real].isfinite().all()), "non-finite forces"

    # the sharded window engine: NVE, iso-MTK NPT and triclinic NPT blocks
    pos2, types2, cell2 = make_lattice("fcc", 3.2, (_reps_x(n), 3, 3))
    pos2 = pos2 + rng.normal(scale=0.03, size=pos2.shape)
    masses2 = np.full(len(pos2), 58.693)
    vel2 = rng.normal(scale=5e-4, size=pos2.shape)
    part2 = partition_slabs(pos2, vel2, types2, masses2, cell2, n, cutoff=w_cut,
                            capacity=capacity(len(pos2), 1.5))
    state2 = ShardedState.from_partition(part2, cell2, rank, **f32)
    grid2 = grid_shape(cell2, w_cut * 1.02)
    wsim = ShardedSimulation(model, comm, capacity=part2.capacity, max_neighbors=24, grid=grid2,
                             skin=SKIN, steps_per_rebuild=2, compute_virial=True)
    state2, wflags = wsim.run(state2, 2, ensemble="nve", dt=0.001)
    assert not bool(wflags.any()), f"sharded-window NVE flags: {wflags}"
    npt = dict(dt=0.001, temperature=300.0, pressure=0.0, tdamp=0.1, pdamp=1.0, refresh=False)
    for ens in ("npt", "npt-tri"):
        state2, wflags = wsim.run(state2, 2, ensemble=ens, **npt)
        assert not bool(wflags.any()), f"sharded-window {ens} flags: {wflags}"
    e2 = float(state2.potential_energy)
    assert math.isfinite(e2), "non-finite energy in sharded-window dryrun"

    # the grades over ranks (max in neighborhood mode)
    m.mvs = build_mvs(rng.normal(size=(5 * m.coeff_count, m.coeff_count)))
    model_al = MTPModel.from_data(m, device="cpu", dtype=torch.float32)
    grades_fn = make_sharded_grades(model_al, comm, capacity=part.capacity, max_neighbors=24,
                                    grid=grid_shape(cell, model_al.cutoff))
    gmax, _, g_flags = grades_fn(state)
    assert math.isfinite(float(gmax)), "non-finite max grade in dryrun"
    assert not bool(g_flags), "overflow in dryrun grades"

    # 2-D bricks (two-stage halo, corner ghosts on the second hop, two-hop
    # give-back): one NVE run on an (n/2, 2) grid
    eb = None
    if n >= 4 and n % 2 == 0:
        shape = (n // 2, 2)
        posb, typesb, cellb = make_lattice("fcc", 3.2, (2 * shape[0], 2 * shape[1], 3))
        posb = posb + rng.normal(scale=0.03, size=posb.shape)
        massesb = np.full(len(posb), 58.693)
        velb = rng.normal(scale=5e-4, size=posb.shape)
        partb = partition_bricks(posb, velb, typesb, massesb, cellb, shape, cutoff=w_cut,
                                 capacity=capacity(len(posb), 1.6))
        bsim = ShardedSimulation(model, Comm(shape), capacity=partb.capacity, max_neighbors=24,
                                 grid=grid_shape(cellb, w_cut * 1.02), skin=SKIN,
                                 steps_per_rebuild=2)
        stateb = ShardedState.from_partition(partb, cellb, rank, **f32)
        stateb, bflags = bsim.run_async(stateb, 2, ensemble="nve", dt=0.001)
        assert not bool(bflags.any()), f"brick NVE flags: {bflags}"
        eb = float(stateb.potential_energy)
        assert math.isfinite(eb), "non-finite energy in the brick dryrun"

    # active learning on the window engine: grades in the block context,
    # forces refreshed from the same pass
    state3 = ShardedState.from_partition(part2, cell2, rank, **f32)
    wsim_al = ShardedSimulation(model_al, comm, capacity=part2.capacity, max_neighbors=24,
                                grid=grid2, skin=SKIN, steps_per_rebuild=2)
    mon = ShardedExtrapolationMonitor(model_al, comm)
    run_sharded_with_extrapolation(wsim_al, mon, state3, 2, al_every=2, ensemble="nve",
                                   dt=0.001)
    wg = mon.max_grade
    assert math.isfinite(wg) and wg > 0, "window-engine grade not produced"
    assert mon.nbh_grades is not None and len(mon.nbh_grades) == len(pos2)
    out = dict(pe=e, window_pe=e2, brick_pe=eb, max_grade=float(gmax), window_max_grade=wg,
               atoms=len(pos), grid=block.sim.grid)
    if rank == 0:
        print(f"dryrun_multichip({n}): OK, PE={e:.6f} eV (grid {block.sim.grid}), "
              f"window PE={e2:.6f} eV (NVE+NPT), max_grade={out['max_grade']:.4f}, "
              f"window AL max_grade={wg:.4f}, {len(pos)} atoms over {n} slabs", flush=True)
    return out


def dryrun_multichip(n_ranks: int):
    """One multi-rank MD block on the row-gather API, the sharded window
    engine in NVE, NPT and NPT-tri, the grades over ranks, 2-D bricks (4 or
    more ranks, even) and the sharded AL driver, on `n_ranks` gloo rank
    processes on the CPU at tiny shapes (the ranks see no card, whatever
    the host has). Prints rank 0's summary; returns every rank's numbers;
    raises if a rank fails."""
    from mtp_tpu_torch.parallel.launch import spawn

    return spawn("mtp_tpu_torch.entry:_dryrun_rank", n_ranks, backend="gloo", threads=1,
                 env=dict(CUDA_VISIBLE_DEVICES=""), timeout=600.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mtp_tpu_torch.entry")
    ap.add_argument("n_ranks", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, ex = entry(device=args.device)
    energy, _ = fn(*ex)
    print(f"entry(): energy = {float(energy)}")
    dryrun_multichip(args.n_ranks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
