"""Rank functions of the port's multi-device CPU tests (run through
``_torch_spawn.World``): each runs on every rank of a gloo world, in
float64 on the plain twins, and returns NumPy results; the test modules hold
them against the JAX package and the port's single-device path. Imports
torch and the port only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.models.mtp import MTPModel
from mtp_tpu_torch.ops.neighbors import grid_shape
from mtp_tpu_torch.parallel.comm import Comm
from mtp_tpu_torch.parallel.domain import halo_capacities, partition_bricks, partition_slabs
from mtp_tpu_torch.parallel.sharded_md import ShardedState
from mtp_tpu_torch.parallel.sharded_window import ShardedSimulation

F64 = torch.float64
SKIN = 0.3


def level8(inverse_active_set=None, configuration_mode=False):
    """The tests' level-8 one-species potential (``make_mtp(8, seed=0)``,
    byte-identical to the JAX package's), with an MVS state if given."""
    model = MTPModel.from_data(make_mtp(8, species_count=1, seed=0), device="cpu", dtype=F64)
    if inverse_active_set is None:
        return model
    return dataclasses.replace(
        model, inverse_active_set=torch.as_tensor(inverse_active_set, dtype=F64),
        configuration_mode=configuration_mode,
    )


def shard(model, comm, box, *, skin=SKIN, steps_per_rebuild=10, margin=1.0, headroom=1.4,
          vel_scale=1.0, **kw):
    """A ShardedSimulation and this rank's ShardedState of `box` (dict of
    pos, types, masses, cell, vel) on `comm`'s grid: slabs along x, or
    bricks along x and y, with the JAX tests' capacity headroom."""
    n = len(box["pos"])
    nd = comm.world
    cap = int(np.ceil((n / nd * headroom + 16) / 8) * 8)
    cut = model.cutoff + skin
    args = (box["pos"], box["vel"] * vel_scale, box["types"], box["masses"], box["cell"])
    if len(comm.grid) == 1:
        part = partition_slabs(*args, nd, cutoff=cut, capacity=cap)
    else:
        part = partition_bricks(*args, comm.grid, cutoff=cut, capacity=cap)
    sstate = ShardedState.from_partition(part, box["cell"], comm.rank, dtype=F64, device="cpu")
    if "halo_capacity" not in kw:
        kw["halo_capacity"] = halo_capacities(part, box["cell"], comm.grid, cut)
    sim = ShardedSimulation(
        model, comm, capacity=part.capacity, max_neighbors=64,
        grid=grid_shape(box["cell"], cut * margin), skin=skin,
        steps_per_rebuild=steps_per_rebuild, **kw,
    )
    return sim, sstate


def replicated_equal(comm, state) -> bool:
    """Whether the replicated fields are bit-equal on every rank."""
    rep = torch.cat([state.cell.reshape(-1), state.potential_energy.reshape(1),
                     state.virial, state.thermo])
    every = comm.all_gather(rep)
    return bool((every == every[0]).all())


def trajectory(comm, sim, sstate, n_steps, **kw):
    """`run` for n_steps. Returns (result, final state): the gathered
    positions, forces and velocities, the replicated fields, and how many
    atoms arrived at this rank."""
    ids0 = set(sstate.ids[sstate.real].tolist())
    out, flags = sim.run(sstate, n_steps, **kw)
    ids1 = set(out.ids[out.real].tolist())
    pos, frc, vel = out.gather_all([out.positions, out.forces, out.velocities], comm)
    return dict(
        positions=pos, forces=frc, velocities=vel, cell=out.cell.numpy(),
        energy=float(out.potential_energy), virial=out.virial.numpy(), thermo=out.thermo.numpy(),
        flags=bool(torch.stack(list(flags)).any()), replicated=replicated_equal(comm, out),
        arrived=len(ids1 - ids0),
    ), out


# --------------------------------------------------------- 2 slabs (window)


def window_cases(rank, world, cubic, npt_box, ensembles, inverse_active_set, cfg_dir):
    """The 2-slab cases of ``test_torch_parallel_window.py``."""
    comm = Comm()
    model = level8()
    me = torch.tensor([float(rank), 10.0 * rank + 1.0], dtype=F64)
    a, b = comm.shifts([(me, +1), (me + 100.0, -1)], 0)
    res = dict(comm=dict(from_left=a.tolist(), from_right=b.tolist(), sum=comm.sum(me).tolist(),
                         max=comm.max(me).tolist(), any=bool(comm.max(torch.tensor(rank == 1)))))
    # NVE, 20 steps in two blocks, migration on
    sim, ss = shard(model, comm, cubic)
    res["nve"], _ = trajectory(comm, sim, ss, 20, ensemble="nve", dt=0.001)
    # NVT, and MTK NPT on the wider box (a 1.08 grid margin keeps 3 bins
    # while the barostat breathes)
    for ens, kw in ensembles.items():
        box, margin = (cubic, 1.0) if ens == "nvt" else (npt_box, 1.08)
        sim, ss = shard(model, comm, box, margin=margin, compute_virial=True)
        res[ens], _ = trajectory(comm, sim, ss, 20, ensemble=ens, dt=0.001, **kw)

    # grades at the lattice positions, in both observation modes
    for cfg_mode in (False, True):
        m = level8(inverse_active_set, cfg_mode)
        sim, ss = shard(m, comm, dict(cubic, vel=np.zeros_like(cubic["pos"])))
        state, ctx, f4 = sim.rebuild(ss)
        out = sim.grade_eval(state, ctx)
        g, frc = state.gather_all([out["grades"], out["forces"]], comm)
        res[f"grades_cfg{int(cfg_mode)}"] = dict(
            flags=bool(torch.stack(list(f4)).any()), max_grade=float(out["max_grade"]),
            grades=g, forces=frc, energy=float(out["energy"]), virial=out["virial"].numpy(),
        )

    # run recovers from a neighbor overflow: J = 40 < 42 in-cutoff neighbors
    sim, ss = shard(model, comm, cubic)
    sim.max_neighbors = 40
    sim._reconfigure()
    res["overflow"], _ = trajectory(comm, sim, ss, 10, ensemble="nve", dt=0.001)
    res["overflow"]["max_neighbors"] = sim.max_neighbors

    # run recovers from staleness (skin 0.12, one 10-step block) ...
    sim, ss = shard(model, comm, cubic, skin=0.12, steps_per_rebuild=10)
    res["stale"], _ = trajectory(comm, sim, ss, 10, ensemble="nve", dt=0.001)
    res["stale"]["steps_per_rebuild"] = sim.steps_per_rebuild
    # ... and raises when even one step outruns the skin
    sim, ss = shard(model, comm, cubic, skin=0.01, steps_per_rebuild=2, vel_scale=50.0)
    try:
        sim.run(ss, 10, ensemble="nve", dt=0.001)
        res["diverging"] = None
    except RuntimeError as e:
        res["diverging"] = str(e)
    # the no-read path flags staleness instead
    sim, ss = shard(model, comm, cubic, skin=0.01, steps_per_rebuild=50)
    _, flags = sim.run_async(ss, 5, ensemble="nve", dt=0.001)
    res["async_stale"] = bool(flags.stale)

    # _recover's dead ends
    sim, _ = shard(model, comm, cubic, halo_capacity=None)
    res["recover"] = _recover_cases(sim)

    # the sharded AL driver, MLIP-3 style, every 4 steps at 5 per block
    res["al"] = _al_case(comm, level8(inverse_active_set), cubic, cfg_dir)
    return res


def _recover_cases(sim):
    out = {}

    def attempt(flags):
        try:
            return sim._recover(flags)
        except RuntimeError as e:
            return f"raised: {e}"

    sim.max_neighbors = 1024
    out["nbr_at_bound"] = attempt((True, False, False, False, False))
    sim.max_neighbors = 64
    out["halo_max_is_none"] = sim.halo_capacity is None
    out["halo_at_max"] = attempt((False, True, False, False, False))
    sim.halo_capacity = (32,)
    sim._reconfigure()
    out["halo_finite"] = attempt((False, True, False, False, False))
    out["halo_after"] = sim.halo_capacity
    sim.migrate_capacity = sim.capacity
    sim._reconfigure()
    out["mig_at_max"] = attempt((False, False, True, False, False))
    sim.migrate_capacity = 8
    sim._reconfigure()
    out["mig_finite"] = attempt((False, False, True, False, False))
    sim.steps_per_rebuild = 1
    out["stale_at_one"] = attempt((False, False, False, False, True))
    out["escape_at_one"] = attempt((False, False, False, True, False))
    return out


def _al_case(comm, model, cubic, cfg_dir):
    from mtp_tpu_torch.al.driver import (
        BreakThresholdExceeded,
        ShardedExtrapolationMonitor,
        run_sharded_with_extrapolation,
    )

    sim, ss = shard(model, comm, cubic, steps_per_rebuild=5)
    mon = ShardedExtrapolationMonitor(model, comm, select_threshold=0.0, break_threshold=1e9,
                                      output_path=f"{cfg_dir}/selected.cfg")
    final = run_sharded_with_extrapolation(sim, mon, ss, 12, al_every=4, ensemble="nve",
                                           dt=0.001)
    mon.close()
    nbh = mon.nbh_grades
    out = dict(positions=final.gather(final.positions, comm), max_grade=mon.max_grade,
               n_grades=None if nbh is None else len(nbh))
    sim, ss = shard(model, comm, cubic, steps_per_rebuild=5)
    mon = ShardedExtrapolationMonitor(model, comm, select_threshold=0.0, break_threshold=0.0,
                                      output_path=f"{cfg_dir}/break.cfg")
    try:
        run_sharded_with_extrapolation(sim, mon, ss, 12, al_every=4, ensemble="nve", dt=0.001)
        out["broke"] = False
    except BreakThresholdExceeded:
        out["broke"] = True
    return out


# --------------------------------------------------- 4 ranks (comm, bricks)


def grid_cases(rank, world, brick):
    """The 4-rank cases of ``test_torch_parallel.py``: the transport on a
    2x2 grid, a 4-ring and a 2-rank subgroup, then NVE on 2x2 bricks (run
    twice for a bit-for-bit repeat) and the observables."""
    from mtp_tpu_torch.parallel.observables import (
        gather_md_state,
        sharded_kinetic_energy,
        sharded_pressure,
        sharded_temperature,
    )

    res = {"rank": rank}
    me = torch.tensor([float(rank), 10.0 * rank + 1.0], dtype=F64)
    grid = Comm((2, 2))
    res["coords"] = grid.coords
    res["grid_shift"] = {
        (axis, d): grid.shift(me, axis, d).tolist() for axis in (0, 1) for d in (+1, -1)
    }
    res["grid_sum"] = grid.sum(me).tolist()
    res["grid_max"] = grid.max(me).tolist()
    res["grid_or"] = bool(grid.max(torch.tensor(rank == 3)))
    ring = Comm()
    res["ring_shift"] = [ring.shift(me, 0, d).tolist() for d in (+1, -1)]
    # a 2-rank subgroup: left and right are ONE peer; one batch carries both
    # directions and each message must land on its own side
    pair = dist.new_group([0, 1])
    if rank < 2:
        sub = Comm(group=pair)
        a, b = sub.shifts([(me, +1), (me + 100.0, -1)], 0)
        res["pair"] = dict(world=sub.world, from_left=a.tolist(), from_right=b.tolist(),
                           sum=sub.sum(me).tolist(), max=sub.max(me).tolist())

    model = level8()
    sim, ss = shard(model, grid, brick, headroom=1.5)
    res["brick"], out = trajectory(grid, sim, ss, 20, ensemble="nve", dt=0.001)
    # two 5-step runs from one state repeat bit for bit; the observables of
    # the first
    (a, _), (b, _) = (sim.run(out, 5, ensemble="nve", dt=0.001) for _ in range(2))
    res["brick_repeats"] = bool(all(torch.equal(getattr(a, k), getattr(b, k)) for k in (
        "positions", "velocities", "forces", "cell", "potential_energy", "virial", "thermo")))
    md = gather_md_state(a, grid, step=5)
    res["observables"] = dict(
        ke=float(sharded_kinetic_energy(a, grid)), temp=float(sharded_temperature(a, grid)),
        press=float(sharded_pressure(a, grid)),
        state={k: getattr(md, k).numpy() for k in ("positions", "velocities", "forces",
                                                   "masses", "types", "cell", "virial")},
        energy=float(md.potential_energy), step=int(md.step),
    )
    return res


# ------------------------------------------------- 2x2 bricks on 4 cards


def brick_run(rank, world, box, n_steps, level=16):
    """NVE for `n_steps` on 2x2 bricks through ``run_async`` (30 steps per
    block): on an NCCL world each rank on its own card in fp32, on a gloo
    world on the CPU in float64. Returns the gathered positions and forces
    (rank 0), the energy, the flags, the launch counts, the halo and ms per
    step."""
    import time

    from mtp_tpu_torch.kernels import main_path_kernels, reset_counts

    comm = Comm((2, 2))
    cuda = comm.transport == "nccl"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dtype = torch.float32 if cuda else F64
    model = MTPModel.from_data(make_mtp(level, species_count=1, seed=0), device=dev, dtype=dtype)
    w_cut = model.cutoff + 0.6
    part = partition_bricks(box["pos"], box["vel"], box["types"], box["masses"], box["cell"],
                            comm.grid, cutoff=w_cut)
    hc = halo_capacities(part, box["cell"], comm.grid, w_cut)
    sim = ShardedSimulation(model, comm, capacity=part.capacity, max_neighbors=64,
                            grid=grid_shape(box["cell"], w_cut), skin=0.6, steps_per_rebuild=30,
                            halo_capacity=hc)
    ss = ShardedState.from_partition(part, box["cell"], rank, dtype=dtype, device=dev)
    sim.run_async(ss, 2)  # warm-up, discarded
    reset_counts()
    comm.barrier()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, flags = sim.run_async(ss, n_steps)
    flags = bool(flags.any())  # waits for the device
    wall = time.perf_counter() - t0
    launches = {k.name: (k.launches, k.plain_calls) for k in main_path_kernels()}
    pos, frc = out.gather_all([out.positions, out.forces], comm, root=0)
    return dict(positions=pos, forces=frc, energy=float(out.potential_energy), flags=flags,
                launches=launches, halo=hc, rows=sim.NE, capacity=part.capacity,
                ms_per_step=wall / n_steps * 1e3, transport=comm.transport)


# ------------------------------- narrow boxes: the row-gather path's API


def rowgather_cases(rank, world, box, boxy, states, inverse_active_set):
    """The 4-rank cases of ``test_torch_parallel_rowgather.py`` on the JAX
    tests' ``wide_system`` (fcc (16, 3, 3): 2 bins across y and z), each
    from a JAX ShardedState carried over by ``sharded_state_from_jax``:
    forces on 4 slabs and, on a 2-rank subgroup, on 2; NVE and NVT blocks
    and grades along x and y on 4; the standalone monitor from a list width
    that overflows, beside the window engine's grade."""
    from types import SimpleNamespace

    from mtp_tpu_torch.al.driver import ShardedExtrapolationMonitor
    from mtp_tpu_torch.parallel.sharded_md import (
        compute_sharded_forces,
        make_sharded_grades,
        make_sharded_md_block,
    )
    from mtp_tpu_torch.utils.convert import sharded_state_from_jax

    def carried(name, comm, axes=(0,)):
        return sharded_state_from_jax(SimpleNamespace(**states[name]), comm.rank, comm.world,
                                      device="cpu", axes=axes)

    pair = dist.new_group([0, 1])  # every rank takes part in making a group
    comms = {4: Comm()}
    if rank < 2:
        comms[2] = Comm(group=pair)
    model = level8()
    cell = box["cell"]
    res = {}
    for nd, comm in comms.items():
        ss = carried(f"forces{nd}", comm)
        fn = compute_sharded_forces(model, comm, capacity=ss.positions.shape[0],
                                    max_neighbors=48, grid=grid_shape(cell, model.cutoff))
        out, flags = fn(ss)
        res[f"forces{nd}"] = dict(
            flags=bool(flags.any()), forces=out.gather(out.forces, comm),
            energy=float(out.potential_energy), virial=out.virial.numpy(), grid=fn.sim.grid,
        )
    comm = comms[4]
    for ens, kw in (("nve", {}), ("nvt", dict(temperature=300.0, tdamp=0.05))):
        ss = carried("md", comm)
        block = make_sharded_md_block(
            model, comm, capacity=ss.positions.shape[0], max_neighbors=64,
            grid=grid_shape(cell, model.cutoff + 0.6), skin=0.6, n_steps=10, dt=0.001,
            ensemble=ens, **kw,
        )
        out, flags = block(ss)
        pos, vel = out.gather_all([out.positions, out.velocities], comm)
        res[ens] = dict(flags=bool(flags.any()), positions=pos, velocities=vel,
                        energy=float(out.potential_energy), thermo=out.thermo.numpy())
    m = level8(inverse_active_set)
    for name, axis, b in (("grades_x", 0, box), ("grades_y", 1, boxy)):
        ss = carried(name, comm, axes=(axis,))
        fn = make_sharded_grades(m, comm, capacity=ss.positions.shape[0], max_neighbors=48,
                                 grid=grid_shape(b["cell"], m.cutoff), slab_axis=axis)
        g, grades, flags = fn(ss)
        res[name] = dict(max_grade=float(g), grades=ss.gather(grades, comm), flags=bool(flags))
    # the standalone engine from J = 16 (about 42 neighbors in the cutoff),
    # and the window engine's grade pass at the same positions
    ss = carried("grades_x", comm)
    cap = ss.positions.shape[0]
    mon = ShardedExtrapolationMonitor(m, comm, capacity=cap, grid=grid_shape(cell, m.cutoff),
                                      max_neighbors=16, halo_capacity=(48,))
    g = float(mon.evaluate(ss))
    sim = ShardedSimulation(m, comm, capacity=cap, max_neighbors=64,
                            grid=grid_shape(cell, m.cutoff + SKIN), skin=SKIN)
    st, ctx, f4 = sim.rebuild(ss)
    win = sim.grade_eval(st, ctx)
    res["standalone"] = dict(
        max_grade=g, grades=mon.nbh_grades, max_neighbors=mon.max_neighbors,
        halo_capacity=mon.halo_capacity, window_flags=bool(torch.stack(list(f4)).any()),
        window_max_grade=float(win["max_grade"]), window_grades=st.gather(win["grades"], comm),
    )
    return res


def narrow_run(rank, world, box, blocks, n_steps, level=16):
    """NVE blocks of the row-gather API (``make_sharded_md_block``) on
    slabs along x, one NCCL rank per card in fp32 (on a gloo world: the
    CPU, float64). Returns the gathered positions and forces (rank 0), the
    energy, the flags, the launch counts and ms per step."""
    import time

    from mtp_tpu_torch.kernels import main_path_kernels, reset_counts
    from mtp_tpu_torch.parallel.sharded_md import make_sharded_md_block

    comm = Comm()
    cuda = comm.transport == "nccl"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dtype = torch.float32 if cuda else F64
    model = MTPModel.from_data(make_mtp(level, species_count=1, seed=0), device=dev, dtype=dtype)
    w_cut = model.cutoff + 0.6
    part = partition_slabs(box["pos"], box["vel"], box["types"], box["masses"], box["cell"],
                           world, cutoff=w_cut)
    hc = halo_capacities(part, box["cell"], comm.grid, w_cut)
    block = make_sharded_md_block(model, comm, capacity=part.capacity, max_neighbors=64,
                                  grid=grid_shape(box["cell"], w_cut), skin=0.6,
                                  n_steps=n_steps, halo_capacity=hc)
    ss = ShardedState.from_partition(part, box["cell"], rank, dtype=dtype, device=dev)
    block(ss)  # warm-up, discarded
    reset_counts()
    comm.barrier()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, flags = ss, []
    for _ in range(blocks):
        out, f = block(out)
        flags.append(f.any())
    flags = bool(torch.stack(flags).any())  # waits for the device
    wall = time.perf_counter() - t0
    launches = {k.name: (k.launches, k.plain_calls) for k in main_path_kernels()}
    pos, frc = out.gather_all([out.positions, out.forces], comm, root=0)
    return dict(positions=pos, forces=frc, energy=float(out.potential_energy), flags=flags,
                launches=launches, halo=hc, grid=block.sim.grid, capacity=part.capacity,
                ms_per_step=wall / (blocks * n_steps) * 1e3, transport=comm.transport)
