"""Multi-device MD with the full single-device output surface (port of
``examples/multichip_md.py``).

LAMMPS's thermo/dump/AL plumbing is rank-transparent (it gathers per-atom
data and reduces scalars behind the scenes). This example is the port's
equivalent, one process per rank joined through ``torch.distributed``
(:class:`~mtp_tpu_torch.parallel.comm.Comm`):

 1. partition an fcc box into slabs over `n_ranks` ranks,
 2. run NVT blocks on the sharded window engine (``ShardedSimulation.run``
    with automatic overflow/staleness recovery),
 3. log thermo rows and dump extended-XYZ frames through the id-ordered
    gather (``gather_md_state``: every single-device writer works as is),
 4. monitor extrapolation grades in the block context
    (``run_sharded_with_extrapolation``), and
 5. checkpoint the gathered state.

Ranks: on the CPU, gloo ranks; on the card, one NCCL rank per card when
there are `n_ranks` cards, else every rank on card 0 over gloo with its
messages staged through host memory (``transport="gloo-staged"``).

The thermo check holds the device-side temperature and pressure to the
gathered state's, at the JAX example's limits (1e-6 K, 1e-3 bar) in float64
(the CPU). In fp32 (the card) the two sides sum the kinetic energy in
different orders, and the limit is 16 ulps of the value; the example prints
the gaps in ulps.

Run:  python -m mtp_tpu_torch.examples.multichip_md [--device cpu] [--ranks 8]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

SKIN = 0.3
TIMEOUT_S = 900.0  # each rank process's limit


def _rank(rank, world, *, reps, nvt_steps, al_steps, device, transport, dtype, out_dir):
    """One rank's share of the example (every rank makes the same calls)."""
    from mtp_tpu_torch.al.driver import ShardedExtrapolationMonitor, run_sharded_with_extrapolation
    from mtp_tpu_torch.al.grades import candidate_vectors
    from mtp_tpu_torch.al.maxvol import build_mvs
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.md.output import ThermoLogger, XYZDumpWriter, save_checkpoint
    from mtp_tpu_torch.md.simulation import make_lattice
    from mtp_tpu_torch.md.state import init_state, thermalize
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce, grid_shape
    from mtp_tpu_torch.parallel.comm import Comm
    from mtp_tpu_torch.parallel.domain import partition_slabs
    from mtp_tpu_torch.parallel.observables import (
        gather_md_state,
        sharded_pressure,
        sharded_temperature,
    )
    from mtp_tpu_torch.parallel.sharded_md import ShardedState
    from mtp_tpu_torch.parallel.sharded_window import ShardedSimulation

    comm = Comm(transport=transport)
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank if comm.transport == "nccl" else 0)
    root = rank == 0

    # -- model with an MVS selection state (so grades are available) --------
    m = make_mtp(8, species_count=1, seed=0)
    model0 = MTPModel.from_data(m, device=dev, dtype=torch.float64)
    pos, types, cell = make_lattice("fcc", 4.0, reps)
    n = len(pos)
    masses = np.full(n, 58.693)
    rng = np.random.default_rng(0)
    c64 = torch.as_tensor(cell, dtype=torch.float64, device=dev)
    rows = []
    for s in (0.02, 0.08):
        p = torch.as_tensor(pos + rng.normal(scale=s, size=pos.shape), dtype=torch.float64,
                            device=dev)
        nl = build_neighbor_list_bruteforce(p, c64, model0.cutoff, max_neighbors=64)
        b, _ = candidate_vectors(model0, p, torch.as_tensor(types, device=dev), nl.idx, c64)
        rows.append(b.cpu().numpy())
    m.mvs = build_mvs(np.concatenate(rows, 0), mode="neighborhood")
    model = MTPModel.from_data(m, device=dev, dtype=dtype)

    # -- shard over the ranks (the same velocities on every rank) -----------
    vel = thermalize(torch.Generator().manual_seed(0),
                     init_state(pos, types, masses, cell, dtype=torch.float64, device="cpu"),
                     300.0).velocities.numpy()
    part = partition_slabs(pos, vel, types, masses, cell, world, cutoff=model.cutoff + SKIN,
                           capacity=int(np.ceil((n / world * 1.4 + 16) / 8) * 8))
    sstate = ShardedState.from_partition(part, cell, rank, dtype=dtype, device=dev)
    sim = ShardedSimulation(model, comm, capacity=part.capacity, max_neighbors=64,
                            grid=grid_shape(cell, model.cutoff + SKIN), skin=SKIN,
                            steps_per_rebuild=5, compute_virial=True)

    # -- NVT with thermo + dump through the id-ordered gather ---------------
    thermo = ThermoLogger(columns=("step", "temp", "pe", "etotal", "press"),
                          stream=sys.stdout if root else None)
    dump = XYZDumpWriter(str(out_dir / "multichip_traj.xyz"), species=("Ni",)) if root else None
    done = [0]
    gaps = []

    def observer(s):
        done[0] += sim.steps_per_rebuild
        # device-side scalars (no gather): cheap enough for every block
        t_dev = float(sharded_temperature(s, comm))
        p_dev = float(sharded_pressure(s, comm))
        # the full single-device output surface through the id-ordered gather
        gst = gather_md_state(s, comm, step=done[0], root=0)
        if root:
            thermo(gst)
            dump.write(gst, forces=True)
            gaps.append((abs(t_dev - thermo.history[-1]["temp"]),
                         abs(p_dev - thermo.history[-1]["press"])))

    sstate, flags = sim.run(sstate, nvt_steps, ensemble="nvt", dt=0.001, temperature=300.0,
                            tdamp=0.1, observer=observer)
    assert not bool(torch.stack(list(flags)).any())
    if root:
        dump.close()
        print(f"dumped {len(thermo.history)} frames -> {out_dir / 'multichip_traj.xyz'}")
        # the module docstring: the JAX example's limits in float64, 16 ulps
        # of the value in fp32
        ulp_t = torch.finfo(dtype).eps * max(abs(r["temp"]) for r in thermo.history)
        ulp_p = torch.finfo(dtype).eps * max(abs(r["press"]) for r in thermo.history)
        dt_max, dp_max = max(g[0] for g in gaps), max(g[1] for g in gaps)
        print(f"sharded vs gathered thermo: max|dT| = {dt_max:.3e} K ({dt_max / ulp_t:.2f} ulps), "
              f"max|dP| = {dp_max:.3e} bar ({dp_max / ulp_p:.2f} ulps)")
        if dtype == torch.float64:
            assert dt_max < 1e-6 and dp_max < 1e-3, gaps
        else:
            assert dt_max < 16 * ulp_t and dp_max < 16 * ulp_p, gaps

    # -- grades in the block context (the window engine) --------------------
    mon = ShardedExtrapolationMonitor(model, comm)
    sstate = run_sharded_with_extrapolation(sim, mon, sstate, al_steps, al_every=5,
                                            ensemble="nvt", dt=0.001, temperature=300.0,
                                            tdamp=0.1)
    grades = mon.nbh_grades  # a collective
    if root:
        print(f"max extrapolation grade: {mon.max_grade:.4f} (per-atom grades: {len(grades)})")
        assert len(grades) == n and mon.max_grade > 0

    # -- checkpoint the gathered state ----------------------------------------
    gst = gather_md_state(sstate, comm, step=nvt_steps + al_steps, root=0)
    if root:
        save_checkpoint(str(out_dir / "multichip_ckpt.npz"), gst)
        print(f"checkpoint -> {out_dir / 'multichip_ckpt.npz'}")
        print("OK")
    return dict(rank=rank, transport=comm.transport, max_grade=mon.max_grade,
                frames=len(thermo.history) if root else None,
                energy=float(sstate.potential_energy))


def main(*, n_ranks: int = 8, reps=(16, 4, 4), nvt_steps: int = 15, al_steps: int = 10,
         device="cuda", out_dir=None) -> list:
    """Runs the example on `n_ranks` rank processes; returns every rank's
    summary."""
    from mtp_tpu_torch.examples import md_dtype, output_dir
    from mtp_tpu_torch.parallel.launch import spawn
    from mtp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        backend, transport = "gloo", None
    elif torch.cuda.device_count() >= n_ranks:
        backend, transport = "nccl", None
    else:
        backend, transport = "gloo", "gloo-staged"
    # one intra-op thread per CPU rank: the ranks share the host's cores
    return spawn("mtp_tpu_torch.examples.multichip_md:_rank", n_ranks, backend=backend,
                 timeout=TIMEOUT_S, threads=1 if dev.type == "cpu" else None, reps=tuple(reps),
                 nvt_steps=nvt_steps, al_steps=al_steps,
                 device=dev.type, transport=transport, dtype=md_dtype(dev),
                 out_dir=output_dir("multichip_md", out_dir))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=8)
    a = ap.parse_args()
    main(n_ranks=a.ranks, device=a.device)
