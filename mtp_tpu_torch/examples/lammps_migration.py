"""The reference README's example LAMMPS script, translated line by line
(port of ``examples/lammps_migration.py``).

The reference ships one smoke input (README.md:124-147): a bcc potassium
box, `velocity create`, `fix nve`, `run 100`. This is the same workflow
through the port; each LAMMPS command is quoted above its equivalent,
including the `mtp/extrapolation <file> <out.cfg> <select> <break>` variant
and a `read_data`/`write_data` round trip.

Run:  python -m mtp_tpu_torch.examples.lammps_migration [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from mtp_tpu_torch.al.driver import (
    BreakThresholdExceeded,
    ExtrapolationMonitor,
    run_with_extrapolation,
)
from mtp_tpu_torch.al.grades import candidate_vectors
from mtp_tpu_torch.al.maxvol import build_mvs
from mtp_tpu_torch.examples import md_dtype, output_dir
from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.io.lammps_data import read_lammps_data, write_lammps_data
from mtp_tpu_torch.io.mtp_file import save_mtp
from mtp_tpu_torch.md.output import ThermoLogger
from mtp_tpu_torch.md.simulation import Simulation, make_lattice
from mtp_tpu_torch.md.state import init_state, temperature_of, thermalize
from mtp_tpu_torch.models.mtp import MTPModel
from mtp_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce, grid_shape
from mtp_tpu_torch.utils.device import resolve_device

DT = 0.001  # `units metal`: ps, A, eV (the framework's native units)


def main(*, reps=(3, 3, 3), n_steps: int = 100, al_steps: int = 50, device="cuda",
         out_dir=None) -> dict:
    dev = resolve_device(device)
    out = output_dir("lammps_migration", out_dir)
    dt_md = md_dtype(dev)

    # -- the reference needs an MLIP-3-trained potential file; we mint a
    #    potassium-shaped one (bcc a=5.28 -> first neighbor 4.57 A) so the
    #    example is self-contained. A real .mtp from MLIP-3 loads the same way.
    mtp_path = out / "potassium_demo.mtp"
    mdata = make_mtp(8, species_count=1, seed=0, min_dist=2.4, max_dist=6.0, r0=4.57,
                     well_depth=0.05)
    save_mtp(str(mtp_path), mdata)

    # lattice         bcc 5.28
    # region          box block 0 3 0 3 0 3 units lattice
    # create_box      1 box
    # create_atoms    1 region box
    pos, types, cell = make_lattice("bcc", 5.28, reps)

    # mass 1 39.0983
    masses = np.full(len(pos), 39.0983)

    # pair_style mtp path/to/mtp/file        (mtp/kk: the same engine, the card's kernels)
    # pair_coeff * *                         (not required -- nor here)
    model = MTPModel.load(str(mtp_path), device=dev, dtype=dt_md)
    sim = Simulation(model, max_neighbors=40, skin=0.6, steps_per_rebuild=10)

    # run 0  (LAMMPS computes initial forces/energy)
    state = init_state(pos, types, masses, cell, dtype=dt_md, device=dev)
    nl = sim.rebuild(state, grid=grid_shape(cell, model.cutoff + sim.skin), max_neighbors=40)
    state = sim.refresh_forces(state, nl)
    pe0 = float(state.potential_energy)
    print(f"run 0: PE = {pe0:.6f} eV")
    assert math.isfinite(pe0)

    # velocity all create 200.0 12345 mom yes rot yes
    state = thermalize(torch.Generator(device=dev).manual_seed(12345), state, 200.0)

    # fix 1 all nve
    # thermo 10
    # run 100
    thermo = ThermoLogger(columns=("step", "temp", "pe", "etotal"), every=10)
    state, _ = sim.run(state, n_steps, ensemble="nve", dt=DT, observer=thermo)
    temp = float(temperature_of(state))
    print(f"after {n_steps} NVE steps: T = {temp:.1f} K")
    assert math.isfinite(temp) and temp > 0

    # write_data box.data  /  read_data box.data (migrate existing LAMMPS boxes)
    data_path = out / "potassium.data"
    write_lammps_data(str(data_path), state.positions.cpu().numpy(), types, masses, cell,
                      velocities=state.velocities.cpu().numpy())
    d = read_lammps_data(str(data_path))
    print(f"data-file round trip: {len(d.positions)} atoms, {d.type_masses[0]:.4f} amu")
    assert len(d.positions) == len(pos) and abs(d.type_masses[0] - 39.0983) < 1e-9

    # pair_style mtp/extrapolation path/to/mtp ./pre.cfg 10 10
    #   (select_threshold=10, break_threshold=10; grades need an MVS selection
    #    state -- MLIP-3 ships it in the .mtp trailer, here MaxVol builds it
    #    from float64 candidate vectors)
    rng = np.random.default_rng(0)
    m64 = MTPModel.from_data(mdata, device=dev, dtype=torch.float64)
    c64 = torch.as_tensor(cell, dtype=torch.float64, device=dev)
    train_pool = []
    for _ in range(8):
        p = torch.as_tensor(pos + rng.normal(0, 0.15, pos.shape), dtype=torch.float64, device=dev)
        nlb = build_neighbor_list_bruteforce(p, c64, m64.cutoff, max_neighbors=40)
        b, _ = candidate_vectors(m64, p, torch.as_tensor(types, device=dev), nlb.idx, c64)
        train_pool.append(b.cpu().numpy())
    mdata.mvs = build_mvs(np.concatenate(train_pool))
    save_mtp(str(mtp_path), mdata)
    model_al = MTPModel.load(str(mtp_path), device=dev, dtype=dt_md)

    sim_al = Simulation(model_al, max_neighbors=40, skin=0.6, steps_per_rebuild=10)
    cfg_path = out / "pre.cfg"
    monitor = ExtrapolationMonitor(model_al, select_threshold=2.0, break_threshold=10.0,
                                   output_path=str(cfg_path), max_neighbors=40)
    # fix pair 10 ... extrapolation 1  +  thermo_style custom step c_max_grade[1]
    broke = False
    try:
        run_with_extrapolation(sim_al, monitor, state, al_steps, al_every=10, ensemble="nve",
                               dt=DT)
        print(f"AL run: final max grade {float(monitor.max_grade):.3f}")
    except BreakThresholdExceeded as e:
        # LAMMPS `fix halt` analog: stream flushed before the break
        broke = True
        print(f"break threshold hit: {e}")
    finally:
        monitor.close()
    n_sel = sum(1 for line in open(cfg_path) if line.startswith("BEGIN_CFG"))
    print(f"{n_sel} preselected configuration(s) -> {cfg_path}")
    return dict(pe0=pe0, temperature=temp, thermo=thermo.history, n_selected=n_sel,
                max_grade=monitor.max_grade, broke=broke)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
