"""Validating production fp32 MD against a float64 re-evaluation (port of
``examples/accuracy_validation.py``).

The reference computes everything in f64 (pair_mtp.cpp throughout); users
coming from it spot-check forces and energies against MLIP-3. The JAX
package re-evaluates on its df32 (double-float) backend because the TPU has
no f64; the H100 has native f64, so the port re-evaluates snapshots on its
float64 plain path: the same potential, a neighbor list at the same
positions and cutoff, IEEE double arithmetic.

Run:  python -m mtp_tpu_torch.examples.accuracy_validation [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mtp_tpu_torch.examples import output_dir
from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.io.mtp_file import save_mtp
from mtp_tpu_torch.md.simulation import Simulation, make_lattice
from mtp_tpu_torch.md.state import init_state, thermalize
from mtp_tpu_torch.models.mtp import MTPModel, mtp_energy_forces
from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape
from mtp_tpu_torch.utils.device import resolve_device

SKIN = 0.5


def main(*, reps=(5, 5, 5), n_steps: int = 100, level: int = 12, device="cuda",
         out_dir=None) -> dict:
    dev = resolve_device(device)
    # mint a level-12 potential (or MTPModel.load("your.mtp"))
    path = output_dir("accuracy_validation", out_dir) / "val.mtp"
    save_mtp(str(path), make_mtp(level, species_count=1, seed=0))
    model = MTPModel.load(str(path), device=dev, dtype=torch.float32)

    pos, types, cell = make_lattice("fcc", 4.0, reps)
    n = len(pos)
    state = thermalize(
        torch.Generator(device=dev).manual_seed(0),
        init_state(pos, types, np.full(n, 58.693), cell, dtype=torch.float32, device=dev),
        300.0,
    )

    # production MD on the fast path (fp32, the kernels on the card)
    sim = Simulation(model, max_neighbors=64, skin=SKIN, steps_per_rebuild=10)
    state, _ = sim.run(state, n_steps, ensemble="nve", dt=0.001)

    # the evolved snapshot: fp32 forces on a fresh list, and the float64
    # plain path's at the same positions (widened exactly) on its own list
    grid = grid_shape(state.cell.cpu().numpy(), model.cutoff + SKIN)
    nl_p = sim.rebuild(state, grid=grid, max_neighbors=64)
    f_prod = sim.refresh_forces(state, nl_p).forces.double()
    model64 = MTPModel.load(str(path), device=dev, dtype=torch.float64)
    p64, c64 = state.positions.double(), state.cell.double()
    nl_a = build_neighbor_list(p64, c64, model.cutoff + SKIN, max_neighbors=64, grid=grid)
    assert not bool(nl_p.overflow) and not bool(nl_a.overflow)
    out_acc = mtp_energy_forces(model64, p64, state.types, nl_a.idx, c64, nl_a.mirror)
    f_acc = out_acc["forces"]

    df = (f_prod - f_acc).abs()
    scale = float(torch.sqrt((f_acc**2).sum(dim=1)).mean())
    dmax = float(df.max())
    print(f"production-vs-float64 after {n_steps} steps ({n} atoms):")
    print(f"  max |dF|  = {dmax:.3e} eV/A   (RMS force scale {scale:.3f})")
    print(f"  RMS dF    = {float(torch.sqrt((df**2).mean())):.3e} eV/A")
    print(f"  PE (f64)  = {float(out_acc['energy']):.6f} eV")
    # the fp32 fast path stays within its documented envelope (~1e-4
    # relative max at bench scale, PARITY.md §2)
    assert dmax < 5e-4 * max(scale, 1.0)
    print("OK: production forces within the documented fp32 envelope")
    return dict(atoms=n, max_df=dmax, rms_df=float(torch.sqrt((df**2).mean())),
                force_scale=scale, energy64=float(out_acc["energy"]))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
