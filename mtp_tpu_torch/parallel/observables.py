"""Observables of sharded runs: the single-device output surface (port of
``mtp_tpu/parallel/observables.py``).

Scalar observables (KE, T, P) reduce over the ranks, padding slots masked
by ``real``. :func:`gather_md_state` collects the slots of every rank into
a plain :class:`~mtp_tpu_torch.md.state.MDState` in original atom order (the
reference's MPI gather funnel, pair_mtp_extrapolation.cpp:415-474), so every
single-device writer (ThermoLogger, XYZDumpWriter, save_checkpoint) works on
multi-device runs unchanged. All of these are collectives: every rank calls
them.
"""

from __future__ import annotations

import torch

from mtp_tpu_torch.md.state import MDState, cell_volume
from mtp_tpu_torch.parallel.sharded_md import ShardedState
from mtp_tpu_torch.utils import units


def sharded_kinetic_energy(sstate: ShardedState, comm):
    """Total kinetic energy [eV] (0-d tensor, the same on every rank)."""
    v = sstate.velocities
    mvv = torch.where(sstate.real[:, None], sstate.masses[:, None] * v * v, 0.0)
    return 0.5 * units.MVV2E * comm.sum(torch.sum(mvv))


def sharded_temperature(sstate: ShardedState, comm):
    """Instantaneous temperature [K] (3N degrees of freedom)."""
    return 2.0 * sharded_kinetic_energy(sstate, comm) / (3.0 * sstate.n_atoms * units.KB)


def sharded_pressure(sstate: ShardedState, comm):
    """Scalar pressure [bar] from the replicated virial and the summed KE."""
    w_tr = sstate.virial[0] + sstate.virial[1] + sstate.virial[2]
    return ((2.0 * sharded_kinetic_energy(sstate, comm) + w_tr)
            / (3.0 * cell_volume(sstate.cell)) * units.EVA3_TO_BAR)


def gather_md_state(sstate: ShardedState, comm, step: int = 0, *, root: int | None = None):
    """An :class:`MDState` in original atom order, on the state's device,
    gathered by ids (valid after migration); with `root`, only that rank
    gets it (others None)."""
    arrs = sstate.gather_all(
        [sstate.positions, sstate.velocities, sstate.forces, sstate.masses, sstate.types],
        comm, root=root,
    )
    if arrs[0] is None:
        return None
    dev, dtype = sstate.positions.device, sstate.positions.dtype
    pos, vel, frc, mas, typ = (torch.as_tensor(a, device=dev) for a in arrs)
    return MDState(
        positions=pos, velocities=vel, forces=frc, masses=mas, types=typ.to(torch.int32),
        cell=sstate.cell.clone(), potential_energy=sstate.potential_energy.to(dtype),
        virial=sstate.virial.to(dtype), step=torch.as_tensor(step, device=dev),
    )
