"""Velocity-Verlet NVE (port of the NVE part of ``mtp_tpu/md/integrators.py``).

The force evaluation is injected as ``force_fn(positions, types, cell) ->
(forces, potential_energy, virial)``, so the integrator stays independent of
the potential and of neighbor-list management.
"""

from __future__ import annotations

import dataclasses

from mtp_tpu_torch.md.state import MDState
from mtp_tpu_torch.utils import units


def _half_kick(state: MDState, dt):
    dv = (0.5 * dt * units.FTM2A) * state.forces / state.masses[:, None]
    return dataclasses.replace(state, velocities=state.velocities + dv)


def _drift(state: MDState, dt):
    return dataclasses.replace(state, positions=state.positions + dt * state.velocities)


def _with_forces(state: MDState, force_fn) -> MDState:
    f, pe, vir = force_fn(state.positions, state.types, state.cell)
    return dataclasses.replace(state, forces=f, potential_energy=pe, virial=vir)


def nve_step(state: MDState, force_fn, dt: float) -> MDState:
    """One velocity-Verlet step."""
    state = _half_kick(state, dt)
    state = _drift(state, dt)
    state = _with_forces(state, force_fn)
    state = _half_kick(state, dt)
    return dataclasses.replace(state, step=state.step + 1)
