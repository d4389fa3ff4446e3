"""MD state container and observables (port of ``mtp_tpu/md/state.py``).

Units: LAMMPS ``metal`` (A, eV, ps, amu, K, bar).
"""

from __future__ import annotations

import dataclasses

import torch

from mtp_tpu_torch.utils import units
from mtp_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class MDState:
    positions: torch.Tensor  # (N, 3) A
    velocities: torch.Tensor  # (N, 3) A/ps
    forces: torch.Tensor  # (N, 3) eV/A
    masses: torch.Tensor  # (N,) amu
    types: torch.Tensor  # (N,) int32
    cell: torch.Tensor  # (3, 3) row-vector cell
    potential_energy: torch.Tensor  # () eV
    virial: torch.Tensor  # (6,) eV (Voigt xx,yy,zz,xy,xz,yz)
    step: torch.Tensor  # () int64

    @property
    def n_atoms(self) -> int:
        return self.positions.shape[0]


def init_state(
    positions, types, masses, cell, *, velocities=None, dtype=torch.float32, device="cuda"
):
    device = resolve_device(device)

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    positions = f(positions)
    n = positions.shape[0]
    return MDState(
        positions=positions,
        velocities=torch.zeros((n, 3), dtype=dtype, device=device)
        if velocities is None else f(velocities),
        forces=torch.zeros((n, 3), dtype=dtype, device=device),
        masses=f(masses),
        types=torch.as_tensor(types, dtype=torch.int32, device=device),
        cell=f(cell),
        potential_energy=torch.zeros((), dtype=dtype, device=device),
        virial=torch.zeros((6,), dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int64, device=device),
    )


def thermalize(generator: torch.Generator, state: MDState, temperature: float) -> MDState:
    """Draw Maxwell-Boltzmann velocities and remove net momentum (LAMMPS
    ``velocity all create T seed mom yes``). `generator` lives on the
    state's device; its numbers differ from ``jax.random``'s."""
    n = state.n_atoms
    sigma = torch.sqrt(units.KB * temperature / (state.masses * units.MVV2E))
    v = torch.randn(
        (n, 3), generator=generator, dtype=state.velocities.dtype,
        device=state.velocities.device,
    ) * sigma[:, None]
    p = torch.sum(v * state.masses[:, None], dim=0) / torch.sum(state.masses)
    v = v - p[None, :]
    # rescale to the exact target temperature
    t_now = temperature_of(dataclasses.replace(state, velocities=v))
    v = v * torch.sqrt(temperature / torch.clamp(t_now, min=1e-30))
    return dataclasses.replace(state, velocities=v)


def kinetic_energy(state: MDState):
    """KE in eV."""
    return 0.5 * units.MVV2E * torch.sum(state.masses[:, None] * state.velocities**2)


def temperature_of(state: MDState):
    """Instantaneous temperature [K] (3N degrees of freedom)."""
    return 2.0 * kinetic_energy(state) / (3.0 * state.n_atoms * units.KB)


def volume_of(state: MDState):
    """Cell volume |det(cell)| [A^3] (:func:`cell_volume`)."""
    return cell_volume(state.cell)


def cell_volume(c):
    """|det(c)| [A^3] of a (3, 3) cell, as the closed-form triple product
    ``a . (b x c)`` of the cell rows: elementwise operations, no LAPACK call."""
    cross = torch.stack([
        c[1, 1] * c[2, 2] - c[1, 2] * c[2, 1],
        c[1, 2] * c[2, 0] - c[1, 0] * c[2, 2],
        c[1, 0] * c[2, 1] - c[1, 1] * c[2, 0],
    ])
    return torch.abs(torch.sum(c[0] * cross))


def pressure_of(state: MDState):
    """Instantaneous isotropic pressure [bar]: (2 KE + trace(W)) / (3 V)."""
    v = volume_of(state)
    w = state.virial[0] + state.virial[1] + state.virial[2]
    p_eva3 = (2.0 * kinetic_energy(state) + w) / (3.0 * v)
    return p_eva3 * units.EVA3_TO_BAR
