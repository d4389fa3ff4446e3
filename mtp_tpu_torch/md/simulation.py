"""Simulation driver: the MTP model, the neighbor engine and the NVE
integrator in a block loop (port of ``mtp_tpu/md/simulation.py``'s
``run_async`` path).

Each block rebuilds the bin-sorted neighbor list once, moves the state into
sorted space, runs ``steps_per_rebuild`` velocity-Verlet steps with force-only
evaluations (K1, K2, K3 on the card), checks Verlet staleness with the top-2
displacement rule, evaluates the energy once (K4) and moves back. The loop is
eager Python over kernel launches and plain torch operations; after reading
the cell once at the start, the host does not wait for the device until the
caller reads the returned flags.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mtp_tpu_torch.md import integrators as itg
from mtp_tpu_torch.md.state import MDState
from mtp_tpu_torch.models.mtp import (
    MTPModel,
    mtp_energy_forces_window,
    mtp_energy_window,
    window_constants,
)
from mtp_tpu_torch.ops.neighbors import (
    SortedNeighborList,
    build_sorted_neighbor_list,
    check_cell,
    grid_shape,
)
from mtp_tpu_torch.ops.window_disp import cell_product, inverse_cell


@dataclasses.dataclass
class RunFlags:
    """Failure flags of an async run (device bool scalars).

    `overflow`: a neighbor or bin capacity, or the bin-grid geometry, was
    exceeded: grow `max_neighbors`. `stale`: an atom outran the Verlet skin
    within a block: shorten `steps_per_rebuild`. ``bool(flags)`` is the OR.
    """

    overflow: torch.Tensor
    stale: torch.Tensor

    def __bool__(self) -> bool:
        return bool(self.overflow) or bool(self.stale)


@dataclasses.dataclass(eq=False)
class Simulation:
    """Host-side controller for single-device NVE MD.

    Args:
      model: the MTP model (its device and dtype are the run's).
      max_neighbors: neighbor width J.
      skin: Verlet skin [A]; lists are built at cutoff + skin.
      steps_per_rebuild: steps per neighbor rebuild.
      compute_virial: tally the virial every step (off for pure NVE runs).
    """

    model: MTPModel
    max_neighbors: int = 64
    skin: float = 0.5
    steps_per_rebuild: int = 10
    compute_virial: bool = True

    def force_fn_window(
        self, swl: SortedNeighborList, types, *,
        sorted_io: bool = False, compute_energy: bool = True,
    ):
        """Force closure over a frozen list; rebuild constants are computed
        here, once. `types` is in user order. The closure's `energy_fn`
        evaluates the energy alone (K4)."""
        consts = window_constants(self.model, types, swl)

        def fn(positions, types_unused, cell):
            out = mtp_energy_forces_window(
                self.model, positions, cell, swl, compute_virial=self.compute_virial,
                sorted_io=sorted_io, compute_energy=compute_energy, **consts,
            )
            return out["forces"], out["energy"], out["virial"]

        def energy_fn(positions, cell):
            return mtp_energy_window(
                self.model, positions, cell, swl, sorted_io=sorted_io, **consts
            )

        fn.energy_fn = energy_fn
        return fn

    def rebuild(self, state: MDState, *, grid: tuple, max_neighbors: int):
        return build_sorted_neighbor_list(
            state.positions, state.cell, self.model.cutoff + self.skin,
            max_neighbors=max_neighbors, grid=grid,
        )

    def refresh_forces(self, state: MDState, nl: SortedNeighborList):
        return itg._with_forces(state, self.force_fn_window(nl, state.types))

    @staticmethod
    def _permute_state(state: MDState, perm):
        return dataclasses.replace(
            state,
            positions=state.positions[perm],
            velocities=state.velocities[perm],
            forces=state.forces[perm],
            masses=state.masses[perm],
            types=state.types[perm],
        )

    def _scan_with_nl(self, state, nl, *, n_steps, dt):
        """`n_steps` steps against a frozen list, integrating in SORTED space
        (one permute in and one out per block). Force-only steps; the energy
        (K4) runs once at the end of the block. Returns (state, stale) with
        `state` back in user order."""
        force_fn = self.force_fn_window(
            nl, state.types, sorted_io=True, compute_energy=False,
        )
        state = self._permute_state(state, nl.order)
        state, stale = self._scan_steps(
            state, force_fn, n_steps=n_steps, dt=dt,
            ref_positions=nl.reference_positions[nl.order],
            ref_cell=nl.reference_cell,
        )
        state = dataclasses.replace(
            state, potential_energy=force_fn.energy_fn(state.positions, state.cell)
        )
        return self._permute_state(state, nl.inv_order), stale

    def _scan_steps(self, state, force_fn, *, n_steps, dt, ref_positions, ref_cell):
        """NVE steps with the Verlet staleness check (LAMMPS ``neigh_modify
        check yes``), OR-accumulated into a device flag.

        Exact pair criterion: a missing pair (i, j) enters the cutoff only if
        d_i + d_j >= skin for DISTINCT atoms, so the bound is the sum of the
        two largest displacements, not twice the largest. The cell is
        constant under NVE, so the cell-shrink term of the JAX driver is
        evaluated once per block (it is 0 unless the cell changed)."""
        cut_skin = self.model.cutoff + self.skin
        inv_ref = inverse_cell(ref_cell)
        ref_widths = 1.0 / torch.linalg.vector_norm(inv_ref, dim=1)
        widths = 1.0 / torch.linalg.vector_norm(inverse_cell(state.cell), dim=1)
        s_min = torch.min(widths / ref_widths)
        shrink = torch.clamp(1.0 - s_min, min=0.0) * cut_skin
        scaled_ref = torch.stack(
            cell_product(cell_product(ref_positions.unbind(-1), inv_ref), state.cell), dim=-1
        )
        rows = torch.arange(state.n_atoms, device=state.positions.device)
        stale = torch.zeros((), dtype=torch.bool, device=state.positions.device)
        for _ in range(n_steps):
            state = itg.nve_step(state, force_fn, dt)
            d = state.positions - scaled_ref
            d2 = torch.sum(d * d, dim=-1)
            m1 = torch.max(d2)
            m2 = torch.max(torch.where(rows == torch.argmax(d2), 0.0, d2))
            stale = stale | (torch.sqrt(m1) + torch.sqrt(m2) + shrink > self.skin)
        return state, stale

    def steps(self, state: MDState, aux, nl, *, n_steps: int = 10, dt: float = 0.001):
        """`n_steps` NVE steps with a frozen list. Returns (state, aux,
        stale); `aux` is passed through (NVE carries no integrator state)."""
        state, stale = self._scan_with_nl(state, nl, n_steps=n_steps, dt=dt)
        return state, aux, stale

    def run_async(
        self,
        state: MDState,
        n_steps: int,
        *,
        ensemble: str = "nve",
        dt: float = 0.001,
        aux=None,
        return_nl: bool = False,
        refresh: bool = True,
    ):
        """Throughput path: rebuilds and step blocks queued back to back,
        forces carried across blocks, no host sync until the caller reads
        the flags.

        Returns (state, aux, flags[, nl]): `flags` is a :class:`RunFlags` of
        device scalars. `refresh=False` trusts the incoming forces to be
        consistent with the positions.
        """
        if ensemble != "nve":
            raise ValueError(f"ensemble {ensemble!r} is not ported yet (only 'nve')")
        cell_h = state.cell.detach().cpu().numpy()
        cut_skin = self.model.cutoff + self.skin
        check_cell(cell_h, cut_skin)
        grid = grid_shape(cell_h, cut_skin)
        dev = state.positions.device
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        stale_any = torch.zeros((), dtype=torch.bool, device=dev)
        done = 0
        first = refresh
        nl = None
        while done < n_steps:
            k = min(self.steps_per_rebuild, n_steps - done)
            nl = self.rebuild(state, grid=grid, max_neighbors=self.max_neighbors)
            overflow = overflow | nl.overflow
            if first:
                state = self.refresh_forces(state, nl)
                first = False
            state, aux, stale = self.steps(state, aux, nl, n_steps=k, dt=dt)
            stale_any = stale_any | stale
            done += k
        flags = RunFlags(overflow=overflow, stale=stale_any)
        if return_nl:
            return state, aux, flags, nl
        return state, aux, flags


def make_lattice(kind: str, a: float, reps, *, type_pattern=(0,)):
    """Simple crystal builder (LAMMPS `lattice`/`create_atoms`).

    kind: 'sc' | 'bcc' | 'fcc'. `reps` = (nx, ny, nz) unit cells.
    Returns numpy float64 positions (N, 3), int32 types (N,), cell (3, 3).
    """
    basis = {
        "sc": [(0, 0, 0)],
        "bcc": [(0, 0, 0), (0.5, 0.5, 0.5)],
        "fcc": [(0, 0, 0), (0.5, 0.5, 0), (0.5, 0, 0.5), (0, 0.5, 0.5)],
    }[kind]
    nx, ny, nz = reps
    pts = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                for b in basis:
                    pts.append(((i + b[0]) * a, (j + b[1]) * a, (k + b[2]) * a))
    pos = np.asarray(pts, dtype=np.float64)
    types = np.array(
        [type_pattern[i % len(type_pattern)] for i in range(len(pos))], dtype=np.int32
    )
    cell = np.diag([nx * a, ny * a, nz * a]).astype(np.float64)
    return pos, types, cell
