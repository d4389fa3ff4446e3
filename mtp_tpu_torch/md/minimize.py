"""FIRE 2.0 energy minimization (port of ``mtp_tpu/md/minimize.py``): the
LAMMPS ``minimize`` + ``min_style fire`` workflow users run before MD, e.g.
to relax a read-in structure onto the potential's surface.

Each block is a :meth:`Simulation.block
<mtp_tpu_torch.md.simulation.Simulation.block>` with FIRE's iterations as
its scan: one neighbor rebuild, then FIRE iterations against the frozen
list in sorted space with force-only evaluations (K1, K2, K3 on the card),
the energy (K4) once at the block's end, and Verlet staleness checked every
iteration. A tripped block recovers through ``Simulation._recover``, as in
``Simulation.run``. The adaptive quantities (dt, alpha, the downhill
counter) are device scalars, so a block reads nothing back to the host.

Algorithm: FIRE 2.0 (Guenole et al., Comput. Mater. Sci. 175 (2020) 109584)
with semi-implicit Euler integration, the N_delay dt-growth gate, the
half-step position backtrack on uphill power, and a LAMMPS-style ``dmax``
cap on any single atom's per-iteration displacement (min_fire.cpp).

Convergence (LAMMPS ``minimize etol ftol maxiter``): ``ftol`` bounds the
max per-atom force magnitude [eV/A] (LAMMPS's ftol bounds the global force
2-norm; the per-atom max is the stricter, size-intensive criterion),
``etol`` the relative energy change across a block. 0 disables either.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from mtp_tpu_torch.md.state import MDState
from mtp_tpu_torch.ops.md_step import verlet_check
from mtp_tpu_torch.ops.neighbors import check_cell
from mtp_tpu_torch.utils import units


class FireAux(NamedTuple):
    """FIRE adaptive state carried across blocks (device scalars)."""

    dt: torch.Tensor  # current timestep [ps]
    alpha: torch.Tensor  # velocity-mixing fraction
    n_pos: torch.Tensor  # consecutive downhill-power iterations (int32)


def fire_init(dt0: float, alpha0: float, dtype=torch.float32, device="cuda") -> FireAux:
    return FireAux(
        dt=torch.full((), dt0, dtype=dtype, device=device),
        alpha=torch.full((), alpha0, dtype=dtype, device=device),
        n_pos=torch.zeros((), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class MinimizeResult:
    """Host-side outcome of :func:`fire_minimize`."""

    converged: bool
    iterations: int
    fmax: float  # max per-atom |F| [eV/A]
    potential_energy: float  # [eV]
    stop_reason: str  # "ftol" | "etol" | "maxiter"


def _fire_scan(
    state: MDState,
    aux: FireAux,
    force_fn,
    *,
    n_steps: int,
    ref_positions,
    ref_cell=None,
    skin: float,
    dt_max: float,
    dt_min: float,
    alpha0: float,
    n_delay: int,
    f_inc: float,
    f_dec: float,
    f_alpha: float,
    dmax: float,
):
    """`n_steps` FIRE iterations against a frozen neighbor list.

    The per-step scan :func:`fire_minimize` passes to ``Simulation.steps``.
    Incoming ``state.forces`` must be position-consistent. Returns (state,
    aux, stale): `stale` trips when the two largest displacements from the
    list's reference positions sum past the skin (the exact pair criterion;
    the cell is fixed during minimization, so `ref_cell` goes unused and
    there is no affine term).
    """
    eps = 1e-30
    masses = state.masses[:, None]
    pos, vel, f, pe, vir = (state.positions, state.velocities, state.forces,
                            state.potential_energy, state.virial)
    dt, alpha, n_pos = aux
    stale = torch.zeros((), dtype=torch.bool, device=pos.device)
    for _ in range(n_steps):
        # semi-implicit Euler kick with the current forces
        vel = vel + (dt * units.FTM2A) * f / masses
        uphill = torch.sum(f * vel) <= 0.0

        # downhill: count; past n_delay grow dt and anneal alpha
        n_pos = torch.where(uphill, 0, n_pos + 1)
        grow = ~uphill & (n_pos > n_delay)
        dt = torch.where(grow, torch.clamp(dt * f_inc, max=dt_max), dt)
        alpha = torch.where(grow, alpha * f_alpha, alpha)

        # uphill: backtrack half the step just taken, freeze, cool dt
        pos = torch.where(uphill, pos - (0.5 * dt) * vel, pos)
        vel = torch.where(uphill, 0.0, vel)
        dt = torch.where(uphill, torch.clamp(dt * f_dec, min=dt_min), dt)
        alpha = torch.where(uphill, alpha0, alpha)

        # velocity mixing toward the force direction (global norms)
        vnorm = torch.sqrt(torch.sum(vel * vel))
        fnorm = torch.sqrt(torch.sum(f * f))
        vel = (1.0 - alpha) * vel + (alpha * vnorm / torch.clamp(fnorm, min=eps)) * f

        # drift, capped so no atom moves further than dmax in one iteration
        step_d = dt * vel
        dmax_atom = torch.sqrt(torch.max(torch.sum(step_d * step_d, dim=-1)))
        scale = torch.clamp(dmax / torch.clamp(dmax_atom, min=eps), max=1.0)
        pos = pos + scale * step_d

        f, pe, vir = force_fn(pos, state.types, state.cell)

        # Verlet staleness: exact pair criterion (max1 + max2 > skin)
        verlet_check(pos, ref_positions, skin, stale)
    state = dataclasses.replace(
        state, positions=pos, velocities=vel, forces=f, potential_energy=pe, virial=vir,
        step=state.step + n_steps,
    )
    return state, FireAux(dt=dt, alpha=alpha, n_pos=n_pos), stale


def fire_minimize(
    sim,
    state: MDState,
    *,
    ftol: float = 1e-3,
    etol: float = 0.0,
    max_steps: int = 2000,
    dt0: float = None,
    dt_max: float = None,
    dt_min: float = 0.0,
    alpha0: float = 0.1,
    n_delay: int = 5,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    f_alpha: float = 0.99,
    dmax: float = 0.1,
    dt_ref: float = 0.001,
    observer=None,
):
    """Relax ``state`` with FIRE 2.0 using ``sim``'s neighbor and force engine.

    Args:
      sim: a :class:`~mtp_tpu_torch.md.simulation.Simulation` (its
        ``max_neighbors``/``skin``/``steps_per_rebuild`` govern the blocks,
        with ``Simulation.run``'s recovery, counted in ``sim.retries``).
      ftol: stop when max per-atom |F| < ftol [eV/A] (0 disables).
      etol: stop when |dE| < etol * |E| across a block (0 disables).
      max_steps: FIRE iteration budget.
      dt0/dt_max/dt_min: initial/max/min FIRE timestep [ps]; defaults
        dt0=dt_ref, dt_max=10*dt_ref.
      dmax: per-iteration cap on any atom's displacement [A].
      observer: optional host callback ``observer(state)`` per block.

    Returns (state, :class:`MinimizeResult`). Velocities in the returned
    state are zeroed (minimization consumes them as internal mixing state).
    Each block reads its two flags, fmax and the energy to the host.
    """
    if dt0 is None:
        dt0 = dt_ref
    if dt_max is None:
        dt_max = 10.0 * dt_ref
    check_cell(state.cell.detach().cpu().numpy(), sim.model.cutoff + sim.skin)
    state = dataclasses.replace(state, velocities=torch.zeros_like(state.velocities))
    aux = fire_init(dt0, alpha0, state.positions.dtype, state.positions.device)
    scan = functools.partial(
        _fire_scan, skin=sim.skin, dt_max=float(dt_max), dt_min=float(dt_min),
        alpha0=float(alpha0), n_delay=int(n_delay), f_inc=float(f_inc), f_dec=float(f_dec),
        f_alpha=float(f_alpha), dmax=float(dmax),
    )
    done = 0
    refresh = True
    prev_e = None
    fmax_h = float("inf")
    reason = "maxiter"
    converged = False
    while done < max_steps:
        k = min(sim.steps_per_rebuild, max_steps - done)
        new_state, new_aux, overflow, stale = sim.block(
            state, aux, grid=sim.grid_for(state.cell), max_neighbors=sim.max_neighbors,
            n_steps=k, refresh=refresh, first=done, scan=scan,
        )
        fmax = torch.sqrt(torch.max(torch.sum(new_state.forces * new_state.forces, dim=-1)))
        overflow, stale, fmax_new, e_new = torch.stack([
            overflow.double(), stale.double(), fmax.double(),
            new_state.potential_energy.double(),
        ]).tolist()
        # a discarded block leaves stale forces behind: the retry refreshes
        refresh = sim._recover(overflow, stale, during="during minimization")
        if refresh:
            continue
        state, aux = new_state, new_aux
        done += k
        if observer is not None:
            observer(state)
        fmax_h, e_h = fmax_new, e_new
        if ftol > 0.0 and fmax_h < ftol:
            converged, reason = True, "ftol"
            break
        if etol > 0.0 and prev_e is not None and abs(e_h - prev_e) < etol * abs(e_h):
            converged, reason = True, "etol"
            break
        prev_e = e_h
    state = dataclasses.replace(state, velocities=torch.zeros_like(state.velocities))
    result = MinimizeResult(
        converged=converged,
        iterations=done,
        fmax=fmax_h,
        potential_energy=float(state.potential_energy),
        stop_reason=reason,
    )
    return state, result
