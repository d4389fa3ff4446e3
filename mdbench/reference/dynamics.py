"""The reference's integrators, to follow one block of the program's run.

From a state the program reached (positions, velocities, and for NPT the
thermostat and barostat variables) the reference integrates the same number
of steps with its own forces and its own pair list, in its own dtype.

* NVE: velocity Verlet.
* NPT: the isotropic Martyna-Tobias-Klein equations with two-link
  Nose-Hoover chains on the particles and on the barostat, in LAMMPS
  ``fix nh``'s Trotter order (thermostat, barostat chain, barostat
  half-kick, velocity coupling, half kick, drift with the cell scaled, forces,
  then the mirror), barostat mass (3N + 3) kT pdamp^2, chain masses 3N kT
  tdamp^2 and kT tdamp^2 (kT pdamp^2 on the barostat).

Units: LAMMPS metal (A, ps, eV, amu, K, bar).
"""

from __future__ import annotations

import math

import torch

from mdbench.reference.neighbors import pair_list

KB = 8.617333262e-5
MVV2E = 1.0364269e-4
FTM2A = 1.0 / MVV2E
EVA3_TO_BAR = 1.602176634e6


class _Forces:
    """Forces (and the virial) of the reference model on a Verlet list
    built at cutoff + skin, rebuilt when an atom has moved skin / 2."""

    def __init__(self, model, types, skin: float = 1.0):
        self.model, self.types, self.skin = model, types, skin
        self.pairs = None

    def __call__(self, pos, cell, virial: bool):
        if self.pairs is None or self._moved(pos) > 0.5 * self.skin:
            self.pairs = pair_list(pos, cell, self.model.cutoff + self.skin)
        return self.model.evaluate(pos, self.types, cell, pairs=self.pairs, virial=virial)

    def _moved(self, pos):
        d = pos.to(torch.float64) - self.pairs.positions
        return float(torch.sqrt(torch.max(torch.sum(d * d, dim=-1))))


def _ke2(v, m):
    return MVV2E * torch.sum(m[:, None] * v * v)


def follow_nve(model, pos, vel, masses, types, cell, n_steps: int, dt: float):
    """Velocity Verlet from (pos, vel): returns (pos, vel, first forces,
    last forces) in the model's dtype."""
    dt_ = model.dtype
    pos, vel, m, h = (t.to(dt_) for t in (pos, vel, masses, cell))
    force = _Forces(model, types)
    f = f0 = force(pos, h, False)["forces"]
    for _ in range(n_steps):
        vel = vel + 0.5 * dt * FTM2A * f / m[:, None]
        pos = pos + dt * vel
        f = force(pos, h, False)["forces"]
        vel = vel + 0.5 * dt * FTM2A * f / m[:, None]
    return dict(positions=pos, velocities=vel, cell=h, forces0=f0, forces=f)


def _chain_half(ke2, ndof, xi, eta, dt, kt, q1, q2):
    """Half step of a two-link Nose-Hoover chain on a subsystem with twice
    the kinetic energy `ke2`: (velocity scale, xi, eta)."""
    x0, x1 = xi
    x1 = x1 + (q1 * x0 ** 2 - kt) / q2 * dt / 4
    x0 = x0 * math.exp(-x1 * dt / 8)
    x0 = x0 + (ke2 - ndof * kt) / q1 * dt / 4
    x0 = x0 * math.exp(-x1 * dt / 8)
    scale = math.exp(-x0 * dt / 2)
    ke2 = ke2 * scale ** 2
    eta = (eta[0] + dt / 2 * x0, eta[1] + dt / 2 * x1)
    x0 = x0 * math.exp(-x1 * dt / 8)
    x0 = x0 + (ke2 - ndof * kt) / q1 * dt / 4
    x0 = x0 * math.exp(-x1 * dt / 8)
    x1 = x1 + (q1 * x0 ** 2 - kt) / q2 * dt / 4
    return scale, (x0, x1), eta


def follow_npt_iso(model, pos, vel, masses, types, cell, n_steps: int, dt: float, *,
                   temperature, pressure, tdamp, pdamp, thermo, baro_thermo, baro_v):
    """Isotropic MTK NPT (module docstring) from the given state; `thermo`
    and `baro_thermo` are (xi (2,), eta (2,)) pairs and `baro_v` the cell's
    strain rate, as plain floats. Returns the state after `n_steps` and the
    first and last forces and virials."""
    dt_ = model.dtype
    pos, vel, m, h = (t.to(dt_) for t in (pos, vel, masses, cell))
    n = len(pos)
    ndof = 3 * n
    kt = KB * temperature
    p_ext = pressure / EVA3_TO_BAR
    w_b = (ndof + 3) * kt * pdamp ** 2
    q1, q2 = ndof * kt * tdamp ** 2, kt * tdamp ** 2
    qb = kt * pdamp ** 2
    force = _Forces(model, types)
    out = force(pos, h, True)
    f, vir = out["forces"], out["virial"]
    f0, vir0 = f, vir
    xi, eta = thermo
    bxi, beta = baro_thermo
    bv = baro_v

    def volume(h):
        return float(torch.abs(torch.linalg.det(h.to(torch.float64))))

    def omega_half(bv, vel, vir, h):
        ke2 = float(_ke2(vel, m))
        vol = volume(h)
        p_int = (ke2 + float(vir[0] + vir[1] + vir[2])) / (3.0 * vol)
        return bv + 0.5 * dt * (3.0 * vol * (p_int - p_ext) + 3.0 / ndof * ke2) / w_b

    for _ in range(n_steps):
        s, xi, eta = _chain_half(float(_ke2(vel, m)), ndof, xi, eta, dt, kt, q1, q2)
        vel = vel * s
        s, bxi, beta = _chain_half(w_b * bv ** 2, 1, bxi, beta, dt, kt, qb, qb)
        bv = bv * s
        bv = omega_half(bv, vel, vir, h)
        vel = vel * math.exp(-0.5 * dt * (1.0 + 3.0 / ndof) * bv)
        vel = vel + 0.5 * dt * FTM2A * f / m[:, None]
        x = dt * bv
        sinh_ratio = math.sinh(0.5 * x) / (0.5 * x) if x else 1.0
        pos = pos * math.exp(x) + dt * vel * (math.exp(0.5 * x) * sinh_ratio)
        h = h * math.exp(x)
        out = force(pos, h, True)
        f, vir = out["forces"], out["virial"]
        vel = vel + 0.5 * dt * FTM2A * f / m[:, None]
        vel = vel * math.exp(-0.5 * dt * (1.0 + 3.0 / ndof) * bv)
        bv = omega_half(bv, vel, vir, h)
        s, bxi, beta = _chain_half(w_b * bv ** 2, 1, bxi, beta, dt, kt, qb, qb)
        bv = bv * s
        s, xi, eta = _chain_half(float(_ke2(vel, m)), ndof, xi, eta, dt, kt, q1, q2)
        vel = vel * s
    return dict(positions=pos, velocities=vel, cell=h, forces0=f0, virial0=vir0,
                forces=f, virial=vir, baro_v=bv)
