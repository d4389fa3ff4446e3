"""Time integrators: velocity-Verlet NVE, Langevin (BAOAB), Nose-Hoover-chain
NVT, and isotropic, anisotropic and triclinic MTK NPT (port of
``mtp_tpu/md/integrators.py``).

Each integrator is a function ``(state, aux, force_fn, dt, ...) -> (state,
aux)`` (NVE: ``-> state``) over device tensors: the aux states are
``NamedTuple``s of tensors on the state's device, every conditional is a
``torch.where``, and no step reads a value back to the host. The force
evaluation is injected as ``force_fn(positions, types, cell) -> (forces,
potential_energy, virial)``, so the integrators stay independent of the
potential and of neighbor-list management. Every half kick and drift goes
through ``ops.md_step.md_step`` (one K9 launch on the card).

Precision: the JAX package pins every (3, 3) product to HIGHEST precision
because the TPU's matrix unit rounds fp32 operands. Torch's ``matmul`` runs
as TF32 on the card whenever ``allow_tf32`` or
``set_float32_matmul_precision`` allows it, so every cell and velocity
transform here is written as explicit component sums (:func:`_mm3`,
:func:`_xm3`, :func:`mtk_ke_tensor`) that no matmul setting can reach.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from mtp_tpu_torch.md.state import MDState, kinetic_energy, volume_of
from mtp_tpu_torch.ops.md_step import md_step
from mtp_tpu_torch.utils import units
from mtp_tpu_torch.utils.device import resolve_device

ForceFn = Callable


def _half_kick(state: MDState, dt, *, drift=None, count_step=False):
    """v += (dt/2) F/m; then, where asked, the drift x += drift * v and the
    step count: one K9 launch on the card."""
    x, v, step = md_step(state.positions, state.velocities, state.forces, state.masses,
                         state.step if count_step else None, kick=0.5 * dt * units.FTM2A,
                         drift=drift)
    return dataclasses.replace(state, positions=x, velocities=v,
                               step=step if count_step else state.step)


def _drift(state: MDState, dt):
    x, _, _ = md_step(state.positions, state.velocities, state.forces, state.masses, drift=dt)
    return dataclasses.replace(state, positions=x)


def _with_forces(state: MDState, force_fn) -> MDState:
    f, pe, vir = force_fn(state.positions, state.types, state.cell)
    return dataclasses.replace(state, forces=f, potential_energy=pe, virial=vir)


# ----------------------------------------------------------------- NVE ----


def nve_step(state: MDState, force_fn: ForceFn, dt: float) -> MDState:
    """One velocity-Verlet step: kick and drift, forces, closing kick (two
    K9 launches on the card besides the forces)."""
    state = _half_kick(state, dt, drift=dt)
    state = _with_forces(state, force_fn)
    return _half_kick(state, dt, count_step=True)


# ------------------------------------------------------------- Langevin ----


class LangevinAux(NamedTuple):
    """The noise source: a ``torch.Generator`` on the state's device."""

    generator: torch.Generator


def langevin_init(seed: int = 0, device="cuda") -> LangevinAux:
    return LangevinAux(torch.Generator(device=resolve_device(device)).manual_seed(seed))


def _fork(generator: torch.Generator) -> torch.Generator:
    """A copy of `generator` at its current state (host-side state only)."""
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return g


def langevin_step(
    state: MDState,
    aux: LangevinAux,
    force_fn: ForceFn,
    dt: float,
    temperature: float,
    damping: float,
):
    """BAOAB Langevin dynamics; `damping` is the relaxation time [ps].

    The noise is drawn from a copy of ``aux.generator``, which the returned
    aux carries: the incoming aux is left as it was, so a driver that
    discards a block and retries it draws the same noise (the JAX package
    splits its key the same way)."""
    gen = _fork(aux.generator)
    state = _half_kick(state, dt, drift=0.5 * dt)
    # O: Ornstein-Uhlenbeck exact update
    c1 = math.exp(-dt / damping)
    sigma = torch.sqrt(units.KB * temperature / (state.masses * units.MVV2E) * (1 - c1**2))
    noise = torch.randn(
        state.velocities.shape, generator=gen, dtype=state.velocities.dtype,
        device=state.velocities.device,
    )
    state = dataclasses.replace(state, velocities=c1 * state.velocities + sigma[:, None] * noise)
    state = _drift(state, 0.5 * dt)
    state = _with_forces(state, force_fn)
    return _half_kick(state, dt, count_step=True), LangevinAux(gen)


# ------------------------------------------------------ Nose-Hoover NVT ----


class NHCAux(NamedTuple):
    """Nose-Hoover chain variables (length-2 chain)."""

    xi: torch.Tensor  # (2,) thermostat velocities
    eta: torch.Tensor  # (2,) thermostat positions (for the conserved quantity)


def nhc_init(dtype=torch.float32, device="cuda") -> NHCAux:
    dev = resolve_device(device)
    return NHCAux(xi=torch.zeros(2, dtype=dtype, device=dev),
                  eta=torch.zeros(2, dtype=dtype, device=dev))


def _nhc_chain_half(ke2, ndof_t, xi, eta, dt, kt, q1, q2):
    """Half-step (dt/2 total) of a 2-link Nose-Hoover chain acting on a
    subsystem with twice-kinetic-energy `ke2` and `ndof_t` degrees of
    freedom. Returns (velocity scale, xi, eta).

    Standard MTK operator splitting: update link 2, damp and drive link 1,
    emit the subsystem velocity scale exp(-xi1 dt/2), then mirror the link
    updates. `xi` are chain velocities, `eta` their positions (needed only
    for the conserved quantity).
    """
    dt2, dt4, dt8 = 0.5 * dt, 0.25 * dt, 0.125 * dt
    x0, x1 = xi[0], xi[1]

    x1 = x1 + (q1 * x0**2 - kt) / q2 * dt4
    x0 = x0 * torch.exp(-x1 * dt8)
    x0 = x0 + (ke2 - ndof_t * kt) / q1 * dt4
    x0 = x0 * torch.exp(-x1 * dt8)

    scale = torch.exp(-x0 * dt2)
    ke2 = ke2 * scale**2
    eta = eta + dt2 * torch.stack([x0, x1])

    x0 = x0 * torch.exp(-x1 * dt8)
    x0 = x0 + (ke2 - ndof_t * kt) / q1 * dt4
    x0 = x0 * torch.exp(-x1 * dt8)
    x1 = x1 + (q1 * x0**2 - kt) / q2 * dt4

    return scale, torch.stack([x0, x1]), eta


def _nhc_half(state: MDState, aux: NHCAux, dt, temperature, tdamp):
    """Particle-thermostat half-step: 2-link NHC over the atomic KE."""
    ndof = 3 * state.n_atoms
    kt = units.KB * temperature
    scale, xi, eta = _nhc_chain_half(
        2.0 * kinetic_energy(state), ndof, aux.xi, aux.eta, dt, kt,
        q1=ndof * kt * tdamp**2, q2=kt * tdamp**2,
    )
    return (
        dataclasses.replace(state, velocities=state.velocities * scale),
        NHCAux(xi=xi, eta=eta),
    )


def _chain_energy(t: NHCAux, kt, q1, q2, n1):
    """Kinetic and potential terms of one 2-link chain [eV]; `n1` is the
    degrees of freedom the first link acts on."""
    return (0.5 * q1 * t.xi[0] ** 2 + 0.5 * q2 * t.xi[1] ** 2
            + n1 * kt * t.eta[0] + kt * t.eta[1])


def nvt_conserved(state: MDState, aux: NHCAux, temperature: float, tdamp: float):
    """NHC-NVT conserved quantity H' = KE + PE + chain terms [eV]."""
    ndof = 3 * state.n_atoms
    kt = units.KB * temperature
    chain = _chain_energy(aux, kt, ndof * kt * tdamp**2, kt * tdamp**2, ndof)
    return kinetic_energy(state) + state.potential_energy + chain


def nvt_step(
    state: MDState,
    aux: NHCAux,
    force_fn: ForceFn,
    dt: float,
    temperature: float,
    tdamp: float,
):
    """Nose-Hoover-chain NVT step (thermostat half, NVE core, thermostat half)."""
    state, aux = _nhc_half(state, aux, dt, temperature, tdamp)
    state = nve_step(state, force_fn, dt)
    state, aux = _nhc_half(state, aux, dt, temperature, tdamp)
    return state, aux


# ----------------------------------------------------------- MTK NPT -------


class NPTAux(NamedTuple):
    thermo: NHCAux  # particle thermostat chain
    baro_thermo: NHCAux  # barostat thermostat chain (its own 2-link NHC)
    baro_v: torch.Tensor  # () cell strain rate epsilon_dot = p_eps / W (isotropic)


def npt_init(dtype=torch.float32, device="cuda") -> NPTAux:
    return NPTAux(
        thermo=nhc_init(dtype, device),
        baro_thermo=nhc_init(dtype, device),
        baro_v=torch.zeros((), dtype=dtype, device=resolve_device(device)),
    )


def _npt_masses(ndof, kt, tdamp, pdamp):
    """(W, Qb1, Qb2): barostat mass and barostat-chain masses (LAMMPS fix nh
    conventions: W = (ndof+3) kT pdamp^2, etap masses kT pdamp^2)."""
    w = (ndof + 3) * kt * pdamp**2
    return w, kt * pdamp**2, kt * pdamp**2


def npt_step(
    state: MDState,
    aux: NPTAux,
    force_fn: ForceFn,
    dt: float,
    temperature: float,
    pressure: float,
    tdamp: float,
    pdamp: float,
):
    """Isotropic Martyna-Tobias-Klein NPT step.

    `pressure` in bar. The cell is scaled isotropically. Trotter splitting
    follows LAMMPS `fix nh`: particle NHC -> barostat NHC (damps the barostat
    momentum) -> barostat force half-step -> barostat velocity coupling ->
    NVE core with cell-scaled drift -> mirrored closing half-steps. The
    barostat momentum is thermostatted by its own 2-link NHC at the same
    temperature (the MTK ensemble requirement). Needs the virial in
    ``state.virial`` and from `force_fn`.
    """
    ndof = 3 * state.n_atoms
    kt = units.KB * temperature
    p_ext = pressure / units.EVA3_TO_BAR  # eV/A^3
    w, qb1, qb2 = _npt_masses(ndof, kt, tdamp, pdamp)

    def baro_chain_half(aux):
        ke2 = w * aux.baro_v**2  # p_eps^2 / W
        scale, xi, eta = _nhc_chain_half(
            ke2, 1, aux.baro_thermo.xi, aux.baro_thermo.eta, dt, kt, qb1, qb2
        )
        return aux._replace(baro_thermo=NHCAux(xi=xi, eta=eta), baro_v=aux.baro_v * scale)

    def omega_dot_half(state, aux):
        bv = mtk_iso_omega_half(
            aux.baro_v, vol=volume_of(state),
            w_tr=state.virial[0] + state.virial[1] + state.virial[2],
            ke2=2.0 * kinetic_energy(state), dt=dt, ndof=ndof, p_ext=p_ext, w_b=w,
        )
        return aux._replace(baro_v=bv)

    def v_press_half(state, aux):
        alpha = mtk_iso_vscale(aux.baro_v, dt, ndof)
        return dataclasses.replace(state, velocities=state.velocities * alpha)

    # opening half: thermostats, barostat force, barostat-velocity coupling
    state, thermo = _nhc_half(state, aux.thermo, dt, temperature, tdamp)
    aux = baro_chain_half(aux._replace(thermo=thermo))
    aux = omega_dot_half(state, aux)
    state = v_press_half(state, aux)
    state = _half_kick(state, dt)

    # drift with cell scaling: the exact MTK position map (mtk_iso_maps)
    s, d = mtk_iso_maps(aux.baro_v, dt)
    state = dataclasses.replace(
        state, positions=state.positions * s + dt * state.velocities * d, cell=state.cell * s,
    )

    state = _with_forces(state, force_fn)

    # closing half (mirror order)
    state = _half_kick(state, dt)
    state = v_press_half(state, aux)
    aux = omega_dot_half(state, aux)
    aux = baro_chain_half(aux)
    state, thermo = _nhc_half(state, aux.thermo, dt, temperature, tdamp)
    state = dataclasses.replace(state, step=state.step + 1)
    return state, aux._replace(thermo=thermo)


# ------------------------------------------------- anisotropic MTK NPT -----


class NPTAnisoAux(NamedTuple):
    """Full-cell MTK barostat state (Parrinello-Rahman-style cell dynamics
    with the MTK kinetic corrections)."""

    thermo: NHCAux  # particle thermostat chain
    baro_thermo: NHCAux  # barostat thermostat chain
    baro_v: torch.Tensor  # (3, 3) symmetric cell strain-rate tensor p_g / W


def npt_aniso_init(dtype=torch.float32, device="cuda") -> NPTAnisoAux:
    return NPTAnisoAux(
        thermo=nhc_init(dtype, device),
        baro_thermo=nhc_init(dtype, device),
        baro_v=torch.zeros((3, 3), dtype=dtype, device=resolve_device(device)),
    )


def _xm3(x, m):
    """``x @ m`` for x (..., 3) and m (3, 3) as explicit component sums
    ``(x0 m0a + x1 m1a) + x2 m2a``: IEEE products and sums in every dtype,
    whatever the caller's TF32 setting; three launches on the card."""
    p = x[..., :, None] * m
    return (p[..., 0, :] + p[..., 1, :]) + p[..., 2, :]


def _mm3(a, b):
    """(3, 3) @ (3, 3) as explicit component sums (:func:`_xm3` on a's rows)."""
    return _xm3(a, b)


def _eye_like(a):
    return torch.eye(3, dtype=a.dtype, device=a.device)


def _sym_expm(a):
    """exp(A) for a small symmetric (3, 3) A by 4th-order series (barostat
    strain increments are ~dt*eps_dot ~ 1e-4; the truncation error ~|A|^5 is
    far below fp precision)."""
    a2 = _mm3(a, a)
    return _eye_like(a) + a + a2 / 2.0 + _mm3(a2, a) / 6.0 + _mm3(a2, a2) / 24.0


def _sinh_ratio_m(a):
    """f(A) = sinh(A/2)/(A/2) as a series in A^2 (commutes with exp(A))."""
    a2 = _mm3(a, a)
    return _eye_like(a) + a2 / 24.0 + _mm3(a2, a2) / 1920.0


def _voigt_to_tensor(v):
    """Voigt (xx, yy, zz, xy, xz, yz) -> symmetric (3, 3)."""
    return torch.stack([v[0], v[3], v[4], v[3], v[1], v[5], v[4], v[5], v[2]]).reshape(3, 3)


def _tensor_to_voigt(m):
    """Symmetric (3, 3) -> Voigt (xx, yy, zz, xy, xz, yz)."""
    return torch.stack([m[0, 0], m[1, 1], m[2, 2], m[0, 1], m[0, 2], m[1, 2]])


# ------------------------------------------------ shared MTK pieces --------
# One source for the barostat math. All inputs are already reduced scalars
# or tensors (KE, virial, kinetic tensor), as in the JAX package, whose
# sharded engines reduce over the mesh first.


def mtk_ke_tensor(vel, mass_col, real=None):
    """m v v^T summed over atoms, in energy units: the kinetic part of the
    internal pressure tensor. One broadcast product and one reduction over
    atoms in the operands' dtype (no matmul, so no TF32)."""
    mv = vel * mass_col
    if real is not None:
        mv = torch.where(real[:, None], mv, 0.0)
    return units.MVV2E * torch.sum(mv[:, :, None] * vel[:, None, :], dim=0)


def mtk_iso_omega_half(bv, *, vol, w_tr, ke2, dt, ndof, p_ext, w_b):
    """Isotropic barostat momentum half-kick: eps_dot += dt/2 * G_eps with
    the MTK (d/ndof)*2KE correction. `w_tr` = virial trace."""
    p_int = (ke2 + w_tr) / (3.0 * vol)
    g = (3.0 * vol * (p_int - p_ext) + (3.0 / ndof) * ke2) / w_b
    return bv + 0.5 * dt * g


def mtk_iso_vscale(bv, dt, ndof):
    """Velocity damping factor of the iso barostat coupling half-step."""
    return torch.exp(-0.5 * dt * (1.0 + 3.0 / ndof) * bv)


def mtk_iso_maps(bv, dt):
    """(s, d) of the exact iso MTK position map (series-expanded sinh):
    pos' = pos*s + dt*vel*d, cell' = cell*s."""
    x = dt * bv
    s = torch.exp(x)
    x2 = (0.5 * x) ** 2
    sinh_ratio = 1.0 + x2 / 6.0 + x2**2 / 120.0
    return s, torch.exp(0.5 * x) * sinh_ratio


def mtk_aniso_omega_half(bv, *, mvv, vir6, vol, ke2, dt, ndof, p_ext, w_b, couple):
    """Tensor-barostat momentum half-kick: p_g/W += dt/2 * G with
    G = [V(P_int - p_ext I) + (2KE/ndof) I]/W. `mvv` from
    :func:`mtk_ke_tensor`; `couple` = "tri" (all six modes) or "aniso"
    (diagonal only)."""
    eye = _eye_like(bv)
    p_int = (mvv + _voigt_to_tensor(vir6)) / vol
    g = (vol * (p_int - p_ext * eye) + (ke2 / ndof) * eye) / w_b
    g = 0.5 * (g + g.T)  # keep p_g exactly symmetric under fp roundoff
    step = 0.5 * dt * g
    if couple != "tri":
        step = step * eye
    return bv + step


def mtk_aniso_vscale(bv, dt, ndof):
    """Velocity-coupling matrix exp(-dt/2 (p_g/W + Tr(p_g/W)/ndof I))."""
    return _sym_expm(-0.5 * dt * (bv + (torch.trace(bv) / ndof) * _eye_like(bv)))


def mtk_aniso_maps(bv, dt):
    """(E, D) of the exact aniso MTK position map (matrix series, all
    factors commute): pos' = pos@E + dt*vel@D, cell' = cell@E."""
    a = dt * bv
    return _sym_expm(a), _mm3(_sym_expm(0.5 * a), _sinh_ratio_m(a))


def _aniso_modes(couple):
    if couple not in ("tri", "aniso"):
        raise ValueError(f"couple must be 'tri' or 'aniso', not {couple!r}")
    return 6 if couple == "tri" else 3


def npt_aniso_step(
    state: MDState,
    aux: NPTAnisoAux,
    force_fn: ForceFn,
    dt: float,
    temperature: float,
    pressure: float,
    tdamp: float,
    pdamp: float,
    couple: str = "tri",
):
    """Anisotropic Martyna-Tobias-Klein NPT step (full-cell / triclinic),
    LAMMPS `fix npt ... aniso/tri`.

    The barostat momentum is a symmetric (3, 3) tensor p_g; `couple="aniso"`
    restricts it to the diagonal (the cell stays orthorhombic), `couple="tri"`
    evolves all six modes (the cell may tilt). The same Trotter splitting as
    :func:`npt_step` with every scalar barostat map promoted to a matrix
    function of p_g/W (series-evaluated; all factors commute).

    `pressure` [bar] is the hydrostatic external target p_ext*I.
    """
    ndof = 3 * state.n_atoms
    kt = units.KB * temperature
    p_ext = pressure / units.EVA3_TO_BAR  # eV/A^3
    w, qb1_unit, qb2 = _npt_masses(ndof, kt, tdamp, pdamp)
    n_modes = _aniso_modes(couple)
    qb1 = n_modes * qb1_unit

    def baro_chain_half(aux):
        ke2 = w * torch.sum(aux.baro_v * aux.baro_v)  # Tr(p_g^2)/W
        scale, xi, eta = _nhc_chain_half(
            ke2, n_modes, aux.baro_thermo.xi, aux.baro_thermo.eta, dt, kt, qb1, qb2,
        )
        return aux._replace(baro_thermo=NHCAux(xi=xi, eta=eta), baro_v=aux.baro_v * scale)

    def omega_dot_half(state, aux):
        bv = mtk_aniso_omega_half(
            aux.baro_v, mvv=mtk_ke_tensor(state.velocities, state.masses[:, None]),
            vir6=state.virial, vol=volume_of(state), ke2=2.0 * kinetic_energy(state),
            dt=dt, ndof=ndof, p_ext=p_ext, w_b=w, couple=couple,
        )
        return aux._replace(baro_v=bv)

    def v_press_half(state, aux):
        alpha = mtk_aniso_vscale(aux.baro_v, dt, ndof)
        return dataclasses.replace(state, velocities=_xm3(state.velocities, alpha))

    state, thermo = _nhc_half(state, aux.thermo, dt, temperature, tdamp)
    aux = baro_chain_half(aux._replace(thermo=thermo))
    aux = omega_dot_half(state, aux)
    state = v_press_half(state, aux)
    state = _half_kick(state, dt)

    # drift with cell deformation: the matrix analog of the exact iso map
    # r' = r E + dt v D,  h' = h E (mtk_aniso_maps)
    e_full, d_mat = mtk_aniso_maps(aux.baro_v, dt)
    state = dataclasses.replace(
        state,
        positions=_xm3(state.positions, e_full) + dt * _xm3(state.velocities, d_mat),
        cell=_mm3(state.cell, e_full),
    )

    state = _with_forces(state, force_fn)

    state = _half_kick(state, dt)
    state = v_press_half(state, aux)
    aux = omega_dot_half(state, aux)
    aux = baro_chain_half(aux)
    state, thermo = _nhc_half(state, aux.thermo, dt, temperature, tdamp)
    state = dataclasses.replace(state, step=state.step + 1)
    return state, aux._replace(thermo=thermo)


def _npt_common(state, aux, temperature, pressure, tdamp, pdamp, n_modes):
    """The terms every MTK conserved quantity shares: KE + PE + P_ext V +
    particle-chain + barostat-chain terms [eV]."""
    ndof = 3 * state.n_atoms
    kt = units.KB * temperature
    p_ext = pressure / units.EVA3_TO_BAR
    _, qb1_unit, qb2 = _npt_masses(ndof, kt, tdamp, pdamp)
    chain = _chain_energy(aux.thermo, kt, ndof * kt * tdamp**2, kt * tdamp**2, ndof)
    baro_chain = _chain_energy(aux.baro_thermo, kt, n_modes * qb1_unit, qb2, n_modes)
    return (kinetic_energy(state) + state.potential_energy + p_ext * volume_of(state)
            + chain + baro_chain)


def npt_aniso_conserved(
    state: MDState,
    aux: NPTAnisoAux,
    temperature: float,
    pressure: float,
    tdamp: float,
    pdamp: float,
    couple: str = "tri",
):
    """Aniso-MTK conserved quantity H' = KE + PE + Tr(p_g^2)/(2W) + P_ext V
    + particle-chain + barostat-chain terms [eV]."""
    w, _, _ = _npt_masses(3 * state.n_atoms, units.KB * temperature, tdamp, pdamp)
    return (_npt_common(state, aux, temperature, pressure, tdamp, pdamp, _aniso_modes(couple))
            + 0.5 * w * torch.sum(aux.baro_v * aux.baro_v))


def npt_conserved(
    state: MDState,
    aux: NPTAux,
    temperature: float,
    pressure: float,
    tdamp: float,
    pdamp: float,
):
    """MTK conserved quantity H' = KE + PE + W eps_dot^2/2 + P_ext V
    + particle-chain terms + barostat-chain terms [eV]."""
    w, _, _ = _npt_masses(3 * state.n_atoms, units.KB * temperature, tdamp, pdamp)
    return (_npt_common(state, aux, temperature, pressure, tdamp, pdamp, 1)
            + 0.5 * w * aux.baro_v**2)
