"""The MTP model and its energy/force evaluators.

Port of ``mtp_tpu/models/mtp.py``:

* :class:`MTPCoeffs` — the coefficient tensors (radial, species, linear) the
  reference's ``PairMTP::read_file`` loads (pair_mtp.cpp:441-569).
* :class:`MTPModel` — schedule + coefficients on an explicit device in an
  explicit dtype, with the kernels' schedule tables.
* :func:`mtp_energy_forces_window` / :func:`mtp_energy_window` — the main
  path over a bin-sorted list: K1 displacements, K2 pair forces (or K4 site
  energies with K2 as its backward), K3 give-back.
* :func:`mtp_energy_forces` — the plain path (the JAX package's ``xla``
  backend): displacements, site energies and pair forces in plain PyTorch
  with autograd, and the mirror give-back. No kernel runs on it, on any
  device; in float64 on the card it is the port's accuracy oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mtp_tpu_torch.io.mtp_file import MTPData
from mtp_tpu_torch.ops.fused_moments import (
    MegaTables,
    build_tables,
    pair_forces_mega,
    site_energies_mega,
)
from mtp_tpu_torch.ops.moments import MTPSchedule, energy_and_pair_forces
from mtp_tpu_torch.ops.window_disp import inverse_cell, minimum_image, window_disp
from mtp_tpu_torch.ops.window_giveback import window_giveback

__all__ = [
    "MTPCoeffs", "MTPModel", "minimum_image", "gather_displacements",
    "mtp_energy_forces", "mtp_energy_forces_window", "mtp_energy_window",
    "window_constants", "readout_vector",
]


@dataclasses.dataclass
class MTPCoeffs:
    """MTP coefficient tensors."""

    radial_coeffs: torch.Tensor  # (S, S, MU, RB)
    species_coeffs: torch.Tensor  # (S,)
    moment_coeffs: torch.Tensor  # (n_scalar,)


@dataclasses.dataclass(frozen=True, eq=False)
class MTPModel:
    """Schedule (host tables) + coefficients and kernel tables on a device."""

    schedule: MTPSchedule
    coeffs: MTPCoeffs
    tables: MegaTables
    dtype: torch.dtype
    device: torch.device

    @property
    def cutoff(self) -> float:
        return self.schedule.max_dist

    @classmethod
    def from_data(cls, m: MTPData, *, device="cpu", dtype=torch.float32) -> "MTPModel":
        device = torch.device(device)
        sched = MTPSchedule.from_tables(
            species_count=m.species_count,
            radial_basis_size=m.radial_basis_size,
            radial_funcs_count=m.radial_funcs_count,
            min_dist=m.min_dist,
            max_dist=m.max_dist,
            scaling=m.scaling,
            alpha_moments_count=m.alpha_moments_count,
            alpha_index_basic=m.alpha_index_basic,
            alpha_index_times=m.alpha_index_times,
            alpha_moment_mapping=m.alpha_moment_mapping,
        )
        return cls.from_arrays(
            sched, m.radial_coeffs, m.species_coeffs, m.moment_coeffs,
            device=device, dtype=dtype,
        )

    @classmethod
    def from_arrays(cls, sched, radial, species, moment, *, device, dtype) -> "MTPModel":
        device = torch.device(device)

        def t(a):
            return torch.as_tensor(np.array(a), dtype=dtype, device=device).contiguous()

        return cls(
            schedule=sched,
            coeffs=MTPCoeffs(
                radial_coeffs=t(radial), species_coeffs=t(species), moment_coeffs=t(moment)
            ),
            tables=build_tables(sched, device),
            dtype=dtype,
            device=device,
        )

    @classmethod
    def load(cls, path: str, *, device="cpu", dtype=torch.float32) -> "MTPModel":
        from mtp_tpu_torch.io.mtp_file import load_mtp

        return cls.from_data(load_mtp(path), device=device, dtype=dtype)


def gather_displacements(positions, nbr_idx, cell, inv_cell):
    """disp[i, jj] = minimum-imaged x[nbr_idx[i, jj]] - x[i]."""
    return minimum_image(positions[nbr_idx.long()] - positions[:, None, :], cell, inv_cell)


def _virial_from_pairs(pair_tT, rT):
    """Global virial (6,) in Voigt order (xx, yy, zz, xy, xz, yz) from
    (3, J, N) pair forces and masked displacements: W -= sym(T (x) r)."""
    t, r = pair_tT, rT
    return torch.stack([
        -torch.sum(t[0] * r[0]),
        -torch.sum(t[1] * r[1]),
        -torch.sum(t[2] * r[2]),
        -0.5 * torch.sum(t[0] * r[1] + t[1] * r[0]),
        -0.5 * torch.sum(t[0] * r[2] + t[2] * r[0]),
        -0.5 * torch.sum(t[1] * r[2] + t[2] * r[1]),
    ])


def mtp_energy_forces(
    model: MTPModel,
    positions,
    types,
    nbr_idx,
    cell,
    nbr_mirror,
    *,
    compute_virial: bool = True,
):
    """Energy, forces and virial for one configuration on the plain path.

    positions (N, 3); types (N,) int; nbr_idx (N, J) with padding entries
    equal to the row's own index; cell (3, 3); nbr_mirror (N*J,) the flat
    mirror permutation of the list (:class:`~mtp_tpu_torch.ops.neighbors.NeighborList`),
    so the Newton give-back is a gather of the mirrored pair's force.

    Returns dict: energy, site_energies (N,), forces (N, 3), virial (6,).
    """
    n = positions.shape[0]
    nbr_idx = nbr_idx.long()
    disp = gather_displacements(positions, nbr_idx, cell, inverse_cell(cell))
    d2 = torch.sum(disp * disp, dim=-1)
    pair_valid = nbr_idx != torch.arange(n, device=positions.device)[:, None]
    mask = (d2 <= model.schedule.max_dist**2) & pair_valid
    types = types.long()
    site_e, pair_t = energy_and_pair_forces(
        model.schedule, model.coeffs, disp, mask, types, types[nbr_idx]
    )
    t_ji = pair_t.reshape(-1, 3)[nbr_mirror.long()].reshape(pair_t.shape)
    t_ji = t_ji * mask[..., None].to(pair_t.dtype)
    forces = torch.sum(pair_t - t_ji, dim=1)
    out = dict(energy=torch.sum(site_e), site_energies=site_e, forces=forces)
    if compute_virial:
        r = torch.where(mask[..., None], disp, torch.zeros_like(disp))
        out["virial"] = _virial_from_pairs(pair_t.permute(2, 1, 0), r.permute(2, 1, 0))
    else:
        out["virial"] = torch.zeros(6, dtype=forces.dtype, device=forces.device)
    return out


# ----------------------------------------------------------------------
# window force path (bin-sorted lists; the CUDA kernels on the card)
# ----------------------------------------------------------------------


def _window_geometry(model, positions, cell, swl, pair_valid_t, sorted_io):
    """Shared preamble of the window evaluators: sorted positions -> K1
    displacements -> the distance and validity mask. ONE implementation, so
    the force and energy paths see the same mask.

    Returns (dispT (3, J, N), maskf (J, N))."""
    pos_s = positions if sorted_io else positions[swl.order]
    dispT = window_disp(pos_s.contiguous(), swl.idx, cell)
    d2 = dispT[0] * dispT[0] + dispT[1] * dispT[1] + dispT[2] * dispT[2]
    maskf = ((d2 <= model.schedule.max_dist**2) & pair_valid_t).to(positions.dtype)
    return dispT, maskf


def mtp_energy_forces_window(
    model: MTPModel,
    positions,
    cell,
    swl,
    *,
    it_row,
    jtypes_t,
    pair_valid_t,
    esp,
    xi_full,
    compute_virial: bool = True,
    sorted_io: bool = False,
    compute_energy: bool = True,
):
    """Energy, forces and virial through the window path.

    `swl` is a :class:`~mtp_tpu_torch.ops.neighbors.SortedNeighborList`; the
    (J, N) and (N,) arrays are rebuild constants from :func:`window_constants`.

    `sorted_io=True`: `positions` are already in sorted space and forces and
    site energies are returned in sorted space (the block driver integrates
    there). `compute_energy=False`: the energy kernel K4 is skipped and K2
    alone gives the forces (energy and site energies are zeros): MD steps
    need forces, the energy is a block-boundary observable
    (pair_mtp.cpp:72-90).
    """
    n = positions.shape[0]
    rc = model.coeffs.radial_coeffs
    dispT, maskf = _window_geometry(model, positions, cell, swl, pair_valid_t, sorted_io)
    args = (model.tables, dispT, maskf, it_row, jtypes_t, rc, xi_full)
    if compute_energy:
        with torch.enable_grad():
            d = dispT.detach().requires_grad_(True)
            site_e = site_energies_mega(model.tables, d, *args[2:], esp)
            (pair_tT,) = torch.autograd.grad(site_e.sum(), d)
        site_e = site_e.detach()
    else:
        site_e = torch.zeros(n, dtype=positions.dtype, device=positions.device)
        pair_tT = pair_forces_mega(*args)
    forces = window_giveback(pair_tT, swl.mirror)
    if not sorted_io:
        forces = forces[swl.inv_order]
        site_e = site_e[swl.inv_order]
    out = dict(energy=torch.sum(site_e), site_energies=site_e, forces=forces)
    if compute_virial:
        out["virial"] = _virial_from_pairs(pair_tT, dispT * maskf[None])
    else:
        out["virial"] = torch.zeros(6, dtype=forces.dtype, device=forces.device)
    return out


def mtp_energy_window(
    model: MTPModel,
    positions,
    cell,
    swl,
    *,
    it_row,
    jtypes_t,
    pair_valid_t,
    esp,
    xi_full,
    sorted_io: bool = False,
):
    """Total potential energy only (K4): the block-boundary companion of
    ``mtp_energy_forces_window(compute_energy=False)``."""
    dispT, maskf = _window_geometry(model, positions, cell, swl, pair_valid_t, sorted_io)
    site_e = site_energies_mega(
        model.tables, dispT, maskf, it_row, jtypes_t, model.coeffs.radial_coeffs,
        xi_full, esp,
    )
    return torch.sum(site_e)


def window_constants(model: MTPModel, types, swl):
    """Rebuild-constant arrays of the window path: center types (N,),
    neighbor types (J, N), the non-self-pair mask (J, N), per-atom species
    energies (N,) and the readout vector (M,). `types` is in user order."""
    types_s = types[swl.order].to(torch.int32)
    n = types_s.shape[0]
    rows = torch.arange(n, device=swl.idx.device)
    return dict(
        it_row=types_s.contiguous(),
        jtypes_t=types_s[swl.idx.long()].T.contiguous(),
        pair_valid_t=(swl.idx != rows[:, None]).T.contiguous(),
        esp=model.coeffs.species_coeffs[types_s.long()].contiguous(),
        xi_full=readout_vector(model),
    )


def readout_vector(model: MTPModel):
    """(M,) moment coefficients scattered over the full moment axis (zeros at
    non-scalar moments): the fused kernels' readout operand."""
    c = model.coeffs.moment_coeffs
    xi = torch.zeros(model.schedule.alpha_moments_count, dtype=c.dtype, device=c.device)
    return xi.index_put((model.tables.mapping,), c)
