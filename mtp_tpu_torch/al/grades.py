"""MaxVol extrapolation grades (active learning).

Port of ``mtp_tpu/al/grades.py``. The reference computes, per atom, the
candidate vector b_i = dE_i/dtheta over all model coefficients (radial block
via a radial Jacobian accumulated in the forward pass, species one-hot,
scalar-basis members; reference pair_mtp_extrapolation.cpp:193-252, 322-329)
and grades it against the inverse active set
(pair_mtp_extrapolation_kokkos.cpp:1156-1166).

Two paths, as in the JAX package:

* plain (:func:`candidate_vectors`, :func:`candidates_and_forces`): any
  neighbor list with its mirror; PyTorch only
  (:func:`~mtp_tpu_torch.ops.fused_candidates.candidate_terms`), on any
  device. In float64 it is the port's grade oracle.
* window (:func:`candidates_and_forces_window`, :func:`grade_eval_window`):
  the Simulation's bin-sorted list; K1 displacements, the K5 grade-step
  kernel (float64 arithmetic and a float64 b from float32 inputs), and the K3
  give-back on the card.

Coefficient-vector layout (must match the MVS active-set files,
pair_mtp_extrapolation.cpp:533): [radial (S,S,MU,RB) row-major | species (S) |
scalar-basis (m_scal)].

Grade products: the JAX package pins them to ``Precision.HIGHEST``. Here a
float32 product runs in float64 (:func:`_ieee_matmul`), so no TF32 or
reduced-precision matmul setting can reach it.
"""

from __future__ import annotations

import torch

from mtp_tpu_torch.models.mtp import (
    _virial_from_pairs,
    _window_geometry,
    gather_displacements,
    readout_vector,
    window_constants,
)
from mtp_tpu_torch.ops.fused_candidates import candidate_terms, candidates_mega
from mtp_tpu_torch.ops.window_disp import inverse_cell
from mtp_tpu_torch.ops.window_giveback import window_giveback


def _ieee_matmul(a, b):
    """``a @ b`` that never runs as TF32: float32 operands are multiplied in
    float64 (exact products, float64 sums) and the result is rounded back."""
    if a.dtype == torch.float32:
        return (a.double() @ b.double()).to(a.dtype)
    return a @ b


def _place_blocks(rad, itypes, basis_members, S):
    """b (N, P) = [radial block at row itype | species one-hot | basis
    members]; rad is (N, S*MU*RB) in (s2, mu, r) order."""
    it_onehot = torch.nn.functional.one_hot(itypes.long(), S).to(rad.dtype)  # (N, S)
    b_rad = (it_onehot[:, :, None] * rad[:, None, :]).reshape(rad.shape[0], -1)
    return torch.cat([b_rad, it_onehot, basis_members], dim=1)


def _plain_terms(model, positions, types, nbr_idx, cell):
    n = positions.shape[0]
    nbr_idx = nbr_idx.long()
    disp = gather_displacements(positions, nbr_idx, cell, inverse_cell(cell))
    d2 = torch.sum(disp * disp, dim=-1)
    rows = torch.arange(n, device=positions.device)
    mask = (d2 <= model.schedule.max_dist**2) & (nbr_idx != rows[:, None])
    types = types.long()
    site, bm, rad, pair_t = candidate_terms(
        model.schedule, model.coeffs.radial_coeffs, disp, mask, types, types[nbr_idx],
        readout_vector(model), model.coeffs.species_coeffs[types],
    )
    b = _place_blocks(rad.reshape(n, -1), types, bm, model.schedule.species_count)
    return b, site, pair_t, disp, mask


def candidate_vectors(model, positions, types, nbr_idx, cell):
    """Per-atom candidate vectors B (N, P) = dE_i/dtheta, and the total
    energy (so an AL step needs no second forward pass).

    positions (N, 3); types (N,); nbr_idx (N, J) padded with the row's own
    index; cell (3, 3)."""
    b, site, _, _, _ = _plain_terms(model, positions, types, nbr_idx, cell)
    return b, torch.sum(site)


def candidates_and_forces(model, positions, types, nbr_idx, cell, nbr_mirror):
    """Fused grade-step evaluation on the plain path: ONE shared forward
    pass yields both the MD forces and the per-atom candidate vectors (the
    reference's ComputeAlphaBasicRad economics,
    pair_mtp_extrapolation_kokkos.cpp:780-907). `nbr_mirror` is the list's
    flat mirror permutation (Newton give-back by gather).

    Returns dict(b, site_energies, energy, forces, virial); the virial is
    tallied too (LAMMPS fills it whenever vflag is set, pair_mtp.cpp:257-266).
    """
    b, site, pair_t, disp, mask = _plain_terms(model, positions, types, nbr_idx, cell)
    t_ji = pair_t.reshape(-1, 3)[nbr_mirror.long()].reshape(pair_t.shape)
    forces = torch.sum(pair_t - t_ji * mask[..., None].to(pair_t.dtype), dim=1)
    r = torch.where(mask[..., None], disp, torch.zeros_like(disp))
    virial = _virial_from_pairs(pair_t.permute(2, 1, 0), r.permute(2, 1, 0))
    return dict(b=b, site_energies=site, energy=torch.sum(site), forces=forces, virial=virial)


def candidates_and_forces_window(
    model, positions, cell, swl, *, it_row, jtypes_t, idx_t, pair_valid_t, mirror_t, esp,
    xi_full,
):
    """Grade-step fusion through the window path: K1 displacements and
    mask, ONE K5 launch for site energies, basis members, radial rows and pair forces,
    and the K3 give-back.

    `positions` are USER order; the (J, N)/(N,) arrays are the rebuild
    constants of :func:`~mtp_tpu_torch.models.mtp.window_constants`. Returns
    dict(b (N, P) in SORTED row space: map grades back with
    ``swl.inv_order``; site_energies (N,), forces (N, 3), both user order;
    energy; virial (6,)).
    """
    dispT, maskf = _window_geometry(model, positions, cell, swl, idx_t, pair_valid_t,
                                    sorted_io=False)
    out = candidates_mega(
        model.tables, dispT, maskf, it_row, jtypes_t, model.coeffs.radial_coeffs, xi_full, esp,
    )
    forces = window_giveback(out["pair_tT"], mirror_t)[swl.inv_order]
    b = _place_blocks(out["rad"], it_row, out["basis_members"], model.schedule.species_count)
    # global virial from the transposed layouts, as the force path tallies it
    virial = _virial_from_pairs(out["pair_tT"], dispT * maskf[None])
    return dict(
        b=b,
        site_energies=out["site_e"][swl.inv_order],
        energy=torch.sum(out["site_e"]),
        forces=forces,
        virial=virial,
    )


def grade_eval_window(model, positions, types, cell, swl, inverse_active_set, *, config_mode):
    """A full grade step on a sorted list: rebuild constants, the fused
    candidates kernel, the grade product and the max.

    Returns dict(forces (N, 3) user order, energy, max_grade (0-d tensor),
    grades (N,) user order or None in configuration mode, virial)."""
    consts = window_constants(model, types, swl)
    out = candidates_and_forces_window(model, positions, cell, swl, **consts)
    b = out["b"]
    if config_mode:
        g = cfg_grade(b, inverse_active_set, positions.shape[0])
        grades = None
    else:
        grades = nbh_grades(b, inverse_active_set)[swl.inv_order]
        g = torch.max(grades)
    return dict(
        forces=out["forces"], energy=out["energy"], max_grade=g,
        grades=grades, virial=out["virial"],
    )


def nbh_grades(b, inverse_active_set):
    """Neighborhood-mode grades: gamma_i = max_l |(invA @ b_i)_l|, one
    (N, P) x (P, P) product for the whole configuration, in b's dtype (K5
    gives a float64 b); the grades come out in the inverse's dtype."""
    g = torch.abs(_ieee_matmul(b, inverse_active_set.to(b.dtype).T))
    return torch.max(g, dim=-1).values.to(inverse_active_set.dtype)


def cfg_grade(b, inverse_active_set, n_atoms):
    """Configuration-mode grade: sum candidate vectors over atoms, one
    matvec, normalize by atom count (pair_mtp_extrapolation.cpp:363-377)."""
    bsum = torch.sum(b, dim=0)
    g = torch.max(torch.abs(_ieee_matmul(inverse_active_set.to(b.dtype), bsum)))
    return (g / max(n_atoms, 1)).to(inverse_active_set.dtype)
