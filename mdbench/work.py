"""The yardstick of the roofline and MFU metrics: the work of each kernel's
function, frozen.

A copy of the program's ``chip_smoke.py`` ``kernel_work`` as it stood when
the benchmark was made, rewritten to read the sizes from a parsed ``.mtp``
(``mdbench.reference.mtp_file``) instead of the program's model, so that an
edit to the program cannot move it. Per call of kernel ``name`` on ``n`` atoms, list width ``j`` and
``live`` pairs within the cutoff: (fp32 operations, bytes), every input read
once and every output written once; the operations the function needs (an
FMA is 2), not those a kernel happens to do. Per live pair each quantity is
counted once: the geometry, the Chebyshev values (and derivatives), f_mu
(and f'_mu), each distinct monomial of rank >= 2 as a lower one times a
unit-vector component (1), the B moment FMAs, and the force tail grouped by
monomial. Per atom each DAG product once forward (3) and once in reverse
(5). K1 and K3 are elementwise. K5's operations are float64.

``live_pairs`` counts the pairs from the benchmark's own geometry.
"""

from __future__ import annotations

import numpy as np

# one NVIDIA H100 SXM (data sheet, dense): fp32 outside the tensor cores,
# fp64 outside the tensor cores, HBM3
PEAK_FLOPS, PEAK_FLOPS_F64, PEAK_BYTES = 67e12, 34e12, 3.35e12

# the force path of one MD step, the energy of one block, one grade step
STEP = ("window_disp", "pair_forces_mega", "window_giveback")
BLOCK = ("site_energies_mega",)
GRADE = ("window_disp", "candidates_mega", "window_giveback")


def monomials(rmax):
    """(ax, ay, az) of every unit-vector monomial of rank <= rmax."""
    return [
        (ax, ay, r - ax - ay)
        for r in range(rmax + 1)
        for ax in range(r, -1, -1)
        for ay in range(r - ax, -1, -1)
    ]


def kernel_work(name, pot: dict, n, j, live):
    """(flops, bytes) of one call of kernel `name` (module docstring)."""
    if name == "window_disp":
        # per pair: 3 subtractions, two 3x3 products, 3 rint and subtractions,
        # |d|^2 and the test; per call the closed-form inverse. Reads
        # positions, idx_t, pair_valid_t (1 byte) and the cell; writes dispT
        # and maskf
        return 45 * j * n + 41, 12 * n + 4 * j * n + j * n + 36 + 12 * j * n + 4 * j * n
    if name == "window_giveback":  # T(own) - T(mirror), summed; pair_T, mirror_t, forces
        return 6 * j * n, 12 * j * n + 4 * j * n + 12 * n
    basic_idx = np.asarray(pot["alpha_index_basic"])
    B, M = len(basic_idx), pot["alpha_moments_count"]
    MU, RB = pot["radial_funcs_count"], pot["radial_basis_size"]
    S, n_scal = pot["species_count"], len(pot["alpha_moment_mapping"])
    P = len(pot["alpha_index_times"])
    monos = monomials(int(basic_idx[:, 1:].sum(axis=1).max()))
    NT = len(monos)
    # D_a += G_t * (alpha_a * U_(t - e_a)): an FMA, and a multiply when alpha_a > 1
    d_terms = sum(2 + (a > 1) for m in monos for a in m if a)
    geo = 16  # d2 5, sqrt, 1/d, u 3, ksi 3, d - hi, envelope 2
    cheb = 2 + 2 * (RB - 2)  # ksi * env, 2 ksi, an FMA per further value
    values = geo + cheb + 2 * MU * RB + (NT - 4)  # geometry, f_mu, monomials
    basic = values + MU + 2 * B  # f_mu * w, the moment FMAs
    deriv = 7 + 5 * (RB - 2) + 2 * MU * RB  # Chebyshev derivatives, f'_mu
    contract = 4 * B + 2 * NT + 3 * (NT - 1) + d_terms + 14  # G, G'; P, Q, D; T
    gmu_rad = 2 * B + RB + 2 * MU * RB  # K5: Gmu, w * cheb_r, the radial rows
    fwd, readout, rev = 3 * P, 2 * n_scal + 1, M + 5 * P
    pairs_in = 20 * j * n + 4 * n  # dispT, mask, jtypes_t; itypes
    return {
        "pair_forces_mega": (live * (basic + deriv + contract) + n * (fwd + rev),
                             pairs_in + 12 * j * n),
        "site_energies_mega": (live * basic + n * (fwd + readout), pairs_in + 8 * n),
        "candidates_mega": (
            live * (basic + deriv + contract + gmu_rad) + n * (fwd + readout + rev),
            pairs_in + 8 * n + 8 * n * (n_scal + S * MU * RB) + 12 * j * n,  # b in float64
        ),
    }[name]


def peak_flops(name) -> float:
    return PEAK_FLOPS_F64 if name == "candidates_mega" else PEAK_FLOPS


def bound_seconds(names, pot, n, j, live) -> float:
    """The least time the chip could take for these calls: for each call the
    larger of its operations over the peak of their type and its bytes over
    the memory rate, summed."""
    total = 0.0
    for name in names:
        flops, nbytes = kernel_work(name, pot, n, j, live)
        total += max(flops / peak_flops(name), nbytes / PEAK_BYTES)
    return total


def peak_seconds(names, pot, n, j, live) -> float:
    """The calls' operations at the peak rate of their type (for MFU)."""
    return sum(kernel_work(name, pot, n, j, live)[0] / peak_flops(name) for name in names)


def live_pairs(positions, cell, cutoff) -> int:
    """Ordered pairs i != j within `cutoff` (the benchmark's own search)."""
    import torch

    from mdbench.reference.neighbors import pair_list

    pos = torch.as_tensor(positions, dtype=torch.float64)
    return int(len(pair_list(pos, torch.as_tensor(cell, dtype=torch.float64,
                                                  device=pos.device), cutoff).i))
