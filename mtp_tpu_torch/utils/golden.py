"""Golden-value reference engine (NumPy, float64).

NumPy copy of ``mtp_tpu/utils/golden.py`` for the port (``import mtp_tpu``
pulls in jax); it reads the port's :mod:`mtp_tpu_torch.io.mtp_file`. The CPU
tests hold the two copies equal, and the port's float64 plain path against
this one.

An independent, loop-level transcription of the MTP algorithm as specified by
the reference CPU engine (pair_mtp.cpp:72-280) and its active-learning
extension (pair_mtp_extrapolation.cpp:68-342). Deliberately written in the
same scalar style as the spec — NOT the TPU path — so the two implementations
can cross-check each other (the reference itself validates against MLIP-3 the
same way; see SURVEY.md §4).

Everything here is host-side test machinery; it is never imported by the
compute path.
"""

from __future__ import annotations

import numpy as np

from mtp_tpu_torch.io.mtp_file import MTPData


def chebyshev_basis(m: MTPData, dist: float):
    """Radial basis values/derivatives (mtp_rb_chevbyshev_basis.cpp:29-54).

    vals[0] = scaling*(d-Rmax)^2, vals[1] = xi*scaling*(d-Rmax)^2,
    vals[k] = 2*xi*vals[k-1] - vals[k-2], xi = (2d-(Rmin+Rmax))/(Rmax-Rmin).
    """
    rb = m.radial_basis_size
    vals = np.zeros(rb)
    ders = np.zeros(rb)
    lo, hi, s = m.min_dist, m.max_dist, m.scaling
    ksi = (2 * dist - (lo + hi)) / (hi - lo)
    mult = 2.0 / (hi - lo)
    env = (dist - hi) ** 2
    vals[0] = s * env
    vals[1] = s * ksi * env
    ders[0] = s * 2 * (dist - hi)
    ders[1] = s * (mult * env + 2 * ksi * (dist - hi))
    for i in range(2, rb):
        vals[i] = 2 * ksi * vals[i - 1] - vals[i - 2]
        ders[i] = 2 * (mult * vals[i - 1] + ksi * ders[i - 1]) - ders[i - 2]
    return vals, ders


def neighbor_vectors(positions, cell, cutoff):
    """Brute-force full neighbor list with periodic images.

    Returns list over atoms of (j_indices, r_vectors) with r = x_j - x_i,
    0 < |r| <= cutoff. `cell` is a (3,3) row-vector cell matrix or None for
    open boundaries.
    """
    n = len(positions)
    out = []
    if cell is not None:
        cell = np.asarray(cell, dtype=np.float64)
        # enough image shells to cover the cutoff
        inv = np.linalg.inv(cell)
        heights = 1.0 / np.linalg.norm(inv, axis=0)  # perpendicular widths
        reps = np.maximum(1, np.ceil(cutoff / heights).astype(int))
        shifts = [
            i * cell[0] + j * cell[1] + k * cell[2]
            for i in range(-reps[0], reps[0] + 1)
            for j in range(-reps[1], reps[1] + 1)
            for k in range(-reps[2], reps[2] + 1)
        ]
        shifts = np.array(shifts)
    else:
        shifts = np.zeros((1, 3))

    for i in range(n):
        js, rs = [], []
        for j in range(n):
            d = positions[j] - positions[i] + shifts  # (S,3)
            dist = np.linalg.norm(d, axis=1)
            for s in range(len(shifts)):
                if dist[s] <= cutoff and dist[s] > 1e-12:
                    js.append(j)
                    rs.append(d[s])
        out.append((np.array(js, dtype=np.int64), np.array(rs).reshape(-1, 3)))
    return out


def compute(
    m: MTPData,
    positions: np.ndarray,
    types: np.ndarray,
    cell=None,
    *,
    compute_grades: bool = False,
):
    """Full MTP forward+backward pass, following pair_mtp.cpp:72-280.

    Returns dict with: energy, site_energies (n,), forces (n,3), virial (6,)
    in LAMMPS Voigt order (xx,yy,zz,xy,xz,yz), and when ``compute_grades`` also
    per-atom candidate vectors ``energy_ders_wrt_coeffs`` (n, P) following
    pair_mtp_extrapolation.cpp:193-252/322-329.
    """
    positions = np.asarray(positions, dtype=np.float64)
    types = np.asarray(types, dtype=np.int64)
    n = len(positions)
    B = m.alpha_index_basic_count
    M = m.alpha_moments_count
    mu_count = m.radial_funcs_count
    rb = m.radial_basis_size
    S = m.species_count
    rcpp = mu_count * rb  # radial coeffs per pair block
    P = m.coeff_count

    nbrs = neighbor_vectors(positions, cell, m.max_dist)

    site_energies = np.zeros(n)
    forces = np.zeros((n, 3))
    virial = np.zeros(6)
    ders_wrt_coeffs = np.zeros((n, P)) if compute_grades else None
    linear_off = m.radial_coeff_count + S

    aib = m.alpha_index_basic
    ait = m.alpha_index_times
    amm = m.alpha_moment_mapping

    for i in range(n):
        itype = int(types[i])
        js, rs = nbrs[i]
        jnum = len(js)
        moments = np.zeros(M)
        jac = np.zeros((jnum, B, 3))
        rad_jac = (
            np.zeros((B, S, rcpp)) if compute_grades else None
        )  # pair_mtp_extrapolation.cpp:193-198

        for jj in range(jnum):
            r = rs[jj]
            dist = np.linalg.norm(r)
            jtype = int(types[js[jj]])
            vals, ders = chebyshev_basis(m, dist)
            coeffs = m.radial_coeffs[itype, jtype]  # (mu, rb)
            f_mu = coeffs @ vals
            df_mu = coeffs @ ders

            maxp = m.max_alpha_index_basic
            dist_pow = dist ** np.arange(maxp)
            coord_pow = np.vstack([r**k for k in range(maxp)])  # (maxp, 3)

            for k in range(B):
                mu, ax, ay, az = aib[k]
                rank = ax + ay + az
                val = f_mu[mu] / dist_pow[rank]
                der = df_mu[mu] / dist_pow[rank] - rank * val / dist
                pw = coord_pow[ax, 0] * coord_pow[ay, 1] * coord_pow[az, 2]
                moments[k] += val * pw

                if compute_grades:
                    rad_jac[k, jtype, mu * rb : (mu + 1) * rb] += (
                        vals / dist_pow[rank] * pw
                    )

                g = pw * der / dist
                jk = g * r
                if ax != 0:
                    jk[0] += val * ax * coord_pow[ax - 1, 0] * coord_pow[ay, 1] * coord_pow[az, 2]
                if ay != 0:
                    jk[1] += val * ay * coord_pow[ax, 0] * coord_pow[ay - 1, 1] * coord_pow[az, 2]
                if az != 0:
                    jk[2] += val * az * coord_pow[ax, 0] * coord_pow[ay, 1] * coord_pow[az - 1, 2]
                jac[jj, k] = jk

        # DAG forward (pair_mtp.cpp:196-201)
        for a0, a1, mult, a3 in ait:
            moments[a3] += mult * moments[a0] * moments[a1]

        # energy readout (pair_mtp.cpp:204-212)
        site_energies[i] = m.species_coeffs[itype] + m.moment_coeffs @ moments[amm]

        # reverse-mode backprop (pair_mtp.cpp:214-233)
        dEdm = np.zeros(M)
        dEdm[amm] = m.moment_coeffs
        for a0, a1, mult, a3 in ait[::-1]:
            dEdm[a1] += dEdm[a3] * mult * moments[a0]
            dEdm[a0] += dEdm[a3] * mult * moments[a1]

        # force scatter + virial (pair_mtp.cpp:236-277)
        for jj in range(jnum):
            T = dEdm[:B] @ jac[jj]  # (3,)
            forces[i] += T
            forces[js[jj]] -= T
            r = rs[jj]
            virial[0] -= T[0] * r[0]
            virial[1] -= T[1] * r[1]
            virial[2] -= T[2] * r[2]
            virial[3] -= (T[0] * r[1] + T[1] * r[0]) / 2
            virial[4] -= (T[0] * r[2] + T[2] * r[0]) / 2
            virial[5] -= (T[1] * r[2] + T[2] * r[1]) / 2

        if compute_grades:
            # candidate vector: pair_mtp_extrapolation.cpp:233-252, 322-329
            b = ders_wrt_coeffs[i]
            b[linear_off:] = moments[amm]
            b[m.radial_coeff_count + itype] = 1.0
            for jt in range(S):
                off = (itype * S + jt) * rcpp
                b[off : off + rcpp] += dEdm[:B] @ rad_jac[:, jt, :]

    out = dict(
        energy=site_energies.sum(),
        site_energies=site_energies,
        forces=forces,
        virial=virial,
    )
    if compute_grades:
        out["energy_ders_wrt_coeffs"] = ders_wrt_coeffs
        if m.mvs is not None:
            inv = m.mvs.inverse_active_set
            if m.mvs.configuration_mode:
                bsum = ders_wrt_coeffs.sum(axis=0)
                out["max_grade"] = np.abs(inv @ bsum).max() / max(n, 1)
            else:
                grades = np.abs(ders_wrt_coeffs @ inv.T).max(axis=1)
                out["nbh_grades"] = grades
                out["max_grade"] = grades.max() if n else 0.0
    return out
