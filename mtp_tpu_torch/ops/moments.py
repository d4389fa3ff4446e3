"""The MTP per-atom chain in plain PyTorch: basic moments, the contraction
DAG, the linear readout, and per-pair forces through ``torch.autograd``.

Port of ``mtp_tpu/ops/moments.py``. This is the port's reference path: the CPU
tests hold it against the JAX package, the fused CUDA kernels of
:mod:`mtp_tpu_torch.ops.fused_moments` are held against it on the card, and in
float64 it is the port's own accuracy oracle there.

* Basic moments use unit-vector powers: the rank-nu normalization divides by
  d^nu (pair_mtp.cpp:162-172), so r^a / d^nu = (r/d)^a.
* The product DAG (`alpha_index_times`, pair_mtp.cpp:196-201) runs wave by
  wave (:meth:`MTPSchedule.waves`); duplicate targets within a wave
  accumulate (``index_add``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mtp_tpu_torch.ops.chebyshev import chebyshev_basis


@dataclasses.dataclass(frozen=True)
class MTPSchedule:
    """Static MTP contraction schedule (host tables; hashable by content)."""

    species_count: int
    radial_basis_size: int
    radial_funcs_count: int
    min_dist: float
    max_dist: float
    scaling: float
    alpha_moments_count: int
    alpha_index_basic: tuple  # of (mu, ax, ay, az)
    alpha_index_times: tuple  # of (a0, a1, mult, a3)
    alpha_moment_mapping: tuple

    @classmethod
    def from_tables(
        cls,
        *,
        species_count,
        radial_basis_size,
        radial_funcs_count,
        min_dist,
        max_dist,
        scaling,
        alpha_moments_count,
        alpha_index_basic,
        alpha_index_times,
        alpha_moment_mapping,
    ):
        return cls(
            species_count=int(species_count),
            radial_basis_size=int(radial_basis_size),
            radial_funcs_count=int(radial_funcs_count),
            min_dist=float(min_dist),
            max_dist=float(max_dist),
            scaling=float(scaling),
            alpha_moments_count=int(alpha_moments_count),
            alpha_index_basic=tuple(map(tuple, np.asarray(alpha_index_basic).tolist())),
            alpha_index_times=tuple(map(tuple, np.asarray(alpha_index_times).tolist())),
            alpha_moment_mapping=tuple(np.asarray(alpha_moment_mapping).tolist()),
        )

    @property
    def basic(self) -> np.ndarray:
        return np.asarray(self.alpha_index_basic, dtype=np.int64).reshape(-1, 4)

    @property
    def times(self) -> np.ndarray:
        return np.asarray(self.alpha_index_times, dtype=np.int64).reshape(-1, 4)

    @property
    def mapping(self) -> np.ndarray:
        return np.asarray(self.alpha_moment_mapping, dtype=np.int64)

    @property
    def basic_count(self) -> int:
        return len(self.alpha_index_basic)

    @property
    def max_rank(self) -> int:
        return int(self.basic[:, 1:].sum(axis=1).max()) if self.basic_count else 0

    def waves(self):
        """Partition the product DAG into dependency waves.

        Node depth: basics are 0; node a3's depth is 1 + max input depth over
        all rows writing it (fixpoint). All rows writing a node execute in
        wave depth-1; consumers read strictly later.
        """
        t = self.times
        M = self.alpha_moments_count
        depth = np.zeros(M, dtype=np.int64)
        changed = True
        while changed:
            changed = False
            nd = np.maximum(depth[t[:, 0]], depth[t[:, 1]]) + 1
            for (a0, a1, _, a3), d in zip(t, nd):
                if d > depth[a3]:
                    depth[a3] = d
                    changed = True
        row_wave = depth[t[:, 3]] - 1
        n_waves = int(depth.max()) if len(t) else 0
        return [t[row_wave == w] for w in range(n_waves)]


def _radial_part(sched: MTPSchedule, coeffs, dist, itypes, jtypes):
    """f_mu(d) for every pair (pair_mtp.cpp:139-151).

    Returns (cheb (N,J,RB), f (N,J,MU))."""
    cheb = chebyshev_basis(
        dist, sched.radial_basis_size, sched.min_dist, sched.max_dist, sched.scaling
    )
    c = coeffs.radial_coeffs[itypes[:, None], jtypes]  # (N, J, MU, RB)
    f = torch.einsum("njmr,njr->njm", c, cheb)
    return cheb, f


def basic_moments(sched: MTPSchedule, coeffs, disp, mask, itypes, jtypes):
    """Basic moments m_k = sum_j f_{mu_k}(d_j) * (r/d)^{alpha_k} for all atoms.

    Args:
      disp: (N, J, 3) displacements r_ij = x_j - x_i (masked entries arbitrary).
      mask: (N, J) bool, True for real neighbors within the cutoff.
      itypes: (N,) central types; jtypes: (N, J) neighbor types (0-indexed).

    Returns m_basic (N, B).
    """
    dev = disp.device
    basic = sched.basic
    d2 = torch.sum(disp * disp, dim=-1)
    # masked slots get d2 = 1 before the sqrt: pads and self pairs have
    # disp = 0, and 0 * inf would poison the sums with NaN
    dist = torch.sqrt(torch.where(mask, d2, torch.ones_like(d2)))
    _, f = _radial_part(sched, coeffs, dist, itypes, jtypes)

    u = disp / dist[..., None]
    upow = [torch.ones_like(u)]
    for _ in range(sched.max_rank):
        upow.append(upow[-1] * u)
    upow = torch.stack(upow, dim=-2)  # (N, J, max_rank+1, 3)

    ax, ay, az, mu = (
        torch.as_tensor(basic[:, k], device=dev) for k in (1, 2, 3, 0)
    )
    U = upow[..., ax, 0] * upow[..., ay, 1] * upow[..., az, 2]  # (N, J, B)
    F = f[..., mu]  # (N, J, B)
    w = mask.to(disp.dtype)
    return torch.einsum("njb,nj->nb", F * U, w)


def contract_dag(sched: MTPSchedule, m_basic):
    """Moments (N, M) from basic moments (N, B), wave by wave; duplicate
    targets accumulate (pair_mtp.cpp:196-201)."""
    n = m_basic.shape[0]
    dev = m_basic.device
    m = torch.zeros((n, sched.alpha_moments_count), dtype=m_basic.dtype, device=dev)
    m = torch.cat([m_basic, m[:, sched.basic_count:]], dim=1)
    for wave in sched.waves():
        a0, a1, mult, a3 = (torch.as_tensor(wave[:, k], device=dev) for k in range(4))
        contrib = m[:, a0] * m[:, a1] * mult.to(m.dtype)
        m = m.index_add(1, a3, contrib)
    return m


def readout(sched: MTPSchedule, coeffs, moments, itypes):
    """Site energies: species constant + linear combination of scalar moments
    (pair_mtp.cpp:204-212). Returns (site energies (N,), basis members)."""
    mapping = torch.as_tensor(sched.mapping, device=moments.device)
    basis_members = moments[:, mapping]  # (N, S)
    e = basis_members @ coeffs.moment_coeffs
    return e + coeffs.species_coeffs[itypes], basis_members


def site_energies(sched: MTPSchedule, coeffs, disp, mask, itypes, jtypes):
    """Per-atom MTP energies as a differentiable function of displacements."""
    m_basic = basic_moments(sched, coeffs, disp, mask, itypes, jtypes)
    moments = contract_dag(sched, m_basic)
    e, _ = readout(sched, coeffs, moments, itypes)
    return e


def energy_and_pair_forces(sched: MTPSchedule, coeffs, disp, mask, itypes, jtypes):
    """Per-atom energies and per-pair force vectors.

    Returns (site_E (N,), pair_T (N, J, 3)) with pair_T = dE_total/d(disp_ij),
    the reference's `temp_force` (pair_mtp.cpp:241-246): pair (i, j) adds +T
    to atom i and -T to atom j.
    """
    with torch.enable_grad():
        d = disp.detach().requires_grad_(True)
        site_e = site_energies(sched, coeffs, d, mask, itypes, jtypes)
        (pair_t,) = torch.autograd.grad(site_e.sum(), d)
    pair_t = pair_t * mask[..., None].to(pair_t.dtype)
    return site_e.detach(), pair_t
