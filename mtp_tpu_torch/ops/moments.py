"""The MTP per-atom chain in plain PyTorch: basic moments, the contraction
DAG, the linear readout, and per-pair forces through ``torch.autograd``.

Port of ``mtp_tpu/ops/moments.py``. This is the port's reference path: the CPU
tests hold it against the JAX package, the fused CUDA kernels of
:mod:`mtp_tpu_torch.ops.fused_moments` are held against it on the card, and in
float64 it is the port's own accuracy oracle there.

* Basic moments use unit-vector powers: the rank-nu normalization divides by
  d^nu (pair_mtp.cpp:162-172), so r^a / d^nu = (r/d)^a.
* The product DAG (`alpha_index_times`, pair_mtp.cpp:196-201) runs wave by
  wave (:meth:`MTPSchedule.waves`); duplicate targets within a wave sum in
  a fixed order (:func:`dag_plan`): slices, reshapes and sums, no
  ``index_add``, whose CUDA version adds with atomics in a varying order. So
  the float64 path repeats bit for bit on the card, its backward too (the
  backward of a gather with repeated indices, ``index_put`` with
  ``accumulate=True``, sorts its indices on CUDA).
"""

from __future__ import annotations

import dataclasses
import functools

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

    Returns (m_basic (N, B), aux): aux holds the per-pair tables active
    learning reuses, ``cheb`` (N, J, RB) enveloped Chebyshev values, ``U``
    (N, J, B) unit-vector power products, ``dist`` (N, J) and ``mask``.
    """
    dev = disp.device
    basic = sched.basic
    d2 = torch.sum(disp * disp, dim=-1)
    # masked slots get d2 = 1 before the sqrt: pads and self pairs have
    # disp = 0, and 0 * inf would poison the sums with NaN
    dist = torch.sqrt(torch.where(mask, d2, torch.ones_like(d2)))
    cheb, f = _radial_part(sched, coeffs, dist, itypes, jtypes)

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
    m_basic = torch.einsum("njb,nj->nb", F * U, w)
    return m_basic, dict(cheb=cheb, U=U, dist=dist, mask=mask)


@functools.lru_cache(maxsize=None)
def dag_plan(sched: MTPSchedule):
    """The product DAG as a fixed-order sum, built once per schedule.

    In each wave the rows are sorted by how many rows share their target,
    then by target, and keep their table order otherwise. The rows of the
    T_c targets with c inputs then lie side by side, and their sums are a
    reshape to (T_c, c) and a sum along c. New moments are appended to the
    moment axis as columns in that order.

    Returns (waves, order, zero): per wave (a0, a1, mult, buckets), where
    a0 and a1 are column positions, mult is float64 and buckets is a tuple
    of (c, T_c) in row order; order (M,) is the column of each moment; zero
    says whether some moment is never written and reads an appended zero
    column.
    """
    B, M = sched.basic_count, sched.alpha_moments_count
    col = np.full(M, -1, dtype=np.int64)
    col[:B] = np.arange(B)
    ncol = B
    waves = []
    for wave in sched.waves():
        uniq, inv, cnt = np.unique(wave[:, 3], return_inverse=True, return_counts=True)
        w = wave[np.lexsort((np.arange(len(wave)), wave[:, 3], cnt[inv]))]
        sizes = np.unique(cnt)
        targets = np.concatenate([uniq[cnt == c] for c in sizes])
        if (col[w[:, :2]] < 0).any() or (col[targets] >= 0).any():
            raise ValueError("alpha_index_times reads a moment before its wave writes it")
        a0, a1 = col[w[:, 0]], col[w[:, 1]]
        col[targets] = ncol + np.arange(len(targets))
        ncol += len(targets)
        buckets = tuple((int(c), int((cnt == c).sum())) for c in sizes)
        waves.append((a0, a1, w[:, 2].astype(np.float64), buckets))
    zero = bool((col < 0).any())
    return waves, np.where(col >= 0, col, ncol), zero


@functools.lru_cache(maxsize=None)
def _dag_plan_on(sched: MTPSchedule, device: torch.device):
    waves, order, zero = dag_plan(sched)
    waves = [
        (torch.as_tensor(a0, device=device), torch.as_tensor(a1, device=device),
         torch.as_tensor(mult, device=device), buckets)
        for a0, a1, mult, buckets in waves
    ]
    return waves, torch.as_tensor(order, device=device), zero


def contract_moments(sched: MTPSchedule, m_basic, dim: int):
    """Moments from basic moments along the moment axis `dim` of `m_basic`
    (the B basic moments there, any other axes alongside), in the fixed
    order of :func:`dag_plan`."""
    waves, order, zero = _dag_plan_on(sched, m_basic.device)
    lead = (slice(None),) * dim
    tail = (1,) * (m_basic.dim() - 1 - dim)
    m = m_basic
    for a0, a1, mult, buckets in waves:
        contrib = m[lead + (a0,)] * m[lead + (a1,)] * mult.to(m.dtype).view(-1, *tail)
        sums, start = [m], 0
        for c, t in buckets:
            seg = contrib.narrow(dim, start, c * t)
            sums.append(seg.reshape(*seg.shape[:dim], t, c, *seg.shape[dim + 1:]).sum(dim + 1))
            start += c * t
        m = torch.cat(sums, dim)
    if zero:
        m = torch.cat([m, torch.zeros_like(m.narrow(dim, 0, 1))], dim)
    return m[lead + (order,)]


def contract_dag(sched: MTPSchedule, m_basic):
    """Moments (N, M) from basic moments (N, B), wave by wave; duplicate
    targets sum in a fixed order (pair_mtp.cpp:196-201)."""
    return contract_moments(sched, m_basic, 1)


def readout(sched: MTPSchedule, coeffs, moments, itypes):
    """Site energies: species constant + linear combination of scalar moments
    (pair_mtp.cpp:204-212). Returns (site energies (N,), basis members)."""
    mapping = torch.as_tensor(sched.mapping, device=moments.device)
    basis_members = moments[:, mapping]  # (N, S)
    e = basis_members @ coeffs.moment_coeffs
    return e + coeffs.species_coeffs[itypes], basis_members


def site_energies(sched: MTPSchedule, coeffs, disp, mask, itypes, jtypes):
    """Per-atom MTP energies as a differentiable function of displacements."""
    m_basic, _ = basic_moments(sched, coeffs, disp, mask, itypes, jtypes)
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
