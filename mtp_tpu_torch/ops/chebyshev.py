"""Chebyshev radial basis on a scaled interval with smooth-cutoff envelope.

Port of ``mtp_tpu/ops/chebyshev.py`` (reference RBChebyshev,
mtp_rb_chevbyshev_basis.cpp:29-38):

    xi      = (2 d - (Rmin + Rmax)) / (Rmax - Rmin)
    T_0     = scaling * (d - Rmax)^2
    T_1     = xi * T_0
    T_k     = 2 xi T_{k-1} - T_{k-2}

Derivatives come from ``torch.autograd`` on the plain path; the CUDA kernels
carry the analytic recurrence (mtp_rb_chevbyshev_basis.cpp:40-54).
"""

from __future__ import annotations

import torch


def chebyshev_basis(dist, size: int, min_dist, max_dist, scaling=1.0):
    """Radial basis values, stacked on a new trailing axis: (..., size)."""
    if size < 2:
        raise ValueError("radial_basis_size must be >= 2")
    ksi = (2.0 * dist - (min_dist + max_dist)) / (max_dist - min_dist)
    env = scaling * (dist - max_dist) ** 2
    vals = [env, ksi * env]
    for _ in range(2, size):
        vals.append(2.0 * ksi * vals[-1] - vals[-2])
    return torch.stack(vals, dim=-1)
