"""The fused grade step of active learning (K5): site energies, scalar-basis
members, radial-Jacobian rows and pair forces from one per-pair stage and one
DAG.

Port of ``mtp_tpu/ops/pallas_moments.py:589 _mega_cand_kernel`` (through
``candidates_mega`` :674). The CUDA entry point runs three stage kernels of
``csrc/fused_moments.cu``, as K2 does with de = 1: the basic moments, the
product DAG (with the readout and the basis members before the reverse
pass), and the force tail, which also gathers the radial rows
``rad[s2, mu, r] = sum_s [jt(s) = s2] w(s) cheb_r(s) Gmu[mu](s)`` with
``Gmu[mu](s) = sum_{k: mu_k = mu} gamma_k U_k(s)``.

K5 computes in float64 from float32 inputs (the JAX kernel runs in fp32),
and the candidate vector's blocks come out as float64. The grades multiply b
by the inverse active set, whose conditioning turns fp32 rounding of the
per-pair sums into grade errors of about 1e-2 of the largest grade; double
arithmetic brings them down to the rounding of the fp32 coefficients. Site
energies and pair forces are rounded to float32, as the force path gives
them. For the specialised shapes of ``fused_moments.SHAPES`` (levels 8 and
16) with at most 8 Chebyshev functions, the pair stages are the specialised
double ``cand_kernel`` instantiations (a block of warps over 32 atoms, each
warp a compile-time group of the terms); every other schedule runs the
General double ``pair_kernel`` ones. The DAG is ``dag_kernel`` in double
either way. :func:`mtp_tpu_torch.ops.fused_moments.resident_warps` says
which ("K5 specialised") and how many warps each stage keeps per SM.

Layouts follow the JAX kernel (see :mod:`mtp_tpu_torch.ops.fused_moments`):
inputs dispT (3, J, N), mask (J, N), itypes (N,), jtypes_t (J, N), radial
(S, S, MU, RB), xi_full (M,), esp (N,); outputs site_e (N,), basis_members
(N, n_scalar) float64, rad (N, S*MU*RB) float64 in (s2, mu, r) order, pair_tT
(3, J, N).
The candidate vector's itype block is placed by the caller
(:func:`mtp_tpu_torch.al.grades.candidates_and_forces_window`).

:func:`candidates_mega` dispatches on the tensor's device: CPU tensors go to
the plain PyTorch twin :func:`candidates_mega_plain`, CUDA tensors to the
kernel, or it raises.
"""

from __future__ import annotations

import ctypes
import functools
import types as _types

import numpy as np
import torch

from mtp_tpu_torch.kernels._build import Kernel
from mtp_tpu_torch.ops import moments
from mtp_tpu_torch.ops.fused_moments import _check, scratch

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

K5 = Kernel(
    name="candidates_mega",
    symbol="mtp_candidates_mega",
    source="mtp_tpu_torch/csrc/fused_moments.cu",
    replaces="mtp_tpu/ops/pallas_moments.py:589",
    argtypes=(_P,) * 14 + (_I,) * 12 + (_D,) * 3 + (_P,),
)


@functools.lru_cache(maxsize=None)
def _mu_plan_on(sched, device: torch.device):
    """The basic moments grouped by radial function, built once per schedule
    and device: (perm, sizes), where ``perm`` lists the basic moments of
    mu = 0, 1, ... in table order and ``sizes[mu]`` counts those of mu."""
    mu = sched.basic[:, 0]
    perm = np.argsort(mu, kind="stable")
    sizes = [int((mu == k).sum()) for k in range(sched.radial_funcs_count)]
    return torch.as_tensor(perm, device=device), sizes


def candidate_terms(sched, radial_coeffs, disp, mask, itypes, jtypes, xi_full, esp):
    """The grade-step terms in plain PyTorch on the (N, J, 3) layout (port
    of the shared forward of ``mtp_tpu/al/grades.py:candidates_and_forces``).

    gamma = dE/d(basic moments) is the autograd gradient of the summed site
    energies; the pair forces chain gamma through the basic moments' vjp;
    the radial rows contract gamma with the same Chebyshev and unit-vector
    tables (``aux`` of :func:`~mtp_tpu_torch.ops.moments.basic_moments`).
    The radial rows are elementwise sums, not a matrix product.

    disp (N, J, 3); mask (N, J) bool; itypes (N,), jtypes (N, J) int64.
    Returns (site_e (N,), basis_members (N, n_scalar), rad (N, S, MU, RB),
    pair_t (N, J, 3) masked).
    """
    coeffs = _types.SimpleNamespace(radial_coeffs=radial_coeffs)
    with torch.enable_grad():
        d = disp.detach().requires_grad_(True)
        m_basic, aux = moments.basic_moments(sched, coeffs, d, mask, itypes, jtypes)
        mb = m_basic.detach().requires_grad_(True)
        m = moments.contract_dag(sched, mb)
        site = torch.sum(m * xi_full, dim=-1) + esp
        (gamma,) = torch.autograd.grad(site.sum(), mb)
        (pair_t,) = torch.autograd.grad(m_basic, d, gamma)
    w = mask.to(disp.dtype)
    pair_t = pair_t * w[..., None]
    m = m.detach()
    basis_members = m[:, torch.as_tensor(sched.mapping, device=m.device)]

    S, MU, RB = sched.species_count, sched.radial_funcs_count, sched.radial_basis_size
    # Gmu[n, j, mu] = sum_{k: mu_k = mu} gamma[n, k] U[n, j, k], each mu's
    # terms summed in one fixed order (no index_add: atomics on the card)
    perm, sizes = _mu_plan_on(sched, m.device)
    gu = (gamma[:, None, :] * aux["U"].detach())[..., perm]
    gmu = torch.stack([seg.sum(-1) for seg in gu.split(sizes, dim=-1)], dim=-1)
    jt_w = torch.nn.functional.one_hot(jtypes, S).to(m.dtype) * w[..., None]  # (N, J, S)
    cheb = aux["cheb"].detach()
    rad = torch.sum(
        (gmu[:, :, None, :, None] * jt_w[:, :, :, None, None]) * cheb[:, :, None, None, :],
        dim=1,
    )  # (N, S, MU, RB)
    return site.detach(), basis_members, rad, pair_t


def candidates_mega_plain(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp):
    """Plain PyTorch twin of K5 on the kernel's layouts, in float64 as the
    kernel computes; site energies and pair forces in the inputs' dtype."""
    K5.plain_calls += 1
    n = dispT.shape[2]
    f64 = torch.float64
    site, bm, rad, pair_t = candidate_terms(
        tables.sched, radial_coeffs.to(f64), dispT.permute(2, 1, 0).to(f64), (mask > 0).T,
        itypes.long(), jtypes_t.T.long(), xi_full.to(f64), esp.to(f64),
    )
    return dict(
        site_e=site.to(dispT.dtype), basis_members=bm, rad=rad.reshape(n, -1),
        pair_tT=pair_t.permute(2, 1, 0).to(dispT.dtype).contiguous(),
    )


def candidates_mega(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp):
    """One grade step's per-atom terms (see the module docstring): the plain
    twin on the CPU, the K5 kernel on the card."""
    if dispT.device.type == "cpu":
        return candidates_mega_plain(
            tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp
        )
    _check(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp)
    s = tables.sched
    _, j, n = dispT.shape
    n_scal = tables.mapping_i32.shape[0]
    n_rad = s.species_count * s.radial_funcs_count * s.radial_basis_size
    f64 = dict(dtype=torch.float64, device=dispT.device)
    out = dict(
        site_e=torch.empty((n,), dtype=torch.float32, device=dispT.device),
        basis_members=torch.empty((n, n_scal), **f64),
        rad=torch.empty((n, n_rad), **f64),
        pair_tT=torch.empty_like(dispT),
    )
    work = scratch(tables, dispT, torch.float64)
    K5.launch(
        dispT.data_ptr(), mask.data_ptr(), itypes.data_ptr(), jtypes_t.data_ptr(),
        radial_coeffs.data_ptr(), xi_full.data_ptr(), esp.data_ptr(),
        tables.tab.data_ptr(), tables.mapping_i32.data_ptr(),
        out["site_e"].data_ptr(), out["basis_members"].data_ptr(), out["rad"].data_ptr(),
        out["pair_tT"].data_ptr(), work.data_ptr(),
        n, j, s.species_count, s.radial_funcs_count, s.radial_basis_size,
        s.max_rank, s.basic_count, s.alpha_moments_count, tables.n_waves, tables.n_dag, n_scal,
        tables.shape, s.min_dist, s.max_dist, s.scaling,
        torch.cuda.current_stream(dispT.device).cuda_stream,
    )
    return out
