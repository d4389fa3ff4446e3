"""Basic moments alone (K6) and their vjp (K7), and the modular energy path
built on them.

Port of ``mtp_tpu/ops/pallas_moments.py:196 _fwd_kernel`` and :219
``_bwd_kernel``: :func:`basic_moments_fused` (``:271``) is a
``torch.autograd.Function`` whose forward is K6 and whose backward is K7 (pair
forces from a given gamma = dE/d(basic moments), a cotangent for dispT only,
as ``_fused_bwd`` :330). Both are stage kernels of ``csrc/fused_moments.cu``:
K6 is the basic stage of the fused chain (per-pair stage and basic moments),
writing m[:B] as (B, N); K7 is its tail stage (per-pair stage with
derivatives and force tail), reading gamma (B, N) from memory. For the
specialised shapes (levels 8 and 16) both run ``float_kernel``, the other
schedules the General ``pair_kernel``. :func:`site_energies_fused`
(``:799``) adds the product DAG as plain torch (:func:`contract_dag_t`) and
the readout.

Layouts as in :mod:`mtp_tpu_torch.ops.fused_moments`. On CPU tensors the
Function runs the plain twins (:func:`basic_moments_fused_plain` forward,
:func:`basic_moments_vjp_plain` backward, also callable alone as
:func:`basic_moments_vjp`); on CUDA tensors the kernels; any other device
raises.
"""

from __future__ import annotations

import types as _types

import torch

from mtp_tpu_torch.kernels._build import Kernel
from mtp_tpu_torch.ops import moments
from mtp_tpu_torch.ops.fused_moments import _ARGS, _check, _launch

K6 = Kernel(
    name="basic_moments_fused",
    symbol="mtp_basic_moments_fused",
    source="mtp_tpu_torch/csrc/fused_moments.cu",
    replaces="mtp_tpu/ops/pallas_moments.py:196",
    argtypes=_ARGS,
)
K7 = Kernel(
    name="basic_moments_vjp",
    symbol="mtp_basic_moments_vjp",
    source="mtp_tpu_torch/csrc/fused_moments.cu",
    replaces="mtp_tpu/ops/pallas_moments.py:219",
    argtypes=_ARGS,
)


def _basic_t(sched, dispT, mask, itypes, jtypes_t, radial_coeffs):
    m_basic, _ = moments.basic_moments(
        sched, _types.SimpleNamespace(radial_coeffs=radial_coeffs), dispT.permute(2, 1, 0),
        (mask > 0).T, itypes.long(), jtypes_t.T.long(),
    )
    return m_basic.T  # (B, N)


def basic_moments_fused_plain(tables, dispT, mask, itypes, jtypes_t, radial_coeffs):
    """Plain PyTorch twin of K6: basic moments (B, N)."""
    K6.plain_calls += 1
    return _basic_t(tables.sched, dispT, mask, itypes, jtypes_t, radial_coeffs)


def basic_moments_vjp_plain(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, gamma):
    """Plain PyTorch twin of K7: pair_T (3, J, N) = gamma . d(basic
    moments)/d(dispT), masked; gamma is (B, N)."""
    K7.plain_calls += 1
    with torch.enable_grad():
        d = dispT.detach().requires_grad_(True)
        mb = _basic_t(tables.sched, d, mask, itypes, jtypes_t, radial_coeffs)
        (g,) = torch.autograd.grad(mb, d, gamma)
    return g * mask[None]


class _BasicMomentsFused(torch.autograd.Function):
    """K6 forward, K7 backward; only dispT gets a cotangent."""

    @staticmethod
    def forward(ctx, dispT, mask, itypes, jtypes_t, radial_coeffs, tables):
        ctx.tables = tables
        ctx.save_for_backward(dispT, mask, itypes, jtypes_t, radial_coeffs)
        if dispT.device.type == "cpu":
            return basic_moments_fused_plain(tables, dispT, mask, itypes, jtypes_t, radial_coeffs)
        _check(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, None, None)
        out = torch.empty(
            (tables.sched.basic_count, dispT.shape[2]), dtype=torch.float32, device=dispT.device
        )
        return _launch(K6, tables, dispT, mask, itypes, jtypes_t, radial_coeffs, None, None, out)

    @staticmethod
    def backward(ctx, gamma):
        dispT, mask, itypes, jtypes_t, radial_coeffs = ctx.saved_tensors
        pair = basic_moments_vjp(
            ctx.tables, dispT, mask, itypes, jtypes_t, radial_coeffs, gamma.contiguous()
        )
        return (pair,) + (None,) * 5


def basic_moments_fused(tables, dispT, mask, itypes, jtypes_t, radial_coeffs):
    """Basic moments, feature-major (B, N); differentiable w.r.t. dispT."""
    return _BasicMomentsFused.apply(dispT, mask, itypes, jtypes_t, radial_coeffs, tables)


def basic_moments_vjp(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, gamma):
    """pair_T (3, J, N) = gamma . d(basic moments)/d(dispT) for a given
    gamma (B, N): the backward of :func:`basic_moments_fused`, callable
    alone."""
    if dispT.device.type == "cpu":
        return basic_moments_vjp_plain(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, gamma)
    _check(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, None, None, gamma=gamma)
    return _launch(
        K7, tables, dispT, mask, itypes, jtypes_t, radial_coeffs, None, gamma,
        torch.empty_like(dispT),
    )


def contract_dag_t(sched, m_basic_t):
    """Moments (M, N) from basic moments (B, N), wave by wave; duplicate
    targets sum in a fixed order (the feature-major twin of
    :func:`~mtp_tpu_torch.ops.moments.contract_dag`). Index operations, no
    matrix product."""
    return moments.contract_moments(sched, m_basic_t, 0)


def site_energies_fused(tables, coeffs, dispT, mask, itypes, jtypes_t):
    """Per-atom energies (N,) through K6 and the plain DAG and readout;
    differentiable w.r.t. dispT (K7)."""
    mb = basic_moments_fused(tables, dispT, mask, itypes, jtypes_t, coeffs.radial_coeffs)
    basis_members = contract_dag_t(tables.sched, mb)[tables.mapping]  # (n_scalar, N)
    e = torch.sum(coeffs.moment_coeffs[:, None] * basis_members, dim=0)
    return e + coeffs.species_coeffs[itypes.long()]
