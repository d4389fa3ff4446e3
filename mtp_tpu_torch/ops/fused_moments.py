"""Fused per-atom MTP chain: site energies (K4) and pair forces (K2).

Port of ``mtp_tpu/ops/pallas_moments.py``'s megakernels. Each CUDA kernel
(``csrc/fused_moments.cu``) runs the whole chain for one atom per warp: the
per-pair stage, the basic moments, the product DAG, and the readout (K4) or
the reverse DAG and the per-pair force tail (K2). K2 is K4's backward
(:class:`_SiteEnergiesMega`), as ``site_energies_mega.defvjp`` makes
``_mega_bwd_kernel`` the vjp of ``_mega_fwd_kernel`` in the JAX package, and
it also runs alone (:func:`pair_forces_mega`) for force-only MD steps.

Layouts follow the JAX kernels: dispT (3, J, N), mask (J, N) float 0/1,
itypes (N,) int32, jtypes_t (J, N) int32, radial coefficients (S, S, MU, RB);
the readout vector xi_full (M,) holds the moment coefficients at their moment
slots (zeros elsewhere) and esp (N,) the per-atom species energies.

Each wrapper dispatches on the tensor's device: CPU tensors go to the plain
PyTorch version (the autograd vjp of :func:`mtp_tpu_torch.ops.moments`
building blocks), CUDA tensors to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import types as _types

import numpy as np
import torch

from mtp_tpu_torch.kernels._build import Kernel
from mtp_tpu_torch.ops import moments
from mtp_tpu_torch.ops.moments import MTPSchedule

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGS = (_P,) * 9 + (_I,) * 9 + (_F,) * 3 + (_P,)

K4 = Kernel(
    name="site_energies_mega",
    symbol="mtp_site_energies_mega",
    source="mtp_tpu_torch/csrc/fused_moments.cu",
    replaces="mtp_tpu/ops/pallas_moments.py:439",
    argtypes=_ARGS,
)
K2 = Kernel(
    name="pair_forces_mega",
    symbol="mtp_pair_forces_mega",
    source="mtp_tpu_torch/csrc/fused_moments.cu",
    replaces="mtp_tpu/ops/pallas_moments.py:463",
    argtypes=_ARGS,
)

# section order of the int32 table header (csrc/fused_moments.cu, enum)
_SECTIONS = (
    "basic", "fwd_wave", "fwd_target", "fwd_seg", "fwd_prod",
    "rev_wave", "rev_node", "rev_seg", "rev_ent",
)


@dataclasses.dataclass(frozen=True, eq=False)
class MegaTables:
    """The schedule as the kernels read it, built once per schedule and device.

    ``tab`` is one int32 tensor: a header of section offsets, then
      basic (B, 4)        mu, ax, ay, az of each basic moment;
      fwd_wave (W+1)      target-segment range of each DAG wave;
      fwd_target (T)      node each forward segment writes (unique per wave);
      fwd_seg (T+1)       product range of each target;
      fwd_prod (P, 3)     a0, a1, mult of every product, grouped by target;
      rev_wave (W+1)      node-segment range of each wave, reverse pass;
      rev_node (Q)        node each reverse segment writes (unique per wave);
      rev_seg (Q+1)       entry range of each node;
      rev_ent (E, 3)      a3, other input, mult: dm[node] += mult*dm[a3]*m[other].
    Grouping by written node lets one lane own each sum, so duplicate
    targets accumulate in a fixed order without atomics.
    """

    sched: MTPSchedule
    tab: torch.Tensor
    n_waves: int
    mapping: torch.Tensor  # (n_scalar,) int64: moment slot of each coefficient


def _group(node, rows):
    """Stable-group `rows` by `node`: (unique nodes, segment offsets, rows)."""
    order = np.argsort(node, kind="stable")
    node, rows = node[order], rows[order]
    uniq, starts = np.unique(node, return_index=True)
    return uniq, np.append(starts, len(node)), rows


def build_tables(sched: MTPSchedule, device) -> MegaTables:
    waves = sched.waves()
    fwd_wave, fwd_target, fwd_seg, fwd_prod = [0], [], [], []
    rev_wave, rev_node, rev_seg, rev_ent = [0], [], [], []
    n_prod = n_ent = 0
    for wv in waves:
        a0, a1, mult, a3 = (wv[:, k] for k in range(4))
        tg, seg, rows = _group(a3, np.stack([a0, a1, mult], axis=1))
        fwd_target.append(tg)
        fwd_seg.append(seg[:-1] + n_prod)
        fwd_prod.append(rows)
        n_prod += len(rows)
        fwd_wave.append(fwd_wave[-1] + len(tg))
        # reverse: each product feeds both of its inputs (twice a0 == a1)
        node = np.concatenate([a0, a1])
        ent = np.concatenate(
            [np.stack([a3, a1, mult], 1), np.stack([a3, a0, mult], 1)]
        )
        rn, rseg, rows = _group(node, ent)
        rev_node.append(rn)
        rev_seg.append(rseg[:-1] + n_ent)
        rev_ent.append(rows)
        n_ent += len(rows)
        rev_wave.append(rev_wave[-1] + len(rn))

    def cat(parts, tail=None):
        parts = [np.asarray(p, np.int64).reshape(-1) for p in parts]
        if tail is not None:
            parts.append(np.asarray([tail], np.int64))
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    sections = dict(
        basic=sched.basic.reshape(-1),
        fwd_wave=np.asarray(fwd_wave),
        fwd_target=cat(fwd_target),
        fwd_seg=cat(fwd_seg, tail=n_prod),
        fwd_prod=cat(fwd_prod),
        rev_wave=np.asarray(rev_wave),
        rev_node=cat(rev_node),
        rev_seg=cat(rev_seg, tail=n_ent),
        rev_ent=cat(rev_ent),
    )
    sections = {k: np.asarray(v, np.int32) for k, v in sections.items()}
    offsets, pos = [], len(_SECTIONS)
    for name in _SECTIONS:
        offsets.append(pos)
        pos += len(sections[name])
    flat = np.concatenate(
        [np.asarray(offsets, np.int32)] + [sections[k] for k in _SECTIONS]
    )
    return MegaTables(
        sched=sched,
        tab=torch.as_tensor(flat, device=device),
        n_waves=len(waves),
        mapping=torch.as_tensor(sched.mapping, device=device),
    )


# ---------------------------------------------------------------- plain ----


def _site_energies_plain(sched, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp):
    disp = dispT.permute(2, 1, 0)  # (N, J, 3)
    coeffs = _types.SimpleNamespace(radial_coeffs=radial_coeffs)
    m_basic = moments.basic_moments(
        sched, coeffs, disp, (mask > 0).T, itypes.long(), jtypes_t.T.long()
    )
    m = moments.contract_dag(sched, m_basic)
    return m @ xi_full + esp


def site_energies_mega_plain(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp):
    """Plain PyTorch twin of K4 (differentiable through autograd)."""
    K4.plain_calls += 1
    return _site_energies_plain(
        tables.sched, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp
    )


def pair_forces_mega_plain(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de=None):
    """Plain PyTorch twin of K2: the autograd vjp of the site energies."""
    K2.plain_calls += 1
    with torch.enable_grad():
        d = dispT.detach().requires_grad_(True)
        e = _site_energies_plain(
            tables.sched, d, mask, itypes, jtypes_t, radial_coeffs, xi_full,
            torch.zeros_like(xi_full[:1]),
        )
        (g,) = torch.autograd.grad(e.sum() if de is None else (e * de).sum(), d)
    return g * mask[None]


# --------------------------------------------------------------- kernels ----


def _check(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, per_atom):
    """Validate what the kernel reads through raw pointers: the sizes it is
    passed come from `tables`' schedule, so every operand must match them."""
    s = tables.sched
    _, j, n = dispT.shape
    f32 = torch.float32
    ns, mu, rb = s.species_count, s.radial_funcs_count, s.radial_basis_size
    want = (
        (dispT, f32, (3, j, n)), (mask, f32, (j, n)), (itypes, torch.int32, (n,)),
        (jtypes_t, torch.int32, (j, n)), (radial_coeffs, f32, (ns, ns, mu, rb)),
        (xi_full, f32, (s.alpha_moments_count,)), (tables.tab, torch.int32, tables.tab.shape),
    )
    if per_atom is not None:
        want += ((per_atom, f32, (n,)),)
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"fused moments kernel takes contiguous {dtype} {tuple(shape)}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != dispT.device:
            raise ValueError("fused moments kernel inputs must share one device")


def _launch(kernel, tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, per_atom, out):
    s = tables.sched
    _, j, n = dispT.shape
    kernel.launch(
        dispT.data_ptr(), mask.data_ptr(), itypes.data_ptr(), jtypes_t.data_ptr(),
        radial_coeffs.data_ptr(), xi_full.data_ptr(),
        0 if per_atom is None else per_atom.data_ptr(),
        tables.tab.data_ptr(), out.data_ptr(),
        n, j, s.species_count, s.radial_funcs_count, s.radial_basis_size,
        s.max_rank, s.basic_count, s.alpha_moments_count, tables.n_waves,
        s.min_dist, s.max_dist, s.scaling,
        torch.cuda.current_stream(dispT.device).cuda_stream,
    )
    return out


class _SiteEnergiesMega(torch.autograd.Function):
    """K4 forward, K2 backward (dE/d dispT = de_i * pair forces)."""

    @staticmethod
    def forward(ctx, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp, tables):
        ctx.tables = tables
        ctx.save_for_backward(dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full)
        out = torch.empty((dispT.shape[2],), dtype=torch.float32, device=dispT.device)
        return _launch(
            K4, tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp, out
        )

    @staticmethod
    def backward(ctx, de):
        dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full = ctx.saved_tensors
        de = de.contiguous()
        _check(ctx.tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de)
        out = torch.empty_like(dispT)
        pair = _launch(
            K2, ctx.tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de, out
        )
        return (pair,) + (None,) * 7


def site_energies_mega(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp):
    """Per-atom site energies (N,); differentiable w.r.t. dispT (K2)."""
    if dispT.device.type == "cpu":
        return site_energies_mega_plain(
            tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp
        )
    _check(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp)
    return _SiteEnergiesMega.apply(
        dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp, tables
    )


def pair_forces_mega(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de=None):
    """pair_T (3, J, N) = d(sum_i de_i site_e_i)/d(dispT), de = 1 by default,
    WITHOUT the forward energy kernel: K2 rebuilds the per-pair stage and the
    DAG itself (the reference's eflag economics, pair_mtp.cpp:72-90)."""
    if dispT.device.type == "cpu":
        return pair_forces_mega_plain(
            tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de
        )
    _check(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de)
    out = torch.empty_like(dispT)
    return _launch(
        K2, tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de, out
    )
