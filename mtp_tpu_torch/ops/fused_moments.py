"""Fused per-atom MTP chain: site energies (K4) and pair forces (K2).

Port of ``mtp_tpu/ops/pallas_moments.py``'s megakernels. Each entry point of
``csrc/fused_moments.cu`` runs the whole chain as its stage kernels: the
per-pair stage and the basic moments (one thread per atom), the product DAG
(one atom per lane), and the readout (K4) or the reverse DAG and the per-pair
force tail (K2), with the basic moments and their gradient in a (B, N)
scratch buffer between stages. K2 is K4's backward
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
_ARGS = (_P,) * 10 + (_I,) * 11 + (_F,) * 3 + (_P,)

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
    "basic", "shell_map", "fwd_wave", "fwd_target", "fwd_seg", "fwd_prod",
    "rev_wave", "rev_node", "rev_seg", "rev_ent",
)
_PACKED = ("fwd_prod", "rev_ent")  # (rows, 2) int32 read as int2: 8-byte aligned

# The kernels' specialised shapes (csrc/fused_moments.cu MTP_SHAPES): id ->
# the top rank R_mu of each radial function's basic moments. Level 8 and
# level 16 (make_mtp) are of this form; every other schedule runs the
# kernels' General instantiation (shape 0).
SHAPES = {1: (2, 0), 2: (6, 4, 2, 0)}


def monomials(rmax):
    """(ax, ay, az) of every unit-vector monomial of rank <= rmax in the
    kernels' order: rank-major, then ax and ay descending (``mono_ax``,
    ``mono_ay``). The monomials of rank <= r are its first n_mono(r)."""
    return [
        (ax, ay, r - ax - ay)
        for r in range(rmax + 1)
        for ax in range(r, -1, -1)
        for ay in range(r - ax, -1, -1)
    ]


def shell_ranks(sched: MTPSchedule):
    """R_mu of each radial function when the basic set is exactly every
    monomial of rank <= R_mu for mu = 0 .. MU-1 (each once), else None."""
    b = sched.basic
    ranks = []
    for mu in range(sched.radial_funcs_count):
        rows = b[b[:, 0] == mu]
        if len(rows) == 0:
            return None
        ranks.append(int(rows[:, 1:].sum(axis=1).max()))
    want = {(mu, *t) for mu, r in enumerate(ranks) for t in monomials(r)}
    if len(b) != len(want) or set(map(tuple, b.tolist())) != want:
        return None
    return tuple(ranks)


def shell_map(sched: MTPSchedule, ranks):
    """Schedule row k of each canonical term c = off(mu) + t, t the
    monomial's index in :func:`monomials` (mu-major)."""
    row = {tuple(r): k for k, r in enumerate(sched.basic.tolist())}
    return [row[(mu, *t)] for mu, r in enumerate(ranks) for t in monomials(r)]


@dataclasses.dataclass(frozen=True, eq=False)
class MegaTables:
    """The schedule as the kernels read it, built once per schedule and device.

    ``tab`` is one int32 tensor: a header of section offsets, then
      basic (B, 4)        mu, ax, ay, az of each basic moment;
      shell_map (B,)      schedule row of each canonical term (specialised
                          shapes; empty for the General instantiation);
      fwd_wave (W+1)      target-segment range of each DAG wave;
      fwd_target (T)      node each forward segment writes (unique per wave);
      fwd_seg (T+1)       product range of each target;
      fwd_prod (P, 2)     a0 | a1 << 16, mult of every product, by target;
      rev_wave (W+1)      node-segment range of each wave, reverse pass;
      rev_node (Q)        node each reverse segment writes (unique per wave);
      rev_seg (Q+1)       entry range of each node;
      rev_ent (E, 2)      a3 | other << 16, mult: dm[node] += mult*dm[a3]*m[other].
    Grouping by written node lets one thread own each sum, so duplicate
    targets accumulate in a fixed order without atomics. ``shape`` is the
    kernels' specialised shape id (:data:`SHAPES`), 0 for General;
    ``n_prod`` the DAG's products P (the reverse pass has 2P entries).
    """

    sched: MTPSchedule
    tab: torch.Tensor
    n_waves: int
    n_dag: int  # ints of the table from fwd_wave (even offset) to its (even) end
    shape: int
    n_prod: int
    mapping: torch.Tensor  # (n_scalar,) int64: moment slot of each coefficient
    mapping_i32: torch.Tensor  # the same slots as int32, for the K5 kernel


def _group(node, rows):
    """Stable-group `rows` by `node`: (unique nodes, segment offsets, rows),
    the segments longest first (the kernel's warps take a wave's segments
    round-robin; a segment's rows keep their order)."""
    order = np.argsort(node, kind="stable")
    node, rows = node[order], rows[order]
    uniq, starts = np.unique(node, return_index=True)
    ends = np.append(starts[1:], len(node))
    by_len = np.argsort(starts - ends, kind="stable")
    rows = np.concatenate([rows[starts[g]:ends[g]] for g in by_len]) if len(node) else rows
    lens = (ends - starts)[by_len]
    return uniq[by_len], np.concatenate([[0], np.cumsum(lens)]), rows


def _pack(rows):
    """(n, 3) rows (i0, i1, mult) -> (n, 2) int32 (i0 | i1 << 16, mult)."""
    rows = np.asarray(rows, np.int64).reshape(-1, 3)
    return np.stack([rows[:, 0] | (rows[:, 1] << 16), rows[:, 2]], axis=1)


def build_tables(sched: MTPSchedule, device) -> MegaTables:
    if sched.alpha_moments_count >= 1 << 16:
        raise ValueError("the kernels' DAG tables index moments in 16 bits")
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

    ranks = shell_ranks(sched)
    shape = next((k for k, v in SHAPES.items() if v == ranks), 0)
    sections = dict(
        basic=sched.basic.reshape(-1),
        shell_map=np.asarray(shell_map(sched, ranks) if shape else [], np.int64),
        fwd_wave=np.asarray(fwd_wave),
        fwd_target=cat(fwd_target),
        fwd_seg=cat(fwd_seg, tail=n_prod),
        fwd_prod=_pack(cat(fwd_prod)).reshape(-1),
        rev_wave=np.asarray(rev_wave),
        rev_node=cat(rev_node),
        rev_seg=cat(rev_seg, tail=n_ent),
        rev_ent=_pack(cat(rev_ent)).reshape(-1),
    )
    sections = {k: np.asarray(v, np.int32) for k, v in sections.items()}
    offsets, parts, pos = [], [], len(_SECTIONS)
    for name in _SECTIONS:
        if name in _PACKED and pos % 2:
            parts.append(np.zeros(1, np.int32))  # int2 alignment
            pos += 1
        offsets.append(pos)
        parts.append(sections[name])
        pos += len(sections[name])
    parts.append(np.zeros(pos % 2, np.int32))  # the DAG part copies as int2
    flat = np.concatenate([np.asarray(offsets, np.int32)] + parts)
    return MegaTables(
        sched=sched,
        tab=torch.as_tensor(flat, device=device),
        n_waves=len(waves),
        n_dag=len(flat) - (offsets[_SECTIONS.index("fwd_wave")] & ~1),
        shape=shape,
        n_prod=n_prod,
        mapping=torch.as_tensor(sched.mapping, device=device),
        mapping_i32=torch.as_tensor(sched.mapping.astype(np.int32), device=device),
    )


def resident_warps(tables, j) -> dict:
    """Resident warps per SM of each stage kernel for `tables`' schedule and
    `j` slots per atom (the specialised float tail's shared memory grows
    with J), by CUDA's occupancy calculator on the current device: the float stages of
    K2, K4, K6 and K7 (basic, tail, DAG) and K5's double stages ("K5 basic",
    "K5 tail + radial rows", "K5 DAG"); for each DAG its atoms per block and
    1 if it stages its table in shared memory (else it reads it through the
    read-only cache); "K5 specialised" is 1 when K5 runs its specialised
    stages for this schedule, "float specialised" 1 when the float basic
    and tail stages are the specialised ``float_kernel`` ones, each 0 for
    General. Builds the kernels; needs a card."""
    from mtp_tpu_torch.kernels._build import LIBRARY

    fn = LIBRARY.get().mtp_fused_occupancy
    fn.argtypes = (_I,) * 10 + (_P,)
    fn.restype = _I
    keys = ("basic", "tail", "DAG", "DAG atoms per block", "DAG table staged",
            "K5 basic", "K5 tail + radial rows", "K5 DAG", "K5 DAG atoms per block",
            "K5 DAG table staged", "K5 specialised", "float specialised")
    out = (ctypes.c_int * len(keys))()
    s = tables.sched
    err = fn(s.species_count, s.radial_funcs_count, s.radial_basis_size, s.max_rank,
             s.basic_count, s.alpha_moments_count, tables.n_dag, len(s.mapping), tables.shape,
             j, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"occupancy query failed: error {err}")
    return dict(zip(keys, out))


# ---------------------------------------------------------------- plain ----


def _site_energies_plain(sched, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp):
    disp = dispT.permute(2, 1, 0)  # (N, J, 3)
    coeffs = _types.SimpleNamespace(radial_coeffs=radial_coeffs)
    m_basic, _ = moments.basic_moments(
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


def _check(tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, per_atom,
           *, gamma=None):
    """Validate what a kernel of this family reads through raw pointers: the
    sizes it is passed come from `tables`' schedule, so every operand must
    match them. `xi_full`, `per_atom` (N,) and `gamma` (B, N) are checked
    where given."""
    s = tables.sched
    _, j, n = dispT.shape
    f32 = torch.float32
    ns, mu, rb = s.species_count, s.radial_funcs_count, s.radial_basis_size
    want = (
        (dispT, f32, (3, j, n)), (mask, f32, (j, n)), (itypes, torch.int32, (n,)),
        (jtypes_t, torch.int32, (j, n)), (radial_coeffs, f32, (ns, ns, mu, rb)),
        (tables.tab, torch.int32, tables.tab.shape),
    )
    if xi_full is not None:
        want += ((xi_full, f32, (s.alpha_moments_count,)),)
    if per_atom is not None:
        want += ((per_atom, f32, (n,)),)
    if gamma is not None:
        want += ((gamma, f32, (s.basic_count, n)),)
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"fused moments kernel takes contiguous {dtype} {tuple(shape)}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != dispT.device:
            raise ValueError("fused moments kernel inputs must share one device")


def scratch(tables, dispT, dtype=torch.float32):
    """The (B, N) buffer that carries the basic moments and their gradient
    between a fused entry point's stage kernels (float64 for K5)."""
    n = dispT.shape[2]
    return torch.empty((tables.sched.basic_count, n), dtype=dtype, device=dispT.device)


def _launch(kernel, tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, per_atom, out,
            work=None):
    s = tables.sched
    _, j, n = dispT.shape
    kernel.launch(
        dispT.data_ptr(), mask.data_ptr(), itypes.data_ptr(), jtypes_t.data_ptr(),
        radial_coeffs.data_ptr(), 0 if xi_full is None else xi_full.data_ptr(),
        0 if per_atom is None else per_atom.data_ptr(),
        tables.tab.data_ptr(), out.data_ptr(), 0 if work is None else work.data_ptr(),
        n, j, s.species_count, s.radial_funcs_count, s.radial_basis_size,
        s.max_rank, s.basic_count, s.alpha_moments_count, tables.n_waves, tables.n_dag,
        tables.shape, s.min_dist, s.max_dist, s.scaling,
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
            K4, tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, esp, out,
            scratch(tables, dispT),
        )

    @staticmethod
    def backward(ctx, de):
        dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full = ctx.saved_tensors
        de = de.contiguous()
        _check(ctx.tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de)
        out = torch.empty_like(dispT)
        pair = _launch(
            K2, ctx.tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de, out,
            scratch(ctx.tables, dispT),
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
        K2, tables, dispT, mask, itypes, jtypes_t, radial_coeffs, xi_full, de, out,
        scratch(tables, dispT),
    )
