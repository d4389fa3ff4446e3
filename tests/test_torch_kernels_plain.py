"""The plain PyTorch twins of the port's CUDA kernels against mtp_tpu's TPU
kernels, run as mtp_tpu's own tests run them on the CPU: float64, Pallas in
interpret mode. Inputs are made with numpy from a seed and passed to both
packages; results are compared in one layout.

Tolerance: 1e-10 absolute (eV for energies, eV/A for forces, A for
displacements). Both sides compute the same float64 function in another
order of operations, which leaves differences near 1e-13.

On the CPU every wrapper takes its plain version: the kernels' launch counters
stay at 0 (the CUDA kernels themselves are checked on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.md.simulation import make_lattice
from mtp_tpu.models.mtp import (
    MTPModel as JaxModel,
    _window_forces_from_pairs,
    _window_geometry as geometry_jax,
    gather_displacements as gather_jax,
    readout_vector as readout_jax,
    window_constants as constants_jax,
)
from mtp_tpu.ops.neighbors import build_sorted_neighbor_list as sorted_jax
from mtp_tpu.ops.neighbors import grid_shape
from mtp_tpu.ops.pallas_moments import basic_moments_fused as bmf_jax
from mtp_tpu.ops.pallas_moments import candidates_mega as cand_jax
from mtp_tpu.ops.pallas_moments import pair_forces_mega as pf_jax
from mtp_tpu.ops.pallas_moments import site_energies_mega as se_jax
from mtp_tpu.ops.window_giveback import giveback_reference
from mtp_tpu_torch.kernels import all_kernels, main_path_kernels
from mtp_tpu_torch.models.mtp import readout_vector
from mtp_tpu_torch.ops import moments
from mtp_tpu_torch.ops.fused_basic import (
    basic_moments_fused,
    basic_moments_vjp_plain,
    site_energies_fused,
)
from mtp_tpu_torch.ops.fused_candidates import candidates_mega
from mtp_tpu_torch.ops.fused_moments import (
    build_tables,
    pair_forces_mega,
    site_energies_mega,
)
from mtp_tpu_torch.ops.window_disp import inverse_cell, window_geometry
from mtp_tpu_torch.ops.window_giveback import mirror_offsets, window_giveback
from mtp_tpu_torch.utils.convert import model_from_jax

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-10


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.fixture(scope="module")
def jitter_box():
    """864-atom fcc box, jittered: numpy positions + the JAX sorted list with
    octant-aligned slots (its `rev` feeds giveback_reference)."""
    pos, _, cell = make_lattice("fcc", 4.0, (6, 6, 6))
    rng = np.random.default_rng(0)
    pos = pos + rng.normal(0, 0.12, pos.shape)
    grid = grid_shape(cell, 5.6)
    swl = sorted_jax(
        jnp.asarray(pos), jnp.asarray(cell), 5.6, max_neighbors=64, grid=grid,
        align_slots=True,
    )
    assert not bool(swl.overflow)
    return pos, cell, swl


@pytest.fixture(scope="module")
def tri_box():
    """The 864-atom box sheared into a triclinic cell (b tilted along x by
    0.2 of a), jittered, with the JAX sorted list (no slot alignment)."""
    pos, _, cell = make_lattice("fcc", 4.0, (6, 6, 6))
    tri = cell.copy()
    tri[1, 0] = 0.2 * cell[0, 0]
    pos = pos @ np.linalg.inv(cell) @ tri + np.random.default_rng(1).normal(0, 0.12, pos.shape)
    swl = sorted_jax(jnp.asarray(pos), jnp.asarray(tri), 5.6, max_neighbors=64,
                     grid=grid_shape(tri, 5.6))
    assert not bool(swl.overflow)
    return pos, tri, swl


@pytest.mark.parametrize("box", ["jitter_box", "tri_box"], ids=["orthorhombic", "triclinic"])
def test_window_disp_matches_jax_kernel(box, mtp_level8_2spec, request):
    """K1's plain twin, (dispT, maskf), against the JAX window geometry (its
    interpreted displacement kernel over the window worklists, and its
    mask) on the JAX list and rebuild constants, padding rows included.
    The masks are equal; the displacements agree to 1e-10 A (the cell
    inverses differ in their last bits)."""
    pos, cell, swl = request.getfixturevalue(box)
    jm = JaxModel.from_data(mtp_level8_2spec, dtype=jnp.float64)
    types = np.zeros(len(pos), np.int32)
    k = constants_jax(jm.schedule, jm.coeffs, jnp.asarray(types), swl, jnp.float64)
    pos_s, want_d, want_m = geometry_jax(jm.schedule, jnp.asarray(pos), jnp.asarray(cell), swl,
                                         k["pair_valid_t"], False)
    got_d, got_m = window_geometry(_t(pos_s), _t(swl.window_idx, torch.int32).T.contiguous(),
                                   _t(cell), _t(k["pair_valid_t"], torch.bool), jm.cutoff)
    assert got_d.shape == want_d.shape and got_m.shape == want_m.shape
    assert np.max(np.abs(got_d.numpy() - np.asarray(want_d))) < TOL
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_m.dtype == torch.float64 and 20 < float(got_m.sum()) / len(pos) < 60


def test_window_disp_matches_gather_displacements(jitter_box):
    """The same on the unpadded list against the plain JAX gather and the
    mask rule of mtp_tpu/models/mtp.py:397-400 (cutoff 5.0 A)."""
    pos, cell, swl = jitter_box
    n = len(pos)
    spos = pos[np.asarray(swl.order)]
    idx = np.asarray(swl.idx)[:n]
    ref = np.asarray(
        gather_jax(jnp.asarray(spos), jnp.asarray(idx), jnp.asarray(cell),
                   jnp.linalg.inv(jnp.asarray(cell)))
    )
    ref_t = np.moveaxis(ref, (0, 1, 2), (2, 1, 0))
    valid_t = (idx != np.arange(n)[:, None]).T
    got_d, got_m = window_geometry(_t(spos), _t(idx.T, torch.int32), _t(cell), _t(valid_t),
                                   5.0)
    assert np.max(np.abs(got_d.numpy() - ref_t)) < TOL
    d2 = ref_t[0] ** 2 + ref_t[1] ** 2 + ref_t[2] ** 2
    np.testing.assert_array_equal(got_m.numpy(), ((d2 <= 25.0) & valid_t).astype(np.float64))


def test_cell_inverse_matches_inverse_cell():
    """The port's closed-form cell inverse (adjugate over determinant, K1's
    and every other caller's) against LAPACK's LU inverse and mtp_tpu's
    jnp.linalg.inv, float64: orthorhombic, the triclinic cell of tri_box,
    and a general cell, to 1e-15 of the largest entry."""
    ortho = np.diag([24.0, 25.5, 23.25])
    tri = ortho.copy()
    tri[1, 0] = 4.8
    gen = np.array([[10.0, 0.5, -0.3], [1.0, 11.0, 0.2], [0.4, -1.2, 12.0]])
    for cell in (ortho, tri, gen):
        got = inverse_cell(_t(cell))
        for want in (torch.linalg.inv(_t(cell)), _t(jnp.linalg.inv(jnp.asarray(cell)))):
            assert float((got - want).abs().max()) <= 1e-15 * float(want.abs().max())


def _random_pairs(rng, n, j, species):
    """dispT (3, J, N) with real pairs at 1.8-5.3 A, pairs beyond the 5.0 A
    cutoff, and zero-displacement pads; mask, types."""
    u = rng.normal(size=(3, j, n))
    u /= np.linalg.norm(u, axis=0, keepdims=True)
    r = rng.uniform(1.8, 5.3, size=(j, n))
    dispT = u * r
    pads = rng.uniform(size=(j, n)) < 0.15
    dispT[:, pads] = 0.0
    mask = ((r <= 5.0) & ~pads).astype(np.float64)
    it = rng.integers(0, species, n).astype(np.int32)
    jt = rng.integers(0, species, (j, n)).astype(np.int32)
    jt[pads] = np.broadcast_to(it, (j, n))[pads]
    return dispT, mask, it, jt


@pytest.fixture(scope="module")
def mega_case(mtp_level8_2spec):
    jm = JaxModel.from_data(mtp_level8_2spec, dtype=jnp.float64)
    tm = model_from_jax(jm, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(11)
    n, j = 256, 64  # one 256-atom tile of the JAX megakernel
    dispT, mask, it, jt = _random_pairs(rng, n, j, 2)
    esp = rng.normal(size=n) * 0.1
    return jm, tm, dispT, mask, it, jt, esp


def _jax_args(jm, dispT, mask, it, jt):
    return (
        jm.schedule, jnp.asarray(dispT), jnp.asarray(mask), jnp.asarray(it)[None, :],
        jnp.asarray(jt), jm.coeffs.radial_coeffs,
        readout_jax(jm.schedule, jm.coeffs, jnp.float64),
    )


def _torch_args(tm, dispT, mask, it, jt):
    return (
        tm.tables, _t(dispT), _t(mask), _t(it, torch.int32), _t(jt, torch.int32),
        tm.coeffs.radial_coeffs, readout_vector(tm),
    )


def test_site_energies_mega_matches_jax_kernel(mega_case):
    jm, tm, dispT, mask, it, jt, esp = mega_case
    want = np.asarray(se_jax(*_jax_args(jm, dispT, mask, it, jt), jnp.asarray(esp)[None, :]))
    got = site_energies_mega(*_torch_args(tm, dispT, mask, it, jt), _t(esp)).numpy()
    assert np.max(np.abs(got - want)) < TOL


def test_pair_forces_mega_matches_jax_kernel(mega_case):
    jm, tm, dispT, mask, it, jt, _ = mega_case
    want = np.asarray(pf_jax(*_jax_args(jm, dispT, mask, it, jt)))
    got = pair_forces_mega(*_torch_args(tm, dispT, mask, it, jt)).numpy()
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) < TOL


def test_pair_forces_mega_weighted_vjp_matches_jax(mega_case):
    """K2 as K4's backward: a non-unit cotangent de, against jax.vjp of the
    JAX megakernel (its custom vjp runs _mega_bwd_kernel)."""
    import jax

    jm, tm, dispT, mask, it, jt, esp = mega_case
    de = np.random.default_rng(5).normal(size=dispT.shape[2])
    args = _jax_args(jm, dispT, mask, it, jt)
    _, vjp = jax.vjp(
        lambda d: se_jax(args[0], d, *args[2:], jnp.asarray(esp)[None, :]),
        jnp.asarray(dispT),
    )
    (want,) = vjp(jnp.asarray(de))
    targs = _torch_args(tm, dispT, mask, it, jt)
    got = pair_forces_mega(*targs, de=_t(de)).numpy()
    assert np.max(np.abs(got - np.asarray(want))) < TOL
    # the differentiable wrapper's gradient is the same function
    d = targs[1].clone().requires_grad_(True)
    e = site_energies_mega(targs[0], d, *targs[2:], _t(esp))
    (g,) = torch.autograd.grad((e * _t(de)).sum(), d)
    assert np.max(np.abs((g * targs[2][None]).numpy() - got)) < TOL


def _sections(tables):
    """Cut the kernels' int32 table at its header's section offsets, each
    section as long as the kernels read it: its length follows from the
    schedule and the sections before it. Each section ends at the next
    offset, or one int before it where an int2 alignment pad follows."""
    from mtp_tpu_torch.ops.fused_moments import _SECTIONS, SHAPES, shell_ranks

    tab = tables.tab.numpy()
    s = tables.sched
    special = shell_ranks(s) in SHAPES.values()  # built with a shell map
    off = [int(tab[i]) for i in range(len(_SECTIONS))] + [len(tab)]
    got = {}

    def cut(k, n):
        i = _SECTIONS.index(k)
        got[k] = tab[off[i] : off[i] + n]
        assert off[i + 1] - (off[i] + n) in (0, 1), k
        return got[k]

    cut("basic", 4 * s.basic_count)
    cut("shell_map", s.basic_count if special else 0)
    for d, node, ent in (("fwd", "target", "prod"), ("rev", "node", "ent")):
        n_seg = cut(f"{d}_wave", tables.n_waves + 1)[-1]
        cut(f"{d}_{node}", n_seg)
        cut(f"{d}_{ent}", 2 * cut(f"{d}_seg", n_seg + 1)[-1])
    np.testing.assert_array_equal(got["basic"], s.basic.reshape(-1))
    assert len(got["fwd_prod"]) == 2 * tables.n_prod
    assert len(got["rev_ent"]) == 4 * tables.n_prod
    return got


def _unpack(rows):
    """(n, 2) int32 (i0 | i1 << 16, mult) as the kernels read it: i0, i1, mult."""
    rows = rows.reshape(-1, 2).astype(np.int64)
    return np.stack([rows[:, 0] & 0xFFFF, rows[:, 0] >> 16, rows[:, 1]], axis=1)


def _walk_forward(sec, n_waves, m):
    """The K4/K2 forward DAG as the CUDA kernel walks its tables."""
    m = m.copy()
    fw, tg, seg, pr = (sec[k] for k in ("fwd_wave", "fwd_target", "fwd_seg", "fwd_prod"))
    pr = _unpack(pr)
    for w in range(n_waves):
        upd = {}
        for t in range(fw[w], fw[w + 1]):
            acc = 0.0
            for p in range(seg[t], seg[t + 1]):
                acc += m[pr[p, 0]] * m[pr[p, 1]] * pr[p, 2]
            upd[tg[t]] = acc
        for node, acc in upd.items():
            m[node] += acc
    return m


def _walk_reverse(sec, n_waves, m, dm):
    dm = dm.copy()
    rw, nd, seg, ent = (sec[k] for k in ("rev_wave", "rev_node", "rev_seg", "rev_ent"))
    ent = _unpack(ent)
    for w in range(n_waves - 1, -1, -1):
        upd = {}
        for t in range(rw[w], rw[w + 1]):
            acc = 0.0
            for p in range(seg[t], seg[t + 1]):
                acc += dm[ent[p, 0]] * m[ent[p, 1]] * ent[p, 2]
            upd[nd[t]] = acc
        for node, acc in upd.items():
            dm[node] += acc
    return dm


@pytest.mark.parametrize("level", [8, 16])
def test_dag_tables_reproduce_contract_dag_and_its_vjp(level):
    """The kernels' grouped product tables (no atomics) give the same moments
    as the wave-by-wave index_add DAG, and the same gradient as autograd."""
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.models.mtp import MTPModel

    tm = MTPModel.from_data(make_mtp(level, seed=2), device="cpu", dtype=torch.float64)
    s = tm.schedule
    tables = build_tables(s, "cpu")
    assert int(tables.tab[0]) == 10  # header length of csrc/fused_moments.cu
    rng = np.random.default_rng(level)
    mb = rng.normal(size=s.basic_count) * 0.5
    m0 = np.zeros(s.alpha_moments_count)
    m0[: s.basic_count] = mb
    sec = _sections(tables)
    m_walk = _walk_forward(sec, tables.n_waves, m0)
    mb_t = _t(mb[None]).requires_grad_(True)
    m_ref = moments.contract_dag(s, mb_t)
    np.testing.assert_allclose(m_walk, m_ref.detach().numpy()[0], rtol=1e-12, atol=1e-12)
    xi = readout_vector(tm).numpy()
    dm = _walk_reverse(sec, tables.n_waves, m_walk, xi)
    (g,) = torch.autograd.grad((m_ref[0] * _t(xi)).sum(), mb_t)
    np.testing.assert_allclose(dm[: s.basic_count], g.numpy()[0], rtol=1e-12, atol=1e-12)


def test_giveback_matches_jax_reference_and_mirror_path(jitter_box):
    """K3's plain twin, sum_s T(i,s) - T(mirror) through the mirror offsets
    mirror_t, against the JAX give-back
    reference (own sum minus giveback_reference over `rev`) and against the
    JAX flat-mirror force assembly."""
    _, _, swl = jitter_box
    n_pad, j = swl.idx.shape
    rng = np.random.default_rng(3)
    real = np.asarray(swl.idx) != np.arange(n_pad)[:, None]
    pair_T = rng.normal(size=(3, j, n_pad)) * real.T[None]
    want_gb = pair_T.sum(axis=1) - np.asarray(
        giveback_reference(jnp.asarray(pair_T), swl.idx, swl.rev)
    )
    want_mirror = np.asarray(
        _window_forces_from_pairs(jnp.asarray(pair_T), dataclasses.replace(swl, gb=None))
    )
    mirror_t = mirror_offsets(_t(swl.mirror, torch.int32), n_pad, j)
    got = window_giveback(_t(pair_T), mirror_t).numpy()
    assert got.shape == (n_pad, 3)
    assert np.max(np.abs(got - want_gb.T)) < TOL
    assert np.max(np.abs(got - want_mirror)) < TOL


def test_mirror_offsets_address_the_flat_mirror(jitter_box):
    """mirror_t[s, i] reaches, in pair_T's (3, J, N) layout, the entry that
    the flat mirror permutation reaches in the (N, J, 3) layout; and a
    mirror's mirror is the pair itself."""
    _, _, swl = jitter_box
    n, j = swl.idx.shape
    mirror = _t(swl.mirror, torch.int32)
    mirror_t = mirror_offsets(mirror, n, j)
    assert mirror_t.dtype == torch.int32 and mirror_t.shape == (j, n)
    pair_T = _t(np.random.default_rng(8).normal(size=(3, j, n)))
    flat = pair_T.permute(2, 1, 0).reshape(-1, 3)[mirror.long()].reshape(n, j, 3)
    np.testing.assert_array_equal(pair_T.reshape(3, -1)[:, mirror_t.long()].numpy(),
                                  flat.permute(2, 1, 0).numpy())
    m = mirror_t.long().reshape(-1)
    np.testing.assert_array_equal(m[m].numpy(), np.arange(n * j))


def test_cpu_wrappers_never_launch_kernels(mega_case, jitter_box):
    """On the CPU each wrapper runs its plain twin: the kernel counters stay
    at 0 while the plain counters move."""
    jm, tm, dispT, mask, it, jt, esp = mega_case
    _, cell, swl = jitter_box
    ks = main_path_kernels()
    before = [(k.launches, k.plain_calls) for k in ks]
    targs = _torch_args(tm, dispT, mask, it, jt)
    site_energies_mega(*targs, _t(esp))
    pt = pair_forces_mega(*targs)
    window_giveback(pt, torch.zeros(pt.shape[1:], dtype=torch.int32))
    window_geometry(torch.zeros((4, 3), dtype=torch.float64), torch.zeros((2, 4), dtype=torch.int32),
                    _t(cell), torch.zeros((2, 4), dtype=torch.bool), 5.0)
    for k, (l0, p0) in zip(ks, before):
        assert k.launches == 0 == l0, k.name
        assert k.plain_calls > p0, k.name
    assert [k.name for k in ks] == [
        "window_disp", "pair_forces_mega", "window_giveback", "site_energies_mega"
    ]


def test_table_sections_match_the_cuda_header():
    """The int32 table's section order and the specialised shapes are
    declared twice, in Python and in the kernel source; they must agree, and
    the int2 sections must sit at even offsets."""
    import os
    import re

    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.fused_moments import _PACKED, _SECTIONS, SHAPES

    src = open(os.path.join(os.path.dirname(__file__), "..", "mtp_tpu_torch", "csrc",
                            "fused_moments.cu")).read()
    enum = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"k(\w+) = (\d+)", enum)
    want = ["Basic", "ShellMap", "FwdWave", "FwdTarget", "FwdSeg", "FwdProd",
            "RevWave", "RevNode", "RevSeg", "RevEnt"]
    assert [n for n, _ in names] == want
    assert [int(v) for _, v in names] == list(range(len(_SECTIONS)))
    assert [s.replace("_", "").lower() for s in _SECTIONS] == [w.lower() for w in want]
    macro = re.search(r"#define MTP_SHAPES\(X\)(.*?)\n\n", src, re.S).group(1)
    shapes = {int(i): tuple(int(r) for r in rs.split(","))
              for i, rs in re.findall(r"X\((\d+), ([\d, ]+)\)", macro)}
    assert shapes == SHAPES
    for level in (8, 16):
        tm = MTPModel.from_data(make_mtp(level, seed=0), device="cpu")
        header = tm.tables.tab[: len(_SECTIONS)].numpy()
        assert all(header[_SECTIONS.index(k)] % 2 == 0 for k in _PACKED)
        assert tm.tables.shape == {8: 1, 16: 2}[level]
        _sections(tm.tables)


def _mono_cuda(t):
    """Monomial t as csrc/fused_moments.cu computes it (`mono_rank`,
    `mono_ax`, `mono_ay`), line for line."""
    r = 0
    while _n_mono(r) <= t:
        r += 1
    q, ax = t - _n_mono(r - 1), r
    while q > r - ax:
        q -= r - ax + 1
        ax -= 1
    ay = r - ax - q
    return ax, ay, r - ax - ay


def _n_mono(r):
    return 0 if r < 0 else (r + 1) * (r + 2) * (r + 3) // 6


def test_monomial_order_is_the_kernels():
    """`monomials` lists what the kernel's compile-time loops enumerate, and
    each rank-r prefix is every monomial of rank <= r once."""
    from mtp_tpu_torch.ops.fused_moments import monomials

    for rmax in range(9):
        got = monomials(rmax)
        assert got == [_mono_cuda(t) for t in range(_n_mono(rmax))]
        assert len(set(got)) == len(got) == _n_mono(rmax)
        assert all(sum(m) <= rmax for m in got)


def _kernel_terms(tables):
    """(mu, ax, ay, az, k) of every term in the order the kernel visits it:
    a specialised shape loops over monomials t, then radial functions mu
    whose shell holds t, at canonical term c = off(mu) + t, schedule row
    shell_map[c]; the General instantiation walks the basic table."""
    from mtp_tpu_torch.ops.fused_moments import SHAPES

    sec = _sections(tables)
    if tables.shape == 0:
        return [(*row, k) for k, row in enumerate(sec["basic"].reshape(-1, 4).tolist())]
    ranks = SHAPES[tables.shape]
    off = np.concatenate([[0], np.cumsum([_n_mono(r) for r in ranks])])
    terms = []
    for t in range(_n_mono(max(ranks))):
        ax, ay, az = _mono_cuda(t)
        for mu, r in enumerate(ranks):
            if ax + ay + az <= r:
                terms.append((mu, ax, ay, az, int(sec["shell_map"][off[mu] + t])))
    return terms


def _pair_stage(sched, radial, dispT, mask, it, jt):
    """The per-pair stage of the kernels over the live slots (mask > 0):
    slot and atom of each, w, 1/d, u, f_mu, f'_mu (P, MU) and the unit-vector
    powers (3, R+1, P)."""
    s_idx, i_idx = np.nonzero(mask > 0)
    x, y, z = (dispT[a, s_idx, i_idx] for a in range(3))
    w = mask[s_idx, i_idx]
    d = np.sqrt(x * x + y * y + z * z)
    inv_d = 1.0 / d
    u = np.stack([x, y, z]) * inv_d
    lo, hi, sc = sched.min_dist, sched.max_dist, sched.scaling
    ksi = (2.0 * d - (lo + hi)) / (hi - lo)
    mult_c, dh = 2.0 / (hi - lo), d - hi
    v = [sc * dh * dh, ksi * sc * dh * dh]
    g = [sc * 2.0 * dh, sc * (mult_c * dh * dh + 2.0 * ksi * dh)]
    for r in range(2, sched.radial_basis_size):
        v.append(2.0 * ksi * v[-1] - v[-2])
        g.append(2.0 * (mult_c * v[-2] + ksi * g[-1]) - g[-2])
    c = radial[it[i_idx], jt[s_idx, i_idx]]  # (P, MU, RB)
    f = np.einsum("pmr,rp->pm", c, np.array(v))
    fp = np.einsum("pmr,rp->pm", c, np.array(g))
    pw = np.stack([u ** e for e in range(sched.max_rank + 1)], axis=1)  # (3, R+1, P)
    return s_idx, i_idx, w, inv_d, u, f, fp, pw


def _walk_basic(tables, radial, dispT, mask, it, jt):
    """K6 as the kernel indexes its terms: (B, N)."""
    _, i_idx, w, _, _, f, _, pw = _pair_stage(tables.sched, radial, dispT, mask, it, jt)
    out = np.zeros((tables.sched.basic_count, dispT.shape[2]))
    for mu, ax, ay, az, k in _kernel_terms(tables):
        np.add.at(out[k], i_idx, (f[:, mu] * w) * (pw[0, ax] * (pw[1, ay] * pw[2, az])))
    return out


def _walk_tail(tables, radial, dispT, mask, it, jt, gamma):
    """The force tail from gamma (B, N) as the kernel runs it: by monomial
    (G_t, G'_t; T = w (u (P - Q/d) + D/d)) for a specialised shape, by term
    (`_pair_force_terms`) for the General one. (3, J, N)."""
    s_idx, i_idx, w, inv_d, u, f, fp, pw = _pair_stage(tables.sched, radial, dispT, mask, it, jt)
    g = gamma[:, i_idx]  # (B, P)
    P = np.zeros_like(w)
    Q = np.zeros_like(w)
    D = np.zeros((3,) + w.shape)
    terms = _kernel_terms(tables)
    if tables.shape:
        by_mono = {}
        for mu, ax, ay, az, k in terms:
            by_mono.setdefault((ax, ay, az), []).append((mu, k))
        for a, mus in by_mono.items():
            G = sum(g[k] * f[:, mu] for mu, k in mus)
            Gp = sum(g[k] * fp[:, mu] for mu, k in mus)
            U = pw[0, a[0]] * pw[1, a[1]] * pw[2, a[2]]
            P += Gp * U
            Q += sum(a) * G * U
            for c in range(3):
                if a[c]:
                    lower = list(a)
                    lower[c] -= 1
                    D[c] += G * a[c] * (pw[0, lower[0]] * pw[1, lower[1]] * pw[2, lower[2]])
        T = (u * (P - Q * inv_d) + D * inv_d) * w
    else:
        for mu, ax, ay, az, k in terms:
            rank = ax + ay + az
            W2 = f[:, mu] * inv_d
            W1 = fp[:, mu] - rank * W2
            a = (ax, ay, az)
            U = pw[0, ax] * pw[1, ay] * pw[2, az]
            P += g[k] * W1 * U
            for c in range(3):
                if a[c]:
                    lower = list(a)
                    lower[c] -= 1
                    D[c] += g[k] * W2 * a[c] * (pw[0, lower[0]] * pw[1, lower[1]] * pw[2, lower[2]])
        T = (u * P + D) * w
    out = np.zeros_like(dispT)
    out[:, s_idx, i_idx] = T
    return out


def _walk_case(level, species, path):
    import dataclasses as dc

    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.models.mtp import MTPModel

    tm = MTPModel.from_data(make_mtp(level, species_count=species, seed=4), device="cpu",
                            dtype=torch.float64)
    tables = tm.tables if path == "specialised" else dc.replace(tm.tables, shape=0)
    assert tables.shape == {"specialised": {8: 1, 16: 2}[level], "general": 0}[path]
    dispT, mask, it, jt = _random_pairs(np.random.default_rng(level + species), 48, 64, species)
    return tm, tables, dispT, mask, it, jt


WALKS = [(lv, sp, path) for lv in (8, 16) for sp in (1, 2) for path in ("specialised", "general")]


@pytest.mark.parametrize("level,species,path", WALKS)
def test_term_tables_reproduce_basic_moments(level, species, path):
    """The basic stage walked as the kernel indexes its terms gives
    moments.basic_moments in float64."""
    tm, tables, dispT, mask, it, jt = _walk_case(level, species, path)
    rc = tm.coeffs.radial_coeffs
    got = _walk_basic(tables, rc.numpy(), dispT, mask, it, jt)
    want, _ = moments.basic_moments(
        tm.schedule, tm.coeffs, _t(dispT).permute(2, 1, 0), _t(mask > 0).T,
        _t(it).long(), _t(jt).T.long(),
    )
    np.testing.assert_allclose(got, want.numpy().T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("level,species,path", WALKS)
def test_term_tables_reproduce_the_autograd_force_tail(level, species, path):
    """The whole K2 chain walked as the kernels run it (basic stage, DAG
    tables forward and back, the force tail by monomial or by term) gives
    pair_forces_mega_plain's autograd pair forces in float64."""
    tm, tables, dispT, mask, it, jt = _walk_case(level, species, path)
    s = tm.schedule
    rc = tm.coeffs.radial_coeffs
    xi = readout_vector(tm).numpy()
    sec = _sections(tables)
    m0 = np.zeros((s.alpha_moments_count, dispT.shape[2]))
    m0[: s.basic_count] = _walk_basic(tables, rc.numpy(), dispT, mask, it, jt)
    m = _walk_forward(sec, tables.n_waves, m0)
    dm = _walk_reverse(sec, tables.n_waves, m, np.repeat(xi[:, None], m.shape[1], axis=1))
    got = _walk_tail(tables, rc.numpy(), dispT, mask, it, jt, dm[: s.basic_count])
    want = pair_forces_mega(tables, _t(dispT), _t(mask), _t(it, torch.int32),
                            _t(jt, torch.int32), rc, readout_vector(tm)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_fused_kernel_operands_must_match_the_schedule():
    """The fused kernels take their sizes from the schedule and read every
    operand through a raw pointer: an operand of another schedule's size
    raises before any launch."""
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.fused_moments import _check

    f32 = torch.float32
    two = MTPModel.from_data(make_mtp(8, species_count=2, seed=2), device="cpu", dtype=f32)
    one = MTPModel.from_data(make_mtp(8, species_count=1, seed=2), device="cpu", dtype=f32)
    n, j = 8, 4
    ops = dict(
        dispT=torch.zeros((3, j, n), dtype=f32), mask=torch.zeros((j, n), dtype=f32),
        itypes=torch.zeros(n, dtype=torch.int32), jtypes_t=torch.zeros((j, n), dtype=torch.int32),
        radial_coeffs=two.coeffs.radial_coeffs, xi_full=readout_vector(two),
        per_atom=torch.zeros(n, dtype=f32),
    )
    _check(two.tables, **ops)
    bad = [
        dict(radial_coeffs=one.coeffs.radial_coeffs),
        dict(xi_full=readout_vector(two)[:-1]),
        dict(per_atom=torch.zeros(n + 1, dtype=f32)),
        dict(mask=torch.zeros((j, n), dtype=torch.float64)),
    ]
    for change in bad:
        with pytest.raises(ValueError):
            _check(two.tables, **{**ops, **change})
    # K6/K7 take no readout vector; K7's gamma is (B, N)
    b = two.schedule.basic_count
    _check(two.tables, **{**ops, "xi_full": None, "per_atom": None},
           gamma=torch.zeros((b, n), dtype=f32))
    with pytest.raises(ValueError):
        _check(two.tables, **ops, gamma=torch.zeros((b + 1, n), dtype=f32))


def test_launch_counter_counts_only_successful_launches():
    """A kernel's counter moves only when its C entry point reports success;
    an error code raises and leaves the count unchanged."""
    from mtp_tpu_torch.kernels._build import Kernel

    codes = iter([0, 700])
    k = Kernel("fake", "fake_symbol", "none.cu", "none.py:1", ())
    k._fn = lambda *args: next(codes)
    k.launch(1, 2)
    assert k.launches == 1
    with pytest.raises(RuntimeError, match="error 700"):
        k.launch(1, 2)
    assert k.launches == 1 and k.plain_calls == 0


@pytest.fixture(scope="module")
def al_case(mtp_level8_2spec):
    """The smallest fcc box with 3 bins per dimension at the level-8 cutoff
    (4x4x4 cells, 256 atoms: one tile of each JAX kernel), jittered, two
    species, J = 64; the kernels' inputs from the port's sorted list."""
    from mtp_tpu_torch.md.simulation import make_lattice as lattice_t
    from mtp_tpu_torch.models.mtp import window_constants
    from mtp_tpu_torch.ops.neighbors import build_sorted_neighbor_list, grid_shape as grid_t

    jm = JaxModel.from_data(mtp_level8_2spec, dtype=jnp.float64)
    tm = model_from_jax(jm, device="cpu", dtype=torch.float64)
    pos, types, cell = lattice_t("fcc", 4.0, (4, 4, 4), type_pattern=(0, 1))
    assert min(grid_t(cell, tm.cutoff)) >= 3
    pos = pos + np.random.default_rng(4).normal(0, 0.1, pos.shape)
    p, c = _t(pos), _t(cell)
    swl = build_sorted_neighbor_list(p, c, tm.cutoff, max_neighbors=64, grid=grid_t(cell, tm.cutoff))
    assert not bool(swl.overflow)
    k = window_constants(tm, _t(types, torch.int32), swl)
    dispT, mask = window_geometry(p[swl.order], k["idx_t"], c, k["pair_valid_t"], tm.cutoff)
    return jm, tm, dispT.numpy(), mask.numpy(), k["it_row"].numpy(), k["jtypes_t"].numpy(), \
        k["esp"].numpy()


def test_candidates_mega_matches_jax_kernel(al_case):
    """K5's plain twin against the interpreted JAX candidates kernel: site
    energies, scalar-basis members, radial rows and pair forces."""
    jm, tm, dispT, mask, it, jt, esp = al_case
    want = cand_jax(*_jax_args(jm, dispT, mask, it, jt), jnp.asarray(esp)[None, :])
    got = candidates_mega(*_torch_args(tm, dispT, mask, it, jt), _t(esp))
    for key in ("site_e", "basis_members", "rad", "pair_tT"):
        assert got[key].shape == want[key].shape, key
        assert np.max(np.abs(got[key].numpy() - np.asarray(want[key]))) < TOL, key
    assert np.abs(np.asarray(want["rad"])).max() > 1.0  # a non-trivial block


def test_candidates_mega_computes_in_float64(al_case):
    """K5 on fp32 inputs computes in float64, its plain twin as the kernel:
    the candidate blocks are the float64 computation at the fp32 inputs'
    values, bit for bit, and stay float64; site energies and pair forces
    are that computation rounded to fp32."""
    _, tm, dispT, mask, it, jt, esp = al_case

    def cast(args, dtype):
        return [a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a for a in args]

    f32 = cast([*_torch_args(tm, dispT, mask, it, jt), _t(esp)], torch.float32)
    got = candidates_mega(*f32)
    want = candidates_mega(*cast(f32, torch.float64))
    for key in ("basis_members", "rad"):
        assert got[key].dtype == torch.float64 and torch.equal(got[key], want[key]), key
    for key in ("site_e", "pair_tT"):
        assert got[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key].float()), key


def test_basic_moments_fused_and_vjp_match_jax_kernels(al_case):
    """K6 (forward) and K7 (its vjp, through the autograd backward) against
    the interpreted JAX kernels and jax.vjp, with a cotangent gamma."""
    import jax

    jm, tm, dispT, mask, it, jt, _ = al_case
    ja = _jax_args(jm, dispT, mask, it, jt)[:6]
    want, vjp = jax.vjp(lambda d: bmf_jax(ja[0], d, *ja[2:]), jnp.asarray(dispT))
    gamma = np.random.default_rng(9).normal(size=np.asarray(want).shape)
    (want_pair,) = vjp(jnp.asarray(gamma))
    targs = _torch_args(tm, dispT, mask, it, jt)[:6]
    d = targs[1].clone().requires_grad_(True)
    mb = basic_moments_fused(targs[0], d, *targs[2:])
    assert np.max(np.abs(mb.detach().numpy() - np.asarray(want))) < TOL
    (pair,) = torch.autograd.grad(mb, d, _t(gamma))
    assert np.max(np.abs(pair.numpy() - np.asarray(want_pair))) < TOL
    direct = basic_moments_vjp_plain(*targs, _t(gamma))
    assert np.max(np.abs(direct.numpy() - np.asarray(want_pair))) < TOL


def test_site_energies_fused_is_the_mega_energy(al_case):
    """The modular energy path (K6, plain DAG and readout; K7 backward) gives
    the fused path's site energies and pair forces (K4, K2)."""
    jm, tm, dispT, mask, it, jt, esp = al_case
    targs = _torch_args(tm, dispT, mask, it, jt)
    d = targs[1].clone().requires_grad_(True)
    e = site_energies_fused(tm.tables, tm.coeffs, d, *targs[2:5])
    np.testing.assert_allclose(e.detach().numpy(), site_energies_mega(*targs, _t(esp)).numpy(),
                               rtol=0, atol=TOL)
    (g,) = torch.autograd.grad(e.sum(), d)
    assert np.max(np.abs(g.numpy() - pair_forces_mega(*targs).numpy())) < TOL


def test_al_wrappers_run_plain_twins_on_cpu(al_case):
    """K5-K7 on the CPU: each plain counter moves, no kernel launches."""
    _, tm, dispT, mask, it, jt, esp = al_case
    ks = all_kernels()[4:7]
    assert [k.name for k in ks] == ["candidates_mega", "basic_moments_fused", "basic_moments_vjp"]
    before = [k.plain_calls for k in ks]
    targs = _torch_args(tm, dispT, mask, it, jt)
    candidates_mega(*targs, _t(esp))
    d = targs[1].clone().requires_grad_(True)
    basic_moments_fused(targs[0], d, *targs[2:6]).sum().backward()
    for k, p0 in zip(ks, before):
        assert k.launches == 0 and k.plain_calls == p0 + 1, k.name
