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
    gather_displacements as gather_jax,
    readout_vector as readout_jax,
)
from mtp_tpu.ops.neighbors import build_sorted_neighbor_list as sorted_jax
from mtp_tpu.ops.neighbors import grid_shape
from mtp_tpu.ops.pallas_moments import pair_forces_mega as pf_jax
from mtp_tpu.ops.pallas_moments import site_energies_mega as se_jax
from mtp_tpu.ops.window_disp import window_disp as wd_jax
from mtp_tpu.ops.window_giveback import giveback_reference
from mtp_tpu_torch.kernels import main_path_kernels
from mtp_tpu_torch.models.mtp import readout_vector
from mtp_tpu_torch.ops import moments
from mtp_tpu_torch.ops.fused_moments import (
    build_tables,
    pair_forces_mega,
    site_energies_mega,
)
from mtp_tpu_torch.ops.window_disp import window_disp
from mtp_tpu_torch.ops.window_giveback import window_giveback
from mtp_tpu_torch.utils.convert import model_from_jax

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


def test_window_disp_matches_jax_kernel(jitter_box):
    pos, cell, swl = jitter_box
    n = len(pos)
    n_pad = swl.idx.shape[0]
    spos = np.zeros((n_pad, 3))
    spos[:n] = pos[np.asarray(swl.order)]
    want = np.asarray(
        wd_jax(jnp.asarray(spos), swl.window_idx, swl.wl, swl.wl_counts, jnp.asarray(cell))
    )
    got = window_disp(_t(spos), _t(swl.window_idx, torch.int32), _t(cell)).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < TOL


def test_window_disp_matches_gather_displacements(jitter_box):
    pos, cell, swl = jitter_box
    n = len(pos)
    spos = pos[np.asarray(swl.order)]
    idx = np.asarray(swl.idx)[:n]
    ref = np.asarray(
        gather_jax(jnp.asarray(spos), jnp.asarray(idx), jnp.asarray(cell),
                   jnp.linalg.inv(jnp.asarray(cell)))
    )
    got = window_disp(_t(spos), _t(idx, torch.int32), _t(cell)).numpy()
    assert np.max(np.abs(got - np.moveaxis(ref, (0, 1, 2), (2, 1, 0)))) < TOL


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
    tm = model_from_jax(jm, dtype=torch.float64)
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


def _sections(tab):
    """Split the kernels' int32 table at its header's section offsets."""
    from mtp_tpu_torch.ops.fused_moments import _SECTIONS

    tab = tab.numpy()
    ends = list(tab[1 : len(_SECTIONS)]) + [len(tab)]
    return {k: tab[tab[i] : ends[i]] for i, k in enumerate(_SECTIONS)}


def _walk_forward(sec, n_waves, m):
    """The K4/K2 forward DAG as the CUDA kernel walks its tables."""
    m = m.copy()
    fw, tg, seg, pr = (sec[k] for k in ("fwd_wave", "fwd_target", "fwd_seg", "fwd_prod"))
    pr = pr.reshape(-1, 3)
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
    ent = ent.reshape(-1, 3)
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

    tm = MTPModel.from_data(make_mtp(level, seed=2), dtype=torch.float64)
    s = tm.schedule
    tables = build_tables(s, "cpu")
    assert int(tables.tab[0]) == 9  # header length of csrc/fused_moments.cu
    rng = np.random.default_rng(level)
    mb = rng.normal(size=s.basic_count) * 0.5
    m0 = np.zeros(s.alpha_moments_count)
    m0[: s.basic_count] = mb
    sec = _sections(tables.tab)
    m_walk = _walk_forward(sec, tables.n_waves, m0)
    mb_t = _t(mb[None]).requires_grad_(True)
    m_ref = moments.contract_dag(s, mb_t)
    np.testing.assert_allclose(m_walk, m_ref.detach().numpy()[0], rtol=1e-12, atol=1e-12)
    xi = readout_vector(tm).numpy()
    dm = _walk_reverse(sec, tables.n_waves, m_walk, xi)
    (g,) = torch.autograd.grad((m_ref[0] * _t(xi)).sum(), mb_t)
    np.testing.assert_allclose(dm[: s.basic_count], g.numpy()[0], rtol=1e-12, atol=1e-12)


def test_giveback_matches_jax_reference_and_mirror_path(jitter_box):
    """K3's plain twin, sum_s T(i,s) - T(mirror), against the JAX give-back
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
    got = window_giveback(_t(pair_T), _t(swl.mirror, torch.int32)).numpy()
    assert got.shape == (n_pad, 3)
    assert np.max(np.abs(got - want_gb.T)) < TOL
    assert np.max(np.abs(got - want_mirror)) < TOL


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
    window_giveback(pt, torch.zeros(pt.shape[1] * pt.shape[2], dtype=torch.int32))
    window_disp(torch.zeros((4, 3), dtype=torch.float64),
                torch.zeros((4, 2), dtype=torch.int32), _t(cell))
    for k, (l0, p0) in zip(ks, before):
        assert k.launches == 0 == l0, k.name
        assert k.plain_calls > p0, k.name
    assert [k.name for k in ks] == [
        "window_disp", "pair_forces_mega", "window_giveback", "site_energies_mega"
    ]


def test_table_sections_match_the_cuda_header():
    """The int32 table's section order is declared twice, in Python and in
    the kernel's enum; they must agree."""
    import os
    import re

    from mtp_tpu_torch.ops.fused_moments import _SECTIONS

    src = open(os.path.join(os.path.dirname(__file__), "..", "mtp_tpu_torch", "csrc",
                            "fused_moments.cu")).read()
    enum = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"k(\w+) = (\d+)", enum)
    want = ["Basic", "FwdWave", "FwdTarget", "FwdSeg", "FwdProd",
            "RevWave", "RevNode", "RevSeg", "RevEnt"]
    assert [n for n, _ in names] == want
    assert [int(v) for _, v in names] == list(range(len(_SECTIONS)))
    assert [s.replace("_", "").lower() for s in _SECTIONS] == [w.lower() for w in want]


def test_fused_kernel_operands_must_match_the_schedule():
    """The fused kernels take their sizes from the schedule and read every
    operand through a raw pointer: an operand of another schedule's size
    raises before any launch."""
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.fused_moments import _check

    f32 = torch.float32
    two = MTPModel.from_data(make_mtp(8, species_count=2, seed=2), dtype=f32)
    one = MTPModel.from_data(make_mtp(8, species_count=1, seed=2), dtype=f32)
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
