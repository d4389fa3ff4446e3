"""The port's active-learning slice against mtp_tpu and the f64 golden engine
(utils/golden.py), in float64 on the CPU: candidate vectors and grades,
MaxVol active-set construction, the .cfg writer, the window grade step, and
MD with grade evaluation.

Tolerances: candidate vectors 1e-11 absolute against golden (golden sums the
same float64 terms per pair in another order; measured ~7e-14); grades rtol
1e-9 (the JAX package's own grade tolerance); forces, energies and virials
1e-10 absolute; trajectory positions 1e-10 A. MaxVol and the .cfg text are
the same NumPy operations in the same order, so they are compared exactly.
On the CPU every kernel wrapper runs its plain twin.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.al.driver import ExtrapolationMonitor as JaxMonitor
from mtp_tpu.al.driver import run_with_extrapolation as run_jax
from mtp_tpu.al.grades import grade_eval_window as gew_jax
from mtp_tpu.al.maxvol import build_mvs as build_mvs_jax
from mtp_tpu.al.maxvol import maxvol_select as maxvol_jax
from mtp_tpu.io.basis_gen import make_mtp
from mtp_tpu.io.cfg_file import format_cfg as format_cfg_jax
from mtp_tpu.md.simulation import Simulation as JaxSimulation
from mtp_tpu.md.state import init_state as init_jax
from mtp_tpu.models.mtp import MTPModel as JaxModel
from mtp_tpu.ops.neighbors import build_sorted_neighbor_list as sorted_jax
from mtp_tpu.utils import golden
from mtp_tpu_torch.al.driver import (
    BreakThresholdExceeded,
    ExtrapolationMonitor,
    run_with_extrapolation,
)
from mtp_tpu_torch.al.grades import (
    candidate_vectors,
    candidates_and_forces,
    cfg_grade,
    grade_eval_window,
    nbh_grades,
)
from mtp_tpu_torch.al.maxvol import build_mvs, maxvol_select
from mtp_tpu_torch.io.cfg_file import CfgWriter, format_cfg, read_cfgs
from mtp_tpu_torch.io.mtp_file import MVSData
from mtp_tpu_torch.md.simulation import Simulation, make_lattice
from mtp_tpu_torch.md.state import init_state
from mtp_tpu_torch.ops.neighbors import (
    build_neighbor_list,
    build_sorted_neighbor_list,
    grid_shape,
)
from mtp_tpu_torch.utils import units
from mtp_tpu_torch.utils.convert import model_from_jax

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


# This file's own potentials, minted as the conftest's session fixtures of
# the same names are: those are shared with every test file a worker runs,
# and several of them assign to the potential (`m.mvs = ...`), so a value
# compared here against golden to 1e-11 must not depend on what ran before.
@pytest.fixture(scope="module")
def mtp_level8():
    return make_mtp(8, species_count=1, seed=0)


@pytest.fixture(scope="module")
def mtp_level8_2spec():
    return make_mtp(8, species_count=2, seed=3)


def _box(seed, reps=(3, 3, 3), jitter=0.1, species=1):
    """fcc box (108 atoms at 3x3x3: 12 A > 2 x cutoff), jittered, random
    types."""
    pos, _, cell = make_lattice("fcc", 4.0, reps)
    rng = np.random.default_rng(seed)
    pos = pos + rng.normal(0, jitter, pos.shape)
    types = rng.integers(0, species, len(pos)).astype(np.int32)
    return pos, types, cell


def _list(model, pos, cell, cut=None, j=64):
    cut = cut or model.cutoff
    nl = build_neighbor_list(_t(pos), _t(cell), cut, max_neighbors=j, grid=grid_shape(cell, cut))
    assert not bool(nl.overflow)
    return nl


def _with_mvs(m, mode):
    """`m` with an MVS state built by the port from the candidate vectors of
    two perturbed 108-atom boxes, so grades near the lattice are ~1."""
    tm = model_from_jax(JaxModel.from_data(m, dtype=jnp.float64), device="cpu")
    rows = []
    for k, s in enumerate((0.05, 0.1)):
        pos, types, cell = _box(100 + k, jitter=s)
        nl = _list(tm, pos, cell)
        b, _ = candidate_vectors(tm, _t(pos), _t(types, torch.int32), nl.idx, _t(cell))
        rows.append(b.numpy())
    return dataclasses.replace(m, mvs=build_mvs(np.concatenate(rows), mode=mode))


@pytest.fixture(scope="module")
def al_models(mtp_level8):
    """(MTPData, JAX model, port model) with a neighborhood-mode MVS."""
    m = _with_mvs(mtp_level8, "neighborhood")
    jm = JaxModel.from_data(m, dtype=jnp.float64)
    return m, jm, model_from_jax(jm, device="cpu")


@pytest.mark.parametrize("fixture", ["mtp_level8", "mtp_level8_2spec"])
def test_candidate_vectors_match_golden(fixture, request):
    m = request.getfixturevalue(fixture)
    pos, types, cell = _box(1, species=m.species_count)
    g = golden.compute(m, pos, types, cell=cell, compute_grades=True)
    jm = JaxModel.from_data(m, dtype=jnp.float64)
    # the inputs are float64 before anything is compared (model_from_jax
    # also refuses narrower coefficient arrays)
    for a in (jm.coeffs.radial_coeffs, jm.coeffs.species_coeffs, jm.coeffs.moment_coeffs):
        assert np.asarray(a).dtype == np.float64
    assert all(np.asarray(a).dtype == np.float64 for a in (pos, cell))
    tm = model_from_jax(jm, device="cpu")
    nl = _list(tm, pos, cell)
    b, e = candidate_vectors(tm, _t(pos), _t(types, torch.int32), nl.idx, _t(cell))
    assert b.shape == g["energy_ders_wrt_coeffs"].shape == (len(pos), m.coeff_count)
    np.testing.assert_allclose(b.numpy(), g["energy_ders_wrt_coeffs"], rtol=0, atol=1e-11)
    assert abs(float(e) - g["energy"]) < 1e-10
    out = candidates_and_forces(tm, _t(pos), _t(types, torch.int32), nl.idx, _t(cell), nl.mirror)
    assert torch.equal(out["b"], b)
    np.testing.assert_allclose(out["forces"].numpy(), g["forces"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(out["virial"].numpy(), g["virial"], rtol=0, atol=1e-10)


def test_grades_match_golden(mtp_level8_2spec):
    m = mtp_level8_2spec
    p = m.coeff_count
    a = np.random.default_rng(3).normal(size=(p, p)) + np.eye(p)
    m = dataclasses.replace(m, mvs=MVSData(0, 0, 0, 1, 2.0, a, np.linalg.inv(a)))
    pos, types, cell = _box(2, species=2)
    g = golden.compute(m, pos, types, cell=cell, compute_grades=True)
    tm = model_from_jax(JaxModel.from_data(m, dtype=jnp.float64), device="cpu")
    b, _ = candidate_vectors(tm, _t(pos), _t(types, torch.int32), _list(tm, pos, cell).idx, _t(cell))
    np.testing.assert_allclose(nbh_grades(b, tm.inverse_active_set).numpy(), g["nbh_grades"],
                               rtol=1e-9)
    bsum = g["energy_ders_wrt_coeffs"].sum(axis=0)
    want = np.abs(np.linalg.inv(a) @ bsum).max() / len(pos)
    np.testing.assert_allclose(float(cfg_grade(b, tm.inverse_active_set, len(pos))), want,
                               rtol=1e-9)


def test_grade_products_run_in_float64(al_models):
    """Float32 grade products are computed in float64 and rounded once, so a
    reduced-precision matmul setting (TF32 on the card) cannot reach them."""
    _, _, tm = al_models
    p = tm.inverse_active_set.shape[0]
    b = torch.as_tensor(np.random.default_rng(11).normal(size=(50, p)), dtype=torch.float32)
    inv = tm.inverse_active_set.float()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        g, gc = nbh_grades(b, inv), cfg_grade(b, inv, 50)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert g.dtype == gc.dtype == torch.float32
    assert torch.equal(g, torch.abs(b.double() @ inv.double().T).max(dim=-1).values.float())
    want_c = torch.abs(inv.double() @ b.sum(0).double()).max().float() / 50
    assert torch.equal(gc, want_c)


def test_maxvol_and_build_mvs_match_jax():
    rng = np.random.default_rng(5)
    pool = rng.normal(size=(200, 12))
    idx, a = maxvol_select(pool)
    idx_j, a_j = maxvol_jax(pool)
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_array_equal(a, a_j)
    assert np.abs(pool @ np.linalg.inv(a)).max() <= 1.01 + 1e-9  # MaxVol dominance
    pool = rng.normal(size=(60, 12))
    for mode in ("neighborhood", "configuration"):
        got, want = build_mvs(pool, mode=mode), build_mvs_jax(pool, mode=mode)
        assert isinstance(got, MVSData)
        assert got.configuration_mode == want.configuration_mode == (mode == "configuration")
        np.testing.assert_array_equal(got.active_set, want.active_set)
        np.testing.assert_array_equal(got.inverse_active_set, want.inverse_active_set)


def test_format_cfg_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    pos = rng.uniform(0, 10, (7, 3))
    types = rng.integers(0, 2, 7)
    grades = rng.uniform(0, 3, 7)
    ortho = np.diag([10.0, 11.0, 12.0])
    tri = np.array([[10.0, 0.5, -0.3], [1.0, 11.0, 0.2], [0.4, -1.2, 12.0]])
    cases = [
        (ortho, dict(grades=grades, max_grade=float(grades.max()))),
        (ortho, dict(energy=-12.5)),
        (tri, dict(forces=rng.normal(size=(7, 3)), energy=-3.25, stress=rng.normal(size=6))),
        (tri, dict(grades=grades, max_grade=2.0)),
    ]
    for cell, kw in cases:
        assert format_cfg(cell, pos, types, **kw) == format_cfg_jax(cell, pos, types, **kw)
    path = str(tmp_path / "s.cfg")
    with CfgWriter(path) as w:
        w.write(ortho, pos, types, grades=grades, max_grade=float(grades.max()))
        w.write(ortho, pos, types, energy=-12.5)
    cfgs = read_cfgs(path)
    assert len(cfgs) == 2 and cfgs[1].grades is None and cfgs[1].energy == -12.5
    np.testing.assert_allclose(cfgs[0].grades, grades, atol=1e-5)
    assert cfgs[0].features["MV_grade"] == pytest.approx(grades.max(), abs=1e-6)


def test_grade_eval_window_matches_jax(al_models):
    """The window grade step (CPU: plain twins of K1, K5, K3) against the JAX
    window grade step (Pallas in interpret mode) on the same positions: the
    smallest fcc box with 3 bins per dimension, each package's sorted list."""
    _, jm, tm = al_models
    pos, types, cell = _box(3, reps=(4, 4, 4), jitter=0.08)
    grid = grid_shape(cell, tm.cutoff)
    assert min(grid) >= 3
    swl_j = sorted_jax(jnp.asarray(pos), jnp.asarray(cell), jm.cutoff, max_neighbors=64, grid=grid)
    want = gew_jax(jm.schedule, jm.coeffs, jnp.asarray(pos), jnp.asarray(types), jnp.asarray(cell),
                   swl_j, jm.inverse_active_set, config_mode=False)
    swl = build_sorted_neighbor_list(_t(pos), _t(cell), tm.cutoff, max_neighbors=64, grid=grid)
    assert not bool(swl.overflow) and not bool(swl_j.overflow)
    got = grade_eval_window(tm, _t(pos), _t(types, torch.int32), _t(cell), swl,
                            tm.inverse_active_set, config_mode=False)
    np.testing.assert_allclose(got["grades"].numpy(), np.asarray(want["grades"]), rtol=1e-9)
    assert float(got["max_grade"]) == pytest.approx(float(want["max_grade"]), rel=1e-9)
    np.testing.assert_allclose(got["forces"].numpy(), np.asarray(want["forces"]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["virial"].numpy(), np.asarray(want["virial"]), rtol=0, atol=1e-10)
    assert abs(float(got["energy"]) - float(want["energy"])) < 1e-10
    # the same step on the plain path
    nl = _list(tm, pos, cell)
    plain = candidates_and_forces(tm, _t(pos), _t(types, torch.int32), nl.idx, _t(cell), nl.mirror)
    np.testing.assert_allclose(nbh_grades(plain["b"], tm.inverse_active_set).numpy(),
                               got["grades"].numpy(), rtol=1e-9)


def _md_start(seed=42):
    """108-atom box, numpy Maxwell-Boltzmann velocities at 300 K shared by
    both packages (their thermalize() draw from different generators)."""
    pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    masses = np.full(len(pos), 58.693)
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(units.KB * 300.0 / (masses * units.MVV2E))
    vel = rng.normal(size=pos.shape) * sigma[:, None]
    vel -= (vel * masses[:, None]).sum(0) / masses.sum()
    return pos, types, masses, cell, vel


def test_run_with_extrapolation_matches_jax_driver(al_models, tmp_path):
    """10 NVE steps graded every 5, MLIP-3 style selecting every evaluation:
    the same trajectory, grades and .cfg stream as the JAX driver."""
    _, jm, tm = al_models
    pos, types, masses, cell, vel = _md_start()
    sj = init_jax(pos, types, masses, cell, velocities=vel, dtype=jnp.float64)
    mon_j = JaxMonitor(jm, select_threshold=0.0, break_threshold=1e9,
                       output_path=str(tmp_path / "jax.cfg"), max_neighbors=64)
    sj = run_jax(JaxSimulation(jm, max_neighbors=64, skin=0.6, steps_per_rebuild=5),
                 mon_j, sj, 10, al_every=5, ensemble="nve", dt=0.001)
    mon_j.close()

    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    mon = ExtrapolationMonitor(tm, select_threshold=0.0, break_threshold=1e9,
                               output_path=str(tmp_path / "port.cfg"))
    seen = []
    st = run_with_extrapolation(Simulation(tm, max_neighbors=64, skin=0.6, steps_per_rebuild=5),
                                mon, st, 10, al_every=5, ensemble="nve", dt=0.001,
                                observer=lambda s, m: seen.append(m.max_grade))
    mon.close()
    assert int(st.step) == 10 and len(seen) == 2
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), rtol=0, atol=1e-10)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(sj.forces), rtol=0, atol=1e-10)
    assert mon.max_grade == pytest.approx(mon_j.max_grade, rel=1e-9) and mon.max_grade > 0
    np.testing.assert_allclose(mon.nbh_grades, np.asarray(mon_j.nbh_grades), rtol=1e-9)
    text = (tmp_path / "port.cfg").read_text()
    assert text == (tmp_path / "jax.cfg").read_text()
    assert text.count("BEGIN_CFG") == 3  # the initial evaluation + 2


def test_break_threshold_flushes_before_raising(al_models, tmp_path):
    _, _, tm = al_models
    pos, types, masses, cell, vel = _md_start()
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    path = tmp_path / "break.cfg"
    mon = ExtrapolationMonitor(tm, select_threshold=0.0, break_threshold=0.0,
                               output_path=str(path))
    with pytest.raises(BreakThresholdExceeded):
        run_with_extrapolation(Simulation(tm, max_neighbors=64, skin=0.6, steps_per_rebuild=5),
                               mon, st, 10, al_every=5, dt=0.001)
    cfgs = read_cfgs(str(path))  # flushed before the raise
    assert len(cfgs) == 1 and cfgs[0].grades is not None
    assert cfgs[0].features["MV_grade"] == pytest.approx(mon.max_grade, abs=1e-6)


def test_configuration_mode_matches_jax(mtp_level8, tmp_path):
    """Configuration mode: one grade per configuration, no per-atom grades,
    so the .cfg stream has no grade column; standalone and window paths agree
    with the JAX monitor."""
    m = _with_mvs(mtp_level8, "configuration")
    jm = JaxModel.from_data(m, dtype=jnp.float64)
    tm = model_from_jax(jm, device="cpu")
    assert tm.configuration_mode
    pos, types, cell = _box(8, jitter=0.12)
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, dtype=F64, device="cpu")
    mon = ExtrapolationMonitor(tm, select_threshold=0.0, output_path=str(tmp_path / "c.cfg"))
    g = mon.evaluate(st)
    want = JaxMonitor(jm).evaluate(init_jax(pos, types, np.full(len(pos), 58.693), cell,
                                            dtype=jnp.float64))
    assert g == pytest.approx(float(want), rel=1e-9) and g > 0
    assert mon.nbh_grades is None
    swl = build_sorted_neighbor_list(_t(pos), _t(cell), tm.cutoff + 0.6, max_neighbors=64,
                                     grid=grid_shape(cell, tm.cutoff + 0.6))
    assert mon.evaluate(st, nl=swl) == pytest.approx(g, rel=1e-9)
    mon.close()
    cfgs = read_cfgs(str(tmp_path / "c.cfg"))
    assert len(cfgs) == 2 and all(c.grades is None for c in cfgs)
    assert "nbh_grades" not in (tmp_path / "c.cfg").read_text()


def test_monitor_regrows_on_neighbor_overflow(al_models):
    """A truncated list would underestimate grades: the standalone monitor
    grows max_neighbors until the build fits."""
    _, _, tm = al_models
    pos, types, cell = _box(9)
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, dtype=F64, device="cpu")
    small = ExtrapolationMonitor(tm, max_neighbors=4)
    g_small = float(small.evaluate(st))
    assert small.max_neighbors > 4
    big = ExtrapolationMonitor(tm, max_neighbors=64)
    assert g_small == pytest.approx(float(big.evaluate(st)), rel=1e-9)
    np.testing.assert_allclose(small.nbh_grades, big.nbh_grades, rtol=1e-9)


def test_driver_regrows_its_lists(al_models):
    """The driver widens a Simulation whose lists overflow before it grades,
    and the run matches one that started wide enough."""
    _, _, tm = al_models
    pos, types, masses, cell, vel = _md_start()
    runs = []
    for j in (8, 64):
        st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
        sim = Simulation(tm, max_neighbors=j, skin=0.6, steps_per_rebuild=5)
        mon = ExtrapolationMonitor(tm)
        runs.append((run_with_extrapolation(sim, mon, st, 5, al_every=5, dt=0.001), mon, sim))
    (narrow, mon_n, sim_n), (wide, mon_w, _) = runs
    assert sim_n.max_neighbors > 8 and sim_n.max_neighbors % 8 == 0
    np.testing.assert_allclose(narrow.positions.numpy(), wide.positions.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(mon_n.nbh_grades, mon_w.nbh_grades, rtol=1e-9)


def test_monitor_refuses_a_model_without_mvs_and_other_ensembles(al_models, mtp_level8):
    _, _, tm = al_models
    with pytest.raises(ValueError, match="MVS"):
        ExtrapolationMonitor(model_from_jax(JaxModel.from_data(mtp_level8, dtype=jnp.float64), device="cpu"))
    pos, types, masses, cell, vel = _md_start()
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="unknown ensemble"):
        run_with_extrapolation(Simulation(tm, max_neighbors=64, skin=0.6), ExtrapolationMonitor(tm),
                               st, 5, al_every=5, ensemble="nvx")
