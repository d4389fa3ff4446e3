"""The port's drivers and host I/O in float64 on the CPU, against ``mtp_tpu``
run as its own tests run it (``backend="xla", window=False``):
``Simulation.run`` with its recovery, ``run_fused``, FIRE, thermo and XYZ
output, checkpoints, LAMMPS data files, and active learning under NPT.

Tolerances, absolute (measured values in brackets):
- ``run`` after its staleness recovery against a fixed-cadence run: 1e-8 A
  (``tests/test_md.py``'s bound) [4e-15].
- ``run_fused`` against ``run``, and against the JAX ``run_fused`` from a
  state with zero forces: 1e-10 [<= 3e-15].
- FIRE against the JAX package: the same iteration count and stop reason;
  positions and energy 1e-9 [2e-14 A, 6e-14 eV].
- Thermo rows and XYZ text: equal to the JAX writers' output for the same
  state; checkpoints bit for bit, and a resumed run bit-identical to an
  unbroken one.
- LAMMPS data files: ``tests/test_lammps_data.py``'s bounds, and the same
  arrays as the JAX reader's.
- Active learning under NPT, 10 steps graded every 5: positions, forces
  and the cell 1e-10, grades rtol 1e-9.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.md.minimize import fire_minimize as fire_jax
from mtp_tpu.md.simulation import Simulation as JaxSimulation
from mtp_tpu.md.state import init_state as init_jax
from mtp_tpu.md.state import thermalize as thermalize_jax
from mtp_tpu.models.mtp import MTPModel as JaxModel
from mtp_tpu_torch.al.driver import ExtrapolationMonitor, run_with_extrapolation
from mtp_tpu_torch.al.grades import candidate_vectors
from mtp_tpu_torch.al.maxvol import build_mvs
from mtp_tpu_torch.io.lammps_data import read_lammps_data, write_lammps_data
from mtp_tpu_torch.md import integrators as itg
from mtp_tpu_torch.md.minimize import fire_minimize
from mtp_tpu_torch.md.output import (
    ThermoLogger,
    XYZDumpWriter,
    load_checkpoint,
    save_checkpoint,
)
from mtp_tpu_torch.md.simulation import Simulation, make_lattice
from mtp_tpu_torch.md.state import init_state, kinetic_energy
from mtp_tpu_torch.models.mtp import MTPModel
from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape, grown_width
from mtp_tpu_torch.utils.convert import model_from_jax

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

F64 = torch.float64
TOL = 1e-10


@pytest.fixture(scope="module")
def models(mtp_level8):
    jm = JaxModel.from_data(mtp_level8, dtype=jnp.float64)
    return jm, model_from_jax(jm, device="cpu")


def _thermal(temperature, seed, reps=(3, 3, 3), rattle=0.0):
    """fcc box (numpy arrays) with the velocities the JAX package's
    `thermalize` draws from ``PRNGKey(seed)``."""
    pos, types, cell = make_lattice("fcc", 4.0, reps)
    pos = pos + np.random.default_rng(seed).normal(0.0, rattle, pos.shape)
    masses = np.full(len(pos), 58.693)
    sj = thermalize_jax(jax.random.PRNGKey(seed),
                        init_jax(pos, types, masses, cell, dtype=jnp.float64), temperature)
    return pos, types, masses, cell, np.array(sj.velocities)


def _state(pos, types, masses, cell, vel=None):
    return init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")


# ---- Simulation.run and its recovery (tests/test_md.py:257, :290)


def test_run_halves_the_rebuild_interval_on_staleness(models):
    _, model = models
    st = _state(*_thermal(600.0, 7))
    sim = Simulation(model, max_neighbors=64, skin=0.05, steps_per_rebuild=64)
    out, aux = sim.run(st, 64, ensemble="nve", dt=0.001)
    assert aux is None and sim.steps_per_rebuild < 64 and int(out.step) == 64
    ref, _ = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=4).run(
        st, 64, ensemble="nve", dt=0.001)
    np.testing.assert_allclose(out.positions.numpy(), ref.positions.numpy(), rtol=0, atol=1e-8)


def test_run_grows_the_list_width_on_overflow(models):
    """J = 16 overflows; `run` discards the block and retries at
    16*1.5 + 8 = 32, then 56, and the trajectory equals a run at J = 64."""
    _, model = models
    st = _state(*_thermal(300.0, 2))
    blocks = []
    sim = Simulation(model, max_neighbors=16, skin=0.6, steps_per_rebuild=5)
    out, _ = sim.run(st, 10, ensemble="npt", dt=0.001, observer=lambda s: blocks.append(1))
    assert sim.max_neighbors == 56 and len(blocks) == 2 and int(out.step) == 10
    ref, _ = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=5).run(
        st, 10, ensemble="npt", dt=0.001)
    np.testing.assert_allclose(out.positions.numpy(), ref.positions.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(out.cell.numpy(), ref.cell.numpy(), rtol=0, atol=TOL)


def test_run_raises_when_overflow_not_curable_by_width(models):
    """An overflow at J >= 1024 is density or geometry, not list width:
    125 atoms 1.2 A apart in one 6 A bin overflow the bin table."""
    _, model = models
    g = np.arange(5) * 1.2 + 12.1
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    st = _state(pos, np.zeros(len(pos), np.int32), np.full(len(pos), 58.693),
                np.diag([24.0, 24.0, 24.0]))
    sim = Simulation(model, max_neighbors=1024, skin=0.3, steps_per_rebuild=1)
    with pytest.raises(RuntimeError, match="not a list-width problem"):
        sim.run(st, 1, ensemble="nve", dt=0.0001)


def test_run_raises_on_staleness_at_one_step_per_rebuild(models):
    _, model = models
    st = _state(*_thermal(600.0, 7))
    sim = Simulation(model, max_neighbors=64, skin=1e-3, steps_per_rebuild=2)
    with pytest.raises(RuntimeError, match="steps_per_rebuild=1"):
        sim.run(st, 4, ensemble="nve", dt=0.001)
    assert sim.steps_per_rebuild == 1


def test_grown_width_steps_and_cap():
    """x1.5 + 8, rounded up to a multiple of 8, and a raise at J >= 1024."""
    widths = [16]
    for _ in range(3):
        widths.append(grown_width(widths[-1]))
    assert widths == [16, 32, 56, 96]
    assert grown_width(8) == 24 and grown_width(1016) == 1536
    with pytest.raises(RuntimeError, match="max_neighbors=1024 during AL run: not a list-width"):
        grown_width(1024, "during AL run")


@pytest.fixture(scope="module")
def al_model(mtp_level8):
    """The level-8 potential with an MVS from two perturbed 108-atom boxes."""
    model = MTPModel.from_data(mtp_level8, device="cpu", dtype=F64)
    rows = []
    for k, sigma in enumerate((0.05, 0.1)):
        pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
        pos = pos + np.random.default_rng(100 + k).normal(0, sigma, pos.shape)
        p, c = torch.as_tensor(pos), torch.as_tensor(cell)
        nl = build_neighbor_list(p, c, model.cutoff, max_neighbors=64,
                                 grid=grid_shape(cell, model.cutoff))
        rows.append(candidate_vectors(model, p, torch.as_tensor(types), nl.idx, c)[0].numpy())
    mvs = build_mvs(np.concatenate(rows), mode="neighborhood")
    return MTPModel.from_data(dataclasses.replace(mtp_level8, mvs=mvs), device="cpu", dtype=F64)


_DRIVERS = {
    "run": lambda sim, st: sim.run(st, 2, ensemble="nve", dt=0.001),
    "run_with_extrapolation": lambda sim, st: run_with_extrapolation(
        sim, ExtrapolationMonitor(sim.model), st, 2, al_every=2, dt=0.001),
    "fire_minimize": lambda sim, st: fire_minimize(sim, st, ftol=0.0, max_steps=2),
}


@pytest.mark.parametrize("driver", tuple(_DRIVERS))
def test_recovery_rule_is_shared(al_model, driver):
    """From J = 8 on the 864-atom box each driver grows J through
    ``Simulation._recover`` to the first width at which the starting list
    fits, counting every growth in ``sim.retries``. With a rebuild that
    always overflows, each raises once J has grown past 1024."""
    st = _state(*_thermal(300.0, 5, reps=(6, 6, 6), rattle=0.05))
    sim = Simulation(al_model, max_neighbors=8, skin=0.6, steps_per_rebuild=2,
                     compute_virial=False)
    grid, want, growths = sim.grid_for(st.cell), 8, 0
    while bool(sim.rebuild(st, grid=grid, max_neighbors=want).overflow):
        want, growths = grown_width(want), growths + 1
    assert growths >= 2
    _DRIVERS[driver](sim, st)
    assert sim.max_neighbors == want
    assert sim.retries == {"overflow": growths, "stale": 0}

    sim = Simulation(al_model, max_neighbors=8, skin=0.6, steps_per_rebuild=2,
                     compute_virial=False)
    build = sim.rebuild

    def overflowing(state, *, grid, max_neighbors):
        nl = build(state, grid=grid, max_neighbors=want)
        return dataclasses.replace(nl, overflow=torch.ones_like(nl.overflow))

    sim.rebuild = overflowing
    with pytest.raises(RuntimeError, match="not a list-width problem"):
        _DRIVERS[driver](sim, st)
    assert sim.max_neighbors == 1104 and sim.retries["overflow"] == 9


@pytest.mark.parametrize("driver", ("run", "run_async", "run_fused"))
def test_drivers_refuse_an_unknown_ensemble(models, driver):
    _, model = models
    st = _state(*_thermal(300.0, 0))
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=5)
    call = {
        "run": lambda: sim.run(st, 5, ensemble="nph"),
        "run_async": lambda: sim.run_async(st, 5, ensemble="nph"),
        "run_fused": lambda: sim.run_fused(st, None, grid=(2, 2, 2), max_neighbors=64,
                                           n_blocks=1, steps_per_block=5, ensemble="nph"),
    }[driver]
    with pytest.raises(ValueError, match="unknown ensemble"):
        call()


# ---- run_fused (tests/test_run_fused.py)


def test_run_fused_matches_run(models):
    """On the perfect lattice (zero forces by symmetry) the blocks of
    `run_fused` equal `run`'s."""
    _, model = models
    st = _state(*_thermal(250.0, 0))
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=5)
    ref, _ = sim.run(st, 20, ensemble="nve", dt=0.001)
    grid = grid_shape(st.cell.numpy(), model.cutoff + 0.6)
    fused, aux, flag = sim.run_fused(st, 0, grid=grid, max_neighbors=48, n_blocks=4,
                                     steps_per_block=5, ensemble="nve", dt=0.001)
    assert not bool(flag) and int(fused.step) == 20 and aux == 0
    np.testing.assert_allclose(fused.positions.numpy(), ref.positions.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(fused.velocities.numpy(), ref.velocities.numpy(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("ensemble", ("nve", "npt"))
def test_run_fused_integrates_from_the_incoming_forces(models, ensemble):
    """From a rattled state whose forces are zero, no block refreshes them:
    the first half-kick uses the zeros, as the JAX program's does. The port
    equals JAX's `run_fused` there, and differs from `run`, which
    refreshes."""
    jm, model = models
    pos, types, masses, cell, vel = _thermal(300.0, 4, rattle=0.05)
    grid = grid_shape(cell, model.cutoff + 0.6)
    kw = dict(grid=grid, max_neighbors=64, n_blocks=2, steps_per_block=5, ensemble=ensemble,
              dt=0.001, temperature=300.0, pressure=0.0, tdamp=0.1, pdamp=0.5)
    sim_j = JaxSimulation(jm, max_neighbors=64, skin=0.6, steps_per_rebuild=5, backend="xla",
                          window=False)
    sj = init_jax(pos, types, masses, cell, velocities=vel, dtype=jnp.float64)
    aux_j = 0 if ensemble == "nve" else _jax_npt_aux()
    fj, _, flag_j = sim_j.run_fused(sj, aux_j, **kw)
    st = _state(pos, types, masses, cell, vel)
    assert float(st.forces.abs().max()) == 0.0
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=5)
    fused, _, flag = sim.run_fused(st, None, **kw)
    assert not bool(flag) and not bool(flag_j)
    np.testing.assert_allclose(fused.positions.numpy(), np.asarray(fj.positions), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(fused.velocities.numpy(), np.asarray(fj.velocities), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(fused.cell.numpy(), np.asarray(fj.cell), rtol=0, atol=TOL)
    ref, _ = sim.run(st, 10, ensemble=ensemble, dt=0.001, temperature=300.0, pressure=0.0,
                     tdamp=0.1, pdamp=0.5)
    assert float((ref.velocities - fused.velocities).abs().max()) > 1e-4


def _jax_npt_aux():
    from mtp_tpu.md.integrators import npt_init

    return npt_init(jnp.float64)


def test_geometry_overflow_flag():
    """Shrinking the cell past the static grid's validity trips overflow."""
    L = 24.0
    cell = np.diag([L, L, L])
    pos = np.random.default_rng(42).uniform(0, L, (60, 3))
    grid = grid_shape(cell, 3.0)
    assert min(grid) >= 3
    ok = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), 3.0,
                             max_neighbors=60, grid=grid)
    assert not bool(ok.overflow)
    shrunk = build_neighbor_list(torch.as_tensor(pos * 0.5), torch.as_tensor(cell * 0.5), 3.0,
                                 max_neighbors=60, grid=grid)
    assert bool(shrunk.overflow)


# ---- FIRE (tests/test_minimize.py)


def _rattled(reps, rattle, seed):
    pos, types, cell = make_lattice("fcc", 4.0, reps)
    pos = pos + np.random.default_rng(seed).normal(0.0, rattle, pos.shape)
    return pos, types, np.full(len(pos), 58.7), cell


def test_fire_matches_jax(models):
    """Same iterations and stop reason; final positions and energy to 1e-9."""
    jm, model = models
    pos, types, masses, cell = _rattled((3, 3, 3), 0.05, 0)
    kw = dict(ftol=1e-2, max_steps=400)
    out_j, res_j = fire_jax(
        JaxSimulation(jm, max_neighbors=48, skin=0.6, steps_per_rebuild=20, backend="xla",
                      window=False),
        init_jax(pos, types, masses, cell, dtype=jnp.float64), **kw)
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=20)
    out, res = fire_minimize(sim, _state(pos, types, masses, cell), **kw)
    assert res.converged and res.stop_reason == res_j.stop_reason == "ftol"
    assert res.iterations == res_j.iterations
    np.testing.assert_allclose(out.positions.numpy(), np.asarray(out_j.positions), rtol=0,
                               atol=1e-9)
    assert abs(res.potential_energy - res_j.potential_energy) < 1e-9
    assert abs(res.fmax - res_j.fmax) < 1e-9 and res.fmax < 1e-2
    assert float(out.velocities.abs().max()) == 0.0
    # the returned forces belong to the returned positions
    nl = sim.rebuild(out, grid=sim.grid_for(out.cell), max_neighbors=64)
    chk = sim.refresh_forces(out, nl)
    assert not bool(nl.overflow)
    assert abs(float(chk.forces.norm(dim=-1).max()) - res.fmax) < 1e-10


def test_fire_recovers_from_overflow_and_stops_on_etol(models):
    """A too-small J grows (the Simulation.run contract) and FIRE still
    converges; the etol criterion stops a run without an ftol; the
    Simulation method delegates."""
    _, model = models
    state = _state(*_rattled((3, 3, 3), 0.05, 0))
    sim = Simulation(model, max_neighbors=16, skin=0.6, steps_per_rebuild=20)
    energies = []
    _, res = fire_minimize(sim, state, ftol=1e-2, max_steps=2000,
                           observer=lambda s: energies.append(float(s.potential_energy)))
    assert sim.max_neighbors > 16 and res.converged and energies[-1] < energies[0]
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=10)
    _, res = sim.minimize(state, ftol=0.0, etol=1e-6, max_steps=2000)
    assert res.converged and res.stop_reason == "etol" and res.iterations < 2000


# ---- thermo, XYZ, checkpoints (tests/test_output.py)


def _jax_state_of(st):
    sj = init_jax(st.positions.numpy(), st.types.numpy(), st.masses.numpy(), st.cell.numpy(),
                  velocities=st.velocities.numpy(), dtype=jnp.float64)
    return dataclasses.replace(sj, forces=jnp.asarray(st.forces.numpy()),
                               potential_energy=jnp.asarray(float(st.potential_energy)),
                               virial=jnp.asarray(st.virial.numpy()))


def _evaluated(models):
    """A 32-atom box at 300 K with forces, energy and virial."""
    _, model = models
    st = _state(*_thermal(300.0, 0, reps=(2, 2, 2), rattle=0.03))
    sim = Simulation(model, max_neighbors=64, skin=0.1)
    return sim.refresh_forces(st, sim.rebuild(st, grid=(2, 2, 2), max_neighbors=64))


def test_thermo_logger_matches_jax(models):
    from mtp_tpu.md.output import ThermoLogger as JaxThermo

    st = _evaluated(models)
    cols = ("step", "temp", "pe", "ke", "etotal", "press", "vol", "max_grade")
    buf, buf_j = io.StringIO(), io.StringIO()
    log, log_j = ThermoLogger(cols, stream=buf), JaxThermo(cols, stream=buf_j)
    sj = _jax_state_of(st)
    for extra in ({}, {"max_grade": 1.5}):
        log(st, **extra)
        log_j(sj, **extra)
    assert len(log.history) == 2 and abs(log.column("temp")[0] - 300.0) < 1.0
    for row, row_j in zip(log.history, log_j.history):
        for c in cols:
            assert row[c] == pytest.approx(row_j[c], rel=1e-12, nan_ok=True), c
    assert buf.getvalue() == buf_j.getvalue()
    with pytest.raises(ValueError, match="unknown thermo"):
        ThermoLogger(("temp", "bogus"))


def test_xyz_dump_matches_jax(models, tmp_path):
    from mtp_tpu.md.output import XYZDumpWriter as JaxXYZ

    st = _evaluated(models)
    grades = np.arange(st.n_atoms, dtype=float)
    for writer, state, name in ((XYZDumpWriter, st, "port"),
                                (JaxXYZ, _jax_state_of(st), "jax")):
        with writer(str(tmp_path / f"{name}.xyz"), species=("Ni",)) as w:
            w.write(state, forces=True, grades=grades)
            w.write(state)
    text = (tmp_path / "port.xyz").read_text()
    assert text == (tmp_path / "jax.xyz").read_text()
    lines = text.splitlines()
    assert lines[0] == str(st.n_atoms) and "nbh_grade" in lines[1]
    assert float(lines[2 + 5].split()[-1]) == 5.0 and len(lines) == 2 * (st.n_atoms + 2)


@pytest.mark.parametrize("ensemble", (None, "nvt", "npt", "npt-tri", "langevin"))
def test_checkpoint_roundtrip(models, tmp_path, ensemble):
    from mtp_tpu_torch.md.simulation import _default_aux

    st = _evaluated(models)
    aux = None if ensemble is None else _default_aux(ensemble, st)
    if ensemble == "langevin":
        torch.randn(5, generator=aux.generator)  # a state past the seed's
    f = str(tmp_path / "ckpt.npz")
    save_checkpoint(f, st, aux)
    st2, aux2 = load_checkpoint(f, device="cpu")
    for name in ("positions", "velocities", "forces", "masses", "types", "cell",
                 "potential_energy", "virial", "step"):
        a, b = getattr(st, name), getattr(st2, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert type(aux2) is type(aux)
    if ensemble == "langevin":
        assert torch.equal(aux2.generator.get_state(), aux.generator.get_state())
    elif ensemble is not None:
        flat = lambda a: [x for leaf in a for x in (flat(leaf) if isinstance(leaf, tuple)
                                                    else [leaf])]  # noqa: E731
        assert all(torch.equal(x, y) for x, y in zip(flat(aux), flat(aux2)))
    st3, _ = load_checkpoint(f, dtype=torch.float32, device="cpu")
    assert st3.positions.dtype == torch.float32 and st3.types.dtype == torch.int32


@pytest.mark.parametrize("ensemble", ("npt-tri", "langevin"))
def test_resumed_run_is_bit_identical(models, tmp_path, ensemble):
    """10 steps, a checkpoint, a new process's worth of objects, 10 more:
    bit for bit the 20 unbroken steps."""
    _, model = models
    st = _state(*_thermal(300.0, 3))
    kw = dict(ensemble=ensemble, dt=0.001, temperature=300.0, pressure=0.0, tdamp=0.1,
              pdamp=0.5)

    def sim():
        return Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=5)

    whole, aux_whole, _ = sim().run_async(st, 20, **kw)
    half, aux, _ = sim().run_async(st, 10, **kw)
    f = str(tmp_path / "half.npz")
    save_checkpoint(f, half, aux)
    half2, aux2 = load_checkpoint(f, device="cpu")
    out, aux_out, _ = sim().run_async(half2, 10, aux=aux2, refresh=False, **kw)
    for name in ("positions", "velocities", "forces", "cell", "virial", "potential_energy"):
        assert torch.equal(getattr(out, name), getattr(whole, name)), name
    assert int(out.step) == 20


# ---- LAMMPS data files (tests/test_lammps_data.py)


def test_lammps_roundtrip_orthorhombic_and_triclinic(tmp_path):
    from mtp_tpu.io.lammps_data import read_lammps_data as read_jax

    pos, types, cell = make_lattice("fcc", 4.0, (2, 2, 2), type_pattern=(0, 1))
    rng = np.random.default_rng(0)
    pos = pos + rng.normal(0, 0.05, pos.shape)
    masses = np.where(types == 0, 58.693, 26.98)
    vel = rng.normal(0, 0.1, pos.shape)
    p = tmp_path / "box.data"
    write_lammps_data(p, pos, types, masses, cell, velocities=vel)
    d = read_lammps_data(p)
    np.testing.assert_allclose(d.positions, pos, atol=1e-12)
    np.testing.assert_array_equal(d.types, types)
    np.testing.assert_allclose(d.masses, masses)
    np.testing.assert_allclose(d.cell, cell, atol=1e-12)
    np.testing.assert_allclose(d.velocities, vel, atol=1e-12)
    np.testing.assert_allclose(d.type_masses, [58.693, 26.98])
    dj = read_jax(p)
    for f in ("positions", "types", "masses", "cell", "velocities", "type_masses"):
        np.testing.assert_array_equal(getattr(d, f), getattr(dj, f))

    tri = np.array([[10.0, 0, 0], [1.5, 9.0, 0], [-0.7, 0.9, 8.0]])
    pos = rng.uniform(0, 1, (20, 3)) @ tri
    p = tmp_path / "tri.data"
    write_lammps_data(p, pos, np.zeros(20, np.int32), np.full(20, 39.0983), tri)
    d = read_lammps_data(p)
    np.testing.assert_allclose(d.cell, tri, atol=1e-12)
    np.testing.assert_allclose(d.positions, pos, atol=1e-12)
    assert d.velocities is None


_DATA = (
    "hdr\n\n3 atoms\n0 bonds\n2 atom types\n\n"
    "-2.0 8.0 xlo xhi\n1.0 9.0 ylo yhi\n0.0 12.0 zlo zhi\n\n"
    "Masses\n\n1 10.0\n2 20.0\n\n"
    "Atoms\n\n2 1 0.0 2.0 3.0\n1 2 -1.0 1.5 0.5\n3 1 7.9 8.9 11.9\n"
)


def test_lammps_reader_header_variants(tmp_path):
    """Origin shift, image-flag unwrap, comments, CRLF, reordered ids."""
    text = (
        "LAMMPS data file  # free-form comment\r\n\r\n3 atoms\r\n0 bonds\r\n"
        "2 atom types  # trailing comment\r\n\r\n-2.0 8.0 xlo xhi\r\n1.0 9.0 ylo yhi\r\n"
        "0.0 12.0 zlo zhi\r\n\r\nMasses\r\n\r\n1 10.0\r\n2 20.0  # heavy\r\n\r\n"
        "Atoms # atomic\r\n\r\n2 1 0.0 2.0 3.0 1 0 0\r\n1 2 -1.0 1.5 0.5\r\n"
        "3 1 7.9 8.9 11.9 0 0 -1\r\n"
    )
    p = tmp_path / "v.data"
    p.write_text(text)
    d = read_lammps_data(p)
    np.testing.assert_allclose(d.positions[0], [1.0, 0.5, 0.5])
    np.testing.assert_allclose(d.positions[1], [2.0 + 10.0, 1.0, 3.0])
    np.testing.assert_allclose(d.positions[2], [9.9, 7.9, 11.9 - 12.0])
    np.testing.assert_array_equal(d.types, [1, 0, 0])
    np.testing.assert_allclose(d.masses, [20.0, 10.0, 10.0])


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda t: t.replace("3 atoms", ""), "missing 'atoms'"),
        (lambda t: t.replace("0.0 12.0 zlo zhi\n", ""), "missing box bounds"),
        (lambda t: t.replace("0 bonds", "2 bonds"), "topology"),
        (lambda t: t.replace("2 1 0.0 2.0 3.0", "2 1 0.0 2.0"), "fields"),
        (lambda t: t + "Bonds\n\n1 1 1 2\n", "not supported"),
        (lambda t: t.replace("1 2 -1.0 1.5 0.5\n", ""), "truncated"),
    ],
)
def test_lammps_reader_rejects(tmp_path, mutate, match):
    p = tmp_path / "bad.data"
    p.write_text(mutate(_DATA))
    with pytest.raises(ValueError, match=match):
        read_lammps_data(p)


def test_lammps_writer_rejects_non_lammps_frame(tmp_path):
    cell = np.array([[10.0, 0.5, 0], [0, 9.0, 0], [0, 0, 8.0]])  # upper tilt
    with pytest.raises(ValueError, match="lower-triangular"):
        write_lammps_data(tmp_path / "x.data", np.zeros((1, 3)), [0], [1.0], cell)


def test_md_from_data_file(models, tmp_path):
    """A data file drives the same force evaluation as the arrays it holds."""
    _, model = models
    pos, types, masses, cell = _rattled((3, 3, 3), 0.05, 2)
    p = tmp_path / "fcc.data"
    write_lammps_data(p, pos, types, masses, cell)
    d = read_lammps_data(p)
    sim = Simulation(model, max_neighbors=64, skin=0.5)
    grid = grid_shape(cell, model.cutoff + 0.5)

    def forces(positions):
        st = _state(positions, d.types, d.masses, d.cell)
        return sim.refresh_forces(st, sim.rebuild(st, grid=grid, max_neighbors=64))

    a, b = forces(pos), forces(d.positions)
    np.testing.assert_allclose(b.forces.numpy(), a.forces.numpy(), rtol=0, atol=TOL)
    assert abs(float(b.potential_energy) - float(a.potential_energy)) < TOL


# ---- active learning under NPT


def test_run_with_extrapolation_under_npt_matches_jax(mtp_level8, tmp_path):
    """10 NPT steps graded every 5 (MLIP-3 style, selecting every
    evaluation): the trajectory, cell, grades and .cfg stream of the JAX
    driver; the barostat continues from each grade step's refresh."""
    from mtp_tpu.al.driver import ExtrapolationMonitor as JaxMonitor
    from mtp_tpu.al.driver import run_with_extrapolation as run_jax
    from mtp_tpu_torch.al.driver import ExtrapolationMonitor, run_with_extrapolation
    from mtp_tpu_torch.al.grades import candidate_vectors
    from mtp_tpu_torch.al.maxvol import build_mvs

    tm0 = model_from_jax(JaxModel.from_data(mtp_level8, dtype=jnp.float64), device="cpu")
    rows = []
    for k, s in enumerate((0.05, 0.1)):
        pos, types, _, cell = _rattled((3, 3, 3), s, 100 + k)
        nl = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), tm0.cutoff,
                                 max_neighbors=64, grid=grid_shape(cell, tm0.cutoff))
        b, _ = candidate_vectors(tm0, torch.as_tensor(pos), torch.as_tensor(types), nl.idx,
                                 torch.as_tensor(cell))
        rows.append(b.numpy())
    m = dataclasses.replace(mtp_level8, mvs=build_mvs(np.concatenate(rows), mode="neighborhood"))
    jm = JaxModel.from_data(m, dtype=jnp.float64)
    tm = model_from_jax(jm, device="cpu")
    pos, types, masses, cell, vel = _thermal(300.0, 11)
    kw = dict(ensemble="npt", dt=0.001, temperature=300.0, pressure=0.0, tdamp=0.1, pdamp=0.5)

    mon_j = JaxMonitor(jm, select_threshold=0.0, break_threshold=1e9,
                       output_path=str(tmp_path / "jax.cfg"), max_neighbors=64)
    sj = run_jax(JaxSimulation(jm, max_neighbors=64, skin=0.6, steps_per_rebuild=5),
                 mon_j, init_jax(pos, types, masses, cell, velocities=vel, dtype=jnp.float64),
                 10, al_every=5, **kw)
    mon_j.close()
    mon = ExtrapolationMonitor(tm, select_threshold=0.0, break_threshold=1e9,
                               output_path=str(tmp_path / "port.cfg"))
    st = run_with_extrapolation(Simulation(tm, max_neighbors=64, skin=0.6, steps_per_rebuild=5),
                                mon, _state(pos, types, masses, cell, vel), 10, al_every=5, **kw)
    mon.close()
    assert int(st.step) == 10
    assert not np.allclose(st.cell.numpy(), cell)  # the barostat moved the cell
    for name in ("positions", "forces", "cell", "virial"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_allclose(mon.nbh_grades, np.asarray(mon_j.nbh_grades), rtol=1e-9)
    text = (tmp_path / "port.cfg").read_text()
    assert text.count("BEGIN_CFG") == 3 and text == (tmp_path / "jax.cfg").read_text()
