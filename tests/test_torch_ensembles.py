"""The port's ensembles (NVT, Langevin, MTK NPT iso/aniso/tri) in float64 on
the CPU, against ``mtp_tpu`` run as its own tests run it (``backend="xla",
window=False``) from the same numpy initial velocities, and the per-atom
virial and the window-path virial.

Tolerances, absolute unless said otherwise (measured values in brackets):
- 20-step trajectories, 256-atom two-species level-8 box, ``run_async`` at
  steps_per_rebuild 10: positions, velocities, cell, potential energy,
  virial and every aux leaf 1e-10 [at most 1.3e-14 A, 1.9e-13 A/ps,
  5.3e-15 A, 2.8e-14 eV, 9.5e-13 eV, 1.1e-13 in the aux]. Both integrate
  the same float64 forces, summed in another order.
- Langevin at T = 0 (the noise drops out) the same 1e-10 [3.6e-15 A/ps].
- A JAX run of 10 steps continued 10 in the port through ``aux_from_jax``
  against 20 JAX steps: 1e-10.
- Conserved quantities and volume/pressure on one state and aux: 1e-10 eV,
  relative 1e-12 on the volume and the pressure.
- Drift bounds: those of ``tests/test_md.py`` on its 108-atom box and from
  its starts (velocities from its ``thermalize`` keys): NVT, NPT and NPT-tri
  conserved quantities; the aniso cell stays orthorhombic; the tri barostat
  relaxes an imposed shear to under half; Langevin reaches its band.
- Window-path vatom against the JAX plain path's ``compute_vatom``: 1e-10
  eV per atom, and its sum equals the virial to 1e-10 eV.
- Window-path virial against the strain derivative of the energy: relative
  1e-4 (``tests/test_virial.py``'s bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.md import integrators as jitg
from mtp_tpu.md.simulation import Simulation as JaxSimulation
from mtp_tpu.md.state import init_state as init_jax
from mtp_tpu.md.state import pressure_of as pressure_jax
from mtp_tpu.md.state import volume_of as volume_jax
from mtp_tpu.models.mtp import MTPModel as JaxModel
from mtp_tpu.models.mtp import mtp_energy_forces as mef_jax
from mtp_tpu.ops.neighbors import build_neighbor_list as build_jax
from mtp_tpu.ops.neighbors import grid_shape
from mtp_tpu_torch.md import integrators as itg
from mtp_tpu_torch.md.simulation import Simulation, make_lattice
from mtp_tpu_torch.md.state import init_state, pressure_of, volume_of
from mtp_tpu_torch.models.mtp import mtp_energy_forces_window, window_constants
from mtp_tpu_torch.utils import units
from mtp_tpu_torch.utils.convert import aux_from_jax, model_from_jax

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

F64 = torch.float64
TOL = 1e-10
KW = dict(temperature=300.0, pressure=1000.0, tdamp=0.05, pdamp=0.2)
ENSEMBLES = ("nvt", "npt", "npt-aniso", "npt-tri", "langevin")


def _velocities(masses, temperature, seed, shape):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(units.KB * temperature / (masses * units.MVV2E))
    vel = rng.normal(size=shape) * sigma[:, None]
    return vel - (vel * masses[:, None]).sum(0) / masses.sum()


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _from_jax(sj):
    """The port's state holding a JAX state's arrays (float64, CPU)."""
    st = init_state(*(np.array(getattr(sj, k)) for k in ("positions", "types", "masses", "cell")),
                    velocities=np.array(sj.velocities), dtype=F64, device="cpu")
    return dataclasses.replace(st, forces=_t(sj.forces), virial=_t(sj.virial),
                               potential_energy=_t(sj.potential_energy),
                               step=torch.as_tensor(int(sj.step)))


def _leaves(aux):
    """Tensor or array leaves of a (nested) NamedTuple aux, in field order."""
    out = []
    for leaf in aux:
        out += _leaves(leaf) if isinstance(leaf, tuple) else [np.asarray(leaf)]
    return out


def _kw(ensemble):
    # Langevin at T = 0: the noise term is zero, so both packages integrate
    # the same deterministic friction dynamics
    return dict(KW, temperature=0.0) if ensemble == "langevin" else KW


@pytest.fixture(scope="module")
def alloy(mtp_level8_2spec):
    """256-atom two-species fcc box, level 8, numpy velocities at 300 K."""
    jm = JaxModel.from_data(mtp_level8_2spec, dtype=jnp.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (4, 4, 4), type_pattern=(0, 1))
    masses = np.where(types == 0, 58.693, 26.98)
    vel = _velocities(masses, 300.0, 42, pos.shape)
    return jm, model_from_jax(jm, device="cpu"), pos, types, masses, cell, vel


@pytest.fixture(scope="module")
def jax_runs(alloy):
    """{ensemble: (state after 10 steps, aux, state after 20 steps, aux)} of
    the JAX driver; one compiled block per ensemble (10 steps)."""
    jm, _, pos, types, masses, cell, vel = alloy
    sim = JaxSimulation(jm, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                        backend="xla", window=False)
    out = {}
    for ens in ENSEMBLES:
        s0 = init_jax(pos, types, masses, cell, velocities=vel, dtype=jnp.float64)
        s10, a10, f10 = sim.run_async(s0, 10, ensemble=ens, dt=0.001, **_kw(ens))
        s20, a20, f20 = sim.run_async(s10, 10, ensemble=ens, dt=0.001, aux=a10,
                                      refresh=False, **_kw(ens))
        assert not bool(f10) and not bool(f20)
        out[ens] = (s10, a10, s20, a20)
    return out


def _assert_state_close(st, sj):
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), rtol=0, atol=TOL)
    np.testing.assert_allclose(st.velocities.numpy(), np.asarray(sj.velocities), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(st.cell.numpy(), np.asarray(sj.cell), rtol=0, atol=TOL)
    np.testing.assert_allclose(st.virial.numpy(), np.asarray(sj.virial), rtol=0, atol=TOL)
    assert abs(float(st.potential_energy) - float(sj.potential_energy)) < TOL
    assert int(st.step) == int(sj.step)


@pytest.mark.parametrize("ensemble", ENSEMBLES)
def test_trajectory_matches_jax(alloy, jax_runs, ensemble):
    """20 steps of `run_async` (two blocks) from the same numpy velocities:
    positions, velocities, cell, energy, virial and every aux leaf."""
    _, model, pos, types, masses, cell, vel = alloy
    _, _, sj, aj = jax_runs[ensemble]
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10)
    st, aux, fl = sim.run_async(st, 20, ensemble=ensemble, dt=0.001, **_kw(ensemble))
    assert not bool(fl)
    _assert_state_close(st, sj)
    if ensemble == "langevin":
        assert isinstance(aux, itg.LangevinAux)
        return
    got, want = _leaves(aux), _leaves(aj)
    assert len(got) == len(want) == (2 if ensemble == "nvt" else 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    if ensemble == "npt-aniso":  # diagonal barostat: the cell stays orthorhombic
        c = st.cell.numpy()
        assert np.abs(c - np.diag(np.diag(c))).max() == 0.0
        assert not np.allclose(c, cell)


@pytest.mark.parametrize("ensemble", ("nvt", "npt", "npt-tri"))
def test_port_continues_a_jax_trajectory(alloy, jax_runs, ensemble):
    """10 JAX steps, then 10 in the port from the JAX state and its aux
    (``aux_from_jax``), equal 20 JAX steps."""
    _, model, _, _, _, _, _ = alloy
    s10, a10, s20, a20 = jax_runs[ensemble]
    st = _from_jax(s10)
    aux = aux_from_jax(a10, device="cpu")
    assert type(aux).__name__ == type(a10).__name__
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10)
    st, aux, fl = sim.run_async(st, 10, ensemble=ensemble, dt=0.001, aux=aux, refresh=False,
                                **KW)
    assert not bool(fl)
    _assert_state_close(st, s20)
    for g, w in zip(_leaves(aux), _leaves(a20)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_aux_from_jax_refuses_a_langevin_key():
    with pytest.raises(ValueError, match="LangevinAux"):
        aux_from_jax(jitg.LangevinAux(jax.random.PRNGKey(0)), device="cpu")


def test_conserved_quantities_volume_and_pressure_match_jax(alloy, jax_runs):
    """Each conserved quantity, the volume and the pressure of the port on
    the JAX state and aux after 20 steps."""
    sj = jax_runs["npt-tri"][2]
    st = _from_jax(sj)
    assert float(volume_of(st)) == pytest.approx(float(volume_jax(sj)), rel=1e-12)
    assert float(pressure_of(st)) == pytest.approx(float(pressure_jax(sj)), rel=1e-12)
    cases = [
        ("nvt", itg.nvt_conserved, jitg.nvt_conserved, dict(temperature=300.0, tdamp=0.05)),
        ("npt", itg.npt_conserved, jitg.npt_conserved, KW),
        ("npt-aniso", lambda *a, **k: itg.npt_aniso_conserved(*a, couple="aniso", **k),
         lambda *a, **k: jitg.npt_aniso_conserved(*a, couple="aniso", **k), KW),
        ("npt-tri", itg.npt_aniso_conserved, jitg.npt_aniso_conserved, KW),
    ]
    for ens, port_fn, jax_fn, kw in cases:
        aj = jax_runs[ens][3]
        got = float(port_fn(st, aux_from_jax(aj, device="cpu"), **kw))
        want = float(jax_fn(sj, aj, **kw))
        assert abs(got - want) < TOL, (ens, got, want)


# ---- drift bounds of tests/test_md.py, on its 108-atom level-8 box


@pytest.fixture(scope="module")
def nickel(mtp_level8):
    jm = JaxModel.from_data(mtp_level8, dtype=jnp.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    return model_from_jax(jm, device="cpu"), pos, types, np.full(len(pos), 58.693), cell


def _start(nickel, temperature, seed):
    """The start of the tests/test_md.py case: its velocities, drawn by the
    JAX package's `thermalize` from ``PRNGKey(seed)``."""
    from mtp_tpu.md.state import thermalize

    model, pos, types, masses, cell = nickel
    sj = thermalize(jax.random.PRNGKey(seed),
                    init_jax(pos, types, masses, cell, dtype=jnp.float64), temperature)
    return model, init_state(pos, types, masses, cell, velocities=np.array(sj.velocities),
                             dtype=F64, device="cpu")


def test_nvt_conserved_quantity(nickel):
    model, state = _start(nickel, 300.0, 5)
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=20)
    aux = itg.nhc_init(F64, "cpu")
    hs = []
    for _ in range(10):
        state, aux = sim.run(state, 40, aux=aux, ensemble="nvt", dt=0.001,
                             temperature=300.0, tdamp=0.05)
        hs.append(float(itg.nvt_conserved(state, aux, 300.0, 0.05)))
    h = np.array(hs)
    assert np.abs(h - h[0]).max() < 2e-6 * max(1.0, abs(h[0])) * state.n_atoms, h - h[0]


@pytest.mark.parametrize("ensemble", ("npt", "npt-tri"))
def test_npt_conserved_quantity(nickel, ensemble):
    """MTK conserved quantity (barostat and both chains) through the
    barostat's ringing, after the initial ring-down."""
    model, state = _start(nickel, 250.0, 6)
    sim = Simulation(model, max_neighbors=64, skin=0.3, steps_per_rebuild=20)
    kw = dict(temperature=250.0, pressure=0.0, tdamp=0.1, pdamp=0.5)
    tri = ensemble == "npt-tri"
    aux = itg.npt_aniso_init(F64, "cpu") if tri else itg.npt_init(F64, "cpu")
    state, aux = sim.run(state, 80, aux=aux, ensemble=ensemble, dt=0.001, **kw)
    hs = []
    for _ in range(8):
        state, aux = sim.run(state, 40, aux=aux, ensemble=ensemble, dt=0.001, **kw)
        hs.append(float(itg.npt_aniso_conserved(state, aux, couple="tri", **kw) if tri
                        else itg.npt_conserved(state, aux, **kw)))
    h = np.array(hs)
    assert np.abs(h - h[0]).max() < 2e-5 * state.n_atoms, h - h[0]
    if tri:  # the barostat tensor stays symmetric
        bv = aux.baro_v.numpy()
        np.testing.assert_allclose(bv, bv.T, rtol=0, atol=1e-14)


def test_npt_aniso_keeps_cell_orthorhombic(nickel):
    model, state0 = _start(nickel, 250.0, 7)
    sim = Simulation(model, max_neighbors=64, skin=0.3, steps_per_rebuild=10)
    state, _ = sim.run(state0, 60, ensemble="npt-aniso", dt=0.001,
                       temperature=250.0, pressure=0.0, tdamp=0.1, pdamp=0.5)
    cell = state.cell.numpy()
    assert np.abs(cell - np.diag(np.diag(cell))).max() < 1e-12
    assert float(volume_of(state)) != float(volume_of(state0))
    assert bool(state.positions.isfinite().all())


def test_npt_tri_relaxes_shear_stress(nickel):
    """A sheared box under a hydrostatic target relaxes its tilt toward the
    unsheared cell: the late average tilt is under half the imposed one."""
    model, state = _start(nickel, 50.0, 8)
    gamma0 = 0.03
    shear = torch.eye(3, dtype=F64)
    shear[1, 0] = gamma0
    state = dataclasses.replace(state, positions=state.positions @ shear.T,
                                cell=state.cell @ shear.T)
    sim = Simulation(model, max_neighbors=64, skin=0.3, steps_per_rebuild=10)
    tilts = []
    state, _ = sim.run(state, 400, ensemble="npt-tri", dt=0.001, temperature=50.0,
                       pressure=0.0, tdamp=0.1, pdamp=0.05,
                       observer=lambda s: tilts.append(float(s.cell[1, 0] / s.cell[0, 0])))
    late = np.mean(tilts[len(tilts) // 2:])
    assert abs(late) < 0.5 * gamma0, (late, tilts[::4])
    assert bool(state.positions.isfinite().all())


def test_langevin_thermalizes(nickel):
    """BAOAB at 300 K from 100 K: the late mean temperature lies in
    tests/test_md.py's band."""
    from mtp_tpu_torch.md.state import temperature_of

    model, state = _start(nickel, 100.0, 3)
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=10)
    temps = []
    sim.run(state, 300, ensemble="langevin", dt=0.002, temperature=300.0, tdamp=0.05,
            observer=lambda s: temps.append(float(temperature_of(s))))
    late = np.mean(temps[len(temps) // 2:])
    assert 180.0 < late < 450.0, late


def test_langevin_same_seed_is_bit_identical(nickel):
    """Two runs from generators of one seed are bit-identical; another seed
    differs; the caller's aux is left as it was (a retried block draws the
    same noise)."""
    model, state = _start(nickel, 300.0, 1)
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=5)

    def run(seed):
        aux = itg.langevin_init(seed, "cpu")
        before = aux.generator.get_state().clone()
        out, aux2, _ = sim.run_async(state, 10, ensemble="langevin", dt=0.001, aux=aux)
        assert torch.equal(aux.generator.get_state(), before)
        assert not torch.equal(aux2.generator.get_state(), before)
        return out

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a.positions, b.positions) and torch.equal(a.velocities, b.velocities)
    assert not torch.equal(a.velocities, c.velocities)


# ---- the per-atom virial and the window-path virial


def test_window_vatom_matches_jax_plain_path(alloy):
    jm, model, pos, types, masses, cell, vel = alloy
    rng = np.random.default_rng(0)
    pos = pos + rng.normal(0.0, 0.08, pos.shape)
    cut = jm.cutoff + 0.6
    grid = grid_shape(cell, cut)
    nl = build_jax(jnp.asarray(pos), jnp.asarray(cell), cut, max_neighbors=64, grid=grid,
                   with_reverse=True)
    ref = mef_jax(jm.schedule, jm.coeffs, jnp.asarray(pos), jnp.asarray(types), nl.idx,
                  jnp.asarray(cell), nl.mirror, compute_vatom=True, backend="xla")
    sim = Simulation(model, max_neighbors=64, skin=0.6)
    st = init_state(pos, types, masses, cell, dtype=F64, device="cpu")
    swl = sim.rebuild(st, grid=grid, max_neighbors=64)
    out = mtp_energy_forces_window(model, st.positions, st.cell, swl, compute_vatom=True,
                                   **window_constants(model, st.types, swl))
    vatom = out["vatom"].numpy()
    assert vatom.shape == (len(pos), 6)
    np.testing.assert_allclose(vatom, np.asarray(ref["vatom"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(vatom.sum(0), out["virial"].numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(out["virial"].numpy(), np.asarray(ref["virial"]), rtol=0,
                               atol=TOL)
    # the plain path's tally is the same
    from mtp_tpu_torch.models.mtp import mtp_energy_forces
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list

    pnl = build_neighbor_list(st.positions, st.cell, cut, max_neighbors=64, grid=grid)
    plain = mtp_energy_forces(model, st.positions, st.types, pnl.idx, st.cell, pnl.mirror,
                              compute_vatom=True)
    np.testing.assert_allclose(plain["vatom"].numpy(), vatom, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_window_virial_matches_strain_derivative(seed):
    """W_ab = -dE/d(eps_ab) for an affine strain, the window path's virial
    against central differences of its own energy (tests/test_virial.py)."""
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.models.mtp import MTPModel

    model = MTPModel.from_data(make_mtp(8, species_count=1, seed=seed), device="cpu",
                               dtype=F64)
    pos0, types, cell0 = make_lattice("fcc", 4.0, (3, 3, 3))
    pos0 = pos0 + np.random.default_rng(42).normal(scale=0.06, size=pos0.shape)
    sim = Simulation(model, max_neighbors=64, skin=0.6)
    grid = grid_shape(cell0, model.cutoff + 0.6)

    def evaluate(strain):
        f = np.eye(3) + strain
        st = init_state(pos0 @ f.T, types, np.ones(len(pos0)), cell0 @ f.T, dtype=F64,
                        device="cpu")
        swl = sim.rebuild(st, grid=grid, max_neighbors=64)
        return mtp_energy_forces_window(model, st.positions, st.cell, swl,
                                        **window_constants(model, st.types, swl))

    w = evaluate(np.zeros((3, 3)))["virial"].numpy()
    h = 1e-6
    pairs = (((0, 0), 0), ((1, 1), 1), ((2, 2), 2), ((0, 1), 3), ((0, 2), 4), ((1, 2), 5))
    for (a, b), voigt in pairs:
        eps = np.zeros((3, 3))
        eps[a, b] = eps[b, a] = h
        de = (float(evaluate(eps)["energy"]) - float(evaluate(-eps)["energy"])) / (2 * h)
        # a symmetric shear strain couples to W_ab + W_ba = 2 W_voigt
        want = -de if a == b else -de / 2
        assert w[voigt] == pytest.approx(want, rel=1e-4, abs=1e-6), (a, b, w[voigt], want)
