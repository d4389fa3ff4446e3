"""The port's NVE slice, Simulation.run_async on the CPU in float64, against
mtp_tpu's Simulation (XLA backend) from the same numpy initial velocities.

Tolerance for the 20-step trajectory: 1e-10 (A for positions, A/ps for
velocities, eV/A for forces, eV for the potential energy of the 864-atom
box). Measured: 3.6e-15 A, 7.1e-15 A/ps, 2.8e-15 eV/A and 5.7e-14 eV; both
integrate the same float64 forces, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.md.simulation import Simulation as JaxSimulation
from mtp_tpu.md.state import init_state as init_jax
from mtp_tpu.models.mtp import MTPModel as JaxModel
from mtp_tpu_torch.kernels import main_path_kernels
from mtp_tpu_torch.md.simulation import RunFlags, Simulation, make_lattice
from mtp_tpu_torch.md.state import (
    init_state,
    kinetic_energy,
    temperature_of,
    thermalize,
)
from mtp_tpu_torch.utils import units
from mtp_tpu_torch.utils.convert import model_from_jax

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

F64 = torch.float64
TOL = 1e-10


@pytest.fixture(scope="module")
def alloy(mtp_level8_2spec):
    """864-atom two-species fcc box, level 8, numpy Maxwell-Boltzmann
    velocities at 300 K shared by both packages."""
    jm = JaxModel.from_data(mtp_level8_2spec, dtype=jnp.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6), type_pattern=(0, 1))
    n = len(pos)
    masses = np.where(types == 0, 58.693, 26.98)
    rng = np.random.default_rng(42)
    sigma = np.sqrt(units.KB * 300.0 / (masses * units.MVV2E))
    vel = rng.normal(size=(n, 3)) * sigma[:, None]
    vel -= (vel * masses[:, None]).sum(0) / masses.sum()
    return jm, pos, types, masses, cell, vel


def test_nve_trajectory_matches_jax(alloy):
    jm, pos, types, masses, cell, vel = alloy
    sj = init_jax(pos, types, masses, cell, velocities=vel, dtype=jnp.float64)
    sim_j = JaxSimulation(jm, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                          backend="xla", window=False, compute_virial=False)
    sj, _, fj = sim_j.run_async(sj, 20, ensemble="nve", dt=0.001)
    assert not bool(fj)

    model = model_from_jax(jm, device="cpu", dtype=F64)
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                     compute_virial=False)
    st, _, fl = sim.run_async(st, 20, dt=0.001)
    assert not bool(fl.overflow) and not bool(fl.stale)
    assert int(st.step) == 20
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), atol=TOL)
    np.testing.assert_allclose(st.velocities.numpy(), np.asarray(sj.velocities), atol=TOL)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(sj.forces), atol=TOL)
    assert abs(float(st.potential_energy) - float(sj.potential_energy)) < TOL


def test_nve_conserves_energy(alloy):
    """Total energy along 60 f64 steps (Ni masses, 300 K, dt = 1 fs) stays
    within 5e-6 eV/atom of its start; the velocity-Verlet fluctuation
    measured on this box is ~1.6e-6 eV/atom peak to peak."""
    jm, pos, types, _, cell, vel = alloy
    masses = np.full(len(pos), 58.693)
    model = model_from_jax(jm, device="cpu", dtype=F64)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=5,
                     compute_virial=False)
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    energies = []
    refresh = True
    for _ in range(12):
        st, _, fl = sim.run_async(st, 5, dt=0.001, refresh=refresh)
        assert not bool(fl)
        refresh = False
        energies.append(float(st.potential_energy + kinetic_energy(st)))
    assert int(st.step) == 60
    assert np.max(np.abs(np.array(energies) - energies[0])) / len(pos) < 5e-6


def test_thermalize_sets_temperature_and_zero_momentum(alloy):
    _, pos, types, masses, cell, _ = alloy
    st = init_state(pos, types, masses, cell, dtype=F64, device="cpu")
    st = thermalize(torch.Generator().manual_seed(0), st, 300.0)
    assert abs(float(temperature_of(st)) - 300.0) < 1e-9
    p = (st.velocities * st.masses[:, None]).sum(0)
    assert float(p.abs().max()) < 1e-10
    again = thermalize(torch.Generator().manual_seed(0), st, 300.0)
    assert torch.equal(again.velocities, st.velocities)


def test_flags_report_overflow_and_staleness_apart(alloy):
    jm, pos, types, masses, cell, vel = alloy
    model = model_from_jax(jm, device="cpu", dtype=F64)
    st = init_state(pos, types, masses, cell, velocities=vel * 40.0, dtype=F64, device="cpu")
    hot = Simulation(model, max_neighbors=64, skin=0.1, steps_per_rebuild=5)
    _, _, fl = hot.run_async(st, 5, dt=0.001)
    assert bool(fl.stale) and not bool(fl.overflow) and bool(fl)
    narrow = Simulation(model, max_neighbors=24, skin=0.6, steps_per_rebuild=2)
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    _, _, fl = narrow.run_async(st, 2, dt=0.001)
    assert bool(fl.overflow) and not bool(fl.stale)
    clear = RunFlags(overflow=torch.tensor(False), stale=torch.tensor(False))
    assert not bool(clear)


def test_run_async_returns_the_last_list_and_permutes_back(alloy):
    """The block driver integrates in sorted space and returns the state in
    user order: types and masses come back unchanged; the returned list is
    the final block's."""
    jm, pos, types, masses, cell, vel = alloy
    model = model_from_jax(jm, device="cpu", dtype=F64)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=3,
                     compute_virial=False)
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    out, aux, fl, nl = sim.run_async(st, 4, dt=0.001, return_nl=True)
    assert aux is None and not bool(fl)
    assert torch.equal(out.types, st.types) and torch.equal(out.masses, st.masses)
    # the last block (1 step) was built from the state after step 3
    assert float((nl.reference_positions - out.positions).abs().max()) < 0.01
    with pytest.raises(ValueError, match="unknown ensemble"):
        sim.run_async(st, 1, ensemble="nvx")


def test_cpu_run_launches_no_kernel(alloy):
    jm, pos, types, masses, cell, vel = alloy
    model = model_from_jax(jm, device="cpu", dtype=F64)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=2)
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    sim.run_async(st, 2, dt=0.001)
    assert all(k.launches == 0 for k in main_path_kernels())


def test_device_window_counts_overlaps_once():
    """The profiler's idle share reads span and busy time from one trace:
    overlapping device events count once, host events not at all; its
    kernel count takes kernels only."""
    from mtp_tpu_torch.utils.prof import device_window, kernel_count

    ev = [
        dict(ph="X", cat="kernel", ts=10.0, dur=5.0),
        dict(ph="X", cat="gpu_memcpy", ts=12.0, dur=5.0),  # overlaps: busy 10-17
        dict(ph="X", cat="cpu_op", ts=0.0, dur=100.0),  # host: ignored
        dict(ph="X", cat="kernel", ts=30.0, dur=10.0),
    ]
    assert device_window(ev) == (30.0, 17.0)
    assert kernel_count(ev) == 2
    with pytest.raises(ValueError):
        device_window(ev[2:3])
