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


def _three_line_rule(positions, ref, real=None):
    """The top-2 rule as the call sites wrote it before K10: torch.sum over
    the vector, then max, argmax and the masked second max."""
    d = positions - ref
    d2 = torch.sum(d * d, dim=-1)
    if real is not None:
        d2 = torch.where(real, d2, 0.0)
    rows = torch.arange(d2.shape[0])
    m1 = torch.max(d2)
    return m1, torch.max(torch.where(rows == torch.argmax(d2), 0.0, d2))


def _top2_case(name, dtype):
    g = torch.Generator().manual_seed(7)
    ref = 20.0 * torch.rand(500, 3, generator=g, dtype=dtype)
    x = ref + 0.05 * torch.randn(500, 3, generator=g, dtype=dtype)
    real = None
    if name == "tie":
        ref[[3, 250]] = 5.0  # the same operands: the same largest d2 twice
        x[[3, 250]] = 5.4
    elif name == "one row":
        x, ref = x[:1], ref[:1]
    elif name == "real":
        real = torch.rand(500, generator=g) < 0.6
        x[~real] += 9.0  # trash rows: only the mask keeps them out
    elif name == "one NaN":
        x[11, 2] = float("nan")
    elif name == "two NaN":
        x[11, 2] = x[400, 0] = float("nan")
    return x, ref, real


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["random", "tie", "one row", "real", "one NaN", "two NaN"])
def test_verlet_top2_twin_equals_the_three_line_rule(case, dtype):
    """The plain twin of K10 (CPU tensors) gives the top two and the flag
    that the three-line rule gave: a tie makes m2 = m1, one row m2 = 0,
    trash rows count 0, a NaN propagates as torch.max and torch.argmax
    propagate it and leaves the flag as it was."""
    from mtp_tpu_torch.ops import md_step as ms

    x, ref, real = _top2_case(case, dtype)
    m1, m2 = _three_line_rule(x, ref, real)
    got = ms.verlet_top2(x, ref, real)
    assert torch.equal(torch.isnan(got), torch.stack([m1, m2]).isnan())
    assert torch.equal(got.nan_to_num(-1.0), torch.stack([m1, m2]).nan_to_num(-1.0))
    if case == "tie":
        assert got[0] == got[1] > 0.4**2
    if case == "one row":
        assert got[1] == 0.0
    s = float(torch.sqrt(m1) + torch.sqrt(m2)) if not m1.isnan() else 0.5
    shrink = torch.tensor(0.01, dtype=dtype)
    for skin in (s * (1 - 1e-6), s * (1 + 1e-6), s - 0.01):
        for sh in (None, shrink):
            for before in (False, True):
                want = bool(before or (torch.sqrt(m1) + torch.sqrt(m2)
                                       + (0.0 if sh is None else sh) > skin))
                flag = torch.tensor(before)
                ms.verlet_check(x, ref, skin, flag, sh, real)
                assert bool(flag) == want, (skin, sh, before)


def test_cpu_tensors_take_the_md_step_twins(alloy):
    """On the CPU the kick, drift and check run their plain twins: two K9
    twin calls and one K10 twin call an NVE step, no launch; the kick is
    out of place."""
    from mtp_tpu_torch.ops import md_step as ms

    jm, pos, types, masses, cell, vel = alloy
    model = model_from_jax(jm, device="cpu", dtype=F64)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=4,
                     compute_virial=False)
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")
    before = [(k.launches, k.plain_calls) for k in (ms.K9, ms.K10)]
    v0 = st.velocities.clone()
    sim.run_async(st, 4, dt=0.001)
    assert ms.K9.launches == before[0][0] and ms.K10.launches == before[1][0]
    assert ms.K9.plain_calls - before[0][1] == 8 and ms.K10.plain_calls - before[1][1] == 4
    assert torch.equal(st.velocities, v0)
    x, v, step = ms.md_step(st.positions, st.velocities, st.forces, st.masses, st.step,
                            kick=0.5, drift=0.001)
    assert int(step) == int(st.step) + 1 and x is not st.positions and v is not st.velocities
    assert ms.K9.plain_calls - before[0][1] == 9 and ms.K9.launches == before[0][0]


def _recording(sim, seen):
    """`sim.force_fn_window` whose closures record the positions of each
    force call (the positions the step's check then reads)."""
    make = sim.force_fn_window

    def spied(*a, **kw):
        fn = make(*a, **kw)

        def force(positions, types, cell):
            seen.append(positions.clone())
            return fn(positions, types, cell)

        force.energy_fn = fn.energy_fn
        return force

    return spied


def _skins_and_flags(seen, ref):
    """Skins either side of each step's sqrt(m1) + sqrt(m2) by the
    three-line rule, and the OR-ed flag that rule gives at each."""
    sums = [float(sum(torch.sqrt(m) for m in _three_line_rule(p, ref))) for p in seen]
    assert sums[-1] > 0.0
    skins = [s * (1 + e) for s in sums for e in (-1e-6, 1e-6)]
    return [(sk, any(s > sk for s in sums)) for sk in skins]


def test_md_and_fire_checks_give_the_flags_of_the_three_line_rule(alloy):
    """The Verlet checks of the MD steps (`Simulation._scan_steps`) and of
    FIRE (`_fire_scan`) trip at the skins where the three-line rule trips,
    over 5 steps, either side of each step's sum."""
    from mtp_tpu_torch.md import integrators as itg
    from mtp_tpu_torch.md.minimize import _fire_scan, fire_init

    jm, pos, types, masses, cell, vel = alloy
    model = model_from_jax(jm, device="cpu", dtype=F64)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=5,
                     compute_virial=False)
    rattled = pos + np.random.default_rng(3).normal(0.0, 0.05, pos.shape)
    st = init_state(rattled, types, masses, cell, velocities=vel * 3.0, dtype=F64,
                    device="cpu")
    nl = sim.rebuild(st, grid=sim.grid_for(st.cell), max_neighbors=64)
    ref = nl.reference_positions[nl.order]
    seen = []
    sim.force_fn_window = _recording(sim, seen)
    force_fn = sim.force_fn_window(nl, st.types, False, sorted_io=True, compute_energy=False)
    st = itg._with_forces(sim._permute_state(st, nl.order), force_fn)
    kw = dict(ensemble="nve", n_steps=5, dt=0.001, temperature=300.0, pressure=0.0,
              tdamp=0.1, pdamp=1.0, ref_positions=ref, ref_cell=nl.reference_cell)
    fire_kw = dict(n_steps=5, ref_positions=ref, dt_max=0.01, dt_min=0.0, alpha0=0.1,
                   n_delay=5, f_inc=1.1, f_dec=0.5, f_alpha=0.99, dmax=0.1)
    for run in ("md", "fire"):
        seen.clear()
        if run == "md":
            sim._scan_steps(st, None, force_fn, **kw)
        else:
            _fire_scan(st, fire_init(0.001, 0.1, F64, "cpu"), force_fn, skin=0.6, **fire_kw)
        steps = list(seen)
        for skin, want in _skins_and_flags(steps, ref):
            if run == "md":
                sim.skin = skin
                _, _, stale = sim._scan_steps(st, None, force_fn, **kw)
            else:
                _, _, stale = _fire_scan(st, fire_init(0.001, 0.1, F64, "cpu"), force_fn,
                                         skin=skin, **fire_kw)
            assert bool(stale) == want, (run, skin)
        assert any(w for _, w in _skins_and_flags(steps, ref))
        assert not all(w for _, w in _skins_and_flags(steps, ref))
