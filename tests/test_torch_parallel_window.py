"""The port's multi-device MD on the window path (``mtp_tpu_torch.parallel``,
``ShardedSimulation`` and the sharded AL driver) in float64 on the CPU.

The multi-rank cases run in ONE spawned world of two gloo ranks per module
(``_torch_spawn.World``, ``_torch_parallel_ranks.window_cases``), with a
time limit of its own, while this process computes the references: the JAX
package's single-device XLA trajectory (``Simulation(backend="xla",
window=False).run``, which the JAX package's own
``tests/test_parallel_window.py`` holds its ``ShardedSimulation`` against),
from the same NumPy initial velocities, and the port's single-device grade
step and AL driver.

Boxes: the JAX tests' ``cubic_system`` (fcc (8,4,4), 512 atoms) for NVE,
NVT, grades, recovery and AL; their ``npt_system`` (fcc (8,5,5), 800 atoms,
grid margin 1.08) for MTK NPT iso and tri. Level 8, skin 0.3, two slabs
along x. The halo capacities are 1.3x a face shell's share
(``mtp_tpu_torch.parallel.domain.halo_capacities``); the maximal default
is checked by the recovery cases.

Tolerances (absolute unless said otherwise), those of the JAX tests:
positions and forces 1e-10, energy 1e-9 eV, virial 1e-9 eV, the cell and
the thermostat and barostat chains 1e-12; grades 1e-10 relative to the
largest grade. The replicated fields are bit-equal on both ranks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.md.simulation import Simulation as JaxSimulation
from mtp_tpu.md.state import init_state as init_jax
from mtp_tpu.models.mtp import MTPModel as JaxModel
from mtp_tpu_torch.al.driver import ExtrapolationMonitor, run_with_extrapolation
from mtp_tpu_torch.al.grades import candidate_vectors, grade_eval_window
from mtp_tpu_torch.al.maxvol import build_mvs
from mtp_tpu_torch.io.cfg_file import read_cfgs
from mtp_tpu_torch.md.simulation import Simulation, make_lattice
from mtp_tpu_torch.md.state import init_state
from mtp_tpu_torch.ops.neighbors import build_neighbor_list, build_sorted_neighbor_list, grid_shape
from mtp_tpu_torch.parallel.comm import Comm
from mtp_tpu_torch.utils import units

from _torch_parallel_ranks import SKIN, level8, shard
from _torch_spawn import World, world_of_one
from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

F64 = torch.float64
TOL_X, TOL_E, TOL_CHAIN, TOL_GRADE = 1e-10, 1e-9, 1e-12, 1e-10
KW_NPT = dict(temperature=280.0, pressure=0.0, tdamp=0.1, pdamp=0.5)
ENSEMBLES = {"nvt": dict(temperature=280.0, tdamp=0.1), "npt": KW_NPT, "npt-tri": KW_NPT}


def _box(reps, seed, temperature):
    """fcc lattice with NumPy Maxwell-Boltzmann velocities (zero momentum)."""
    pos, types, cell = make_lattice("fcc", 4.0, reps)
    masses = np.full(len(pos), 58.693)
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(units.KB * temperature / (masses * units.MVV2E))
    vel = rng.normal(size=pos.shape) * sigma[:, None]
    vel -= (vel * masses[:, None]).sum(0) / masses.sum()
    return dict(pos=pos, types=types, masses=masses, cell=cell, vel=vel)


def _inverse_active_set(box):
    """An MVS from float64 candidate vectors of two perturbed copies (the
    pattern of the JAX tests' ``al_system``)."""
    model = level8()
    rng = np.random.default_rng(7)
    cell = torch.as_tensor(box["cell"])
    rows = []
    for s in (0.02, 0.08):
        p = torch.as_tensor(box["pos"] + rng.normal(scale=s, size=box["pos"].shape))
        nl = build_neighbor_list(p, cell, model.cutoff, max_neighbors=64,
                                 grid=grid_shape(box["cell"], model.cutoff))
        b, _ = candidate_vectors(model, p, torch.as_tensor(box["types"]), nl.idx, cell)
        rows.append(b.numpy())
    return build_mvs(np.concatenate(rows), mode="neighborhood").inverse_active_set


def _jax_runs(mtp_data, cubic, npt_box):
    """The JAX single-device XLA references from the same velocities."""
    jm = JaxModel.from_data(mtp_data, dtype=jnp.float64)

    def start(box):
        return init_jax(box["pos"], box["types"], box["masses"], box["cell"],
                        velocities=box["vel"], dtype=jnp.float64)

    def np_state(s):
        return {k: np.asarray(getattr(s, k)) for k in
                ("positions", "forces", "velocities", "cell", "potential_energy", "virial")}

    out = {}
    sim = JaxSimulation(jm, max_neighbors=64, skin=SKIN, steps_per_rebuild=10,
                        backend="xla", window=False)
    s10, _ = sim.run(start(cubic), 10, ensemble="nve", dt=0.001)
    s20, _ = sim.run(s10, 10, ensemble="nve", dt=0.001)
    out["nve10"], out["nve"] = np_state(s10), np_state(s20)
    s, aux = sim.run(start(cubic), 20, ensemble="nvt", dt=0.001, **ENSEMBLES["nvt"])
    out["nvt"] = dict(np_state(s), chains=np.concatenate([aux.xi, aux.eta]))
    sim = JaxSimulation(jm, max_neighbors=64, skin=SKIN, steps_per_rebuild=10,
                        backend="xla", window=False, grid_margin=1.08, compute_virial=True)
    for ens in ("npt", "npt-tri"):
        s, aux = sim.run(start(npt_box), 20, ensemble=ens, dt=0.001, **KW_NPT)
        bv = np.asarray(aux.baro_v)
        out[ens] = dict(np_state(s), chains=np.concatenate(
            [aux.thermo.xi, aux.thermo.eta, aux.baro_thermo.xi, aux.baro_thermo.eta]),
            baro=bv if ens == "npt" else bv[[0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]])
    return out


def _port_references(cubic, inv, cfg_dir):
    """The port's single-device grade steps at the lattice positions (both
    modes) and its AL driver, MLIP-3 style, every 4 steps at 5 per block."""
    p, c = torch.as_tensor(cubic["pos"]), torch.as_tensor(cubic["cell"])
    t = torch.as_tensor(cubic["types"])
    swl = build_sorted_neighbor_list(p, c, 5.0 + SKIN, max_neighbors=64,
                                     grid=grid_shape(cubic["cell"], 5.0 + SKIN))
    grades = {}
    for cfg_mode in (False, True):
        m = level8(inv, cfg_mode)
        assert m.cutoff == 5.0
        out = grade_eval_window(m, p, t, c, swl, m.inverse_active_set, config_mode=cfg_mode)
        grades[cfg_mode] = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                            for k, v in out.items()}
    m = level8(inv)
    sim = Simulation(m, max_neighbors=64, skin=SKIN, steps_per_rebuild=5)
    st = init_state(cubic["pos"], cubic["types"], cubic["masses"], cubic["cell"],
                    velocities=cubic["vel"], dtype=F64, device="cpu")
    mon = ExtrapolationMonitor(m, select_threshold=0.0, break_threshold=1e9,
                               output_path=f"{cfg_dir}/single.cfg")
    final = run_with_extrapolation(sim, mon, st, 12, al_every=4, ensemble="nve", dt=0.001)
    mon.close()
    return grades, final.positions.numpy()


@pytest.fixture(scope="module")
def cases(mtp_level8, tmp_path_factory):
    """(rank results, JAX references, port references, box, the directory
    of the .cfg files): the two-rank world runs while the references are
    computed here."""
    cubic = _box((8, 4, 4), 0, 300.0)
    npt_box = _box((8, 5, 5), 1, 280.0)
    inv = _inverse_active_set(cubic)
    d = tmp_path_factory.mktemp("window_world")
    world = World("_torch_parallel_ranks:window_cases", 2, d, timeout=120.0, cubic=cubic,
                  npt_box=npt_box, ensembles=ENSEMBLES, inverse_active_set=inv, cfg_dir=str(d))
    try:
        jax_ref = _jax_runs(mtp_level8, cubic, npt_box)
        port_ref = _port_references(cubic, inv, str(d))
        ranks = world.results()
    finally:
        world.kill()
    return ranks, jax_ref, port_ref, cubic, d


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _same_trajectory(got, ref):
    _close(got["positions"], ref["positions"], TOL_X)
    _close(got["forces"], ref["forces"], TOL_X)
    _close(got["velocities"], ref["velocities"], TOL_X)
    assert got["energy"] == pytest.approx(float(ref["potential_energy"]), abs=TOL_E)


def test_two_rank_world_shift_sum_max(cases):
    """The transport in a world of two ranks: left and right are one peer;
    one batch carries a message each way, and each lands on its side; sum,
    max and OR are the same on both ranks."""
    for rank, r in enumerate(cases[0]):
        c, peer = r["comm"], 1 - rank
        assert c["from_left"] == [float(peer), 10.0 * peer + 1.0]
        assert c["from_right"] == [peer + 100.0, 10.0 * peer + 101.0]
        assert c["sum"] == [1.0, 12.0] and c["max"] == [1.0, 11.0] and c["any"] is True


def test_nve_on_two_slabs_matches_jax(cases):
    """20 NVE steps (two blocks) on 2 slabs, atoms migrating between them,
    against the JAX single-device XLA trajectory."""
    ranks, ref, *_ = cases
    got = ranks[0]["nve"]
    assert not got["flags"]
    assert sum(r["nve"]["arrived"] for r in ranks) > 0  # migration happened
    _same_trajectory(got, ref["nve"])


def test_replicated_fields_are_bit_equal_on_both_ranks(cases):
    """The cell, energy, virial and thermostat state: one value on every
    rank (sums over ranks in rank order)."""
    ranks = cases[0]
    for name in ("nve", *ENSEMBLES, "overflow", "stale"):
        assert ranks[0][name]["replicated"], name


@pytest.mark.parametrize("ensemble", list(ENSEMBLES))
def test_thermostatted_runs_match_jax(cases, ensemble):
    """NHC-NVT, MTK NPT iso and tri on 2 slabs against the JAX single-device
    integrators: trajectory, cell, and the chain and barostat state."""
    ranks, ref, *_ = cases
    got, r = ranks[0][ensemble], ref[ensemble]
    assert not got["flags"]
    _same_trajectory(got, r)
    _close(got["cell"], r["cell"], TOL_CHAIN)
    th = got["thermo"]
    if ensemble == "nvt":
        _close(th[:4], r["chains"], TOL_CHAIN)
        return
    _close(th[:8], r["chains"], TOL_CHAIN)
    _close(th[8] if ensemble == "npt" else th[8:14], r["baro"], TOL_CHAIN)
    _close(got["virial"], r["virial"], TOL_E)


@pytest.mark.parametrize("cfg_mode", [False, True], ids=["neighborhood", "configuration"])
def test_grades_match_single_device(cases, cfg_mode):
    """``grade_eval`` on 2 slabs (K5's plain twin on each rank's extended
    set, max and sum over ranks) against the single-device
    ``grade_eval_window``, and the force refresh of the same pass."""
    ranks, _, (grades, _), *_ = cases
    got, ref = ranks[0][f"grades_cfg{int(cfg_mode)}"], grades[cfg_mode]
    assert not got["flags"]
    g = float(ref["max_grade"])
    assert abs(got["max_grade"] - g) <= TOL_GRADE * g
    if not cfg_mode:
        _close(got["grades"], ref["grades"], TOL_GRADE * g)
    _close(got["forces"], ref["forces"], TOL_X)
    assert got["energy"] == pytest.approx(float(ref["energy"]), abs=TOL_E)
    _close(got["virial"], ref["virial"], TOL_E)


def test_run_recovers_from_neighbor_overflow(cases):
    """J = 40 is below fcc's 42 in-cutoff neighbors: `run` discards the
    tripped block, grows J and lands on the JAX trajectory."""
    ranks, ref, *_ = cases
    got = ranks[0]["overflow"]
    assert not got["flags"] and got["max_neighbors"] > 40
    _same_trajectory(got, ref["nve10"])


def test_run_recovers_from_staleness(cases):
    """A 0.12 A skin: `run` halves the block until it holds, and lands on
    the JAX trajectory; a system that outruns the skin in one step raises
    at steps_per_rebuild = 1."""
    ranks, ref, *_ = cases
    got = ranks[0]["stale"]
    assert not got["flags"] and got["steps_per_rebuild"] < 10
    _same_trajectory(got, ref["nve10"])
    assert "steps_per_rebuild=1" in ranks[0]["diverging"]


def test_run_async_flags_staleness(cases):
    """The no-read path flags a stale block instead of recovering."""
    assert cases[0][0]["async_stale"]


def test_recover_raises_at_dead_ends(cases):
    """`_recover` raises once a flag has no lever left (J at its bound,
    maximal halo, migration buffers covering every slot, one-step blocks)
    and grows the capacity otherwise."""
    r = cases[0][0]["recover"]
    assert r["nbr_at_bound"].startswith("raised") and "not a list-width" in r["nbr_at_bound"]
    assert r["halo_max_is_none"] and "thinner than" in r["halo_at_max"]
    assert r["halo_finite"].startswith("halo_capacity") and r["halo_after"] is None
    assert "exceeds its capacity" in r["mig_at_max"]
    assert r["mig_finite"].startswith("migrate_capacity")
    assert "staleness at steps_per_rebuild=1" in r["stale_at_one"]
    assert "escape at steps_per_rebuild=1" in r["escape_at_one"]


def test_sharded_al_writes_what_the_single_device_driver_writes(cases):
    """``run_sharded_with_extrapolation`` on 2 slabs (grading every 4 steps,
    selecting everything) writes the same configurations as the port's
    single-device driver, and its force refresh leaves the trajectory as
    the single-device one."""
    ranks, _, (_, single_final), cubic, d = cases
    got = ranks[0]["al"]
    n = len(cubic["pos"])
    assert got["max_grade"] > 0 and got["n_grades"] == n
    _close(got["positions"], single_final, TOL_X)
    sharded, single = read_cfgs(str(d / "selected.cfg")), read_cfgs(str(d / "single.cfg"))
    assert len(sharded) == len(single) == 4  # the first grade step + one per segment
    # as written: positions with 6 decimals, grades with 5 (one unit of the
    # last decimal covers a rounding that the 1e-14 differences can tip)
    for a, b in zip(sharded, single):
        np.testing.assert_array_equal(a.types, b.types)
        _close(a.positions, b.positions, 1.01e-6)
        _close(a.grades, b.grades, 1.01e-5)
        assert float(a.features["MV_grade"]) == pytest.approx(
            float(b.features["MV_grade"]), abs=1.01e-6)


def test_sharded_al_break_flushes_first(cases):
    """A break threshold of 0: the first selected configuration is written
    and flushed before the run raises."""
    ranks, *_, d = cases
    assert ranks[0]["al"]["broke"]
    assert len(read_cfgs(str(d / "break.cfg"))) == 1


def test_world_of_one_in_process(cases, tmp_path):
    """A gloo world of one rank in this process (no spawn): the sharded
    state and driver, no message along the axis, against the JAX
    trajectory."""
    _, ref, *_, cubic, _ = cases
    with world_of_one(tmp_path):
        comm = Comm()
        assert comm.transport == "gloo" and comm.grid == (1,)
        sim, ss = shard(level8(), comm, cubic)
        assert sim.NE == sim.capacity  # no halo
        out, flags = sim.run(ss, 20, ensemble="nve", dt=0.001)
        assert not bool(flags.any())
        pos, frc = out.gather_all([out.positions, out.forces], comm)
    _close(pos, ref["nve"]["positions"], TOL_X)
    _close(frc, ref["nve"]["forces"], TOL_X)
    assert float(out.potential_energy) == pytest.approx(
        float(ref["nve"]["potential_energy"]), abs=TOL_E)
    with pytest.raises(ValueError, match="langevin"):
        sim.steps(out, None, 1, ensemble="langevin")


def test_sharded_check_gives_the_flags_of_the_three_line_rule(cases, tmp_path):
    """The sharded steps' Verlet check (each step's top two over the real
    rows, through K10's wrapper) trips at the skins where the three-line
    rule it replaced trips: on a world of one, either side of each of 4
    steps' sqrt(m1) + sqrt(m2)."""
    *_, cubic, _ = cases
    with world_of_one(tmp_path):
        sim, ss = shard(level8(), Comm(), cubic, vel_scale=3.0)
        state, ctx, _ = sim.rebuild(ss)
        ref, real = state.positions.clone(), state.real
        rows = torch.arange(ref.shape[0])
        sums = []
        for k in range(1, 5):
            out, _ = sim.steps(state, ctx, k, ensemble="nve", dt=0.001, refresh=True)
            d = out.positions - ref
            d2 = torch.where(real, torch.sum(d * d, dim=-1), 0.0)
            m2 = torch.max(torch.where(rows == torch.argmax(d2), 0.0, d2))
            sums.append(float(torch.sqrt(torch.max(d2)) + torch.sqrt(m2)))
        flags = []
        for skin in (s * (1 + e) for s in sums for e in (-1e-6, 1e-6)):
            sim.skin = skin
            _, stale = sim.steps(state, ctx, 4, ensemble="nve", dt=0.001, refresh=True)
            flags.append(bool(stale))
            assert flags[-1] == any(s > skin for s in sums), skin
    assert any(flags) and not all(flags)


def test_sharded_state_from_jax():
    """``sharded_state_from_jax`` gives each rank the slice of a JAX
    ``ShardedState.from_partition`` that the port's own ``from_partition``
    gives it, with the replicated fields."""
    from mtp_tpu.parallel.domain import partition_slabs as jax_partition
    from mtp_tpu.parallel.sharded_md import ShardedState as JaxState
    from mtp_tpu.parallel.sharded_md import make_mesh
    from mtp_tpu_torch.parallel.domain import partition_slabs
    from mtp_tpu_torch.parallel.sharded_md import ShardedState
    from mtp_tpu_torch.utils.convert import sharded_state_from_jax

    box = _box((8, 4, 4), 0, 300.0)
    args = (box["pos"], box["vel"], box["types"], box["masses"], box["cell"], 2)
    jstate = JaxState.from_partition(jax_partition(*args, cutoff=5.3), box["cell"], make_mesh(2),
                                     dtype=jnp.float64)
    part = partition_slabs(*args, cutoff=5.3)
    for rank in range(2):
        a = sharded_state_from_jax(jstate, rank, 2, device="cpu")
        b = ShardedState.from_partition(part, box["cell"], rank, dtype=F64, device="cpu")
        assert a.n_atoms == b.n_atoms == len(box["pos"]) and a.axes == b.axes == (0,)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), f.name
