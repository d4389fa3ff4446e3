"""The port's domain decomposition and transport (``mtp_tpu_torch.parallel``
``domain`` and ``comm``), NVE on a 2x2 brick grid, and the sharded
observables, in float64 on the CPU.

The partition is held against ``mtp_tpu/parallel/domain.py`` (no spawn);
the transport, the brick run and the observables run in ONE spawned world of
four gloo ranks per module (``_torch_spawn.World``,
``_torch_parallel_ranks.grid_cases``), with a time limit of its own, while
this process computes the JAX single-device XLA trajectory of the JAX tests'
``brick_system`` (fcc (8,6,6), 1,152 atoms, level 8, skin 0.3) from the same
NumPy velocities.

Tolerances: the partitions exactly equal; messages and integer-valued sums
exact; the brick trajectory as the JAX tests hold theirs (positions and
forces 1e-10, energy 1e-9 eV); the observables against the single-device
formulas on the gathered state 1e-12 relative (1e-10 for the pressure); two
runs from one state bit-equal.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.md.simulation import Simulation as JaxSimulation
from mtp_tpu.md.state import init_state as init_jax
from mtp_tpu.models.mtp import MTPModel as JaxModel
from mtp_tpu.parallel import domain as jax_domain
from mtp_tpu_torch.md.output import ThermoLogger, XYZDumpWriter, load_checkpoint, save_checkpoint
from mtp_tpu_torch.md.simulation import make_lattice
from mtp_tpu_torch.md.state import MDState, kinetic_energy, pressure_of, temperature_of
from mtp_tpu_torch.ops.neighbors import perpendicular_widths
from mtp_tpu_torch.parallel import domain
from mtp_tpu_torch.parallel.comm import Comm
from mtp_tpu_torch.utils import units

from _torch_parallel_ranks import SKIN, level8
from _torch_spawn import World, world_of_one
from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

CUT = 5.0 + SKIN


def _box(reps, seed, temperature=300.0):
    pos, types, cell = make_lattice("fcc", 4.0, reps)
    masses = np.full(len(pos), 58.693)
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(units.KB * temperature / (masses * units.MVV2E))
    vel = rng.normal(size=pos.shape) * sigma[:, None]
    vel -= (vel * masses[:, None]).sum(0) / masses.sum()
    return dict(pos=pos, types=types, masses=masses, cell=cell, vel=vel)


def _same_partition(a, b):
    assert (a.capacity, a.n_shards, a.axis) == (b.capacity, b.n_shards, b.axis)
    for name in ("positions", "velocities", "types", "masses", "real", "original_index"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_partition_slabs_matches_jax(n_shards):
    b = _box((8, 4, 4), 0)
    args = (b["pos"], b["vel"], b["types"], b["masses"], b["cell"], n_shards)
    _same_partition(domain.partition_slabs(*args, cutoff=CUT),
                    jax_domain.partition_slabs(*args, cutoff=CUT))
    part = domain.partition_slabs(*args, cutoff=CUT, capacity=264)
    np.testing.assert_array_equal(part.gather(part.positions, len(b["pos"])), b["pos"])


def test_partition_bricks_matches_jax():
    b = _box((8, 6, 6), 3)
    args = (b["pos"], b["vel"], b["types"], b["masses"], b["cell"], (2, 2))
    _same_partition(domain.partition_bricks(*args, cutoff=CUT),
                    jax_domain.partition_bricks(*args, cutoff=CUT))
    for part in (domain.partition_bricks, jax_domain.partition_bricks):
        with pytest.raises(ValueError, match="overflow"):
            part(*args, cutoff=CUT, capacity=8)
        with pytest.raises(ValueError, match="width"):  # 12 A y-bricks < 2 x 6.5 A
            part(*args, cutoff=6.5)


def test_sheared_cell_takes_the_plane_spacing():
    """A cell whose b vector leans along x by a full period: the x planes
    sit 22/sqrt(2) = 15.6 A apart, not 22 A. Two slabs of 7.8 A are thinner
    than 2 x (cutoff + skin) = 10.6 A, so the port refuses them; the JAX
    guard's row norms see 11 A slabs and accept them (reference fault 5)."""
    cell = np.array([[22.0, 0.0, 0.0], [24.0, 24.0, 0.0], [0.0, 0.0, 24.0]])
    frac = np.random.default_rng(0).uniform(size=(64, 3))
    pos = frac @ cell
    args = (pos, np.zeros_like(pos), np.zeros(64, np.int32), np.ones(64), cell, 2)
    assert perpendicular_widths(cell)[0] == pytest.approx(22.0 / np.sqrt(2.0))
    jax_domain.partition_slabs(*args, cutoff=CUT)  # accepted
    with pytest.raises(ValueError, match="slab width 7.78 A along axis 0"):
        domain.partition_slabs(*args, cutoff=CUT)
    # along y the leaning vector is no narrower: both accept
    domain.partition_slabs(*args, cutoff=CUT, axis=1)


def test_comm_refuses_what_it_cannot_carry(tmp_path):
    with pytest.raises(ValueError, match="initialised process group"):
        Comm()
    with world_of_one(tmp_path):
        with pytest.raises(ValueError, match="'nccl' on a 'gloo'"):
            Comm(transport="nccl")
        with pytest.raises(ValueError, match="does not hold a world of 1"):
            Comm((2, 1))
        one = Comm()
        assert one.transport == "gloo" and one.grid == (1,)
        x = torch.arange(3.0)
        # an axis of one rank sends nothing; the reductions gather one part
        assert one.shift(x, 0, +1) is x
        assert torch.equal(one.sum(x), x) and torch.equal(one.max(x), x)
        with pytest.raises(TypeError, match="gloo-staged"):
            Comm((1, 1)).all_gather(torch.zeros(1, device="meta"))


def test_state_carries_the_partition_axes(tmp_path):
    """The partition records the cell vectors it cut along, the state
    carries them, and ShardedSimulation migrates and selects halos along
    them: a state whose axes do not fit the rank grid is refused at the
    first rebuild, as are halo capacities asked for another grid."""
    from mtp_tpu_torch.parallel.sharded_md import ShardedState
    from mtp_tpu_torch.parallel.sharded_window import ShardedSimulation

    b = _box((8, 4, 4), 0)
    args = (b["pos"], b["vel"], b["types"], b["masses"], b["cell"])
    assert domain.partition_slabs(*args, 3, cutoff=CUT, axis=1).axes == (1,)
    bricks = domain.partition_bricks(*args, (1, 1), cutoff=CUT, axes=(2, 1))
    assert bricks.axes == (2, 1) and bricks.axis == 2
    with pytest.raises(ValueError, match="two different cell vectors"):
        domain.partition_bricks(*args, (2, 1), cutoff=CUT, axes=(0, 0))
    slabs = domain.partition_slabs(*args, 1, cutoff=CUT)
    with pytest.raises(ValueError, match=r"rank grid \(1, 1\) for a partition along"):
        domain.halo_capacities(slabs, b["cell"], (1, 1), CUT)
    model = level8()
    with world_of_one(tmp_path):
        sim = ShardedSimulation(model, Comm((1, 1)), capacity=slabs.capacity, max_neighbors=64,
                                grid=(6, 3, 3), skin=SKIN)
        for part, fits in ((slabs, False), (bricks, True)):
            ss = ShardedState.from_partition(part, b["cell"], 0, dtype=torch.float64,
                                             device="cpu")
            assert ss.axes == part.axes
            if fits:
                _, _, flags = sim.rebuild(ss)
                assert not bool(torch.stack(list(flags)).any())
            else:
                with pytest.raises(ValueError, match=r"cell vectors \(0,\); the rank grid"):
                    sim.rebuild(ss)


@pytest.fixture(scope="module")
def grid_world(mtp_level8, tmp_path_factory):
    """(rank results, JAX reference, box): the four-rank world runs while
    the JAX brick trajectory is computed here."""
    brick = _box((8, 6, 6), 3)
    world = World("_torch_parallel_ranks:grid_cases", 4, tmp_path_factory.mktemp("grid_world"),
                  timeout=120.0, brick=brick)
    try:
        jm = JaxModel.from_data(mtp_level8, dtype=jnp.float64)
        sim = JaxSimulation(jm, max_neighbors=64, skin=SKIN, steps_per_rebuild=10,
                            backend="xla", window=False)
        s0 = init_jax(brick["pos"], brick["types"], brick["masses"], brick["cell"],
                      velocities=brick["vel"], dtype=jnp.float64)
        ref, _ = sim.run(s0, 20, ensemble="nve", dt=0.001)
        ref = {k: np.asarray(getattr(ref, k)) for k in
               ("positions", "forces", "velocities", "potential_energy")}
        ranks = world.results()
    finally:
        world.kill()
    return ranks, ref, brick


def test_grid_shift_sum_max(grid_world):
    """On a 2x2 grid (rank = 2 i0 + i1) a shift along an axis of two ranks
    brings the other rank's tensor in either direction; sum and max are the
    same on every rank, and max ORs bools."""
    ranks = grid_world[0]
    for r in ranks:
        i0, i1 = r["coords"]
        assert r["rank"] == 2 * i0 + i1
        for (axis, _), got in r["grid_shift"].items():
            peer = 2 * (1 - i0) + i1 if axis == 0 else 2 * i0 + (1 - i1)
            assert got == [float(peer), 10.0 * peer + 1.0]
        assert r["grid_sum"] == [6.0, 64.0] and r["grid_max"] == [3.0, 31.0]
        assert r["grid_or"] is True


def test_ring_shift(grid_world):
    """A ring of four: +1 brings the left neighbor's tensor, -1 the right's."""
    for r in grid_world[0]:
        left, right = (r["rank"] - 1) % 4, (r["rank"] + 1) % 4
        assert r["ring_shift"] == [[float(left), 10.0 * left + 1.0],
                                   [float(right), 10.0 * right + 1.0]]


def test_two_rank_group_keeps_the_directions_apart(grid_world):
    """A subgroup of two ranks: left and right are one peer, and one batch
    carries a message each way; each lands on its own side."""
    for r in grid_world[0][:2]:
        p = r["pair"]
        peer = 1 - r["rank"]
        assert p["world"] == 2
        assert p["from_left"] == [float(peer), 10.0 * peer + 1.0]
        assert p["from_right"] == [peer + 100.0, 10.0 * peer + 101.0]
        assert p["sum"] == [1.0, 12.0] and p["max"] == [1.0, 11.0]
    assert "pair" not in grid_world[0][2]


def test_brick_nve_matches_jax(grid_world):
    """20 NVE steps on a 2x2 brick grid (two-stage halo, corner ghosts on
    the second hop, two-hop give-back, per-axis migration) against the JAX
    single-device XLA trajectory."""
    ranks, ref, _ = grid_world
    got = ranks[0]["brick"]
    assert not got["flags"] and got["replicated"]
    assert sum(r["brick"]["arrived"] for r in ranks) > 0
    for k in ("positions", "forces", "velocities"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-10, err_msg=k)
    assert got["energy"] == pytest.approx(float(ref["potential_energy"]), abs=1e-9)


def test_brick_run_repeats_bit_for_bit(grid_world):
    assert grid_world[0][0]["brick_repeats"]


def test_observables_and_writers(grid_world, tmp_path):
    """The summed KE, T and P equal the single-device formulas on the
    gathered state, and the gathered state goes through every single-device
    writer."""
    ranks, _, brick = grid_world
    o = ranks[0]["observables"]
    s = o["state"]
    md = MDState(
        positions=torch.as_tensor(s["positions"]), velocities=torch.as_tensor(s["velocities"]),
        forces=torch.as_tensor(s["forces"]), masses=torch.as_tensor(s["masses"]),
        types=torch.as_tensor(s["types"]), cell=torch.as_tensor(s["cell"]),
        potential_energy=torch.as_tensor(o["energy"]), virial=torch.as_tensor(s["virial"]),
        step=torch.as_tensor(o["step"]),
    )
    n = len(brick["pos"])
    assert md.n_atoms == n and o["step"] == 5
    np.testing.assert_array_equal(s["masses"], brick["masses"])
    assert o["ke"] == pytest.approx(float(kinetic_energy(md)), rel=1e-12)
    assert o["temp"] == pytest.approx(float(temperature_of(md)), rel=1e-12)
    assert o["press"] == pytest.approx(float(pressure_of(md)), rel=1e-10)
    thermo = ThermoLogger(columns=("step", "temp", "pe", "etotal", "press"), stream=io.StringIO())
    thermo(md)
    assert thermo.history[-1]["step"] == 5
    dump = XYZDumpWriter(str(tmp_path / "traj.xyz"), species=("Ni",))
    dump.write(md, forces=True)
    dump.close()
    assert (tmp_path / "traj.xyz").read_text().startswith(f"{n}\n")
    save_checkpoint(str(tmp_path / "ck.npz"), md)
    loaded, _ = load_checkpoint(str(tmp_path / "ck.npz"), device="cpu")
    np.testing.assert_array_equal(loaded.positions.numpy(), s["positions"])
