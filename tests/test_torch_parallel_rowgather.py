"""The JAX package's XLA row-gather API of multi-device MD
(``make_sharded_md_block``, ``compute_sharded_forces``,
``make_sharded_grades``) and the sharded monitor's standalone engine, in the
port (``mtp_tpu_torch.parallel.sharded_md``, ``al.driver``), on the port's
one sharded engine, in float64 on the CPU.

The box is the JAX tests' ``wide_system`` (``tests/test_parallel.py``): fcc
(16, 3, 3) at a = 4 A jittered by 0.08 A, level 8, a grid of (12, 2, 2)
bins at the cutoff: fewer than 3 bins across y and z, which the JAX
package's window engine refuses. One spawned world of four gloo ranks
(``_torch_parallel_ranks.rowgather_cases``) runs the port while this
process computes the JAX package's row-gather path on the conftest's
virtual devices; every case starts from the JAX ShardedState, carried
across by ``utils.convert.sharded_state_from_jax``, so both packages start
from the same slots and the same NumPy velocities.

Tolerances, absolute: forces, energy and virial 1e-10 (eV/A, eV); positions
and velocities after 10 steps 1e-10; grades 1e-10 relative to the largest.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.md.simulation import make_lattice
from mtp_tpu.models.mtp import MTPModel as JaxModel
from mtp_tpu.ops.neighbors import grid_shape as grid_jax
from mtp_tpu.parallel.domain import partition_slabs as partition_jax
from mtp_tpu.parallel.sharded_md import ShardedState as JaxShardedState
from mtp_tpu.parallel.sharded_md import compute_sharded_forces as forces_jax
from mtp_tpu.parallel.sharded_md import make_mesh
from mtp_tpu.parallel.sharded_md import make_sharded_grades as grades_jax
from mtp_tpu.parallel.sharded_md import make_sharded_md_block as block_jax
from mtp_tpu_torch.al.grades import candidate_vectors
from mtp_tpu_torch.al.maxvol import build_mvs
from mtp_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce
from mtp_tpu_torch.parallel.comm import Comm
from mtp_tpu_torch.utils import units

from _torch_parallel_ranks import level8
from _torch_spawn import World, world_of_one
from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-10
NVT = dict(temperature=300.0, tdamp=0.05)


def _wide_box():
    pos, types, cell = make_lattice("fcc", 4.0, (16, 3, 3))
    pos = pos + np.random.default_rng(0).normal(scale=0.08, size=pos.shape)
    masses = np.full(len(pos), 58.693)
    rng = np.random.default_rng(5)
    sigma = np.sqrt(units.KB * 300.0 / (masses * units.MVV2E))
    vel = rng.normal(size=pos.shape) * sigma[:, None]
    vel -= (vel * masses[:, None]).sum(0) / masses.sum()
    return dict(pos=pos, types=types, masses=masses, cell=cell, vel=vel)


def _inverse_active_set(box):
    """An MVS from float64 candidate vectors of two perturbed copies, as
    the JAX tests build theirs."""
    model = level8()
    rng = np.random.default_rng(3)
    cell = torch.as_tensor(box["cell"])
    rows = []
    for s in (0.02, 0.08):
        p = torch.as_tensor(box["pos"] + rng.normal(scale=s, size=box["pos"].shape))
        nl = build_neighbor_list_bruteforce(p, cell, model.cutoff, max_neighbors=64)
        b, _ = candidate_vectors(model, p, torch.as_tensor(box["types"]), nl.idx, cell)
        rows.append(b.numpy())
    return build_mvs(np.concatenate(rows), mode="neighborhood").inverse_active_set


def _jax_state(box, nd, cut, axis=0, vel=False):
    part = partition_jax(box["pos"], box["vel"] if vel else np.zeros_like(box["pos"]),
                         box["types"], box["masses"], box["cell"], nd, cutoff=cut, axis=axis)
    return make_mesh(nd), part, JaxShardedState.from_partition(part, box["cell"], make_mesh(nd),
                                                               dtype=jnp.float64)


def _arrays(s):
    return {k: np.asarray(getattr(s, k)) for k in (
        "positions", "velocities", "forces", "types", "masses", "real", "ids", "cell",
        "potential_energy", "virial", "thermo")}


def _jax_inputs(box, boxy):
    """The JAX ShardedStates of every case (mesh, partition, state), and
    their arrays for the ranks."""
    cut = 5.0  # the level-8 potential's cutoff
    inputs = {f"forces{nd}": _jax_state(box, nd, cut) for nd in (2, 4)}
    inputs["md"] = _jax_state(box, 4, cut + 0.6, vel=True)
    inputs["grades_x"] = _jax_state(box, 4, cut)
    inputs["grades_y"] = _jax_state(boxy, 4, cut, axis=1)
    return inputs, {k: _arrays(s) for k, (_, _, s) in inputs.items()}


def _jax_references(mtp_data, box, boxy, inv, inputs):
    """The JAX row-gather path's results on `inputs`."""
    jm = JaxModel.from_data(mtp_data, dtype=jnp.float64)
    assert jm.cutoff == 5.0
    n = len(box["pos"])
    ref = {}
    for nd in (2, 4):
        mesh, part, s = inputs[f"forces{nd}"]
        out, flags = forces_jax(jm, mesh, capacity=part.capacity, max_neighbors=48,
                                grid=grid_jax(box["cell"], jm.cutoff))(s)
        assert not bool(flags.any())
        ref[f"forces{nd}"] = dict(forces=out.gather(out.forces, n),
                                  energy=float(out.potential_energy),
                                  virial=np.asarray(out.virial))
    mesh, part, s = inputs["md"]
    for ens, kw in (("nve", {}), ("nvt", NVT)):
        out, flags = block_jax(jm, mesh, capacity=part.capacity, max_neighbors=64,
                               grid=grid_jax(box["cell"], jm.cutoff + 0.6), skin=0.6,
                               n_steps=10, dt=0.001, ensemble=ens, **kw)(s)
        assert not bool(flags.any())
        ref[ens] = dict(positions=out.gather(out.positions, n),
                        velocities=out.gather(out.velocities, n),
                        energy=float(out.potential_energy), thermo=np.asarray(out.thermo))
    jal = dataclasses.replace(jm, inverse_active_set=jnp.asarray(inv, jnp.float64),
                              configuration_mode=False)
    for name, axis, b in (("grades_x", 0, box), ("grades_y", 1, boxy)):
        mesh, part, s = inputs[name]
        g, grades, flags = grades_jax(jal, mesh, capacity=part.capacity, max_neighbors=48,
                                      grid=grid_jax(b["cell"], jm.cutoff), slab_axis=axis)(s)
        assert not bool(flags)
        ref[name] = dict(max_grade=float(g), grades=part.gather(np.asarray(grades), n))
    return ref


@pytest.fixture(scope="module")
def cases(mtp_level8, tmp_path_factory):
    """(rank results, JAX references): the four-rank world runs while the
    references are computed here."""
    box = _wide_box()
    boxy = dict(box, pos=box["pos"][:, [1, 0, 2]], vel=box["vel"][:, [1, 0, 2]],
                cell=np.diag(np.diag(box["cell"])[[1, 0, 2]]))
    inv = _inverse_active_set(box)
    inputs, states = _jax_inputs(box, boxy)
    d = tmp_path_factory.mktemp("rowgather_world")
    world = World("_torch_parallel_ranks:rowgather_cases", 4, d, timeout=120.0, box=box,
                  boxy=boxy, states=states, inverse_active_set=inv)
    try:
        ref = _jax_references(mtp_level8, box, boxy, inv, inputs)
        ranks = world.results()
    finally:
        world.kill()
    return ranks, ref


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("nd", [2, 4])
def test_forces_on_narrow_box_match_jax(cases, nd):
    """compute_sharded_forces on 2 and 4 slabs of a box 2 bins across:
    forces, energy and virial of the JAX row-gather path."""
    ranks, ref = cases
    got, want = ranks[0][f"forces{nd}"], ref[f"forces{nd}"]
    assert got["grid"] == (12, 2, 2) and not got["flags"]
    _close(got["forces"], want["forces"])
    assert got["energy"] == pytest.approx(want["energy"], abs=TOL)
    _close(got["virial"], want["virial"])
    for r in ranks[:nd]:  # replicated: one value on every rank of the group
        assert r[f"forces{nd}"]["energy"] == got["energy"]


@pytest.mark.parametrize("ensemble", ["nve", "nvt"])
def test_md_block_matches_jax(cases, ensemble):
    """make_sharded_md_block, 10 steps on 4 slabs from the same NumPy
    velocities: positions, velocities, the energy and the chain."""
    ranks, ref = cases
    got, want = ranks[0][ensemble], ref[ensemble]
    assert not got["flags"]
    _close(got["positions"], want["positions"])
    _close(got["velocities"], want["velocities"])
    assert got["energy"] == pytest.approx(want["energy"], abs=1e-9)
    _close(got["thermo"][:4], want["thermo"][:4], 1e-12)
    if ensemble == "nvt":
        assert np.abs(got["thermo"][:2]).max() > 0  # the chain moved


@pytest.mark.parametrize("name", ["grades_x", "grades_y"])
def test_grades_match_jax(cases, name):
    """make_sharded_grades on 4 slabs along x, and along y
    (``slab_axis=1``) on the same box with x and y swapped."""
    ranks, ref = cases
    got, want = ranks[0][name], ref[name]
    assert not got["flags"]
    top = want["grades"].max()
    assert top > 0 and got["max_grade"] == pytest.approx(want["max_grade"], rel=TOL)
    _close(got["grades"] / top, want["grades"] / top)
    assert all(r[name]["max_grade"] == got["max_grade"] for r in ranks)


def test_standalone_monitor_regrows_to_the_window_grade(cases):
    """The standalone engine from J = 16 and a finite shell: it grows J
    until the list fits (16 -> 32 -> 56), sets the shell to its maximum,
    and grades as the window engine's grade pass does at those positions,
    and as the JAX package's grades."""
    ranks, ref = cases
    got = ranks[0]["standalone"]
    assert got["max_neighbors"] == 56 and got["halo_capacity"] is None
    assert not got["window_flags"]
    top = got["window_grades"].max()
    assert got["max_grade"] == pytest.approx(got["window_max_grade"], rel=TOL)
    _close(got["grades"] / top, got["window_grades"] / top)
    assert got["max_grade"] == pytest.approx(ref["grades_x"]["max_grade"], rel=TOL)


def test_narrow_grid_is_taken_and_recovered(tmp_path):
    """ShardedSimulation takes a grid of 2 bins across, and its recovery
    re-grids to one (the refusals of 3 bins are gone); a cell narrower than
    2 x (cutoff + skin) still raises."""
    from mtp_tpu_torch.parallel.sharded_window import ShardedSimulation

    with world_of_one(tmp_path):
        sim = ShardedSimulation(level8(), Comm(), capacity=600, max_neighbors=64,
                                grid=(11, 3, 3), skin=0.6)
        wide = np.diag([64.0, 12.0, 12.0])
        assert sim._recover((True, False, False, False, False), cell=wide) == \
            "grid -> (11, 2, 2) (cell changed)"
        assert sim.grid == (11, 2, 2)
        with pytest.raises(RuntimeError, match="minimum image"):
            sim._recover((True, False, False, False, False), cell=np.diag([64.0, 11.0, 12.0]))
