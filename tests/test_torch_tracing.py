"""The port's profiler spans and retry counters on the CPU (float64).

Under a ``torch.profiler`` session the drivers open spans at their layer
boundaries (``mtp_tpu_torch/utils/tracing.py``): counted and nested here
per block, step and grade step. With no session they enter no
``record_function`` at all. ``Simulation.retries`` counts the block attempts
that ``Simulation.run`` and ``run_with_extrapolation`` discard, by cause.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from mtp_tpu_torch.al.driver import ExtrapolationMonitor, run_with_extrapolation
from mtp_tpu_torch.al.grades import candidate_vectors
from mtp_tpu_torch.al.maxvol import build_mvs
from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.md.simulation import Simulation, make_lattice
from mtp_tpu_torch.md.state import init_state
from mtp_tpu_torch.models.mtp import MTPModel
from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape, grown_width
from mtp_tpu_torch.utils import tracing, units

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

F64 = torch.float64
PREFIXES = ("md.", "nl.", "mtp.", "al.")


def _velocities(masses, seed=42):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(units.KB * 300.0 / (masses * units.MVV2E))
    vel = rng.normal(size=(len(masses), 3)) * sigma[:, None]
    return vel - (vel * masses[:, None]).sum(0) / masses.sum()


@pytest.fixture(scope="module")
def alloy():
    """864-atom two-species fcc box, level 8, numpy Maxwell-Boltzmann
    velocities at 300 K (``tests/test_torch_md.py``'s box)."""
    model = MTPModel.from_data(make_mtp(8, species_count=2, seed=3), device="cpu", dtype=F64)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6), type_pattern=(0, 1))
    masses = np.where(types == 0, 58.693, 26.98)
    return model, pos, types, masses, cell, _velocities(masses)


@pytest.fixture(scope="module")
def al_model():
    """Level 8, one species, with an MVS from two perturbed 108-atom boxes
    (grades near the lattice are ~1)."""
    m = make_mtp(8, species_count=1, seed=0)
    model = MTPModel.from_data(m, device="cpu", dtype=F64)
    rows = []
    for k, sigma in enumerate((0.05, 0.1)):
        pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
        pos = pos + np.random.default_rng(100 + k).normal(0, sigma, pos.shape)
        p, c = torch.as_tensor(pos), torch.as_tensor(cell)
        nl = build_neighbor_list(p, c, model.cutoff, max_neighbors=64,
                                 grid=grid_shape(cell, model.cutoff))
        rows.append(candidate_vectors(model, p, torch.as_tensor(types), nl.idx, c)[0].numpy())
    m = dataclasses.replace(m, mvs=build_mvs(np.concatenate(rows), mode="neighborhood"))
    return MTPModel.from_data(m, device="cpu", dtype=F64)


def _state(model_box):
    _, pos, types, masses, cell, vel = model_box
    return init_state(pos, types, masses, cell, velocities=vel, dtype=F64, device="cpu")


def _al_start():
    pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    masses = np.full(len(pos), 58.693)
    return init_state(pos, types, masses, cell, velocities=_velocities(masses), dtype=F64,
                      device="cpu")


def _spans(prof):
    """[(name, innermost enclosing program span or None)] in start order."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith(PREFIXES):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIXES):
            p = p.cpu_parent
        out.append((e.name, p.name if p is not None else None))
    return out


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def test_run_spans_blocks_rebuilds_and_steps(alloy):
    """2 blocks of 3 steps: each block one rebuild, 3 integrator steps each
    holding one force call, 3 staleness checks, a refresh of the incoming
    forces and the energy, then one flag read."""
    sim = Simulation(alloy[0], max_neighbors=64, skin=0.6, steps_per_rebuild=3,
                     compute_virial=False)
    st = _state(alloy)
    spans = _profiled(lambda: sim.run(st, 6, dt=0.001))
    count = collections.Counter(spans)
    assert count == {
        ("md.read_cell", None): 3,  # check_cell, then the grid of each block
        ("md.block", None): 2,
        ("md.read_flags", None): 2,
        ("nl.build", "md.block"): 2,
        ("nl.sort", "nl.build"): 2,  # the bin sort and cell table, once a build
        ("nl.rows", "nl.build"): 2,
        ("nl.mirror", "nl.build"): 2,
        ("md.steps", "md.block"): 2,
        ("mtp.forces", "md.steps"): 2,  # the refresh
        ("md.integrate", "md.steps"): 6,
        ("mtp.forces", "md.integrate"): 6,
        ("md.verlet_check", "md.steps"): 6,
        ("mtp.energy", "md.steps"): 2,
    }
    top = [name for name, parent in spans if parent is None]
    assert top == ["md.read_cell"] + ["md.read_cell", "md.block", "md.read_flags"] * 2
    assert sim.retries == {"overflow": 0, "stale": 0}


def test_extrapolation_spans_grade_steps(al_model, tmp_path):
    """One ``al.grade`` per segment attempt and one ``al.commit`` per
    accepted segment (and one of each for the starting state), with the
    grade's host read and the ``.cfg`` write inside the commit. The skin of
    0.05 A makes the first 5-step block stale, so one attempt is discarded."""
    sim = Simulation(al_model, max_neighbors=64, skin=0.05, steps_per_rebuild=5,
                     compute_virial=False)
    mon = ExtrapolationMonitor(al_model, select_threshold=0.0,
                               output_path=str(tmp_path / "sel.cfg"))
    st = _al_start()
    spans = _profiled(lambda: run_with_extrapolation(sim, mon, st, 10, al_every=5, dt=0.001))
    mon.close()
    retried = sum(sim.retries.values())
    assert sim.retries["stale"] >= 1 and sim.retries["overflow"] == 0
    count = collections.Counter(spans)
    attempts = 2 + retried
    assert count[("al.grade", None)] == 1 + attempts
    assert count[("al.commit", None)] == 3
    assert count[("al.read_grade", "al.commit")] == 3
    assert count[("al.write_cfg", "al.commit")] == 3
    assert count[("md.read_flags", None)] == 1 + attempts  # the first list, then each segment
    assert count[("nl.build", "md.block")] == count[("md.block", None)] >= attempts
    assert count[("nl.build", None)] == 1  # the first list
    assert (tmp_path / "sel.cfg").read_text().count("BEGIN_CFG") == 3


def test_no_session_enters_no_span(alloy, al_model, monkeypatch):
    """With no profiler session the port never enters ``record_function``;
    inside one, ``tracing.enabled = False`` keeps the spans out too."""

    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    sim = Simulation(alloy[0], max_neighbors=64, skin=0.6, steps_per_rebuild=2,
                     compute_virial=False)
    st, _ = sim.run(_state(alloy), 2, dt=0.001)
    assert int(st.step) == 2
    al_sim = Simulation(al_model, max_neighbors=64, skin=0.6, steps_per_rebuild=5,
                        compute_virial=False)
    mon = ExtrapolationMonitor(al_model, select_threshold=1e9)
    st = run_with_extrapolation(al_sim, mon, _al_start(), 5, al_every=5, dt=0.001)
    assert int(st.step) == 5
    monkeypatch.undo()
    monkeypatch.setattr(tracing, "enabled", False)
    assert _profiled(lambda: sim.run(st, 2, dt=0.001)) == []


def _grown(j0, j1):
    """Growth steps of ``grown_width`` from J = j0 to j1."""
    n = 0
    while j0 < j1:
        j0 = grown_width(j0)
        n += 1
    assert j0 == j1
    return n


def test_retries_count_discarded_blocks(alloy, al_model):
    """Every grown list and every halved block is one discarded attempt, in
    ``Simulation.run`` and in ``run_with_extrapolation``."""
    sim = Simulation(alloy[0], max_neighbors=8, skin=0.6, steps_per_rebuild=2,
                     compute_virial=False)
    sim.run(_state(alloy), 2, dt=0.001)
    assert sim.max_neighbors > 8
    assert sim.retries == {"overflow": _grown(8, sim.max_neighbors), "stale": 0}

    sim = Simulation(alloy[0], max_neighbors=64, skin=0.05, steps_per_rebuild=8,
                     compute_virial=False)
    sim.run(_state(alloy), 8, dt=0.001)
    assert sim.steps_per_rebuild < 8
    assert sim.retries == {"overflow": 0, "stale": int(np.log2(8 // sim.steps_per_rebuild))}

    sim = Simulation(al_model, max_neighbors=64, skin=0.05, steps_per_rebuild=8,
                     compute_virial=False)
    run_with_extrapolation(sim, ExtrapolationMonitor(al_model), _al_start(), 8, al_every=8,
                           dt=0.001)
    assert sim.steps_per_rebuild < 8
    assert sim.retries == {"overflow": 0, "stale": int(np.log2(8 // sim.steps_per_rebuild))}
