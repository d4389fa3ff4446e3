"""The benchmark's reference against the program's float64 plain path on
the CPU, at 500 atoms: energies, forces, virials and candidate vectors at
levels 8 and 16 with one and two species, the integrators, the MaxVol
active set and the zero-pressure lattice. The reference itself imports
nothing of the program; these tests do, to hold the two against each
other."""

import numpy as np
import pytest
import torch

from mdbench import inputs, mint
from mdbench.reference import dynamics
from mdbench.reference.maxvol import active_set, grades
from mdbench.reference.model import ReferenceMTP
from mdbench.reference.mtp_file import parse_mtp


def _box(species, seed, sigma=0.1):
    rng = np.random.default_rng(seed)
    pos, cell = inputs.lattice("fcc", 4.0, (5, 5, 5))
    pos = pos + rng.normal(0.0, sigma, pos.shape)
    types = inputs.species(rng, len(pos), [1.0 / species] * species)
    return pos, cell, types


def _program(level, species, seed):
    from mtp_tpu_torch.io.mtp_file import loads_mtp
    from mtp_tpu_torch.models.mtp import MTPModel

    blob = mint.dumps_mtp(mint.make_mtp(level, species_count=species, seed=seed))
    model = MTPModel.from_data(loads_mtp(blob), device="cpu", dtype=torch.float64)
    return blob, model


def _program_eval(model, pos, types, cell):
    from mtp_tpu_torch.al.grades import candidates_and_forces
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape

    p, c = torch.as_tensor(pos), torch.as_tensor(cell)
    nl = build_neighbor_list(p, c, model.cutoff, max_neighbors=96,
                             grid=grid_shape(np.asarray(cell), model.cutoff))
    assert not bool(nl.overflow)
    return candidates_and_forces(model, p, torch.as_tensor(types), nl.idx, c, nl.mirror)


@pytest.mark.parametrize("level,species", [(8, 1), (8, 2), (16, 1), (16, 2)])
def test_model_matches_the_program(level, species):
    blob, model = _program(level, species, seed=3)
    ref = ReferenceMTP(parse_mtp(blob), "cpu")
    pos, cell, types = _box(species, seed=level + species)
    want = _program_eval(model, pos, types, cell)
    got = ref.evaluate(torch.as_tensor(pos), torch.as_tensor(types), torch.as_tensor(cell),
                       virial=True, candidates=True, block=128)
    # float64 on both sides: agreement to rounding (1e-15 as a rule; a
    # pair at the cutoff may enter one sum and not the other, ~1e-10)
    scale = float(want["forces"].abs().max())
    assert float(got["energy"]) == pytest.approx(float(want["energy"]), rel=1e-9)
    assert float((got["forces"] - want["forces"]).abs().max()) < 1e-9 * scale
    assert float((got["virial"] - want["virial"]).abs().max()) < 1e-9 * float(
        want["virial"].abs().max())
    assert float((got["b"] - want["b"]).abs().max()) < 1e-9 * float(want["b"].abs().max())


def test_mtp_reader_reads_the_writer():
    m = mint.make_mtp(8, species_count=2, seed=5)
    pot = parse_mtp(mint.dumps_mtp(m))
    assert np.array_equal(pot["radial_coeffs"], m.radial_coeffs)
    assert np.array_equal(pot["alpha_index_times"], m.alpha_index_times)
    assert np.array_equal(pot["moment_coeffs"], m.moment_coeffs)
    assert pot["max_dist"] == m.max_dist and pot["species_count"] == 2


def _force_fn(model):
    def fn(positions, types, cell):
        out = _program_eval(model, positions.numpy(), types.numpy(), cell.numpy())
        return out["forces"], out["energy"], out["virial"]
    return fn


def test_nve_follows_the_program():
    from mtp_tpu_torch.md import integrators as itg
    from mtp_tpu_torch.md.state import init_state

    blob, model = _program(8, 1, seed=4)
    pos, cell, types = _box(1, seed=9, sigma=0.05)
    masses = np.full(len(pos), 58.693)
    vel = inputs.velocities(np.random.default_rng(1), masses, 300.0)
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=torch.float64, device="cpu")
    st = itg._with_forces(st, _force_fn(model))
    for _ in range(5):
        st = itg.nve_step(st, _force_fn(model), 0.001)
    ref = ReferenceMTP(parse_mtp(blob), "cpu")
    t = torch.as_tensor
    out = dynamics.follow_nve(ref, t(pos), t(vel), t(masses), t(types), t(cell), 5, 0.001)
    assert float((out["positions"] - st.positions).abs().max()) < 1e-11
    assert float((out["velocities"] - st.velocities).abs().max()) < 1e-9


def test_npt_follows_the_program():
    from mtp_tpu_torch.md import integrators as itg
    from mtp_tpu_torch.md.state import init_state

    blob, model = _program(8, 1, seed=4)
    pos, cell, types = _box(1, seed=9, sigma=0.05)
    masses = np.full(len(pos), 58.693)
    vel = inputs.velocities(np.random.default_rng(2), masses, 300.0)
    kw = dict(temperature=300.0, pressure=-2000.0, tdamp=0.1, pdamp=0.5)
    st = init_state(pos, types, masses, cell, velocities=vel, dtype=torch.float64, device="cpu")
    st = itg._with_forces(st, _force_fn(model))
    aux = itg.npt_init(torch.float64, "cpu")
    aux = aux._replace(baro_v=torch.tensor(0.3, dtype=torch.float64))
    start = dict(thermo=((0.01, -0.02), (0.0, 0.0)), baro_thermo=((0.0, 0.0), (0.0, 0.0)),
                 baro_v=0.3)
    aux = aux._replace(thermo=aux.thermo._replace(xi=torch.tensor([0.01, -0.02],
                                                                  dtype=torch.float64)))
    for _ in range(4):
        st, aux = itg.npt_step(st, aux, _force_fn(model), 0.001, **kw)
    ref = ReferenceMTP(parse_mtp(blob), "cpu")
    t = torch.as_tensor
    out = dynamics.follow_npt_iso(ref, t(pos), t(vel), t(masses), t(types), t(cell), 4, 0.001,
                                  **kw, **start)
    assert float((out["cell"] - st.cell).abs().max()) < 1e-11
    assert float((out["positions"] - st.positions).abs().max()) < 1e-10
    assert float((out["velocities"] - st.velocities).abs().max()) < 1e-8
    assert out["baro_v"] == pytest.approx(float(aux.baro_v), rel=1e-9)


def test_active_set_and_grades_match_the_program():
    from mtp_tpu_torch.al.grades import nbh_grades
    from mtp_tpu_torch.al.maxvol import build_mvs

    rng = np.random.default_rng(0)
    pool = rng.normal(size=(400, 30))
    pool[:, 7] = 3.0 * pool[:, 2]  # a structural null direction
    mvs = build_mvs(pool)
    a = active_set(pool)
    assert np.array_equal(a, mvs.active_set)
    b = rng.normal(size=(50, 30))
    want = nbh_grades(torch.as_tensor(b), torch.as_tensor(mvs.inverse_active_set)).numpy()
    assert np.allclose(grades(b, a), want, rtol=1e-9)


def test_zero_pressure_lattice_has_no_pressure():
    blob = mint.dumps_mtp(mint.make_mtp(8, seed=2))
    a0 = inputs.zero_pressure_a(blob, "fcc", 4.0, "cpu")
    ref = ReferenceMTP(parse_mtp(blob), "cpu")
    pos, cell = inputs.lattice("fcc", a0, (5, 5, 5))
    t = torch.as_tensor
    w = ref.evaluate(t(pos), t(np.zeros(len(pos), dtype=np.int64)), t(cell), virial=True)["virial"]
    w0 = ref.evaluate(t(pos * 4.0 / a0), t(np.zeros(len(pos), dtype=np.int64)),
                      t(cell * 4.0 / a0), virial=True)["virial"]
    assert abs(float(w[:3].sum())) < 1e-8 * abs(float(w0[:3].sum()))
