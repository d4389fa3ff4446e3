"""The port's model evaluators against mtp_tpu's XLA path and the f64 golden
engine (utils/golden.py), in float64 on the CPU.

Tolerance: 1e-10 absolute (eV, eV/A, eV for the virial): the same float64
function computed in another order of operations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.models.mtp import MTPModel as JaxModel
from mtp_tpu.models.mtp import mtp_energy as energy_jax
from mtp_tpu.models.mtp import mtp_energy_forces as ef_jax
from mtp_tpu.utils import golden
from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.io.mtp_file import save_mtp
from mtp_tpu_torch.md.simulation import make_lattice
from mtp_tpu_torch.models.mtp import (
    MTPModel,
    mtp_energy,
    mtp_energy_forces,
    mtp_energy_forces_window,
    mtp_energy_window,
    window_constants,
)
from mtp_tpu_torch.ops.neighbors import (
    build_neighbor_list,
    build_sorted_neighbor_list,
    grid_shape,
)
from mtp_tpu_torch.utils.convert import model_from_jax

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-10


@pytest.fixture(scope="module", params=[(8, 2, 3), (16, 1, 0), (16, 2, 5)],
                ids=["level8-2spec", "level16", "level16-2spec"])
def case(request):
    level, species, seed = request.param
    m = make_mtp(level, species_count=species, seed=seed)
    # 108-atom fcc box (12 A > 2 x cutoff), jittered: the geometry the minted
    # potentials are made for (nearest neighbors near r0 = 2.85 A)
    pos, _, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    rng = np.random.default_rng(seed)
    pos = pos + rng.normal(0, 0.1, pos.shape)
    types = rng.integers(0, species, len(pos)).astype(np.int32)
    g = golden.compute(m, pos, types, cell=cell)
    return m, pos, types, cell, g


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _lists(m, pos, cell, j=64):
    cut = m.max_dist + 0.5
    grid = grid_shape(cell, cut)
    nl = build_neighbor_list(_t(pos), _t(cell), cut, max_neighbors=j, grid=grid)
    swl = build_sorted_neighbor_list(_t(pos), _t(cell), cut, max_neighbors=j, grid=grid)
    assert not bool(nl.overflow) and not bool(swl.overflow)
    return nl, swl


def _assert_close(out, ref):
    assert abs(float(out["energy"]) - float(ref["energy"])) < TOL
    np.testing.assert_allclose(np.asarray(out["site_energies"]), ref["site_energies"], atol=TOL)
    np.testing.assert_allclose(np.asarray(out["forces"]), ref["forces"], atol=TOL)
    np.testing.assert_allclose(np.asarray(out["virial"]), ref["virial"], atol=TOL)


def test_plain_path_matches_golden_and_jax_xla(case):
    m, pos, types, cell, g = case
    model = MTPModel.from_data(m, device="cpu", dtype=torch.float64)
    nl, _ = _lists(m, pos, cell)
    out = mtp_energy_forces(model, _t(pos), _t(types, torch.int32), nl.idx, _t(cell), nl.mirror)
    out = {k: v.numpy() for k, v in out.items()}
    _assert_close(out, g)

    jm = JaxModel.from_data(m, dtype=jnp.float64)
    oj = ef_jax(
        jm.schedule, jm.coeffs, jnp.asarray(pos), jnp.asarray(types),
        jnp.asarray(nl.idx.numpy()), jnp.asarray(cell), jnp.asarray(nl.mirror.numpy()),
        backend="xla",
    )
    _assert_close(out, {k: np.asarray(v) for k, v in oj.items()})


def test_energy_only_matches_jax_and_the_force_path(case):
    """`mtp_energy` (no forces) against the JAX `mtp_energy` on the same
    list, and against the energy of the port's own force path."""
    m, pos, types, cell, g = case
    model = MTPModel.from_data(m, device="cpu", dtype=torch.float64)
    nl, _ = _lists(m, pos, cell)
    ty = _t(types, torch.int32)
    e = float(mtp_energy(model, _t(pos), ty, nl.idx, _t(cell)))
    jm = JaxModel.from_data(m, dtype=jnp.float64)
    ej = energy_jax(jm.schedule, jm.coeffs, jnp.asarray(pos), jnp.asarray(types),
                    jnp.asarray(nl.idx.numpy()), jnp.asarray(cell))
    assert np.asarray(ej).dtype == np.float64
    assert abs(e - float(ej)) < TOL
    ef = mtp_energy_forces(model, _t(pos), ty, nl.idx, _t(cell), nl.mirror)
    assert abs(e - float(ef["energy"])) < TOL
    assert abs(e - g["energy"]) < TOL


def test_window_path_matches_golden(case):
    """The main-path evaluator (CPU: the kernels' plain twins), in user
    order and in sorted space, with and without the energy kernel."""
    m, pos, types, cell, g = case
    jm = JaxModel.from_data(m, dtype=jnp.float64)
    model = model_from_jax(jm, device="cpu", dtype=torch.float64)
    _, swl = _lists(m, pos, cell)
    ty = _t(types, torch.int32)
    consts = window_constants(model, ty, swl)
    out = mtp_energy_forces_window(model, _t(pos), _t(cell), swl, **consts)
    _assert_close({k: v.numpy() for k, v in out.items()}, g)

    pos_s = _t(pos)[swl.order]
    out_s = mtp_energy_forces_window(
        model, pos_s, _t(cell), swl, sorted_io=True, compute_energy=False,
        compute_virial=False, **consts,
    )
    order = swl.order.numpy()
    np.testing.assert_allclose(out_s["forces"].numpy(), g["forces"][order], atol=TOL)
    assert float(out_s["energy"]) == 0.0
    assert not out_s["virial"].any()
    e = mtp_energy_window(model, pos_s, _t(cell), swl, sorted_io=True, **consts)
    assert abs(float(e) - g["energy"]) < TOL


def test_model_load_and_fp32(tmp_path):
    """MTPModel.load reads a saved potential; dtype and device are explicit."""
    m = make_mtp(8, species_count=2, seed=3)
    path = str(tmp_path / "p.mtp")
    save_mtp(path, m)
    a = MTPModel.load(path, device="cpu", dtype=torch.float32)
    b = MTPModel.from_data(m, device="cpu", dtype=torch.float32)
    assert a.dtype == torch.float32 and a.device == torch.device("cpu")
    for name in ("radial_coeffs", "species_coeffs", "moment_coeffs"):
        ta, tb = getattr(a.coeffs, name), getattr(b.coeffs, name)
        assert ta.dtype == torch.float32
        assert torch.equal(ta, tb)
    assert a.schedule == b.schedule
    assert a.cutoff == m.max_dist


@pytest.mark.parametrize("energy_weight", [0.0, 1.0], ids=["neighborhood", "configuration"])
def test_mvs_state_survives_loading(tmp_path, energy_weight):
    """A .mtp with an MVS trailer keeps its selection state in the port, as
    in mtp_tpu: the inverse active set on the model's device in its dtype,
    the active set as numpy, and the mode; model_from_jax carries all three."""
    from mtp_tpu_torch.io.mtp_file import MVSData

    m = make_mtp(8, species_count=2, seed=3)
    p = m.coeff_count
    a = np.random.default_rng(7).normal(size=(p, p)) + 3.0 * np.eye(p)
    m.mvs = MVSData(energy_weight, 0.0, 0.0, 1.0 - energy_weight, 2.0, a, np.linalg.inv(a).T)
    path = str(tmp_path / "al.mtp")
    save_mtp(path, m)
    jm = JaxModel.load(path, dtype=jnp.float64)
    cpu = dict(device="cpu")
    for tm in (MTPModel.load(path, **cpu, dtype=torch.float64), model_from_jax(jm, **cpu)):
        assert tm.configuration_mode is jm.configuration_mode is bool(energy_weight)
        assert isinstance(tm.active_set, np.ndarray)
        np.testing.assert_array_equal(tm.active_set, jm.active_set)
        inv = tm.inverse_active_set
        assert inv.dtype == torch.float64 and inv.device == tm.device
        np.testing.assert_allclose(inv.numpy(), np.asarray(jm.inverse_active_set), rtol=0, atol=1e-15)
    plain = MTPModel.from_data(make_mtp(8, seed=0), device="cpu")
    assert plain.inverse_active_set is None and plain.active_set is None
    assert not plain.configuration_mode


@pytest.mark.parametrize("entry", ["from_data", "load", "init_state", "model_from_jax"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """The port's entry points take device="cuda" by default; with no CUDA
    device a default call raises instead of falling back to the CPU."""
    import inspect

    from mtp_tpu_torch.md.state import init_state

    m = make_mtp(8, seed=0)
    path = str(tmp_path / "p.mtp")
    save_mtp(path, m)
    pos, types, cell = make_lattice("fcc", 4.0, (2, 2, 2))
    fn, call = {
        "from_data": (MTPModel.from_data, lambda: MTPModel.from_data(m)),
        "load": (MTPModel.load, lambda: MTPModel.load(path)),
        "init_state": (init_state, lambda: init_state(pos, types, np.ones(len(pos)), cell)),
        "model_from_jax": (
            model_from_jax, lambda: model_from_jax(JaxModel.from_data(m, dtype=jnp.float64))
        ),
    }[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_model_from_jax_refuses_narrower_coefficients():
    """A float32 JAX model cannot become a float64 port model: its
    coefficients would be widened float32 values. In its own precision it
    converts."""
    jm32 = JaxModel.from_data(make_mtp(8, seed=0), dtype=jnp.float32)
    assert np.asarray(jm32.coeffs.radial_coeffs).dtype == np.float32
    with pytest.raises(ValueError, match="narrower than the torch.float64"):
        model_from_jax(jm32, device="cpu", dtype=torch.float64)
    tm = model_from_jax(jm32, device="cpu", dtype=torch.float32)
    assert tm.coeffs.radial_coeffs.dtype == torch.float32
