"""The port's training (``mtp_tpu_torch.train.fit``) against ``mtp_tpu``'s,
in float64 on the CPU, on the fixture of ``tests/test_train.py`` (level 8,
108 atoms, 12 configurations labeled by golden).

Tolerances: the datasets' arrays equal; the loss 1e-10 relative (the two
sum in other orders); the overdetermined warm start 1e-10 relative to the
largest coefficient, the underdetermined one (4 configurations at level 16,
minimum norm) 1e-8; 10 Adam steps (``torch.optim.Adam`` against
``optax.adam``) 1e-8 relative in losses and coefficients.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import _one_intra_op_thread  # noqa: F401
from _torch_train_data import teacher_configs

from mtp_tpu.io.basis_gen import make_mtp as make_mtp_jax
from mtp_tpu.io.cfg_file import Config as JaxConfig
from mtp_tpu.md.simulation import make_lattice
from mtp_tpu.models.mtp import MTPCoeffs as JaxCoeffs
from mtp_tpu.models.mtp import MTPModel as JaxModel
from mtp_tpu.train import fit as jfit
from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.io.cfg_file import Config
from mtp_tpu_torch.models.mtp import MTPCoeffs, MTPModel
from mtp_tpu_torch.train import fit as tfit
from mtp_tpu_torch.utils.convert import coeffs_from_jax, model_from_jax

COEFFS = ("radial_coeffs", "species_coeffs", "moment_coeffs")


def _port_configs(configs):
    return [Config(**{f.name: getattr(c, f.name) for f in dataclasses.fields(JaxConfig)})
            for c in configs]


@pytest.fixture(scope="module")
def case():
    """The teacher, both packages' datasets and models, and a start with the
    radial coefficients perturbed by 30% (numpy, seed 1)."""
    m, configs = teacher_configs()
    jm = JaxModel.from_data(m, dtype=jnp.float64)
    tm = model_from_jax(jm, device="cpu")
    jd = jfit.make_dataset(configs, m.max_dist, max_neighbors=48)
    td = tfit.make_dataset(_port_configs(configs), m.max_dist, max_neighbors=48, device="cpu")
    rng = np.random.default_rng(1)
    rc = jm.coeffs.radial_coeffs
    start = JaxCoeffs(
        radial_coeffs=rc * (1 + 0.3 * jnp.asarray(rng.normal(size=rc.shape))),
        species_coeffs=jm.coeffs.species_coeffs,
        moment_coeffs=jm.coeffs.moment_coeffs,
    )
    return dict(m=m, configs=configs, jm=jm, tm=tm, jd=jd, td=td, start=start,
                tstart=coeffs_from_jax(start, device="cpu"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _solution(c):
    """The warm start's unknowns, (species, moment) coefficients, as numpy."""
    return np.concatenate([np.asarray(c.species_coeffs), np.asarray(c.moment_coeffs)])


def test_make_dataset_matches_jax(case):
    jd, td = case["jd"], case["td"]
    assert td.n_configs == jd.n_configs == 12
    for f in ("positions", "types", "real", "nbr_idx", "cells", "energies", "forces",
              "has_forces"):
        a, b = np.asarray(getattr(jd, f)), getattr(td, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert td.positions.device.type == "cpu"


def test_make_dataset_refuses_small_cells():
    """A 2x2x2 fcc box (8 A) is narrower than 2 * cutoff (10 A): the JAX
    dataset takes one image per pair without a word; the port refuses."""
    m = make_mtp_jax(8, species_count=1, seed=11)
    pos, types, cell = make_lattice("fcc", 4.0, (2, 2, 2))
    cfg = JaxConfig(cell=cell, positions=pos, types=types, energy=0.0)
    data = jfit.make_dataset([cfg], m.max_dist, max_neighbors=48)
    assert data.n_configs == 1
    with pytest.raises(ValueError, match="2\\*cutoff"):
        tfit.make_dataset(_port_configs([cfg]), m.max_dist, max_neighbors=48, device="cpu")


@pytest.mark.parametrize("forces", [True, False], ids=["forces", "energies_only"])
@pytest.mark.parametrize("which", ["teacher", "perturbed"])
def test_loss_matches_jax(case, which, forces):
    m, configs = case["m"], case["configs"]
    if forces:
        jd, td = case["jd"], case["td"]
    else:
        bare = [dataclasses.replace(c, forces=None) for c in configs]
        jd = jfit.make_dataset(bare, m.max_dist, max_neighbors=48)
        td = tfit.make_dataset(_port_configs(bare), m.max_dist, max_neighbors=48,
                               device="cpu")
        assert not bool(td.has_forces.any())
    jc = case["jm"].coeffs if which == "teacher" else case["start"]
    tc = case["tm"].coeffs if which == "teacher" else case["tstart"]
    for fw in (0.01, 1.0):
        lj = float(jfit.loss_fn(case["jm"].schedule, jc, jd, force_weight=fw))
        lt = float(tfit.loss_fn(case["tm"].schedule, tc, td, force_weight=fw))
        if which == "teacher":  # ~1e-30: both at the rounding floor
            assert lj < 1e-16 and lt < 1e-16, (lj, lt)
        else:
            assert abs(lt - lj) <= 1e-10 * lj, (lt, lj)


def test_self_consistency_zero_loss(case):
    """The teacher's own coefficients give ~zero loss on its own labels (the
    twin of ``test_train.py``'s test)."""
    l = float(tfit.loss_fn(case["tm"].schedule, case["tm"].coeffs, case["td"],
                           force_weight=1.0))
    assert l < 1e-16, l


def test_linear_warm_start_matches_jax(case):
    """Overdetermined (12 configurations, 1 + 7 columns), from the perturbed
    start: the same (species, moment) coefficients, radial ones untouched."""
    fj = jfit.linear_warm_start(case["jm"].schedule, case["start"], case["jd"])
    ft = tfit.linear_warm_start(case["tm"].schedule, case["tstart"], case["td"])
    assert ft.species_coeffs.dtype == ft.moment_coeffs.dtype == torch.float64
    assert _rel(_solution(ft), _solution(fj)) <= 1e-10
    assert ft.radial_coeffs is case["tstart"].radial_coeffs


def test_linear_warm_start_recovers_linear_coeffs(case):
    """With the teacher's radial coefficients and zeroed linear ones, the
    solve recovers the energies exactly (the twin of ``test_train.py``'s
    test). Its design matrix is ill-conditioned: the JAX and port solutions
    differ by ~1e-9 of the largest coefficient, and both fit the energies."""
    tm = case["tm"]
    zt = MTPCoeffs(tm.coeffs.radial_coeffs, torch.zeros_like(tm.coeffs.species_coeffs),
                   torch.zeros_like(tm.coeffs.moment_coeffs))
    ft = tfit.linear_warm_start(tm.schedule, zt, case["td"])
    e_err = float(tfit.loss_fn(tm.schedule, ft, case["td"], force_weight=0.0))
    assert e_err < 1e-14, e_err


def test_linear_warm_start_underdetermined_matches_lstsq():
    """4 configurations at level 16 (1 + 66 columns): the minimum-norm
    solution of ``jnp.linalg.lstsq``, by ``gelsd`` on the host."""
    m = make_mtp_jax(16, species_count=1, seed=11)
    jm = JaxModel.from_data(m, dtype=jnp.float64)
    tm = model_from_jax(jm, device="cpu")
    rng = np.random.default_rng(4)
    pos0, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    configs = [JaxConfig(cell=cell, positions=pos0 + rng.normal(scale=0.05, size=pos0.shape),
                         types=types, energy=float(e))
               for e in rng.normal(-4.0 * len(pos0), 2.0, size=4)]
    jd = jfit.make_dataset(configs, m.max_dist, max_neighbors=64)
    td = tfit.make_dataset(_port_configs(configs), m.max_dist, max_neighbors=64, device="cpu")
    fj = jfit.linear_warm_start(jm.schedule, jm.coeffs, jd)
    ft = tfit.linear_warm_start(tm.schedule, tm.coeffs, td)
    assert _solution(ft).shape == (67,)
    assert _rel(_solution(ft), _solution(fj)) <= 1e-8


def test_adam_climbs_from_a_level16_warm_start():
    """A level-16 student warm-started on 4 configurations labeled by a
    level-16 teacher (the recipe of ``train.fit.training_set``), then 5 Adam
    steps at lr 2e-3, force weight 0.1: the warm start fits the energies
    exactly and Adam's first steps raise the loss by more than 100x, in the
    JAX fit as in the port, whose curves agree to 1e-8 relative. The climb
    is the method's, so the card's level-16 fit starts from the minted
    student instead."""
    teacher = MTPModel.from_data(make_mtp(16, seed=11), device="cpu", dtype=torch.float64)
    configs = tfit.training_set(teacher, 4)
    jm = JaxModel.from_data(make_mtp_jax(16, species_count=1, seed=99), dtype=jnp.float64)
    tm = model_from_jax(jm, device="cpu")
    jconfigs = [JaxConfig(**{f.name: getattr(c, f.name) for f in dataclasses.fields(Config)})
                for c in configs]
    jd = jfit.make_dataset(jconfigs, tm.cutoff, max_neighbors=48)
    td = tfit.make_dataset(configs, tm.cutoff, max_neighbors=48, device="cpu")
    kw = dict(steps=5, learning_rate=2e-3, force_weight=0.1)
    _, lj = jfit.fit(jm.schedule, jm.coeffs, jd, **kw)
    _, lt = tfit.fit(tm.schedule, tm.coeffs, td, **kw)
    assert np.abs(lt - lj).max() <= 1e-8 * np.abs(lj).max()
    for losses in (lj, lt):
        assert losses.max() > 100 * losses[0] and losses[-1] > losses[0], losses


def test_fit_matches_jax(case):
    """10 Adam steps from the perturbed start (no warm start, lr 3e-4: a
    falling curve, so both return the last coefficients)."""
    kw = dict(steps=10, learning_rate=3e-4, warm_start=False)
    cj, lj = jfit.fit(case["jm"].schedule, case["start"], case["jd"], **kw)
    ct, lt = tfit.fit(case["tm"].schedule, case["tstart"], case["td"], **kw)
    assert lt.shape == lj.shape == (10,) and np.all(np.diff(lj) < 0)
    assert np.abs(lt - lj).max() <= 1e-8 * np.abs(lj).max()
    for name in COEFFS:
        assert _rel(getattr(ct, name), getattr(cj, name)) <= 1e-8, name
        assert not getattr(ct, name).requires_grad


def test_fit_reduces_loss(case):
    """The twin of ``test_train.py``'s: 60 Adam steps (warm start on) from
    the perturbed radial coefficients."""
    tm = case["tm"]
    l0 = float(tfit.loss_fn(tm.schedule, case["tstart"], case["td"]))
    fitted, losses = tfit.fit(tm.schedule, case["tstart"], case["td"], steps=60,
                              learning_rate=1e-3)
    assert losses[-1] < 0.2 * l0, (l0, losses[-1])
    assert float(tfit.loss_fn(tm.schedule, fitted, case["td"])) <= losses.min()


def test_fit_returns_the_coefficients_of_the_best_loss(case):
    """On a curve that falls, then rises (lr 5e-4, lowest loss at step 8),
    the port returns the coefficients that step 8 was evaluated at. The JAX
    fit pairs that loss with the coefficients after step 8, whose loss is
    higher: the off-by-one of ``mtp_tpu/train/fit.py:224-233``."""
    kw = dict(steps=10, learning_rate=5e-4, warm_start=False)
    cj, lj = jfit.fit(case["jm"].schedule, case["start"], case["jd"], **kw)
    ct, lt = tfit.fit(case["tm"].schedule, case["tstart"], case["td"], **kw)
    k = int(np.argmin(lt))
    assert 0 < k < 9 and lt[k + 1] > lt[k]
    assert np.abs(lt - lj).max() <= 1e-8 * np.abs(lj).max()
    got = float(tfit.loss_fn(case["tm"].schedule, ct, case["td"]))
    assert abs(got - lt[k]) <= 1e-12 * lt[k]
    jax_best = float(jfit.loss_fn(case["jm"].schedule, cj, case["jd"]))
    assert abs(jax_best - lt[k + 1]) <= 1e-8 * lt[k + 1]
    assert jax_best > got


def test_coeffs_from_jax_refuses_narrower_coefficients(case):
    """Float32 JAX coefficients are not widened into a float64 start."""
    c = case["start"]
    narrow = JaxCoeffs(c.radial_coeffs.astype(jnp.float32), c.species_coeffs,
                       c.moment_coeffs)
    with pytest.raises(ValueError, match="narrower"):
        coeffs_from_jax(narrow, device="cpu")
    assert coeffs_from_jax(narrow, device="cpu", dtype=torch.float32).radial_coeffs.dtype == \
        torch.float32
