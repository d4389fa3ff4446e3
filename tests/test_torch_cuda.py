"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit, and skips without
them. This file imports no jax, so it also runs where only PyTorch is
installed; on the GPU machine run it without the repository's conftest (which
imports jax):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py -q

Tolerances (fp32 on the card, kernel vs plain version on the same inputs):
K1 window_disp exact (it repeats the plain version's IEEE operations in the
same order); K4 site energies 1e-5 eV; K2 pair forces 5e-5 eV/A; K3
give-back 1e-5 eV/A. The plain path's own fp32-vs-float64 noise at level 16
is ~5e-7 eV, ~1.2e-6 eV/A and ~4e-6 eV/A for these quantities.
"""

import numpy as np
import pytest
import torch

from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.kernels import main_path_kernels
from mtp_tpu_torch.md.simulation import Simulation, make_lattice
from mtp_tpu_torch.md.state import init_state, thermalize
from mtp_tpu_torch.models.mtp import MTPModel, window_constants
from mtp_tpu_torch.ops import fused_moments as fm
from mtp_tpu_torch.ops import window_disp as wd
from mtp_tpu_torch.ops import window_giveback as wg
from mtp_tpu_torch.ops.neighbors import build_sorted_neighbor_list, grid_shape

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(dev, level, species, dtype=torch.float32):
    m = make_mtp(level, species_count=species, seed=1)
    model = MTPModel.from_data(m, device=dev, dtype=dtype)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6), type_pattern=tuple(range(species)))
    pos = pos + np.random.default_rng(level).normal(0, 0.1, pos.shape)
    p = torch.as_tensor(pos, dtype=dtype, device=dev)
    c = torch.as_tensor(cell, dtype=dtype, device=dev)
    ty = torch.as_tensor(types, dtype=torch.int32, device=dev)
    swl = build_sorted_neighbor_list(p, c, model.cutoff + 0.6, max_neighbors=64,
                                     grid=grid_shape(cell, model.cutoff + 0.6))
    assert not bool(swl.overflow)
    k = window_constants(model, ty, swl)
    pos_s = p[swl.order].contiguous()
    return model, pos_s, c, ty, swl, k


def _inputs(model, pos_s, c, swl, k):
    dispT = wd.window_disp(pos_s, swl.idx, c)
    d2 = dispT[0] * dispT[0] + dispT[1] * dispT[1] + dispT[2] * dispT[2]
    mask = ((d2 <= model.cutoff**2) & k["pair_valid_t"]).to(torch.float32)
    return (model.tables, dispT, mask, k["it_row"], k["jtypes_t"],
            model.coeffs.radial_coeffs, k["xi_full"])


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


def test_window_disp_is_exact(dev):
    model, pos_s, c, _, swl, _ = _case(dev, 16, 2)
    got = wd.window_disp(pos_s, swl.idx, c)
    want = wd.window_disp_plain(pos_s, swl.idx, c)
    torch.cuda.synchronize()
    assert got.shape == (3, 64, pos_s.shape[0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("level,species", [(8, 2), (16, 2), (16, 1)])
def test_fused_kernels_match_plain(dev, level, species):
    """One binary serves every level: the schedule is a run-time table."""
    model, pos_s, c, _, swl, k = _case(dev, level, species)
    args = _inputs(model, pos_s, c, swl, k)
    e = fm.site_energies_mega(*args, k["esp"])
    t = fm.pair_forces_mega(*args)
    torch.cuda.synchronize()
    assert bool(e.isfinite().all()) and bool(t.isfinite().all())
    assert _err(e, fm.site_energies_mega_plain(*args, k["esp"])) < 1e-5
    assert _err(t, fm.pair_forces_mega_plain(*args)) < 5e-5
    de = torch.rand(pos_s.shape[0], device=dev)
    assert _err(fm.pair_forces_mega(*args, de=de), fm.pair_forces_mega_plain(*args, de=de)) < 5e-5


def test_site_energies_backward_is_pair_forces_kernel(dev):
    model, pos_s, c, _, swl, k = _case(dev, 16, 2)
    args = _inputs(model, pos_s, c, swl, k)
    d = args[1].clone().requires_grad_(True)
    e = fm.site_energies_mega(args[0], d, *args[2:], k["esp"])
    launches = fm.K2.launches
    (g,) = torch.autograd.grad(e.sum(), d)
    assert fm.K2.launches == launches + 1
    assert torch.equal(g, fm.pair_forces_mega(*args))


def test_giveback_matches_plain(dev):
    model, pos_s, c, _, swl, k = _case(dev, 16, 2)
    t = fm.pair_forces_mega(*_inputs(model, pos_s, c, swl, k))
    got = wg.window_giveback(t, swl.mirror)
    torch.cuda.synchronize()
    assert _err(got, wg.window_giveback_plain(t, swl.mirror)) < 1e-5
    # Newton's third law: the forces of a periodic box sum to zero
    assert float(got.double().sum(0).abs().max()) < 1e-3


def test_wrappers_raise_instead_of_falling_back(dev):
    model, pos_s, c, _, swl, k = _case(dev, 8, 2)
    with pytest.raises(TypeError):
        wd.window_disp(pos_s.double(), swl.idx, c)
    with pytest.raises(TypeError):
        wg.window_giveback(torch.zeros((3, 64, pos_s.shape[0]), dtype=torch.float64,
                                       device=dev), swl.mirror)
    args = _inputs(model, pos_s, c, swl, k)
    with pytest.raises(ValueError):
        fm.pair_forces_mega(args[0], args[1].double(), *args[2:])


def test_main_path_launches_every_kernel(dev):
    model = MTPModel.from_data(make_mtp(16, seed=0), device=dev, dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6))
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, device=dev)
    st = thermalize(torch.Generator(device=dev).manual_seed(0), st, 300.0)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                     compute_virial=False)
    ks = main_path_kernels()
    before = [(kk.launches, kk.plain_calls) for kk in ks]
    st, _, fl = sim.run_async(st, 20, dt=0.001)
    assert not bool(fl)
    assert bool(st.positions.isfinite().all()) and bool(st.potential_energy.isfinite())
    for kk, (l0, p0) in zip(ks, before):
        assert kk.launches > l0, kk.name
        assert kk.plain_calls == p0, kk.name
