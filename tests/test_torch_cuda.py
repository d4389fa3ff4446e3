"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit, and skips without
them. This file imports no jax, so it also runs where only PyTorch is
installed; on the GPU machine run it without the repository's conftest (which
imports jax):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py -q

Tolerances (fp32 on the card, kernel vs plain version on the same inputs):
K1 window_disp exact in displacements and mask (it repeats the plain
version's IEEE operations in the same order); K4 site energies 1e-5 eV; K2
pair forces 5e-5 eV/A; K3 give-back 1e-5 eV/A (the slot sums run in another
order), and two K3 launches bit-equal. The plain path's own fp32-vs-float64 noise at level 16
is ~5e-7 eV, ~1.2e-6 eV/A and ~4e-6 eV/A for these quantities. K5 as K4 and
K2 for its site energies and pair forces, and 1e-10 of the largest entry for
its basis members and radial rows (K5 and its twin both compute them in
float64 and differ by the order of their sums, ~1e-15; fp32 arithmetic would
give ~1e-7); K6 1e-5 of the largest basic moment; K7 (the gradient of the
modular energy path) 5e-5 eV/A. An NPT block of 20 steps on the card against the same block
on the CPU (the plain twins, fp32 too): positions 1e-4 A, the cell 1e-5 of
its largest entry, the barostat strain rate 1e-3 of its value. The float64
plain path (the oracle) bit-equal between runs; two training steps on the
card against the CPU 1e-9 relative in losses and coefficients. K8
neighbor_rows bit-equal to its plain twin in rows, mirror and flag whenever
no capacity overflows (the same IEEE operations in the same order), the flag
alone under overflow. K9 md_step bit-equal to its plain twin in positions,
velocities and step; K10 verlet_top2 bit-equal in m1 and m2 (NaN where the
twin's is) and equal in the flag, on every case. K11 cell_list bit-equal to
its plain twin in every output on every case, a bin past its capacity
included (both keep a bin's first `cap` rows).
"""

import json
import re

import numpy as np
import pytest
import torch

from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.kernels import main_path_kernels
from mtp_tpu_torch.md.simulation import Simulation, _default_aux, make_lattice
from mtp_tpu_torch.md.state import init_state, thermalize
from mtp_tpu_torch.models.mtp import MTPModel, _window_geometry, window_constants
from mtp_tpu_torch.ops import fused_basic as fb
from mtp_tpu_torch.ops import fused_candidates as fc
from mtp_tpu_torch.ops import fused_moments as fm
from mtp_tpu_torch.ops import md_step as ms
from mtp_tpu_torch.ops import neighbors as nbm
from mtp_tpu_torch.ops import window_disp as wd
from mtp_tpu_torch.ops import window_giveback as wg
from mtp_tpu_torch.ops.neighbors import build_neighbor_list, build_sorted_neighbor_list, grid_shape

from _torch_spawn import World

pytestmark = pytest.mark.cuda

K5_REL = 1e-10  # K5's basis members and radial rows vs its float64 twin, of the largest entry


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(dev, level, species, dtype=torch.float32, **mint):
    m = make_mtp(level, species_count=species, seed=1, **mint)
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
    dispT, mask = _window_geometry(model, pos_s, c, swl, k["idx_t"], k["pair_valid_t"], True)
    return (model.tables, dispT, mask, k["it_row"], k["jtypes_t"],
            model.coeffs.radial_coeffs, k["xi_full"])


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


def _geometry_box(dev, kind):
    """Sorted positions, cell and list of the K1 cases: "triclinic", the
    864-atom jittered box with b tilted along x by 0.2 of a; "at the
    cutoff", the unjittered 256-atom fcc box of side 16 A (every fp32
    operation of its minimum image is exact) with one atom moved to
    (3, 4, 0) A from another across the periodic boundary, so that one pair
    sits at exactly d = 5 A, the level-16 cutoff."""
    if kind == "triclinic":
        pos, _, cell = make_lattice("fcc", 4.0, (6, 6, 6))
        tri = cell.copy()
        tri[1, 0] = 0.2 * cell[0, 0]
        pos = pos @ np.linalg.inv(cell) @ tri + np.random.default_rng(3).normal(0, 0.1, pos.shape)
        cell = tri
    else:
        pos, _, cell = make_lattice("fcc", 4.0, (4, 4, 4))
        a = int(np.flatnonzero((pos == [12.0, 12.0, 0.0]).all(1))[0])
        pos[a + 1] = pos[a] + [3.0, 4.0, 0.0]  # (15, 16, 0): y on the boundary
    p = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    c = torch.as_tensor(cell, dtype=torch.float32, device=dev)
    swl = build_sorted_neighbor_list(p, c, 5.6, max_neighbors=64, grid=grid_shape(cell, 5.6))
    assert not bool(swl.overflow)
    return p[swl.order].contiguous(), c, swl


@pytest.mark.parametrize("kind", ["triclinic", "at the cutoff"])
def test_window_disp_is_exact(dev, kind):
    """K1's displacements and mask are bit-equal to its plain twin's; the
    pair at exactly the cutoff is in the mask of both."""
    pos_s, c, swl = _geometry_box(dev, kind)
    k = window_constants(MTPModel.from_data(make_mtp(8, seed=0), device=dev), torch.zeros(
        pos_s.shape[0], dtype=torch.int32, device=dev), swl)
    args = (pos_s, k["idx_t"], c, k["pair_valid_t"], 5.0)
    launches = wd.K1.launches
    got = wd.window_geometry(*args)
    want = wd.window_geometry_plain(*args)
    torch.cuda.synchronize()
    assert wd.K1.launches == launches + 1
    assert got[0].shape == (3, 64, pos_s.shape[0]) and got[1].shape == (64, pos_s.shape[0])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 20 < float(got[1].sum()) / pos_s.shape[0] < 60
    if kind == "at the cutoff":  # the moved atom has five lattice sites at 5 A
        at = (got[0] * got[0]).sum(0) == 25.0
        assert int(at.sum()) == 10 and bool((got[1][at] == 1.0).all())


def test_window_geometry_is_one_launch(dev):
    """On the main path (sorted positions) the whole window geometry is one
    kernel on the device: no inverse, cast or mask kernels beside K1."""
    model, pos_s, c, _, swl, k = _case(dev, 8, 1)
    _inputs(model, pos_s, c, swl, k)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _window_geometry(model, pos_s, c, swl, k["idx_t"], k["pair_valid_t"], True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [e.name for e in kernels] == [kernels[0].name] and "window_geometry" in kernels[0].name


def test_force_spans_share_the_kernels_clock(dev, tmp_path):
    """The port's spans and the kernels lie on the profiler's one clock:
    every kernel launched inside an ``mtp.forces`` span starts no earlier
    than the span and ends no earlier than its own launch call."""
    model = MTPModel.from_data(make_mtp(8, seed=1), device=dev, dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6))
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, device=dev)
    st = thermalize(torch.Generator(device=dev).manual_seed(0), st, 300.0)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=5,
                     compute_virial=False)
    sim.run(st, 5, dt=0.001)  # builds and loads the kernels
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sim.run(st, 10, dt=0.001)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    forces = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e["name"] == "mtp.forces"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    checked = 0
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") != "kernel" or corr not in launches:
            continue
        t = launches[corr]
        span = next((s for s in forces if s[0] <= t < s[1]), None)
        if span is None:
            continue
        assert e["ts"] >= span[0] and e["ts"] + e["dur"] >= t, (e["name"], span, t)
        checked += 1
    assert len(forces) == 12  # 10 steps and a refresh in each of the 2 blocks
    assert checked >= 3 * len(forces)  # K1, K2 and K3 at least


@pytest.mark.parametrize("level,species", [(8, 1), (8, 2), (16, 2), (16, 1)])
def test_fused_kernels_match_plain(dev, level, species):
    """K4 and K2 on their specialised shapes (levels 8 and 16), with and
    without de, against the plain twins; K6 alone at 1e-5 of its largest
    moment and K7 alone (a random gamma) at 1e-5 of its largest force; two
    launches of each agree bit for bit."""
    model, pos_s, c, _, swl, k = _case(dev, level, species)
    assert model.tables.shape != 0
    assert fm.resident_warps(model.tables, swl.idx.shape[1])["float specialised"] == 1
    args = _inputs(model, pos_s, c, swl, k)
    e = fm.site_energies_mega(*args, k["esp"])
    t = fm.pair_forces_mega(*args)
    torch.cuda.synchronize()
    assert bool(e.isfinite().all()) and bool(t.isfinite().all())
    assert _err(e, fm.site_energies_mega_plain(*args, k["esp"])) < 1e-5
    assert _err(t, fm.pair_forces_mega_plain(*args)) < 5e-5
    de = torch.rand(pos_s.shape[0], device=dev)
    td = fm.pair_forces_mega(*args, de=de)
    assert _err(td, fm.pair_forces_mega_plain(*args, de=de)) < 5e-5
    assert torch.equal(e, fm.site_energies_mega(*args, k["esp"]))
    assert torch.equal(t, fm.pair_forces_mega(*args))
    assert torch.equal(td, fm.pair_forces_mega(*args, de=de))
    mb = fb.basic_moments_fused(*args[:6])
    assert _rel(mb, fb.basic_moments_fused_plain(*args[:6])) < 1e-5
    g = torch.Generator(device=dev).manual_seed(level + species)
    gamma = torch.rand((model.schedule.basic_count, pos_s.shape[0]), device=dev, generator=g)
    t7 = fb.basic_moments_vjp(*args[:6], gamma)
    assert _rel(t7, fb.basic_moments_vjp_plain(*args[:6], gamma)) < 1e-5
    assert torch.equal(mb, fb.basic_moments_fused(*args[:6]))
    assert torch.equal(t7, fb.basic_moments_vjp(*args[:6], gamma))


def _padded(args, k, pad):
    """The kernels' inputs with `pad` rows after the atoms: random
    displacements behind an all-zero mask (padding and ghost rows as the
    sharded engine lays them out), and the same rows of esp zero."""
    tables, dispT, mask, it, jt, rc, xi = args
    dev = dispT.device
    g = torch.Generator(device=dev).manual_seed(pad)
    dispT = torch.cat([dispT, torch.randn((3, dispT.shape[1], pad), device=dev, generator=g)], 2)
    mask = torch.cat([mask, torch.zeros((mask.shape[0], pad), device=dev)], 1)
    it = torch.cat([it, torch.zeros(pad, dtype=it.dtype, device=dev)])
    jt = torch.cat([jt, torch.zeros((jt.shape[0], pad), dtype=jt.dtype, device=dev)], 1)
    esp = torch.cat([k["esp"], torch.zeros(pad, device=dev)])
    return (tables, dispT.contiguous(), mask.contiguous(), it, jt.contiguous(), rc, xi), esp


@pytest.mark.parametrize("level", [8, 16])
def test_float_stages_ignore_padding_rows(dev, level):
    """An atom's K2 pair forces, K4 site energy, K6 basic moments and K7
    pair forces are bit-equal when the same atoms are followed by 45 and 77
    fully masked rows (a larger N and other blocks): what keeps the sharded
    runs bit-equal to one device (chip_smoke.py phases 11a and 12a)."""
    model, pos_s, c, _, swl, k = _case(dev, level, 2)
    args = _inputs(model, pos_s, c, swl, k)
    n = pos_s.shape[0]
    g = torch.Generator(device=dev).manual_seed(level)
    gamma = torch.rand((model.schedule.basic_count, n), device=dev, generator=g)
    t2 = fm.pair_forces_mega(*args)
    e4 = fm.site_energies_mega(*args, k["esp"])
    mb = fb.basic_moments_fused(*args[:6])
    t7 = fb.basic_moments_vjp(*args[:6], gamma)
    for pad in (45, 77):
        pargs, esp = _padded(args, k, pad)
        pg = torch.cat([gamma, torch.rand((gamma.shape[0], pad), device=dev, generator=g)], 1)
        assert torch.equal(fm.pair_forces_mega(*pargs)[:, :, :n], t2), pad
        assert torch.equal(fm.site_energies_mega(*pargs, esp)[:n], e4), pad
        assert torch.equal(fb.basic_moments_fused(*pargs[:6])[:, :n], mb), pad
        t = fb.basic_moments_vjp(*pargs[:6], pg.contiguous())
        assert torch.equal(t[:, :, :n], t7) and not bool(t[:, :, n:].any()), pad


@pytest.mark.parametrize("level,rb,stage", [(8, 8, "float_kernel"), (16, 8, "float_kernel"),
                                             (12, 10, "pair_kernel")])
def test_float_stages_run_their_kernels(dev, level, rb, stage):
    """K2, K4, K6 and K7 launch the specialised float stages (float_kernel:
    basic stage 0, tail 1) for the schedules of levels 8 and 16, and the
    General ones (pair_kernel<General, stage, float>) for level 12 with 10
    Chebyshev functions (kernel names from the profiler); resident_warps
    says which."""
    model, pos_s, c, _, swl, k = _case(dev, level, 2, radial_basis_size=rb)
    warps = fm.resident_warps(model.tables, swl.idx.shape[1])
    assert warps["float specialised"] == (stage == "float_kernel")
    args = _inputs(model, pos_s, c, swl, k)
    gamma = torch.rand((model.schedule.basic_count, pos_s.shape[0]), device=dev)
    calls = {
        "K2": (lambda: fm.pair_forces_mega(*args), (0, 1)),
        "K4": (lambda: fm.site_energies_mega(*args, k["esp"]), (0,)),
        "K6": (lambda: fb.basic_moments_fused(*args[:6]), (0,)),
        "K7": (lambda: fb.basic_moments_vjp(*args[:6], gamma), (1,)),
    }
    for label, (fn, stages) in calls.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if "_kernel<" in e.key]
        pair = sorted(nm for nm in names if "pair_kernel<" in nm or "float_kernel<" in nm)
        assert len(pair) == len(stages) and all(stage + "<" in nm for nm in pair), (label, names)
        if stage == "pair_kernel":
            assert all("General" in nm and "float>" in nm for nm in pair), (label, names)
        pattern = r"_kernel<.*, (\d)(, float)?>\("
        got = sorted(int(re.search(pattern, nm).group(1)) for nm in pair)
        assert got == list(stages), (label, names)


def _sparse_inputs(model, k, j, n=32, live=3):
    """The kernels' inputs for `n` atoms of one species with `j` slots, the
    first `live` of them in range, the rest masked."""
    dev = k["xi_full"].device
    g = torch.Generator(device=dev).manual_seed(j)
    s = model.schedule
    u = torch.nn.functional.normalize(torch.randn((3, live, n), device=dev, generator=g), dim=0)
    r = s.min_dist + 0.5 + (s.max_dist - s.min_dist - 1.0) * torch.rand(
        (live, n), device=dev, generator=g)
    dispT = torch.randn((3, j, n), device=dev, generator=g)
    dispT[:, :live] = u * r
    mask = torch.zeros((j, n), device=dev)
    mask[:live] = 1.0
    it = torch.zeros(n, dtype=torch.int32, device=dev)
    jt = torch.zeros((j, n), dtype=torch.int32, device=dev)
    return (model.tables, dispT, mask, it, jt, model.coeffs.radial_coeffs, k["xi_full"])


def test_float_tail_raises_beyond_its_slot_ceiling(dev):
    """The specialised float tail keeps 33 floats a slot in shared memory
    (fused_moments.cu `float_floats`), so J has a ceiling: 4 (head + 32 BP +
    64 + 33 J) bytes within the 227 KB a block may have, 1,626 at level 16
    (BP = 136) with one species and RB = 8. At the ceiling K7 and K2 match
    their twins; one slot beyond it both raise, resident_warps too, and the
    next launch still runs and gives the same bits."""
    model, _, _, _, _, k = _case(dev, 16, 1)
    s = model.schedule
    head = (s.species_count ** 2 * s.radial_funcs_count * s.radial_basis_size + 3) // 4 * 4
    j_max = (227 * 1024 // 4 - head - 32 * 136 - 64) // 33
    assert j_max == 1626
    args = _sparse_inputs(model, k, j_max)
    gamma = torch.rand((s.basic_count, 32), device=dev)
    t7 = fb.basic_moments_vjp(*args[:6], gamma)
    assert _rel(t7, fb.basic_moments_vjp_plain(*args[:6], gamma)) < 1e-5
    assert _err(fm.pair_forces_mega(*args), fm.pair_forces_mega_plain(*args)) < 5e-5
    assert fm.resident_warps(model.tables, j_max)["tail"] > 0
    over = _sparse_inputs(model, k, j_max + 1)
    with pytest.raises(RuntimeError, match="failed to launch"):
        fb.basic_moments_vjp(*over[:6], gamma)
    with pytest.raises(RuntimeError, match="failed to launch"):
        fm.pair_forces_mega(*over)
    with pytest.raises(RuntimeError, match="occupancy query failed"):
        fm.resident_warps(model.tables, j_max + 1)
    assert torch.equal(fb.basic_moments_vjp(*args[:6], gamma), t7)


def test_general_shape_matches_plain(dev):
    """A schedule with no specialised instantiation (level 12, 10 Chebyshev
    functions) runs every mode on the General one and matches the plain
    twins."""
    model, pos_s, c, _, swl, k = _case(dev, 12, 2, radial_basis_size=10)
    assert model.tables.shape == 0
    args = _inputs(model, pos_s, c, swl, k)
    assert _err(fm.site_energies_mega(*args, k["esp"]),
                fm.site_energies_mega_plain(*args, k["esp"])) < 1e-5
    de = torch.rand(pos_s.shape[0], device=dev)
    t = fm.pair_forces_mega(*args, de=de)
    assert _err(t, fm.pair_forces_mega_plain(*args, de=de)) < 5e-5
    assert torch.equal(t, fm.pair_forces_mega(*args, de=de))
    got = fc.candidates_mega(*args, k["esp"])
    want = fc.candidates_mega_plain(*args, k["esp"])
    assert _err(got["pair_tT"], want["pair_tT"]) < 5e-5
    assert _rel(got["rad"], want["rad"]) < K5_REL
    assert _rel(got["basis_members"], want["basis_members"]) < K5_REL
    mb = fb.basic_moments_fused(*args[:6])
    assert _rel(mb, fb.basic_moments_fused_plain(*args[:6])) < 1e-5
    gamma = torch.rand((model.schedule.basic_count, pos_s.shape[0]), device=dev)
    assert _rel(fb.basic_moments_vjp(*args[:6], gamma),
                fb.basic_moments_vjp_plain(*args[:6], gamma)) < 1e-5


@pytest.mark.parametrize("level,staged", [(2, 1), (6, 1), (18, 0)])
def test_dag_layouts_match_plain(dev, level, staged):
    """Levels whose moment count M is below the DAG block's 16 warps (2, 6:
    K4's and K5's readout partial sums need more rows than m has), and a
    level whose DAG table does not fit in shared memory beside m and dm
    (18: read through the read-only cache, 16 atoms per block), against
    the plain twins; K2 twice bit-equal."""
    model, pos_s, c, _, swl, k = _case(dev, level, 1)
    assert fm.resident_warps(model.tables, swl.idx.shape[1])["DAG table staged"] == staged
    args = _inputs(model, pos_s, c, swl, k)
    assert _err(fm.site_energies_mega(*args, k["esp"]),
                fm.site_energies_mega_plain(*args, k["esp"])) < 1e-5
    de = torch.rand(pos_s.shape[0], device=dev)
    t = fm.pair_forces_mega(*args, de=de)
    assert _err(t, fm.pair_forces_mega_plain(*args, de=de)) < 5e-5
    assert torch.equal(t, fm.pair_forces_mega(*args, de=de))
    got = fc.candidates_mega(*args, k["esp"])
    want = fc.candidates_mega_plain(*args, k["esp"])
    assert _err(got["site_e"], want["site_e"]) < 1e-5
    assert _err(got["pair_tT"], want["pair_tT"]) < 5e-5
    assert _rel(got["basis_members"], want["basis_members"]) < K5_REL
    assert _rel(got["rad"], want["rad"]) < K5_REL


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
    got = wg.window_giveback(t, k["mirror_t"])
    torch.cuda.synchronize()
    assert _err(got, wg.window_giveback_plain(t, k["mirror_t"])) < 1e-5
    assert torch.equal(got, wg.window_giveback(t, k["mirror_t"]))  # no atomics
    # Newton's third law: the forces of a periodic box sum to zero
    assert float(got.double().sum(0).abs().max()) < 1e-3


@pytest.mark.parametrize("n", [1000, 60000], ids=["fits in L2", "past L2"])
def test_giveback_layouts_match_plain(dev, n):
    """Both of K3's layouts (two slot groups while pair_T and mirror_t fit in
    the card's L2, one thread per atom past it) on a random pair_T and a
    random mirror involution, J = 64: within 1e-5 of the plain twin, and
    two launches bit-equal."""
    j = 64
    g = torch.Generator(device=dev).manual_seed(n)
    perm = torch.randperm(j * n, device=dev, generator=g).view(-1, 2)
    mirror_t = torch.empty(j * n, dtype=torch.int64, device=dev)
    mirror_t[perm[:, 0]] = perm[:, 1]
    mirror_t[perm[:, 1]] = perm[:, 0]
    mirror_t = mirror_t.view(j, n).to(torch.int32)
    t = torch.randn((3, j, n), device=dev, generator=g) * 0.05  # eV/A, as pair forces
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    assert (16 * j * n <= l2) == (n == 1000)
    got = wg.window_giveback(t, mirror_t)
    assert _err(got, wg.window_giveback_plain(t, mirror_t)) < 1e-5
    assert torch.equal(got, wg.window_giveback(t, mirror_t))


def test_wrappers_raise_instead_of_falling_back(dev):
    model, pos_s, c, _, swl, k = _case(dev, 8, 2)
    geo = (pos_s, k["idx_t"], c, k["pair_valid_t"], model.cutoff)
    for i, bad in ((0, pos_s.double()), (1, k["idx_t"].long()), (2, c.double()),
                   (3, k["pair_valid_t"].float())):
        with pytest.raises(TypeError):
            wd.window_geometry(*geo[:i], bad, *geo[i + 1:])
    for i, bad in ((1, swl.idx), (1, k["idx_t"].T), (3, k["pair_valid_t"].T.contiguous().T),
                   (0, pos_s.T.contiguous().T)):
        with pytest.raises(ValueError):
            wd.window_geometry(*geo[:i], bad, *geo[i + 1:])
    t = torch.zeros((3, 64, pos_s.shape[0]), dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        wg.window_giveback(t.double(), k["mirror_t"])
    with pytest.raises(TypeError):
        wg.window_giveback(t, k["mirror_t"].long())
    for bad in (swl.mirror, k["mirror_t"].T.contiguous(), k["mirror_t"].T.contiguous().T):
        with pytest.raises(ValueError):
            wg.window_giveback(t, bad)
    args = _inputs(model, pos_s, c, swl, k)
    with pytest.raises(ValueError):
        fm.pair_forces_mega(args[0], args[1].double(), *args[2:])


def _rows_box(dev, reps, a=4.0, tilt=0.0, dtype=torch.float32, seed=0):
    """A jittered fcc box (0.1 A) on the card; b tilted along x by `tilt` of a."""
    pos, _, cell = make_lattice("fcc", a, reps)
    cell = cell.copy()
    cell[1, 0] = tilt * cell[0, 0]
    pos = pos @ np.linalg.inv(np.diag(np.diag(cell))) @ cell
    pos = pos + np.random.default_rng(seed).normal(0, 0.1, pos.shape)
    return (torch.as_tensor(pos, dtype=dtype, device=dev),
            torch.as_tensor(cell, dtype=dtype, device=dev), cell)


# name: (reps, a, tilt, dtype, grid (None: grid_shape), J, sorted build, options, overflows)
_ROWS_CASES = {
    "fcc32k": ((20, 20, 20), 3.8, 0.0, torch.float32, None, 64, True, {}, False),
    "alloy131k": ((32, 32, 32), 3.8, 0.0, torch.float32, None, 64, True, {}, False),
    "triclinic": ((6, 6, 6), 4.0, 0.2, torch.float32, None, 64, False, {}, False),
    "2-bin axes": ((6, 3, 3), 4.0, 0.0, torch.float32, None, 64, False, {}, False),
    "1-bin axis": ((6, 6, 6), 4.0, 0.0, torch.float32, (1, 4, 4), 64, False, {}, False),
    "real, trash rows": ((6, 6, 6), 4.0, 0.0, torch.float32, None, 64, True, {"real": 7}, False),
    "centers": ((6, 3, 3), 4.0, 0.1, torch.float32, None, 64, False,
                {"real": 7, "centers": 200}, False),
    "self image": ((6, 6, 6), 4.0, 0.0, torch.float32, None, 64, False,
                   {"include_self_image": True}, False),
    "float64": ((6, 6, 6), 4.0, 0.2, torch.float64, None, 64, True, {}, False),
    "float64 unsorted": ((8, 8, 8), 3.8, 0.0, torch.float64, None, 64, False, {}, False),
    "J 104": ((6, 6, 6), 4.0, 0.0, torch.float32, None, 104, True, {}, False),
    "J overflows": ((6, 6, 6), 4.0, 0.0, torch.float32, None, 40, True, {}, True),
    "bin overflows": ((6, 6, 6), 4.0, 0.0, torch.float32, None, 64, False,
                      {"bin_capacity": 4}, True),
}


@pytest.mark.parametrize("case", list(_ROWS_CASES))
def test_neighbor_rows_kernel_matches_plain(dev, case, monkeypatch):
    """A build with K8 against the same build with its plain twin on the
    card: rows, mirror (and bin order) bit-equal and the flag equal; under
    overflow the flag alone. The kernel launches once a build, the twin not."""
    reps, a, tilt, dtype, grid, j, sorted_build, opts, overflows = _ROWS_CASES[case]
    p, c, cell = _rows_box(dev, reps, a, tilt, dtype)
    grid = grid or grid_shape(cell, 5.6)
    kw = dict(opts, max_neighbors=j, grid=grid)
    if "real" in kw:
        kw["real"] = torch.arange(len(p), device=dev) % kw["real"] != 0
    build = build_sorted_neighbor_list if sorted_build else build_neighbor_list
    launches, plain = nbm.K8.launches, nbm.K8.plain_calls
    got = build(p, c, 5.6, **kw)
    torch.cuda.synchronize()
    assert (nbm.K8.launches, nbm.K8.plain_calls) == (launches + 1, plain)
    monkeypatch.setattr(nbm, "neighbor_rows", nbm.neighbor_rows_plain)
    want = build(p, c, 5.6, **kw)
    torch.cuda.synchronize()
    assert (nbm.K8.launches, nbm.K8.plain_calls) == (launches + 1, plain + 1)
    assert bool(got.overflow) == bool(want.overflow) == overflows
    if overflows:
        return
    assert got.idx.dtype == torch.int32 and got.idx.shape == want.idx.shape
    assert torch.equal(got.idx, want.idx)
    assert (got.mirror is None) == (want.mirror is None) == ("centers" in opts)
    if got.mirror is not None:
        assert torch.equal(got.mirror, want.mirror)
    if sorted_build:
        assert torch.equal(got.order, want.order)
    live = float((got.idx != torch.arange(len(got.idx), device=dev)[:, None]).sum())
    assert live > 20 * len(got.idx) * (0.8 if "real" in opts else 1.0)


def test_neighbor_rows_is_one_launch(dev):
    """The row phase on the card: one K8 launch beside the count's zero
    fill; no sort kernel."""
    p, c, cell = _rows_box(dev, (10, 10, 10), 3.8)
    grid = grid_shape(cell, 5.6)
    cl = nbm.cell_list(p, c, 5.6, grid, sort=False)
    args = (p, cl.bin3, cl.table, cl.counts, c, cl.inv_cell, grid, 5.6, 64, len(p))
    nbm.neighbor_rows(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        nbm.neighbor_rows(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2 and sum("neighbor_rows_kernel" in n for n in names) == 1, names
    assert not any("sort" in n.lower() for n in names), names


def test_neighbor_rows_refuses_bad_operands(dev):
    p, c, cell = _rows_box(dev, (6, 6, 6))
    grid = grid_shape(cell, 5.6)
    cl = nbm.cell_list(p, c, 5.6, grid, sort=False)
    bin3, table, counts, inv = cl.bin3, cl.table, cl.counts, cl.inv_cell
    args = (p, bin3, table, counts, c, inv, grid, 5.6, 64, len(p))
    for i, bad in ((0, p.half()), (1, bin3.int()), (2, table.int()), (3, counts.int()),
                   (4, c.double())):
        with pytest.raises(TypeError):
            nbm.neighbor_rows(*args[:i], bad, *args[i + 1:])
    for i, bad in ((5, inv.T), (0, p.T.contiguous().T), (1, bin3[:-1]), (3, counts[:-1]),
                   (9, len(p) + 1)):
        with pytest.raises(ValueError):
            nbm.neighbor_rows(*args[:i], bad, *args[i + 1:])
    with pytest.raises(RuntimeError):  # a J whose buffer exceeds shared memory
        nbm.neighbor_rows(*args[:8], 9000, len(p))


def test_simulation_run_builds_rows_with_the_kernel(dev):
    """`Simulation.run` on the card: K8 and K11 launch once per rebuild and
    their plain twins never run."""
    model = MTPModel.from_data(make_mtp(8, seed=0), device=dev, dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6))
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, device=dev)
    st = thermalize(torch.Generator(device=dev).manual_seed(0), st, 300.0)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                     compute_virial=False)
    rebuilds = []
    inner = sim.rebuild
    sim.rebuild = lambda *a, **kw: rebuilds.append(1) or inner(*a, **kw)
    launches, plain = nbm.K8.launches, nbm.K8.plain_calls
    sort_launches, sort_plain = nbm.K11.launches, nbm.K11.plain_calls
    sim.run(st, 30, dt=0.001)
    torch.cuda.synchronize()
    assert len(rebuilds) >= 3
    assert nbm.K8.launches - launches == len(rebuilds) and nbm.K8.plain_calls == plain
    assert nbm.K11.launches - sort_launches == len(rebuilds) and nbm.K11.plain_calls == sort_plain


# name: (reps, a, tilt, dtype, grid (None: grid_shape), bin_capacity, real every k-th row
# dropped (0: no mask), atoms crowded into one bin)
_CELL_CASES = {
    "fcc32k": ((20, 20, 20), 3.8, 0.0, torch.float32, None, None, 0, 0),
    "alloy131k": ((32, 32, 32), 3.8, 0.0, torch.float32, None, None, 0, 0),
    "tilted": ((6, 6, 6), 4.0, 0.2, torch.float32, None, None, 0, 0),
    "1-bin axis": ((6, 6, 6), 4.0, 0.0, torch.float32, (1, 4, 4), None, 0, 0),
    "2-bin axes": ((6, 3, 3), 4.0, 0.0, torch.float32, None, None, 0, 0),
    "float64": ((6, 6, 6), 4.0, 0.2, torch.float64, None, None, 0, 0),
    "random gas": (None, None, None, torch.float32, None, None, 0, 0),
    "trash bin of thousands": ((12, 12, 12), 4.0, 0.0, torch.float32, None, None, 2, 0),
    "one overflowed bin": ((6, 6, 6), 4.0, 0.0, torch.float32, None, None, 0, 60),
    "every bin over capacity": ((6, 6, 6), 4.0, 0.0, torch.float32, None, 4, 0, 0),
}


def _cell_case(dev, case):
    reps, a, tilt, dtype, grid, cap, every, crowd = _CELL_CASES[case]
    if reps is None:  # 900 atoms anywhere in a box three times the cell's: unwrapped
        cell = np.diag([23.0, 25.0, 27.0])
        pos = np.random.default_rng(12).uniform(-1.0, 2.0, (900, 3)) * np.diag(cell)
        p = torch.as_tensor(pos, dtype=dtype, device=dev)
        c = torch.as_tensor(cell, dtype=dtype, device=dev)
    else:
        p, c, cell = _rows_box(dev, reps, a, tilt, dtype)
        if crowd:
            # about the centre of the first bin (6 A wide), past its capacity of 42
            g = torch.Generator(device=dev).manual_seed(1)
            p[:crowd] = 3.0 + 0.05 * torch.randn((crowd, 3), dtype=dtype, device=dev, generator=g)
    real = torch.arange(len(p), device=dev) % every != 0 if every else None
    return p, c, grid or grid_shape(cell, 5.6), cap, real


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("case", list(_CELL_CASES))
def test_cell_list_kernel_matches_plain(dev, case, sort, monkeypatch):
    """K11 against its plain twin on the same inputs, on the card: every
    output bit-equal (the table of a bin past its capacity too), order a
    permutation; one launch, no twin call. Sorted and within capacity, a
    whole build with K11 against one with its twin: rows, mirror and order
    bit-equal."""
    p, c, grid, cap, real = _cell_case(dev, case)
    n = len(p)
    launches, plain = nbm.K11.launches, nbm.K11.plain_calls
    got = nbm.cell_list(p, c, 5.6, grid, cap, real, sort=sort)
    torch.cuda.synchronize()
    assert (nbm.K11.launches, nbm.K11.plain_calls) == (launches + 1, plain)
    want = nbm.cell_list_plain(p, c, 5.6, grid, cap, real, sort=sort)
    overflows = case in ("one overflowed bin", "every bin over capacity")
    assert bool(got.overflow) == bool(want.overflow) == overflows
    for name in ("inv_cell", "positions", "bin3", "table", "counts"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.inv_cell.is_contiguous() and got.table.shape == want.table.shape
    assert (got.real is None) == (real is None)
    if real is not None:
        assert torch.equal(got.real, want.real)
        assert int(got.counts[-1]) == int((~real).sum()) > 1000
    if not sort:
        assert got.order is None and got.inv_order is None and got.positions is p
        return
    assert torch.equal(got.order, want.order) and torch.equal(got.inv_order, want.inv_order)
    assert torch.equal(torch.sort(got.order).values, torch.arange(n, device=dev))
    if overflows:
        return
    build = lambda: build_sorted_neighbor_list(p, c, 5.6, max_neighbors=64, grid=grid,  # noqa: E731
                                               real=real, bin_capacity=cap)
    kernel_build = build()
    monkeypatch.setattr(nbm, "cell_list", nbm.cell_list_plain)
    twin_build = build()
    assert not bool(kernel_build.overflow) and not bool(twin_build.overflow)
    for name in ("idx", "mirror", "order", "inv_order"):
        assert torch.equal(getattr(kernel_build, name), getattr(twin_build, name)), name


def test_sort_span_launches_at_most_six(dev, tmp_path):
    """A sorted build's ``nl.sort`` span on the card: K11's four kernels and
    one memset, nothing else (no sort kernel)."""
    p, c, cell = _rows_box(dev, (20, 20, 20), 3.8)
    grid = grid_shape(cell, 5.6)

    def build():
        return build_sorted_neighbor_list(p, c, 5.6, max_neighbors=64, grid=grid)

    build()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        build()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == "nl.sort"]
    assert len(spans) == 1
    lo, hi = spans[0]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {}) and lo <= e["ts"] < hi}
    ops = [e for e in events if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
           and e.get("args", {}).get("correlation") in launched]
    names = [e["name"] for e in ops]
    assert len(ops) <= 6, names
    assert sum(e["cat"] == "kernel" and "cell_list_" in e["name"] for e in ops) == 4, names
    assert sum(e["cat"] == "gpu_memset" for e in ops) == 1, names
    assert not any("sort" in n.lower() for n in names), names


def test_cell_list_refuses_bad_operands(dev):
    p, c, cell = _rows_box(dev, (6, 6, 6))
    grid = grid_shape(cell, 5.6)
    real = torch.ones(len(p), dtype=torch.bool, device=dev)
    args = (p, c, 5.6, grid, None, real)
    launches = nbm.K11.launches
    for i, bad in ((0, p.half()), (1, c.double()), (5, real.int())):
        with pytest.raises(TypeError):
            nbm.cell_list(*args[:i], bad, *args[i + 1:], sort=True)
    for i, bad in ((0, p.T.contiguous().T), (0, p[:, :2].contiguous()), (1, c.T),
                   (1, c.cpu()), (5, real[:-1]), (3, (4, 4)), (3, (0, 4, 4))):
        with pytest.raises(ValueError):
            nbm.cell_list(*args[:i], bad, *args[i + 1:], sort=True)
    assert nbm.K11.launches == launches


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


# K9's modes: (kick, drift, count the step); dt 1 fs as the cells run it
_DT = 0.001
_MD_MODES = {"kick": (True, None, False), "kick and step": (True, None, True),
             "kick and drift": (True, _DT, False), "drift": (False, _DT, False),
             "kick, drift and step": (True, 0.5 * _DT, True)}


def _md_arrays(dev, n, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64).to(dtype).to(dev)

    masses = (20.0 + 100.0 * torch.rand(n, generator=g, dtype=torch.float64)).to(dtype).to(dev)
    step = torch.tensor(41, dtype=torch.int64, device=dev)
    return 40.0 * r(n, 3), 5.0 * r(n, 3), r(n, 3), masses, step


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [32000, 131072])
def test_md_step_kernel_is_bit_equal_to_plain(dev, n, dtype):
    """K9 in each mode against its plain twin on the card: positions,
    velocities and step bit for bit; the inputs left as they were."""
    from mtp_tpu_torch.utils import units

    x, v, f, m, step = _md_arrays(dev, n, dtype)
    keep = [t.clone() for t in (x, v, f, m, step)]
    for mode, (kick, drift, count) in _MD_MODES.items():
        kw = dict(kick=0.5 * _DT * units.FTM2A if kick else None, drift=drift)
        st = step if count else None
        launches = ms.K9.launches
        got = ms.md_step(x, v, f, m, st, **kw)
        want = ms.md_step_plain(x, v, f, m, st, **kw)
        torch.cuda.synchronize()
        assert ms.K9.launches == launches + 1, mode
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b), mode
        if drift is None:
            assert got[0] is x, mode
        if not kick:
            assert got[1] is v, mode
        assert all(torch.equal(a, b) for a, b in zip((x, v, f, m, step), keep)), mode


def _top2_cases(dev, dtype):
    """{case: (positions, reference, real, flag before)} for K10."""
    g = torch.Generator(device="cpu").manual_seed(3)

    def box(n):
        ref = 30.0 * torch.rand(n, 3, generator=g, dtype=torch.float64)
        d = 0.05 * torch.randn(n, 3, generator=g, dtype=torch.float64)
        return (ref + d).to(dtype).to(dev), ref.to(dtype).to(dev)

    out = {}
    x, ref = box(32000)
    out["random"] = (x, ref, None, False)
    out["random, flag set"] = (x, ref, None, True)
    x, ref = box(131072)
    out["random 131k"] = (x, ref, None, False)
    xt, rt = x.clone(), ref.clone()
    rt[[5, 90000]] = 7.0  # the same operands: a tie for the largest
    xt[[5, 90000]] = 7.3
    out["tie"] = (xt, rt, None, False)
    x1, r1 = box(1)
    out["one row"] = (x1, r1, None, False)
    x2, r2 = box(1000)  # not a multiple of the block
    out["1000 rows"] = (x2, r2, None, False)
    real = torch.rand(32000, generator=g) < 0.7
    xr = out["random"][0].clone()
    xr[~real.to(dev)] += 25.0  # trash rows far off: only the mask keeps them out
    out["real"] = (xr, out["random"][1], real.to(dev), False)
    xn = out["random"][0].clone()
    xn[7, 1] = float("nan")
    out["one NaN"] = (xn, out["random"][1], None, False)
    xn2 = xn.clone()
    xn2[31000, 0] = float("nan")
    out["two NaN"] = (xn2, out["random"][1], None, False)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_verlet_top2_kernel_matches_plain(dev, dtype):
    """K10 against its plain twin on the card: m1 and m2 bit-equal (NaN where
    the twin's is NaN), and the flag equal, with and without a shrink term
    and at skins either side of the displacements' sum, and set flags stay
    set."""
    shrink = torch.tensor(0.0125, dtype=dtype, device=dev)
    for case, (x, ref, real, before) in _top2_cases(dev, dtype).items():
        got = ms.verlet_top2(x, ref, real)
        want = ms.verlet_top2_plain(x, ref, real)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), case
        assert torch.equal(got[~nan], want[~nan]), case
        if nan[0]:
            skins = [0.1, 10.0]
        else:
            s = float(torch.sqrt(want[0]) + torch.sqrt(want[1]))
            skins = [s * (1 - 1e-3), s * (1 + 1e-3), s - 0.0125, s]
        for sk in skins:
            for sh in (None, shrink):
                flags = []
                for check in (ms.verlet_check, ms.verlet_check_plain):
                    flag = torch.tensor(before, device=dev)
                    check(x, ref, sk, flag, sh, real)
                    flags.append(bool(flag))
                assert flags[0] == flags[1], (case, sk, sh)
                assert flags[0] or not before, (case, sk, sh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_verlet_check_at_the_skin_by_ulps(dev, dtype):
    """Displacements placed so that sqrt(m1) + sqrt(m2) lands a few ulp
    either side of the skin: the kernel's flag is the twin's at every one."""
    n, skin = 32000, 0.6
    ref = torch.zeros(n, 3, dtype=dtype, device=dev)
    x = ref.clone()
    x[:, 0] = torch.linspace(0.0, 0.1, n, dtype=dtype, device=dev)
    half = torch.tensor(skin / 2, dtype=dtype)
    for k in range(-4, 5):
        a = half
        for _ in range(abs(k)):
            a = torch.nextafter(a, torch.tensor(float("inf") if k > 0 else 0.0, dtype=dtype))
        xs = x.clone()
        xs[[17, 20000], 0] = a.to(dev)
        flags = []
        for check in (ms.verlet_check, ms.verlet_check_plain):
            flag = torch.zeros((), dtype=torch.bool, device=dev)
            check(xs, ref, skin, flag)
            flags.append(bool(flag))
        torch.cuda.synchronize()
        assert flags[0] == flags[1], k
        assert flags[0] == (k > 0) or k == 0, k


def test_verlet_top2_relaunches_back_to_back(dev):
    """1,000 launches back to back on one stream: the ticket resets after
    each, so every launch finds the same top two."""
    x, ref, _, _ = _top2_cases(dev, torch.float32)["random 131k"]
    want = ms.verlet_top2_plain(x, ref)
    outs = [ms.verlet_top2(x, ref) for _ in range(1000)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def test_md_step_wrappers_raise_instead_of_falling_back(dev):
    x, v, f, m, step = _md_arrays(dev, 100, torch.float32)
    with pytest.raises(TypeError):
        ms.md_step(x, v, f, m.double(), kick=1.0)
    with pytest.raises(TypeError):
        ms.md_step(x, v, f, m, step.int(), kick=1.0)
    with pytest.raises(ValueError):
        ms.md_step(x.T.contiguous().T, v, f, m, kick=1.0)
    with pytest.raises(ValueError):
        ms.md_step(x, v, f, m)
    with pytest.raises(ValueError):
        ms.md_step(x, v.cpu(), f, m, kick=1.0)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        ms.verlet_check(x, v.double(), 0.6, flag)
    with pytest.raises(TypeError):
        ms.verlet_check(x, v, 0.6, flag.int())
    with pytest.raises(ValueError):
        ms.verlet_check(x, v[:-1], 0.6, flag)
    with pytest.raises(ValueError):
        ms.verlet_check(x, v, 0.6, flag.cpu())
    with pytest.raises(ValueError):
        ms.verlet_top2(x[:0], v[:0])


def test_nve_step_and_check_launch_only_their_kernels(dev):
    """On the card a velocity-Verlet step around a force call launches K9
    twice and nothing else, and the Verlet check K10 once and nothing else:
    no torch elementwise or reduction kernel is left in either."""
    from mtp_tpu_torch.md import integrators as itg

    x, v, f, m, step = _md_arrays(dev, 32000, torch.float32)
    st = init_state(x.cpu().numpy(), np.zeros(32000, dtype=np.int32), m.cpu().numpy(),
                    np.eye(3) * 200.0, velocities=v.cpu().numpy(), device=dev)
    pe, vir = torch.zeros((), device=dev), torch.zeros(6, device=dev)

    def force(positions, types, cell):  # the forces of the step, already on the card
        return f, pe, vir

    flag = torch.zeros((), dtype=torch.bool, device=dev)
    itg.nve_step(st, force, _DT)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for fn, kernel, count in (
            (lambda: itg.nve_step(st, force, _DT), "md_step_kernel", 2),
            (lambda: ms.verlet_check(x, st.positions, 0.6, flag), "verlet_top2_kernel", 1)):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == count and all(kernel in name for name in names), names


def test_simulation_run_block_launches_k9_and_k10(dev):
    """One `Simulation.run` block of 15 NVE steps at 32,000 atoms launches
    K9 30 times and K10 15 times, and neither twin."""
    model = MTPModel.from_data(make_mtp(8, seed=0), device=dev, dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (20, 20, 20))
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, device=dev)
    st = thermalize(torch.Generator(device=dev).manual_seed(0), st, 300.0)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=15,
                     compute_virial=False)
    before = [(k.launches, k.plain_calls) for k in (ms.K9, ms.K10)]
    out, _ = sim.run(st, 15, dt=_DT)
    torch.cuda.synchronize()
    assert int(out.step) == int(st.step) + 15 and sim.steps_per_rebuild == 15
    assert ms.K9.launches - before[0][0] == 30 and ms.K9.plain_calls == before[0][1]
    assert ms.K10.launches - before[1][0] == 15 and ms.K10.plain_calls == before[1][1]


def _rel(a, b):
    return _err(a, b) / float(b.double().abs().max())


@pytest.mark.parametrize("level,species", [(8, 1), (8, 2), (16, 2), (16, 1)])
def test_candidates_kernel_matches_plain(dev, level, species):
    """K5 on its specialised double stages (levels 8 and 16) against its
    float64 twin; its site energies and pair forces are K4's and K2's."""
    model, pos_s, c, _, swl, k = _case(dev, level, species)
    assert fm.resident_warps(model.tables, swl.idx.shape[1])["K5 specialised"] == 1
    args = _inputs(model, pos_s, c, swl, k)
    got = fc.candidates_mega(*args, k["esp"])
    want = fc.candidates_mega_plain(*args, k["esp"])
    torch.cuda.synchronize()
    for key in got:
        assert bool(got[key].isfinite().all()), key
        assert got[key].shape == want[key].shape, key
    assert _err(got["site_e"], want["site_e"]) < 1e-5
    assert _err(got["pair_tT"], want["pair_tT"]) < 5e-5
    assert _rel(got["basis_members"], want["basis_members"]) < K5_REL
    assert _rel(got["rad"], want["rad"]) < K5_REL
    # the grade step's pair forces and energies are the MD kernels' own
    assert _err(got["pair_tT"], fm.pair_forces_mega(*args)) < 1e-6
    assert _err(got["site_e"], fm.site_energies_mega(*args, k["esp"])) < 1e-6


@pytest.mark.parametrize("level", [8, 16])
def test_candidates_kernel_is_deterministic(dev, level):
    """No atomics: two launches of K5's specialised stages on the same
    inputs agree bit for bit."""
    model, pos_s, c, _, swl, k = _case(dev, level, 2)
    args = _inputs(model, pos_s, c, swl, k)
    a = fc.candidates_mega(*args, k["esp"])
    b = fc.candidates_mega(*args, k["esp"])
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("level,rb,stage", [(8, 8, "cand_kernel"), (16, 8, "cand_kernel"),
                                             (12, 10, "pair_kernel")])
def test_candidates_kernel_runs_its_stages(dev, level, rb, stage):
    """K5 launches its specialised double pair stages (cand_kernel) for the
    schedules of levels 8 and 16, and the General ones (pair_kernel in
    double) for level 12 with 10 Chebyshev functions; the DAG stage is
    dag_kernel in double either way (kernel names from the profiler)."""
    model, pos_s, c, _, swl, k = _case(dev, level, 2, radial_basis_size=rb)
    warps = fm.resident_warps(model.tables, swl.idx.shape[1])
    assert warps["K5 specialised"] == (stage == "cand_kernel")
    args = _inputs(model, pos_s, c, swl, k)
    fc.candidates_mega(*args, k["esp"])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fc.candidates_mega(*args, k["esp"])
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "_kernel<" in e.key]
    pair = [nm for nm in names if "pair_kernel<" in nm or "cand_kernel<" in nm]
    assert len(pair) == 2 and all(stage + "<" in nm for nm in pair), names
    if stage == "pair_kernel":
        assert all("General" in nm and "double>" in nm for nm in pair), names
    assert [nm for nm in names if "dag_kernel<2, " in nm and "double>" in nm], names


def test_basic_moments_kernels_match_plain(dev):
    """K6 against its twin; K7 through the autograd backward of the modular
    energy path, against the plain twin's gradient."""
    model, pos_s, c, _, swl, k = _case(dev, 16, 2)
    args = _inputs(model, pos_s, c, swl, k)
    mb = fb.basic_moments_fused(*args[:6])
    assert _rel(mb, fb.basic_moments_fused_plain(*args[:6])) < 1e-5
    d = args[1].clone().requires_grad_(True)
    launches = fb.K7.launches
    e = fb.site_energies_fused(model.tables, model.coeffs, d, *args[2:5])
    (g,) = torch.autograd.grad(e.sum(), d)
    assert fb.K7.launches == launches + 1
    assert _err(e.detach(), fm.site_energies_mega(*args, k["esp"])) < 1e-5
    assert _err(g, fm.pair_forces_mega_plain(*args)) < 5e-5
    gamma = torch.rand((model.schedule.basic_count, pos_s.shape[0]), device=dev)
    direct = fb.basic_moments_vjp_plain(*args[:6], gamma)
    (g2,) = torch.autograd.grad(fb.basic_moments_fused(args[0], d, *args[2:6]), d, gamma)
    assert _rel(g2, direct) < 1e-5


def test_al_wrappers_refuse_bad_operands(dev):
    model, pos_s, c, _, swl, k = _case(dev, 8, 2)
    args = _inputs(model, pos_s, c, swl, k)
    n = pos_s.shape[0]
    with pytest.raises(ValueError):
        fc.candidates_mega(args[0], args[1].double(), *args[2:], k["esp"])
    with pytest.raises(ValueError):
        fc.candidates_mega(*args, k["esp"][:-1])
    with pytest.raises(ValueError):
        fb.basic_moments_fused(args[0], args[1], args[2][:, :-1].contiguous(), *args[3:6])
    with pytest.raises(ValueError):
        fb.basic_moments_fused(args[0], args[1], args[2], args[3][: n - 1], *args[4:6])


def _alloy(dev):
    """The 864-atom two-species level-16 box at 300 K, fp32, with masses."""
    m = make_mtp(16, species_count=2, seed=1)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6), type_pattern=(0, 1))
    masses = np.where(types == 0, 58.693, 26.98)
    st = init_state(pos, types, masses, cell, device=dev)
    st = thermalize(torch.Generator(device=dev).manual_seed(0), st, 300.0)
    return m, st


def test_npt_block_matches_its_plain_twin(dev):
    """20 NPT steps (one block) on the card, through K1-K4, against the same
    block on the CPU, where every wrapper runs its plain twin."""
    m, st = _alloy(dev)
    kw = dict(ensemble="npt", dt=0.001, temperature=300.0, pressure=0.0, tdamp=0.1, pdamp=1.0)
    out = {}
    for where in (dev, torch.device("cpu")):
        model = MTPModel.from_data(m, device=where, dtype=torch.float32)
        sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=20)
        ks = main_path_kernels()
        before = [(kk.launches, kk.plain_calls) for kk in ks]
        s0 = init_state(*(getattr(st, k).cpu().numpy() for k in ("positions", "types", "masses",
                                                               "cell")),
                        velocities=st.velocities.cpu().numpy(), device=where)
        s1, aux, fl = sim.run_async(s0, 20, **kw)
        assert not bool(fl)
        if where.type == "cuda":
            for kk, (l0, p0) in zip(ks, before):
                assert kk.launches > l0 and kk.plain_calls == p0, kk.name
        out[where.type] = (s1, aux)
    (a, aux_a), (b, aux_b) = out["cuda"], out["cpu"]
    assert _err(a.positions.cpu(), b.positions) < 1e-4
    assert _err(a.cell.cpu(), b.cell) / float(b.cell.abs().max()) < 1e-5
    assert abs(float(aux_a.baro_v) - float(aux_b.baro_v)) < 1e-3 * abs(float(aux_b.baro_v))


@pytest.mark.parametrize("ensemble", ["nve", "nvt", "langevin", "npt", "npt-aniso", "npt-tri"])
def test_ensemble_block_reads_nothing_back(dev, ensemble):
    """A block of every ensemble (`Simulation.steps`) runs under
    ``set_sync_debug_mode("error")``: no step reads the device from the
    host."""
    m, st = _alloy(dev)
    model = MTPModel.from_data(m, device=dev, dtype=torch.float32)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10)
    nl = sim.rebuild(st, grid=sim.grid_for(st.cell), max_neighbors=64)
    st = sim.refresh_forces(st, nl, ensemble=ensemble)
    aux = _default_aux(ensemble, st)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux, stale = sim.steps(st, aux, nl, ensemble=ensemble, n_steps=5, dt=0.001)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not bool(stale) and int(out.step) == int(st.step) + 5
    assert bool(out.positions.isfinite().all())


def _f64_plain_outputs(dev):
    """The float64 plain path's outputs on the phase-3 box of chip_smoke.py
    (864 atoms, level 16, two species): energy, site energies, forces,
    virial and candidate vectors."""
    from mtp_tpu_torch.al.grades import candidate_vectors
    from mtp_tpu_torch.models.mtp import mtp_energy_forces
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list

    m = make_mtp(16, species_count=2, seed=0)
    model = MTPModel.from_data(m, device=dev, dtype=torch.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6), type_pattern=(0, 1))
    pos = pos + np.random.default_rng(0).normal(0.0, 0.1, pos.shape)
    p = torch.as_tensor(pos, dtype=torch.float64, device=dev)
    c = torch.as_tensor(cell, dtype=torch.float64, device=dev)
    t = torch.as_tensor(types, dtype=torch.int32, device=dev)
    nl = build_neighbor_list(p, c, model.cutoff + 0.6, max_neighbors=64,
                             grid=grid_shape(cell, model.cutoff + 0.6))
    out = mtp_energy_forces(model, p, t, nl.idx, c, nl.mirror)
    b, _ = candidate_vectors(model, p, t, nl.idx, c)
    torch.cuda.synchronize()
    return dict(out, b=b)


def test_f64_plain_path_repeats_bit_for_bit(dev):
    """The oracle repeats: two runs bit-equal in every output, and equal to
    a run under ``torch.use_deterministic_algorithms`` (which swaps any op
    with a nondeterministic CUDA default for its deterministic version)."""
    a, b = _f64_plain_outputs(dev), _f64_plain_outputs(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        d = _f64_plain_outputs(dev)
    finally:
        torch.use_deterministic_algorithms(False)
    for k in ("energy", "site_energies", "forces", "virial", "b"):
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], d[k]), k


def test_fit_steps_on_the_card_match_the_cpu(dev):
    """Two Adam steps (level 8, 6 configurations of the 108-atom box labeled
    by a level-8 teacher, float64, lr 1e-4 from the minted student) twice on
    the card and once on the CPU: the card's two runs bit-equal, the CPU's
    losses and coefficients within 1e-9 relative; no kernel launched during
    the fit."""
    from mtp_tpu_torch.kernels import all_kernels
    from mtp_tpu_torch.train.fit import fit, make_dataset, training_set

    teacher = MTPModel.from_data(make_mtp(8, seed=11), device="cpu", dtype=torch.float64)
    student = make_mtp(8, seed=99)
    configs = training_set(teacher, 6)
    runs = []
    for where in (dev, dev, torch.device("cpu")):
        model = MTPModel.from_data(student, device=where, dtype=torch.float64)
        data = make_dataset(configs, student.max_dist, max_neighbors=48, device=where)
        before = [(k.launches, k.plain_calls) for k in all_kernels()]
        runs.append(fit(model.schedule, model.coeffs, data, steps=2, learning_rate=1e-4,
                        force_weight=0.1, warm_start=False))
        assert [(k.launches, k.plain_calls) for k in all_kernels()] == before
    (cg, lg), (cg2, lg2), (cc, lc) = runs
    # the training gradients repeat on the card too
    assert np.array_equal(lg, lg2)
    assert all(torch.equal(getattr(cg, n), getattr(cg2, n))
               for n in ("radial_coeffs", "species_coeffs", "moment_coeffs"))
    assert np.abs(lg - lc).max() <= 1e-9 * np.abs(lc).max()
    for name in ("radial_coeffs", "species_coeffs", "moment_coeffs"):
        want = getattr(cc, name)
        assert getattr(cg, name).device.type == "cuda"
        assert _err(getattr(cg, name).cpu(), want) <= 1e-9 * float(want.abs().max()), name


# ------------------------------------------------------------- sharded path


def _sharded_inputs(dev, level=16, species=2):
    """A rank's halo-extended set in miniature: the 864-atom jittered box
    with 96 padding rows appended (not real: the trash bin, no neighbors)
    and the last 200 real rows as ghosts (real, but masked as centers), so N
    = 960 is no box's atom count."""
    m = make_mtp(level, species_count=species, seed=1)
    model = MTPModel.from_data(m, device=dev, dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6), type_pattern=tuple(range(species)))
    pos = pos + np.random.default_rng(level).normal(0, 0.1, pos.shape)
    n_real, n_pad, n_ghost = len(pos), 96, 200
    pos = np.concatenate([pos, np.zeros((n_pad, 3))])
    types = np.concatenate([types, np.zeros(n_pad, types.dtype)])
    real = torch.arange(n_real + n_pad, device=dev) < n_real
    own = torch.arange(n_real + n_pad, device=dev) < n_real - n_ghost
    p = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    c = torch.as_tensor(cell, dtype=torch.float32, device=dev)
    ty = torch.as_tensor(types, dtype=torch.int32, device=dev)
    cut = model.cutoff + 0.6
    swl = build_sorted_neighbor_list(p, c, cut, max_neighbors=64, grid=grid_shape(cell, cut),
                                     real=real)
    assert not bool(swl.overflow)
    k = window_constants(model, ty, swl, center_mask=own)
    return model, p[swl.order].contiguous(), c, swl, k, own[swl.order], real[swl.order]


def test_kernels_on_sharded_inputs_match_plain(dev):
    """K1-K5 on a sharded rank's rows (padding rows with no neighbors, ghost
    rows with every slot masked, N = C + 2H) against their plain twins on
    the same inputs; masked rows give zero site energy (their species
    energy is zeroed) and zero pair forces, and K3 still fills ghost rows."""
    model, pos_s, c, swl, k, own_s, real_s = _sharded_inputs(dev)
    disp, mask = wd.window_geometry(pos_s, k["idx_t"], c, k["pair_valid_t"], model.cutoff)
    disp_p, mask_p = wd.window_geometry_plain(pos_s, k["idx_t"], c, k["pair_valid_t"],
                                              model.cutoff)
    assert torch.equal(disp, disp_p) and torch.equal(mask, mask_p)
    assert float(mask[:, ~own_s].abs().max()) == 0.0
    args = (model.tables, disp, mask, k["it_row"], k["jtypes_t"], model.coeffs.radial_coeffs,
            k["xi_full"])
    pair = fm.pair_forces_mega(*args)
    pair_p = fm.pair_forces_mega_plain(*args)
    assert _err(pair, pair_p) < 5e-5
    assert float(pair[:, :, ~own_s].abs().max()) == 0.0
    site = fm.site_energies_mega(*args, k["esp"])
    site_p = fm.site_energies_mega_plain(*args, k["esp"])
    assert _err(site, site_p) < 1e-5 and float(site[~own_s].abs().max()) == 0.0
    f = wg.window_giveback(pair, k["mirror_t"])
    f_p = wg.window_giveback_plain(pair, k["mirror_t"])
    assert _err(f, f_p) < 1e-5
    ghost = real_s & ~own_s
    assert float(f[ghost].abs().max()) > 0.0 and float(f[~real_s].abs().max()) == 0.0
    out = fc.candidates_mega(*args, k["esp"])
    out_p = fc.candidates_mega_plain(*args, k["esp"])
    for name in ("site_e", "pair_tT"):
        assert _err(out[name], out_p[name]) < 5e-5, name
    for name in ("basis_members", "rad"):
        assert _rel(out[name], out_p[name]) < K5_REL, name


@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    """A world of one NCCL rank for this module (one process group per
    process), destroyed at the end."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit (runs on the card)")
    import torch.distributed as dist

    from mtp_tpu_torch.parallel.comm import Comm, init_world

    torch.cuda.set_device(0)
    init_world(0, 1, str(tmp_path_factory.mktemp("nccl") / "store"), backend="nccl")
    yield Comm()
    dist.destroy_process_group()


def _sharded_alloy(dev, comm, **kw):
    from mtp_tpu_torch.parallel.domain import partition_slabs
    from mtp_tpu_torch.parallel.sharded_md import ShardedState
    from mtp_tpu_torch.parallel.sharded_window import ShardedSimulation

    m, st = _alloy(dev)
    model = MTPModel.from_data(m, device=dev, dtype=torch.float32)
    cell = st.cell.cpu().numpy()
    part = partition_slabs(*(getattr(st, a).cpu().numpy() for a in (
        "positions", "velocities", "types", "masses")), cell, 1, cutoff=model.cutoff + 0.6)
    ss = ShardedState.from_partition(part, cell, 0, device=dev)
    sim = ShardedSimulation(model, comm, capacity=part.capacity, max_neighbors=64,
                            grid=grid_shape(cell, model.cutoff + 0.6), skin=0.6,
                            steps_per_rebuild=10, **kw)
    return sim, ss


@pytest.mark.parametrize("ensemble", ["nve", "nvt", "npt", "npt-tri"])
def test_sharded_block_reads_nothing_back(dev, nccl_world, ensemble):
    """A world of one NCCL rank: a ShardedSimulation block (steps, its
    reductions through NCCL) runs under ``set_sync_debug_mode("error")``."""
    assert nccl_world.transport == "nccl"
    sim, ss = _sharded_alloy(dev, nccl_world)
    st, ctx, f4 = sim.rebuild(ss)
    st, _ = sim.steps(st, ctx, 1, ensemble=ensemble, refresh=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, stale = sim.steps(st, ctx, 5, ensemble=ensemble)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not bool(torch.stack([*f4, stale]).any())
    assert bool(out.positions.isfinite().all())


def test_sharded_run_repeats_bit_for_bit(dev, nccl_world):
    """Two run_async calls from one state on a world of one NCCL rank:
    positions, forces, energy and flags bit-equal (every sum in a fixed
    order, the give-back's index_add over unique rows)."""
    sim, ss = _sharded_alloy(dev, nccl_world, compute_virial=True)
    a, fa = sim.run_async(ss, 20, ensemble="nvt", temperature=300.0)
    b, fb = sim.run_async(ss, 20, ensemble="nvt", temperature=300.0)
    assert not bool(fa.any()) and not bool(fb.any())
    for name in ("positions", "velocities", "forces", "potential_energy", "virial", "thermo"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_four_cards_match_single_device(dev, tmp_path):
    """The 32,000-atom box on 2x2 bricks, one NCCL rank per card (ring
    shifts between cards, the two-hop halo and give-back, migration), 60
    NVE steps through K1-K4, against the single-device run from the same
    state on the first card: max|dx| < 1e-4 A, max|dF| < 5e-4 eV/A (phase
    3's force gate), dE/atom < 1e-6 eV. Needs four cards; skips on fewer."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (one NCCL rank per card)")
    m = make_mtp(16, species_count=1, seed=0)
    model = MTPModel.from_data(m, device=dev, dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (20, 20, 20))
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, device=dev)
    st = thermalize(torch.Generator(device=dev).manual_seed(0), st, 300.0)
    st, _, fl = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                           compute_virial=False).run_async(st, 60)
    assert not bool(fl)
    box = {k: getattr(st, a).cpu().numpy() for k, a in (
        ("pos", "positions"), ("vel", "velocities"), ("types", "types"), ("masses", "masses"),
        ("cell", "cell"))}
    world = World("_torch_parallel_ranks:brick_run", 4, tmp_path, timeout=240.0,
                  backend="nccl", box=box, n_steps=60)
    try:
        ref, _, fl = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                                compute_virial=False).run_async(st, 60)
        ranks = world.results()
    finally:
        world.kill()
    assert not bool(fl)
    r0 = ranks[0]
    print(f"4 cards, 2x2 bricks: C={r0['capacity']} H={r0['halo']} rows {r0['rows']}; "
          f"ms per step {[round(r['ms_per_step'], 3) for r in ranks]}")
    for r in ranks:
        assert r["transport"] == "nccl" and not r["flags"]
        for name, (launched, plain) in r["launches"].items():
            assert launched > 0 and plain == 0, name
    dx = float(np.abs(r0["positions"] - ref.positions.cpu().numpy()).max())
    df = float(np.abs(r0["forces"] - ref.forces.cpu().numpy()).max())
    de = abs(r0["energy"] - float(ref.potential_energy)) / len(pos)
    print(f"vs single device after 60 steps: max|dx|={dx:.3e} max|dF|={df:.3e} dE/atom={de:.3e}")
    assert dx < 1e-4 and df < 5e-4 and de < 1e-6


def _long_box(dev):
    """The long narrow box of ``chip_smoke.py`` phase 12: level 16, fcc
    500 x 4 x 4 cells (32,000 atoms, 2,000 x 16 x 16 A), 300 K, fp32; its
    grid at cutoff + skin is (357, 2, 2)."""
    model = MTPModel.from_data(make_mtp(16, species_count=1, seed=0), device=dev,
                               dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (500, 4, 4))
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, device=dev)
    st = thermalize(torch.Generator(device=dev).manual_seed(0), st, 300.0)
    return model, st


@pytest.mark.parametrize("ensemble", ["nve", "nvt"])
def test_long_box_on_one_rank_matches_single_device(dev, nccl_world, ensemble):
    """The long box on a world of one NCCL rank through the row-gather API
    (``make_sharded_md_block``, 3 blocks of 10 steps from the fresh 300 K
    lattice), against the single-device ``Simulation.run_async`` in three
    calls of 10 (each call refreshes its forces on its new list, as each
    block does): NVE bit for
    bit; NVT to 5e-4 eV/A and each coordinate to the larger of 1e-4 A and
    one fp32 spacing of the reference coordinate (1.221e-04 A above 1,024
    A; its thermostat sums the kinetic energy in slot order, the
    single-device step in bin-sorted order). A block
    reads nothing back (``set_sync_debug_mode("error")``)."""
    from mtp_tpu_torch.parallel.domain import partition_slabs
    from mtp_tpu_torch.parallel.sharded_md import ShardedState, make_sharded_md_block

    model, st = _long_box(dev)
    cell = st.cell.cpu().numpy()
    n = st.n_atoms
    kw = dict(ensemble=ensemble, temperature=300.0, tdamp=0.1)
    part = partition_slabs(*(getattr(st, a).cpu().numpy() for a in (
        "positions", "velocities", "types", "masses")), cell, 1, cutoff=model.cutoff + 0.6,
        capacity=n)
    block = make_sharded_md_block(model, nccl_world, capacity=n, max_neighbors=64,
                                  grid=grid_shape(cell, model.cutoff + 0.6), skin=0.6,
                                  n_steps=10, **kw)
    assert block.sim.grid == (357, 2, 2)
    ss = ShardedState.from_partition(part, cell, 0, device=dev)
    flags = []
    for k in range(3):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if k == 2 else 0)
        try:
            ss, f = block(ss)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        flags.append(f.any())
    one = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                     compute_virial=False)
    ref, aux = st, None
    for _ in range(3):
        ref, aux, g = one.run_async(ref, 10, aux=aux, **kw)
        flags += [g.overflow, g.stale]
    assert not bool(torch.stack(flags).any())
    if ensemble == "nve":
        for name in ("positions", "velocities", "forces", "potential_energy"):
            assert torch.equal(getattr(ss, name), getattr(ref, name)), name
    else:
        ulp = torch.nextafter(ref.positions, torch.full_like(ref.positions, float("inf")))
        limit = torch.clamp(ulp - ref.positions, min=1e-4)
        assert bool(((ss.positions - ref.positions).abs() <= limit).all())
        assert float((ss.forces - ref.forces).abs().max()) < 5e-4


def test_four_cards_long_box_match_single_device(dev, tmp_path):
    """The long box as 4 slabs along x, one NCCL rank per card, 6 blocks of
    10 NVE steps of ``make_sharded_md_block`` through K1-K4, against the
    single-device run from the same state on the first card: max|dx| <
    1e-4 A, max|dF| < 5e-4 eV/A, dE/atom < 1e-6 eV. Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (one NCCL rank per card)")
    model, st = _long_box(dev)
    box = {k: getattr(st, a).cpu().numpy() for k, a in (
        ("pos", "positions"), ("vel", "velocities"), ("types", "types"), ("masses", "masses"),
        ("cell", "cell"))}
    world = World("_torch_parallel_ranks:narrow_run", 4, tmp_path, timeout=240.0,
                  backend="nccl", box=box, blocks=6, n_steps=10)
    try:
        one = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                         compute_virial=False)
        ref, flags = st, []
        for _ in range(6):
            ref, _, f = one.run_async(ref, 10)
            flags.append(bool(f))
        ranks = world.results()
    finally:
        world.kill()
    assert not any(flags)
    r0 = ranks[0]
    print(f"4 cards, long box as 4 slabs: grid {r0['grid']} C={r0['capacity']} H={r0['halo']}; "
          f"ms per step {[round(r['ms_per_step'], 3) for r in ranks]}")
    for r in ranks:
        assert r["transport"] == "nccl" and not r["flags"]
        for name, (launched, plain) in r["launches"].items():
            assert launched > 0 and plain == 0, name
    dx = float(np.abs(r0["positions"] - ref.positions.cpu().numpy()).max())
    df = float(np.abs(r0["forces"] - ref.forces.cpu().numpy()).max())
    de = abs(r0["energy"] - float(ref.potential_energy)) / st.n_atoms
    print(f"vs single device after 60 steps: max|dx|={dx:.3e} max|dF|={df:.3e} dE/atom={de:.3e}")
    assert dx < 1e-4 and df < 5e-4 and de < 1e-6
