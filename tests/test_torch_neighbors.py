"""The port's cell-list neighbor engine against mtp_tpu's: the same neighbor
set on every row, the same overflow flags, and a valid mirror permutation.
Neighbor sets are integer data, so they must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.md.simulation import make_lattice
from mtp_tpu.ops.neighbors import build_neighbor_list as bnl_jax
from mtp_tpu.ops.neighbors import build_sorted_neighbor_list as bsnl_jax
from mtp_tpu.ops.neighbors import grid_shape as grid_jax
from mtp_tpu_torch.ops import neighbors as nbm
from mtp_tpu_torch.ops.neighbors import (
    build_neighbor_list,
    build_sorted_neighbor_list,
    check_cell,
    grid_shape,
    mirror_permutation,
    needs_rebuild,
)
from mtp_tpu_torch.ops.window_disp import inverse_cell

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)

CUT = 5.6


def _box(reps=(6, 6, 6), sigma=0.12, seed=0, tilt=0.0):
    pos, _, cell = make_lattice("fcc", 4.0, reps)
    cell = cell.copy()
    cell[1, 0] = tilt * cell[0, 0]  # triclinic when tilt != 0
    rng = np.random.default_rng(seed)
    frac = pos @ np.linalg.inv(np.diag(np.diag(cell)))
    pos = frac @ cell + rng.normal(0, sigma, pos.shape)
    return pos, cell


def _rows(idx, n=None):
    idx = np.asarray(idx)[:n]
    return [set(r[r != i].tolist()) for i, r in enumerate(idx)]


@pytest.mark.parametrize("tilt", [0.0, 0.2], ids=["orthorhombic", "triclinic"])
def test_same_neighbor_sets_as_jax(tilt):
    pos, cell = _box(tilt=tilt)
    grid = grid_shape(cell, CUT)
    assert grid == grid_jax(cell, CUT)
    nl = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), CUT,
                             max_neighbors=64, grid=grid)
    ref = bnl_jax(jnp.asarray(pos), jnp.asarray(cell), CUT, max_neighbors=64, grid=grid)
    assert not bool(nl.overflow) and not bool(ref.overflow)
    assert _rows(nl.idx) == _rows(ref.idx)
    assert nl.idx.dtype == torch.int32 and nl.idx.shape == (len(pos), 64)
    # rows ascending, padding entries are the row's own index
    idx = nl.idx.numpy()
    assert np.all(np.diff(idx, axis=1) >= 0)


def test_sorted_list_matches_jax():
    """Same bin order, and the same sorted-space rows as the JAX builder's
    align_slots=False branch (which pads N to a tile multiple)."""
    pos, cell = _box(seed=1)
    n = len(pos)
    grid = grid_shape(cell, CUT)
    swl = build_sorted_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), CUT,
                                     max_neighbors=64, grid=grid)
    ref = bsnl_jax(jnp.asarray(pos), jnp.asarray(cell), CUT, max_neighbors=64, grid=grid)
    assert not bool(swl.overflow) and not bool(ref.overflow)
    np.testing.assert_array_equal(swl.order.numpy(), np.asarray(ref.order))
    np.testing.assert_array_equal(swl.inv_order.numpy(), np.asarray(ref.inv_order))
    np.testing.assert_array_equal(swl.idx.numpy(), np.asarray(ref.idx)[:n])


def test_mirror_is_a_valid_involution():
    pos, cell = _box(seed=2)
    n = len(pos)
    grid = grid_shape(cell, CUT)
    swl = build_sorted_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), CUT,
                                     max_neighbors=64, grid=grid)
    idx = swl.idx.numpy()
    j = idx.shape[1]
    mir = swl.mirror.numpy().astype(np.int64)
    assert swl.mirror.dtype == torch.int32
    assert np.array_equal(np.sort(mir), np.arange(n * j))  # a permutation
    assert np.array_equal(mir[mir], np.arange(n * j))  # an involution
    src = np.repeat(np.arange(n), j)
    dst = idx.reshape(-1)
    # the mirror of (i -> k) is (k -> i); padding entries stay in their row
    assert np.array_equal(src[mir], dst)
    assert np.array_equal(dst[mir], src)
    # flat-mirror give-back == scatter-add give-back on random pair data
    rng = np.random.default_rng(0)
    real = idx != np.arange(n)[:, None]
    t = rng.normal(size=(n, j, 3)) * real[..., None]
    f_mirror = (t - t.reshape(-1, 3)[mir].reshape(t.shape)).sum(axis=1)
    f_scatter = t.sum(axis=1)
    np.subtract.at(f_scatter, dst, t.reshape(-1, 3))
    np.testing.assert_allclose(f_mirror, f_scatter, atol=1e-12)


def test_mirror_permutation_matches_jax_on_sorted_rows():
    from mtp_tpu.ops.neighbors import mirror_permutation as mp_jax

    pos, cell = _box(reps=(4, 4, 4), seed=3)
    nl = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), 3.0,
                             max_neighbors=24, grid=grid_shape(cell, 3.0))
    want = np.asarray(mp_jax(jnp.asarray(nl.idx.numpy())))
    np.testing.assert_array_equal(mirror_permutation(nl.idx).numpy(), want)


@pytest.mark.parametrize(
    "what", ["neighbors", "bin_capacity", "geometry", "clear"],
)
def test_overflow_flags_match_jax(what):
    pos, cell = _box(reps=(6, 6, 6), seed=4)
    grid = grid_shape(cell, CUT)
    kw = dict(max_neighbors=64, grid=grid)
    pos_t, cell_t = torch.as_tensor(pos), torch.as_tensor(cell)
    if what == "neighbors":
        kw["max_neighbors"] = 40  # fcc at 5.6 A has ~54 neighbors
    elif what == "bin_capacity":
        kw["bin_capacity"] = 4
    elif what == "geometry":
        cell = cell * 0.9  # the bin grid of the larger cell is now too fine
        pos = pos * 0.9
        pos_t, cell_t = torch.as_tensor(pos), torch.as_tensor(cell)
    nl = build_neighbor_list(pos_t, cell_t, CUT, **kw)
    ref = bnl_jax(jnp.asarray(pos), jnp.asarray(cell), CUT, **kw)
    assert bool(nl.overflow) == bool(ref.overflow) == (what != "clear")


def test_small_grid_uses_every_bin():
    """A box with fewer than 3 bins per side (every bin once) still finds
    every neighbor."""
    pos, cell = _box(reps=(3, 3, 3), seed=5)
    grid = grid_shape(cell, CUT)
    assert min(grid) < 3
    nl = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), CUT,
                             max_neighbors=64, grid=grid)
    ref = bnl_jax(jnp.asarray(pos), jnp.asarray(cell), CUT, max_neighbors=64, grid=grid)
    assert not bool(nl.overflow)
    assert _rows(nl.idx) == _rows(ref.idx)


def test_check_cell_and_needs_rebuild():
    pos, cell = _box(reps=(3, 3, 3), seed=6)
    check_cell(cell, 5.5)
    with pytest.raises(ValueError):
        check_cell(cell, 6.5)
    p = torch.as_tensor(pos)
    nl = build_neighbor_list(p, torch.as_tensor(cell), 5.5, max_neighbors=64,
                             grid=grid_shape(cell, 5.5))
    c = torch.as_tensor(cell)
    assert not bool(needs_rebuild(nl, p + 0.1, c, skin=0.5))
    moved = p.clone()
    moved[7, 0] += 0.3
    assert bool(needs_rebuild(nl, moved, c, skin=0.5))


def _bruteforce_counts(pos, cell, cutoff):
    inv = np.linalg.inv(cell)
    f = pos @ inv
    df = f[None] - f[:, None]
    df -= np.round(df)
    d = df @ cell
    d2 = np.einsum("ija,ija->ij", d, d)
    np.fill_diagonal(d2, np.inf)
    return (d2 <= cutoff * cutoff).sum(1)


def test_perpendicular_widths_are_plane_spacings():
    """Each width is the spacing of the lattice planes it bins across, V / |b x c|
    and its cyclic partners; and check_cell holds a sheared cell to them."""
    from mtp_tpu.ops.neighbors import check_cell as check_cell_jax
    from mtp_tpu_torch.ops.neighbors import perpendicular_widths

    cell = np.array([[18.0, 0, 0], [1.5, 18.0, 0], [0.5, -1.0, 18.0]])
    v = abs(np.linalg.det(cell))
    a, b, c = cell
    want = [v / np.linalg.norm(np.cross(b, c)), v / np.linalg.norm(np.cross(c, a)),
            v / np.linalg.norm(np.cross(a, b))]
    np.testing.assert_allclose(perpendicular_widths(cell), want, rtol=1e-14)
    # the narrowest spacing is 17.9285 A: a cutoff of 8.965 needs 17.93
    check_cell_jax(cell, 8.965)  # the JAX package's row norms give 17.9378
    with pytest.raises(ValueError, match="2\\*cutoff"):
        check_cell(cell, 8.965)


def test_sheared_cell_list_is_complete():
    """A 20 A fcc box sheared by 12 A: binning by the plane spacings keeps
    every pair within the cutoff. The JAX package bins by the inverse's row
    norms, gives this cell 4 bins along a (3 fit), and drops pairs without a
    flag."""
    pos0, _, cube = make_lattice("fcc", 4.0, (5, 5, 5))
    cell = cube.copy()
    cell[1, 0] = 12.0
    pos = pos0 @ np.linalg.inv(cube) @ cell + np.random.default_rng(0).normal(0, 0.1, pos0.shape)
    want = _bruteforce_counts(pos, cell, 5.0)
    assert grid_shape(cell, 5.0) == (3, 4, 4) and grid_jax(cell, 5.0) == (4, 3, 4)
    nl = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), 5.0,
                             max_neighbors=64, grid=grid_shape(cell, 5.0))
    assert not bool(nl.overflow)
    idx = nl.idx.numpy()
    np.testing.assert_array_equal((idx != np.arange(len(pos))[:, None]).sum(1), want)
    ref = bnl_jax(jnp.asarray(pos), jnp.asarray(cell), 5.0, max_neighbors=64,
                  grid=grid_jax(cell, 5.0))
    got_jax = (np.asarray(ref.idx) != np.arange(len(pos))[:, None]).sum(1)
    assert not bool(ref.overflow) and got_jax.sum() < want.sum()


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
def test_bruteforce_matches_jax(periodic):
    """The all-pairs list: the JAX builder's neighbor sets row by row, the
    same overflow flag, the cell list's rows, and a mirror that is an
    involution pairing (i, j) with (j, i)."""
    from mtp_tpu.ops.neighbors import build_neighbor_list_bruteforce as bf_jax
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce

    pos, cell = _box(reps=(3, 3, 3), seed=7, tilt=0.1)
    c = cell if periodic else None
    nl = build_neighbor_list_bruteforce(torch.as_tensor(pos), None if c is None else
                                        torch.as_tensor(c), 5.0, max_neighbors=64)
    ref = bf_jax(jnp.asarray(pos), None if c is None else jnp.asarray(c), 5.0, max_neighbors=64)
    assert not bool(nl.overflow) and not bool(ref.overflow)
    assert nl.idx.dtype == torch.int32 and nl.idx.shape == (len(pos), 64)
    assert _rows(nl.idx) == _rows(ref.idx)
    idx = nl.idx.numpy()
    assert np.all(np.diff(idx, axis=1) >= 0)
    mir = nl.mirror.long().numpy()
    np.testing.assert_array_equal(mir[mir], np.arange(idx.size))
    src = np.repeat(np.arange(len(pos)), 64)
    np.testing.assert_array_equal(idx.reshape(-1)[mir], src)
    if periodic:
        cl = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), 5.0,
                                 max_neighbors=64, grid=grid_shape(cell, 5.0))
        np.testing.assert_array_equal(cl.idx.numpy(), idx)
    tight = build_neighbor_list_bruteforce(torch.as_tensor(pos), torch.as_tensor(cell), 5.0,
                                           max_neighbors=24)
    assert bool(tight.overflow) == bool(bf_jax(jnp.asarray(pos), jnp.asarray(cell), 5.0,
                                               max_neighbors=24).overflow) is True


@pytest.mark.parametrize("option", ["centers", "include_self_image"])
def test_list_options_match_jax(option):
    """``centers``: rows for the first C atoms of a set with padding rows
    (a halo-extended set), every real atom still a candidate; no mirror.
    ``include_self_image``: the JAX option's rows (its own images never
    enter a minimum-image list, so the default rows)."""
    pos, cell = _box(reps=(6, 3, 3), seed=8)
    n = len(pos)
    real = np.ones(n, bool)
    real[::7] = False
    grid = grid_shape(cell, 5.0)
    kw = dict(max_neighbors=64, grid=grid)
    if option == "centers":
        kw.update(centers=200)
    else:
        kw.update(include_self_image=True)
    nl = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), 5.0,
                             real=torch.as_tensor(real), **kw)
    ref = bnl_jax(jnp.asarray(pos), jnp.asarray(cell), 5.0, real=jnp.asarray(real), **kw)
    assert not bool(nl.overflow) and not bool(ref.overflow)
    rows = kw.get("centers", n)
    assert nl.idx.shape == (rows, 64)
    assert _rows(nl.idx) == _rows(ref.idx)
    assert (nl.mirror is None) == (option == "centers")
    full = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), 5.0,
                               real=torch.as_tensor(real), max_neighbors=64, grid=grid)
    np.testing.assert_array_equal(nl.idx.numpy(), full.idx.numpy()[:rows])


def test_narrow_axis_flags_the_minimum_image():
    """A 2-bin axis whose cell shrinks below 2 x cutoff under a fixed grid:
    a pair then lies within the cutoff through two images, and the minimum
    image keeps one. The port flags it; the JAX builder checks only axes
    of 3 bins or more and drops the second image without a flag."""
    pos, cell = _box(reps=(6, 3, 3), seed=9)
    grid = grid_shape(cell, 5.6)
    assert grid[1:] == (2, 2)
    s = np.diag([1.0, 0.9, 1.0])  # y: 12 A -> 10.8 A < 2 x 5.6
    p, c = pos @ s, cell @ s
    nl = build_neighbor_list(torch.as_tensor(p), torch.as_tensor(c), 5.6, max_neighbors=96,
                             grid=grid)
    ref = bnl_jax(jnp.asarray(p), jnp.asarray(c), 5.6, max_neighbors=96, grid=grid)
    assert bool(nl.overflow) and not bool(ref.overflow)
    ok = build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(cell), 5.6, max_neighbors=96,
                             grid=grid)
    assert not bool(ok.overflow)


def test_cpu_tensors_take_the_plain_row_phase():
    """On the CPU every build runs the row phase's plain twin once (its
    counter moves), and K8 never launches; the sorted build likewise. The
    bin sort and cell table too: K11's plain twin once a build, the sorted
    build's included."""
    pos, cell = _box(reps=(4, 4, 4), seed=10)
    p, c = torch.as_tensor(pos), torch.as_tensor(cell)
    grid = grid_shape(cell, CUT)
    launches, plain = nbm.K8.launches, nbm.K8.plain_calls
    sort_launches, sort_plain = nbm.K11.launches, nbm.K11.plain_calls
    build_neighbor_list(p, c, CUT, max_neighbors=64, grid=grid)
    build_sorted_neighbor_list(p, c, CUT, max_neighbors=64, grid=grid)
    assert nbm.K8.plain_calls == plain + 2 and nbm.K8.launches == launches == 0
    assert nbm.K11.plain_calls == sort_plain + 2 and nbm.K11.launches == sort_launches == 0


@pytest.mark.parametrize("case", ["fcc", "triclinic", "real and centers", "self image, J 104",
                                  "2-bin axes", "overflow"])
def test_plain_rows_ignore_the_row_block(case, monkeypatch):
    """The plain twin's rows and largest count do not depend on how many
    rows a pass takes (8,192 against 7): each row is computed on its own,
    which the kernel's single launch over all rows relies on."""
    reps, tilt, kw, j = (6, 6, 6), 0.0, {}, 64
    if case == "triclinic":
        tilt = 0.2
    elif case == "real and centers":
        kw = dict(real=torch.as_tensor(np.arange(864) % 5 != 0), centers=700)
    elif case == "self image, J 104":
        kw, j = dict(include_self_image=True), 104
    elif case == "2-bin axes":
        reps = (3, 3, 3)
    elif case == "overflow":
        j = 20
    pos, cell = _box(reps=reps, seed=11, tilt=tilt)
    p, c = torch.as_tensor(pos), torch.as_tensor(cell)
    grid = grid_shape(cell, CUT)
    real = kw.get("real")
    cl = nbm.cell_list(p, c, CUT, grid, None, real, sort=False)
    args = (p, cl.bin3, cl.table, cl.counts, c, cl.inv_cell, grid, CUT, j,
            kw.get("centers", len(pos)), real, kw.get("include_self_image", False))
    idx, count = nbm.neighbor_rows_plain(*args)
    assert nbm._ROW_BLOCK == 8192
    monkeypatch.setattr(nbm, "_ROW_BLOCK", 7)
    idx7, count7 = nbm.neighbor_rows_plain(*args)
    assert torch.equal(idx, idx7) and int(count) == int(count7)
    assert (int(count) > j) == (case == "overflow")
    assert idx.shape == (args[9], j) and bool((idx[:, 1:] >= idx[:, :-1]).all())


def _frozen_bins(positions, inv_cell, grid):
    """The bins of a build before K11 (``ops/neighbors.py _bins``)."""
    gx, gy, gz = grid
    frac = [positions[:, 0] * inv_cell[0, a] + positions[:, 1] * inv_cell[1, a]
            + positions[:, 2] * inv_cell[2, a] for a in range(3)]
    frac = [f - torch.floor(f) for f in frac]
    bin3 = torch.stack(
        [torch.clamp((frac[a] * g).to(torch.int64), 0, g - 1) for a, g in enumerate(grid)],
        dim=1,
    )
    return bin3, (bin3[:, 0] * gy + bin3[:, 1]) * gz + bin3[:, 2]


def _frozen_cell_table(positions, cell, cutoff, grid, bin_capacity, real):
    """The cell table of a build before K11 (``ops/neighbors.py
    _cell_table``): (inv_cell, bin3, table, counts, flag)."""
    n = positions.shape[0]
    ncells = grid[0] * grid[1] * grid[2]
    inv_cell = inverse_cell(cell)
    bin3, bin_id = _frozen_bins(positions, inv_cell, grid)
    if real is not None:
        bin_id = torch.where(real, bin_id, ncells)
    widths = 1.0 / torch.linalg.vector_norm(inv_cell, dim=0)
    geom = torch.zeros((), dtype=torch.bool)
    for a, g in enumerate(grid):
        geom = geom | (widths[a] / max(g, 2) < cutoff * (1.0 - 1e-6))
    order = torch.argsort(bin_id, stable=True)
    sorted_bin = bin_id[order]
    cap = bin_capacity or max(1, int(np.ceil(2.2 * n / ncells)) + 12)
    nbins = ncells + (real is not None)
    counts = torch.zeros(nbins, dtype=torch.int64).index_add_(0, bin_id, torch.ones_like(bin_id))
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n) - start[sorted_bin]
    table = torch.full((nbins, cap), -1, dtype=torch.int64)
    table[sorted_bin, torch.clamp(rank, max=cap - 1)] = order
    return inv_cell, bin3, table, counts, (torch.max(counts[:ncells]) > cap) | geom


def _frozen_two_sorts(positions, cell, cutoff, grid, bin_capacity, real):
    """The sorted build's bin sort before K11: the atoms' bins and stable
    argsort, then the cell table of the sorted atoms, which bins and sorts
    them a second time. Returns (order, inv_order, sorted positions, sorted
    real, inv_cell, bin3, table, counts, flag)."""
    _, bin_id = _frozen_bins(positions, inverse_cell(cell), grid)
    if real is not None:
        bin_id = torch.where(real, bin_id, grid[0] * grid[1] * grid[2])
    order = torch.argsort(bin_id, stable=True)
    ps, rs = positions[order], None if real is None else real[order]
    return (order, torch.argsort(order), ps, rs,
            *_frozen_cell_table(ps, cell, cutoff, grid, bin_capacity, rs))


def _cell_list_case(name):
    """(positions, cell, grid, bin_capacity, real) of a cell-list case,
    float32 but for "float64"."""
    dtype = torch.float64 if name == "float64" else torch.float32
    grid, cap, real = None, None, None
    if name == "random gas":  # unwrapped: coordinates up to a box beyond the cell
        cell = np.diag([23.0, 25.0, 27.0])
        pos = np.random.default_rng(12).uniform(-0.5, 1.5, (900, 3)) * np.diag(cell)
    elif name == "trash bin of thousands":
        pos, cell = _box(reps=(12, 12, 12), seed=13)
        real = torch.as_tensor(np.arange(len(pos)) % 2 == 0)
    else:
        reps = (6, 3, 3) if name == "2-bin axes" else (6, 6, 6)
        pos, cell = _box(reps=reps, seed=14, tilt=0.2 if name in ("tilted", "float64") else 0.0)
        if name == "1-bin axis":
            grid = (1, 4, 4)
        elif name == "one overflowed bin":
            # 60 atoms about the centre of the first bin (6 A wide), past its 42
            pos[:60] = 3.0 + np.random.default_rng(15).normal(0, 0.05, (60, 3))
    p, c = torch.as_tensor(pos, dtype=dtype), torch.as_tensor(cell, dtype=dtype)
    return p, c, grid or grid_shape(cell, CUT), cap, real


_CELL_LIST_CASES = ["fcc", "random gas", "tilted", "1-bin axis", "2-bin axes", "float64",
                    "trash bin of thousands", "one overflowed bin"]


def _equal_tables(got, want, counts):
    """Tables equal in every bin within its capacity; a bin past it in all
    but its last slot (where the old clipped writes collided)."""
    cap = got.shape[1]
    over = counts > cap
    return (torch.equal(got[~over], want[~over])
            and torch.equal(got[over, :cap - 1], want[over, :cap - 1]))


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("case", _CELL_LIST_CASES)
def test_cell_list_plain_sorts_once_as_the_two_sorts_did(case, sort):
    """The plain twin of K11, one stable sort, gives what the build gave
    before it, output by output: sorted, what the outer bin sort and the
    cell table of the sorted atoms gave; unsorted, the cell table of the
    atoms in their own order. Order and inverse order are permutations,
    overflow or not."""
    p, c, grid, cap, real = _cell_list_case(case)
    n = len(p)
    got = nbm.cell_list_plain(p, c, CUT, grid, cap, real, sort=sort)
    if sort:
        order, inv_order, ps, rs, inv, bin3, table, counts, flag = _frozen_two_sorts(
            p, c, CUT, grid, cap, real)
        assert torch.equal(got.order, order) and torch.equal(got.inv_order, inv_order)
        assert torch.equal(got.positions, ps)
        assert (got.real is None) == (rs is None) and (rs is None or torch.equal(got.real, rs))
        assert torch.equal(torch.sort(got.order).values, torch.arange(n))
        assert torch.equal(got.inv_order[got.order], torch.arange(n))
    else:
        inv, bin3, table, counts, flag = _frozen_cell_table(p, c, CUT, grid, cap, real)
        assert got.order is None and got.inv_order is None and got.positions is p
    assert torch.equal(got.inv_cell, inv) and got.inv_cell.is_contiguous()
    assert torch.equal(got.bin3, bin3) and torch.equal(got.counts, counts)
    assert _equal_tables(got.table, table, counts)
    assert bool(got.overflow) == bool(flag) == (case == "one overflowed bin")
    assert int(counts.sum()) == n and got.table.shape == (len(counts), got.table.shape[1])
    if real is not None:  # the trash bin: every non-real row, past its capacity
        assert int(counts[-1]) == int((~real).sum()) > 1000 > got.table.shape[1]
