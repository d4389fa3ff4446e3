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
from mtp_tpu_torch.ops.neighbors import (
    build_neighbor_list,
    build_sorted_neighbor_list,
    check_cell,
    grid_shape,
    mirror_permutation,
    needs_rebuild,
)

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
