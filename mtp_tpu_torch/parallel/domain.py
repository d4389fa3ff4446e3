"""Spatial domain decomposition: slabs along one cell vector, or an (n0, n1)
grid of bricks along two (port of ``mtp_tpu/parallel/domain.py``, NumPy).

The reference inherits spatial decomposition and ghost atoms from LAMMPS MPI
(SURVEY.md §2.2/§2.3). Each domain is padded to one common atom capacity
(static shapes); ghost positions are exchanged every step by
:mod:`mtp_tpu_torch.parallel.sharded_window`.

Width guards (raised here): a domain's perpendicular width along a cut
vector must be >= cutoff (cutoff + skin for MD), so every neighbor of an atom
lives in its own or an adjacent domain; on exactly two domains along an axis
both faces ship to the same peer, so the width must be >= 2 x cutoff there.

Difference from the JAX package, by design: the widths are 1 / the column
norms of the inverse cell (``ops.neighbors.perpendicular_widths``), the
spacings of the planes of constant fractional coordinate. The JAX package
takes the row norms (``domain.py:75,150``), which is wrong for a tilted
cell.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mtp_tpu_torch.ops.neighbors import perpendicular_widths


@dataclasses.dataclass
class SlabPartition:
    """Host-side partition result. Arrays are (n_shards * capacity, ...),
    shard-major: rank r's slots are ``[r * capacity, (r + 1) * capacity)``."""

    positions: np.ndarray
    velocities: np.ndarray
    types: np.ndarray
    masses: np.ndarray
    real: np.ndarray  # bool, False = padding slot
    capacity: int
    n_shards: int
    axes: tuple  # the cell vector each axis of the rank grid cuts along
    original_index: np.ndarray  # (n_shards*capacity,) -> index into input (or -1)

    @property
    def axis(self) -> int:
        """The cell vector of the first cut (the JAX package's field)."""
        return self.axes[0]

    @property
    def n_atoms(self) -> int:
        return int(self.real.sum())

    def gather(self, arr_sharded: np.ndarray, n_atoms: int) -> np.ndarray:
        """Undo the partition permutation for a per-atom array."""
        out = np.zeros((n_atoms,) + arr_sharded.shape[1:], arr_sharded.dtype)
        m = self.original_index >= 0
        out[self.original_index[m]] = arr_sharded[m]
        return out


def _check_width(width: float, nk: int, cutoff: float, axis: int, what: str) -> None:
    min_w = 2.0 * cutoff if nk == 2 else cutoff
    if width / nk < min_w:
        raise ValueError(
            f"{what} width {width / nk:.2f} A along axis {axis} < required "
            f"{min_w:.2f} A ({'2x cutoff on 2 domains' if nk == 2 else 'cutoff'}): "
            f"max domains along it is {int(width / cutoff)}"
        )


def _fill(positions, velocities, types, masses, dom, n_shards, capacity, pad_multiple, axes):
    counts = np.bincount(dom, minlength=n_shards)
    if capacity is None:
        # ~10% headroom: migration needs free slots for atoms drifting in
        capacity = int(np.ceil((counts.max() * 1.1 + 4) / pad_multiple) * pad_multiple)
    elif counts.max() > capacity:
        raise ValueError(f"domain overflow: max count {counts.max()} > capacity {capacity}")
    total = n_shards * capacity
    pos_out = np.zeros((total, 3), positions.dtype)
    vel_out = np.zeros((total, 3), positions.dtype)
    typ_out = np.zeros((total,), np.int32)
    mas_out = np.ones((total,), positions.dtype)
    real = np.zeros((total,), bool)
    orig = np.full((total,), -1, np.int64)
    order = np.argsort(dom, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for s in range(n_shards):
        sel = order[offsets[s]: offsets[s + 1]]
        dst = np.arange(len(sel)) + s * capacity
        pos_out[dst] = positions[sel]
        vel_out[dst] = np.asarray(velocities)[sel]
        typ_out[dst] = np.asarray(types)[sel]
        mas_out[dst] = np.asarray(masses)[sel]
        real[dst] = True
        orig[dst] = sel
    return SlabPartition(
        positions=pos_out, velocities=vel_out, types=typ_out, masses=mas_out, real=real,
        capacity=capacity, n_shards=n_shards, axes=tuple(axes), original_index=orig,
    )


def _frac(positions, cell):
    frac = np.asarray(positions) @ np.linalg.inv(np.asarray(cell, dtype=np.float64))
    return frac - np.floor(frac)


def partition_slabs(
    positions, velocities, types, masses, cell, n_shards: int, *,
    cutoff: float, axis: int = 0, capacity: int | None = None, pad_multiple: int = 8,
) -> SlabPartition:
    """Sort atoms into `n_shards` slabs by their fractional coordinate along
    cell vector `axis`. The slab count is capped by the 1-D decomposition
    limit (width guard above)."""
    positions = np.asarray(positions)
    _check_width(perpendicular_widths(cell)[axis], n_shards, cutoff, axis, "slab")
    frac = _frac(positions, cell)
    slab = np.minimum((frac[:, axis] * n_shards).astype(np.int64), n_shards - 1)
    return _fill(positions, velocities, types, masses, slab, n_shards, capacity,
                 pad_multiple, (axis,))


def partition_bricks(
    positions, velocities, types, masses, cell, shape: tuple, *,
    cutoff: float, axes: tuple = (0, 1), capacity: int | None = None, pad_multiple: int = 8,
) -> SlabPartition:
    """2-D brick decomposition (the LAMMPS brick analog for a 2-D rank
    grid): atoms into an (n0, n1) grid along cell vectors `axes`, flattened
    brick-major (i0 * n1 + i1), the rank order of
    :class:`~mtp_tpu_torch.parallel.comm.Comm`. Per-axis width guards."""
    n0, n1 = shape
    if axes[0] == axes[1]:
        raise ValueError(f"bricks need two different cell vectors, axes={axes}")
    if n1 == 1:
        part = partition_slabs(positions, velocities, types, masses, cell, n0, cutoff=cutoff,
                               axis=axes[0], capacity=capacity, pad_multiple=pad_multiple)
        return dataclasses.replace(part, axes=tuple(axes))
    positions = np.asarray(positions)
    widths = perpendicular_widths(cell)
    for ax, nk in zip(axes, shape):
        if nk > 1:
            _check_width(widths[ax], nk, cutoff, ax, "brick")
    frac = _frac(positions, cell)
    i0 = np.minimum((frac[:, axes[0]] * n0).astype(np.int64), n0 - 1)
    i1 = np.minimum((frac[:, axes[1]] * n1).astype(np.int64), n1 - 1)
    return _fill(positions, velocities, types, masses, i0 * n1 + i1, n0 * n1, capacity,
                 pad_multiple, axes)


def halo_capacities(part: SlabPartition, cell, grid: tuple, w_cut: float, *,
                    headroom: float = 1.3) -> tuple:
    """Per-stage halo capacities for ``ShardedSimulation(halo_capacity=...)``
    on rank grid `grid` of partition `part` (its capacity, and the cell
    vectors it cut along): `headroom` times a face shell's share of its source rows (the shell of
    depth `w_cut` in a domain of width plane spacing / n), plus 16, rounded
    up to 8 and at most the source. Stage k's source is the stage-(k-1)-
    extended set; an axis of one rank ships nothing (0). The maximal default
    (every source row) always fits but multiplies the kernels' rows; a shell
    that outgrows these trips the halo flag, and ``run`` then takes the
    maximal one."""
    if len(grid) != len(part.axes):
        raise ValueError(f"rank grid {grid} for a partition along cell vectors {part.axes}")
    widths = perpendicular_widths(cell)
    caps, src = [], part.capacity
    for ax, nk in zip(part.axes, grid):
        if nk == 1:
            caps.append(0)
            continue
        h = int(np.ceil((headroom * src * w_cut * nk / widths[ax] + 16) / 8) * 8)
        caps.append(min(src, h))
        src += 2 * caps[-1]
    return tuple(caps)
