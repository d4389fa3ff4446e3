"""Neighbor lists in plain PyTorch, on the tensors' device.

Port of ``mtp_tpu/ops/neighbors.py``: a periodic cell (bin) list built from
sort and gather primitives. Every constant is made on the device or folded
in as a Python number (a host-to-device copy from pageable memory would
synchronise the stream), so a rebuild queues behind the step loop on the
card without the host waiting for it.

Representation: padded index array ``idx (N, max_neighbors) int32`` whose
padding entries equal the row's own atom index (self-pairs are masked by the
compute path). Overflow of a static capacity (neighbors per row, atoms per
bin) or of the bin-grid geometry is reported in a device flag, never assumed
away; callers rebuild with a larger capacity.

Requires every perpendicular cell width >= 2*cutoff (minimum-image regime);
:func:`check_cell` validates this on the host.

Differences from the JAX package, by design: the TPU-only layouts (fat
(y, z) rows, packed top-k keys, window worklists, octant-aligned slots) are
not ported; rows come out sorted ascending; the sorted list has no tile
padding (N_pad = N), since the CUDA kernels mask their ragged edge.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mtp_tpu_torch.ops.window_disp import (
    cell_product,
    image_components,
    inverse_cell,
    minimum_image,
)

# center rows per candidate pass: bounds the (rows, ~27 x bin capacity)
# candidate arrays to a few hundred MB at 32k atoms
_ROW_BLOCK = 8192


@dataclasses.dataclass
class NeighborList:
    idx: torch.Tensor  # (N, max_neighbors) int32, padded with self-index
    overflow: torch.Tensor  # () bool: a capacity or the geometry was exceeded
    reference_positions: torch.Tensor  # positions at build time (skin check)
    reference_cell: torch.Tensor  # cell at build time
    mirror: torch.Tensor  # (N*J,) int32 flat mirror permutation


def mirror_permutation(idx):
    """Flat mirror permutation of a row-sorted symmetric neighbor list.

    With each row of `idx` sorted ascending, storage order IS the (src, dst)
    lexicographic order, so the k-th pair in (dst, src) order is the mirror
    of the k-th stored pair: ``argsort(dst * N + src)`` maps a storage
    position to its mirror's. The keys are int64, so no two-key sort is
    needed at any N. Padding entries (dst == src == row) mirror among
    themselves (equal keys; the stable sort keeps their order).
    """
    n, j = idx.shape
    src = torch.arange(n, device=idx.device, dtype=torch.int64).repeat_interleave(j)
    dst = idx.reshape(-1).long()
    return torch.argsort(dst * n + src, stable=True).to(torch.int32)


def perpendicular_widths(cell: np.ndarray) -> np.ndarray:
    """Perpendicular widths of a (row-vector) cell matrix."""
    inv = np.linalg.inv(np.asarray(cell, dtype=np.float64))
    return 1.0 / np.linalg.norm(inv, axis=1)


def check_cell(cell, cutoff: float) -> None:
    w = perpendicular_widths(cell)
    if (w < 2.0 * cutoff).any():
        raise ValueError(
            f"cell widths {w} must be >= 2*cutoff ({2 * cutoff}) for the "
            "minimum-image neighbor engine; replicate the cell first"
        )


def grid_shape(cell, cutoff: float) -> tuple:
    """Static bin-grid shape: as many bins as fit with width >= cutoff."""
    w = perpendicular_widths(cell)
    return tuple(int(max(1, np.floor(wi / cutoff))) for wi in w)


def _bins(positions, inv_cell, grid):
    """Integer bin coordinates (N, 3) and flat bin ids (N,) of wrapped atoms."""
    gx, gy, gz = grid
    frac = cell_product(positions.unbind(-1), inv_cell)
    frac = [f - torch.floor(f) for f in frac]  # wrap to [0, 1)
    bin3 = torch.stack(
        [torch.clamp((frac[a] * g).to(torch.int64), 0, g - 1) for a, g in enumerate(grid)],
        dim=1,
    )
    bin_id = (bin3[:, 0] * gy + bin3[:, 1]) * gz + bin3[:, 2]
    return bin3, bin_id


def build_neighbor_list(
    positions,
    cell,
    cutoff: float,
    *,
    max_neighbors: int,
    grid: tuple,
    bin_capacity: int | None = None,
):
    """Periodic cell-list neighbor build.

    Args:
      positions: (N, 3); may be unwrapped (wrapped internally).
      cell: (3, 3) row-vector cell matrix.
      cutoff: neighbor cutoff (model cutoff + Verlet skin).
      max_neighbors: output width J.
      grid: bin grid from :func:`grid_shape`. Along a dimension with fewer
        than 3 bins, every bin is a candidate once.
      bin_capacity: atoms per bin in the cell table (default: 2.2x the mean
        + 12, as in the JAX package); exceeding it raises the overflow flag.

    Returns :class:`NeighborList` with the flat mirror permutation; each row
    is sorted ascending, pads (the row's own index) included.
    """
    n = positions.shape[0]
    dev = positions.device
    gx, gy, gz = grid
    ncells = gx * gy * gz
    inv_cell = inverse_cell(cell)
    bin3, bin_id = _bins(positions, inv_cell, grid)

    # the grid is static but the cell is a run-time value: flag any binned
    # dimension whose bin width has shrunk below the cutoff (relative
    # epsilon: commensurate boxes have width/g == cutoff exactly)
    widths = 1.0 / torch.linalg.vector_norm(inv_cell, dim=1)
    geom_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for a, g in enumerate(grid):
        if g >= 3:
            geom_overflow = geom_overflow | (widths[a] / g < cutoff * (1.0 - 1e-6))

    order = torch.argsort(bin_id, stable=True)
    sorted_bin = bin_id[order]
    cap = bin_capacity or max(1, int(np.ceil(2.2 * n / ncells)) + 12)
    counts = torch.zeros(ncells, dtype=torch.int64, device=dev).index_add_(
        0, bin_id, torch.ones_like(bin_id)
    )
    cell_overflow = torch.max(counts) > cap
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - start[sorted_bin]
    table = torch.full((ncells, cap), -1, dtype=torch.int64, device=dev)
    # on bin overflow, clipped writes collide (the flag is already set)
    table[sorted_bin, torch.clamp(rank, max=cap - 1)] = order

    def offs(g):
        return torch.arange(g, device=dev) if g < 3 else torch.arange(-1, 2, device=dev)

    stencil = torch.cartesian_prod(offs(gx), offs(gy), offs(gz)).reshape(-1, 3)  # (K, 3)
    cut2 = cutoff * cutoff
    big = torch.iinfo(torch.int64).max

    def row_phase(rows):
        """Distance filter and compaction for a block of center rows."""
        b = rows.shape[0]
        nb = [
            torch.remainder(bin3[rows, None, a] + stencil[None, :, a], g)
            for a, g in enumerate(grid)
        ]
        nb_id = (nb[0] * gy + nb[1]) * gz + nb[2]
        cand = table[nb_id].reshape(b, -1)  # (b, K*cap)
        valid = cand >= 0
        safe = torch.where(valid, cand, 0)
        cpos = positions[safe]  # (b, W, 3)
        dc = [cpos[..., a] - positions[rows, a][:, None] for a in range(3)]
        dr = image_components(dc, cell, inv_cell)
        d2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        keep = valid & (d2 <= cut2) & (safe != rows[:, None])
        # kept candidates to the front, ascending by atom index
        key = torch.sort(torch.where(keep, safe, big), dim=1).values
        if key.shape[1] < max_neighbors:
            pad = torch.full((b, max_neighbors - key.shape[1]), big, device=dev)
            key = torch.cat([key, pad], dim=1)
        key = key[:, :max_neighbors]
        idx = torch.where(key == big, rows[:, None], key)
        return idx.to(torch.int32), torch.max(torch.sum(keep, dim=1))

    rows_all = torch.arange(n, device=dev)
    parts = [row_phase(rows_all[a : a + _ROW_BLOCK]) for a in range(0, n, _ROW_BLOCK)]
    idx = torch.cat([p[0] for p in parts], dim=0)
    max_cnt = torch.max(torch.stack([p[1] for p in parts]))
    nbr_overflow = max_cnt > max_neighbors

    idx = torch.sort(idx, dim=1).values  # row-sorted storage = (src, dst) order
    return NeighborList(
        idx=idx,
        overflow=cell_overflow | nbr_overflow | geom_overflow,
        reference_positions=positions,
        reference_cell=cell,
        mirror=mirror_permutation(idx),
    )


def needs_rebuild(nl, positions, cell, skin: float):
    """Verlet criterion: any atom moved more than skin/2 since the build."""
    disp = minimum_image(positions - nl.reference_positions, cell, inverse_cell(cell))
    return torch.max(torch.sum(disp * disp, dim=-1)) > (0.5 * skin) ** 2


@dataclasses.dataclass
class SortedNeighborList:
    """Bin-sorted neighbor data for the window force path.

    Index arrays live in *sorted* space (row k = atom order[k]); the MD state
    stays in user order and the block driver permutes it once per block.
    """

    order: torch.Tensor  # (N,) int64: sorted row -> user atom
    inv_order: torch.Tensor  # (N,) int64: user atom -> sorted row
    idx: torch.Tensor  # (N, J) int32 sorted-space list, rows ascending, pads = own row
    mirror: torch.Tensor  # (N*J,) int32 flat mirror permutation
    overflow: torch.Tensor  # () bool: capacity or geometry overflow
    reference_positions: torch.Tensor  # user-order positions at build time
    reference_cell: torch.Tensor  # cell at build time


def build_sorted_neighbor_list(
    positions,
    cell,
    cutoff: float,
    *,
    max_neighbors: int,
    grid: tuple,
):
    """Cell-list build over bin-sorted atoms (the ``align_slots=False``
    branch of the JAX builder, without window worklists). The bin sort keeps
    every atom's neighbors close in memory, which the gathers of the K1 and
    K3 kernels rely on for cache reuse."""
    _, bin_id = _bins(positions, inverse_cell(cell), grid)
    order = torch.argsort(bin_id, stable=True)
    inv_order = torch.argsort(order)
    nl = build_neighbor_list(
        positions[order], cell, cutoff, max_neighbors=max_neighbors, grid=grid,
    )
    return SortedNeighborList(
        order=order,
        inv_order=inv_order,
        idx=nl.idx,
        mirror=nl.mirror,
        overflow=nl.overflow,
        reference_positions=positions,
        reference_cell=cell,
    )
