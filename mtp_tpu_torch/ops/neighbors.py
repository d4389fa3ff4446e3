"""Neighbor lists on the tensors' device.

Port of ``mtp_tpu/ops/neighbors.py``: a periodic cell (bin) list. On the
card its bin sort and cell table are one call of K11 (``csrc/cell_list.cu``)
and its row phase (each centre's stencil candidates, filtered and sorted)
one launch of K8 (``csrc/neighbor_rows.cu``); CPU tensors take their plain
twins :func:`cell_list_plain` and :func:`neighbor_rows_plain`. Every
constant is made on the device or folded in as a Python number (a
host-to-device copy from pageable memory would synchronise the stream), so
a rebuild queues behind the step loop on the card without the host waiting
for it.

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

import ctypes
import dataclasses

import numpy as np
import torch

from mtp_tpu_torch.ops.window_disp import (
    cell_product,
    image_components,
    inverse_cell,
    minimum_image,
)
from mtp_tpu_torch.kernels._build import Kernel
from mtp_tpu_torch.utils.tracing import span

# center rows per candidate pass of the plain twin: bounds its (rows, ~27 x
# bin capacity) candidate arrays to a few hundred MB at 32k atoms
_ROW_BLOCK = 8192

_P = ctypes.c_void_p
_I = ctypes.c_int

K8 = Kernel(
    name="neighbor_rows",
    symbol="mtp_neighbor_rows",
    source="mtp_tpu_torch/csrc/neighbor_rows.cu",
    replaces="none: the row phase of mtp_tpu/ops/neighbors.py is XLA code",
    argtypes=(_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_double,
              _I, _I, _P),
)
K11 = Kernel(
    name="cell_list",
    symbol="mtp_cell_list",
    source="mtp_tpu_torch/csrc/cell_list.cu",
    replaces="none: the bin sort of mtp_tpu/ops/neighbors.py is XLA code",
    argtypes=(_P,) * 14 + (_I,) * 5 + (ctypes.c_double, _I, _I, _P),
)


@dataclasses.dataclass
class NeighborList:
    idx: torch.Tensor  # (N, max_neighbors) int32, padded with self-index
    overflow: torch.Tensor  # () bool: a capacity or the geometry was exceeded
    reference_positions: torch.Tensor  # positions at build time (skin check)
    reference_cell: torch.Tensor  # cell at build time
    mirror: torch.Tensor | None  # (N*J,) int32 flat mirror permutation; None with `centers`


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
    """Perpendicular widths of a (row-vector) cell matrix: the spacing of
    the planes of constant fractional coordinate a is 1 / |inv[:, a]| (the
    columns of the inverse are the reciprocal vectors; the JAX package takes
    its rows, which is wrong for a tilted cell)."""
    inv = np.linalg.inv(np.asarray(cell, dtype=np.float64))
    return 1.0 / np.linalg.norm(inv, axis=0)


def check_cell(cell, cutoff: float) -> None:
    w = perpendicular_widths(cell)
    if (w < 2.0 * cutoff).any():
        raise ValueError(
            f"cell widths {w} must be >= 2*cutoff ({2 * cutoff}) for the "
            "minimum-image neighbor engine; replicate the cell first"
        )


def grown_width(max_neighbors: int, during: str = "") -> int:
    """The list width J after an overflow: x1.5 + 8, rounded up to a
    multiple of 8 (16 -> 32 -> 56 -> 96). At J >= 1024 it raises: an
    overflow there is density or geometry, not list width. `during` names
    the caller's run in the message ("during minimization")."""
    if max_neighbors >= 1024:
        where = f" {during}" if during else ""
        raise RuntimeError(
            f"neighbor overflow persists at max_neighbors={max_neighbors}{where}: not a "
            "list-width problem. Check bin_capacity vs the local density, the grid "
            "geometry, and the system for collapse/overlap."
        )
    return -(-(int(max_neighbors * 1.5) + 8) // 8) * 8


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
    real=None,
    centers: int | None = None,
    include_self_image: bool = False,
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
      real: optional (N,) bool; False rows (slab padding) go to a trash bin
        the stencil never reads, so they are neither centers nor neighbors
        (their rows hold only self-padding) and cannot overflow a real bin.
      centers: build rows only for the first `centers` atoms (a
        halo-extended set: own atoms first, ghosts after); every atom is
        still a candidate neighbor. The list is then (centers, J) and not
        symmetric, so it has no mirror (``mirror`` is None).
      include_self_image: also keep an atom's own periodic images within the
        cutoff (the JAX package's option). Candidates are minimum-imaged and
        each bin is visited once, so an atom's own candidate always lies at
        distance 0 and no image is ever added in the regime
        :func:`check_cell` allows; the list is the default one.

    Returns :class:`NeighborList` with the flat mirror permutation; each row
    is sorted ascending, pads (the row's own index) included.

    The geometry flag covers every axis: one of 3 or more bins flags bins
    narrower than the cutoff; one of 1 or 2 bins (every bin visited once)
    flags a cell narrower than 2 x cutoff, where the minimum image would
    drop a pair's second image. The JAX package checks only the first kind
    (``ops/neighbors.py:163-168``) and drops such pairs without a flag.
    """
    with span("nl.build"):
        with span("nl.sort"):
            cl = cell_list(positions.contiguous(), cell.contiguous(), cutoff, grid, bin_capacity,
                           None if real is None else real.contiguous(), sort=False)
        idx, overflow = _rows(cl, cell, cutoff, max_neighbors, grid, centers, include_self_image)
        del cl  # the cell table ends with the rows: the mirror's sort may reuse its memory
        mirror = None
        if centers is None:
            with span("nl.mirror"):
                mirror = mirror_permutation(idx)
    return NeighborList(
        idx=idx,
        overflow=overflow,
        reference_positions=positions,
        reference_cell=cell,
        mirror=mirror,
    )


@dataclasses.dataclass
class CellList:
    """The bin sort and cell table of a build (:func:`cell_list`). Sorted
    (the MD path): rows in bin order, `order` sorted row -> atom and
    `inv_order` its inverse; unsorted: rows in the atoms' own order, `order`
    and `inv_order` None."""

    inv_cell: torch.Tensor  # (3, 3) contiguous, inverse_cell's values
    positions: torch.Tensor  # (N, 3): in bin order when sorted, else as given
    real: torch.Tensor | None  # (N,) bool, ordered as `positions`
    bin3: torch.Tensor  # (N, 3) int64 bin coordinates, ordered as `positions`
    table: torch.Tensor  # (bins, cap) int64 rows of `positions`, -1 holes
    counts: torch.Tensor  # (bins,) int64 atoms a bin (over cap on overflow)
    overflow: torch.Tensor  # () bool: a real bin over cap, or the geometry
    order: torch.Tensor | None  # (N,) int64 sorted row -> atom
    inv_order: torch.Tensor | None  # (N,) int64 atom -> sorted row


def _bin_capacity(n, ncells, bin_capacity):
    return bin_capacity or max(1, int(np.ceil(2.2 * n / ncells)) + 12)


def cell_list_plain(positions, cell, cutoff, grid, bin_capacity=None, real=None, *, sort):
    """Plain PyTorch twin of K11 (:func:`cell_list`), in the kernel's
    operations and order; one stable sort. Each bin's table row holds its
    first `cap` atoms in ascending order (the sorted rows when `sort`, else
    the atoms' own indices)."""
    K11.plain_calls += 1
    n = positions.shape[0]
    dev = positions.device
    ncells = grid[0] * grid[1] * grid[2]
    inv_cell = inverse_cell(cell).contiguous()
    bin3, bin_id = _bins(positions, inv_cell, grid)
    if real is not None:
        bin_id = torch.where(real, bin_id, ncells)  # the trash bin: sorts last

    # the grid is static but the cell is a run-time value: flag any binned
    # dimension whose bin width has shrunk below the cutoff, and any
    # dimension of 1 or 2 bins narrower than 2 x cutoff (the minimum-image
    # bound); relative epsilon: commensurate boxes have width/g == cutoff
    sq = inv_cell * inv_cell
    widths = 1.0 / torch.sqrt(sq[0] + sq[1] + sq[2])  # plane spacings
    geom_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for a, g in enumerate(grid):
        geom_overflow = geom_overflow | (widths[a] / max(g, 2) < cutoff * (1.0 - 1e-6))

    order = torch.argsort(bin_id, stable=True)
    sorted_bin = bin_id[order]
    cap = _bin_capacity(n, ncells, bin_capacity)
    nbins = ncells + (real is not None)
    counts = torch.zeros(nbins, dtype=torch.int64, device=dev).index_add_(
        0, bin_id, torch.ones_like(bin_id)
    )
    cell_overflow = torch.max(counts[:ncells]) > cap
    start = torch.cumsum(counts, 0) - counts
    rows = torch.arange(n, device=dev)
    rank = rows - start[sorted_bin]
    fill = rank < cap  # a bin past cap keeps its first cap atoms (the flag is set)
    table = torch.full((nbins, cap), -1, dtype=torch.int64, device=dev)
    table[sorted_bin[fill], rank[fill]] = (rows if sort else order)[fill]
    overflow = cell_overflow | geom_overflow
    if not sort:
        return CellList(inv_cell, positions, real, bin3, table, counts, overflow, None, None)
    return CellList(inv_cell, positions[order], None if real is None else real[order],
                    bin3[order], table, counts, overflow, order, torch.argsort(order))


def cell_list(positions, cell, cutoff, grid, bin_capacity=None, real=None, *, sort):
    """The bin sort and cell table of a build: each atom's bin (cell
    coordinates wrapped to [0, 1), times the grid, truncated), the stable
    order of the atoms by bin with non-real rows last (a trash bin the
    stencil never reads), the bins' counts, the (bins, cap) table of each
    bin's first `cap` rows ascending with -1 holes, and the flag: a real
    bin over `cap` (default 2.2x the mean + 12, as in the JAX package), or
    a binned axis narrower than the cutoff, or one of 1 or 2 bins narrower
    than 2 x cutoff. `sort` puts the rows in bin order (the MD path's
    sorted build); else they stay in the atoms' order. Returns a
    :class:`CellList`.

    A CPU tensor goes to :func:`cell_list_plain`, a CUDA tensor to K11
    (``csrc/cell_list.cu``: a memset and four kernels, one call), or the
    wrapper raises."""
    if positions.device.type == "cpu":
        return cell_list_plain(positions, cell, cutoff, grid, bin_capacity, real, sort=sort)
    n = positions.shape[0]
    dtype, dev = positions.dtype, positions.device
    if dtype not in (torch.float32, torch.float64) or cell.dtype != dtype:
        raise TypeError("cell_list kernel takes float32 or float64 positions and a cell of "
                        "their type")
    if real is not None and real.dtype != torch.bool:
        raise TypeError("cell_list kernel takes a bool real")
    tensors = (positions, cell) + (() if real is None else (real,))
    if (positions.shape != (n, 3) or cell.shape != (3, 3)
            or (real is not None and real.shape != (n,))
            or any(t.device != dev or not t.is_contiguous() for t in tensors)
            or len(grid) != 3 or min(grid) < 1):
        raise ValueError("cell_list kernel takes contiguous (N, 3) positions, a (3, 3) cell and "
                         "an (N,) real on one device, and a grid of three positive sizes")
    gx, gy, gz = map(int, grid)
    ncells = gx * gy * gz
    nbins = ncells + (real is not None)
    cap = _bin_capacity(n, ncells, bin_capacity)
    i64 = dict(dtype=torch.int64, device=dev)
    inv_cell = torch.empty((3, 3), dtype=dtype, device=dev)
    bin3 = torch.empty((n, 3), **i64)
    table = torch.empty((nbins, cap), **i64)
    counts = torch.empty(nbins, **i64)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    scratch = torch.empty(3 * n, dtype=torch.int32, device=dev)
    start = torch.empty(nbins, **i64)
    order = inv_order = real_s = None
    pos_s = positions
    if sort:
        order, inv_order = torch.empty(n, **i64), torch.empty(n, **i64)
        pos_s = torch.empty_like(positions)
        real_s = None if real is None else torch.empty_like(real)

    def ptr(t):
        return None if t is None else t.data_ptr()

    K11.launch(
        positions.data_ptr(), cell.data_ptr(), ptr(real), inv_cell.data_ptr(), ptr(order),
        ptr(inv_order), pos_s.data_ptr() if sort else None, ptr(real_s), bin3.data_ptr(),
        counts.data_ptr(), table.data_ptr(), overflow.data_ptr(), scratch.data_ptr(),
        start.data_ptr(), n, gx, gy, gz, cap, cutoff * (1.0 - 1e-6), int(sort),
        int(dtype == torch.float64), torch.cuda.current_stream(dev).cuda_stream,
    )
    return CellList(inv_cell, pos_s, real_s if sort else real, bin3, table, counts, overflow,
                    order, inv_order)


def neighbor_rows_plain(positions, bin3, table, counts, cell, inv_cell, grid, cutoff,
                        max_neighbors, centers, real=None, include_self_image=False):
    """Plain PyTorch twin of K8 (:func:`neighbor_rows`): the candidates of
    each row's bin stencil, distance-filtered and sorted, in passes over
    blocks of `_ROW_BLOCK` rows (each row's result is its own, whatever the
    block). It reads a bin's filled slots from the table's holes, so
    `counts` goes unread. Returns (idx, the largest kept count of a row)."""
    K8.plain_calls += 1
    dev = positions.device
    gx, gy, gz = grid

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
        self_row = safe == rows[:, None]
        keep = valid & (d2 <= cut2) & ~self_row
        if include_self_image:
            keep = keep | (valid & (d2 <= cut2) & self_row & (d2 > 1e-12))
        if real is not None:
            # candidates are real by construction (the stencil never reads
            # the trash bin): only the centers need the mask
            keep = keep & real[rows][:, None]
        # kept candidates to the front, ascending by atom index
        key = torch.sort(torch.where(keep, safe, big), dim=1).values
        if key.shape[1] < max_neighbors:
            pad = torch.full((b, max_neighbors - key.shape[1]), big, device=dev)
            key = torch.cat([key, pad], dim=1)
        key = key[:, :max_neighbors]
        idx = torch.where(key == big, rows[:, None], key)
        return idx.to(torch.int32), torch.max(torch.sum(keep, dim=1))

    rows_all = torch.arange(centers, device=dev)
    parts = [row_phase(rows_all[a : a + _ROW_BLOCK]) for a in range(0, centers, _ROW_BLOCK)]
    idx = torch.cat([p[0] for p in parts], dim=0)
    max_count = torch.max(torch.stack([p[1] for p in parts]))
    idx = torch.sort(idx, dim=1).values  # row-sorted storage = (src, dst) order
    return idx, max_count


def neighbor_rows(positions, bin3, table, counts, cell, inv_cell, grid, cutoff, max_neighbors,
                  centers, real=None, include_self_image=False):
    """The row phase of a build: (idx (centers, J) int32, each row's kept
    neighbours ascending and padded with its own index; the largest kept
    count of a row, a device scalar). Inputs as :func:`cell_list` makes
    them. A CPU tensor goes to :func:`neighbor_rows_plain`, a CUDA tensor to
    K8 (``csrc/neighbor_rows.cu``), one launch, or the wrapper raises."""
    if positions.device.type == "cpu":
        return neighbor_rows_plain(positions, bin3, table, counts, cell, inv_cell, grid,
                                   cutoff, max_neighbors, centers, real, include_self_image)
    n = positions.shape[0]
    if positions.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != positions.dtype for t in (cell, inv_cell)):
        raise TypeError("neighbor_rows kernel takes float32 or float64 positions, cell and "
                        "inverse cell of one type")
    if (any(t.dtype != torch.int64 for t in (bin3, table, counts))
            or (real is not None and real.dtype != torch.bool)):
        raise TypeError("neighbor_rows kernel takes int64 bin3, table and counts, and a bool "
                        "real")
    tensors = (positions, bin3, table, counts, cell, inv_cell) + (() if real is None else (real,))
    if (positions.shape != (n, 3) or bin3.shape != (n, 3) or table.dim() != 2
            or counts.shape != table.shape[:1] or cell.shape != (3, 3)
            or inv_cell.shape != (3, 3)
            or (real is not None and real.shape != (n,)) or not 0 <= centers <= n
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError("neighbor_rows kernel takes contiguous (N, 3) positions and bin3, a "
                         "(bins, cap) table, (bins,) counts, (3, 3) cells, an (N,) real and "
                         "centers <= N")
    idx = torch.empty((centers, max_neighbors), dtype=torch.int32, device=positions.device)
    max_count = torch.zeros((), dtype=torch.int32, device=positions.device)
    K8.launch(
        positions.data_ptr(), bin3.data_ptr(), table.data_ptr(), counts.data_ptr(),
        None if real is None else real.data_ptr(), cell.data_ptr(), inv_cell.data_ptr(),
        idx.data_ptr(), max_count.data_ptr(), centers, max_neighbors, table.shape[1],
        *map(int, grid), cutoff * cutoff, int(include_self_image),
        int(positions.dtype == torch.float64),
        torch.cuda.current_stream(positions.device).cuda_stream,
    )
    return idx, max_count


def _rows(cl, cell, cutoff, max_neighbors, grid, centers=None, include_self_image=False):
    """The row phase (``nl.rows``, K8 on the card) over a :class:`CellList`'s
    rows. Returns (idx, the build's overflow flag)."""
    nc = cl.positions.shape[0] if centers is None else int(centers)
    with span("nl.rows"):
        idx, max_count = neighbor_rows(
            cl.positions, cl.bin3, cl.table, cl.counts, cell.contiguous(), cl.inv_cell, grid,
            cutoff, max_neighbors, nc, cl.real, include_self_image)
        return idx, cl.overflow | (max_count > max_neighbors)


def build_neighbor_list_bruteforce(positions, cell, cutoff: float, *, max_neighbors: int):
    """All-pairs O(N^2) build (tests and small systems; port of the JAX
    package's ``build_neighbor_list_bruteforce``). `cell` None: open
    boundaries; otherwise minimum-image displacements, which needs every
    perpendicular width >= 2 x cutoff (:func:`check_cell`). Rows sorted
    ascending, pads (the row's own index) included, with the flat mirror
    permutation, as :func:`build_neighbor_list` gives them."""
    n = positions.shape[0]
    dev = positions.device
    dc = [positions[None, :, a] - positions[:, None, a] for a in range(3)]
    if cell is not None:
        dc = image_components(dc, cell, inverse_cell(cell))
    d2 = dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]
    rows = torch.arange(n, device=dev)
    keep = (d2 <= cutoff * cutoff) & (rows[None, :] != rows[:, None])
    big = torch.iinfo(torch.int64).max
    key = torch.sort(torch.where(keep, rows[None, :], big), dim=1).values[:, :max_neighbors]
    if key.shape[1] < max_neighbors:
        key = torch.cat([key, torch.full((n, max_neighbors - key.shape[1]), big, device=dev)], 1)
    idx = torch.sort(torch.where(key == big, rows[:, None], key), dim=1).values.to(torch.int32)
    return NeighborList(
        idx=idx,
        overflow=torch.max(torch.sum(keep, dim=1)) > max_neighbors,
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
    real=None,
    bin_capacity: int | None = None,
):
    """Cell-list build over bin-sorted atoms (the ``align_slots=False``
    branch of the JAX builder, without window worklists). The bin sort keeps
    every atom's neighbors close in memory, which the gathers of the K1 and
    K3 kernels rely on for cache reuse.

    `real`/`bin_capacity`: as in :func:`build_neighbor_list`. Non-real rows
    (the halo and slab padding of the sharded path) sort last, into the
    trash bin, and are excluded as centers and as neighbors."""
    with span("nl.build"):
        with span("nl.sort"):
            cl = cell_list(positions.contiguous(), cell.contiguous(), cutoff, grid, bin_capacity,
                           None if real is None else real.contiguous(), sort=True)
        idx, overflow = _rows(cl, cell, cutoff, max_neighbors, grid)
        order, inv_order = cl.order, cl.inv_order
        del cl  # the cell table ends with the rows: the mirror's sort may reuse its memory
        with span("nl.mirror"):
            mirror = mirror_permutation(idx)
    return SortedNeighborList(
        order=order,
        inv_order=inv_order,
        idx=idx,
        mirror=mirror,
        overflow=overflow,
        reference_positions=positions,
        reference_cell=cell,
    )
