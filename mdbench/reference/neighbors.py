"""Pair search for the reference: a periodic cell list in plain PyTorch.

Every ordered pair (i, j), i != j, whose minimum-image distance is at most
``radius`` is returned with the integer image shift that makes
``x[j] - x[i] + shift @ cell`` its displacement. The shift stays valid while
atoms move and the cell deforms, so a list built at the cutoff plus a skin
serves several steps, as a Verlet list does. The cell has rows as its
vectors, and every plane spacing must hold at least three bins (the cell
list then never visits a bin twice, and the minimum image is unique).
"""

from __future__ import annotations

import dataclasses
import itertools

import torch


@dataclasses.dataclass
class PairList:
    i: torch.Tensor  # (P,) int64 centers, ascending
    j: torch.Tensor  # (P,) int64 neighbors
    shift: torch.Tensor  # (P, 3) image shifts in cell vectors (float, integral values)
    radius: float
    positions: torch.Tensor  # (N, 3) positions the list was built at

    def displacements(self, positions, cell):
        """(P, 3) displacements x_j - x_i + shift @ cell."""
        img = self.shift.to(positions.dtype)
        return positions[self.j] - positions[self.i] + _rows_times(img, cell.to(positions.dtype))


def _rows_times(x, m):
    """x @ m for (..., 3) rows and a (3, 3) matrix, as component sums."""
    return x[..., 0:1] * m[0] + x[..., 1:2] * m[1] + x[..., 2:3] * m[2]


def pair_list(positions, cell, radius: float, *, block: int = 8192) -> PairList:
    """All ordered pairs within `radius` (module docstring). Computed in
    float64 whatever the positions' dtype."""
    pos = positions.detach().to(torch.float64)
    h = cell.detach().to(torch.float64)
    dev = pos.device
    inv = torch.linalg.inv(h)
    frac = _rows_times(pos, inv)
    spacing = 1.0 / torch.linalg.vector_norm(inv, dim=0)
    nb = torch.floor(spacing / radius).to(torch.int64)
    if bool((nb < 3).any()):
        raise ValueError(f"cell too small for a cell list at radius {radius}: {spacing.tolist()}")
    cb = torch.floor((frac - torch.floor(frac)) * nb).to(torch.int64)
    cb = torch.minimum(cb, nb - 1)
    nbx, nby, nbz = nb.tolist()
    bid = (cb[:, 0] * nby + cb[:, 1]) * nbz + cb[:, 2]
    order = torch.argsort(bid, stable=True)
    counts = torch.bincount(bid, minlength=nbx * nby * nbz)
    start = torch.cumsum(counts, 0) - counts
    cap = int(counts.max())
    sb = bid[order]
    table = torch.full((nbx * nby * nbz, cap), -1, dtype=torch.int64, device=dev)
    table[sb, torch.arange(len(pos), device=dev) - start[sb]] = order
    offs = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)), device=dev)
    ii, jj, ss = [], [], []
    for a in range(0, len(pos), block):
        rows = torch.arange(a, min(a + block, len(pos)), device=dev)
        nc = (cb[rows, None, :] + offs) % nb
        cand = table[(nc[..., 0] * nby + nc[..., 1]) * nbz + nc[..., 2]].reshape(len(rows), -1)
        ok = (cand >= 0) & (cand != rows[:, None])
        r, c = torch.nonzero(ok, as_tuple=True)
        i, j = rows[r], cand[r, c]
        df = frac[j] - frac[i]
        shift = -torch.round(df)
        d = _rows_times(df + shift, h)
        near = torch.sum(d * d, dim=-1) <= radius * radius
        ii.append(i[near])
        jj.append(j[near])
        ss.append(shift[near])
    i, j, shift = torch.cat(ii), torch.cat(jj), torch.cat(ss)
    # frac holds unwrapped coordinates, so x_j - x_i + shift @ cell is the
    # displacement
    o = torch.argsort(i * len(pos) + j)
    return PairList(i=i[o], j=j[o], shift=shift[o], radius=float(radius), positions=pos)
