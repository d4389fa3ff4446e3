"""The window path's pair geometry (K1): minimum-imaged displacements dispT
(3, J, N) and the pair mask maskf (J, N) over bin-sorted atoms.

Port of ``mtp_tpu/ops/window_disp.py`` together with the mask of
``mtp_tpu/models/mtp.py:396-400``. On the TPU the gather runs through
per-tile chunk worklists (`worklists`, `pad_window_lists`), because Mosaic has
no general in-VMEM gather. The CUDA kernel (``csrc/window_disp.cu``) is a
direct indexed gather from the transposed neighbor list, so the worklists
are not ported; it computes the cell's inverse itself, in the closed form of
:func:`inverse_cell`, and the mask beside the displacements.

:func:`window_geometry` dispatches on the tensor's device: a CPU tensor goes
to the plain PyTorch version :func:`window_geometry_plain`, a CUDA tensor to
the kernel (or the wrapper raises).
"""

from __future__ import annotations

import ctypes

import torch

from mtp_tpu_torch.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

K1 = Kernel(
    name="window_disp",
    symbol="mtp_window_geometry",
    source="mtp_tpu_torch/csrc/window_disp.cu",
    replaces="mtp_tpu/ops/window_disp.py:121",
    argtypes=(_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _P),
)


def inverse_cell(cell):
    """Inverse of a (3, 3) cell in closed form, in the K1 kernel's operation
    order: adjugate A[r][k] = C[k+1][r+1] C[k+2][r+2] - C[k+1][r+2]
    C[k+2][r+1] (indices mod 3) over det = (C00 A00 + C01 A10) + C02 A20,
    each entry one IEEE division. Elementwise operations on (3, 3) tensors
    only (about ten launches on the card): no LAPACK call, no host sync."""

    def rolled(a, b):  # rolled(a, b)[r, k] = C[k + a][r + b]
        return torch.roll(cell, shifts=(-a, -b), dims=(0, 1)).T

    adj = rolled(1, 1) * rolled(2, 2) - rolled(1, 2) * rolled(2, 1)
    p = cell[0] * adj[:, 0]  # C0k A_k0
    return adj / ((p[0] + p[1]) + p[2])


def cell_product(x, m):
    """``x @ m`` for row vectors given as their three components (x, y, z)
    and a (3, 3) matrix, unrolled in the operation order of
    ``mtp_tpu/models/mtp.py:106-116``; returns the three components.

    Every Cartesian/fractional conversion of the port goes through here, so
    the neighbor build, the staleness check and the plain twin of K1 share
    one order of operations. Components, not a stacked (..., 3) tensor: the
    neighbor build's candidate filter would pay a stack copy per product.
    """
    return [x[0] * m[0, a] + x[1] * m[1, a] + x[2] * m[2, a] for a in range(3)]


def image_components(d, cell, inv_cell):
    """Minimum image of displacements given as their three components.

    The K1 kernel repeats this order with non-contracted IEEE operations, so
    the two agree bit for bit. ``torch.round`` rounds half to even, as
    ``jnp.round`` does.
    """
    f = cell_product(d, inv_cell)
    return cell_product([fa - torch.round(fa) for fa in f], cell)


def minimum_image(disp, cell, inv_cell):
    """Wrap displacement vectors (..., 3) to the nearest periodic image."""
    return torch.stack(image_components(disp.unbind(-1), cell, inv_cell), dim=-1)


def window_geometry_plain(positions, idx_t, cell, pair_valid_t, cutoff):
    """Plain PyTorch twin of K1: (dispT, maskf), in the kernel's operations
    and order."""
    K1.plain_calls += 1
    pos_t = positions.T  # (3, N)
    nb = idx_t.long()
    d = [pos_t[a][nb] - pos_t[a][None, :] for a in range(3)]  # (J, N) each
    r = image_components(d, cell, inverse_cell(cell))
    d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    # the Python scalar is compared in the tensor's dtype, as the kernel's
    # float cut2 is
    maskf = ((d2 <= cutoff * cutoff) & pair_valid_t).to(positions.dtype)
    return torch.stack(r), maskf


def window_geometry(positions, idx_t, cell, pair_valid_t, cutoff: float):
    """dispT (3, J, N) = minimum-imaged x[idx_t[s, i]] - x[i], and maskf
    (J, N) = (|dispT|^2 <= cutoff^2) & pair_valid_t as 0/1 in the positions'
    dtype, with |d|^2 = (d0 d0 + d1 d1) + d2 d2.

    positions: (N, 3) bin-sorted; idx_t: (J, N) int32 transposed sorted-space
    neighbor list (padding entries = own row, giving disp 0); cell: (3, 3);
    pair_valid_t: (J, N) bool (a rebuild constant: not a pad, and the center
    counts)."""
    if positions.device.type == "cpu":
        return window_geometry_plain(positions, idx_t, cell, pair_valid_t, cutoff)
    j, n = idx_t.shape
    if (positions.dtype != torch.float32 or cell.dtype != torch.float32
            or idx_t.dtype != torch.int32 or pair_valid_t.dtype != torch.bool):
        raise TypeError("window_geometry kernel takes float32 positions and cell, int32 "
                        "idx_t and bool pair_valid_t")
    if (positions.shape != (n, 3) or cell.shape != (3, 3) or pair_valid_t.shape != (j, n)
            or not all(t.is_contiguous() for t in (positions, idx_t, cell, pair_valid_t))):
        raise ValueError("window_geometry kernel takes contiguous (N, 3) positions, (J, N) "
                         "idx_t and pair_valid_t, and a (3, 3) cell")
    disp = torch.empty((3, j, n), dtype=torch.float32, device=positions.device)
    maskf = torch.empty((j, n), dtype=torch.float32, device=positions.device)
    K1.launch(
        positions.data_ptr(), idx_t.data_ptr(), pair_valid_t.data_ptr(), cell.data_ptr(),
        disp.data_ptr(), maskf.data_ptr(), n, j, cutoff * cutoff,
        torch.cuda.current_stream(positions.device).cuda_stream,
    )
    return disp, maskf
