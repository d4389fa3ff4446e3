"""Per-pair displacements dispT (3, J, N) over bin-sorted atoms (K1).

Port of ``mtp_tpu/ops/window_disp.py``. On the TPU the gather runs through
per-tile chunk worklists (`worklists`, `pad_window_lists`), because Mosaic has
no general in-VMEM gather. The CUDA kernel (``csrc/window_disp.cu``) is a
direct indexed gather from the neighbor list, so the worklists are not ported.

:func:`window_disp` dispatches on the tensor's device: a CPU tensor goes to
the plain PyTorch version :func:`window_disp_plain`, a CUDA tensor to the
kernel (or the wrapper raises).
"""

from __future__ import annotations

import ctypes

import torch

from mtp_tpu_torch.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

K1 = Kernel(
    name="window_disp",
    symbol="mtp_window_disp",
    source="mtp_tpu_torch/csrc/window_disp.cu",
    replaces="mtp_tpu/ops/window_disp.py:121",
    argtypes=(_P, _P, _P, _P, _I, _I, _P),
)


def inverse_cell(cell):
    """Inverse of a (3, 3) cell without a host sync (``inv_ex`` reports
    singularity in a tensor instead of raising)."""
    return torch.linalg.inv_ex(cell).inverse


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


def window_disp_plain(positions, idx, cell):
    """Plain PyTorch twin of K1: ``minimum_image(x[idx] - x[i])`` as (3, J, N)."""
    K1.plain_calls += 1
    disp = positions[idx.long()] - positions[:, None, :]
    disp = minimum_image(disp, cell, inverse_cell(cell))
    return disp.permute(2, 1, 0).contiguous()


def window_disp(positions, idx, cell):
    """dispT (3, J, N) = minimum-imaged x[idx[i, s]] - x[i].

    positions: (N, 3) bin-sorted; idx: (N, J) int32 sorted-space neighbor
    list (padding entries = own row, giving disp 0); cell: (3, 3).
    """
    if positions.device.type == "cpu":
        return window_disp_plain(positions, idx, cell)
    n, j = idx.shape
    if positions.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("window_disp kernel takes float32 positions and int32 idx")
    if positions.shape != (n, 3) or not positions.is_contiguous() or not idx.is_contiguous():
        raise ValueError("window_disp kernel takes contiguous (N, 3) positions and (N, J) idx")
    cell18 = torch.cat([cell.reshape(-1), inverse_cell(cell).reshape(-1)]).to(torch.float32)
    out = torch.empty((3, j, n), dtype=torch.float32, device=positions.device)
    K1.launch(
        positions.data_ptr(), idx.data_ptr(), cell18.data_ptr(), out.data_ptr(),
        n, j, torch.cuda.current_stream(positions.device).cuda_stream,
    )
    return out
