"""Newton give-back: sorted-space forces from per-pair forces (K3).

Port of ``mtp_tpu/ops/window_giveback.py`` fused with the own-slot sum of
``mtp_tpu/models/mtp.py:404-425``: F[i] = sum_s (T[:, s, i] - T[mirror(i, s)]).
On the TPU the give-back needs octant-aligned slots (``slot_assign.py``,
``slot_repair.py``), band metadata (``giveback_metadata``) and a spill path,
because Mosaic has no atomics and no general 2-D in-VMEM gather. The CUDA
kernel (``csrc/window_giveback.cu``) reads the flat mirror permutation
directly, so none of those are ported.

:func:`window_giveback` dispatches on the tensor's device: a CPU tensor goes
to :func:`window_giveback_plain`, a CUDA tensor to the kernel (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from mtp_tpu_torch.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

K3 = Kernel(
    name="window_giveback",
    symbol="mtp_window_giveback",
    source="mtp_tpu_torch/csrc/window_giveback.cu",
    replaces="mtp_tpu/ops/window_giveback.py:173",
    argtypes=(_P, _P, _P, _I, _I, _P),
)


def window_giveback_plain(pair_T, mirror):
    """Plain PyTorch twin of K3: the flat-mirror form of
    ``mtp_tpu/models/mtp.py:417-425``. Masked slots of ``pair_T`` are zero and
    padding entries mirror among themselves, so no mask is applied."""
    K3.plain_calls += 1
    pair_t = pair_T.permute(2, 1, 0)  # (N, J, 3)
    t_ji = pair_t.reshape(-1, 3)[mirror.long()].reshape(pair_t.shape)
    return torch.sum(pair_t - t_ji, dim=1)  # (N, 3)


def window_giveback(pair_T, mirror):
    """Forces (N, 3) from pair forces pair_T (3, J, N) and the flat mirror
    permutation mirror (N*J,) int32 of the sorted-space neighbor list."""
    if pair_T.device.type == "cpu":
        return window_giveback_plain(pair_T, mirror)
    _, j, n = pair_T.shape
    if pair_T.dtype != torch.float32 or mirror.dtype != torch.int32:
        raise TypeError("window_giveback kernel takes float32 pair_T and int32 mirror")
    if mirror.shape != (n * j,) or not pair_T.is_contiguous() or not mirror.is_contiguous():
        raise ValueError("window_giveback kernel takes contiguous (3, J, N) and (N*J,)")
    out = torch.empty((n, 3), dtype=torch.float32, device=pair_T.device)
    K3.launch(
        pair_T.data_ptr(), mirror.data_ptr(), out.data_ptr(), n, j,
        torch.cuda.current_stream(pair_T.device).cuda_stream,
    )
    return out
