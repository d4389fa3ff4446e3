"""Newton give-back: sorted-space forces from per-pair forces (K3).

Port of ``mtp_tpu/ops/window_giveback.py`` fused with the own-slot sum of
``mtp_tpu/models/mtp.py:404-425``: F[i] = sum_s (T[:, s, i] - T[mirror(s, i)]).
On the TPU the give-back needs octant-aligned slots (``slot_assign.py``,
``slot_repair.py``), band metadata (``giveback_metadata``) and a spill path,
because Mosaic has no atomics and no general 2-D in-VMEM gather. The CUDA
kernel (``csrc/window_giveback.cu``) gathers the mirrored pair force through
``mirror_t`` (:func:`mirror_offsets`), so none of those are ported.

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


def mirror_offsets(mirror, n: int, j: int):
    """mirror_t (J, N) int32 from the flat mirror permutation (N*J,) of an
    (N, J) list: slot s of atom i mirrors slot sq of atom iq, and mirror_t[s,
    i] = sq * N + iq, its flat offset into one (J, N) plane of pair_T
    (3, J, N). A rebuild constant."""
    q = mirror.long().view(n, j)
    return ((q % j) * n + q // j).T.contiguous().to(torch.int32)


def window_giveback_plain(pair_T, mirror_t):
    """Plain PyTorch twin of K3: ``mtp_tpu/models/mtp.py:417-425`` on the
    (3, J, N) layout. Masked slots of ``pair_T`` are zero and padding
    entries mirror among themselves, so no mask is applied."""
    K3.plain_calls += 1
    t_ji = pair_T.reshape(3, -1)[:, mirror_t.long()]  # (3, J, N)
    return torch.sum(pair_T - t_ji, dim=1).T.contiguous()  # (N, 3)


def window_giveback(pair_T, mirror_t):
    """Forces (N, 3) from pair forces pair_T (3, J, N) and the mirror
    offsets mirror_t (J, N) int32 of :func:`mirror_offsets`."""
    if pair_T.device.type == "cpu":
        return window_giveback_plain(pair_T, mirror_t)
    _, j, n = pair_T.shape
    if pair_T.dtype != torch.float32 or mirror_t.dtype != torch.int32:
        raise TypeError("window_giveback kernel takes float32 pair_T and int32 mirror_t")
    if mirror_t.shape != (j, n) or not pair_T.is_contiguous() or not mirror_t.is_contiguous():
        raise ValueError("window_giveback kernel takes contiguous (3, J, N) and (J, N)")
    out = torch.empty((n, 3), dtype=torch.float32, device=pair_T.device)
    K3.launch(
        pair_T.data_ptr(), mirror_t.data_ptr(), out.data_ptr(), n, j,
        torch.cuda.current_stream(pair_T.device).cuda_stream,
    )
    return out
