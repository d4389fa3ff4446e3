"""The MD step's per-atom work around the force call: the velocity-Verlet
kick and drift (K9) and the Verlet check's top-2 displacement rule (K10).

Neither replaces a Pallas kernel: in ``mtp_tpu`` the integrator and the
check are XLA code. On the card each is one launch of
``csrc/md_step.cu``, bit-equal to its plain twin here, in place of a chain
of elementwise and reduction launches (3 a half kick, 2 a drift, 14 the
check).

Each wrapper dispatches on the tensors' device: a CPU tensor goes to the
plain PyTorch twin (and counts ``plain_calls``), a CUDA tensor to the
kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from mtp_tpu_torch.kernels._build import LIBRARY, Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

K9 = Kernel(
    name="md_step",
    symbol="mtp_md_step",
    source="mtp_tpu_torch/csrc/md_step.cu",
    replaces="none: the integrator of mtp_tpu/md/integrators.py is XLA code",
    argtypes=(_I, _P, _P, _P, _P, _P, _P, _P, _P, _D, _D, _I, _I, _P),
)
K10 = Kernel(
    name="verlet_top2",
    symbol="mtp_verlet_top2",
    source="mtp_tpu_torch/csrc/md_step.cu",
    replaces="none: the Verlet check of mtp_tpu/md/simulation.py is XLA code",
    argtypes=(_P, _P, _P, _I, _P, ctypes.c_longlong, _P, _P, _P, _D, _I, _P),
)

_KICK, _DRIFT = 1, 2
_FLOATS = (torch.float32, torch.float64)
_INT_MAX = 2**31 - 1
# K10's scratch (its ticket and the blocks' partials) by (device, stream):
# the last block of a launch sets the ticket back to 0, so launches that
# follow one another on a stream share one buffer
_SCRATCH: dict = {}


def md_step_plain(positions, velocities, forces, masses, step=None, *, kick=None, drift=None):
    """Plain PyTorch twin of K9, in the kernel's operations and order."""
    K9.plain_calls += 1
    if kick is not None:
        velocities = velocities + kick * forces / masses[:, None]
    if drift is not None:
        positions = positions + drift * velocities
    if step is not None:
        step = step + 1
    return positions, velocities, step


def md_step(positions, velocities, forces, masses, step=None, *, kick=None, drift=None):
    """The kick ``v' = v + (kick * F) / m`` where `kick` is given, then the
    drift ``x' = x + drift * v'`` where `drift` is given, and ``step + 1``
    where `step` is given. Returns (positions, velocities, step), each the
    input where its part did not run, else a new tensor: the inputs are
    never written. The Python scalars are taken in the positions' type.

    positions, velocities, forces: (N, 3); masses: (N,), all of one type;
    step: an int64 scalar."""
    if positions.device.type == "cpu":
        return md_step_plain(positions, velocities, forces, masses, step, kick=kick,
                             drift=drift)
    mode = (_KICK if kick is not None else 0) | (_DRIFT if drift is not None else 0)
    if not mode:
        raise ValueError("md_step takes a kick, a drift or both")
    # written out, not as loops over the tensors: they run on every half step
    dtype, shape, device = positions.dtype, positions.shape, positions.device
    if (dtype not in _FLOATS or velocities.dtype != dtype or forces.dtype != dtype
            or masses.dtype != dtype):
        raise TypeError("md_step kernel takes float32 or float64 positions, velocities, "
                        "forces and masses of one type")
    if step is not None and step.dtype != torch.int64:
        raise TypeError("md_step kernel takes an int64 step")
    if (len(shape) != 2 or shape[1] != 3 or velocities.shape != shape or forces.shape != shape
            or masses.shape != shape[:1] or (step is not None and step.dim() != 0)
            or 3 * shape[0] > _INT_MAX
            or not (positions.is_contiguous() and velocities.is_contiguous()
                    and forces.is_contiguous() and masses.is_contiguous())
            or velocities.device != device or forces.device != device
            or masses.device != device or (step is not None and step.device != device)):
        raise ValueError("md_step kernel takes contiguous (N, 3) positions, velocities and "
                         "forces, (N,) masses and a scalar step on one device")
    n = shape[0]
    v_out = torch.empty_like(velocities) if mode & _KICK else velocities
    x_out = torch.empty_like(positions) if mode & _DRIFT else positions
    step_out = None if step is None else torch.empty_like(step)
    K9.launch(
        mode, positions.data_ptr(), velocities.data_ptr(), forces.data_ptr(),
        masses.data_ptr(), x_out.data_ptr(), v_out.data_ptr(),
        None if step is None else step.data_ptr(),
        None if step is None else step_out.data_ptr(),
        0.0 if kick is None else kick, 0.0 if drift is None else drift, 3 * n,
        int(dtype == torch.float64), torch.cuda.current_stream(device).cuda_stream,
    )
    return x_out, v_out, step_out


def verlet_top2_plain(positions, scaled_ref, real=None):
    """Plain PyTorch twin of K10's top two: (2,) [m1, m2], the port's only
    torch copy of the rule."""
    K10.plain_calls += 1
    d = positions - scaled_ref
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    if real is not None:
        d2 = torch.where(real, d2, 0.0)
    rows = torch.arange(d2.shape[0], device=d2.device)
    m2 = torch.max(torch.where(rows == torch.argmax(d2), 0.0, d2))
    return torch.stack([torch.max(d2), m2])


def verlet_check_plain(positions, scaled_ref, skin: float, flag, shrink=None, real=None):
    """Plain PyTorch twin of K10's staleness test (:func:`verlet_check`)."""
    m = verlet_top2_plain(positions, scaled_ref, real)
    s = torch.sqrt(m[0]) + torch.sqrt(m[1])
    if shrink is not None:
        s = s + shrink
    flag |= s > skin


def _top2(positions, scaled_ref, real, tops, flag, shrink, skin):
    """One K10 launch; writes `tops` and ORs into `flag`, either may be None."""
    dtype, shape, device = positions.dtype, positions.shape, positions.device
    if (dtype not in _FLOATS or scaled_ref.dtype != dtype
            or (shrink is not None and shrink.dtype != dtype)):
        raise TypeError("verlet_top2 kernel takes float32 or float64 positions, reference "
                        "and shrink of one type")
    if ((real is not None and real.dtype != torch.bool)
            or (flag is not None and flag.dtype != torch.bool)):
        raise TypeError("verlet_top2 kernel takes a bool real and a bool flag")
    if (len(shape) != 2 or shape[1] != 3 or scaled_ref.shape != shape
            or not 0 < 3 * shape[0] <= _INT_MAX
            or not (positions.is_contiguous() and scaled_ref.is_contiguous())
            or scaled_ref.device != device
            or (real is not None and (real.shape != shape[:1] or real.device != device
                                      or not real.is_contiguous()))
            or (flag is not None and (flag.dim() != 0 or flag.device != device))
            or (shrink is not None and (shrink.dim() != 0 or shrink.device != device))):
        raise ValueError("verlet_top2 kernel takes contiguous (N, 3) positions and reference "
                         "(N >= 1), an (N,) real and scalar flag and shrink on one device")
    n = shape[0]
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        size_fn = LIBRARY.get().mtp_verlet_top2_scratch_bytes
        size_fn.argtypes, size_fn.restype = (), ctypes.c_longlong
        scratch = _SCRATCH[key] = torch.zeros(size_fn(), dtype=torch.uint8, device=device)
    K10.launch(
        positions.data_ptr(), scaled_ref.data_ptr(), None if real is None else real.data_ptr(),
        n, scratch.data_ptr(), scratch.numel(), None if tops is None else tops.data_ptr(),
        None if flag is None else flag.data_ptr(),
        None if shrink is None else shrink.data_ptr(), float(skin), int(dtype == torch.float64),
        stream,
    )


def verlet_top2(positions, scaled_ref, real=None):
    """(2,) [m1, m2]: the largest and the second largest squared
    displacement ``(d0 d0 + d1 d1) + d2 d2`` of ``d = positions -
    scaled_ref`` over the rows where `real` holds (others count 0), with
    multiplicity (a tie gives m2 = m1; one row gives m2 = 0). NaN as
    ``torch.max`` and ``torch.argmax`` give it: one NaN d2 makes m1 NaN and
    m2 the largest other, two make both NaN."""
    if positions.device.type == "cpu":
        return verlet_top2_plain(positions, scaled_ref, real)
    tops = torch.empty(2, dtype=positions.dtype, device=positions.device)
    _top2(positions, scaled_ref, real, tops, None, None, 0.0)
    return tops


def verlet_check(positions, scaled_ref, skin: float, flag, shrink=None, real=None) -> None:
    """The Verlet staleness test of a step, OR-ed into the bool scalar
    `flag` in place: ``sqrt(m1) + sqrt(m2) + shrink > skin`` with
    :func:`verlet_top2`'s m1, m2 (`shrink` a scalar tensor, 0 when None;
    `skin` taken in the positions' type). A NaN leaves `flag` as it was."""
    if positions.device.type == "cpu":
        verlet_check_plain(positions, scaled_ref, skin, flag, shrink, real)
    else:
        _top2(positions, scaled_ref, real, None, flag, shrink, skin)
