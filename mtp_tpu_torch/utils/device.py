"""The device the port's entry points build on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a ``torch.device``. The entry points default to the card
    (``"cuda"``) and never fall back to the CPU: a CUDA device on a host
    without one raises, and CPU use passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
