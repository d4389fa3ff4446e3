"""The JAX package's four user workflows (``examples/*.py``) on the port.

Each module's ``main()`` takes its sizes, its device and its output
directory as keyword arguments, with the JAX example's sizes as defaults,
and runs on the card unless it is given ``device="cpu"``. MD runs in fp32
on the card (the kernels' precision) and in float64 on the CPU (the JAX
examples' precision); training and the
candidate vectors of an MVS run on the float64 plain path. Outputs go to
`out_dir`, by default ``build/examples/<name>/`` in the checkout.
"""

from __future__ import annotations

from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def output_dir(name: str, out_dir=None) -> Path:
    """`out_dir`, or ``build/examples/<name>`` in the checkout; created."""
    path = Path(out_dir) if out_dir is not None else ROOT / "build" / "examples" / name
    path.mkdir(parents=True, exist_ok=True)
    return path


def md_dtype(device):
    """The MD precision: fp32 on the card and float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
