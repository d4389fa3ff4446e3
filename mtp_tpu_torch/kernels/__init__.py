"""The port's hand-written CUDA kernels: build (``_build``) and registry.

Each kernel's wrapper lives beside its plain PyTorch twin in ``ops/``; this
module only lists them, in the order the main path runs them per step.
"""

from __future__ import annotations


def main_path_kernels():
    """The four kernels of the NVE main path: K1 window_disp, K2
    pair_forces_mega, K3 window_giveback (every step) and K4
    site_energies_mega (once per neighbor block)."""
    from mtp_tpu_torch.ops.fused_moments import K2, K4
    from mtp_tpu_torch.ops.window_disp import K1
    from mtp_tpu_torch.ops.window_giveback import K3

    return [K1, K2, K3, K4]


def reset_counts() -> None:
    for k in main_path_kernels():
        k.launches = 0
        k.plain_calls = 0
