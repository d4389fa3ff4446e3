"""The port's hand-written CUDA kernels: build (``_build``) and registry.

Each kernel's wrapper lives beside its plain PyTorch twin in ``ops/``; this
module only lists them: the main path's four force-path kernels in the order
it runs them per step, the kernel active learning adds, and all eleven (the
seven ports of the TPU kernels, the neighbor list's row phase, the MD
step's kick and drift and Verlet check, and the neighbor list's bin sort
and cell table).
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


def al_path_kernels():
    """The kernel the active-learning path adds to the main path's four: K5
    candidates_mega, once per grade step (with K1 and K3 around it)."""
    from mtp_tpu_torch.ops.fused_candidates import K5

    return [K5]


def all_kernels():
    """K1-K11 in order: the main path's four, K5, K6 basic_moments_fused with
    its vjp K7 (the modular path of ``ops/fused_basic.py``), K8
    neighbor_rows (once per neighbor-list build, on every path), K9 md_step
    (the kick and drift: twice a velocity-Verlet step), K10 verlet_top2
    (the Verlet check: once a step, on the sharded path and in FIRE too) and
    K11 cell_list (the bin sort and cell table: one call of its four
    kernels and a memset per neighbor-list build, on every path)."""
    from mtp_tpu_torch.ops.fused_basic import K6, K7
    from mtp_tpu_torch.ops.md_step import K9, K10
    from mtp_tpu_torch.ops.neighbors import K8, K11

    return main_path_kernels() + al_path_kernels() + [K6, K7, K8, K9, K10, K11]


def reset_counts() -> None:
    for k in all_kernels():
        k.launches = 0
        k.plain_calls = 0
