"""mtp_tpu_torch — the PyTorch + CUDA port of the ``mtp_tpu`` MD engine.

Mirrors ``mtp_tpu``'s layout module for module; the JAX package stays the
reference the port is tested against. This package imports ``torch`` and never
``jax``.

Subpackages
-----------
io       ``.mtp`` file format and basis-set generation (NumPy copies)
ops      Chebyshev basis, plain torch moments, neighbor lists, and the
         wrappers of the hand-written CUDA kernels (window_disp,
         fused_moments, window_giveback)
kernels  the nvcc build of ``csrc/*.cu`` and the per-kernel launch counters
models   the MTP model and its window-path energy/force evaluators
md       MD state, the NVE integrator and the simulation driver
utils    units, and weight conversion from a ``mtp_tpu`` model
"""

from mtp_tpu_torch.io.mtp_file import load_mtp, save_mtp  # noqa: F401
from mtp_tpu_torch.models.mtp import MTPCoeffs, MTPModel  # noqa: F401

__version__ = "0.1.0"
