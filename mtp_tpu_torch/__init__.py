"""mtp_tpu_torch — the PyTorch + CUDA port of the ``mtp_tpu`` MD engine.

Mirrors ``mtp_tpu``'s layout module for module; the JAX package stays the
reference the port is tested against. This package imports ``torch`` and never
``jax``.

Subpackages
-----------
io       ``.mtp``, ``.cfg`` and LAMMPS data file formats and basis-set
         generation (NumPy copies)
ops      Chebyshev basis, plain torch moments, neighbor lists, and the
         wrappers of the hand-written CUDA kernels (window_disp,
         fused_moments, fused_candidates, fused_basic, window_giveback)
kernels  the nvcc build of ``csrc/*.cu`` and the per-kernel launch counters
models   the MTP model and its window-path energy/force evaluators
md       MD state, the integrators (NVE, NVT, Langevin, MTK NPT), the
         simulation driver, FIRE minimization, thermo/XYZ/checkpoint output
al       MaxVol extrapolation grades, active-set construction and MD
         with grade evaluation (active learning)
utils    units, weight and integrator-state conversion from ``mtp_tpu``,
         the device profiler
"""

from mtp_tpu_torch.io.mtp_file import load_mtp, save_mtp  # noqa: F401
from mtp_tpu_torch.models.mtp import MTPCoeffs, MTPModel  # noqa: F401

__version__ = "0.1.0"
