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
train    coefficient fitting on energy/force data (``train.fit``: padded
         datasets, the linear warm start, Adam on the float64 plain path)
utils    units, weight, coefficient and integrator-state conversion from
         ``mtp_tpu``, the device profiler, the native host library
         (``native``: cell list, ``.cfg`` rows), the float64 golden engine
         (``golden``) and the accuracy gate (``python -m
         mtp_tpu_torch.utils.accuracy_gate``)

A short fit (``device="cpu"`` here; the default is the card)::

    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.io.cfg_file import read_cfgs
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.train.fit import fit, make_dataset

    m = make_mtp(8, seed=0)
    model = MTPModel.from_data(m, device="cpu", dtype=torch.float64)
    data = make_dataset(read_cfgs("train.cfg"), m.max_dist, max_neighbors=48, device="cpu")
    coeffs, losses = fit(model.schedule, model.coeffs, data, steps=60, learning_rate=1e-4)
"""

from mtp_tpu_torch.io.mtp_file import load_mtp, save_mtp  # noqa: F401
from mtp_tpu_torch.models.mtp import MTPCoeffs, MTPModel  # noqa: F401

__version__ = "0.1.0"
