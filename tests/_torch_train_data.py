"""The training fixture of ``tests/test_train.py``, shared by the port's
training and native-library tests: 12 configurations of the 108-atom fcc box
(3x3x3, a = 4.0) displaced by 0.02-0.07 A from a seed, labeled in float64 by
a level-8 'teacher' potential through ``mtp_tpu.utils.golden``."""

import numpy as np

from mtp_tpu.io.basis_gen import make_mtp
from mtp_tpu.io.cfg_file import Config
from mtp_tpu.md.simulation import make_lattice
from mtp_tpu.utils import golden


def teacher_configs(n_configs=12, labels=True):
    """(teacher MTPData, list of mtp_tpu Configs); without `labels` the
    configurations carry no energy or forces (no golden evaluation)."""
    m = make_mtp(8, species_count=1, seed=11)
    rng = np.random.default_rng(0)
    pos0, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    configs = []
    for k in range(n_configs):
        p = pos0 + rng.normal(scale=0.02 + 0.01 * (k % 6), size=pos0.shape)
        out = golden.compute(m, p, types, cell=cell) if labels else {}
        configs.append(Config(cell=cell, positions=p, types=types,
                              energy=out.get("energy"), forces=out.get("forces")))
    return m, configs
