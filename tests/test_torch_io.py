"""The port's host modules against mtp_tpu's: the no-jax import rule, and
byte-identical `.mtp` files from the NumPy copies of mtp_file and basis_gen."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mtp_tpu.io import basis_gen as bg_jax
from mtp_tpu.io import mtp_file as mf_jax
from mtp_tpu.utils import units as units_jax
from mtp_tpu_torch.io import basis_gen as bg_t
from mtp_tpu_torch.io import mtp_file as mf_t
from mtp_tpu_torch.utils import units as units_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIALECT = os.path.join(REPO, "tests", "data", "mlip3_dialect_level8.mtp")

_TABLES = (
    "species_count", "scaling", "min_dist", "max_dist", "radial_basis_size",
    "radial_funcs_count", "radial_basis_type", "radial_coeffs",
    "alpha_moments_count", "alpha_index_basic", "alpha_index_times",
    "alpha_moment_mapping", "species_coeffs", "moment_coeffs",
    "potential_name", "potential_tag",
)


def _assert_same_data(a, b):
    for name in _TABLES:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


def test_import_leaves_jax_out():
    """`import mtp_tpu_torch` (every module of the main path, and the root
    chip_smoke.py) must not import jax. A subprocess: this test process
    already has jax loaded."""
    code = (
        "import sys\n"
        "import mtp_tpu_torch\n"
        "import mtp_tpu_torch.md.simulation, mtp_tpu_torch.utils.convert\n"
        "import mtp_tpu_torch.kernels, mtp_tpu_torch.ops.neighbors\n"
        "import mtp_tpu_torch.utils.prof, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mtp_tpu' or m.startswith('mtp_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "level,species,seed", [(8, 1, 0), (8, 2, 3), (12, 1, 1), (16, 1, 0), (16, 2, 0)]
)
def test_make_mtp_byte_identical(level, species, seed):
    a = bg_jax.make_mtp(level, species_count=species, seed=seed)
    b = bg_t.make_mtp(level, species_count=species, seed=seed)
    _assert_same_data(a, b)
    assert mf_jax.dumps_mtp(a) == mf_t.dumps_mtp(b)


def test_mlip3_dialect_file_parity():
    with open(DIALECT, "rb") as f:
        raw = f.read()
    a = mf_jax.loads_mtp(raw)
    b = mf_t.loads_mtp(raw)
    _assert_same_data(a, b)
    assert mf_jax.dumps_mtp(a) == mf_t.dumps_mtp(b)


def test_roundtrip_with_mvs(tmp_path):
    """The MVS trailer survives save/load and matches mtp_tpu's bytes."""
    rng = np.random.default_rng(7)
    m = bg_t.make_mtp(8, species_count=2, seed=3)
    p = m.coeff_count
    a = rng.normal(size=(p, p))
    m.mvs = mf_t.MVSData(
        energy_weight=0.0, force_weight=0.01, stress_weight=0.0,
        site_en_weight=1.0, weight_scaling=2.0,
        active_set=a, inverse_active_set=np.linalg.inv(a),
    )
    path = str(tmp_path / "p.mtp")
    mf_t.save_mtp(path, m)
    back = mf_t.load_mtp(path)
    _assert_same_data(m, back)
    np.testing.assert_array_equal(back.mvs.active_set, a)
    assert mf_jax.dumps_mtp(mf_jax.load_mtp(path)) == mf_t.dumps_mtp(back)


def test_units_match():
    for name in ("KB", "MVV2E", "FTM2A", "EVA3_TO_BAR"):
        assert getattr(units_t, name) == getattr(units_jax, name)
