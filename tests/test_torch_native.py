"""The port's host utilities against ``mtp_tpu``'s: the native library
(``utils/native.py``: cell list, ``.cfg`` row formatter, its build), the
``.cfg`` writer's fast path, the golden engine's copy (``utils/golden.py``)
and the accuracy gate (``utils/accuracy_gate.py``) on the CPU.

The native tests skip only on a host with no C++ compiler; a build that
fails fails them. Tolerances: cell lists, ``.cfg`` text and the golden
copy are equal; the gate at 108 atoms is held to its own gates.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _torch_threads import _one_intra_op_thread  # noqa: F401
from _torch_train_data import teacher_configs

from mtp_tpu.io import cfg_file as cfg_jax
from mtp_tpu.io.basis_gen import make_mtp as make_mtp_jax
from mtp_tpu.md.simulation import make_lattice
from mtp_tpu.utils import golden as golden_jax
from mtp_tpu.utils import native as native_jax
from mtp_tpu_torch.io import cfg_file as cfg_t
from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.utils import accuracy_gate
from mtp_tpu_torch.utils import golden
from mtp_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def lib():
    """The port's native library; skips only where no C++ compiler is on
    PATH (a failed build raises)."""
    if native.compiler() is None:
        pytest.skip("no C++ compiler on PATH: the NumPy fallbacks run")
    lib = native.load()
    assert lib is not None and native.available()
    return lib


def _triclinic_box(rng, n=300, L=18.0):
    cell = np.array([[L, 0, 0], [1.5, L, 0], [0.5, -1.0, L]])
    return rng.uniform(0, L, (n, 3)), cell


def test_cell_list_matches_bruteforce(lib, rng):
    """The twin of ``test_native.py``'s."""
    pos, cell = _triclinic_box(rng)
    n, cutoff = len(pos), 4.0
    idx, counts, ovf = native.cell_list_host(pos, cell, cutoff, 64)
    assert not ovf

    inv = np.linalg.inv(cell)
    f = pos @ inv
    df = f[None] - f[:, None]
    df -= np.round(df)
    disp = df @ cell
    d2 = np.einsum("ija,ija->ij", disp, disp)
    np.fill_diagonal(d2, np.inf)
    keep = d2 <= cutoff**2
    for i in range(n):
        assert set(int(j) for j in idx[i] if j != i) == set(np.nonzero(keep[i])[0].tolist())
    np.testing.assert_array_equal(counts, keep.sum(axis=1))


def test_cell_list_overflow_flag(lib, rng):
    """The twin of ``test_native.py``'s."""
    pos = rng.uniform(0, 10.0, (100, 3))
    _, counts, ovf = native.cell_list_host(pos, np.eye(3) * 10.0, 4.0, 2)
    assert ovf and counts.max() > 2


def test_format_cfg_atoms_matches_python(lib, rng, monkeypatch):
    """The twin of ``test_native.py``'s: the library's rows equal the NumPy
    fallback's, byte for byte."""
    pos = rng.uniform(0, 5, (7, 3))
    types = rng.integers(0, 2, 7).astype(np.int32)
    grades = rng.uniform(0, 3, 7)
    s = native.format_cfg_atoms(pos, types, grades)
    lines = s.strip().split("\n")
    assert len(lines) == 7
    first = lines[0].split("\t")
    assert first[0] == "1"
    assert int(first[1]) == types[0]
    assert float(first[2]) == pytest.approx(pos[0, 0], abs=1e-6)
    assert float(first[5]) == pytest.approx(grades[0], abs=1e-5)
    monkeypatch.setattr(native, "_lib", False)
    assert not native.available()
    assert native.format_cfg_atoms(pos, types, grades) == s


def _jax_native_matches(pos, cell, cutoff, j):
    """The port's cell list against the JAX package's on the same inputs:
    equal when the reference's library loaded; the same neighbor sets when
    its worker fell back to NumPy (its build races, see ROADMAP.md)."""
    got = native.cell_list_host(pos, cell, cutoff, j)
    want = native_jax.cell_list_host(pos, cell, cutoff, j)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    if native_jax.available():
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_array_equal(np.sort(got[0], axis=1), np.sort(want[0], axis=1))


def test_cell_list_matches_jax_native(lib, rng):
    """The fixture's 12 configurations (J = 48) and a triclinic box."""
    m, configs = teacher_configs(labels=False)
    for c in configs:
        _jax_native_matches(c.positions, c.cell, m.max_dist, 48)
    _jax_native_matches(*_triclinic_box(rng), 4.0, 64)


@pytest.mark.parametrize("with_lib", [True, False], ids=["native", "numpy"])
def test_cell_list_refuses_small_cells(with_lib, monkeypatch):
    """A 2x2x2 fcc box (8 A) at the level-8 cutoff (5 A): JAX's native code
    keeps one image per pair; the port raises before it runs, on either
    path."""
    if not with_lib:
        monkeypatch.setattr(native, "_lib", False)
    pos, _, cell = make_lattice("fcc", 4.0, (2, 2, 2))
    idx, _, _ = native_jax.cell_list_host(pos, cell, 5.0, 64)
    assert idx.shape == (32, 64)
    with pytest.raises(ValueError, match="2\\*cutoff"):
        native.cell_list_host(pos, cell, 5.0, 64)


def test_numpy_fallback_without_a_compiler(lib, rng, monkeypatch):
    """With no compiler on PATH the fallback runs and ``available()`` says
    so; its lists hold the library's neighbors."""
    pos, cell = _triclinic_box(rng, n=120)
    want = native.cell_list_host(pos, cell, 4.0, 64)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert not native.available()
    got = native.cell_list_host(pos, cell, 4.0, 64)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(np.sort(got[0], axis=1), np.sort(want[0], axis=1))


def test_concurrent_builds_leave_one_library(lib, tmp_path):
    """Three processes build into one empty directory at once: each loads a
    whole library, and one file is left, named by the source hash."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from mtp_tpu_torch.utils import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "pos = np.random.default_rng(0).uniform(0, 10.0, (50, 3))\n"
        "idx, counts, ovf = native.cell_list_host(pos, np.eye(3) * 10.0, 4.0, 64)\n"
        "assert native.available() and not ovf and counts.sum() > 0\n"
    )
    env = {"PYTHONPATH": str(REPO), "PATH": os.environ["PATH"]}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    left = sorted(f.name for f in tmp_path.iterdir())
    assert left == [native.build(native.compiler()).name], left


def test_failed_build_raises(lib, tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build(native.compiler())
    assert list((tmp_path / "out").iterdir()) == []


@pytest.mark.parametrize("kind", ["grades", "plain", "triclinic"])
def test_cfg_fast_path_matches_python_and_jax(kind, rng, monkeypatch):
    """``format_cfg`` without forces: the same bytes through the library and
    through the fallback, and the JAX writer's bytes."""
    n = 9
    cell = np.diag([7.0, 8.0, 9.0])
    if kind == "triclinic":
        cell[1, 0], cell[2, 1] = 1.3, -0.7
    pos = rng.uniform(0, 7, (n, 3))
    types = rng.integers(0, 3, n).astype(np.int32)
    kw = dict(max_grade=2.5)
    if kind != "plain":
        kw["grades"] = rng.uniform(0, 3, n)
    want = cfg_jax.format_cfg(cell, pos, types, **kw)
    monkeypatch.setattr(native, "_lib", None)
    fast = cfg_t.format_cfg(cell, pos, types, **kw)
    monkeypatch.setattr(native, "_lib", False)
    slow = cfg_t.format_cfg(cell, pos, types, **kw)
    assert fast == slow == want


def test_golden_copy_matches_jax():
    """The port's golden engine gives the reference's numbers exactly on a
    two-species 108-atom box, candidate vectors included."""
    kw = dict(species_count=2, seed=3)
    m_j, m_t = make_mtp_jax(8, **kw), make_mtp(8, **kw)
    pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3), type_pattern=(0, 1))
    pos = pos + np.random.default_rng(5).normal(0, 0.05, pos.shape)
    a = golden_jax.compute(m_j, pos, types, cell, compute_grades=True)
    b = golden.compute(m_t, pos, types, cell, compute_grades=True)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)


def _reference_tree():
    return ast.parse((REPO / "tools" / "accuracy_gate.py").read_text())


def _reference_cfg():
    """``CFG`` of ``tools/accuracy_gate.py``, read from its source."""
    node = next(a.value for a in _reference_tree().body if isinstance(a, ast.Assign)
                and getattr(a.targets[0], "id", None) == "CFG")
    return {k.arg: ast.literal_eval(k.value) for k in node.keywords}


def _reference_gate_keys():
    """The keys of the JSON that ``tools/accuracy_gate.py``'s ``run_fp32``
    prints (read from its source, which imports jax)."""
    fn = next(f for f in _reference_tree().body
              if isinstance(f, ast.FunctionDef) and f.name == "run_fp32")
    call = next(c for c in ast.walk(fn) if isinstance(c, ast.Call)
                and getattr(c.func, "id", None) == "dict")
    return {k.arg for k in call.keywords}


@pytest.mark.parametrize("fp32_plain", [True, False], ids=["fp32_plain", "window_path"])
def test_accuracy_gate_on_the_cpu(fp32_plain):
    """The gate's function at 108 atoms on the CPU (fp32 on the plain path
    or on the window path's plain twins, against float64): the reference's
    keys, its gates met, no device memory reported."""
    result, stats = accuracy_gate.run(reps=(3, 3, 3), device="cpu", fp32_plain=fp32_plain)
    assert set(result) == _reference_gate_keys()
    assert result["n_atoms"] == 108
    assert accuracy_gate.failed_gates(result) == [], result
    assert 0 < result["max_abs_dF"] and result["force_scale_rms"] > 0.1
    assert stats["oracle_peak_bytes"] is None and stats["oracle_ms"] > 0


def test_accuracy_gate_takes_a_shared_oracle():
    """Both fp32 sides can share one float64 oracle: the gate run on the
    oracle's (ref, stats) gives the result and stats of a run that computes
    its own."""
    f64 = accuracy_gate.oracle(reps=(3, 3, 3), device="cpu")
    for fp32_plain in (True, False):
        shared, stats = accuracy_gate.run(reps=(3, 3, 3), device="cpu",
                                          fp32_plain=fp32_plain, f64=f64)
        own, _ = accuracy_gate.run(reps=(3, 3, 3), device="cpu", fp32_plain=fp32_plain)
        assert shared == own and stats is f64[1]


def test_gate_positions_match_the_reference():
    """The configuration of ``tools/accuracy_gate.py``: its lattice and
    draws, rounded to fp32 once."""
    pos, types, cell = accuracy_gate.config_positions((3, 3, 3))
    p0, t0, c0 = make_lattice("fcc", 4.0, (3, 3, 3))
    want = (p0 + np.random.default_rng(0).normal(scale=0.07, size=p0.shape))
    np.testing.assert_array_equal(pos, want.astype(np.float32).astype(np.float64))
    np.testing.assert_array_equal(types, t0)
    np.testing.assert_array_equal(cell, np.asarray(c0, np.float32).astype(np.float64))
    assert accuracy_gate.CFG == _reference_cfg()


def test_compiler_without_openmp_builds_without_it(lib, tmp_path, monkeypatch):
    """A compiler whose ``-fopenmp`` cannot link (a toolchain without
    libgomp) builds the library without the flag; the library works."""
    fake = tmp_path / "cxx"
    fake.write_text(f'#!/bin/sh\ncase " $* " in *" -fopenmp "*) '
                    f'echo "cannot read spec file libgomp.spec" >&2; exit 1;; esac\n'
                    f'exec {native.compiler()} "$@"\n')
    fake.chmod(0o755)
    assert "-fopenmp" in native.cxxflags()
    flags = native.build_flags(str(fake))
    assert flags == [f for f in native.cxxflags() if f != "-fopenmp"]
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "compiler", lambda: str(fake))
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    idx, counts, ovf = native.cell_list_host(np.eye(3) * 2.0, np.eye(3) * 10.0, 4.0, 8)
    assert not ovf and counts.tolist() == [2, 2, 2]
