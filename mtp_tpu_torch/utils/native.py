"""ctypes bindings for the native host library (``csrc/mtp_native.cpp``).

Port of ``mtp_tpu/utils/native.py``: the same C entry points, built from the
same source. The port writes nothing into ``csrc/``: it compiles the source
with the C++ compiler (``$CXX``, else ``g++``) and the ``CXXFLAGS`` of
``csrc/Makefile`` into ``build/native/`` at the repository root, under a
file name that carries a hash of the source and the flags. It compiles to a
private temporary name and renames the result into place, so processes that
build at once (test workers) never load a half-written library.

A build that fails raises. Only a host with no C++ compiler takes the NumPy
fallbacks; :func:`available` says which path runs (True: the library). A
compiler that cannot link OpenMP builds without ``-fopenmp`` (the source
guards its pragmas with ``_OPENMP``; the library then runs on one thread),
and :func:`build_flags` says so.

:func:`cell_list_host` refuses a cell narrower than twice the cutoff
(:func:`~mtp_tpu_torch.ops.neighbors.check_cell`) before the native code
runs: that code keeps one image per pair, so a smaller cell would lose the
other images (``mtp_tpu_torch.utils.golden.neighbor_vectors`` counts them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from mtp_tpu_torch.ops.neighbors import check_cell

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "csrc" / "mtp_native.cpp"
MAKEFILE = _REPO / "csrc" / "Makefile"
BUILD_DIR = _REPO / "build" / "native"

_lib = None  # the loaded library; False on a host with no C++ compiler


def compiler() -> Optional[str]:
    """The C++ compiler on ``PATH`` (``$CXX``, else ``g++``), or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def cxxflags() -> list:
    """The ``CXXFLAGS`` of ``csrc/Makefile``."""
    m = re.search(r"^CXXFLAGS\s*\?=\s*(.+)$", MAKEFILE.read_text(), re.M)
    if m is None:
        raise RuntimeError(f"no CXXFLAGS line in {MAKEFILE}")
    return m.group(1).split()


def build_flags(cxx: str) -> list:
    """The flags the library is built with: the Makefile's, without
    ``-fopenmp`` when `cxx` cannot link an empty shared library with it."""
    flags = cxxflags()
    if "-fopenmp" in flags:
        with tempfile.TemporaryDirectory() as tmp:
            probe = subprocess.run(
                [cxx, "-fopenmp", "-fPIC", "-shared", "-x", "c++", os.devnull,
                 "-o", os.path.join(tmp, "probe.so")],
                capture_output=True, timeout=60,
            )
        if probe.returncode != 0:
            flags = [f for f in flags if f != "-fopenmp"]
    return flags


def build(cxx: str) -> Path:
    """The library built from :data:`SOURCE` by `cxx` (reused if a build of
    the same source and flags exists). Raises if the compiler fails."""
    flags = build_flags(cxx)
    h = hashlib.sha256(" ".join([Path(cxx).name, *flags]).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libmtp_native_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([cxx, *flags, "-shared", "-o", tmp, str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed to build {SOURCE.name} ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None on a host with no C++
    compiler. Raises if the build fails."""
    global _lib
    if _lib is None:
        cxx = compiler()
        if cxx is None:
            _lib = False
        else:
            lib = ctypes.CDLL(str(build(cxx)))
            lib.mtp_cell_list.restype = ctypes.c_int
            lib.mtp_cell_list.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_double,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.mtp_format_cfg_atoms.restype = ctypes.c_int64
            lib.mtp_format_cfg_atoms.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_char_p,
                ctypes.c_int64,
            ]
            _lib = lib
    return _lib or None


def available() -> bool:
    """True when the native library runs, False when the NumPy fallbacks do
    (a host with no C++ compiler)."""
    return load() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def cell_list_host(positions, cell, cutoff, max_neighbors):
    """Host-side padded neighbor list. Native if available, NumPy otherwise.

    Returns (idx (n, max_neighbors) int32 self-padded, counts (n,), overflow).
    Raises ``ValueError`` for a cell whose perpendicular width is under
    2 * cutoff.
    """
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    check_cell(cell, cutoff)
    n = len(positions)
    lib = load()
    if lib is not None:
        idx = np.empty((n, max_neighbors), dtype=np.int32)
        counts = np.empty(n, dtype=np.int32)
        rc = lib.mtp_cell_list(
            _dptr(positions),
            n,
            _dptr(cell),
            float(cutoff),
            int(max_neighbors),
            _iptr(idx),
            _iptr(counts),
        )
        if rc < 0:
            raise ValueError("invalid cell matrix")
        return idx, counts, bool(rc)

    # NumPy fallback: O(N^2) minimum image
    inv = np.linalg.inv(cell)
    f = positions @ inv
    df = f[None, :, :] - f[:, None, :]
    df -= np.round(df)
    disp = df @ cell
    d2 = np.einsum("ija,ija->ij", disp, disp)
    np.fill_diagonal(d2, np.inf)
    keep = d2 <= cutoff * cutoff
    counts = keep.sum(axis=1).astype(np.int32)
    overflow = bool((counts > max_neighbors).any())
    idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, max_neighbors))
    for i in range(n):
        js = np.nonzero(keep[i])[0][:max_neighbors]
        idx[i, : len(js)] = js
    return idx, counts, overflow


def format_cfg_atoms(positions, types, grades=None, id_offset=0) -> str:
    """AtomData rows for a .cfg block (native fast path for large systems)."""
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    types = np.ascontiguousarray(types, dtype=np.int32)
    n = len(positions)
    lib = load()
    if lib is not None:
        g = (
            np.ascontiguousarray(grades, dtype=np.float64)
            if grades is not None
            else None
        )
        cap = 96 * n + 1024
        buf = ctypes.create_string_buffer(cap)
        w = lib.mtp_format_cfg_atoms(
            _dptr(positions),
            _iptr(types),
            _dptr(g) if g is not None else None,
            n,
            int(id_offset),
            buf,
            cap,
        )
        if w < 0:
            cap = -w + 1024
            buf = ctypes.create_string_buffer(cap)
            w = lib.mtp_format_cfg_atoms(
                _dptr(positions),
                _iptr(types),
                _dptr(g) if g is not None else None,
                n,
                int(id_offset),
                buf,
                cap,
            )
        return buf.raw[:w].decode()

    rows = []
    for i in range(n):
        row = f"{i + 1 + id_offset}\t{int(types[i])}\t{positions[i, 0]:.6f}\t{positions[i, 1]:.6f}\t{positions[i, 2]:.6f}"
        if grades is not None:
            row += f"\t{float(grades[i]):.5f}"
        rows.append(row)
    return "\n".join(rows) + ("\n" if rows else "")
