"""Build and load the port's hand-written CUDA kernels.

All sources under ``mtp_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
Hopper (``sm_90a``) into ONE shared library with a plain C interface, loaded
with ``ctypes``. The build runs at first use, never at import (the CPU tests
import every module on a host with no ``nvcc``), into ``build/kernels/`` at
the repository root (listed in ``.gitignore``). The library's file name
carries a hash of the sources and flags, so an edited source rebuilds.

No ``--use_fast_math``: it changes ``sqrtf`` and division, and the energy gate
needs IEEE fp32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


class _Library:
    """The loaded kernel library, built on the first call of :meth:`get`."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.build_seconds = None  # None when an existing build was reused
        self.log = ""

    def get(self) -> ctypes.CDLL:
        if self.lib is None:
            self.path = self._build()
            self.lib = ctypes.CDLL(str(self.path))
        return self.lib

    def _build(self) -> Path:
        from torch.utils.cpp_extension import CUDA_HOME

        sources = sorted(CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sorted(CSRC.glob("*.cu*")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        out = BUILD_DIR / f"libmtp_kernels_{h.hexdigest()[:16]}.so"
        if out.exists():
            return out
        if CUDA_HOME is None:
            raise RuntimeError("no CUDA toolkit found: cannot build the kernels")
        nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [str(nvcc), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.log = res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{self.log}")
        os.replace(tmp, out)
        return out


LIBRARY = _Library()


class Kernel:
    """One CUDA kernel's C entry point and its counters.

    ``launches`` counts launches of the CUDA kernel (incremented only in
    :meth:`launch`); ``plain_calls`` counts calls of its plain PyTorch twin.
    Every argument is a Python int (pointers, the stream) or float; the C
    function returns ``cudaGetLastError()``, and a non-zero code raises.
    """

    def __init__(self, name: str, symbol: str, source: str, replaces: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.argtypes = argtypes
        self.launches = 0
        self.plain_calls = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(LIBRARY.get(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: error {err}")
        self.launches += 1
