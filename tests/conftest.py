"""Test configuration: run on CPU with 8 virtual devices (the TPU-world analog
of multi-node testing without a cluster; SURVEY.md §4) and float64 enabled so
golden-parity checks are exact."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# --xla_cpu_use_fusion_emitters=false: jax 0.9.0's new MLIR CPU fusion
# emitters spin for tens of minutes in LLVM on the df32 path's error-free-
# transform chains (one level-8 module measured >18 min -> 5 s with the
# legacy emitters; the hang sits between a fused kernel's ir-no-opt and
# ir-with-opt dumps). CPU-only flag; the TPU production path is unaffected.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
    + " --xla_cpu_use_fusion_emitters=false"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mtp_tpu.io.basis_gen import make_mtp  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips elsewhere"
    )


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop jit/compile caches after each test module.

    The suite compiles hundreds of distinct XLA programs (every Simulation
    backend/ensemble/mesh variant); holding all executables for the whole
    run accumulated >128 GB anon RSS on a 1-CPU host — the kernel OOM-killed
    one full run (dmesg) and a second died with a malloc-path segfault
    inside backend_compile_and_load at the same test. Per-module clearing
    bounds the footprint; cross-module recompiles are minimal because jit
    caches rarely hit across modules anyway (different models/shapes).
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def mtp_level8():
    return make_mtp(8, species_count=1, seed=0)


@pytest.fixture(scope="session")
def mtp_level8_2spec():
    return make_mtp(8, species_count=2, seed=3)


@pytest.fixture(scope="session")
def mtp_level12():
    return make_mtp(12, species_count=1, seed=1)


def scatter_cluster(n, rng, span=6.0, min_sep=1.8):
    """Random cluster with a minimum separation (avoids r=0 singularities)."""
    pos = rng.uniform(0, span, (n, 3))
    for _ in range(500):
        d = pos[:, None] - pos[None, :]
        dist = np.linalg.norm(d, axis=-1) + np.eye(n) * 100
        if dist.min() > min_sep:
            break
        i, j = divmod(dist.argmin(), n)
        pos[i] += 0.3 * (pos[i] - pos[j]) / dist[i, j]
    return pos


@pytest.fixture
def rng():
    return np.random.default_rng(42)
