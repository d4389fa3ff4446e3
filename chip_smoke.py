"""Smoke check of the PyTorch port (``mtp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Device: name, ``nvidia-smi`` name and power limit, TF32 pinned off.
2. Build: nvcc builds the four CUDA kernels from ``mtp_tpu_torch/csrc``.
3. Kernels against their plain PyTorch versions on an 864-atom two-species
   level-16 fcc box (positions jittered from a seed), in fp32 on the card;
   then the fp32 kernel path against the port's float64 plain path on the
   card (dE/atom < 1e-6 eV, max|dF| < 5e-4 eV/A, max|dW| < 5e-2 eV).
4. Main path: the ``bench.py`` configuration (level 16, 32,000 atoms, fp32,
   J = 64, skin 0.6): 60 NVE steps at steps_per_rebuild=10, then a timed
   ``run_async`` of 210 steps at steps_per_rebuild=30. Both flags clear,
   finite positions and energies, every kernel launched and no plain
   version called during the run.
5. Each kernel at the main path's shapes against its plain version, with
   its time and the plain version's time (CUDA events).

Prints one JSON line of kernels before the last line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the package is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0

# kernel vs plain version, fp32 on the card. The two sum in another order;
# the measured fp32-vs-float64 noise of the plain path at level 16 is ~5e-7 eV
# (site energies), ~1.2e-6 eV/A (pair forces), ~4e-6 eV/A (forces). K1 does the
# plain version's IEEE operations in its order, so it is expected exact.
TOL = {
    "window_disp": 1e-5,  # A
    "pair_forces_mega": 5e-5,  # eV/A
    "window_giveback": 1e-5,  # eV/A (same pair_T input; only the sum order differs)
    "site_energies_mega": 1e-5,  # eV
}
GATE_DE, GATE_DF, GATE_DW = 1e-6, 5e-4, 5e-2  # tools/tpu_smoke.py:76


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, reps):
    """Mean ms per call over `reps` calls, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def kernel_inputs(model, state_pos, cell, types, swl):
    """Sorted positions, the window constants and the kernels' inputs."""
    from mtp_tpu_torch.models.mtp import window_constants
    from mtp_tpu_torch.ops.window_disp import window_disp

    k = window_constants(model, types, swl)
    pos_s = state_pos[swl.order].contiguous()
    dispT = window_disp(pos_s, swl.idx, cell)
    d2 = dispT[0] * dispT[0] + dispT[1] * dispT[1] + dispT[2] * dispT[2]
    mask = ((d2 <= model.cutoff**2) & k["pair_valid_t"]).to(pos_s.dtype)
    args = (model.tables, dispT, mask, k["it_row"], k["jtypes_t"],
            model.coeffs.radial_coeffs, k["xi_full"])
    return pos_s, k, args


def compare_kernels(model, pos, cell, types, swl, timing):
    """Each kernel vs its plain version on the same inputs. Returns
    {name: (max_abs_err, ms, plain_ms)}."""
    from mtp_tpu_torch.ops import fused_moments as fm
    from mtp_tpu_torch.ops import window_disp as wd
    from mtp_tpu_torch.ops import window_giveback as wg

    pos_s, k, args = kernel_inputs(model, pos, cell, types, swl)
    pair_T = fm.pair_forces_mega(*args)
    calls = {
        "window_disp": (
            lambda: wd.window_disp(pos_s, swl.idx, cell),
            lambda: wd.window_disp_plain(pos_s, swl.idx, cell),
        ),
        "pair_forces_mega": (
            lambda: fm.pair_forces_mega(*args),
            lambda: fm.pair_forces_mega_plain(*args),
        ),
        "window_giveback": (
            lambda: wg.window_giveback(pair_T, swl.mirror),
            lambda: wg.window_giveback_plain(pair_T, swl.mirror),
        ),
        "site_energies_mega": (
            lambda: fm.site_energies_mega(*args, k["esp"]),
            lambda: fm.site_energies_mega_plain(*args, k["esp"]),
        ),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
        torch_sync()
        check(bool(got.isfinite().all()), f"{name}: non-finite kernel output")
        err = max_err(got, want)
        print(f"  {name}: max|kernel - plain| = {err:.3e} (tol {TOL[name]:.0e})")
        check(err <= TOL[name], f"{name} disagrees with its plain version")
        ms = plain_ms = None
        if timing:
            ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 3)
        out[name] = (err, ms, plain_ms)
    return out


def torch_sync():
    import torch

    torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "mtp_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: mtp_tpu_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.kernels import main_path_kernels, reset_counts
    from mtp_tpu_torch.kernels._build import LIBRARY
    from mtp_tpu_torch.md.simulation import Simulation, make_lattice
    from mtp_tpu_torch.md.state import init_state, kinetic_energy, thermalize
    from mtp_tpu_torch.models.mtp import (
        MTPModel,
        mtp_energy_forces,
        mtp_energy_forces_window,
        window_constants,
    )
    from mtp_tpu_torch.ops.neighbors import (
        build_neighbor_list,
        build_sorted_neighbor_list,
        grid_shape,
    )

    dev = torch.device("cuda", 0)
    card = smi()

    # ---- 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[1 device] nvidia-smi: {card}")
    print(f"[1 device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build
    t0 = time.perf_counter()
    LIBRARY.get()
    print(f"[2 build] {LIBRARY.path.name}: nvcc {LIBRARY.build_seconds} s, "
          f"load total {time.perf_counter() - t0:.2f} s")
    for line in LIBRARY.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[2 build]   {line.strip()}")

    # ---- 3. kernels vs plain versions, and fp32 kernels vs the f64 plain path
    m2 = make_mtp(16, species_count=2, seed=SEED)
    pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6), type_pattern=(0, 1))
    n = len(pos)
    pos = pos + np.random.default_rng(SEED).normal(0.0, 0.1, pos.shape)
    model32 = MTPModel.from_data(m2, device=dev, dtype=torch.float32)
    model64 = MTPModel.from_data(m2, device=dev, dtype=torch.float64)
    cut = model32.cutoff + 0.6
    grid = grid_shape(cell, cut)
    p32 = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    c32 = torch.as_tensor(cell, dtype=torch.float32, device=dev)
    ty = torch.as_tensor(types, dtype=torch.int32, device=dev)
    swl = build_sorted_neighbor_list(p32, c32, cut, max_neighbors=64, grid=grid)
    check(not bool(swl.overflow), "864-atom list overflow")
    print(f"[3 kernels] {n} atoms, level 16, 2 species, J=64, fp32: kernel vs plain")
    compare_kernels(model32, p32, c32, ty, swl, timing=False)

    out32 = mtp_energy_forces_window(
        model32, p32, c32, swl, compute_virial=True,
        **window_constants(model32, ty, swl),
    )
    p64 = p32.double()
    c64 = c32.double()
    nl64 = build_neighbor_list(p64, c64, cut, max_neighbors=64, grid=grid)
    check(not bool(nl64.overflow), "f64 list overflow")
    out64 = mtp_energy_forces(model64, p64, ty, nl64.idx, c64, nl64.mirror)
    de = abs(float(out32["energy"]) - float(out64["energy"])) / n
    df = max_err(out32["forces"], out64["forces"])
    dw = max_err(out32["virial"], out64["virial"])
    print(f"[3 kernels] fp32 kernel path vs f64 plain path: dE/atom={de:.3e} "
          f"(gate {GATE_DE:.0e}) max|dF|={df:.3e} (gate {GATE_DF:.0e}) "
          f"max|dW|={dw:.3e} (gate {GATE_DW:.0e})")
    check(de < GATE_DE and df < GATE_DF and dw < GATE_DW, "fp32 path vs f64 gate")

    # ---- 4. main path (bench.py configuration)
    m = make_mtp(16, species_count=1, seed=SEED)
    model = MTPModel.from_data(m, device=dev, dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (20, 20, 20))
    n = len(pos)
    state = init_state(pos, types, np.full(n, 58.693), cell, dtype=torch.float32, device=dev)
    state = thermalize(torch.Generator(device=dev).manual_seed(SEED), state, 300.0)
    eq = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                    compute_virial=False)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                     compute_virial=False)
    kernels = main_path_kernels()
    torch_sync()
    reset_counts()
    state, _, fl_eq = eq.run_async(state, 60, dt=0.001)
    e0 = state.potential_energy + kinetic_energy(state)
    torch_sync()
    t0 = time.perf_counter()
    state, _, fl, nl = sim.run_async(state, 210, dt=0.001, return_nl=True)
    torch_sync()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    plain = {k.name: k.plain_calls for k in kernels}
    e1 = state.potential_energy + kinetic_energy(state)
    print(f"[4 main path] {n} atoms, level 16, fp32, J=64: 60 steps (spb 10) + 210 "
          f"steps (spb 30)")
    print(f"[4 main path] flags: eq overflow={bool(fl_eq.overflow)} "
          f"stale={bool(fl_eq.stale)}; run overflow={bool(fl.overflow)} "
          f"stale={bool(fl.stale)}")
    check(not fl_eq.overflow and not fl_eq.stale, "equilibration flags set")
    check(not fl.overflow and not fl.stale, "main run flags set")
    check(bool(state.positions.isfinite().all()), "non-finite positions")
    check(bool(e0.isfinite()) and bool(e1.isfinite()), "non-finite energy")
    print(f"[4 main path] launches {launches}; plain calls {plain}")
    for k in kernels:
        check(k.launches > 0, f"{k.name} was not launched on the main path")
        check(k.plain_calls == 0, f"{k.name}'s plain version ran on the main path")
    drift = (float(e1) - float(e0)) / n
    rate = n * 210 / wall
    print(f"[4 main path] E_tot drift over 210 steps: {drift:.3e} eV/atom; "
          f"{rate:.1f} atom-steps/s ({wall:.3f} s wall) on {card}")

    # ---- 5. kernels at the main path's shapes
    print("[5 kernels] main-path shapes (32000 atoms, J=64, level 16), fp32")
    res = compare_kernels(model, state.positions, state.cell, state.types, nl, timing=True)
    rows = []
    for k in kernels:
        err, ms, plain_ms = res[k.name]
        print(f"  {k.name}: {ms:.4f} ms (plain {plain_ms:.4f} ms)")
        rows.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[k.name], max_abs_err=err, ms=ms, plain_ms=plain_ms,
        ))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
