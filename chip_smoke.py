"""Smoke check of the PyTorch port (``mtp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Device: name, ``nvidia-smi`` name and power limit, TF32 pinned off.
2. Build: nvcc builds the eight CUDA kernels from ``mtp_tpu_torch/csrc``.
3. Kernels against their plain PyTorch versions on an 864-atom two-species
   level-16 fcc box (positions jittered from a seed), in fp32 on the card
   (K1's displacements and mask bit for bit); then the fp32 kernel path
   against the port's float64 plain path on the card (dE/atom < 1e-6 eV,
   max|dF| < 5e-4 eV/A, max|dW| < 5e-2 eV).
4. Main path: the ``bench.py`` configuration (level 16, 32,000 atoms, fp32,
   J = 64, skin 0.6): 60 NVE steps at steps_per_rebuild=10, then a timed
   ``run_async`` of 210 steps at steps_per_rebuild=30. Both flags clear,
   finite positions and energies, every kernel launched and no plain
   version called during the run: K9 twice a step, K10 once, K8 and K11
   once a rebuild.
5. Each kernel at the main path's shapes against its plain version, with
   its time and the plain version's time (CUDA events), its bound (the
   larger of its bytes over 3.35 TB/s and its fp32 operations on these
   inputs over 67 TFLOP/s) and what bounds it, its launches per main-path
   step and its share of the bound; the fused kernels' device time by
   stage kernel (``torch.profiler``: ``float_kernel`` for the specialised
   float stages, ``pair_kernel`` for the General ones) and the stage
   kernels' resident warps per SM (the float stages and K5's double ones),
   K2's and K4's in their kernels-line rows. The stage split runs
   right after phase 7: a profiler session slows the host-bound runs that
   follow it in the same process, and phase 7 times two of them against
   each other; a window that loses kernel events fails the run.
5b. The neighbor list's bin sort and cell table (K11) and row phase (K8)
   on the jittered fcc box at a = 3.8 A of 32,000 and of 131,072 atoms
   (cutoff + skin 5.6 A, J = 64): K11's outputs bit-equal to its plain
   twin's, K8's rows and largest count to its twin's on K11's bin-sorted
   rows, and a whole sorted build with the kernels bit-equal (rows, mirror,
   order) to one with K8's twin and to one with K11's; each kernel's ms and
   its twin's, its bound (K8: 45 operations a candidate test; both: every
   input and output byte once) and share of it (device ms from the stage
   split), one call of each per build, and the build's ms and peak device
   memory with the kernels and with K8's twin.
5c. The MD step's kernels, K9 md_step (the kick and drift, and the closing
   kick with the step count) and K10 verlet_top2 (the Verlet check), on
   random fp32 arrays of 32,000 and 131,072 atoms: outputs bit-equal to
   their plain twins; their ms and the plain chains' ms, their bound (bytes:
   every input and output once) and share of it (device ms from the stage
   split); phase 4 checks 2 K9 and 1 K10 launches a step and no twin call.
6. Active-learning kernels on the phase-3 box, with an MVS state built by
   ``build_mvs`` from float64 plain candidate vectors of perturbed copies:
   K5 against its plain twin on every output, K6 and K7 (through the autograd
   backward) against theirs, and the fp32 model's window grade step (K1,
   K5 in float64, K3) against the float64 plain path (b, grades, forces,
   energy; tolerances and their reasons at the top of this file).
7. The AL path at full width (``bench_suite.py`` configuration 4b): level
   16, one species, an MVS from three perturbed 4,000-atom boxes, the
   32,000-atom box equilibrated 60 steps, then ``run_with_extrapolation`` for
   120 NVE steps graded every 30 (5 grade steps, the initial one included)
   and the same 120 steps of plain ``run_async``, both warmed up once and
   timed in turns over three rounds. K5 launched 5 times in the first,
   K1-K4 launched, no plain twin called. Then the modular energy path
   (``site_energies_fused``: K6 forward, K7 backward) drives K6 and K7 once
   each, and K5, K6 and K7 at these shapes are held against their plain
   versions and timed, with their device time by stage kernel and the
   resident warps per SM of K5's stages, K6's basic stage and K7's tail.

8. Ensembles (after phase 7 and phase 5's stage split). (a) The
   phase-3 box: 20 NPT steps from one state on the fp32 kernel path
   (``Simulation.run_async``) and on the float64 plain path (``npt_step``
   over ``mtp_energy_forces``), held to max|dx|, the cell and the
   barostat's strain rate (gates at the top of this file); the fp32
   per-atom virial against the float64 one, and its sum against the
   virial. (b) At phase 4's width from its equilibrated state: NVE with
   the virial off and on, NVT, Langevin and NPT-tri for 60 steps, NPT-iso
   for 120 at the box's own initial pressure; a first pass checks each
   run and counts its launches, then three rounds time the runs in turns.
   Each prints its median atom-steps/s and its rounds, the kernel launches
   per step, its flags and the conserved quantity's drift per atom; the
   virial's cost is the median over the rounds of NVE's step time with it
   on minus off. Every ``Simulation.steps`` block runs under
   ``torch.cuda.set_sync_debug_mode("error")``, so a step that reads the
   device from the host fails. (c) ``Simulation.run`` from J = 32 grows J
   until the list fits and finishes. (d) FIRE on the 32,000-atom lattice
   rattled by 0.05 A to ftol 1e-2 eV/A or 200 iterations. (e)
   ``run_with_extrapolation`` under NPT for 60 steps graded every 30 on
   phase 7's MVS, launching K5 once per grade step.

3b. Oracle repeatability (after phase 3): the float64 plain path
   (``mtp_energy_forces`` and ``al.grades.candidate_vectors``) twice on the
   phase-3 box; energy, site energies, forces, virial and candidate vectors
   must be bit-equal (``torch.equal``).

9. Training and the lifecycle at full width (level 16, float64 on the
   card): 96 configurations of the 108-atom fcc box labeled by a level-16
   teacher on the plain path (two cross-checked against
   ``mtp_tpu_torch.utils.golden``), ``make_dataset`` (J = 48),
   ``linear_warm_start`` and 30 ``fit`` steps of a level-16 student from
   its minted coefficients at lr 1e-4 (from the warm start Adam raises the
   loss, in the JAX fit as in the port); every loss finite, the last below
   the first, no kernel launched during the fit; the first 2 steps on 8
   configurations give the card's losses on the CPU too. Then the
   student's MVS from its float64 candidate vectors of the training set,
   ``save_mtp`` with the MVS, ``MTPModel.load`` in fp32,
   and ``run_with_extrapolation`` under NVT at 600 K on the 864-atom box
   (200 steps, graded every 20) writing the graded configurations to a
   ``.cfg`` through the native row formatter, read back; K1-K5 launched, no
   plain twin called.
10. The accuracy gate at 32,000 atoms (``mtp_tpu_torch.utils.accuracy_gate``):
   the fp32 kernel path against the float64 plain path on the card, held to
   the gates of phase 3, and the plain fp32 path beside it (the rounding
   floor), both against one oracle, with its time and peak device memory.
11. The sharded path (``mtp_tpu_torch.parallel``). (a) A world of one NCCL
   rank at the main path's width, from phase 4's state:
   ``ShardedSimulation.run_async`` and the single-device
   ``Simulation.run_async``, 60 NVE steps each, in turns over three rounds
   (atom-steps/s of both); positions and forces of the two compared; the
   kernel path's energy, forces and virial at the final positions held to
   phase 3's gates against the float64 plain path; K1-K4 launched and no plain
   twin called; a 10-step block under
   ``torch.cuda.set_sync_debug_mode("error")``; the device's idle share of one
   traced block. (b) The same box as 2 slabs on 2 rank processes sharing the
   card (``--sharded-rank``, gloo with the messages staged through host
   memory, ``Comm(transport="gloo-staged")``, a time limit of its own): NVE
   for 2 blocks of 30 steps, atoms migrating, then one ``grade_eval`` with
   phase 7's MVS (K5), its forces, energy and virial held to phase 3's gates
   and its grades to phase 6's against the float64 plain path, and against the
   single-device port at the same positions; the halo size, the migration
   counts and ms per step. Each rank then holds K1-K5 against their plain
   twins on its own block rows (N = C + 2H, padding rows in the trash bin,
   ghost rows masked as centers), at the kernel rows' limits, and K11
   bit-equal to its plain twin on the rank's extended set (its trash bin
   holding the padding rows) with the rebuild's order.

12. The long narrow box (``mtp_tpu_torch.parallel.sharded_md``'s
   row-gather API on the one sharded engine): the level-16 fp32 model on
   fcc 500 x 4 x 4 cells (32,000 atoms, 2,000 x 16 x 16 A, 300 K), a grid
   of (357, 2, 2) bins at cutoff + skin.
   (a) A world of one NCCL rank: ``make_sharded_md_block`` NVE and NVT, 6
   blocks of 10 steps each from the fresh 300 K lattice, beside
   ``Simulation.run_async`` in six calls of 10 from the same state; NVE
   bit-equal, NVT within ``nvt_dx_limit`` (each coordinate to the larger
   of 1e-4 A and one fp32 spacing of the reference coordinate) and phase
   3's force gate; K1-K4 launched,
   no plain twin called; ms per step and atom-steps/s of both; an NVE
   block under the sync debugger; the energy, forces and virial of
   ``compute_sharded_forces`` at the final positions held to phase 3's
   gates against the float64 plain path. (b) 2 gloo rank processes on the
   card (``mtp_tpu_torch.parallel.launch``, staged transport), slabs along
   x: 3 NVE blocks of 10 steps, then 3 NVT, then ``make_sharded_grades``
   and the monitor's standalone engine with phase 7's MVS, and the window
   engine's grade pass at the same positions; its energy, forces and
   virial held to phase 3's gates, and the grades of both engines to phase
   6's, against the float64 plain path; besides, the standalone grades
   within phase 6's gate of the window engine's per atom and within 1e-3
   in the max grade. A witness of where fp32 grade error comes from: the
   fp32 plain path's grades against float64 at these positions and
   translated by -1000 A along x, by tenth of the box along x (printed, not
   gated). K1-K5 launched with no plain call, then held against their
   plain twins on each rank's rows. Then
   ``mtp_tpu_torch.examples.accuracy_validation.main()`` at its default
   size. The phase must take under a minute.

Prints one JSON line of the ensembles' numbers, one of the sharded path,
one of the long box, one of training and the gate, then one of all ten
kernels (with their launch counts in phases 11 and 12 and their errors on
the rank rows of 11b and 12b), before the last line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the package is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0

# kernel vs plain version, fp32 on the card. The two sum in another order;
# the measured fp32-vs-float64 noise of the plain path at level 16 is ~5e-7 eV
# (site energies), ~1.2e-6 eV/A (pair forces), ~4e-6 eV/A (forces). K1 does the
# plain version's IEEE operations in its order, so its displacements (A) and
# mask must be bit-equal.
TOL = {
    "window_disp": 0.0,
    "pair_forces_mega": 5e-5,  # eV/A
    "window_giveback": 1e-5,  # eV/A (same pair_T input; only the sum order differs)
    "site_energies_mega": 1e-5,  # eV
}
GATE_DE, GATE_DF, GATE_DW = 1e-6, 5e-4, 5e-2  # tools/tpu_smoke.py:76
# K5 vs its plain twin on the card, both in float64 from fp32 inputs: site
# energies and pair forces (rounded to fp32) as K4 and K2; basis members and
# radial rows relative to their largest entry, at what float64 gives: the
# two sum in other orders, 1.4e-15 and 6.7e-16 measured on an H100 (3-6e-7
# while K5 ran in fp32, so a K5 that slipped into fp32 fails); K6 in fp32
# relative to its largest entry; K7 (the gradient of the modular energy
# path) against K2's plain twin as K2.
TOL_K5 = {"site_e": 1e-5, "pair_tT": 5e-5, "basis_members": 1e-10, "rad": 1e-10}
K5_RELATIVE = ("basis_members", "rad")
TOL_K6_REL, TOL_K7 = 1e-5, 5e-5
# fp32 window grade step vs the float64 plain path. b: max|db|/max|b| (1.6e-6
# measured on an H100). Grades: max|dg| over the largest grade, and the max
# grade's relative error. The MVS built here has cond(A) ~ 8e7 (build_mvs
# prices the structural null directions of b at 1/reg), so fp32 rounding of
# b is amplified: rounding the float64 b to fp32 alone moves grades by
# 5.5e-4 of the max grade, and the kernel path by 1.2e-3 (the max grade by
# 4e-5) while K5 ran in fp32, measured on an H100; on phase 12's long box
# with phase 7's MVS the fp32 K5 reached 9.8e-3, so K5 now computes in
# float64 and its b is not rounded. Each run prints the rounding floor of b
# beside the error.
GATE_B_REL, GATE_GRADE_REL, GATE_MAX_GRADE_REL = 1e-5, 1e-2, 1e-3
# phase 12b: the window engine's grades vs float64, max|dg|/max g, measured
# on an H100 (NVIDIA H100 80GB HBM3, 700 W) with K5's double stages on their
# General instantiations; printed beside each run's value (the specialised
# stages change the order of K5's sums only)
GRADE_REL_12B_GENERAL = 4.943e-4
# phase 8a: 20 NPT steps, fp32 kernel path vs float64 plain path on the
# phase-3 box: max|dx| [A], the cell relative to its largest entry, and the
# barostat strain rate relative to its largest magnitude over the f64 run
# (1.9e-5 A, 5.3e-7 and 2.4e-6 measured on an H100; the gates started at
# 1e-4, 1e-5 and 1e-3). The per-atom virial, max|dvatom| in eV (4.5e-6
# measured), and its sum against the f64 virial, held to GATE_DW as the
# virial is (6.3e-5 measured).
GATE_NPT_DX, GATE_NPT_CELL, GATE_NPT_BV, GATE_VATOM = 5e-5, 5e-6, 5e-5, 5e-5
# H100 SXM peaks (NVIDIA's data sheet): fp32 and fp64 outside the tensor
# cores, HBM3
PEAK_FLOPS, PEAK_FLOPS_F64, PEAK_BYTES = 67e12, 34e12, 3.35e12


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


def kernel_work(name, model, n, j, live):
    """(flops, bytes) of one call of kernel `name` on these inputs: every
    input read once and every output written once; the fp32 operations the
    function needs (an FMA is 2), not those the kernel happens to do. Per
    live pair (`live` pairs with mask > 0) each quantity is counted once:
    the geometry, the Chebyshev values (and derivatives), f_mu (and f'_mu),
    each distinct monomial of rank >= 2 as a lower one times a unit-vector
    component (1), the B moment FMAs, and the force tail grouped by monomial
    (G_t and G'_t per term, P, Q and D_a per monomial, D_a from the lower
    monomials already built). Per atom each DAG product once forward (a
    multiply and an FMA, 3) and once in reverse (mult * dm once, two FMAs,
    5). K1 and K3 are elementwise."""
    from mtp_tpu_torch.ops.fused_moments import monomials

    if name == "window_disp":
        # per pair: 3 subtractions, two 3x3 products, 3 rint and subtractions,
        # |d|^2 and the test; per call the closed-form inverse. Reads
        # positions, idx_t, pair_valid_t (1 byte) and the cell; writes dispT
        # and maskf
        return 45 * j * n + 41, 12 * n + 4 * j * n + j * n + 36 + 12 * j * n + 4 * j * n
    if name == "window_giveback":  # T(own) - T(mirror), summed; pair_T, mirror_t, forces
        return 6 * j * n, 12 * j * n + 4 * j * n + 12 * n
    s = model.schedule
    B, M, MU, RB = (s.basic_count, s.alpha_moments_count, s.radial_funcs_count,
                    s.radial_basis_size)
    S, n_scal, P = s.species_count, len(s.mapping), model.tables.n_prod
    monos = monomials(s.max_rank)
    NT = len(monos)
    # D_a += G_t * (alpha_a * U_(t - e_a)): an FMA, and a multiply when alpha_a > 1
    d_terms = sum(2 + (a > 1) for m in monos for a in m if a)
    geo = 16  # d2 5, sqrt, 1/d, u 3, ksi 3, d - hi, envelope 2
    cheb = 2 + 2 * (RB - 2)  # ksi * env, 2 ksi, an FMA per further value
    values = geo + cheb + 2 * MU * RB + (NT - 4)  # geometry, f_mu, monomials
    basic = values + MU + 2 * B  # f_mu * w, the moment FMAs
    deriv = 7 + 5 * (RB - 2) + 2 * MU * RB  # Chebyshev derivatives, f'_mu
    contract = 4 * B + 2 * NT + 3 * (NT - 1) + d_terms + 14  # G, G'; P, Q, D; T
    gmu_rad = 2 * B + RB + 2 * MU * RB  # K5: Gmu, w * cheb_r, the radial rows
    fwd, readout, rev = 3 * P, 2 * n_scal + 1, M + 5 * P
    pairs_in = 20 * j * n + 4 * n  # dispT, mask, jtypes_t; itypes
    return {
        "pair_forces_mega": (live * (basic + deriv + contract) + n * (fwd + rev),
                             pairs_in + 12 * j * n),
        "site_energies_mega": (live * basic + n * (fwd + readout), pairs_in + 8 * n),
        "basic_moments_fused": (live * basic, pairs_in + 4 * B * n),
        "basic_moments_vjp": (live * (values + deriv + contract),
                              pairs_in + 4 * B * n + 12 * j * n),
        "candidates_mega": (
            live * (basic + deriv + contract + gmu_rad) + n * (fwd + readout + rev),
            pairs_in + 8 * n + 8 * n * (n_scal + S * MU * RB) + 12 * j * n,  # b in float64
        ),
    }[name]


def bound(name, model, n, j, live):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type (K5's are float64)."""
    flops, nbytes = kernel_work(name, model, n, j, live)
    peak = PEAK_FLOPS_F64 if name == "candidates_mega" else PEAK_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_row(kern, launches, err, ms, plain_ms, model, n, j, live):
    bound_ms, bound_by = bound(kern.name, model, n, j, live)
    return dict(
        name=kern.name, route="cuda", source=kern.source, replaces=kern.replaces,
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,  # no single PyTorch call computes these
    )


def device_share(row, dev_ms):
    """Set a kernels-line row's device ms (from `stage_ms`, which fails on
    an empty window) and share of its bound; returns the share as text."""
    row["device_ms"] = dev_ms
    row["share"] = row["bound_ms"] / dev_ms
    return f"{row['share']:.1%}"


def kernel_inputs(model, state_pos, cell, types, swl):
    """Sorted positions, the window constants and the kernels' inputs, the
    geometry from the force path's own preamble (K1)."""
    from mtp_tpu_torch.models.mtp import _window_geometry, window_constants

    k = window_constants(model, types, swl)
    pos_s = state_pos[swl.order].contiguous()
    dispT, mask = _window_geometry(model, pos_s, cell, swl, k["idx_t"], k["pair_valid_t"], True)
    args = (model.tables, dispT, mask, k["it_row"], k["jtypes_t"],
            model.coeffs.radial_coeffs, k["xi_full"])
    return pos_s, k, args


def window_kernel_calls(model, pos_s, cell, k, args):
    """{name: (kernel call, plain call)} of K1-K4 on one set of sorted rows
    `pos_s` with its window constants `k` and the kernels' inputs `args`."""
    from mtp_tpu_torch.ops import fused_moments as fm
    from mtp_tpu_torch.ops import window_disp as wd
    from mtp_tpu_torch.ops import window_giveback as wg

    pair_T = fm.pair_forces_mega(*args)
    geo = (pos_s, k["idx_t"], cell, k["pair_valid_t"], model.cutoff)
    return {
        "window_disp": (
            lambda: wd.window_geometry(*geo),
            lambda: wd.window_geometry_plain(*geo),
        ),
        "pair_forces_mega": (
            lambda: fm.pair_forces_mega(*args),
            lambda: fm.pair_forces_mega_plain(*args),
        ),
        "window_giveback": (
            lambda: wg.window_giveback(pair_T, k["mirror_t"]),
            lambda: wg.window_giveback_plain(pair_T, k["mirror_t"]),
        ),
        "site_energies_mega": (
            lambda: fm.site_energies_mega(*args, k["esp"]),
            lambda: fm.site_energies_mega_plain(*args, k["esp"]),
        ),
    }


def hold(name, kern, plain, tag="  "):
    """Kernel `name` against its plain version on the same inputs, held to
    TOL[name]; returns (max_abs_err, the kernel's output)."""
    got, want = kern(), plain()
    torch_sync()
    # K1 returns (dispT, maskf): every output is held to the tolerance
    gots, wants = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    check(all(bool(g.isfinite().all()) for g in gots), f"{name}: non-finite kernel output")
    errs = [max_err(g, w) for g, w in zip(gots, wants)]
    err = max(errs)
    print(f"{tag}{name}: max|kernel - plain| = {' and '.join(f'{e:.3e}' for e in errs)} "
          f"(tol {TOL[name]:.0e})")
    check(err <= TOL[name], f"{name} disagrees with its plain version")
    return err, got


def hold_k5(model, k, args, tag="  "):
    """K5 against its plain twin on every output, each held to TOL_K5, and
    the candidate vectors placed from both to GATE_B_REL; returns the
    largest absolute error over the outputs."""
    from mtp_tpu_torch.al.grades import _place_blocks
    from mtp_tpu_torch.ops import fused_candidates as fc

    got = fc.candidates_mega(*args, k["esp"])
    want = fc.candidates_mega_plain(*args, k["esp"])
    torch_sync()
    errs = {}
    for key, tol in TOL_K5.items():
        check(bool(got[key].isfinite().all()), f"candidates_mega {key}: non-finite")
        e = rel_err(got[key], want[key]) if key in K5_RELATIVE else max_err(got[key], want[key])
        errs[key] = max_err(got[key], want[key])
        kind = "relative" if key in K5_RELATIVE else "abs"
        print(f"{tag}candidates_mega {key}: {kind} err {e:.3e} (tol {tol:.0e})")
        check(e <= tol, f"candidates_mega {key} disagrees with its plain version")
    s = model.schedule.species_count
    b_k = _place_blocks(got["rad"], k["it_row"], got["basis_members"], s)
    b_p = _place_blocks(want["rad"], k["it_row"], want["basis_members"], s)
    eb = rel_err(b_k, b_p)
    print(f"{tag}candidates_mega b: max|db|/max|b| = {eb:.3e} (gate {GATE_B_REL:.0e})")
    check(eb <= GATE_B_REL, "candidate vectors from K5 disagree with the plain twin's")
    return max(errs.values())


def compare_kernels(model, pos, cell, types, swl, timing):
    """Each kernel vs its plain version on the same inputs. Returns
    ({name: (max_abs_err, ms, plain_ms)}, live pairs, {entry point: call});
    the kernels are timed, and the calls for `stage_ms` returned, only with
    `timing`."""
    import torch

    from mtp_tpu_torch.models.mtp import _window_geometry
    from mtp_tpu_torch.ops import fused_basic as fb
    from mtp_tpu_torch.ops import fused_moments as fm
    from mtp_tpu_torch.ops import window_giveback as wg

    pos_s, k, args = kernel_inputs(model, pos, cell, types, swl)
    pair_T = fm.pair_forces_mega(*args)
    out = {}
    for name, (kern, plain) in window_kernel_calls(model, pos_s, cell, k, args).items():
        err, _ = hold(name, kern, plain)
        ms = plain_ms = None
        if timing:
            ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 3)
        out[name] = (err, ms, plain_ms)
    stage_calls = {}
    if timing:
        from mtp_tpu_torch.ops import fused_candidates as fc

        gamma = torch.rand((model.schedule.basic_count, pos_s.shape[0]), device=pos_s.device)
        stage_calls = {
            "pair_forces_mega": lambda: fm.pair_forces_mega(*args),
            "site_energies_mega": lambda: fm.site_energies_mega(*args, k["esp"]),
            "basic_moments_fused": lambda: fb.basic_moments_fused(*args[:6]),
            "basic_moments_vjp": lambda: fb.basic_moments_vjp(*args[:6], gamma),
            "candidates_mega": lambda: fc.candidates_mega(*args, k["esp"]),
            # everything the force path's geometry does on the device
            "window_disp": lambda: _window_geometry(model, pos_s, cell, swl, k["idx_t"],
                                                    k["pair_valid_t"], True),
            "window_giveback": lambda: wg.window_giveback(pair_T, k["mirror_t"]),
        }
    return out, float(args[2].sum()), stage_calls


_STAGES = {"pair_kernel": ("basic", "tail", "tail + radial rows"),
           "dag_kernel": ("DAG forward + readout", "DAG forward + reverse",
                          "DAG forward + readout + reverse")}


def stage_ms(calls, reps=10):
    """{entry point: {stage kernel: device ms per call}}, each entry point's
    from one torch.profiler window of `reps` calls after a warm-up call.
    Fails if a window recorded no kernel, or a kernel a number of times that
    is not a multiple of `reps` (events lost: a profiler session late in a
    long process once recorded half of them, or none)."""
    import re

    import torch

    from mtp_tpu_torch.utils.prof import _device_us, trace

    out = {}
    for label, fn in calls.items():
        fn()
        torch_sync()
        with trace() as prof:
            for _ in range(reps):
                fn()
            torch_sync()
        per, counts = {}, {}
        for evt in prof.key_averages():
            us = _device_us(evt)
            if evt.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
                continue
            counts[evt.key] = evt.count
            # pair_kernel<General, stage, type> (every schedule without a
            # specialised shape), float_kernel<shape, stage> (the specialised
            # float stages), cand_kernel<shape, stage> (K5's specialised
            # shapes, double), dag_kernel<mode, staged, type>
            m = re.search(r"pair_kernel<.*, (\d), (float|double)>\(", evt.key)
            f = re.search(r"float_kernel<.*, (\d)>\(", evt.key)
            c = re.search(r"cand_kernel<.*, (\d)>\(", evt.key)
            d = re.search(r"dag_kernel<(\d), \w+, (float|double)>", evt.key)
            k = re.search(r"(\w+(<[^()]*>)?)\(", evt.key)  # a kernel's name, template included
            name = (f"{_STAGES['pair_kernel'][int(m.group(1))]} ({m.group(2)}, General)" if m else
                    f"{_STAGES['pair_kernel'][int(f.group(1))]} (float, specialised)" if f else
                    f"{_STAGES['pair_kernel'][int(c.group(1))]} (double, specialised)" if c else
                    f"{_STAGES['dag_kernel'][int(d.group(1))]} ({d.group(2)})" if d else
                    k.group(1)[-40:] if k else evt.key[:40])
            per[name] = per.get(name, 0.0) + us / reps / 1e3
        check(bool(per) and all(c % reps == 0 for c in counts.values()),
              f"{label}: the profiler window of {reps} calls recorded "
              f"{ {key[-60:]: c for key, c in counts.items()} }")
        out[label] = per
    return out


def print_stages(tag, stages):
    for label, per in stages.items():
        parts = " + ".join(f"{name} {ms:.4f}" for name, ms in per.items())
        print(f"[{tag} stages] {label}: {parts} = {sum(per.values()):.4f} ms on the device")


def torch_sync():
    import torch

    torch.cuda.synchronize()


def rel_err(a, b):
    return max_err(a, b) / float(b.double().abs().max())


def compare_al_kernels(model, pos, cell, types, swl, timing):
    """K5, K6 and K7 vs their plain versions on the same inputs. Returns
    {name: (max_abs_err, ms, plain_ms)}; K5's error is its largest over the
    four outputs, each of which is checked against its tolerance."""
    import torch

    from mtp_tpu_torch.ops import fused_basic as fb
    from mtp_tpu_torch.ops import fused_candidates as fc
    from mtp_tpu_torch.ops import fused_moments as fm

    _, k, args = kernel_inputs(model, pos, cell, types, swl)
    e5 = hold_k5(model, k, args)
    mb = fb.basic_moments_fused(*args[:6])
    mb_plain = fb.basic_moments_fused_plain(*args[:6])
    e6 = rel_err(mb, mb_plain)
    print(f"  basic_moments_fused: relative err {e6:.3e} (tol {TOL_K6_REL:.0e})")
    check(e6 <= TOL_K6_REL, "basic_moments_fused disagrees with its plain version")
    # K7 through the autograd backward of the modular energy path: the
    # gradient of the site energies is the pair force of K2's plain twin
    d = args[1].clone().requires_grad_(True)
    e = fb.site_energies_fused(model.tables, model.coeffs, d, *args[2:5])
    (g,) = torch.autograd.grad(e.sum(), d)
    want_g = fm.pair_forces_mega_plain(*args)
    e7 = max_err(g, want_g)
    print(f"  basic_moments_vjp (autograd backward): max|kernel - plain| = {e7:.3e} "
          f"(tol {TOL_K7:.0e})")
    check(e7 <= TOL_K7, "basic_moments_vjp disagrees with its plain version")
    out = {
        "candidates_mega": [e5, None, None],
        "basic_moments_fused": [max_err(mb, mb_plain), None, None],
        "basic_moments_vjp": [e7, None, None],
    }
    if timing:
        # K7 alone, on the gamma = dE/d(basic moments) of these inputs
        mb0 = mb.detach().requires_grad_(True)
        basis = fb.contract_dag_t(model.schedule, mb0)[model.tables.mapping]
        (gamma,) = torch.autograd.grad(
            torch.sum(basis * model.coeffs.moment_coeffs[:, None]), mb0
        )
        gamma = gamma.contiguous()
        calls = {
            "candidates_mega": (lambda: fc.candidates_mega(*args, k["esp"]),
                                lambda: fc.candidates_mega_plain(*args, k["esp"])),
            "basic_moments_fused": (lambda: fb.basic_moments_fused(*args[:6]),
                                    lambda: fb.basic_moments_fused_plain(*args[:6])),
            "basic_moments_vjp": (lambda: fb.basic_moments_vjp(*args[:6], gamma),
                                  lambda: fb.basic_moments_vjp_plain(*args[:6], gamma)),
        }
        for name, (kern, plain) in calls.items():
            out[name][1] = time_ms(kern, 20)
            out[name][2] = time_ms(plain, 3)
        stages = stage_ms({name: kern for name, (kern, _) in calls.items()})
        print_stages("7", stages)
        for name in out:
            out[name].append(sum(stages[name].values()))
    return {name: tuple(v) for name, v in out.items()}, float(args[2].sum())


def mvs_from(model64, boxes, cell, types, cutoff):
    """An MVS state (neighborhood mode) from the float64 plain candidate
    vectors of the given position arrays (lists at `cutoff`, J = 64)."""
    import torch

    from mtp_tpu_torch.al.grades import candidate_vectors
    from mtp_tpu_torch.al.maxvol import build_mvs
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape

    dev = model64.device
    c = torch.as_tensor(cell, dtype=torch.float64, device=dev)
    t = torch.as_tensor(types, dtype=torch.int32, device=dev)
    rows = []
    for pos in boxes:
        p = torch.as_tensor(pos, dtype=torch.float64, device=dev)
        nl = build_neighbor_list(p, c, cutoff, max_neighbors=64, grid=grid_shape(cell, cutoff))
        check(not bool(nl.overflow), "candidate-pool list overflow")
        b, _ = candidate_vectors(model64, p, t, nl.idx, c)
        rows.append(b.cpu().numpy())
    return build_mvs(np.concatenate(rows), mode="neighborhood")


# phase 5b: the row phase's boxes (jittered fcc at a = 3.8 A, about the
# benchmark's zero-pressure lattice; cutoff + skin 5.6 A, J = 64) and the
# operations of one candidate test: 3 subtractions, two 3x3 products (30), 3
# rint and subtractions, |d|^2 (5) and the test, as K1's per pair
ROWS_BOXES = {"32k": (20, 20, 20), "131k": (32, 32, 32)}
ROWS_CUT, ROWS_J, ROWS_OPS_PER_TEST = 5.6, 64, 45
# every output of K11 (ops.neighbors.CellList)
CELL_LIST_FIELDS = ("inv_cell", "positions", "bin3", "table", "counts", "overflow", "order",
                    "inv_order")


def rows_work(n, j, tests, table):
    """(operations, bytes) of one K8 call: every candidate test once; the
    positions, bin coordinates, cell table, bin counts and both cells read
    once, the rows and the count written once."""
    return (ROWS_OPS_PER_TEST * tests,
            12 * n + 24 * n + 8 * table.numel() + 8 * table.shape[0] + 2 * 36 + 4 * n * j + 4)


def cell_list_bytes(n, table):
    """Bytes of one sorted K11 call in fp32: the positions and the cell read
    once; the inverse, order, inverse order, sorted positions, bin
    coordinates, counts, table and flag written once."""
    return 12 * n + 36 + 36 + 8 * n + 8 * n + 12 * n + 24 * n + 8 * table.shape[0] \
        + 8 * table.numel() + 1


# the stage split's kernels of each kernel's rows in phase 5b
ROWS_STAGES = {"neighbor_rows": ("neighbor_rows_kernel",), "cell_list": ("cell_list_", "Memset")}


def neighbor_rows_phase(dev, card):
    """Phase 5b: K11 and K8 against their plain twins on the MD path's
    inputs at 32,000 and 131,072 atoms: K11's outputs, and K8's rows and
    count on K11's bin-sorted rows, bit-equal; whole sorted builds (rows,
    mirror, order, flag) with the kernels, with K8's twin and with K11's;
    each kernel's ms and its twin's (CUDA events), the builds' ms and peak
    device memory above what was allocated before, each kernel's calls per
    build. Returns ({label: row}, {label: call} for `stage_ms`), labels
    "<kernel name> <box>"."""
    import torch

    from mtp_tpu_torch.md.simulation import make_lattice
    from mtp_tpu_torch.ops import neighbors as nbm

    def build_peak(fn):
        torch_sync()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch_sync()
        return out, torch.cuda.max_memory_allocated(dev) - base

    kernel_cell_list = nbm.cell_list
    rows, calls = {}, {}
    for tag, reps in ROWS_BOXES.items():
        pos, _, cell = make_lattice("fcc", 3.8, reps)
        pos = pos + np.random.default_rng(SEED).normal(0.0, 0.1, pos.shape)
        n = len(pos)
        p = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        c = torch.as_tensor(cell, dtype=torch.float32, device=dev)
        grid = nbm.grid_shape(cell, ROWS_CUT)

        def build():
            return nbm.build_sorted_neighbor_list(p, c, ROWS_CUT, max_neighbors=ROWS_J,
                                                  grid=grid)

        for k in (nbm.K8, nbm.K11):
            k.launches = k.plain_calls = 0
        got, peak = build_peak(build)
        per_build = {k.name: k.launches for k in (nbm.K8, nbm.K11)}
        check(nbm.K8.plain_calls == 0 and nbm.K11.plain_calls == 0,
              f"{tag}: the build with K8 and K11 called a plain twin")
        kernel_rows = nbm.neighbor_rows
        nbm.neighbor_rows = nbm.neighbor_rows_plain  # the builds with K8's plain twin
        try:
            want, plain_peak = build_peak(build)
            plain_build_ms = time_ms(build, 3)
        finally:
            nbm.neighbor_rows = kernel_rows
        nbm.cell_list = nbm.cell_list_plain  # a build with K11's plain twin
        try:
            want11 = build()
        finally:
            nbm.cell_list = kernel_cell_list
        build_ms = time_ms(build, 20)
        check(not any(bool(b.overflow) for b in (got, want, want11)), f"{tag} build overflow")
        for label, other in (("K8", want), ("K11", want11)):
            same = (torch.equal(got.idx, other.idx) and torch.equal(got.mirror, other.mirror)
                    and torch.equal(got.order, other.order))
            check(same, f"{tag}: the build with the kernels differs from the build with "
                        f"{label}'s plain twin")

        cl = nbm.cell_list(p, c, ROWS_CUT, grid, sort=True)
        twin = nbm.cell_list_plain(p, c, ROWS_CUT, grid, sort=True)
        torch_sync()
        check(all(torch.equal(getattr(cl, f), getattr(twin, f)) for f in CELL_LIST_FIELDS),
              f"{tag}: K11's outputs differ from its plain twin's")
        check(torch.equal(cl.order, got.order), f"{tag}: K11 alone differs from the build's order")
        table, bin3 = cl.table, cl.bin3
        args = (cl.positions, bin3, table, cl.counts, c, cl.inv_cell, grid, ROWS_CUT, ROWS_J, n)
        idx, count = nbm.neighbor_rows(*args)
        idx_p, count_p = nbm.neighbor_rows_plain(*args)
        torch_sync()
        check(torch.equal(idx, idx_p) and int(count) == int(count_p),
              f"{tag}: K8's rows differ from its plain twin's")
        check(torch.equal(idx, got.idx), f"{tag}: K8 alone differs from the build's rows")
        # candidate tests: each row's stencil bins' atoms
        per_bin = (table >= 0).sum(1)
        offs = [torch.arange(g, device=dev) if g < 3 else torch.arange(-1, 2, device=dev)
                for g in grid]
        st = torch.cartesian_prod(*offs).reshape(-1, 3)
        nb = [torch.remainder(bin3[:, None, a] + st[None, :, a], g) for a, g in enumerate(grid)]
        tests = int(per_bin[(nb[0] * grid[1] + nb[1]) * grid[2] + nb[2]].sum())
        ops, nbytes = rows_work(n, ROWS_J, tests, table)
        t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms = time_ms(lambda: nbm.neighbor_rows(*args), 20)
        plain_ms = time_ms(lambda: nbm.neighbor_rows_plain(*args), 3)
        row = dict(
            name=nbm.K8.name, route="cuda", source=nbm.K8.source, replaces=nbm.K8.replaces,
            atoms=n, grid=list(grid), cap=table.shape[1], candidate_tests=tests,
            max_count=int(count), launches_per_build=per_build[nbm.K8.name], max_abs_err=0.0,
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes", operations=ops,
            bytes=nbytes, build_ms=build_ms, plain_build_ms=plain_build_ms,
            build_peak_bytes=peak, plain_build_peak_bytes=plain_peak, library_ms=None,
        )
        print(f"  neighbor_rows {tag}: {n} atoms, grid {grid}, cap {table.shape[1]}, "
              f"{tests} candidate tests, largest count {int(count)}: rows and count "
              f"bit-equal to the plain twin, and the whole build's rows, mirror and order; "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms); bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}: {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB); "
              f"{per_build} calls per build; build {build_ms:.4f} ms (with K8's twin "
              f"{plain_build_ms:.4f}), peak {peak:,} B (with K8's twin {plain_peak:,} B) on "
              f"{card}")
        check(all(v == 1 for v in per_build.values()),
              f"{tag}: K8 and K11 called {per_build} times in one build")
        rows[f"neighbor_rows {tag}"] = row
        calls[f"neighbor_rows {tag}"] = lambda args=args: nbm.neighbor_rows(*args)

        def sort(p=p, c=c, grid=grid):
            return nbm.cell_list(p, c, ROWS_CUT, grid, sort=True)

        nbytes = cell_list_bytes(n, table)
        ms = time_ms(sort, 20)
        plain_ms = time_ms(lambda: nbm.cell_list_plain(p, c, ROWS_CUT, grid, sort=True), 3)
        rows[f"cell_list {tag}"] = dict(
            name=nbm.K11.name, route="cuda", source=nbm.K11.source, replaces=nbm.K11.replaces,
            atoms=n, grid=list(grid), cap=table.shape[1],
            launches_per_build=per_build[nbm.K11.name], max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
            operations=None, bytes=nbytes, library_ms=None,
        )
        print(f"  cell_list {tag}: {n} atoms, grid {grid}, cap {table.shape[1]}: every output "
              f"bit-equal to the plain twin; {ms:.4f} ms (plain {plain_ms:.4f} ms); bound "
              f"{nbytes / PEAK_BYTES * 1e3:.5f} ms (bytes: {nbytes / 1e6:.2f} MB) on {card}")
        calls[f"cell_list {tag}"] = sort
    return rows, calls


# phase 5c: K9's two calls of a velocity-Verlet step, (kick, drift, count the
# step), and the bytes an atom of each call and of K10 in fp32: every input
# and output once (kick and drift: x, v, f, m read, x' and v' written;
# closing kick: v, f, m read, v' written; check: x and the reference read)
MD_STEP_CALLS = {"kick and drift": (True, True, False), "kick and step": (True, False, True)}
MD_STEP_BYTES = {"kick and drift": 64, "kick and step": 40, "verlet_top2": 24}


def md_step_phase(dev, card):
    """Phase 5c: K9 (both calls of an NVE step) and K10 against their plain
    twins on random fp32 arrays at 32,000 and 131,072 atoms: outputs bit-equal,
    the flag equal at a skin either side of the displacements' sum; ms by
    CUDA events of the kernel and of its plain chain, the bound from the
    bytes. Returns ({tag: row}, {label: call} for `stage_ms`)."""
    import torch

    from mtp_tpu_torch.ops import md_step as ms
    from mtp_tpu_torch.utils import units

    rows, calls = {}, {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    for tag, reps in ROWS_BOXES.items():
        n = 4 * reps[0] * reps[1] * reps[2]
        x = 70.0 * torch.rand((n, 3), generator=g, device=dev)
        v = 5.0 * torch.randn((n, 3), generator=g, device=dev)
        f = torch.randn((n, 3), generator=g, device=dev)
        m = 20.0 + 100.0 * torch.rand(n, generator=g, device=dev)
        step = torch.zeros((), dtype=torch.int64, device=dev)
        ref = x + 0.05 * torch.randn((n, 3), generator=g, device=dev)
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        kick = 0.5 * 0.001 * units.FTM2A
        work = {}
        for call, (k, d, c) in MD_STEP_CALLS.items():
            args = (x, v, f, m, step if c else None)
            kw = dict(kick=kick if k else None, drift=0.001 if d else None)
            got = ms.md_step(*args, **kw)
            want = ms.md_step_plain(*args, **kw)
            torch_sync()
            check(all(a is b or torch.equal(a, b) for a, b in zip(got, want)),
                  f"{tag}: md_step {call} differs from its plain twin")
            work[f"md_step {call}"] = (
                ms.K9, lambda args=args, kw=kw: ms.md_step(*args, **kw),
                lambda args=args, kw=kw: ms.md_step_plain(*args, **kw), MD_STEP_BYTES[call])
        got, want = ms.verlet_top2(x, ref), ms.verlet_top2_plain(x, ref)
        s = float(torch.sqrt(want[0]) + torch.sqrt(want[1]))
        flags = []
        for skin in (s * (1 - 1e-6), s * (1 + 1e-6)):
            for fn in (ms.verlet_check, ms.verlet_check_plain):
                fl = torch.zeros((), dtype=torch.bool, device=dev)
                fn(x, ref, skin, fl)
                flags.append(bool(fl))
        check(torch.equal(got, want) and flags == [True, True, False, False],
              f"{tag}: verlet_top2 differs from its plain twin (flags {flags})")
        work["verlet_top2"] = (
            ms.K10, lambda: ms.verlet_check(x, ref, 0.6, flag),
            lambda: ms.verlet_check_plain(x, ref, 0.6, flag), MD_STEP_BYTES["verlet_top2"])
        for label, (kern, fn, plain, per_atom) in work.items():
            nbytes = per_atom * n
            ms_k, plain_ms = time_ms(fn, 20), time_ms(plain, 20)
            row = dict(
                name=kern.name, call=label, route="cuda", source=kern.source,
                replaces=kern.replaces, atoms=n, max_abs_err=0.0, ms=ms_k, plain_ms=plain_ms,
                bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes", operations=None,
                bytes=nbytes, library_ms=None,
            )
            print(f"  {label} {tag}: {n} atoms, bit-equal to the plain twin; {ms_k:.4f} ms "
                  f"(plain chain {plain_ms:.4f} ms); bound {row['bound_ms']:.5f} ms (bytes: "
                  f"{nbytes / 1e6:.2f} MB) on {card}")
            rows[f"{label} {tag}"] = row
            calls[f"{label} {tag}"] = fn
    return rows, calls


def al_kernel_phase(m2, p32, ty, c32, swl):
    """Phase 6 on the phase-3 box (`m2`, positions, types, cell, list)."""
    import torch

    from mtp_tpu_torch.al.grades import (
        candidates_and_forces,
        candidates_and_forces_window,
        grade_eval_window,
        nbh_grades,
    )
    from mtp_tpu_torch.models.mtp import MTPModel, window_constants
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape

    dev = p32.device
    n = p32.shape[0]
    cell = c32.double().cpu().numpy()
    base = p32.double().cpu().numpy()
    rng = np.random.default_rng(SEED)
    boxes = [base + rng.normal(0.0, s, base.shape) for s in (0.05, 0.1)]
    m2.mvs = mvs_from(MTPModel.from_data(m2, device=dev, dtype=torch.float64), boxes, cell,
                      ty.cpu().numpy(), m2.max_dist)
    al32 = MTPModel.from_data(m2, device=dev, dtype=torch.float32)
    al64 = MTPModel.from_data(m2, device=dev, dtype=torch.float64)
    print(f"[6 AL kernels] {n} atoms, level 16, 2 species, J=64, fp32, MVS P="
          f"{al32.inverse_active_set.shape[0]}: kernel vs plain")
    compare_al_kernels(al32, p32, c32, ty, swl, timing=False)

    win = candidates_and_forces_window(al32, p32, c32, swl, **window_constants(al32, ty, swl))
    gw = grade_eval_window(al32, p32, ty, c32, swl, al32.inverse_active_set, config_mode=False)
    p64, c64 = p32.double(), c32.double()
    cut = al64.cutoff + 0.6
    nl64 = build_neighbor_list(p64, c64, cut, max_neighbors=64, grid=grid_shape(cell, cut))
    check(not bool(nl64.overflow), "f64 list overflow")
    ref = candidates_and_forces(al64, p64, ty, nl64.idx, c64, nl64.mirror)
    g64 = nbh_grades(ref["b"], al64.inverse_active_set)
    gmax = float(g64.max())
    floor = rel_err(nbh_grades(ref["b"].float().double(), al64.inverse_active_set), g64)
    db = rel_err(win["b"][swl.inv_order], ref["b"])
    dg = rel_err(gw["grades"], g64)
    dmax = abs(float(gw["max_grade"]) - gmax) / gmax
    df = max_err(gw["forces"], ref["forces"])
    de = abs(float(gw["energy"]) - float(ref["energy"])) / n
    print(f"[6 AL kernels] fp32 window grade step vs f64 plain path: max|db|/max|b|="
          f"{db:.3e} (gate {GATE_B_REL:.0e}) max|dg|/max g={dg:.3e} (gate "
          f"{GATE_GRADE_REL:.0e}; f64 b rounded to fp32 alone: {floor:.3e}) max grade "
          f"{gmax:.4f} (rel err {dmax:.3e}, gate {GATE_MAX_GRADE_REL:.0e}) max|dF|={df:.3e} "
          f"(gate {GATE_DF:.0e}) dE/atom={de:.3e} (gate {GATE_DE:.0e})")
    check(bool(gw["grades"].isfinite().all()), "non-finite fp32 grades")
    check(db <= GATE_B_REL, "fp32 candidate vectors vs f64")
    check(dg <= GATE_GRADE_REL and dmax <= GATE_MAX_GRADE_REL, "fp32 grades vs f64")
    check(df < GATE_DF and de < GATE_DE, "fp32 grade-step forces or energy vs f64")


AL_BOX = (20, 20, 20)  # bench_suite.py configuration 4b: 32,000 atoms
POOL_BOX = (10, 10, 10)  # its MVS pool: three 4,000-atom boxes
AL_ROUNDS = 3  # timed (AL run, pure-MD run) pairs in phase 7


def al_path_phase(dev, card):
    """Phase 7: the AL path at full width. Returns the kernel rows of K5-K7."""
    import torch

    from mtp_tpu_torch.al.driver import ExtrapolationMonitor, run_with_extrapolation
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.kernels import all_kernels, reset_counts
    from mtp_tpu_torch.md.simulation import Simulation, make_lattice
    from mtp_tpu_torch.md.state import init_state, thermalize
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops import fused_moments as fm
    from mtp_tpu_torch.ops.fused_basic import site_energies_fused
    from mtp_tpu_torch.ops.window_giveback import window_giveback

    m = make_mtp(16, species_count=1, seed=SEED)
    pos4, types4, cell4 = make_lattice("fcc", 4.0, POOL_BOX)
    rng = np.random.default_rng(1)
    boxes = [pos4 + rng.normal(0.0, s, pos4.shape) for s in (0.02, 0.06, 0.1)]
    t0 = time.perf_counter()
    m.mvs = mvs_from(MTPModel.from_data(m, device=dev, dtype=torch.float64), boxes, cell4,
                     types4, 5.0)
    model = MTPModel.from_data(m, device=dev, dtype=torch.float32)
    print(f"[7 AL path] MVS from 3 x {len(pos4)} f64 candidate vectors: P="
          f"{model.inverse_active_set.shape[0]}, {time.perf_counter() - t0:.2f} s")

    pos, types, cell = make_lattice("fcc", 4.0, AL_BOX)
    n = len(pos)
    state = init_state(pos, types, np.full(n, 58.693), cell, dtype=torch.float32, device=dev)
    state = thermalize(torch.Generator(device=dev).manual_seed(5), state, 300.0)
    eq = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                    compute_virial=False)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                     compute_virial=False)
    state, _, fl = eq.run_async(state, 60, dt=0.001)
    check(not bool(fl), "AL equilibration flags set")
    mon = ExtrapolationMonitor(model)
    n_steps, al_every = 120, 30
    n_evals = n_steps // al_every + 1
    # warm-up: each run once as it is timed below
    state = run_with_extrapolation(sim, mon, state, al_every, al_every=al_every,
                                   ensemble="nve", dt=0.001)
    state, _, fl = sim.run_async(state, al_every, dt=0.001)
    check(not bool(fl), "pure-MD warm-up flags set")
    kernels = all_kernels()
    # rounds of (AL run, pure-MD run), each from the state the last one left;
    # the launch counts are those of the first AL run
    per_eval = []
    for rnd in range(AL_ROUNDS):
        torch_sync()
        if rnd == 0:
            reset_counts()
        t0 = time.perf_counter()
        state = run_with_extrapolation(sim, mon, state, n_steps, al_every=al_every,
                                       ensemble="nve", dt=0.001)
        torch_sync()
        dt_al = time.perf_counter() - t0
        if rnd == 0:
            launches = {k.name: k.launches for k in kernels}
            plain = {k.name: k.plain_calls for k in kernels}
            grades = mon.nbh_grades
            print(f"[7 AL path] {n} atoms, level 16, fp32, J=64: run_with_extrapolation "
                  f"{n_steps} steps, grades every {al_every}")
            print(f"[7 AL path] launches {launches}; plain calls {plain}")
        check(bool(state.positions.isfinite().all()), "non-finite positions after AL")
        t0 = time.perf_counter()
        state, _, fl, nl = sim.run_async(state, n_steps, dt=0.001, return_nl=True)
        torch_sync()
        dt_md = time.perf_counter() - t0
        check(not bool(fl), "pure-MD run flags set")
        per_eval.append((dt_al - dt_md) / n_evals * 1e3)
        print(f"[7 AL path] round {rnd}: max grade {mon.max_grade:.4f}; with AL "
              f"{n * n_steps / dt_al:.1f} atom-steps/s ({dt_al:.4f} s), pure MD "
              f"{n * n_steps / dt_md:.1f} atom-steps/s ({dt_md:.4f} s), "
              f"{per_eval[-1]:.3f} ms per grade eval ({n_evals} evals) on {card}")
    print(f"[7 AL path] ms per grade eval by round {[round(v, 3) for v in per_eval]}, "
          f"median {float(np.median(per_eval)):.3f}")
    check(sim.max_neighbors == 64 and sim.steps_per_rebuild == 30,
          "an AL segment tripped its flags and was retried")
    check(launches["candidates_mega"] == n_evals, f"K5 launched {launches['candidates_mega']} "
          f"times, not once per grade step ({n_evals})")
    for k in kernels[:4]:
        check(k.launches > 0, f"{k.name} was not launched on the AL path")
    for k in kernels:
        check(k.plain_calls == 0, f"{k.name}'s plain version ran on the AL path")
    check(grades is not None and grades.shape == (n,) and bool(np.isfinite(grades).all()),
          "non-finite or missing grades")
    check(mon.max_grade > 0, "max grade is not positive")

    # the modular energy path: K6 forward, K7 backward, through its entry point
    reset_counts()
    _, k, args = kernel_inputs(model, state.positions, state.cell, state.types, nl)
    d = args[1].clone().requires_grad_(True)
    e = site_energies_fused(model.tables, model.coeffs, d, *args[2:5])
    (pair,) = torch.autograd.grad(e.sum(), d)
    f_mod = window_giveback(pair, k["mirror_t"])
    torch_sync()
    mod = {k_.name: k_.launches for k_ in kernels}
    print(f"[7 modular path] launches {mod}")
    for name in ("basic_moments_fused", "basic_moments_vjp"):
        check(mod[name] == 1, f"{name} was not launched on the modular path")
    f_main = window_giveback(fm.pair_forces_mega(*args), k["mirror_t"])
    e_main = fm.site_energies_mega(*args, k["esp"])
    dfm, dem = max_err(f_mod, f_main), max_err(e.detach(), e_main)
    print(f"[7 modular path] vs the fused path: max|dF|={dfm:.3e} max|de|={dem:.3e}")
    check(dfm < TOL["pair_forces_mega"] and dem < TOL["site_energies_mega"],
          "modular path disagrees with the fused path")

    print(f"[7 AL kernels] {n} atoms, J=64, level 16, fp32: kernel vs plain, timed")
    res, live = compare_al_kernels(model, state.positions, state.cell, state.types, nl,
                                   timing=True)
    counts = {"candidates_mega": launches["candidates_mega"], **{
        name: mod[name] for name in ("basic_moments_fused", "basic_moments_vjp")}}
    j = nl.idx.shape[1]
    # K5's double stages and the float stages of K6 and K7 (specialised for
    # this level-16 schedule)
    warps = fm.resident_warps(model.tables, j)
    k5_warps = {key: v for key, v in warps.items() if key.startswith("K5")}
    stage_warps = {"basic_moments_fused": {"basic": warps["basic"]},
                   "basic_moments_vjp": {"tail": warps["tail"]}, "candidates_mega": k5_warps}
    print(f"[7 occupancy] resident warps per SM (CUDA occupancy calculator) of K5's stages "
          f"{k5_warps}; of K6's basic stage {warps['basic']} and K7's tail {warps['tail']} "
          f"(float specialised {warps['float specialised']})")
    rows = []
    for kern in kernels[4:7]:  # K5-K7
        err, ms, plain_ms, dev_ms = res[kern.name]
        row = kernel_row(kern, counts[kern.name], err, ms, plain_ms, model, n, j, live)
        share = device_share(row, dev_ms)
        row["resident_warps"] = stage_warps[kern.name]
        print(f"  {kern.name}: {ms:.4f} ms by CUDA events around the wrapper, {dev_ms:.4f} ms "
              f"on the device (plain {plain_ms:.4f} ms); bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {share} of the device time")
        rows.append(row)
    return rows, model, state


ENS_KW = dict(temperature=300.0, tdamp=0.1, pdamp=1.0)
ENS_ROUNDS = 3  # timed rounds of the phase-8b configurations, in turns


class _NoSyncSimulation:
    """Mixin: every ``steps`` block under ``set_sync_debug_mode("error")``,
    so any host read of the device inside a block raises."""

    def steps(self, *args, **kw):
        import torch

        torch.cuda.set_sync_debug_mode("error")
        out = super().steps(*args, **kw)
        torch.cuda.set_sync_debug_mode(0)
        return out


def npt_fp32_vs_f64(m2, p32, c32, ty):
    """Phase 8a on the phase-3 box. Returns the errors."""
    import torch

    from mtp_tpu_torch.md import integrators as itg
    from mtp_tpu_torch.md.simulation import Simulation
    from mtp_tpu_torch.md.state import init_state, volume_of
    from mtp_tpu_torch.models.mtp import (
        MTPModel,
        mtp_energy_forces,
        mtp_energy_forces_window,
        window_constants,
    )
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list, build_sorted_neighbor_list
    from mtp_tpu_torch.utils import units

    dev = p32.device
    types = ty.cpu().numpy()
    masses = np.where(types == 0, 58.693, 26.98)
    rng = np.random.default_rng(SEED)
    vel = rng.normal(size=(len(types), 3)) * np.sqrt(units.KB * 300.0 / (masses * units.MVV2E))[:, None]
    vel -= (vel * masses[:, None]).sum(0) / masses.sum()
    pos, cell = p32.cpu().numpy(), c32.cpu().numpy()
    kw = dict(pressure=0.0, **ENS_KW)
    model32 = MTPModel.from_data(m2, device=dev, dtype=torch.float32)
    model64 = MTPModel.from_data(m2, device=dev, dtype=torch.float64)

    st32 = init_state(pos, types, masses, cell, velocities=vel, dtype=torch.float32, device=dev)
    sim = Simulation(model32, max_neighbors=64, skin=0.6, steps_per_rebuild=20)
    st32, aux32, fl = sim.run_async(st32, 20, ensemble="npt", dt=0.001, **kw)
    check(not bool(fl), "8a fp32 NPT flags set")

    st64 = init_state(pos, types, masses, cell, velocities=vel, dtype=torch.float64, device=dev)
    cut = model64.cutoff + 0.6
    nl = build_neighbor_list(st64.positions, st64.cell, cut, max_neighbors=64,
                             grid=sim.grid_for(st64.cell))
    check(not bool(nl.overflow), "8a f64 list overflow")

    def force_fn(positions, types_, cell_):
        out = mtp_energy_forces(model64, positions, types_, nl.idx, cell_, nl.mirror)
        return out["forces"], out["energy"], out["virial"]

    st64 = itg._with_forces(st64, force_fn)
    aux64 = itg.npt_init(torch.float64, dev)
    bv_max = 0.0
    for _ in range(20):
        st64, aux64 = itg.npt_step(st64, aux64, force_fn, 0.001, **kw)
        bv_max = max(bv_max, abs(float(aux64.baro_v)))
    d0 = st64.positions - nl.reference_positions
    check(float(d0.norm(dim=-1).max()) < 0.3, "8a f64 run left its list's skin")
    dx = max_err(st32.positions, st64.positions)
    dcell = max_err(st32.cell, st64.cell) / float(st64.cell.abs().max())
    dbv = abs(float(aux32.baro_v) - float(aux64.baro_v)) / bv_max
    print(f"[8a NPT] {len(types)} atoms, level 16, 2 species, 20 steps at 0 bar, fp32 kernel "
          f"path vs f64 plain path: max|dx|={dx:.3e} A (gate {GATE_NPT_DX:.0e}), cell "
          f"{dcell:.3e} relative (gate {GATE_NPT_CELL:.0e}), baro_v {dbv:.3e} of its max "
          f"{bv_max:.3e} (gate {GATE_NPT_BV:.0e}); V {float(np.linalg.det(cell)):.4f} -> "
          f"{float(volume_of(st64)):.4f} A^3")
    check(dx <= GATE_NPT_DX and dcell <= GATE_NPT_CELL and dbv <= GATE_NPT_BV,
          "8a fp32 NPT vs f64")

    # per-atom virial: fp32 window path vs f64 plain path, on the phase-3 box
    swl = build_sorted_neighbor_list(p32, c32, cut, max_neighbors=64, grid=sim.grid_for(c32))
    w32 = mtp_energy_forces_window(model32, p32, c32, swl, compute_vatom=True,
                                   **window_constants(model32, ty, swl))
    p64, c64 = p32.double(), c32.double()
    nl64 = build_neighbor_list(p64, c64, cut, max_neighbors=64, grid=sim.grid_for(c64))
    w64 = mtp_energy_forces(model64, p64, ty, nl64.idx, c64, nl64.mirror, compute_vatom=True)
    dva = max_err(w32["vatom"], w64["vatom"])
    dsum = max_err(w32["vatom"].double().sum(0), w64["virial"])
    print(f"[8a vatom] fp32 window vs f64 plain: max|dvatom|={dva:.3e} eV (gate "
          f"{GATE_VATOM:.0e}), |sum vatom - W(f64)|={dsum:.3e} eV (gate {GATE_DW:.0e})")
    check(dva <= GATE_VATOM and dsum <= GATE_DW, "8a per-atom virial vs f64")
    return dict(dx=dx, dcell=dcell, dbaro_v=dbv, dvatom=dva, dvatom_sum=dsum)


def ensembles_phase(dev, card, m2, p32, c32, ty, model, state, al_model, al_state):
    """Phase 8. `model` and `state`: phase 4's model and final state;
    `al_model` and `al_state`: phase 7's model with its MVS and its final
    state."""
    import torch

    from mtp_tpu_torch.al.driver import ExtrapolationMonitor, run_with_extrapolation
    from mtp_tpu_torch.kernels import all_kernels, main_path_kernels, reset_counts
    from mtp_tpu_torch.md import integrators as itg
    from mtp_tpu_torch.md.minimize import fire_minimize
    from mtp_tpu_torch.md.simulation import Simulation, _default_aux, make_lattice
    from mtp_tpu_torch.md.state import init_state, kinetic_energy, pressure_of, volume_of

    class Sim(_NoSyncSimulation, Simulation):
        pass

    report = {"card": card, "npt_fp32_vs_f64": npt_fp32_vs_f64(m2, p32, c32, ty)}
    n = state.n_atoms
    kernels = main_path_kernels()

    def conserved(ens, st, aux, kw):
        if ens == "nvt":
            return itg.nvt_conserved(st, aux, kw["temperature"], kw["tdamp"])
        if ens == "npt":
            return itg.npt_conserved(st, aux, **kw)
        if ens == "npt-tri":
            return itg.npt_aniso_conserved(st, aux, couple="tri", **kw)
        return st.potential_energy + kinetic_energy(st)  # NVE; Langevin: not conserved

    # the box's own initial pressure, from a force evaluation with the virial
    probe = Simulation(model, max_neighbors=64, skin=0.6)
    st_v = probe.refresh_forces(state, probe.rebuild(state, grid=probe.grid_for(state.cell),
                                                     max_neighbors=64), ensemble="npt")
    p0 = float(pressure_of(st_v))
    runs = [("nve", 60, False), ("nve", 60, True), ("nvt", 60, False), ("langevin", 60, False),
            ("npt-tri", 60, False), ("npt", 120, False)]
    cfgs = []
    for ens, steps, virial in runs:
        kw = dict(ENS_KW, pressure=p0) if ens.startswith("npt") else (
            {} if ens == "nve" else dict(temperature=300.0, tdamp=0.1))
        sim = Sim(model, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                  compute_virial=virial)
        cfgs.append((ens, steps, virial, kw, sim, st_v if ens.startswith("npt") else state))

    def drive(ens, steps, kw, sim, st0):
        """One run of `steps` steps from `st0` with a fresh aux: (state, aux,
        flags, wall seconds)."""
        aux = _default_aux(ens, st0)
        torch_sync()
        t0 = time.perf_counter()
        st, aux, fl = sim.run_async(st0, steps, ensemble=ens, dt=0.001, aux=aux,
                                    refresh=False, **kw)
        torch_sync()
        return st, aux, fl, time.perf_counter() - t0

    # a first pass counts the launches and checks every run (it also warms
    # them up), then ENS_ROUNDS timed rounds take the configurations in turns
    rows = []
    for ens, steps, virial, kw, sim, st0 in cfgs:
        reset_counts()
        h0 = None if ens == "langevin" else float(conserved(ens, st0, _default_aux(ens, st0),
                                                           kw))
        st, aux, fl, _ = drive(ens, steps, kw, sim, st0)
        launches = {k.name: k.launches for k in kernels}
        plain = sum(k.plain_calls for k in all_kernels())
        blocks = -(-steps // 30)
        drift = None if h0 is None else (float(conserved(ens, st, aux, kw)) - h0) / n
        rows.append(dict(ensemble=ens, compute_virial=virial or ens.startswith("npt"),
                         steps=steps, launches=launches,
                         launches_per_step=sum(launches.values()) / steps, plain_calls=plain,
                         overflow=bool(fl.overflow), stale=bool(fl.stale),
                         drift_per_atom=drift,
                         volume_ratio=float(volume_of(st)) / float(volume_of(st0)), walls=[]))
        check(not fl.overflow and not fl.stale, f"8b {ens} flags set")
        check(plain == 0, f"8b {ens}: a plain twin ran")
        for k in kernels[:3]:
            check(k.launches >= steps, f"8b {ens}: {k.name} launched {k.launches} times in "
                  f"{steps} steps")
        check(launches["site_energies_mega"] >= blocks, f"8b {ens}: K4 not once per block")
        check(bool(st.positions.isfinite().all()), f"8b {ens}: non-finite positions")
    for _ in range(ENS_ROUNDS):
        for row, (ens, steps, _v, kw, sim, st0) in zip(rows, cfgs):
            st, _, fl, wall = drive(ens, steps, kw, sim, st0)
            check(not fl.overflow and not fl.stale and bool(st.positions.isfinite().all()),
                  f"8b {ens}: a timed run went wrong")
            row["walls"].append(wall)
    for row in rows:
        ens, steps = row["ensemble"], row["steps"]
        rates = [n * steps / w for w in row["walls"]]
        row["atom_steps_per_s_rounds"] = rates
        row["atom_steps_per_s"] = float(np.median(rates))
        drift = row["drift_per_atom"]
        tag = f"{ens}{' (virial on)' if row['compute_virial'] and ens == 'nve' else ''}"
        print(f"[8b {tag}] {n} atoms, {steps} steps: median {row['atom_steps_per_s']:.1f} "
              f"atom-steps/s of {ENS_ROUNDS} rounds {[round(r, 1) for r in rates]} on {card}; "
              f"launches {row['launches']} ({row['launches_per_step']:.3f} per step), plain "
              f"calls {row['plain_calls']}; flags overflow={row['overflow']} "
              f"stale={row['stale']}; conserved drift "
              f"{'n/a' if drift is None else f'{drift:.3e} eV/atom'}; V/V0 "
              f"{row['volume_ratio']:.6f}" + (f"; p_ext {p0:.1f} bar" if ens.startswith("npt")
                                               else ""))
    # the virial's cost: NVE with it on minus off, per step, paired by round
    virial_ms = [(on - off) / rows[0]["steps"] * 1e3
                 for off, on in zip(rows[0]["walls"], rows[1]["walls"])]
    print(f"[8b virial] NVE with the virial on minus off: median "
          f"{float(np.median(virial_ms)):.4f} ms per step, by round "
          f"{[round(v, 4) for v in virial_ms]} on {card}")
    report["ensembles"] = rows
    report["virial_ms_per_step"] = dict(median=float(np.median(virial_ms)), rounds=virial_ms)

    # 8c: Simulation.run from J = 32 grows the list until it fits
    sim = Simulation(model, max_neighbors=32, skin=0.6, steps_per_rebuild=30)
    reset_counts()
    t0 = time.perf_counter()
    st, _ = sim.run(st_v, 30, ensemble="npt", dt=0.001, pressure=p0, **ENS_KW)
    torch_sync()
    print(f"[8c run] NPT 30 steps from J=32: J grew to {sim.max_neighbors}, steps_per_rebuild "
          f"{sim.steps_per_rebuild}, step {int(st.step) - int(st_v.step)}, "
          f"{time.perf_counter() - t0:.3f} s with the retries")
    check(sim.max_neighbors > 32 and int(st.step) - int(st_v.step) == 30, "8c run did not recover")
    report["run_from_j32"] = dict(j=sim.max_neighbors, steps_per_rebuild=sim.steps_per_rebuild)

    # 8d: FIRE on the rattled lattice
    pos, types, cell = make_lattice("fcc", 4.0, AL_BOX)
    pos = pos + np.random.default_rng(0).normal(0.0, 0.05, pos.shape)
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, dtype=torch.float32, device=dev)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=20)
    reset_counts()
    torch_sync()
    t0 = time.perf_counter()
    st, res = fire_minimize(sim, st, ftol=1e-2, max_steps=200)
    torch_sync()
    ms_it = (time.perf_counter() - t0) * 1e3 / res.iterations
    print(f"[8d FIRE] {len(pos)} atoms rattled 0.05 A: {res.iterations} iterations, stop "
          f"{res.stop_reason}, fmax {res.fmax:.4e} eV/A, E {res.potential_energy:.4f} eV, "
          f"{ms_it:.4f} ms per iteration on {card}; steps_per_rebuild 20 -> "
          f"{sim.steps_per_rebuild}, J {sim.max_neighbors}; launches "
          f"{ {k.name: k.launches for k in kernels} }")
    check(res.stop_reason in ("ftol", "maxiter") and np.isfinite(res.fmax), "8d FIRE")
    check(all(k.launches > 0 for k in kernels), "8d FIRE did not launch K1-K4")
    report["fire"] = dict(iterations=res.iterations, stop_reason=res.stop_reason,
                          fmax=res.fmax, ms_per_iteration=ms_it,
                          steps_per_rebuild=sim.steps_per_rebuild)

    # 8e: active learning under NPT, from phase 7's final state
    st = al_state
    sim = Sim(al_model, max_neighbors=64, skin=0.6, steps_per_rebuild=30, compute_virial=False)
    mon = ExtrapolationMonitor(al_model)
    reset_counts()
    t0 = time.perf_counter()
    st = run_with_extrapolation(sim, mon, st, 60, al_every=30, ensemble="npt", dt=0.001,
                                pressure=0.0, **ENS_KW)
    torch_sync()
    wall = time.perf_counter() - t0
    al = {k.name: k.launches for k in all_kernels()}
    plain = sum(k.plain_calls for k in all_kernels())
    print(f"[8e AL NPT] {st.n_atoms} atoms, 60 NPT steps graded every 30: launches {al}, plain "
          f"calls {plain}, max grade {mon.max_grade:.4f}, {st.n_atoms * 60 / wall:.1f} "
          f"atom-steps/s on {card}")
    check(al["candidates_mega"] == 3 and plain == 0, "8e K5 not launched once per grade step")
    check(bool(st.positions.isfinite().all()), "8e non-finite positions")
    report["al_npt"] = dict(k5_launches=al["candidates_mega"], max_grade=mon.max_grade)
    return report


def oracle_repeat_phase(model64, p64, ty, c64, nl64):
    """Phase 3b: the float64 plain path twice, bit for bit."""
    import torch

    from mtp_tpu_torch.al.grades import candidate_vectors
    from mtp_tpu_torch.models.mtp import mtp_energy_forces

    def once():
        out = mtp_energy_forces(model64, p64, ty, nl64.idx, c64, nl64.mirror)
        b, e_b = candidate_vectors(model64, p64, ty, nl64.idx, c64)
        return dict(energy=out["energy"], site_energies=out["site_energies"],
                    forces=out["forces"], virial=out["virial"], b=b, energy_of_b=e_b)

    first, second = once(), once()
    torch_sync()
    differ = [k for k in first if not torch.equal(first[k], second[k])]
    for k in differ:
        print(f"[3b oracle] {k} differs between two runs: max|d| = "
              f"{max_err(first[k], second[k]):.3e}")
    print(f"[3b oracle] f64 plain path twice on the phase-3 box: "
          f"{'bit-equal' if not differ else 'NOT bit-equal'} in "
          f"{', '.join(first)}")
    check(not differ, f"the float64 plain path does not repeat: {differ[0] if differ else ''}")
    return dict(bit_equal=not differ, quantities=list(first))


def events_ms(fn):
    """(result, ms) of one call of `fn`, by CUDA events."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    b.synchronize()
    return res, a.elapsed_time(b)


# lr 1e-4: at 2e-3 Adam overshoots on these labels (`utils/prof.py --fit` prints both)
TRAIN = dict(n_configs=96, j=48, steps=30, lr=1e-4, force_weight=0.1)
LIFE = dict(reps=(6, 6, 6), temperature=600.0, steps=200, al_every=20)
N_GOLDEN = 2  # labels cross-checked against golden


def training_phase(dev, card, out_dir):
    """Phase 9: label, fit, MVS, save, load, and MD with grading. Returns the
    report; `out_dir` receives the potential and the selected configurations."""
    import dataclasses

    import torch

    from mtp_tpu_torch.al.driver import ExtrapolationMonitor, run_with_extrapolation
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.io.cfg_file import read_cfgs
    from mtp_tpu_torch.io.mtp_file import save_mtp
    from mtp_tpu_torch.kernels import all_kernels, reset_counts
    from mtp_tpu_torch.md.simulation import Simulation, make_lattice
    from mtp_tpu_torch.md.state import init_state, thermalize
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.train.fit import (fit, linear_warm_start, loss_fn, make_dataset,
                                         training_set)
    from mtp_tpu_torch.utils import golden, native

    report = {"card": card}
    teacher = make_mtp(16, species_count=1, seed=11)
    t0 = time.perf_counter()
    configs = training_set(MTPModel.from_data(teacher, device=dev, dtype=torch.float64),
                           TRAIN["n_configs"])
    types, cell = configs[0].types, configs[0].cell
    boxes = [c.positions for c in configs]
    print(f"[9 train] labeled {len(configs)} x {len(types)} atoms with a level-16 teacher "
          f"(f64 plain path): {time.perf_counter() - t0:.2f} s")
    for c in configs[:N_GOLDEN]:
        g = golden.compute(teacher, c.positions, c.types, cell)
        de = abs(c.energy - g["energy"]) / len(types)
        df = float(np.abs(c.forces - g["forces"]).max())
        print(f"[9 train] vs golden: dE/atom {de:.3e} (tol 1e-9), max|dF| {df:.3e} (tol 1e-8)")
        check(de <= 1e-9 and df <= 1e-8, "labels disagree with golden")

    student = make_mtp(16, species_count=1, seed=99)
    s64 = MTPModel.from_data(student, device=dev, dtype=torch.float64)
    data = make_dataset(configs, student.max_dist, max_neighbors=TRAIN["j"], device=dev)
    kw = dict(force_weight=TRAIN["force_weight"])
    reset_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ws, ws_ms = events_ms(lambda: linear_warm_start(s64.schedule, s64.coeffs, data))
    # Adam starts from the minted student: from the warm start, which fits
    # these labels almost exactly, Adam raises the loss, in the JAX fit as in
    # the port (tests/test_torch_train.py::test_adam_climbs_from_a_level16_warm_start)
    (coeffs, losses), fit_ms = events_ms(lambda: fit(
        s64.schedule, s64.coeffs, data, steps=TRAIN["steps"], learning_rate=TRAIN["lr"],
        warm_start=False, **kw))
    launched = {k.name: (k.launches, k.plain_calls) for k in all_kernels()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    l_ws = float(loss_fn(s64.schedule, ws, data, **kw))
    l_final = float(loss_fn(s64.schedule, coeffs, data, **kw))
    print(f"[9 train] {TRAIN['n_configs']} configs x {len(types)} atoms, level 16, J="
          f"{TRAIN['j']}, f64: warm start {ws_ms:.2f} ms (loss {l_ws:.6e}, max|moment coeff| "
          f"{float(ws.moment_coeffs.abs().max()):.4g}); {TRAIN['steps']} Adam steps "
          f"{fit_ms / TRAIN['steps']:.2f} ms per step (the final evaluation included), peak "
          f"memory {'not measured' if peak is None else f'{peak / 2**30:.3f} GiB'} on {card}")
    print(f"[9 train] loss {losses[0]:.6e} -> {losses[-1]:.6e} (returned coefficients "
          f"{l_final:.6e}); launches and plain calls during warm start and fit {launched}")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0], "the fit did not descend")
    check(all(v == (0, 0) for v in launched.values()), "a kernel ran during the fit")

    # the first 2 steps on 8 configurations: the card's losses on the CPU
    sub = make_dataset(configs[:8], student.max_dist, max_neighbors=TRAIN["j"], device=dev)
    sub_cpu = make_dataset(configs[:8], student.max_dist, max_neighbors=TRAIN["j"],
                           device="cpu")
    s_cpu = MTPModel.from_data(student, device="cpu", dtype=torch.float64)
    _, l_dev = fit(s64.schedule, s64.coeffs, sub, steps=2, learning_rate=TRAIN["lr"],
                   warm_start=False, **kw)
    _, l_cpu = fit(s_cpu.schedule, s_cpu.coeffs, sub_cpu, steps=2,
                   learning_rate=TRAIN["lr"], warm_start=False, **kw)
    rel = float(np.abs(l_dev - l_cpu).max() / np.abs(l_cpu).max())
    print(f"[9 train] 2 steps on 8 configs: card {l_dev.tolist()} CPU {l_cpu.tolist()} "
          f"relative {rel:.3e} (tol 1e-9)")
    check(rel <= 1e-9, "the fit on the card disagrees with the CPU")

    # the lifecycle: MVS, save, load, MD with grading and selection
    trained = dataclasses.replace(
        student, radial_coeffs=coeffs.radial_coeffs.cpu().numpy(),
        species_coeffs=coeffs.species_coeffs.cpu().numpy(),
        moment_coeffs=coeffs.moment_coeffs.cpu().numpy())
    t0 = time.perf_counter()
    trained.mvs = mvs_from(MTPModel.from_data(trained, device=dev, dtype=torch.float64),
                           boxes, cell, types, trained.max_dist)
    path = out_dir / "trained.mtp"
    save_mtp(str(path), trained)
    model = MTPModel.load(str(path), device=dev, dtype=torch.float32)
    print(f"[9 lifecycle] MVS from {len(boxes)} x {len(types)} f64 candidate vectors: P="
          f"{model.inverse_active_set.shape[0]}, {time.perf_counter() - t0:.2f} s; saved and "
          f"loaded {path.name}")
    pos, mtypes, mcell = make_lattice("fcc", 4.0, LIFE["reps"])
    n = len(pos)
    st = init_state(pos, mtypes, np.full(n, 58.693), mcell, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    st = thermalize(gen, st, LIFE["temperature"])
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=20)
    cfg_path = out_dir / "selected.cfg"
    mon = ExtrapolationMonitor(model, select_threshold=0.0, output_path=str(cfg_path))
    reset_counts()
    t0 = time.perf_counter()
    st = run_with_extrapolation(sim, mon, st, LIFE["steps"], al_every=LIFE["al_every"],
                                ensemble="nvt", dt=0.001, temperature=LIFE["temperature"],
                                tdamp=0.1)
    mon.close()
    torch_sync()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in all_kernels()}
    plain = sum(k.plain_calls for k in all_kernels())
    selected = read_cfgs(str(cfg_path))
    n_evals = LIFE["steps"] // LIFE["al_every"] + 1
    print(f"[9 lifecycle] {n} atoms NVT {LIFE['temperature']:.0f} K, {LIFE['steps']} steps "
          f"graded every {LIFE['al_every']}: {wall:.2f} s, max grade {mon.max_grade:.4f}, "
          f"{len(selected)} configurations written (native row formatter: "
          f"{native.available()}, flags {native.build_flags(native.compiler())}); launches "
          f"{launches}, plain calls {plain}")
    check(bool(st.positions.isfinite().all()), "non-finite positions in the lifecycle MD")
    check(all(launches[k.name] > 0 for k in all_kernels()[:5]), "K1-K5 not all launched")
    check(launches["candidates_mega"] == n_evals, "K5 not once per grade step")
    check(plain == 0, "a plain twin ran in the lifecycle MD")
    check(native.available(), "the native library did not load")
    check(len(selected) == n_evals and all(len(c.positions) == n and c.grades is not None
                                           for c in selected), "selected .cfg read-back")
    report.update(
        n_configs=TRAIN["n_configs"], steps=TRAIN["steps"], warm_start_ms=ws_ms,
        warm_start_loss=l_ws,
        fit_ms_per_step=fit_ms / TRAIN["steps"], fit_peak_bytes=peak,
        losses=[float(v) for v in losses], cpu_vs_card_rel=rel,
        lifecycle=dict(atoms=n, steps=LIFE["steps"], max_grade=mon.max_grade,
                       selected=len(selected), k5_launches=launches["candidates_mega"]),
    )
    return report


def gate_phase(dev, card):
    """Phase 10: the accuracy gate at 32,000 atoms, the kernel path and the
    plain fp32 floor."""
    from mtp_tpu_torch.kernels import main_path_kernels, reset_counts
    from mtp_tpu_torch.utils import accuracy_gate

    f64 = accuracy_gate.oracle(device=dev)
    stats = f64[1]
    print(f"[10 gate] f64 oracle {stats['oracle_ms']:.1f} ms, peak device memory "
          f"{stats['oracle_peak_bytes'] / 2**30:.3f} GiB on {card}")
    out = dict(stats, card=card)
    for side, plain in (("fp32_kernel_path", False), ("fp32_plain_floor", True)):
        reset_counts()
        result, _ = accuracy_gate.run(device=dev, fp32_plain=plain, f64=f64)
        launches = {k.name: (k.launches, k.plain_calls) for k in main_path_kernels()}
        print(f"[10 gate] {side}: launches and plain calls {launches}")
        print(f"[10 gate] {json.dumps(result)}")
        if not plain:
            check(all(v[0] > 0 and v[1] == 0 for v in launches.values()),
                  "the gate's fp32 side did not run the kernel path")
            bad = accuracy_gate.failed_gates(result)
            check(not bad, f"accuracy gate at 32k: {bad}")
        out[side] = result
    return out


SHARDED_STEPS, SHARDED_ROUNDS = 60, 3  # phase 11a: steps per timed run, rounds in turns
SHARDED_B = dict(world=2, blocks=2, spb=30, timeout_s=300.0)  # phase 11b


def _f64_reference(m, pos, types, cell, dev, inverse_active_set=None):
    """The float64 plain path at `pos` on the card: energy, forces, virial,
    and with an MVS the neighborhood grades (the oracle of phases 3 and 6)."""
    import dataclasses

    import torch

    from mtp_tpu_torch.al.grades import candidate_vectors, nbh_grades
    from mtp_tpu_torch.models.mtp import MTPModel, mtp_energy_forces
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape

    model64 = MTPModel.from_data(m, device=dev, dtype=torch.float64)
    p = torch.as_tensor(pos, dtype=torch.float64, device=dev)
    c = torch.as_tensor(cell, dtype=torch.float64, device=dev)
    t = torch.as_tensor(types, dtype=torch.int32, device=dev)
    cut = model64.cutoff + 0.6
    nl = build_neighbor_list(p, c, cut, max_neighbors=64, grid=grid_shape(cell, cut))
    check(not bool(nl.overflow), "f64 list overflow")
    out = mtp_energy_forces(model64, p, t, nl.idx, c, nl.mirror)
    if inverse_active_set is not None:
        model64 = dataclasses.replace(model64, inverse_active_set=torch.as_tensor(
            inverse_active_set, dtype=torch.float64, device=dev))
        b, _ = candidate_vectors(model64, p, t, nl.idx, c)
        out["b"] = b
        out["grades"] = nbh_grades(b, model64.inverse_active_set)
    return out


def _gates(tag, n, e32, f32, w32, ref, phase="11 sharded"):
    """Phase 3's gates for fp32 energy, forces and virial against `ref`."""
    de = abs(float(e32) - float(ref["energy"])) / n
    df = max_err(f32, ref["forces"])
    dw = max_err(w32, ref["virial"])
    print(f"[{phase}] {tag}: dE/atom={de:.3e} (gate {GATE_DE:.0e}) max|dF|={df:.3e} "
          f"(gate {GATE_DF:.0e}) max|dW|={dw:.3e} (gate {GATE_DW:.0e})")
    check(de < GATE_DE and df < GATE_DF and dw < GATE_DW, f"{tag}: gate")
    return dict(de_per_atom=de, max_df=df, max_dw=dw)


def sharded_world_of_one(dev, card, m, model, state):
    """Phase 11a: ShardedSimulation.run_async on a world of one NCCL rank at
    the main path's width, beside Simulation.run_async from the same state,
    in turns. Returns (report, launch counts of K1-K8 in its first sharded
    run)."""
    import torch
    import torch.distributed as dist

    from mtp_tpu_torch.kernels import all_kernels, main_path_kernels, reset_counts
    from mtp_tpu_torch.md.simulation import Simulation
    from mtp_tpu_torch.ops.neighbors import K8, K11, grid_shape
    from mtp_tpu_torch.parallel.comm import Comm, init_world
    from mtp_tpu_torch.parallel.domain import partition_slabs
    from mtp_tpu_torch.parallel.sharded_md import ShardedState
    from mtp_tpu_torch.parallel.sharded_window import ShardedSimulation
    from mtp_tpu_torch.utils.prof import device_window, kernel_count, trace

    n = state.n_atoms
    np_state = [getattr(state, k).cpu().numpy() for k in ("positions", "velocities", "types",
                                                           "masses", "cell")]
    cell = np_state[4]
    w_cut = model.cutoff + 0.6
    kernels, on_path = all_kernels(), main_path_kernels() + [K8, K11]
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(dev)
        init_world(0, 1, f"{tmp}/store", backend="nccl")
        try:
            comm = Comm()
            check(comm.transport == "nccl" and comm.world == 1, "not a world of one NCCL rank")
            # one rank holds every atom: capacity n, no padding rows
            part = partition_slabs(*np_state[:4], cell, 1, cutoff=w_cut, capacity=n)
            ss0 = ShardedState.from_partition(part, cell, 0, dtype=torch.float32, device=dev)
            kw = dict(max_neighbors=64, skin=0.6, steps_per_rebuild=30)
            shd = ShardedSimulation(model, comm, capacity=n, grid=grid_shape(cell, w_cut), **kw)
            one = Simulation(model, compute_virial=False, **kw)
            shd.run_async(ss0, 30)  # warm-up, each as it is timed
            one.run_async(state, 30)
            rates = {"single": [], "sharded": []}
            for rnd in range(SHARDED_ROUNDS):
                for name in (("single", "sharded") if rnd % 2 == 0 else ("sharded", "single")):
                    torch_sync()
                    if rnd == 0 and name == "sharded":
                        reset_counts()
                    t0 = time.perf_counter()
                    if name == "single":
                        out1, _, fl1 = one.run_async(state, SHARDED_STEPS)
                    else:
                        outs, fls = shd.run_async(ss0, SHARDED_STEPS)
                    torch_sync()
                    rates[name].append(n * SHARDED_STEPS / (time.perf_counter() - t0))
                    if rnd == 0 and name == "sharded":
                        launches = {k.name: k.launches for k in kernels}
                        plain = {k.name: k.plain_calls for k in kernels}
            check(not bool(fl1) and not bool(fls.any()), "phase 11a flags set")
            print(f"[11a world of 1] NCCL, {n} atoms, level 16, fp32, J=64, {SHARDED_STEPS} NVE "
                  f"steps at spb 30: launches {launches}; plain calls {plain}")
            for k in on_path:
                check(launches[k.name] > 0, f"{k.name} was not launched on the sharded path")
                check(plain[k.name] == 0, f"{k.name}'s plain version ran on the sharded path")
            pos_s, frc_s = outs.gather_all([outs.positions, outs.forces], comm)
            dx = float(np.abs(pos_s - out1.positions.cpu().numpy()).max())
            dfs = float(np.abs(frc_s - out1.forces.cpu().numpy()).max())
            print(f"[11a world of 1] sharded vs single-device after {SHARDED_STEPS} steps: "
                  f"max|dx|={dx:.3e} A max|dF|={dfs:.3e} eV/A")
            check(dx < 1e-4 and dfs < GATE_DF, "sharded world of one left the single-device run")
            # the kernel path's energy, forces and virial at the final
            # positions (one refresh with the virial on) against float64
            shv = ShardedSimulation(model, comm, capacity=n, grid=shd.grid, compute_virial=True,
                                    **kw)
            st, ctx, _ = shv.rebuild(outs)
            st, _ = shv.steps(st, ctx, 0, refresh=True)
            gate = _gates("11a world of 1 vs f64 plain", n, st.potential_energy,
                          torch.as_tensor(st.gather(st.forces, comm), device=dev), st.virial,
                          _f64_reference(m, pos_s, np_state[2], cell, dev))
            # a block reads nothing back: steps under the sync debugger
            st, ctx, _ = shd.rebuild(outs)
            torch_sync()
            torch.cuda.set_sync_debug_mode("error")
            try:
                st, stale = shd.steps(st, ctx, 10)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(not bool(stale), "stale in the sync-debug block")
            # one traced block: the device's idle share
            with trace() as prof:
                shd.run_async(outs, 30, refresh=False)
                torch_sync()
            path = Path(tmp) / "sharded_trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
            span_us, busy_us = device_window(events)
        finally:
            dist.destroy_process_group()
    med = {k: float(np.median(v)) for k, v in rates.items()}
    report = dict(
        atoms=n, steps=SHARDED_STEPS, rounds=rates, median=med, sharded_vs_single=dict(
            max_dx=dx, max_df=dfs), f64=gate, traced_block=dict(
            span_ms=span_us / 1e3, busy_ms=busy_us / 1e3, idle_share=1.0 - busy_us / span_us,
            kernels_per_step=kernel_count(events) / 30), card=card,
    )
    print(f"[11a world of 1] atom-steps/s by round: single {[round(v) for v in rates['single']]}"
          f", sharded {[round(v) for v in rates['sharded']]}; medians single "
          f"{med['single']:.1f}, sharded {med['sharded']:.1f} on {card}")
    print(f"[11a world of 1] traced block (rebuild + 30 steps): span {span_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms, idle share {1.0 - busy_us / span_us:.4f}, "
          f"{kernel_count(events) / 30:.1f} kernels per step; no host read in a 10-step block")
    return report, launches


def sharded_kernel_errors(sim, st, ctx, tag):
    """K1-K5 against their plain twins on one rank's block inputs, as
    `sim.rebuild` left them in `ctx`: the halo-extended rows (N = C + 2H, no
    box's atom count), the padding rows in the trash bin and the ghost rows
    masked as centers. A collective (the positions' halo exchange): every
    rank calls it. Held to the kernel rows' limits; also checks that ghost
    and padding rows carry no live pair and no site energy, and that K3
    still fills the ghost rows. K11 against its plain twin on the rank's
    extended set first: every output bit-equal, and its order the
    rebuild's. Returns ({name: max_abs_err}, row counts)."""
    import torch

    from mtp_tpu_torch.ops.neighbors import cell_list, cell_list_plain
    from mtp_tpu_torch.ops.window_disp import window_geometry

    swl, k = ctx["swl"], ctx["consts"]
    model = sim.model
    (ext,) = sim._exchange_multi([(st.positions, 0.0)], ctx["sels"])
    sort_args = (ext.contiguous(), st.cell.contiguous(), sim.w_cut, sim.grid, sim.bin_cap,
                 ctx["real"].contiguous())
    cl, twin = cell_list(*sort_args, sort=True), cell_list_plain(*sort_args, sort=True)
    check(all(torch.equal(getattr(cl, f), getattr(twin, f)) for f in CELL_LIST_FIELDS + ("real",))
          and torch.equal(cl.order, swl.order),
          "K11 differs from its plain twin, or from the rebuild's order, on a rank's rows")
    pos_s = ext[swl.order].contiguous()
    own_s, real_s = ctx["own"][swl.order], ctx["real"][swl.order]
    ghost_s = real_s & ~own_s
    rows = dict(N=int(pos_s.shape[0]), own=int(own_s.sum()), ghost=int(ghost_s.sum()),
                padding=int((~real_s).sum()))
    print(f"{tag}kernels vs plain on this rank's rows: {rows}")
    check(rows["ghost"] > 0 and rows["padding"] > 0, "no ghost or no padding rows")
    disp, mask = window_geometry(pos_s, k["idx_t"], st.cell, k["pair_valid_t"], model.cutoff)
    args = (model.tables, disp, mask, k["it_row"], k["jtypes_t"], model.coeffs.radial_coeffs,
            k["xi_full"])
    errs, outs = {}, {}
    for name, (kern, plain) in window_kernel_calls(model, pos_s, st.cell, k, args).items():
        errs[name], outs[name] = hold(name, kern, plain, tag)
    errs["candidates_mega"] = hold_k5(model, k, args, tag)
    errs["cell_list"] = 0.0  # bit-equal, checked above
    check(float(mask[:, ~own_s].abs().max()) == 0.0, "a ghost or padding row has a live pair")
    check(float(outs["pair_forces_mega"][:, :, ~own_s].abs().max()) == 0.0,
          "K2 gave a masked row pair forces")
    check(float(outs["site_energies_mega"][~own_s].abs().max()) == 0.0,
          "K4 gave a masked row a site energy")
    f = outs["window_giveback"]
    check(bool((f[ghost_s].abs().sum(-1) > 0).any()), "K3 left every ghost row empty")
    check(float(f[~real_s].abs().max()) == 0.0, "K3 gave a padding row a force")
    return errs, rows


def sharded_rank_main(rank, world, workdir) -> int:
    """Phase 11b's rank process (``chip_smoke.py --sharded-rank R W DIR``):
    one of `world` gloo ranks on the one card, its messages staged through
    host memory; writes its result into DIR."""
    import dataclasses

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.kernels import all_kernels, reset_counts
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.neighbors import grid_shape
    from mtp_tpu_torch.parallel.comm import Comm, init_world
    from mtp_tpu_torch.parallel.domain import halo_capacities, partition_slabs
    from mtp_tpu_torch.parallel.sharded_md import ShardedState
    from mtp_tpu_torch.parallel.sharded_window import ShardedSimulation

    rank, world, workdir = int(rank), int(world), Path(workdir)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_world(rank, world, str(workdir / "store"), backend="gloo",
               timeout_s=SHARDED_B["timeout_s"])
    try:
        comm = Comm(transport="gloo-staged")
        d = np.load(workdir / "inputs.npz")
        model = MTPModel.from_data(make_mtp(16, species_count=1, seed=SEED), device=dev,
                                   dtype=torch.float32)
        model = dataclasses.replace(model, inverse_active_set=torch.as_tensor(
            d["inv"], dtype=torch.float32, device=dev))
        cell = d["cell"]
        w_cut = model.cutoff + 0.6
        part = partition_slabs(d["pos"], d["vel"], d["types"], d["masses"], cell, world,
                               cutoff=w_cut)
        hc = halo_capacities(part, cell, (world,), w_cut)
        sim = ShardedSimulation(model, comm, capacity=part.capacity, max_neighbors=64,
                                grid=grid_shape(cell, w_cut), skin=0.6,
                                steps_per_rebuild=SHARDED_B["spb"], halo_capacity=hc)
        ss = ShardedState.from_partition(part, cell, rank, dtype=torch.float32, device=dev)
        sim.run_async(ss, 2)  # warm-up, discarded
        ids0 = set(ss.ids[ss.real].tolist())
        n_steps = SHARDED_B["blocks"] * SHARDED_B["spb"]
        comm.barrier()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out, flags = sim.run(ss, n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st, ctx, f4 = sim.rebuild(out)
        g = sim.grade_eval(st, ctx)
        torch.cuda.synchronize()
        counts = {k.name: (k.launches, k.plain_calls) for k in all_kernels()}
        # after the counts: launches to compare kernels count nowhere
        errs, rows = sharded_kernel_errors(sim, st, ctx, "  ")
        pos, frc, grades = st.gather_all([st.positions, g["forces"], g["grades"]], comm, root=0)
        result = dict(
            rank=rank, capacity=part.capacity, halo=list(hc), NE=sim.NE,
            halo_after=sim.halo_capacity, max_neighbors=sim.max_neighbors,
            arrived=len(set(out.ids[out.real].tolist()) - ids0),
            own=int(out.real.sum()), ms_per_step=wall / n_steps * 1e3,
            flags=bool(torch.stack([*f4]).any()), counts=counts, kernel_errs=errs,
            kernel_rows=rows,
        )
        (workdir / f"rank{rank}.json").write_text(json.dumps(result))
        if rank == 0:
            np.savez(workdir / "result.npz", pos=pos, forces=frc, grades=grades,
                     energy=float(g["energy"]), virial=g["virial"].cpu().numpy(),
                     max_grade=float(g["max_grade"]))
    finally:
        dist.destroy_process_group()
    return 0


def sharded_two_ranks(dev, card, m, al_model, state):
    """Phase 11b: the 32k box as 2 slabs on 2 rank processes sharing the
    card through the staged gloo transport: NVE for 2 blocks, then one
    grade_eval with phase 7's MVS (K5), held against the float64 plain path
    and the single-device port at the same positions. Returns (report,
    launch counts summed over the ranks)."""
    import torch

    from mtp_tpu_torch.al.grades import grade_eval_window
    from mtp_tpu_torch.ops.neighbors import build_sorted_neighbor_list, grid_shape

    world = SHARDED_B["world"]
    inv = al_model.inverse_active_set.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "inputs.npz", inv=inv, **{k: getattr(state, a).cpu().numpy() for k, a in (
            ("pos", "positions"), ("vel", "velocities"), ("types", "types"),
            ("masses", "masses"), ("cell", "cell"))})
        logs = [open(Path(tmp) / f"rank{r}.log", "w") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--sharded-rank", str(r), str(world),
             tmp], cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
        deadline = time.monotonic() + SHARDED_B["timeout_s"]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        for r in range(world):
            for line in (Path(tmp) / f"rank{r}.log").read_text().splitlines()[-30:]:
                print(f"[11b rank {r}] {line}")
        check(all(p.returncode == 0 for p in procs),
              f"phase 11b ranks failed or timed out: exit codes {[p.returncode for p in procs]}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(world)]
        res = dict(np.load(Path(tmp) / "result.npz"))
    n = state.n_atoms
    for r in ranks:
        check(not r["flags"], f"rank {r['rank']}: flags set")
        check(r["halo_after"] == r["halo"] and r["max_neighbors"] == 64,
              f"rank {r['rank']}: run recovered from a tripped block")
    counts = {name: sum(r["counts"][name][0] for r in ranks) for name in ranks[0]["counts"]}
    plain = {name: sum(r["counts"][name][1] for r in ranks) for name in ranks[0]["counts"]}
    print(f"[11b 2 ranks] {n} atoms as 2 slabs on one card (gloo, staged through the host): "
          f"C={ranks[0]['capacity']} H={ranks[0]['halo']} rows per rank {ranks[0]['NE']}; "
          f"atoms arrived by migration {[r['arrived'] for r in ranks]}, own after "
          f"{[r['own'] for r in ranks]}; launches {counts}; plain calls {plain}")
    for name in ("window_disp", "pair_forces_mega", "window_giveback", "site_energies_mega",
                 "candidates_mega", "neighbor_rows", "cell_list"):
        check(counts[name] > 0, f"{name} was not launched on 2 ranks")
        check(plain[name] == 0, f"{name}'s plain version ran on 2 ranks")
    errs = {name: max(r["kernel_errs"][name] for r in ranks) for name in ranks[0]["kernel_errs"]}
    print(f"[11b 2 ranks] kernels vs plain twins on each rank's block rows "
          f"{[r['kernel_rows'] for r in ranks]}: max|kernel - plain| over the ranks {errs}")
    # each rank held every output to its limit (K5's to TOL_K5, some relative)
    for name, tol in TOL.items():
        check(errs[name] <= tol, f"{name} disagrees with its plain version on a rank's rows")
    check(sum(r["arrived"] for r in ranks) > 0, "no atom migrated in phase 11b")
    check(sum(r["own"] for r in ranks) == n, "atoms lost in migration")
    ms = [r["ms_per_step"] for r in ranks]
    print(f"[11b 2 ranks] {SHARDED_B['blocks']} blocks of {SHARDED_B['spb']} NVE steps: "
          f"{ms} ms per step by rank (host staging, rebuilds included) on {card}")
    # the grade pass at the final positions: float64 plain path, and the
    # single-device port (K1, K5, K3) at the same positions
    pos = res["pos"]
    types = state.types.cpu().numpy()
    cell = state.cell.cpu().numpy()
    f64 = _f64_reference(m, pos, types, cell, dev, inverse_active_set=inv)
    forces = torch.as_tensor(res["forces"], device=dev)
    gate = _gates("11b 2 ranks vs f64 plain", n, res["energy"], forces,
                  torch.as_tensor(res["virial"], device=dev), f64)
    g64 = f64["grades"].cpu().numpy()
    dg = float(np.abs(res["grades"] - g64).max()) / float(g64.max())
    dgm = abs(float(res["max_grade"]) - float(g64.max())) / float(g64.max())
    print(f"[11b 2 ranks] grades vs f64: max|dg|/max g={dg:.3e} (gate {GATE_GRADE_REL:.0e}), "
          f"max grade {float(res['max_grade']):.6f} rel err {dgm:.3e} "
          f"(gate {GATE_MAX_GRADE_REL:.0e})")
    check(dg < GATE_GRADE_REL and dgm < GATE_MAX_GRADE_REL, "phase 11b grades vs f64")
    p32 = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    c32 = state.cell
    cut = al_model.cutoff + 0.6
    swl = build_sorted_neighbor_list(p32, c32, cut, max_neighbors=64, grid=grid_shape(cell, cut))
    one = grade_eval_window(al_model, p32, state.types, c32, swl, al_model.inverse_active_set,
                            config_mode=False)
    single = _gates("11b 2 ranks vs single-device port", n, res["energy"], forces,
                    torch.as_tensor(res["virial"], device=dev), one)
    dgs = abs(float(res["max_grade"]) - float(one["max_grade"])) / float(one["max_grade"])
    print(f"[11b 2 ranks] max grade vs single-device port: rel err {dgs:.3e} "
          f"(gate {GATE_MAX_GRADE_REL:.0e})")
    check(dgs < GATE_MAX_GRADE_REL, "phase 11b max grade vs the single-device port")
    report = dict(atoms=n, ranks=world, capacity=ranks[0]["capacity"], halo=ranks[0]["halo"],
                  rows_per_rank=ranks[0]["NE"], arrived=[r["arrived"] for r in ranks],
                  ms_per_step=ms, f64=gate, single_device=single, grade_rel=dg,
                  max_grade_rel=dgm, max_grade_vs_single_rel=dgs,
                  kernel_rows=[r["kernel_rows"] for r in ranks], card=card)
    return report, counts, errs


def sharded_phase(dev, card, m, model, state, al_model):
    """Phase 11: the sharded path, (a) and (b). Returns (report, {kernel
    name: {"a": launches, "b": launches}}, {kernel name: max_abs_err on
    (b)'s rank rows})."""
    a, la = sharded_world_of_one(dev, card, m, model, state)
    b, lb, errs = sharded_two_ranks(dev, card, m, al_model, state)
    names = set(la) | set(lb)
    return dict(world_of_one=a, two_ranks=b), {
        k: {"a": la.get(k), "b": lb.get(k)} for k in names}, errs


# phase 12: 6 blocks of 10 steps from the fresh 300 K lattice (its first
# 30 steps outrun a 0.6 A skin), 2 ranks in 12b
NARROW = dict(reps=(500, 4, 4), n_steps=10, blocks=6, world=2, timeout_s=300.0)


def narrow_box(dev):
    """Phase 12's box: fcc 500 x 4 x 4 cells at a = 4.0 A (32,000 atoms,
    2,000 x 16 x 16 A) at 300 K in fp32, from the seed."""
    import torch

    from mtp_tpu_torch.md.simulation import make_lattice
    from mtp_tpu_torch.md.state import init_state, thermalize

    pos, types, cell = make_lattice("fcc", 4.0, NARROW["reps"])
    st = init_state(pos, types, np.full(len(pos), 58.693), cell, dtype=torch.float32, device=dev)
    return thermalize(torch.Generator(device=dev).manual_seed(SEED), st, 300.0)


def nvt_dx_limit(ref):
    """Per-coordinate limit of a position difference from the reference
    positions `ref` (fp32): the larger of 1e-4 A and one fp32 spacing of
    the reference coordinate. Two NVT runs that sum the thermostat's kinetic
    energy in different orders are not bit-equal, and above 1,024 A one
    spacing is 1.221e-04 A, more than 1e-4."""
    import torch

    return torch.clamp(torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref, min=1e-4)


def narrow_world_of_one(dev, card, m, model, state):
    """Phase 12a: the long box on a world of one NCCL rank through the
    row-gather API, NVE and NVT blocks beside the single-device run.
    Returns (report, launch counts of K1-K8 in the NVE run)."""
    import torch
    import torch.distributed as dist

    from mtp_tpu_torch.kernels import all_kernels, main_path_kernels, reset_counts
    from mtp_tpu_torch.md.simulation import Simulation
    from mtp_tpu_torch.ops.neighbors import K8, K11, grid_shape
    from mtp_tpu_torch.parallel.comm import Comm, init_world
    from mtp_tpu_torch.parallel.domain import partition_slabs
    from mtp_tpu_torch.parallel.sharded_md import (
        ShardedState,
        compute_sharded_forces,
        make_sharded_md_block,
    )

    n = state.n_atoms
    cell = state.cell.cpu().numpy()
    w_cut = model.cutoff + 0.6
    grid = grid_shape(cell, w_cut)
    k, blocks = NARROW["n_steps"], NARROW["blocks"]
    kernels, on_path = all_kernels(), main_path_kernels() + [K8, K11]
    report = dict(atoms=n, grid=list(grid), steps=k * blocks, card=card)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(dev)
        init_world(0, 1, f"{tmp}/store", backend="nccl")
        try:
            comm = Comm()
            part = partition_slabs(*(getattr(state, a).cpu().numpy() for a in (
                "positions", "velocities", "types", "masses")), cell, 1, cutoff=w_cut,
                capacity=n)
            ss0 = ShardedState.from_partition(part, cell, 0, dtype=torch.float32, device=dev)
            # both tally the virial every step, as the JAX block does
            one = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=k,
                             compute_virial=True)
            for ens in ("nve", "nvt"):
                kw = dict(ensemble=ens, temperature=300.0, tdamp=0.1)
                block = make_sharded_md_block(model, comm, capacity=n, max_neighbors=64,
                                              grid=grid, skin=0.6, n_steps=k, **kw)
                check(block.sim.grid == (357, 2, 2), f"phase 12 grid {block.sim.grid}")
                block(ss0)  # warm-up, each as it is timed
                one.run_async(state, k, **kw)
                torch_sync()
                reset_counts()
                t0 = time.perf_counter()
                s, flags = ss0, []
                for _ in range(blocks):
                    s, f = block(s)
                    flags.append(f.any())
                torch_sync()
                wall = time.perf_counter() - t0
                launches = {kk.name: kk.launches for kk in kernels}
                plain = {kk.name: kk.plain_calls for kk in kernels}
                t0 = time.perf_counter()
                ref, aux = state, None
                for _ in range(blocks):  # each call refreshes on its new list, as a block does
                    ref, aux, f = one.run_async(ref, k, aux=aux, **kw)
                    flags += [f.overflow, f.stale]
                torch_sync()
                wall1 = time.perf_counter() - t0
                check(not bool(torch.stack(flags).any()), f"phase 12a {ens} flags set")
                for kk in on_path:
                    check(launches[kk.name] > 0, f"{kk.name} was not launched on the long box")
                    check(plain[kk.name] == 0, f"{kk.name}'s plain version ran on the long box")
                bit = all(torch.equal(getattr(s, a), getattr(ref, a)) for a in (
                    "positions", "velocities", "forces", "potential_energy"))
                dx = float((s.positions - ref.positions).abs().max())
                dx_of_limit = float(((s.positions - ref.positions).abs()
                                     / nvt_dx_limit(ref.positions)).max())
                dfs = float((s.forces - ref.forces).abs().max())
                steps = k * blocks
                report[ens] = dict(
                    bit_equal=bit, max_dx=dx, max_dx_of_limit=dx_of_limit, max_df=dfs,
                    launches=launches, plain=plain,
                    ms_per_step=wall / steps * 1e3, atom_steps_per_s=n * steps / wall,
                    single_ms_per_step=wall1 / steps * 1e3,
                    single_atom_steps_per_s=n * steps / wall1,
                )
                print(f"[12a long box, world of 1] {ens}: {n} atoms, grid {grid}, {blocks} blocks "
                      f"of {k}: {wall / steps * 1e3:.4f} ms per step ({n * steps / wall:.1f} "
                      f"atom-steps/s), single-device {wall1 / steps * 1e3:.4f} ms "
                      f"({n * steps / wall1:.1f}); bit-equal {bit}, max|dx|={dx:.3e} A "
                      f"({dx_of_limit:.3f} of its limit) max|dF|={dfs:.3e} eV/A; launches "
                      f"{launches}; plain calls {plain} "
                      f"on {card}")
                if ens == "nve":
                    check(bit, "phase 12a NVE left the single-device trajectory")
                    nve_block, nve_out, nve_launches = block, s, launches
                else:
                    check(dx_of_limit <= 1.0 and dfs < GATE_DF,
                          "phase 12a NVT left the single-device run")
            # a block reads nothing back
            torch_sync()
            torch.cuda.set_sync_debug_mode("error")
            try:
                nve_block(nve_out)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            # the kernel path's energy, forces and virial at the final NVE
            # positions against float64
            out, fl = compute_sharded_forces(model, comm, capacity=n, max_neighbors=64,
                                             grid=grid, skin=0.6)(nve_out)
            check(not bool(fl.any()), "phase 12a force evaluation flags")
            pos, frc = out.gather_all([out.positions, out.forces], comm)
            report["f64"] = _gates("12a long box vs f64 plain", n, out.potential_energy,
                                   torch.as_tensor(frc, device=dev), out.virial,
                                   _f64_reference(m, pos, state.types.cpu().numpy(), cell, dev),
                                   phase="12 long box")
        finally:
            dist.destroy_process_group()
    print("[12a long box, world of 1] an NVE block ran under the sync debugger")
    return report, nve_launches


def narrow_rank(rank, world, data_dir):
    """Phase 12b's rank (a ``mtp_tpu_torch.parallel.launch`` rank of gloo,
    its messages staged through host memory, on the one card): an NVE and
    an NVT block, the standalone grades (``make_sharded_grades`` and the
    monitor's engine) and the window engine's grade pass, then K1-K5
    against their plain twins on this rank's rows."""
    import dataclasses

    import torch

    from mtp_tpu_torch.al.driver import ShardedExtrapolationMonitor
    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.kernels import all_kernels, reset_counts
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.neighbors import grid_shape
    from mtp_tpu_torch.parallel.comm import Comm
    from mtp_tpu_torch.parallel.domain import halo_capacities, partition_slabs
    from mtp_tpu_torch.parallel.sharded_md import (
        ShardedState,
        make_sharded_grades,
        make_sharded_md_block,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    comm = Comm(transport="gloo-staged")
    d = np.load(Path(data_dir) / "narrow.npz")
    model = MTPModel.from_data(make_mtp(16, species_count=1, seed=SEED), device=dev,
                               dtype=torch.float32)
    model = dataclasses.replace(model, inverse_active_set=torch.as_tensor(
        d["inv"], dtype=torch.float32, device=dev))
    cell = d["cell"]
    w_cut = model.cutoff + 0.6
    part = partition_slabs(d["pos"], d["vel"], d["types"], d["masses"], cell, world, cutoff=w_cut)
    hc = halo_capacities(part, cell, (world,), w_cut)
    common = dict(capacity=part.capacity, max_neighbors=64, grid=grid_shape(cell, w_cut),
                  skin=0.6, n_steps=NARROW["n_steps"], halo_capacity=hc)
    nve = make_sharded_md_block(model, comm, **common)
    nvt = make_sharded_md_block(model, comm, ensemble="nvt", temperature=300.0, tdamp=0.1,
                                **common)
    ss = ShardedState.from_partition(part, cell, rank, dtype=torch.float32, device=dev)
    nve(ss)  # warm-up, discarded
    ids0 = set(ss.ids[ss.real].tolist())
    comm.barrier()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    s, flags = ss, []
    half = NARROW["blocks"] // 2
    for block in [nve] * half + [nvt] * half:  # an NVE run, then NVT from it
        s, f = block(s)
        flags.append(f.any())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grid_cut = grid_shape(cell, model.cutoff)
    grades_fn = make_sharded_grades(model, comm, capacity=part.capacity, max_neighbors=64,
                                    grid=grid_cut, halo_capacity=hc)
    g_std, grades_std, g_flags = grades_fn(s)
    mon = ShardedExtrapolationMonitor(model, comm, capacity=part.capacity, grid=grid_cut,
                                      max_neighbors=64, halo_capacity=hc)
    g_mon = float(mon.evaluate(s))
    sim = nvt.sim
    st, ctx, f4 = sim.rebuild(s)
    win = sim.grade_eval(st, ctx)
    torch.cuda.synchronize()
    counts = {k.name: (k.launches, k.plain_calls) for k in all_kernels()}
    # after the counts: launches to compare kernels count nowhere
    errs, rows = sharded_kernel_errors(sim, st, ctx, "  ")
    pos, frc, grades = st.gather_all([st.positions, win["forces"], win["grades"]], comm, root=0)
    (std,) = s.gather_all([grades_std], comm, root=0)
    mon_grades = mon.nbh_grades  # a collective
    flags = torch.stack(flags + [g_flags, torch.stack(list(f4)).any()])
    return dict(
        rank=rank, capacity=part.capacity, halo=list(hc), NE=sim.NE, wall_s=wall,
        ms_per_step=wall / (NARROW["blocks"] * NARROW["n_steps"]) * 1e3, flags=flags.tolist(),
        arrived=len(set(s.ids[s.real].tolist()) - ids0), own=int(s.real.sum()), counts=counts,
        kernel_errs=errs, kernel_rows=rows, max_grade_standalone=float(g_std),
        max_grade_monitor=g_mon, max_grade_window=float(win["max_grade"]),
        monitor_max_neighbors=mon.max_neighbors,
        result=None if rank else dict(
            pos=pos, forces=frc, grades=grades, grades_standalone=std,
            grades_monitor=mon_grades, energy=float(win["energy"]),
            virial=win["virial"].cpu().numpy()),
    )


def narrow_two_ranks(dev, card, m, al_model, state):
    """Phase 12b: the long box as 2 slabs along x on 2 gloo rank processes
    sharing the card. Returns (report, launch counts summed over the ranks,
    {kernel: max_abs_err over the ranks' rows})."""
    import torch

    from mtp_tpu_torch.parallel.launch import World

    inv = al_model.inverse_active_set.cpu().numpy()
    world = NARROW["world"]
    with tempfile.TemporaryDirectory() as tmp:
        arrays = {k: getattr(state, a).cpu().numpy() for k, a in (
            ("pos", "positions"), ("vel", "velocities"), ("types", "types"),
            ("masses", "masses"), ("cell", "cell"))}
        np.savez(Path(tmp) / "narrow.npz", inv=inv, **arrays)
        w = World("chip_smoke:narrow_rank", world, Path(tmp) / "world",
                  timeout=NARROW["timeout_s"], backend="gloo", path=[REPO], data_dir=tmp)
        try:
            ranks = w.results()
        finally:
            w.kill()
            for r in range(world):
                for line in w.log(r).splitlines()[-20:]:
                    print(f"[12b rank {r}] {line}")
    n = state.n_atoms
    for r in ranks:
        check(not any(r["flags"]), f"phase 12b rank {r['rank']}: flags set {r['flags']}")
        check(r["monitor_max_neighbors"] == 64, "phase 12b: the standalone engine regrew")
    counts = {k: sum(r["counts"][k][0] for r in ranks) for k in ranks[0]["counts"]}
    plain = {k: sum(r["counts"][k][1] for r in ranks) for k in ranks[0]["counts"]}
    print(f"[12b long box, 2 ranks] {n} atoms as 2 slabs on one card (gloo, staged through the "
          f"host): C={ranks[0]['capacity']} H={ranks[0]['halo']} rows per rank "
          f"{ranks[0]['NE']}; atoms arrived {[r['arrived'] for r in ranks]}; launches {counts}; "
          f"plain calls {plain}")
    for name in ("window_disp", "pair_forces_mega", "window_giveback", "site_energies_mega",
                 "candidates_mega", "neighbor_rows", "cell_list"):
        check(counts[name] > 0, f"{name} was not launched on the long box's 2 ranks")
        check(plain[name] == 0, f"{name}'s plain version ran on the long box's 2 ranks")
    errs = {k: max(r["kernel_errs"][k] for r in ranks) for k in ranks[0]["kernel_errs"]}
    print(f"[12b long box, 2 ranks] kernels vs plain twins on each rank's rows "
          f"{[r['kernel_rows'] for r in ranks]}: max|kernel - plain| {errs}")
    for name, tol in TOL.items():
        check(errs[name] <= tol, f"{name} disagrees with its plain version on a rank's rows")
    check(sum(r["own"] for r in ranks) == n, "atoms lost in migration")
    steps = NARROW["blocks"] * NARROW["n_steps"]
    wall = max(r["wall_s"] for r in ranks)
    ms = [r["ms_per_step"] for r in ranks]
    print(f"[12b long box, 2 ranks] {NARROW['blocks'] // 2} NVE then {NARROW['blocks'] // 2} NVT "
          f"blocks of {NARROW['n_steps']}: {ms} ms per "
          f"step by rank, {n * steps / wall:.1f} atom-steps/s on {card}")
    res = ranks[0]["result"]
    cell = state.cell.cpu().numpy()
    f64 = _f64_reference(m, res["pos"], state.types.cpu().numpy(), cell, dev,
                         inverse_active_set=inv)
    gate = _gates("12b long box, 2 ranks vs f64 plain", n, res["energy"],
                  torch.as_tensor(res["forces"], device=dev),
                  torch.as_tensor(res["virial"], device=dev), f64, phase="12 long box")
    from mtp_tpu_torch.al.grades import nbh_grades

    g64 = f64["grades"].cpu().numpy()
    top = float(g64.max())
    inv64 = torch.as_tensor(inv, dtype=torch.float64, device=dev)
    floor = float(np.abs(nbh_grades(f64["b"].float().double(), inv64).cpu().numpy()
                         - g64).max()) / top
    # both engines' grades (the window engine's, and the standalone one's
    # through make_sharded_grades and the monitor) against float64 at phase
    # 6's gate; besides, the standalone grades against the window engine's
    grade_errs = {name: float(np.abs(res[name] - g64).max()) / top
                  for name in ("grades", "grades_standalone", "grades_monitor")}
    vs_window = float(np.abs(res["grades_standalone"] - res["grades"]).max()) / top
    worst = int(np.abs(res["grades_standalone"] - g64).argmax())
    print(f"[12b long box, 2 ranks] grades vs f64, max|dg|/max g (gate {GATE_GRADE_REL:.0e}; "
          f"f64 b rounded to fp32 alone: {floor:.3e}; K5 on its General double stages: "
          f"{GRADE_REL_12B_GENERAL:.3e}): {grade_errs}; standalone vs window "
          f"{vs_window:.3e}; the standalone's worst atom {worst} at "
          f"x={res['pos'][worst, 0]:.4f} A: f64 {g64[worst]:.6f}, window "
          f"{res['grades'][worst]:.6f}, standalone {res['grades_standalone'][worst]:.6f}")
    check(grade_errs["grades"] < GATE_GRADE_REL, "phase 12b window grades vs f64")
    check(grade_errs["grades_standalone"] < GATE_GRADE_REL,
          "phase 12b standalone grades vs f64")
    check(vs_window < GATE_GRADE_REL, "phase 12b standalone grades vs the window engine's")
    witness = fp32_grade_witness(m, res["pos"], state.types.cpu().numpy(), cell, dev, inv, g64)
    check(np.array_equal(res["grades_monitor"], res["grades_standalone"]),
          "the monitor's standalone grades")
    g_win = ranks[0]["max_grade_window"]
    g_std = ranks[0]["max_grade_standalone"]
    dgm = abs(g_win - top) / top
    dstd = abs(g_std - g_win) / g_win
    print(f"[12b long box, 2 ranks] max grade window {g_win:.6f} ({dgm:.3e} from f64, gate "
          f"{GATE_MAX_GRADE_REL:.0e}), standalone {g_std:.6f} ({dstd:.3e} from the window "
          f"engine's, limit 1e-3), monitor {ranks[0]['max_grade_monitor']:.6f}")
    check(dgm < GATE_MAX_GRADE_REL, "phase 12b max grade vs f64")
    check(dstd < 1e-3, "phase 12b standalone grade vs the window engine's")
    check(ranks[0]["max_grade_monitor"] == g_std, "the monitor's standalone grade")
    report = dict(atoms=n, ranks=world, capacity=ranks[0]["capacity"], halo=ranks[0]["halo"],
                  rows_per_rank=ranks[0]["NE"], arrived=[r["arrived"] for r in ranks],
                  ms_per_step=ms, atom_steps_per_s=n * steps / wall, f64=gate,
                  grade_rel=grade_errs, grade_rounding_floor=floor, max_grade_rel=dgm,
                  standalone_vs_window_rel=dstd, standalone_vs_window_grades_rel=vs_window,
                  fp32_grade_witness=witness,
                  kernel_rows=[r["kernel_rows"] for r in ranks], card=card)
    return report, counts, errs


def fp32_grade_witness(m, pos, types, cell, dev, inv, g64):
    """Where fp32 grade error comes from: the fp32 plain path's grades (the
    arithmetic of K5 before it computed in float64; the product in float64)
    against float64, at `pos` and at `pos` translated by -1000 A along x
    (its own float64 reference), with the largest error in each tenth of the
    box along x. If fp32 coordinates near 2,000 A caused the error, the
    translation would move it; if the arithmetic does, it stays."""
    import torch

    from mtp_tpu_torch.al.grades import candidate_vectors, nbh_grades
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape

    model32 = MTPModel.from_data(m, device=dev, dtype=torch.float32)
    inv64 = torch.as_tensor(inv, dtype=torch.float64, device=dev)
    c32 = torch.as_tensor(cell, dtype=torch.float32, device=dev)
    t = torch.as_tensor(types, dtype=torch.int32, device=dev)
    cut = model32.cutoff + 0.6
    length = float(cell[0, 0])
    out = {}
    for tag, shift in (("at", 0.0), ("translated", -1000.0)):
        p32 = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        p32 = p32 - torch.tensor([1000.0, 0.0, 0.0], device=dev) if shift else p32
        ref = g64 if not shift else _f64_reference(
            m, p32.double().cpu().numpy(), types, cell, dev, inverse_active_set=inv
        )["grades"].cpu().numpy()
        nl = build_neighbor_list(p32, c32, cut, max_neighbors=64, grid=grid_shape(cell, cut))
        check(not bool(nl.overflow), "witness list overflow")
        b32, _ = candidate_vectors(model32, p32, t, nl.idx, c32)
        err = np.abs(nbh_grades(b32.double(), inv64).cpu().numpy() - ref) / float(ref.max())
        tenth = np.clip((np.asarray(pos)[:, 0] // (length / 10)).astype(int), 0, 9)
        out[tag] = dict(max_rel=float(err.max()),
                        by_tenth=[float(err[tenth == q].max()) for q in range(10)])
    print(f"[12b long box, witness] the fp32 plain path's grades vs f64, max|dg|/max g at "
          f"these positions {out['at']['max_rel']:.3e}, translated by -1000 A along x "
          f"{out['translated']['max_rel']:.3e}; largest by tenth of the box along x: at "
          f"{[f'{e:.2e}' for e in out['at']['by_tenth']]}, translated "
          f"{[f'{e:.2e}' for e in out['translated']['by_tenth']]}")
    return out


def narrow_phase(dev, card, m, model, al_model):
    """Phase 12: the long narrow box, (a) and (b), then the accuracy
    validation example at its default size. Returns (report, {kernel name:
    {"a": launches, "b": launches}}, {kernel name: max_abs_err on (b)'s rank
    rows})."""
    from mtp_tpu_torch.examples import accuracy_validation

    t0 = time.perf_counter()
    state = narrow_box(dev)
    a, la = narrow_world_of_one(dev, card, m, model, state)
    b, lb, errs = narrow_two_ranks(dev, card, m, al_model, state)
    with tempfile.TemporaryDirectory() as tmp:
        av = accuracy_validation.main(device="cuda", out_dir=tmp)
    wall = time.perf_counter() - t0
    print(f"[12 long box] phase 12 took {wall:.1f} s")
    check(wall < 60.0, "phase 12 took a minute or more")
    names = set(la) | set(lb)
    return dict(world_of_one=a, two_ranks=b, accuracy_validation=av, seconds=wall), {
        k: {"a": la.get(k), "b": lb.get(k)} for k in names}, errs


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
    from mtp_tpu_torch.ops.md_step import K9, K10
    from mtp_tpu_torch.ops.neighbors import (
        K8,
        K11,
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

    # ---- 3b. the float64 oracle repeats bit for bit
    oracle_report = oracle_repeat_phase(model64, p64, ty, c64, nl64)

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
    launches = {k.name: k.launches for k in kernels + [K8, K9, K10, K11]}
    plain = {k.name: k.plain_calls for k in kernels + [K8, K9, K10, K11]}
    # run_async rebuilds once a block
    rebuilds = -(-60 // eq.steps_per_rebuild) - (-210 // sim.steps_per_rebuild)
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
    for k in (K8, K11):
        print(f"[4 main path] {k.name}: {launches[k.name]} launches for the run's {rebuilds} "
              f"rebuilds, its plain twin {plain[k.name]} calls")
        check(launches[k.name] == rebuilds, f"{k.name} did not launch once per main-path rebuild")
        check(plain[k.name] == 0, f"{k.name}'s plain twin ran on the main path")
    print(f"[4 main path] {K9.name}: {launches[K9.name]} launches and {K10.name}: "
          f"{launches[K10.name]} for the run's 270 steps, their plain twins "
          f"{plain[K9.name]} and {plain[K10.name]} calls")
    check(launches[K9.name] == 2 * 270 and launches[K10.name] == 270,
          f"{K9.name} did not launch twice and {K10.name} once a main-path step")
    check(plain[K9.name] == 0 and plain[K10.name] == 0,
          f"{K9.name}'s or {K10.name}'s plain twin ran on the main path")
    drift = (float(e1) - float(e0)) / n
    rate = n * 210 / wall
    print(f"[4 main path] E_tot drift over 210 steps: {drift:.3e} eV/atom; "
          f"{rate:.1f} atom-steps/s ({wall:.3f} s wall) on {card}")

    # ---- 5. kernels at the main path's shapes
    print("[5 kernels] main-path shapes (32000 atoms, J=64, level 16), fp32")
    res, live, stage_calls = compare_kernels(model, state.positions, state.cell, state.types,
                                             nl, timing=True)
    j = nl.idx.shape[1]
    steps = 60 + 210
    print(f"[5 kernels] {live:.0f} live pairs ({live / n:.2f} per atom); bound = max(bytes / "
          f"{PEAK_BYTES:.3g} B/s, fp32 operations / {PEAK_FLOPS:.3g} FLOP/s)")
    print("[5b neighbor list] K11 and K8 against their plain twins on the fcc box, fp32, J=64, "
          f"cutoff + skin {ROWS_CUT} A")
    rows_k8, rows_calls = neighbor_rows_phase(dev, card)
    stage_calls.update(rows_calls)
    print("[5c md step] K9 and K10 against their plain twins on random fp32 arrays")
    rows_md, md_calls = md_step_phase(dev, card)
    stage_calls.update(md_calls)

    # ---- 6. active-learning kernels, and the fp32 grade step vs float64
    al_kernel_phase(m2, p32, ty, c32, swl)

    # ---- 7. the AL path at full width
    rows7, al_model, al_state = al_path_phase(dev, card)

    # ---- 5, continued: device time by stage kernel at phase 5's inputs.
    # Taken after phase 7: a torch.profiler session slows the host-bound
    # runs that follow it in the process and widens their spread, and phase
    # 7 times two such runs against each other; and not at the end, where
    # the windows lost events. The AL path's waits by program span: `python
    # -m mdbench.run --workload fcc32k.al10 --seed 1 --seconds 20 --trace 1`.
    stages = stage_ms(stage_calls)
    print_stages("5", stages)

    # ---- 8. the other ensembles, run, FIRE and AL under NPT
    ens_report = ensembles_phase(dev, card, m2, p32, c32, ty, model, state, al_model,
                                 al_state)

    # ---- 9. training and the lifecycle; 10. the accuracy gate at 32k
    with tempfile.TemporaryDirectory() as tmp:
        train_report = training_phase(dev, card, Path(tmp))
    gate_report = gate_phase(dev, card)

    # ---- 11. the sharded path: a world of one NCCL rank at full width, and
    # two gloo ranks on the one card
    sharded_report, sharded_counts, sharded_errs = sharded_phase(dev, card, m, model, state,
                                                                 al_model)

    # ---- 12. the long narrow box: the row-gather API on one NCCL rank and on
    # two ranks sharing the card, the standalone grades
    narrow_report, narrow_counts, narrow_errs = narrow_phase(dev, card, m, model, al_model)

    # ---- 5, continued: the kernels line's rows of K1-K4
    rows = []
    from mtp_tpu_torch.ops.fused_moments import resident_warps

    warps = resident_warps(model.tables, j)
    print(f"[5 occupancy] resident warps per SM of the stage kernels (CUDA occupancy "
          f"calculator): {warps}")
    stage_warps = {"pair_forces_mega": ("basic", "DAG", "tail"),
                   "site_energies_mega": ("basic", "DAG")}
    for k in kernels:
        err, ms, plain_ms = res[k.name]
        row = kernel_row(k, launches[k.name], err, ms, plain_ms, model, n, j, live)
        dev_ms = sum(stages[k.name].values())
        share = device_share(row, dev_ms)
        if k.name in stage_warps:
            row["resident_warps"] = {key: warps[key] for key in stage_warps[k.name]}
        print(f"  {k.name}: {ms:.4f} ms by CUDA events around the wrapper, {dev_ms:.4f} ms "
              f"on the device (plain {plain_ms:.4f} ms); bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {share} of the device time; "
              f"{launches[k.name] / steps:.4f} launches per main-path step")
        rows.append(row)
    rows += rows7
    for label, row in rows_k8.items():
        dev_ms = sum(ms for name, ms in stages[label].items()
                     if any(s in name for s in ROWS_STAGES[row["name"]]))
        share = device_share(row, dev_ms)
        print(f"  {label}: {row['ms']:.4f} ms by CUDA events around the wrapper, "
              f"{dev_ms:.4f} ms on the device (plain {row['plain_ms']:.4f} ms); bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), {share} of the device time; "
              f"{row['launches_per_build']} call per rebuild")
        row["main_path_launches"] = launches[row["name"]]
        row["main_path_rebuilds"] = rebuilds
        rows.append(row)
    for label, row in rows_md.items():
        kernel = "verlet_top2_kernel" if row["name"] == "verlet_top2" else "md_step_kernel"
        dev_ms = sum(ms for name, ms in stages[label].items() if kernel in name)
        share = device_share(row, dev_ms)
        row["main_path_launches_per_step"] = launches[row["name"]] / steps
        print(f"  {label}: {row['ms']:.4f} ms by CUDA events around the wrapper, "
              f"{dev_ms:.4f} ms on the device (plain chain {row['plain_ms']:.4f} ms); bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), {share} of the device time; "
              f"{launches[row['name']] / steps:.4f} launches of {row['name']} per main-path "
              f"step")
        rows.append(row)
    for row in rows:
        row["sharded_launches"] = sharded_counts.get(row["name"])
        # (b)'s kernel-vs-plain check on the rank rows; None off the path
        row["sharded_max_abs_err"] = sharded_errs.get(row["name"])
        row["narrow_launches"] = narrow_counts.get(row["name"])
        row["narrow_max_abs_err"] = narrow_errs.get(row["name"])
    print(card)
    print(json.dumps({"ensembles": ens_report}))
    print(json.dumps({"sharded": sharded_report}))
    print(json.dumps({"narrow": narrow_report}))
    print(json.dumps({"oracle": oracle_report, "training": train_report,
                      "accuracy_gate": gate_report}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank_main(*sys.argv[2:5]))
    sys.exit(main())
