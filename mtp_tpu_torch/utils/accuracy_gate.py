"""Accuracy gate at bench scale: the fp32 kernel path against the float64
plain path, both on the card, in one process.

Port of ``tools/accuracy_gate.py`` (its fp32 mode): the same configuration
(:data:`CFG`, a level-16 potential on a 32,000-atom fcc box) at the same
thermally displaced positions, rounded to fp32 once so both sides evaluate
one representable configuration; the gate measures the evaluator's
arithmetic, not the fp32 representation of the coordinates. The oracle is
the port's float64 plain path (``models.mtp.mtp_energy_forces``), which
repeats bit for bit on the card; it is computed here and kept in no file.

Usage (on the card; ``device`` defaults to ``"cuda"``):

    python -m mtp_tpu_torch.utils.accuracy_gate               # fp32 kernel path
    python -m mtp_tpu_torch.utils.accuracy_gate --fp32-plain  # plain fp32 floor

``--fp32-plain`` runs the fp32 side on the plain path instead of the
kernels: the rounding floor of fp32 arithmetic, in place of the reference's
``--fp32-cpu``. The reference's ``--df32`` mode is not ported (the card has
float64). Prints the oracle's time and peak device memory on one line and
the gate's JSON (the keys of ``tools/accuracy_gate.py``'s ``run_fp32``) on
the next; exits non-zero if a gate of :data:`GATES` fails.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

CFG = dict(level=16, reps=(20, 20, 20), a=4.0, seed=0, temperature=300.0)
# dE/atom (f64-summed site energies) [eV], max|dF| [eV/A], max|dW| [eV]
GATES = dict(dE_per_atom_f64_host_sum=1e-6, max_abs_dF=5e-4, max_dvirial=5e-2)


def config_positions(reps=CFG["reps"]):
    """The bench box, thermally displaced (sigma 0.07 A, ~300 K for fcc Ni)
    from a seed, with positions and cell rounded to fp32 once."""
    from mtp_tpu_torch.md.simulation import make_lattice

    pos, types, cell = make_lattice("fcc", CFG["a"], reps)
    rng = np.random.default_rng(CFG["seed"])
    pos = pos + rng.normal(scale=0.07, size=pos.shape)
    pos = pos.astype(np.float32).astype(np.float64)
    cell = np.asarray(cell, np.float32).astype(np.float64)
    return pos, types, cell


def _plain(model, pos, types, cell, dtype, dev):
    """Forces, energy, virial and site energies on the plain path."""
    from mtp_tpu_torch.models.mtp import mtp_energy_forces
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape

    p = torch.as_tensor(pos, dtype=dtype, device=dev)
    c = torch.as_tensor(cell, dtype=dtype, device=dev)
    nl = build_neighbor_list(p, c, model.cutoff, max_neighbors=64,
                             grid=grid_shape(cell, model.cutoff))
    if bool(nl.overflow):
        raise RuntimeError("neighbor list overflow at J=64")
    t = torch.as_tensor(types, dtype=torch.int32, device=dev)
    return mtp_energy_forces(model, p, t, nl.idx, c, nl.mirror)


def _kernel_path(model, pos, types, cell, dev):
    """Forces, energy, virial and site energies on the fp32 window path (K1,
    K4 with K2 as its backward, K3)."""
    from mtp_tpu_torch.models.mtp import mtp_energy_forces_window, window_constants
    from mtp_tpu_torch.ops.neighbors import build_sorted_neighbor_list, grid_shape

    p = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    c = torch.as_tensor(cell, dtype=torch.float32, device=dev)
    t = torch.as_tensor(types, dtype=torch.int32, device=dev)
    swl = build_sorted_neighbor_list(p, c, model.cutoff, max_neighbors=64,
                                     grid=grid_shape(cell, model.cutoff))
    if bool(swl.overflow):
        raise RuntimeError("neighbor list overflow at J=64")
    return mtp_energy_forces_window(model, p, c, swl, compute_virial=True,
                                    **window_constants(model, t, swl))


def _potential():
    from mtp_tpu_torch.io.basis_gen import make_mtp

    return make_mtp(CFG["level"], species_count=1, seed=CFG["seed"])


def oracle(*, reps=CFG["reps"], device="cuda"):
    """The float64 plain path on the gate's configuration: (ref, stats).
    `ref` holds forces, site energies, energy and virial as numpy; `stats`
    the oracle's wall ms and, on the card, its peak device memory in bytes."""
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    pos, types, cell = config_positions(reps)
    model64 = MTPModel.from_data(_potential(), device=dev, dtype=torch.float64)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref = _plain(model64, pos, types, cell, torch.float64, dev)
    ref = {k: ref[k].detach().cpu().numpy() for k in ("forces", "site_energies", "energy",
                                                      "virial")}
    stats = dict(oracle_ms=(time.perf_counter() - t0) * 1e3, oracle_peak_bytes=None)
    if dev.type == "cuda":
        stats["oracle_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return ref, stats


def run(*, reps=CFG["reps"], device="cuda", fp32_plain=False, f64=None):
    """The gate: returns (result, stats). `result` holds the keys of the
    reference's ``run_fp32``; `stats` those of :func:`oracle`. The float64
    side is computed here unless `f64` passes in the (ref, stats) that
    :func:`oracle` returned for the same `reps` and `device`."""
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    ref, stats = oracle(reps=reps, device=dev) if f64 is None else f64
    pos, types, cell = config_positions(reps)
    n = len(pos)
    model32 = MTPModel.from_data(_potential(), device=dev, dtype=torch.float32)
    if fp32_plain:
        out = _plain(model32, pos, types, cell, torch.float32, dev)
        label = f"fp32 plain path on {dev.type}"
    else:
        out = _kernel_path(model32, pos, types, cell, dev)
        label = f"fp32 kernel path on {dev.type}"
    f32 = {k: out[k].detach().cpu().numpy().astype(np.float64)
           for k in ("forces", "site_energies", "energy", "virial")}

    df = f32["forces"] - ref["forces"]
    fmag = np.linalg.norm(ref["forces"], axis=1)
    site_err = f32["site_energies"] - ref["site_energies"]
    e_ref = float(ref["energy"])
    result = dict(
        metric=f"accuracy-gate ({n} atoms level-{CFG['level']} thermal fcc, {label} vs "
               "f64 plain path)",
        n_atoms=n,
        max_abs_dF=float(np.abs(df).max()),
        rms_dF=float(np.sqrt((df**2).mean())),
        force_scale_rms=float(np.sqrt((fmag**2).mean())),
        dE_per_atom_naive_f32_sum=abs(float(f32["energy"]) - e_ref) / n,
        dE_per_atom_f64_host_sum=float(abs(f32["site_energies"].sum() - e_ref) / n),
        max_site_e_err=float(np.abs(site_err).max()),
        rms_site_e_err=float(np.sqrt((site_err**2).mean())),
        max_dvirial=float(np.abs(f32["virial"] - ref["virial"]).max()),
        virial_scale=float(np.abs(ref["virial"]).max()),
    )
    return result, stats


def failed_gates(result) -> list:
    """The names of the :data:`GATES` the result does not meet."""
    return [k for k, limit in GATES.items() if not result[k] < limit]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    result, stats = run(fp32_plain="--fp32-plain" in argv)
    peak = stats["oracle_peak_bytes"]
    print(f"oracle: f64 plain path {stats['oracle_ms']:.1f} ms, peak device memory "
          f"{'not measured' if peak is None else f'{peak / 2**30:.3f} GiB'}")
    print(json.dumps(result))
    bad = failed_gates(result)
    if bad:
        print(f"accuracy gate FAILED: {bad} (limits {GATES})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
