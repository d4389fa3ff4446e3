"""End-to-end MTP workflow: train -> simulate -> actively learn -> retrain
(port of ``examples/full_workflow.py``).

 1. label a small training set with a "teacher" (stands in for DFT; the
    float64 golden engine),
 2. fit MTP coefficients (linear warm start + Adam, float64),
 3. build a MaxVol selection state and write a full .mtp (+MVS trailer),
 4. run NVT MD with MLIP-3-style two-threshold extrapolation monitoring,
 5. read back the preselected configurations (what you would re-label).

Run:  python -m mtp_tpu_torch.examples.full_workflow [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from mtp_tpu_torch.al.driver import (
    BreakThresholdExceeded,
    ExtrapolationMonitor,
    run_with_extrapolation,
)
from mtp_tpu_torch.al.grades import candidate_vectors
from mtp_tpu_torch.al.maxvol import build_mvs
from mtp_tpu_torch.examples import md_dtype, output_dir
from mtp_tpu_torch.io.basis_gen import make_mtp
from mtp_tpu_torch.io.cfg_file import Config, read_cfgs
from mtp_tpu_torch.io.mtp_file import save_mtp
from mtp_tpu_torch.md.output import ThermoLogger
from mtp_tpu_torch.md.simulation import Simulation, make_lattice
from mtp_tpu_torch.md.state import init_state, thermalize
from mtp_tpu_torch.models.mtp import MTPModel
from mtp_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce
from mtp_tpu_torch.train.fit import fit, make_dataset
from mtp_tpu_torch.utils import golden
from mtp_tpu_torch.utils.device import resolve_device

SELECT, BREAK = 2.0, 1000.0


def main(*, n_configs: int = 12, fit_steps: int = 150, md_steps: int = 200, al_every: int = 20,
         reps=(3, 3, 3), device="cuda", out_dir=None) -> dict:
    dev = resolve_device(device)
    out = output_dir("full_workflow", out_dir)
    f64 = dict(device=dev, dtype=torch.float64)
    rng = np.random.default_rng(0)

    # ---- 1. training data from a "teacher" (golden f64 as the oracle) ----
    teacher = make_mtp(8, species_count=1, seed=11)
    pos0, types, cell = make_lattice("fcc", 4.0, reps)
    configs = []
    for k in range(n_configs):
        p = pos0 + rng.normal(scale=0.02 + 0.01 * (k % 6), size=pos0.shape)
        lab = golden.compute(teacher, p, types, cell=cell)
        configs.append(Config(cell=cell, positions=p, types=types, energy=lab["energy"],
                              forces=lab["forces"]))
    print(f"[1] labeled {len(configs)} training configurations")

    # ---- 2. fit a fresh student potential on that data ----
    student_mtp = make_mtp(8, species_count=1, seed=99)  # a different random init
    student = MTPModel.from_data(student_mtp, **f64)
    data = make_dataset(configs, student.cutoff, max_neighbors=48, device=dev)
    coeffs, losses = fit(student.schedule, student.coeffs, data, steps=fit_steps,
                         learning_rate=2e-3, force_weight=0.1)
    print(f"[2] fit: loss {losses[0]:.3e} -> {losses[-1]:.3e} (best {losses.min():.3e})")
    assert np.isfinite(losses).all(), "non-finite training loss"

    # ---- 3. MaxVol selection state + a complete .mtp file ----
    for name in ("radial_coeffs", "species_coeffs", "moment_coeffs"):
        setattr(student_mtp, name, getattr(coeffs, name).cpu().numpy())
    fitted = MTPModel.from_data(student_mtp, **f64)
    rows = []
    for c in configs:
        p = torch.as_tensor(c.positions, **f64)
        cl = torch.as_tensor(c.cell, **f64)
        nl = build_neighbor_list_bruteforce(p, cl, fitted.cutoff, max_neighbors=48)
        b, _ = candidate_vectors(fitted, p, torch.as_tensor(c.types, device=dev), nl.idx, cl)
        rows.append(b.cpu().numpy())
    student_mtp.mvs = build_mvs(np.concatenate(rows, 0), mode="neighborhood")
    path = out / "student.mtp"
    save_mtp(str(path), student_mtp)
    print(f"[3] wrote {path} (P={student_mtp.coeff_count}, MVS trailer)")

    # ---- 4. MD with MLIP-3-style extrapolation monitoring ----
    dt_md = md_dtype(dev)
    model = MTPModel.load(str(path), device=dev, dtype=dt_md)
    assert model.inverse_active_set is not None, "the .mtp lost its MVS trailer"
    state = thermalize(
        torch.Generator(device=dev).manual_seed(1),
        init_state(pos0, types, np.full(len(pos0), 58.693), cell, dtype=dt_md, device=dev),
        600.0,  # hotter than the training set -> expect extrapolation
    )
    sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=10)
    cfg_path = out / "preselected.cfg"
    mon = ExtrapolationMonitor(model, select_threshold=SELECT, break_threshold=BREAK,
                               output_path=str(cfg_path), max_neighbors=48)
    thermo = ThermoLogger(("step", "temp", "pe", "max_grade"), every=al_every, stream=sys.stdout)
    broke = False
    try:
        state = run_with_extrapolation(
            sim, mon, state, md_steps, al_every=al_every, ensemble="nvt", dt=0.002,
            temperature=600.0, tdamp=0.1,
            observer=lambda s, mo: thermo(s, max_grade=mo.max_grade),
        )
        print(f"[4] {md_steps} NVT steps done; final max grade {mon.max_grade:.2f}")
    except BreakThresholdExceeded as e:
        broke = True
        print(f"[4] {e}")
    finally:
        mon.close()
    assert math.isfinite(mon.max_grade) and mon.max_grade > 0, "no grade"

    # ---- 5. harvest the preselected configurations for re-labeling ----
    selected = read_cfgs(str(cfg_path))
    print(f"[5] {len(selected)} configurations preselected for re-labeling "
          f"(grades > {SELECT})")
    assert all(float(c.features["MV_grade"]) >= SELECT for c in selected)
    return dict(losses=losses, n_selected=len(selected), max_grade=mon.max_grade, broke=broke,
                mtp=path, cfg=cfg_path)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
