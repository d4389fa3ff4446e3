"""The comparison that decides ``correct``.

What the timed path produced is held against the float64 reference in
``mdbench/reference/``, after the window has closed:

* the final state of the window: the program's forces and potential energy
  there (in the active-learning mix also the last grade step's per-atom
  grades) against the reference's at the same positions, types and cell;
* one block drawn from the seed among the first blocks of the window's
  calls: the reference starts from the program's state at the block's
  start (positions and velocities) and integrates as many NVE steps with
  its own forces and pair list; the program's velocities at the block's
  end are held against the reference's, and the program's forces at the
  block's start and energy at its end against the reference's there.

The compared numbers: ``force`` (the widest gap of an atom's force over the
largest force), ``energy`` (eV per atom), ``velocity`` (RMS gap over RMS
velocity) and ``grade`` (widest gap over the largest grade). ``readings``
also returns ``position`` (A), printed but not compared: it separates the
program from the control no better than 3 to 1, because both round
positions to float32.

The reference cannot follow the whole window: MD is chaotic and the window
holds thousands of steps. So it follows one block from the program's own
state, and the state that block starts from is itself checked (its forces);
every block runs the same code.

A cell's limits (``mdbench/limits/<cell>.json``) name the numbers it
compares; the run is correct when every one is at most its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench.reference.dynamics import follow_nve
from mdbench.reference.maxvol import active_set, grades
from mdbench.reference.model import ReferenceMTP
from mdbench.reference.mtp_file import parse_mtp


def _t(a, device):
    return torch.as_tensor(np.asarray(a), device=device)


def rel_rows(a, b) -> float:
    """max_i |a_i - b_i| / max_i |b_i| over rows (vectors) or entries."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.ndim == 1:
        a, b = a[:, None], b[:, None]
    return float(np.max(np.linalg.norm(a - b, axis=-1)) / np.max(np.linalg.norm(b, axis=-1)))


def rms_rel(a, b) -> float:
    """RMS over rows of |a_i - b_i| over the RMS of |b_i|."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1)) / np.mean(np.sum(b * b, axis=-1))))


def reference_model(inputs, device, dtype=torch.float64) -> ReferenceMTP:
    return ReferenceMTP(parse_mtp(inputs.mtp_bytes), device, dtype)


def evaluate(model, inputs, state: dict, *, candidates=False) -> dict:
    """The model's energy, forces (and candidate vectors) at a state's
    positions and cell, as float64 host arrays."""
    dev = model.device
    out = model.evaluate(_t(state["positions"], dev), _t(inputs.types, dev),
                         _t(state["cell"], dev), candidates=candidates)
    return {k: v.detach().double().cpu().numpy() for k, v in out.items() if k != "pairs"}


def follow(model, inputs, traffic: dict, sample: dict) -> dict:
    """The model integrating the sampled block from its start (module
    docstring), as float64 host arrays."""
    if traffic["ensemble"] != "nve":
        raise ValueError(f"the harness does not follow {traffic['ensemble']!r}")
    dev = model.device
    s = sample["start"]
    out = follow_nve(model, _t(s["positions"], dev), _t(s["velocities"], dev),
                     _t(inputs.masses, dev), _t(inputs.types, dev), _t(s["cell"], dev),
                     sample["steps"], traffic["dt"])
    end = {k: v.detach().double().cpu().numpy() for k, v in out.items()
           if isinstance(v, torch.Tensor)}
    end["potential_energy"] = evaluate(model, inputs, end)["energy"]
    return end


def active_set_of(model, inputs) -> np.ndarray:
    """The model's own active set from the traffic's perturbed boxes."""
    dev = model.device
    rows = [model.evaluate(_t(p, dev), _t(t, dev), _t(c, dev), candidates=True)["b"]
            .double().cpu().numpy() for p, c, t in inputs.mvs_boxes]
    return active_set(np.concatenate(rows))


def readings(outputs: dict, inputs, traffic: dict, ref: ReferenceMTP) -> dict:
    """Each compared number (module docstring) for one run's outputs."""
    al = outputs.get("grades") is not None
    n = len(inputs.types)
    fin, s = outputs["final"], outputs["sample"]
    rfin = evaluate(ref, inputs, fin, candidates=al)
    rend = follow(ref, inputs, traffic, s)
    nums = {
        "force": max(rel_rows(fin["forces"], rfin["forces"]),
                     rel_rows(s["start"]["forces"], rend["forces0"])),
        "energy": max(abs(float(fin["potential_energy"]) - float(rfin["energy"])),
                      abs(float(s["end"]["potential_energy"])
                          - float(rend["potential_energy"]))) / n,
        "velocity": rms_rel(s["end"]["velocities"], rend["velocities"]),
        "position": float(np.max(np.linalg.norm(s["end"]["positions"] - rend["positions"],
                                                axis=-1))),
    }
    if al:
        g_ref = grades(rfin["b"], active_set_of(ref, inputs))
        nums["grade"] = float(np.max(np.abs(outputs["grades"] - g_ref)) / np.max(g_ref))
    return nums


def decide(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: correct when each is finite and at most its limit. A number that
    is missing or not finite is reported as None, and fails."""
    checks = {}
    for k, lim in limits.items():
        v = nums.get(k)
        checks[k] = {"value": v if v is not None and np.isfinite(v) else None, "limit": lim}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
