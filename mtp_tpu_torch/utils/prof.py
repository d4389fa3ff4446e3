"""Where the main path's time goes on the card (counterpart of
``mtp_tpu/utils/prof.py``).

    python -m mtp_tpu_torch.utils.prof [--reps 20] [--blocks 2] [--out DIR]
                                       [--ensemble {nve,nvt,langevin,npt,npt-tri}]
                                       [--virial] [--fit]

Runs the ``bench.py`` configuration (level 16, fp32, J = 64, skin 0.6,
steps_per_rebuild 30, NVE) on 20^3 fcc cells (--reps) after a 60-step warm-up
and measures, on one GPU:

* the steady-state step time and atom-steps/s from the host clock between
  ``torch.cuda.synchronize()`` calls, profiler off;
* device time by kernel name over the same number of blocks under
  ``torch.profiler``, the kernels run per step, and the device's idle
  share in that traced window: 1 - (time in which a device event ran) /
  (span from the first device event's start to the last one's end), all
  read from the one trace;
* the neighbor rebuild's time (host clock, synchronised, mean of 5);
* a Chrome trace of the profiled window, written to --out.

``--ensemble`` runs the measured blocks under another ensemble (300 K,
tdamp 0.1 ps; the barostats at pdamp 1.0 ps and the box's own pressure after
the warm-up, with the virial tallied every step), the integrator state
carried from block to block. ``--virial`` tallies the virial every step in
the other ensembles too, so that two runs, with and without it, give what
the tally costs.

With ``--fit`` it profiles training instead, at ``chip_smoke.py`` phase 9's
configuration (``train.fit.training_set``: 96 configurations of the
108-atom box labeled by a level-16 teacher; a level-16 student, J = 48,
float64, force weight 0.1, lr 1e-4): the host time of 3 ``fit`` steps
after a warm-up, then one traced step: its device busy time, idle share,
kernels and the kernels' device time by name; then the losses of 5 steps
from the linear warm start (lr 2e-3 and 1e-4) and from the minted student
(lr 2e-3).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time
from pathlib import Path


@contextlib.contextmanager
def trace():
    """Profile the enclosed block with ``torch.profiler`` (CPU and CUDA)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# Chrome-trace categories of work on the device
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_window(trace_events):
    """(span_us, busy_us) of the device events of one Chrome trace: the span
    from the first event's start to the last one's end, and the part of it
    in which at least one event ran (overlaps counted once)."""
    iv = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in trace_events
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS
    )
    if not iv:
        raise ValueError("the trace holds no device events")
    busy = 0.0
    lo, hi = iv[0]
    for s, e in iv[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return max(e for _, e in iv) - iv[0][0], busy


def kernel_count(trace_events) -> int:
    """Kernels that ran on the device in one Chrome trace."""
    return sum(1 for e in trace_events if e.get("ph") == "X" and e.get("cat") == "kernel")


def fit_main(args, dev, card) -> int:
    """The --fit mode (module docstring)."""
    import torch

    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.train.fit import fit, make_dataset, training_set

    configs = training_set(MTPModel.from_data(make_mtp(16, seed=11), device=dev,
                                              dtype=torch.float64), 96)
    student = MTPModel.from_data(make_mtp(16, seed=99), device=dev, dtype=torch.float64)
    data = make_dataset(configs, student.cutoff, max_neighbors=48, device=dev)

    def steps(k):
        return fit(student.schedule, student.coeffs, data, steps=k, learning_rate=1e-4,
                   force_weight=0.1, warm_start=False)

    steps(1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(3)  # 3 steps and the final evaluation
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with trace() as prof:
        steps(1)  # 1 step and the final evaluation
        torch.cuda.synchronize()
    path = out / "fit_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    span_us, busy_us = device_window(events)
    rows = sorted(((_device_us(e) / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0),
                  reverse=True)
    print(f"prof --fit: {card}; 96 x 108 atoms, level 16, J=48, float64")
    print(f"prof --fit: 3 steps and a final evaluation {host_ms:.3f} ms on the host; traced "
          f"(1 step and a final evaluation): span {span_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1.0 - busy_us / span_us:.4f}, "
          f"{kernel_count(events)} kernels")
    print("prof --fit: device ms  launches  kernel")
    for ms, count, key in rows[:20]:
        print(f"prof --fit: {ms:10.4f}  {count:8d}  {key[:100]}")
    # why phase 9 starts from the minted student at lr 1e-4: 5 steps from
    # the warm start at 2e-3 and at 1e-4, and from the minted student at 2e-3
    probe = {f"{start} lr {lr:g}": fit(student.schedule, student.coeffs, data, steps=5,
                                      learning_rate=lr, force_weight=0.1,
                                      warm_start=start == "warm start")[1].tolist()
             for start, lr in (("warm start", 2e-3), ("warm start", 1e-4),
                               ("minted", 2e-3))}
    for name, losses in probe.items():
        print(f"prof --fit: 5 Adam steps from the {name}: losses {losses}")
    print(json.dumps({
        "card": card, "host_ms_3_steps": host_ms, "span_ms": span_us / 1e3,
        "busy_ms": busy_us / 1e3, "kernels": kernel_count(events),
        "top": [dict(name=k[:100], ms=ms, launches=c) for ms, c, k in rows[:20]],
        "probe": probe,
    }))
    return 0


def main(argv=None) -> int:
    import numpy as np
    import torch

    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.md.simulation import Simulation, _default_aux, make_lattice
    from mtp_tpu_torch.md.state import init_state, pressure_of, thermalize
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.neighbors import grid_shape

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20, help="fcc cells per side")
    ap.add_argument("--blocks", type=int, default=2, help="30-step blocks measured")
    ap.add_argument("--out", default="build/prof", help="trace directory")
    ap.add_argument("--ensemble", default="nve",
                    choices=("nve", "nvt", "langevin", "npt", "npt-tri"),
                    help="ensemble of the measured blocks")
    ap.add_argument("--virial", action="store_true",
                    help="tally the virial every step (the barostats always do)")
    ap.add_argument("--fit", action="store_true", help="profile training steps instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    if args.fit:
        return fit_main(args, dev, card)
    model = MTPModel.from_data(make_mtp(16, seed=0), device=dev, dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (args.reps,) * 3)
    n = len(pos)
    st = init_state(pos, types, np.full(n, 58.693), cell, device=dev)
    st = thermalize(torch.Generator(device=dev).manual_seed(0), st, 300.0)
    eq = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                    compute_virial=False)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                     compute_virial=args.virial)
    st, _, fl = eq.run_async(st, 60)
    steps = 30 * args.blocks
    ens = args.ensemble
    kw = dict(temperature=300.0, tdamp=0.1, pdamp=1.0)
    if ens.startswith("npt"):
        # forces and virial of the warm-up's last state, and its pressure
        st = sim.refresh_forces(st, sim.rebuild(st, grid=sim.grid_for(st.cell),
                                                max_neighbors=64), ensemble=ens)
        kw["pressure"] = float(pressure_of(st))
    carried = {"aux": _default_aux(ens, st)}

    def run(state):
        state, carried["aux"], flags = sim.run_async(
            state, steps, ensemble=ens, aux=carried["aux"], refresh=False, **kw)
        return state, flags

    st, fl = run(st)  # warm-up at the measured shapes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, fl_t = run(st)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with trace() as prof:
        st, fl_p = run(st)
        torch.cuda.synchronize()
    if bool(fl) or bool(fl_t) or bool(fl_p):
        raise SystemExit("prof: overflow or staleness flag set")
    grid = grid_shape(cell, model.cutoff + sim.skin)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        sim.rebuild(st, grid=grid, max_neighbors=sim.max_neighbors)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) / 5 * 1e3

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / f"main_path_{ens}_trace.json"
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    span_us, busy_us = device_window(events)
    launches = kernel_count(events) / steps
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): a host operator's
        # device time repeats that of the kernels it launched
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(evt)
        if us > 0:
            rows.append((us / steps / 1e3, evt.count / steps, evt.key))
    rows.sort(reverse=True)
    idle = 1.0 - busy_us / span_us
    virial = args.virial or ens.startswith("npt")
    print(f"prof: {card}; {n} atoms, level 16, fp32, J=64, {steps} steps, {ens}"
          + (f" at {kw['pressure']:.1f} bar" if "pressure" in kw else "")
          + f", virial {'on' if virial else 'off'}")
    print(f"prof: step {step_ms:.4f} ms (profiler off), {n / step_ms * 1e3:.1f} atom-steps/s")
    print(f"prof: traced window {span_us / steps / 1e3:.4f} ms/step, device busy "
          f"{busy_us / steps / 1e3:.4f} ms/step, idle share {idle:.4f}, "
          f"{launches:.2f} kernels/step; neighbor rebuild {rebuild_ms:.4f} ms")
    print("prof: device ms/step  launches/step  kernel")
    for ms, count, key in rows[:25]:
        print(f"prof: {ms:12.5f}  {count:12.2f}  {key[:100]}")
    print(json.dumps({
        "card": card, "atoms": n, "ensemble": ens, "virial": virial, "step_ms": step_ms,
        "traced_ms_per_step": span_us / steps / 1e3,
        "busy_ms_per_step": busy_us / steps / 1e3, "idle_share": idle,
        "kernels_per_step": launches,
        "rebuild_ms": rebuild_ms,
        "kernels": [dict(name=k[:100], ms_per_step=ms, launches_per_step=c)
                    for ms, c, k in rows[:25]],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
