"""Where the main path's time goes on the card (counterpart of
``mtp_tpu/utils/prof.py``).

    python -m mtp_tpu_torch.utils.prof [--reps 20] [--blocks 2] [--out DIR]

Runs the ``bench.py`` configuration (level 16, fp32, J = 64, skin 0.6,
steps_per_rebuild 30, NVE) on 20^3 fcc cells (--reps) after a 60-step warm-up
and measures, on one GPU:

* the steady-state step time and atom-steps/s from the host clock between
  ``torch.cuda.synchronize()`` calls, profiler off;
* device time by kernel name over the same number of blocks under
  ``torch.profiler``, and the device's idle share in that traced window:
  1 - (time in which a device event ran) / (span from the first device
  event's start to the last one's end), both read from the one trace;
* the neighbor rebuild's time (host clock, synchronised, mean of 5);
* a Chrome trace of the profiled window, written to --out.
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


def main(argv=None) -> int:
    import numpy as np
    import torch

    from mtp_tpu_torch.io.basis_gen import make_mtp
    from mtp_tpu_torch.md.simulation import Simulation, make_lattice
    from mtp_tpu_torch.md.state import init_state, thermalize
    from mtp_tpu_torch.models.mtp import MTPModel
    from mtp_tpu_torch.ops.neighbors import grid_shape

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20, help="fcc cells per side")
    ap.add_argument("--blocks", type=int, default=2, help="30-step blocks measured")
    ap.add_argument("--out", default="build/prof", help="trace directory")
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

    model = MTPModel.from_data(make_mtp(16, seed=0), device=dev, dtype=torch.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (args.reps,) * 3)
    n = len(pos)
    st = init_state(pos, types, np.full(n, 58.693), cell, device=dev)
    st = thermalize(torch.Generator(device=dev).manual_seed(0), st, 300.0)
    eq = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                    compute_virial=False)
    sim = Simulation(model, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                     compute_virial=False)
    st, _, fl = eq.run_async(st, 60)
    steps = 30 * args.blocks

    def run(state):
        state, _, flags = sim.run_async(state, steps, refresh=False)
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
    trace_path = out / "main_path_trace.json"
    prof.export_chrome_trace(str(trace_path))
    span_us, busy_us = device_window(json.loads(trace_path.read_text())["traceEvents"])
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
    print(f"prof: {card}; {n} atoms, level 16, fp32, J=64, {steps} steps")
    print(f"prof: step {step_ms:.4f} ms (profiler off), {n / step_ms * 1e3:.1f} atom-steps/s")
    print(f"prof: traced window {span_us / steps / 1e3:.4f} ms/step, device busy "
          f"{busy_us / steps / 1e3:.4f} ms/step, idle share {idle:.4f}; "
          f"neighbor rebuild {rebuild_ms:.4f} ms")
    print("prof: device ms/step  launches/step  kernel")
    for ms, count, key in rows[:25]:
        print(f"prof: {ms:12.5f}  {count:12.2f}  {key[:100]}")
    print(json.dumps({
        "card": card, "atoms": n, "step_ms": step_ms,
        "traced_ms_per_step": span_us / steps / 1e3,
        "busy_ms_per_step": busy_us / steps / 1e3, "idle_share": idle,
        "rebuild_ms": rebuild_ms,
        "kernels": [dict(name=k[:100], ms_per_step=ms, launches_per_step=c)
                    for ms, c, k in rows[:25]],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
