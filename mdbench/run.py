"""Run one cell of the benchmark once.

    python -m mdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with a CUDA
card. The cell, its configuration and its traffic mix are found by name
from ``BENCHMARK.json``. The run makes its inputs from the seed
(``mdbench.inputs``), sets the program up through its user entry points
(``mdbench/traffic/<driver>.py``), warms up with one call of the window's
driver, then repeats that call until ``--seconds`` have passed, finishes
the call under way and divides by the time it took. With ``--trace 1`` it
then reads the cell's per-layer metrics (``mdbench/metrics/<name>.py``),
some before and some from a ``torch.profiler`` window of the traffic's
``trace_calls`` calls. Once the window has closed and the peak memory is
read, the program is released and the float64 reference judges what the
window produced (``mdbench.judge``).

Standard error carries the card, the run's counts and, as its last lines,
each compared number beside its limit; the last line of standard output is
the result: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

A metric named ``<quantity>.<split>`` is the same quantity as
``<quantity>``, in cells that report another end-to-end metric: it is
taken the same way, and a per-layer one by the reader
``mdbench/metrics/<quantity>.py``.

Exit codes: 0 with a result; 2 without a CUDA card, with fewer cards than
the cell asks for, or without the program (a checkout that holds only the
benchmark); 3 when a module of JAX or of the JAX package is loaded, checked
after set-up, after the window and last before the result is printed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mtp_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``mtp_tpu_torch`` is not ``mtp_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def guard(where: str):
    found = forbidden_modules()
    if found:
        print(f"mdbench: {where}: forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)


def quantity(metric_name: str) -> str:
    """The quantity a metric measures: its name up to the first dot."""
    return metric_name.split(".")[0]


def host_counters() -> dict:
    """This process's CPU seconds and context switches, and the machine's
    stolen CPU seconds (``/proc/stat``), to difference over the window."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    with open("/proc/stat") as f:
        steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    return dict(cpu_s=ru.ru_utime + ru.ru_stime, voluntary=ru.ru_nvcsw,
                involuntary=ru.ru_nivcsw, steal_s=steal)


def load_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix,
    end-to-end and per-layer metrics and limits, found by name."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or load_json("BENCHMARK.json")
        (self.spec,) = [w for w in bench["workloads"] if w["name"] == name]
        self.name = name
        (cfg,) = [c for c in bench["configs"] if c["name"] == self.spec["config"]]
        self.config = load_json(cfg["file"])
        self.traffic = load_json(f"mdbench/traffic/{self.spec['traffic']}.json")
        self.limits = load_json(f"mdbench/limits/{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]


class Context:
    """What the per-layer metric readers see."""

    def __init__(self, prog, cell: Cell, pot: dict, window: dict, cuda: bool):
        self.prog, self.traffic, self.pot, self.window = prog, cell.traffic, pot, window
        self.cuda = cuda
        self.n_atoms = len(prog.inputs.types)
        self.events = None
        self.trace_steps = 0
        self._live = None

    def live_pairs(self) -> int:
        """Ordered pairs within the cutoff at the window's last state."""
        if self._live is None:
            from mdbench.work import live_pairs

            st = self.prog.state
            self._live = live_pairs(st.positions.detach().double(), st.cell.detach().double(),
                                    self.pot["max_dist"])
        return self._live


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             fault=None, keep_outputs=False) -> dict:
    """One run of `cell` (module docstring). `fault(prog)`, for tests,
    breaks the program after its set-up. Returns the result object and, under
    ``"log"``, the lines for standard error; with `keep_outputs` also the
    judged ``"outputs"`` and the run's ``"inputs"`` (for the control)."""
    import numpy as np
    import torch

    from mdbench import inputs as inputs_mod
    from mdbench import judge
    from mdbench import trace as trace_mod
    from mdbench.program import host_copy
    from mdbench.reference.mtp_file import parse_mtp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    log = []
    workdir = Path(tempfile.mkdtemp(prefix="mdbench-"))
    try:
        marks = [("imports", process_age())]
        torch.zeros(1, device=device)
        sync()
        marks.append(("card context", process_age()))
        inp = inputs_mod.make(cell.config, cell.traffic, seed, device)
        sync()
        marks.append(("inputs", process_age()))
        driver = importlib.import_module(f"mdbench.traffic.{cell.traffic['driver']}")
        clock = []
        prog = driver.Driver(cell.config, cell.traffic, inp, device, workdir, clock,
                             spans=trace)
        if fault is not None:
            fault(prog)
        sync()
        marks.append(("program", process_age()))
        prog.call()  # warm-up: every shape the window uses
        sync()
        marks.append(("warm-up", process_age()))
        guard("after set-up")
        clock.clear()
        prog.reset_counts()
        step0, att0, ret0 = int(prog.state.step), prog.attempts(), dict(prog.retries)
        setup_s = process_age()
        log.append("mdbench: set-up s: " + ", ".join(
            f"{name} {t - t_prev:.3f}" for (name, t), (_, t_prev) in
            zip(marks, [("", 0.0)] + marks)) + f"; total {setup_s:.3f}")
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        error = None
        host0 = host_counters()
        t0 = time.perf_counter()
        try:
            while True:
                prog.call()
                if time.perf_counter() - t0 >= seconds:
                    break
        except Exception:  # the program failed in the window: recorded, judged incorrect
            error = traceback.format_exc()
        sync()
        wall = time.perf_counter() - t0
        host = {k: v - host0[k] for k, v in host_counters().items()}
        guard("after the window")
        steps = prog.steps_done(step0)
        blocks = np.diff([t0] + clock)
        attempted = prog.attempts() - att0
        retries = {k: v - ret0[k] for k, v in prog.retries.items()}
        failed = attempted - len(clock) + (error is not None)
        window = dict(steps=steps, blocks=len(clock), seconds=wall)
        n = len(inp.types)
        metrics = {}
        device_info = dict(platform="gpu" if cuda else "cpu",
                           kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                           count=1)
        e2e = {
            "atom_steps_per_s": (n * steps / wall, "atom-steps/s"),
            "block_ms_p95": (float(np.percentile(blocks, 95)) * 1e3 if len(blocks) else
                             float("inf"), "ms"),
            "setup_s": (setup_s, "s"),
        }
        log.append(f"mdbench: {cell.name} seed {seed}: {n} atoms, {steps} steps, "
                   f"{len(clock)} blocks in {wall:.3f} s ({prog.calls} calls); block ms "
                   f"median {float(np.median(blocks)) * 1e3:.3f} p95 "
                   f"{e2e['block_ms_p95'][0]:.3f}; attempted {attempted}, failed {failed} "
                   f"(retries: overflow {retries['overflow']}, stale {retries['stale']}); "
                   f"J {prog.sim.max_neighbors}, steps per rebuild "
                   f"{prog.sim.steps_per_rebuild}")
        log.append(f"mdbench: host in the window: process CPU {host['cpu_s']:.3f} s, context "
                   f"switches {host['voluntary']} voluntary and {host['involuntary']} "
                   f"involuntary, machine steal {host['steal_s']:.2f} CPU s")
        if error:
            log.append(f"mdbench: the program raised in the window:\n{error}")
        if hasattr(prog, "selected"):
            g = np.asarray(prog.max_grades[:len(clock)] or [np.nan])
            log.append(f"mdbench: grade steps {len(clock)}, selected {prog.selected} "
                       f"(threshold {cell.traffic['select_threshold']}), .cfg bytes "
                       f"{prog.cfg_bytes()}; max grade per step in the window: median "
                       f"{np.median(g):.4g}, p90 {np.percentile(g, 90):.4g}, max {np.max(g):.4g}")
        pot = parse_mtp(inp.mtp_bytes)
        breakdown = None
        if trace and error is None:
            ctx = Context(prog, cell, pot, window, cuda)
            readers = {m["name"]: importlib.import_module(
                f"mdbench.metrics.{quantity(m['name'])}") for m in cell.per_layer}
            values = {k: r.read(ctx) for k, r in readers.items() if r.WHEN == "before_trace"}
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            s0 = int(prog.state.step)
            with torch.profiler.profile(activities=acts) as prof:
                t1 = time.perf_counter()  # the profiler's own start-up is outside
                for _ in range(cell.traffic["trace_calls"]):
                    prog.call()
                sync()
                traced_s = time.perf_counter() - t1
            ctx.trace_steps = int(prog.state.step) - s0
            path = workdir / "trace.json"
            prof.export_chrome_trace(str(path))
            ctx.events = json.loads(path.read_text())["traceEvents"]
            path.unlink()
            values.update({k: r.read(ctx) for k, r in readers.items()
                           if r.WHEN == "after_trace"})
            for m in cell.per_layer:
                if values.get(m["name"]) is not None:
                    metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
            breakdown = trace_mod.breakdown(ctx.events)
            log.append(f"mdbench: traced {cell.traffic['trace_calls']} calls, "
                       f"{ctx.trace_steps} steps in {traced_s:.3f} s")
            if cuda:
                span_us, busy_us = trace_mod.device_window(ctx.events)
                device_info.update(busy_s=busy_us * 1e-6, window_s=traced_s)
                log.append(f"mdbench: device span {span_us * 1e-6:.6f} s, busy "
                           f"{busy_us * 1e-6:.6f} s")
        elif not trace:
            for m in cell.end_to_end:
                value, unit = e2e[quantity(m["name"])]
                if np.isfinite(value):
                    metrics[m["name"]] = {"value": value, "unit": unit}
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        peak = max(setup_peak, window_peak)
        device_info["memory_peak_bytes"] = peak
        log.append(f"mdbench: peak device memory {peak} bytes; in set-up {setup_peak}, from the "
                   f"window on {window_peak} ({window_peak / n:.1f} per atom)")
        if error is not None or prog.sample is None:
            # nothing sound to judge: every number fails
            correct, checks = judge.decide({}, cell.limits)
            result = dict(correct=False, attempted=attempted, failed=failed, metrics=metrics,
                          device=device_info, checks=checks)
            log.extend(f"mdbench: check {k} {c['value']!r} limit {c['limit']!r}"
                       for k, c in checks.items())
            return dict(result=result, log=log, readings={})
        outputs = dict(
            final=host_copy(prog.state),
            sample=dict(start=host_copy(prog.sample.start), end=host_copy(prog.sample.end),
                        steps=int(prog.sample.end.step) - int(prog.sample.start.step)),
            grades=prog.grades() if hasattr(prog, "grades") else None,
        )
        prog.release()
        del prog
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref = judge.reference_model(inp, device)
        nums = judge.readings(outputs, inp, cell.traffic, ref)
        correct, checks = judge.decide(nums, cell.limits)
        correct = correct and error is None and steps > 0
        log.append(f"mdbench: reference {time.perf_counter() - t_ref:.3f} s; every reading "
                   f"{json.dumps(nums)}; correct {correct}")
        log.extend(f"mdbench: check {k} {c['value']!r} limit {c['limit']!r}"
                   for k, c in checks.items())
        result = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
                      device=device_info)
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = checks
        out = dict(result=result, log=log, readings=nums)
        if keep_outputs:
            out.update(outputs=outputs, inputs=inp)
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    if importlib.util.find_spec("mtp_tpu_torch") is None:
        print("mdbench: the program (mtp_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    # every build and kernel cache of the run at a fixed path in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch

    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mdbench: {cell.name} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    report(run_cell(cell, args.seed, args.seconds, bool(args.trace)))
    return 0


def report(out: dict):
    """Print a run's log on standard error and then its result as the last
    line of standard output, unless a module of JAX or of the JAX package
    has been loaded by then (exit 3, no result)."""
    import torch

    from mtp_tpu_torch.kernels._build import LIBRARY

    if torch.cuda.is_available():  # read after the run, so that set-up does not wait on it
        print(f"mdbench: card {card_line()}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", file=sys.stderr)
    print(f"mdbench: kernel library {LIBRARY.path}, build seconds {LIBRARY.build_seconds}",
          file=sys.stderr)
    for line in out["log"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    guard("before the result")
    print(json.dumps(out["result"]))


if __name__ == "__main__":
    raise SystemExit(main())
