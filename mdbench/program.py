"""The program under test, set up for one run of one cell.

Everything here goes through the program's user entry points: the minted
potential is written as a ``.mtp`` file and loaded by ``MTPModel.load``, the
state comes from ``init_state`` with the benchmark's own velocities, and the
dynamics run through ``Simulation`` (and ``run_with_extrapolation`` in the
active-learning mix). The traffic drivers in ``mdbench/traffic/`` subclass
:class:`Program` and add the call the window repeats.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch


def wrap(obj, attr: str, label: str, *, spans: bool, counts: dict):
    """Replace the bound method `attr` of `obj` by one that counts its calls
    under `label` in `counts` and, with `spans`, records a profiler span."""
    fn = getattr(obj, attr)

    def wrapped(*a, **kw):
        counts[label] = counts.get(label, 0) + 1
        if not spans:
            return fn(*a, **kw)
        with torch.profiler.record_function(label):
            return fn(*a, **kw)

    setattr(obj, attr, wrapped)


@dataclasses.dataclass
class Sample:
    """One block the reference follows: the state it started from and the
    state it ended in."""

    start: object
    end: object


class Program:
    """Model, state and Simulation of one run (module docstring)."""

    def __init__(self, config: dict, traffic: dict, inputs, device, workdir: Path,
                 clock: list, spans: bool):
        from mtp_tpu_torch.md.simulation import Simulation
        from mtp_tpu_torch.md.state import init_state

        self.config, self.traffic, self.inputs = config, traffic, inputs
        self.device = torch.device(device)
        self.workdir = Path(workdir)
        self.clock = clock  # host times of the accepted blocks
        self.spans = spans
        self.counts = {}  # calls of the wrapped methods
        self.retries = {"overflow": 0, "stale": 0}
        self.calls = 0
        self.sample = None
        self.model = self.load_model()
        self.state = init_state(inputs.positions, inputs.types, inputs.masses, inputs.cell,
                                velocities=inputs.velocities, dtype=torch.float32,
                                device=self.device)
        eq = config["equilibration"]
        warm = Simulation(self.model, max_neighbors=config["max_neighbors"],
                          skin=config["skin"], steps_per_rebuild=eq["steps_per_rebuild"],
                          compute_virial=False)
        self.state, _, flags = warm.run_async(self.state, eq["steps"], dt=traffic["dt"])
        if bool(flags):
            raise RuntimeError("equilibration tripped a neighbor flag")
        self.sim = Simulation(self.model, max_neighbors=config["max_neighbors"],
                              skin=config["skin"],
                              steps_per_rebuild=config["steps_per_rebuild"],
                              compute_virial=False)
        self.aux = None
        self.kw = dict(ensemble=traffic["ensemble"], dt=traffic["dt"])

    def potential_path(self) -> Path:
        path = self.workdir / "potential.mtp"
        path.write_bytes(self.inputs.mtp_bytes)
        return path

    def load_model(self):
        from mtp_tpu_torch.models.mtp import MTPModel

        return MTPModel.load(str(self.potential_path()), device=self.device,
                             dtype=torch.float32)

    def instrument(self):
        """Count (and in a traced run, span) the driver's calls into the
        program's layers: every instance method named by the traffic mix.
        In a traced run, also span the force closure's calls."""
        for obj_name, attr in self.traffic["spans"]:
            obj = getattr(self, obj_name)
            wrap(obj, attr, f"{type(obj).__name__}.{attr}", spans=self.spans,
                 counts=self.counts)
        if self.spans:
            self.span_forces()

    def span_forces(self):
        """Put every call of the Simulation's force closure (one step's
        forces: K1, K2 and K3) in a ``force`` span, which ``force_roofline``
        reads from the trace. The closure's ``energy_fn`` (K4) stays
        outside."""
        make = self.sim.force_fn_window

        def spanned(*a, **kw):
            fn = make(*a, **kw)

            def force(*args):
                with torch.profiler.record_function("force"):
                    return fn(*args)

            force.energy_fn = fn.energy_fn
            return force

        self.sim.force_fn_window = spanned

    def watch_retries(self, attr: str):
        """Count the program's retries by cause: before each call of the
        Simulation's method `attr` (one attempt of a block or segment), a
        wider list than before means the last attempt overflowed, a shorter
        block that it went stale."""
        sim, fn = self.sim, getattr(self.sim, attr)
        seen = [sim.max_neighbors, sim.steps_per_rebuild]

        def watched(*a, **kw):
            if sim.max_neighbors != seen[0]:
                self.retries["overflow"] += 1
            elif sim.steps_per_rebuild != seen[1]:
                self.retries["stale"] += 1
            seen[:] = [sim.max_neighbors, sim.steps_per_rebuild]
            return fn(*a, **kw)

        setattr(sim, attr, watched)

    def span(self, label: str):
        """A profiler span in a traced run, nothing otherwise."""
        return torch.profiler.record_function(label) if self.spans else contextlib.nullcontext()

    def observe(self):
        """A block clock for the observer hooks: appends the host time."""
        self.clock.append(time.perf_counter())

    def keep_sample(self, start, end):
        """Reservoir sampling of one call's first block over all calls."""
        self.calls += 1
        if self.inputs.sample_rng.random() * self.calls < 1.0:
            self.sample = Sample(start, end)

    def reset_counts(self):
        """Forget the warm-up: the window's counts start here."""
        self.calls, self.sample = 0, None

    def steps_done(self, since) -> int:
        return int(self.state.step) - int(since)

    def release(self):
        """Drop the program's objects once the window is over (the judged
        states stay with the caller)."""
        self.sim = self.model = None


def host_copy(state) -> dict:
    """The judged fields of a state as float64 host arrays."""
    out = {}
    for k in ("positions", "velocities", "forces", "cell", "potential_energy"):
        out[k] = state_field(state, k)
    return out


def state_field(state, key):
    return np.asarray(getattr(state, key).detach().double().cpu().numpy())
