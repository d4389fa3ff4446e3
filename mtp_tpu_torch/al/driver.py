"""Active-learning driver: extrapolation-grade evaluation during MD, with the
reference's two observation styles and two-threshold selection semantics.

Port of ``mtp_tpu/al/driver.py``: the single-device monitor and driver,
and the sharded ones (:class:`ShardedExtrapolationMonitor`, on the window
engine or standalone, and :func:`run_sharded_with_extrapolation`). The MD
segments run under any ensemble of :meth:`Simulation.run_async` (and every
sharded ensemble), with the integrator state carried across segments;
every grade step tallies the virial, so a barostat continues from a
consistent state after each refresh.

* LAMMPS style (reference README.md:60-82): grades computed every N steps on
  request; per-atom grades and the scalar max grade are exposed as observables
  (the analog of `fix pair` / `compute pair`; values are stale between
  evaluations, as documented there).
* MLIP-3 style (reference README.md:84-97): grades every evaluation; if
  max_grade >= select_threshold the configuration is appended to the
  preselected ``.cfg`` stream; if >= break_threshold the stream is flushed and
  the run is terminated (flush-before-break contract,
  pair_mtp_extrapolation.cpp:387-397).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mtp_tpu_torch.al.grades import (
    candidates_and_forces,
    cfg_grade,
    grade_eval_window,
    nbh_grades,
)
from mtp_tpu_torch.io.cfg_file import CfgWriter
from mtp_tpu_torch.md.simulation import Simulation, read_cell
from mtp_tpu_torch.md.state import MDState
from mtp_tpu_torch.models.mtp import MTPModel
from mtp_tpu_torch.ops.neighbors import (
    SortedNeighborList,
    build_neighbor_list,
    check_cell,
    grid_shape,
    grown_width,
)
from mtp_tpu_torch.utils.tracing import span


class BreakThresholdExceeded(RuntimeError):
    """Raised when max grade exceeds the break threshold (run terminated)."""

    def __init__(self, max_grade: float):
        super().__init__(
            f"Exceeded Break Threshold: {max_grade:.5f}. Terminating simulation."
        )
        self.max_grade = max_grade


class _Selection:
    """What both monitors share: the MLIP-3 style, the max grade read to the
    host once, the break rule and the ``.cfg`` stream."""

    @property
    def mlip3_style(self) -> bool:
        return self.select_threshold is not None

    @property
    def max_grade(self) -> float:
        if not isinstance(self._max_grade, float):
            self._max_grade = float(self._max_grade)
        return self._max_grade

    def _check_break(self):
        if self.break_threshold is not None and self.max_grade >= self.break_threshold:
            # flush-before-break: no selected configuration may be lost
            self.close()
            raise BreakThresholdExceeded(self.max_grade)

    def close(self):
        if self._writer is not None:
            self._writer.close()


@dataclasses.dataclass(eq=False)
class ExtrapolationMonitor(_Selection):
    """Evaluates grades for a configuration and applies selection semantics.

    Observables (mirroring extract_peratom/pvector,
    pair_mtp_extrapolation.cpp:624-652): `.max_grade` (float) and
    `.nbh_grades` (per-atom numpy array; neighborhood mode only). Stale
    between evaluations by design. Both stay device tensors until read, so a
    monitor with no thresholds never waits for the device; MLIP-3 style reads
    the max grade at once (the thresholds need it).
    """

    model: MTPModel
    select_threshold: Optional[float] = None
    break_threshold: Optional[float] = None
    output_path: Optional[str] = None
    max_neighbors: int = 64

    _max_grade: object = 0.0  # float, or a 0-d device tensor until read
    _nbh_grades: object = None  # numpy array, device tensor until read, or None
    _writer: Optional[CfgWriter] = None

    def __post_init__(self):
        if self.model.inverse_active_set is None:
            raise ValueError(
                "model has no MVS selection state; load a .mtp with an MVS "
                "trailer or build one with mtp_tpu_torch.al.maxvol.build_mvs"
            )
        if self.output_path is not None:
            self._writer = CfgWriter(self.output_path)

    @property
    def nbh_grades(self) -> Optional[np.ndarray]:
        if isinstance(self._nbh_grades, torch.Tensor):
            self._nbh_grades = self._nbh_grades.detach().cpu().numpy()
        return self._nbh_grades

    def evaluate(self, state: MDState, *, refresh_forces: bool = False, nl=None):
        """Compute grades for the current configuration; apply thresholds.

        The forward pass is SHARED between forces and candidate vectors (the
        reference's grade-step fusion, ComputeAlphaBasicRad
        pair_mtp_extrapolation_kokkos.cpp:780-907). With
        ``refresh_forces=True`` returns ``(grade, state)`` with forces,
        energy and virial refreshed from that same pass.

        `nl`: optional existing list (the Simulation's current
        :class:`SortedNeighborList`, built at >= cutoff) -- skips the
        rebuild and takes the window path (K1, K5, K3 on the card). The
        beyond-cutoff (skin) pairs are masked by distance; the caller is
        responsible for the Verlet guarantee (an unflagged simulation block
        provides it).

        Returns the grade as a 0-d device tensor unless thresholds are set
        (MLIP-3 style reads it: the break decision needs the value).
        """
        out = self._compute(state, nl)
        return self._commit(out, state, refresh_forces=refresh_forces)

    def _compute(self, state: MDState, nl=None) -> dict:
        """The device half of :meth:`evaluate`: queues the grade computation,
        touches no monitor state, applies no thresholds. Drivers queue it
        BEFORE reading run flags and `_commit` only accepted segments."""
        with span("al.grade"):
            model = self.model
            if isinstance(nl, SortedNeighborList):
                return grade_eval_window(
                    model, state.positions, state.types, state.cell, nl,
                    model.inverse_active_set, config_mode=model.configuration_mode,
                )
            if nl is None:
                cutoff = model.cutoff
                cell_h = read_cell(state.cell)
                check_cell(cell_h, cutoff)
                grid = grid_shape(cell_h, cutoff)
                # a truncated neighbor list would silently UNDERESTIMATE grades --
                # the one failure mode this subsystem exists to prevent -- so grow
                # the capacity until the build fits
                while True:
                    nl = build_neighbor_list(
                        state.positions, state.cell, cutoff,
                        max_neighbors=self.max_neighbors, grid=grid,
                    )
                    with span("md.read_flags"):
                        fits = not bool(nl.overflow)
                    if fits:
                        break
                    self.max_neighbors = grown_width(self.max_neighbors, "during grading")
            out = candidates_and_forces(
                model, state.positions, state.types, nl.idx, state.cell, nl.mirror,
            )
            b = out["b"]
            if model.configuration_mode:
                g = cfg_grade(b, model.inverse_active_set, state.n_atoms)
                grades = None
            else:
                grades = nbh_grades(b, model.inverse_active_set)
                g = torch.max(grades)
            return dict(
                forces=out["forces"], energy=out["energy"], max_grade=g,
                grades=grades, virial=out["virial"],
            )

    def _commit(self, out: dict, state: MDState, *, refresh_forces: bool):
        """Host half of :meth:`evaluate`: store the observables, apply the
        MLIP-3 thresholds, optionally return the state with forces, energy
        and virial refreshed from the shared pass."""
        with span("al.commit"):
            self._nbh_grades = out["grades"]
            self._max_grade = out["max_grade"]
            g = out["max_grade"]
            if self.mlip3_style:
                with span("al.read_grade"):
                    g = self.max_grade
                self._apply_thresholds(state)
            if refresh_forces:
                new_state = dataclasses.replace(
                    state,
                    forces=out["forces"],
                    potential_energy=out["energy"],
                    virial=out["virial"],
                )
                return g, new_state
            return g

    def _apply_thresholds(self, state: MDState):
        if self._writer is not None and self.max_grade >= self.select_threshold:
            with span("al.write_cfg"):
                self._writer.write(
                    state.cell.detach().cpu().numpy(),
                    state.positions.detach().cpu().numpy(),
                    state.types.cpu().numpy(),
                    grades=None if self.model.configuration_mode else self.nbh_grades,
                    max_grade=self.max_grade,
                )
        self._check_break()


def _first_list(sim: Simulation, state: MDState) -> SortedNeighborList:
    """The Simulation's sorted list for the first grade step, grown by
    ``Simulation._recover`` until it fits. The JAX driver grades the
    starting state on the standalone path; here every grade step, the first
    included, takes the window path."""
    cell_h = read_cell(state.cell)
    cut_skin = sim.model.cutoff + sim.skin
    check_cell(cell_h, cut_skin)
    grid = grid_shape(cell_h, cut_skin)
    while True:
        nl = sim.rebuild(state, grid=grid, max_neighbors=sim.max_neighbors)
        with span("md.read_flags"):
            overflow = bool(nl.overflow)
        if not sim._recover(overflow, False, during="during AL run"):
            return nl


def run_with_extrapolation(
    sim: Simulation,
    monitor: ExtrapolationMonitor,
    state: MDState,
    n_steps: int,
    *,
    al_every: int = 1,
    observer=None,
    **run_kwargs,
):
    """MD with periodic grade evaluation (the `fix pair N ... extrapolation 1`
    pattern, reference README.md:70-76).

    Grade-step economics match the reference's on-device AL pipeline
    (ComputeAlphaBasicRad, pair_mtp_extrapolation_kokkos.cpp:780-907):

    * the grade evaluation REUSES the simulation's last neighbor list (no
      per-eval rebuild; the list is valid within the skin whenever the
      segment's flags are clear), and
    * SHARES its forward pass with the force refresh, so the next MD segment
      starts from the forces the grade step computed (``refresh=False``).

    A tripped segment is discarded and retried after
    ``Simulation._recover`` (the `Simulation.run` rule, counted in
    ``sim.retries``). `run_kwargs` go to
    :meth:`Simulation.run_async` (``ensemble``, ``dt``, ``temperature``,
    ``pressure``, ``tdamp``, ``pdamp``); the integrator state (chains,
    barostat, Langevin generator) is carried from segment to segment, and a
    retried segment restarts from the aux it started with.

    Returns the final state; raises :class:`BreakThresholdExceeded` in MLIP-3
    style when the break threshold is hit (stream flushed first).
    """
    done = 0
    aux = None
    _, state = monitor.evaluate(state, refresh_forces=True, nl=_first_list(sim, state))
    while done < n_steps:
        k = min(al_every, n_steps - done)
        while True:
            new_state, new_aux, flags, nl = sim.run_async(
                state, k, aux=aux, return_nl=True, refresh=False, **run_kwargs,
            )
            # speculative grade dispatch BEFORE the flag read: the device
            # queues the grades behind the segment. _compute is pure (no
            # monitor state, no cfg write, no break), so a tripped segment
            # just discards it and retries.
            pending = monitor._compute(new_state, nl=nl)
            with span("md.read_flags"):
                ovf, stale = torch.stack([flags.overflow, flags.stale]).tolist()
            if not sim._recover(ovf, stale, during="during AL run"):
                break
        done += k
        _, state = monitor._commit(pending, new_state, refresh_forces=True)
        aux = new_aux
        if observer is not None:
            observer(state, monitor)
    return state


@dataclasses.dataclass(eq=False)
class ShardedExtrapolationMonitor(_Selection):
    """Multi-device extrapolation monitor: grades, the max over ranks, and
    an id-ordered gather to rank 0 for the preselected ``.cfg`` stream,
    with the single-device monitor's thresholds and flush-before-break
    contract (the reference's MPI grade pipeline,
    pair_mtp_extrapolation.cpp:363-479). Two engines, both on K5:

    * **window engine** -- ``evaluate(sstate, sim=sharded_sim, ctx=ctx)``
      grades through :meth:`ShardedSimulation.grade_eval
      <mtp_tpu_torch.parallel.sharded_window.ShardedSimulation.grade_eval>`
      inside the simulation's block context (no second rebuild), and the
      shared pass refreshes forces, energy and virial
      (``refresh_forces=True``);
    * **standalone** -- ``evaluate(sstate)`` grades any state through
      :func:`~mtp_tpu_torch.parallel.sharded_md.make_sharded_grades`, which
      builds its own halo and list per call, with `capacity`, `grid`,
      `max_neighbors` and `halo_capacity` (None: maximal). On a tripped
      rebuild flag it grows `max_neighbors`
      (:func:`~mtp_tpu_torch.ops.neighbors.grown_width`), sets the shell to
      its maximum and grades again: a truncated list would underestimate
      grades. It refreshes no forces.

    Every rank of `comm` holds one and makes the same calls: the max grade
    is the same on every rank, so every rank takes the same select and
    break decisions, and the gathers they need are collectives. Only rank 0
    opens and writes `output_path`. Reading :attr:`nbh_grades` is a
    collective too.
    """

    model: MTPModel
    comm: object
    select_threshold: Optional[float] = None
    break_threshold: Optional[float] = None
    output_path: Optional[str] = None
    capacity: Optional[int] = None
    grid: Optional[tuple] = None
    max_neighbors: int = 64
    halo_capacity: object = None

    _max_grade: object = 0.0  # float, or a 0-d device tensor until read
    _nbh_pending: object = None  # (grades, state) until read, numpy array, or None
    _writer: Optional[CfgWriter] = None
    _grades_fn: object = None

    def __post_init__(self):
        if self.model.inverse_active_set is None:
            raise ValueError("model has no MVS selection state")
        if self.output_path is not None and self.comm.rank == 0:
            self._writer = CfgWriter(self.output_path)

    @property
    def nbh_grades(self) -> Optional[np.ndarray]:
        """Per-atom grades of the last evaluation in original atom order (a
        collective on first read), or None in configuration mode."""
        if isinstance(self._nbh_pending, tuple):
            grades, snap = self._nbh_pending
            self._nbh_pending = snap.gather(grades, self.comm)
        return self._nbh_pending

    def evaluate(self, sstate, *, sim=None, ctx=None, refresh_forces: bool = False):
        """Grades of a ShardedState, through `sim`'s window engine with the
        block context `ctx` of its last rebuild, or without them through the
        standalone engine; thresholds as in the single-device monitor.
        ``refresh_forces=True`` (window engine only) returns ``(grade,
        state)`` with forces, energy and virial from the same pass."""
        if refresh_forces and sim is None:
            raise ValueError("standalone evaluation has no force refresh; pass sim/ctx for "
                             "the window engine")
        return self._commit(self._compute(sstate, sim=sim, ctx=ctx), sstate,
                            refresh_forces=refresh_forces)

    def _compute(self, sstate, *, sim=None, ctx=None) -> dict:
        """The device half: queues the grade pass, touches no monitor state
        (the standalone engine reads its flags and may grow its own
        capacities)."""
        if sim is not None:
            if ctx is None:
                raise ValueError("window-engine evaluation needs the block ctx from sim.rebuild")
            return sim.grade_eval(sstate, ctx)
        return self._standalone(sstate)

    def _standalone(self, sstate) -> dict:
        from mtp_tpu_torch.parallel.sharded_md import make_sharded_grades

        if self.capacity is None or self.grid is None:
            raise ValueError("the standalone engine needs the monitor's capacity and grid")
        while True:
            if self._grades_fn is None:
                self._grades_fn = make_sharded_grades(
                    self.model, self.comm, capacity=self.capacity,
                    max_neighbors=self.max_neighbors, grid=self.grid,
                    halo_capacity=self.halo_capacity, slab_axis=sstate.axes[0],
                )
            g, grades, flags = self._grades_fn(sstate)
            if not bool(flags):  # the same on every rank
                return dict(max_grade=g, grades=grades)
            self.max_neighbors = grown_width(self.max_neighbors, "during standalone grading")
            self.halo_capacity = None
            self._grades_fn = None

    def _commit(self, out: dict, sstate, *, refresh_forces: bool = False):
        """The host half: store the observables, apply the MLIP-3
        thresholds, optionally return the refreshed state. The pending
        grades pin THIS state, whose ids pair with them."""
        self._max_grade = out["max_grade"]
        self._nbh_pending = None if self.model.configuration_mode else (out["grades"], sstate)
        g = out["max_grade"]
        if self.mlip3_style:
            g = self.max_grade
            self._apply_thresholds(sstate)
        if refresh_forces:
            return g, dataclasses.replace(sstate, forces=out["forces"],
                                          potential_energy=out["energy"], virial=out["virial"])
        return g

    def _apply_thresholds(self, sstate):
        if self.output_path is not None and self.max_grade >= self.select_threshold:
            grades = self.nbh_grades
            pos, typ = sstate.gather_all([sstate.positions, sstate.types], self.comm, root=0)
            if self._writer is not None:
                self._writer.write(sstate.cell.detach().cpu().numpy(), pos, typ,
                                   grades=grades, max_grade=self.max_grade)
        self._check_break()


def run_sharded_with_extrapolation(
    sim,
    monitor: ShardedExtrapolationMonitor,
    sstate,
    n_steps: int,
    *,
    al_every: int = 1,
    observer=None,
    **run_kwargs,
):
    """Multi-device MD with periodic grade evaluation on the window engine:
    the sharded :func:`run_with_extrapolation`. Every rank calls it.

    * the grade evaluation REUSES the segment's last block context
      (``ShardedSimulation.grade_eval``: lists, halo selections and window
      constants; no second rebuild),
    * it SHARES its fused pass with the force refresh, so the next segment
      starts from the forces, energy and virial it computed
      (``refresh=False``), and
    * it is queued BEFORE the segment's flags are read; a tripped segment
      discards it, applies ``ShardedSimulation._recover`` and retries.

    `run_kwargs` go to :meth:`ShardedSimulation.steps` (``ensemble``, ``dt``,
    ``temperature``, ``pressure``, ``tdamp``, ``pdamp``); the thermostat and
    barostat state rides in ``sstate.thermo``. `sim.model` must carry the
    MVS selection state. Returns the final ShardedState; raises
    :class:`BreakThresholdExceeded` in MLIP-3 style when the break
    threshold is hit (stream flushed first).
    """
    state, ctx, f4 = sim.rebuild(sstate)
    if any(torch.stack(list(f4)).tolist()):
        sim._recover([*f4, False])
        state, ctx, f4 = sim.rebuild(sstate)
        if any(torch.stack(list(f4)).tolist()):
            raise RuntimeError("initial sharded rebuild keeps tripping flags")
    _, state = monitor._commit(monitor._compute(state, sim=sim, ctx=ctx), state,
                               refresh_forces=True)
    done = 0
    while done < n_steps:
        k = min(al_every, n_steps - done)
        while True:
            cur, ctx, flags = sim._segment(state, k, refresh=False, **run_kwargs)
            # speculative grade dispatch BEFORE the flag read; _compute is
            # pure, so a tripped segment just discards it
            pending = monitor._compute(cur, sim=sim, ctx=ctx)
            flags = flags.tolist()
            if not any(flags):
                break
            sim._recover(flags, cell=state.cell.detach().cpu().numpy())
        done += k
        _, state = monitor._commit(pending, cur, refresh_forces=True)
        if observer is not None:
            observer(state, monitor)
    return state
