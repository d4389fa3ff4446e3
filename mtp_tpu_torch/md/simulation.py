"""Simulation driver: the MTP model, the neighbor engine and an integrator
in a block loop (port of ``mtp_tpu/md/simulation.py``).

One block, :meth:`Simulation.block`, is the only code that rebuilds and
steps: it rebuilds the bin-sorted neighbor list once, moves the state into
sorted space, runs its steps with force-only evaluations (K1, K2, K3 on the
card), checks Verlet staleness with the top-2 displacement rule, evaluates
the energy once (K4) and moves back. The loop is eager Python over kernel
launches and plain torch operations. Three entry points run it:

* :meth:`Simulation.run`       one block at a time, one host read of its
                               flags, a tripped block recovered by
                               :meth:`Simulation._recover`; observer hook.
* :meth:`Simulation.run_async` throughput path: blocks queued back to back,
                               no host read until the caller reads the flags.
* :meth:`Simulation.run_fused` the same queue on a fixed grid and width,
                               flags OR-ed into one.

The AL driver (``al/driver.py``) and FIRE (``md/minimize.py``) step
through the same block and recover through the same rule.

Ensembles: ``"nve"``, ``"nvt"`` (Nose-Hoover chain), ``"langevin"`` (BAOAB),
``"npt"`` (isotropic MTK), ``"npt-aniso"`` and ``"npt-tri"`` (full-cell
MTK). The port has one force path, the window path: the JAX package's
TPU knobs ``remat``, ``backend``, ``window`` and ``giveback`` have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mtp_tpu_torch.md import integrators as itg
from mtp_tpu_torch.md.state import MDState
from mtp_tpu_torch.models.mtp import (
    MTPModel,
    mtp_energy_forces_window,
    mtp_energy_window,
    window_constants,
)
from mtp_tpu_torch.ops.md_step import verlet_check
from mtp_tpu_torch.ops.neighbors import (
    SortedNeighborList,
    build_sorted_neighbor_list,
    check_cell,
    grid_shape,
    grown_width,
)
from mtp_tpu_torch.ops.window_disp import cell_product, inverse_cell
from mtp_tpu_torch.utils.tracing import span

ENSEMBLES = ("nve", "nvt", "langevin", "npt", "npt-aniso", "npt-tri")
_CONSTANT_CELL = ("nve", "nvt", "langevin")


def _check_ensemble(ensemble: str) -> None:
    if ensemble not in ENSEMBLES:
        raise ValueError(f"unknown ensemble {ensemble!r}; one of {ENSEMBLES}")


@dataclasses.dataclass
class RunFlags:
    """Failure flags of an async run (device bool scalars).

    `overflow`: a neighbor or bin capacity, or the bin-grid geometry, was
    exceeded: grow `max_neighbors` (or re-derive the grid). `stale`: an atom
    outran the Verlet skin within a block: shorten `steps_per_rebuild`.
    ``bool(flags)`` is the OR.
    """

    overflow: torch.Tensor
    stale: torch.Tensor

    def __bool__(self) -> bool:
        return bool(self.overflow) or bool(self.stale)


@dataclasses.dataclass(eq=False)
class Simulation:
    """Host-side controller for single-device MD.

    Args:
      model: the MTP model (its device and dtype are the run's).
      max_neighbors: neighbor width J (:meth:`_recover` grows it on overflow).
      skin: Verlet skin [A]; lists are built at cutoff + skin.
      steps_per_rebuild: steps per neighbor rebuild.
      compute_virial: tally the virial every step (LAMMPS vflag). The
        ``npt*`` ensembles tally it whatever this says.
      grid_margin: bins are sized >= grid_margin*(cutoff+skin), so an NPT
        cell can shrink by (grid_margin-1) before the grid, fixed for a
        :meth:`run_async` or :meth:`run_fused` call, trips the geometry flag.

    ``retries`` counts the attempts that :meth:`_recover` discarded (in
    :meth:`run`, ``al.driver.run_with_extrapolation`` and FIRE), by cause:
    ``"overflow"`` (J grown) and ``"stale"`` (the block halved); LAMMPS
    reports the second kind as "Dangerous builds".
    """

    model: MTPModel
    max_neighbors: int = 64
    skin: float = 0.5
    steps_per_rebuild: int = 10
    compute_virial: bool = True
    grid_margin: float = 1.0
    retries: dict = dataclasses.field(
        default_factory=lambda: {"overflow": 0, "stale": 0}, init=False)

    def force_fn_window(
        self, swl: SortedNeighborList, types, compute_virial=None, *,
        sorted_io: bool = False, compute_energy: bool = True,
    ):
        """Force closure over a frozen list; rebuild constants are computed
        here, once. `types` is in user order. The closure's `energy_fn`
        evaluates the energy alone (K4)."""
        consts = window_constants(self.model, types, swl)
        cv = self.compute_virial if compute_virial is None else compute_virial

        def fn(positions, types_unused, cell):
            with span("mtp.forces"):
                out = mtp_energy_forces_window(
                    self.model, positions, cell, swl, compute_virial=cv,
                    sorted_io=sorted_io, compute_energy=compute_energy, **consts,
                )
            return out["forces"], out["energy"], out["virial"]

        def energy_fn(positions, cell):
            with span("mtp.energy"):
                return mtp_energy_window(
                    self.model, positions, cell, swl, sorted_io=sorted_io, **consts
                )

        fn.energy_fn = energy_fn
        return fn

    def _virial_for(self, ensemble: str) -> bool:
        return self.compute_virial or ensemble.startswith("npt")

    def grid_for(self, cell) -> tuple:
        """The bin grid for a cell: (cutoff + skin) * grid_margin per bin.
        Reads the cell to the host."""
        return grid_shape(read_cell(cell), (self.model.cutoff + self.skin) * self.grid_margin)

    def rebuild(self, state: MDState, *, grid: tuple, max_neighbors: int):
        return build_sorted_neighbor_list(
            state.positions, state.cell, self.model.cutoff + self.skin,
            max_neighbors=max_neighbors, grid=grid,
        )

    def refresh_forces(self, state: MDState, nl: SortedNeighborList, *, ensemble: str = "nve"):
        """The state's forces, energy and virial recomputed against `nl`, in
        user order. No driver calls it: a block refreshes in sorted space
        (:meth:`steps` with ``refresh=True``)."""
        force_fn = self.force_fn_window(nl, state.types, self._virial_for(ensemble))
        return itg._with_forces(state, force_fn)

    def block(
        self, state: MDState, aux, *, grid: tuple, max_neighbors: int, n_steps: int = 10,
        refresh: bool = False, first: int = 0, return_nl: bool = False, **kw,
    ):
        """One block in an ``md.block`` span: rebuild, then :meth:`steps`
        against the list (`refresh` and `kw` go to it). Every driver steps
        through here. The span's arguments are the block's first step within
        its run (`first`; a retried block repeats it), J and its steps.
        Returns (state, aux, overflow, stale[, nl]), the flags as device
        scalars."""
        with span("md.block", f"first={first} J={max_neighbors} steps={n_steps}"):
            nl = self.rebuild(state, grid=grid, max_neighbors=max_neighbors)
            state, aux, stale = self.steps(state, aux, nl, n_steps=n_steps, refresh=refresh, **kw)
        if return_nl:
            return state, aux, nl.overflow, stale, nl
        return state, aux, nl.overflow, stale

    @staticmethod
    def _permute_state(state: MDState, perm):
        return dataclasses.replace(
            state,
            positions=state.positions[perm],
            velocities=state.velocities[perm],
            forces=state.forces[perm],
            masses=state.masses[perm],
            types=state.types[perm],
        )

    def _scan_steps(
        self, state, aux, force_fn, *, ensemble, n_steps, dt, temperature, pressure,
        tdamp, pdamp, ref_positions, ref_cell,
    ):
        """Integrator steps with the Verlet staleness check (LAMMPS
        ``neigh_modify check yes``), OR-accumulated into a device flag.

        Under a barostat the cell's affine rescaling moves atoms without
        invalidating lists, so the check measures the displacement from the
        reference rescaled into the current cell, and adds a shrink term: a
        pair just outside cutoff+skin enters the cutoff when the two largest
        displacements plus (1 - s_min)*(cutoff+skin) exceed the skin. Exact
        pair criterion: a missing pair (i, j) enters only if d_i + d_j >=
        skin for DISTINCT atoms, so the bound sums the two largest
        displacements. Under the constant-cell ensembles the rescaled
        reference and the shrink term are the same every step and are taken
        once per block; under NPT they are taken every step."""
        _check_ensemble(ensemble)

        def step(state, aux):
            if ensemble == "nve":
                return itg.nve_step(state, force_fn, dt), aux
            if ensemble == "nvt":
                return itg.nvt_step(state, aux, force_fn, dt, temperature, tdamp)
            if ensemble == "langevin":
                return itg.langevin_step(state, aux, force_fn, dt, temperature, tdamp)
            if ensemble == "npt":
                return itg.npt_step(state, aux, force_fn, dt, temperature, pressure, tdamp,
                                    pdamp)
            return itg.npt_aniso_step(state, aux, force_fn, dt, temperature, pressure, tdamp,
                                      pdamp, couple="tri" if ensemble == "npt-tri" else "aniso")

        cut_skin = self.model.cutoff + self.skin
        inv_ref = inverse_cell(ref_cell)
        ref_frac = cell_product(ref_positions.unbind(-1), inv_ref)
        ref_widths = 1.0 / torch.linalg.vector_norm(inv_ref, dim=0)  # plane spacings

        def geometry(cell):
            widths = 1.0 / torch.linalg.vector_norm(inverse_cell(cell), dim=0)
            shrink = torch.clamp(1.0 - torch.min(widths / ref_widths), min=0.0) * cut_skin
            return torch.stack(cell_product(ref_frac, cell), dim=-1), shrink

        scaled_ref, shrink = geometry(state.cell)
        # the block's flag: each step's check ORs into it in place (K10)
        stale = torch.zeros((), dtype=torch.bool, device=state.positions.device)
        for _ in range(n_steps):
            with span("md.integrate"):
                state, aux = step(state, aux)
            with span("md.verlet_check"):
                if ensemble not in _CONSTANT_CELL:
                    scaled_ref, shrink = geometry(state.cell)
                verlet_check(state.positions, scaled_ref, self.skin, stale, shrink)
        return state, aux, stale

    def steps(
        self, state: MDState, aux, nl, *, ensemble: str = "nve", n_steps: int = 10,
        dt: float = 0.001, temperature: float = 300.0, pressure: float = 0.0,
        tdamp: float = 0.1, pdamp: float = 1.0, refresh: bool = False, scan=None,
    ):
        """`n_steps` steps with the frozen list `nl`, in an ``md.steps`` span,
        in SORTED space: one permute in and one out (the integrators are
        permutation-equivariant), force-only steps (K1, K2, K3) and the
        energy (K4) once at the end. `refresh` recomputes the incoming
        forces first (they are stale or zero: a run's first block, or a
        retry). ``scan(state, aux, force_fn, n_steps=, ref_positions=,
        ref_cell=)`` runs the steps and returns (state, aux, stale); by
        default the ensemble's integrator (:meth:`_scan_steps`), while FIRE
        passes its iterations. Returns (state, aux, stale) with `state` back
        in user order: `stale` a device bool set if an atom outran the
        skin."""
        if scan is None:
            scan = functools.partial(self._scan_steps, ensemble=ensemble, dt=dt,
                                     temperature=temperature, pressure=pressure, tdamp=tdamp,
                                     pdamp=pdamp)
        with span("md.steps"):
            force_fn = self.force_fn_window(
                nl, state.types, self._virial_for(ensemble), sorted_io=True,
                compute_energy=False,
            )
            state = self._permute_state(state, nl.order)
            if refresh:
                state = itg._with_forces(state, force_fn)
            state, aux, stale = scan(
                state, aux, force_fn, n_steps=n_steps,
                ref_positions=nl.reference_positions[nl.order], ref_cell=nl.reference_cell,
            )
            state = dataclasses.replace(
                state, potential_energy=force_fn.energy_fn(state.positions, state.cell)
            )
            return self._permute_state(state, nl.inv_order), aux, stale

    def _queue(self, state, aux, n_steps, *, grid, max_neighbors, steps_per_block, refresh,
               **kw):
        """Blocks of `steps_per_block` queued back to back with no host read:
        the one loop of :meth:`run_async` and :meth:`run_fused`. Only the
        first block refreshes, if `refresh`. Returns (state, aux, overflow,
        stale, nl): the flags OR-ed on the device, the last block's list."""
        dev = state.positions.device
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        stale = torch.zeros((), dtype=torch.bool, device=dev)
        nl = None
        for first in range(0, n_steps, steps_per_block):
            state, aux, o, s, nl = self.block(
                state, aux, grid=grid, max_neighbors=max_neighbors,
                n_steps=min(steps_per_block, n_steps - first), refresh=refresh and first == 0,
                first=first, return_nl=True, **kw,
            )
            overflow, stale = overflow | o, stale | s
        return state, aux, overflow, stale, nl

    def run_async(
        self,
        state: MDState,
        n_steps: int,
        *,
        ensemble: str = "nve",
        dt: float = 0.001,
        temperature: float = 300.0,
        pressure: float = 0.0,
        tdamp: float = 0.1,
        pdamp: float = 1.0,
        aux=None,
        return_nl: bool = False,
        refresh: bool = True,
    ):
        """Throughput path: blocks of ``steps_per_rebuild`` queued back to
        back at ``max_neighbors``, forces carried across blocks, no host read
        after the cell's, until the caller reads the flags.

        Returns (state, aux, flags[, nl]): `flags` is a :class:`RunFlags` of
        device scalars, `nl` the last block's list. `refresh` recomputes the
        first block's incoming forces; False trusts them (and, for NPT, the
        virial) to be consistent with the positions. The bin grid comes
        from the initial cell: under NPT the neighbor build flags `overflow`
        if the cell shrinks past the grid's validity.
        """
        aux = _default_aux(ensemble, state, aux)
        check_cell(read_cell(state.cell), self.model.cutoff + self.skin)
        state, aux, overflow, stale, nl = self._queue(
            state, aux, n_steps, grid=self.grid_for(state.cell),
            max_neighbors=self.max_neighbors, steps_per_block=self.steps_per_rebuild,
            refresh=refresh, ensemble=ensemble, dt=dt, temperature=temperature,
            pressure=pressure, tdamp=tdamp, pdamp=pdamp,
        )
        flags = RunFlags(overflow=overflow, stale=stale)
        if return_nl:
            return state, aux, flags, nl
        return state, aux, flags

    def run_fused(
        self,
        state: MDState,
        aux,
        *,
        grid: tuple,
        max_neighbors: int,
        n_blocks: int,
        steps_per_block: int,
        ensemble: str = "nve",
        dt: float = 0.001,
        temperature: float = 300.0,
        pressure: float = 0.0,
        tdamp: float = 0.1,
        pdamp: float = 1.0,
    ):
        """`n_blocks` x (rebuild + `steps_per_block` steps) back to back with
        no host read, as the JAX package's one compiled program does: the
        loop of :meth:`run_async` on a given grid and width. No block
        refreshes its incoming forces: the first block integrates from
        ``state.forces`` as given. Overflow and staleness are OR-ed into one
        device flag, returned at the end (re-run with more capacity or a
        shorter block if set). Under NPT the grid stays `grid`; the neighbor
        build flags overflow if the cell shrinks past its validity.

        Returns (state, aux, flag)."""
        aux = _default_aux(ensemble, state, aux)
        state, aux, overflow, stale, _ = self._queue(
            state, aux, n_blocks * steps_per_block, grid=grid, max_neighbors=max_neighbors,
            steps_per_block=steps_per_block, refresh=False, ensemble=ensemble, dt=dt,
            temperature=temperature, pressure=pressure, tdamp=tdamp, pdamp=pdamp,
        )
        return state, aux, overflow | stale

    def run(
        self,
        state: MDState,
        n_steps: int,
        *,
        ensemble: str = "nve",
        dt: float = 0.001,
        temperature: float = 300.0,
        pressure: float = 0.0,
        tdamp: float = 0.1,
        pdamp: float = 1.0,
        aux=None,
        observer=None,
        refresh: bool = True,
    ):
        """Run `n_steps`, recovering from tripped blocks.

        Each block is one :meth:`block` on a grid re-derived from the current
        cell, then one host read of its two flags. A tripped block is
        discarded and retried after :meth:`_recover`: a wider list on
        overflow, a shorter block on staleness.

        `observer(state)` is called after every accepted block (host side:
        thermo output, dumps, hooks). `refresh=False` trusts the incoming
        ``state.forces`` to be position-consistent and has no block refresh
        them; with True every block recomputes its incoming forces.

        Returns (state, aux).
        """
        aux = _default_aux(ensemble, state, aux)
        check_cell(read_cell(state.cell), self.model.cutoff + self.skin)
        done = 0
        while done < n_steps:
            k = min(self.steps_per_rebuild, n_steps - done)
            new_state, new_aux, overflow, stale = self.block(
                state, aux, grid=self.grid_for(state.cell), max_neighbors=self.max_neighbors,
                n_steps=k, refresh=refresh, first=done, ensemble=ensemble, dt=dt,
                temperature=temperature, pressure=pressure, tdamp=tdamp, pdamp=pdamp,
            )
            with span("md.read_flags"):
                overflow, stale = torch.stack([overflow, stale]).tolist()
            if self._recover(overflow, stale):
                continue
            state, aux = new_state, new_aux
            done += k
            if observer is not None:
                observer(state)
        return state, aux

    def _recover(self, overflow: bool, stale: bool, *, during: str = "") -> bool:
        """The recovery rule of a block attempt from its two flags (host
        bools), shared by :meth:`run`, the AL driver and FIRE: True if the
        attempt is to be discarded. On overflow J grows
        (:func:`~mtp_tpu_torch.ops.neighbors.grown_width`, which raises at
        J >= 1024); on staleness `steps_per_rebuild` halves, and at 1 it
        raises (the system diverges or the skin is too small). Both changes
        stay on this Simulation, and each discarded attempt counts in
        ``retries``. `during` names the caller's run in the messages."""
        if overflow:
            self.max_neighbors = grown_width(self.max_neighbors, during)
            self.retries["overflow"] += 1
            return True
        if not stale:
            return False
        if self.steps_per_rebuild <= 1:
            where = f" {during}" if during else ""
            raise RuntimeError(
                f"Verlet staleness at steps_per_rebuild=1{where}: an atom moved > skin/2 "
                f"({self.skin / 2:.3f} A) in a single step. The system is diverging or the "
                "skin is too small: check dt/forces or increase skin."
            )
        self.steps_per_rebuild //= 2
        self.retries["stale"] += 1
        return True

    def minimize(self, state: MDState, **kw):
        """FIRE 2.0 relaxation (LAMMPS ``minimize``) on this simulation's
        neighbor and force engine; see
        :func:`mtp_tpu_torch.md.minimize.fire_minimize` for the knobs."""
        from mtp_tpu_torch.md.minimize import fire_minimize

        return fire_minimize(self, state, **kw)


def read_cell(cell) -> np.ndarray:
    """The cell as a host array: a read that waits for the device (span
    ``md.read_cell``)."""
    with span("md.read_cell"):
        return cell.detach().cpu().numpy()


def _default_aux(ensemble, state, aux=None):
    """A run's integrator state after checking its ensemble: `aux`, or when
    None the one it starts from: zeroed chains and barostat, or for
    Langevin a generator on the state's device seeded 0. NVE carries none
    (None)."""
    _check_ensemble(ensemble)
    if aux is not None:
        return aux
    dtype, dev = state.positions.dtype, state.positions.device
    if ensemble == "nvt":
        return itg.nhc_init(dtype, dev)
    if ensemble == "npt":
        return itg.npt_init(dtype, dev)
    if ensemble in ("npt-aniso", "npt-tri"):
        return itg.npt_aniso_init(dtype, dev)
    if ensemble == "langevin":
        return itg.langevin_init(0, dev)
    return None


def make_lattice(kind: str, a: float, reps, *, type_pattern=(0,)):
    """Simple crystal builder (LAMMPS `lattice`/`create_atoms`).

    kind: 'sc' | 'bcc' | 'fcc'. `reps` = (nx, ny, nz) unit cells.
    Returns numpy float64 positions (N, 3), int32 types (N,), cell (3, 3).
    """
    basis = {
        "sc": [(0, 0, 0)],
        "bcc": [(0, 0, 0), (0.5, 0.5, 0.5)],
        "fcc": [(0, 0, 0), (0.5, 0.5, 0), (0.5, 0, 0.5), (0, 0.5, 0.5)],
    }[kind]
    nx, ny, nz = reps
    pts = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                for b in basis:
                    pts.append(((i + b[0]) * a, (j + b[1]) * a, (k + b[2]) * a))
    pos = np.asarray(pts, dtype=np.float64)
    types = np.array(
        [type_pattern[i % len(type_pattern)] for i in range(len(pos))], dtype=np.int32
    )
    cell = np.diag([nx * a, ny * a, nz * a]).astype(np.float64)
    return pos, types, cell
