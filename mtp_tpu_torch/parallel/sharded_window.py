"""Multi-device MD on the window kernel path, one process per rank (port of
``mtp_tpu/parallel/sharded_window.py``).

Each rank runs the single-device window pipeline (K1 displacements, K2 pair
forces, K3 give-back, K4 energies, K5 grade steps) unchanged on its
halo-extended set, the design point of the reference, whose Kokkos pipeline
runs unchanged on each MPI rank's local + ghost view
(pair_mtp_kokkos.cpp:287-361). A block is two phases:

* :meth:`ShardedSimulation.rebuild`: migrate atoms whose domain changed ->
  face-shell halo selection -> position and type exchange -> bin-sorted
  neighbor build over the halo-EXTENDED set (ghost rows get neighbor rows
  too, so the mirror sees a symmetric list; padding rows go to the trash
  bin) -> rebuild constants with the ghosts masked as centers.
* :meth:`ShardedSimulation.steps`: integrator steps (NVE, NHC-NVT, MTK NPT
  iso, aniso and tri); each force evaluation ships the ghost positions in
  and the ghosts' force rows back (one batch of messages per grid axis each
  way) around :func:`~mtp_tpu_torch.models.mtp.mtp_energy_forces_window`.

Ghost centers are masked (``center_mask``): a ghost's neighborhood is
incomplete, so its site energy and pair forces come from its owner. K3 then
fills a ghost row with exactly -sum_i T_{i->ghost} over the own centers i
around it, and that row travels back to the owner and adds on (the LAMMPS
reverse communication, pair_mtp.cpp:248-254). A rank's energy and virial sum
only its own centers; the half-shares of a pair that straddles two ranks
complete in the sum over ranks.

Decomposition: 1-D slabs on a ``(n,)`` rank grid, or 2-D bricks on
``(n0, n1)`` (the LAMMPS brick analog). The 2-D halo runs as two stages:
axis-0 face shells first, then axis-1 face shells of the axis-0-EXTENDED
set, so corner ghosts ride the second hop; the give-back reverses both hops
(a stage-1 return may add into a stage-0 ghost row, which then goes on to
the diagonal owner). Migration re-homes diagonal movers in two per-axis hops
within one rebuild.

Not ported, by design: the TPU-only context of the JAX class (``window_idx``,
``wl``, ``wl_counts``, the ``gb_*`` tables, ``align_slots``, the
``giveback`` knob, ``TN`` padding, ``_COL_SHARDED``): the port has one force
path, K3 through ``mirror_t``. JAX has no sharded Langevin, and neither does
the port.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from mtp_tpu_torch.al.grades import candidates_and_forces_window, cfg_grade, nbh_grades
from mtp_tpu_torch.md import integrators as itg
from mtp_tpu_torch.md.state import cell_volume
from mtp_tpu_torch.models.mtp import (
    MTPModel,
    mtp_energy_forces_window,
    mtp_energy_window,
    window_constants,
)
from mtp_tpu_torch.ops.md_step import verlet_top2
from mtp_tpu_torch.ops.neighbors import (
    build_sorted_neighbor_list,
    grid_shape,
    grown_width,
    perpendicular_widths,
)
from mtp_tpu_torch.ops.window_disp import cell_product, inverse_cell
from mtp_tpu_torch.parallel.comm import Comm
from mtp_tpu_torch.parallel.sharded_md import (
    ShardedState,
    ShardFlags,
    exchange,
    halo_select,
    migrate,
    plane_spacings,
)
from mtp_tpu_torch.utils import units

SHARDED_ENSEMBLES = ("nve", "nvt", "npt", "npt-aniso", "npt-tri")


class ShardedRunFlags(NamedTuple):
    """Device-bool flags of a sharded run, the same on every rank."""

    neighbor_overflow: torch.Tensor  # list/bin capacity or bin geometry
    halo_overflow: torch.Tensor  # face shell exceeded the halo capacity
    migrate_overflow: torch.Tensor  # migration buffers / free slots exceeded
    escape: torch.Tensor  # an atom jumped past the adjacent domain in one block
    stale: torch.Tensor  # an atom outran the Verlet skin mid-block

    def any(self):
        return (self.neighbor_overflow | self.halo_overflow | self.migrate_overflow
                | self.escape | self.stale)


@dataclasses.dataclass(eq=False)
class ShardedSimulation:
    """Host-side controller of one rank's share of multi-device MD.

    Every rank of `comm` builds one with the same arguments and makes the
    same calls. Two drivers over one loop of (rebuild, steps) per Verlet
    block, :meth:`_segment`: :meth:`run_async` (no host read; flags
    accumulate on the device, the throughput path) and :meth:`run` (one
    flag read per block; a tripped block is discarded and retried after
    :meth:`_recover` grows the capacity that tripped).

    Args:
      model: the MTP model (its device and dtype are the run's).
      comm: the rank grid and transport.
      capacity: slots per rank (C).
      max_neighbors: neighbor width J (a multiple of 8).
      grid: the bin grid of the whole box. An axis of 1 or 2 bins is
        visited whole by the cell list (``ops.neighbors``), so long boxes
        with a narrow cross-section (the JAX package sends them to its XLA
        row-gather path) run here like any other.
      halo_capacity: a tuple, one shell capacity per grid axis (as
        :func:`~mtp_tpu_torch.parallel.domain.halo_capacities` gives them),
        or None: maximal, each stage's shell a subset of its source rows,
        always sufficient but the widest.
      migrate_capacity: migration buffer rows per direction (default C/8).
      compute_virial: tally the virial every step; the ``npt*`` ensembles
        tally it whatever this says.
    """

    model: MTPModel
    comm: Comm
    capacity: int
    max_neighbors: int
    grid: tuple
    skin: float = 0.5
    steps_per_rebuild: int = 10
    halo_capacity: Optional[tuple] = None
    migrate_capacity: Optional[int] = None
    compute_virial: bool = False

    def __post_init__(self):
        self.sizes = self.comm.grid
        self.w_cut = self.model.cutoff + self.skin
        self._reconfigure()

    def _reconfigure(self):
        """Re-derive the capacity-dependent layout. Called at construction
        and by :meth:`run`'s recovery after growing `max_neighbors`,
        `halo_capacity` or `migrate_capacity`."""
        C = self.capacity
        if self.max_neighbors % 8:
            raise ValueError("max_neighbors must be a multiple of 8")
        self.E = self.migrate_capacity if self.migrate_capacity is not None else max(8, C // 8)
        # one stage per grid axis: stage k ships the face shells of the
        # stage-(k-1)-extended set along axis k
        hc = self.halo_capacity
        self.stages = []
        src = C
        for k, nk in enumerate(self.sizes):
            if nk <= 1:
                hk = 0
            elif hc is None:
                hk = src  # maximal: the shell is a subset of the source
            else:
                hk = hc[k]
            self.stages.append(dict(axis=k, nd=nk, H=hk, base=src))
            src += 2 * hk
        self.NE = src
        # each rank's extended set is a SUBSET of the global atom set per bin
        # (ghosts sit at their owners' coordinates), so the single-device
        # uniform-density cap applies; overflow is flagged
        nd = int(np.prod(self.sizes))
        self.bin_cap = max(1, int(np.ceil(2.2 * nd * C / int(np.prod(self.grid))))) + 12

    # ------------------------------------------------------------ halo

    def _exchange_multi(self, items, sels):
        """[(own (C, ...), fill), ...] -> the same arrays halo-extended to
        (NE, ...), stage by stage, each stage's messages in one batch."""
        arrs = [x for x, _ in items]
        for st, sel in zip(self.stages, sels):
            if st["nd"] == 1:
                continue
            arrs = exchange([(a, fill) for a, (_, fill) in zip(arrs, items)], sel, self.comm, st)
        return arrs

    def _giveback_multi(self, f_ext, sels):
        """Reverse the halo hops: the ghost rows' force contributions go back
        to their owners stage by stage and add on, in a fixed order (sel_r's
        rows, then sel_l's; each index_add over unique rows)."""
        for st, (sr, vr, sl, vl) in reversed(list(zip(self.stages, sels))):
            if st["nd"] == 1:
                continue
            base, h = st["base"], st["H"]
            back_r, back_l = self.comm.shifts(
                [(f_ext[base:base + h], -1), (f_ext[base + h:base + 2 * h], +1)], st["axis"]
            )
            low = torch.cat([f_ext[:base], torch.zeros_like(f_ext[:1])])  # + a trash row
            low.index_add_(0, torch.where(vr, sr, base), back_r)
            low.index_add_(0, torch.where(vl, sl, base), back_l)
            f_ext = low[:base]
        return f_ext

    # ---------------------------------------------------------- rebuild

    def rebuild(self, state: ShardedState):
        """Migration, halo selection, exchange and the window neighbor build
        over the extended set, along the cell vectors the state's partition
        cut along (``state.axes``). Returns (state, ctx,
        :class:`ShardFlags`)."""
        if len(state.axes) != len(self.sizes) or len(set(state.axes)) != len(state.axes):
            raise ValueError(f"the state was partitioned along cell vectors {state.axes}; the "
                             f"rank grid {self.sizes} needs one distinct vector per axis")
        stages = [dict(st, slab_axis=ax) for st, ax in zip(self.stages, state.axes)]
        comm = self.comm
        dev = state.positions.device
        zero = torch.zeros((), dtype=torch.bool, device=dev)
        inv_cell = inverse_cell(state.cell)
        fields = (state.positions, state.velocities, state.forces, state.types, state.masses,
                  state.real, state.ids)
        mig_ovf = escape = zero
        # a diagonal mover re-homes in two per-axis hops within this rebuild
        for st in stages:
            fields, (mo, esc) = migrate(fields, inv_cell, comm, st, self.E)
            mig_ovf, escape = mig_ovf | mo, escape | esc
        pos, vel, f, types, masses, real, ids = fields
        # staged selection: stage k selects face shells of the stage-(k-1)-
        # extended set; the types ride as -1 on rows that are not real
        sels = []
        halo_ovf = zero
        cur_pos, cur_tr = pos, torch.where(real, types.long(), -1)
        for st in stages:
            sel, ho = halo_select(cur_pos, cur_tr >= 0, inv_cell, comm, st, self.w_cut)
            halo_ovf = halo_ovf | ho
            sels.append(sel)
            if st["nd"] > 1:
                cur_pos, cur_tr = exchange([(cur_pos, 0.0), (cur_tr, -1)], sel, comm, st)
        ext_real = cur_tr >= 0
        swl = build_sorted_neighbor_list(
            cur_pos, state.cell, self.w_cut, max_neighbors=self.max_neighbors, grid=self.grid,
            real=ext_real, bin_capacity=self.bin_cap,
        )
        own = (torch.arange(self.NE, device=dev) < self.capacity) & ext_real
        consts = window_constants(self.model, torch.clamp(cur_tr, min=0), swl, center_mask=own)
        flags = comm.max(torch.stack([swl.overflow, halo_ovf, mig_ovf, escape]))
        state = dataclasses.replace(state, positions=pos, velocities=vel, forces=f, types=types,
                                    masses=masses, real=real, ids=ids)
        ctx = dict(swl=swl, consts=consts, sels=sels, own=own, real=ext_real)
        return state, ctx, ShardFlags(*flags.unbind())

    # ------------------------------------------------------------ steps

    def steps(
        self, state: ShardedState, ctx, n_steps: int, *, ensemble: str = "nve",
        dt: float = 0.001, temperature: float = 300.0, pressure: float = 0.0,
        tdamp: float = 0.1, pdamp: float = 1.0, refresh: bool = False,
    ):
        """`n_steps` integrator steps with the block context of
        :meth:`rebuild`. Returns (state, stale): `stale` a device bool, the
        same on every rank. No host read; under NCCL no host wait either.
        `refresh` recomputes the incoming forces (and virial) first."""
        if ensemble not in SHARDED_ENSEMBLES:
            raise ValueError(f"unknown sharded ensemble {ensemble!r}; one of {SHARDED_ENSEMBLES}")
        comm, model = self.comm, self.model
        swl, consts, sels = ctx["swl"], ctx["consts"], ctx["sels"]
        aniso = ensemble in ("npt-aniso", "npt-tri")
        couple = "tri" if ensemble == "npt-tri" else "aniso"
        thermostat = ensemble in ("nvt", "npt") or aniso
        cv = self.compute_virial or ensemble.startswith("npt")
        half = 0.5 * dt * units.FTM2A
        pos, vel, f, cell = state.positions, state.velocities, state.forces, state.cell
        vir, th = state.virial, state.thermo
        real = state.real
        mass_col = state.masses[:, None]

        def force_eval(pos, cell):
            # the energy is a block-boundary observable (K4 below); the steps
            # run K1, K2 and K3 only
            (ext_pos,) = self._exchange_multi([(pos, 0.0)], sels)
            out = mtp_energy_forces_window(
                model, ext_pos, cell, swl, compute_virial=cv, compute_energy=False, **consts,
            )
            fo = self._giveback_multi(out["forces"], sels)
            return fo, (comm.sum(out["virial"]) if cv else out["virial"])

        ndof = 3.0 * state.n_atoms
        kt = units.KB * temperature
        q1, q2 = ndof * kt * tdamp**2, kt * tdamp**2
        p_ext = pressure / units.EVA3_TO_BAR
        w_b, qb1, qb2 = itg._npt_masses(ndof, kt, tdamp, pdamp)
        # aniso/tri MTK: a symmetric barostat tensor, n_modes thermostatted modes
        n_modes = 6 if couple == "tri" else 3
        qb1_a = n_modes * qb1

        def ke2_of(vel):
            return comm.sum(torch.sum(torch.where(real[:, None], mass_col * vel * vel, 0.0))
                            * units.MVV2E)

        def nhc_half(vel, xi, eta):
            scale, xi, eta = itg._nhc_chain_half(ke2_of(vel), ndof, xi, eta, dt, kt, q1, q2)
            return vel * scale, xi, eta

        def baro_chain_half(bv, bxi, beta):
            scale, bxi, beta = itg._nhc_chain_half(w_b * bv**2, 1.0, bxi, beta, dt, kt, qb1, qb2)
            return bv * scale, bxi, beta

        def omega_dot_half(vel, vir, cell, bv):
            return itg.mtk_iso_omega_half(
                bv, vol=cell_volume(cell), w_tr=vir[0] + vir[1] + vir[2], ke2=ke2_of(vel),
                dt=dt, ndof=ndof, p_ext=p_ext, w_b=w_b,
            )

        # the tensor barostat: the same mtk_* functions as npt_aniso_step,
        # with the kinetic tensor and the kinetic energy summed over ranks
        def baro_chain_half_a(bv6, bxi, beta):
            sumsq = torch.sum(bv6[:3] * bv6[:3]) + 2.0 * torch.sum(bv6[3:] * bv6[3:])
            scale, bxi, beta = itg._nhc_chain_half(w_b * sumsq, n_modes, bxi, beta, dt, kt,
                                                   qb1_a, qb2)
            return bv6 * scale, bxi, beta

        def omega_dot_half_a(vel, vir, cell, bv6):
            bv = itg.mtk_aniso_omega_half(
                itg._voigt_to_tensor(bv6), mvv=comm.sum(itg.mtk_ke_tensor(vel, mass_col, real)),
                vir6=vir, vol=cell_volume(cell), ke2=ke2_of(vel), dt=dt, ndof=ndof,
                p_ext=p_ext, w_b=w_b, couple=couple,
            )
            return itg._tensor_to_voigt(bv)

        def v_press_half_a(vel, bv6):
            return itg._xm3(vel, itg.mtk_aniso_vscale(itg._voigt_to_tensor(bv6), dt, ndof))

        # Verlet staleness (the single-device rule: the two largest
        # non-affine displacements over DISTINCT atoms plus the shrink
        # term). Each step keeps this rank's top two; the global top two
        # over ranks are taken once, at the end of the block.
        inv_ref = inverse_cell(cell)
        ref_frac = cell_product(pos.unbind(-1), inv_ref)
        ref_widths = plane_spacings(inv_ref)

        def geometry(cell):
            shrink = torch.clamp(1.0 - torch.min(plane_spacings(inverse_cell(cell)) / ref_widths),
                                 min=0.0) * self.w_cut
            return torch.stack(cell_product(ref_frac, cell), dim=-1), shrink

        scaled_ref, shrink = geometry(cell)
        tops, shrinks = [], []

        if refresh:
            f, vir = force_eval(pos, cell)
        for _ in range(n_steps):
            xi, eta, bxi, beta = th[0:2], th[2:4], th[4:6], th[6:8]
            bv, bv6 = th[8], th[8:14]
            if thermostat:
                vel, xi, eta = nhc_half(vel, xi, eta)
            if ensemble == "npt":
                bv, bxi, beta = baro_chain_half(bv, bxi, beta)
                bv = omega_dot_half(vel, vir, cell, bv)
                alpha = itg.mtk_iso_vscale(bv, dt, ndof)
                vel = vel * alpha
            if aniso:
                bv6, bxi, beta = baro_chain_half_a(bv6, bxi, beta)
                bv6 = omega_dot_half_a(vel, vir, cell, bv6)
                vel = v_press_half_a(vel, bv6)
            vel = vel + half * f / mass_col
            if ensemble == "npt":
                s, d = itg.mtk_iso_maps(bv, dt)  # the exact MTK position map
                pos = pos * s + dt * vel * d
                cell = cell * s
            elif aniso:
                e_full, d_mat = itg.mtk_aniso_maps(itg._voigt_to_tensor(bv6), dt)
                pos = itg._xm3(pos, e_full) + dt * itg._xm3(vel, d_mat)
                cell = itg._mm3(cell, e_full)
            else:
                pos = pos + dt * vel
            f, vir = force_eval(pos, cell)
            vel = vel + half * f / mass_col
            if ensemble == "npt":
                vel = vel * alpha
                bv = omega_dot_half(vel, vir, cell, bv)
                bv, bxi, beta = baro_chain_half(bv, bxi, beta)
            if aniso:
                vel = v_press_half_a(vel, bv6)
                bv6 = omega_dot_half_a(vel, vir, cell, bv6)
                bv6, bxi, beta = baro_chain_half_a(bv6, bxi, beta)
            if thermostat:
                vel, xi, eta = nhc_half(vel, xi, eta)
            if aniso:
                th = torch.cat([xi, eta, bxi, beta, bv6])
            elif thermostat:
                th = torch.cat([xi, eta, bxi, beta, bv[None], th[9:]])
            if ensemble.startswith("npt"):
                scaled_ref, shrink = geometry(cell)
            tops.append(verlet_top2(pos, scaled_ref, real))
            shrinks.append(shrink)
        stale = torch.zeros((), dtype=torch.bool, device=pos.device)
        if tops:
            stale = self._stale(torch.stack(tops), torch.stack(shrinks))
        # block-boundary energy (K4)
        (ext_pos,) = self._exchange_multi([(pos, 0.0)], sels)
        pe = comm.sum(mtp_energy_window(model, ext_pos, cell, swl, **consts))
        state = dataclasses.replace(state, positions=pos, velocities=vel, forces=f, cell=cell,
                                    potential_energy=pe, virial=vir, thermo=th)
        return state, stale

    def _stale(self, tops, shrink):
        """The staleness flag of a block from each step's local top two
        (k, 2) and the shrink term (k,): the global max g1 over ranks; the
        global second g2 is g1 itself if two ranks tie at g1, else the max
        of each rank's runner-up candidate (its own second if it holds g1,
        its first otherwise) — the rule of the JAX package's
        ``sharded_window.py:536-543``, for all steps in one message."""
        every = self.comm.all_gather(tops)  # (W, k, 2)
        m1, m2 = every[..., 0], every[..., 1]
        g1 = torch.amax(m1, dim=0)
        at_max = m1 == g1
        cand = torch.where(at_max, m2, m1)
        g2 = torch.where(torch.sum(at_max, dim=0) > 1, g1, torch.amax(cand, dim=0))
        return torch.any(torch.sqrt(g1) + torch.sqrt(g2) + shrink > self.skin)

    # ------------------------------------------------------- grade eval

    def grade_eval(self, state: ShardedState, ctx):
        """Extrapolation grades and refreshed forces, energy and virial in
        one pass (K1, K5, K3 on each rank's extended set), reusing the
        block's context: no second rebuild. Valid while the block's Verlet
        guarantee holds (an unflagged segment gives it).

        Returns dict(forces (C, 3), energy, virial (6,), max_grade (0-d,
        the same on every rank), grades (C,): this rank's own-slot grades,
        zeros in configuration mode)."""
        model = self.model
        if model.inverse_active_set is None:
            raise ValueError(
                "model has no MVS selection state; load a .mtp with an MVS trailer or build "
                "one with mtp_tpu_torch.al.maxvol.build_mvs"
            )
        comm = self.comm
        swl, sels = ctx["swl"], ctx["sels"]
        (ext_pos,) = self._exchange_multi([(state.positions, 0.0)], sels)
        out = candidates_and_forces_window(model, ext_pos, state.cell, swl, **ctx["consts"])
        fo = self._giveback_multi(out["forces"], sels)
        pe = comm.sum(out["energy"])  # ghost centers are masked: own rows only
        # own-centered pairs tally their half-shares here, the rest at the
        # neighbor's owner; the sum over ranks completes the virial
        vir = comm.sum(out["virial"])
        own_s = ctx["own"][swl.order]
        b = out["b"] * own_s[:, None].to(out["b"].dtype)  # candidates of OWN centers
        inv_a = model.inverse_active_set
        C = self.capacity
        if model.configuration_mode:
            g = cfg_grade(comm.sum(torch.sum(b, dim=0))[None], inv_a, state.n_atoms)
            grades = torch.zeros(C, dtype=inv_a.dtype, device=b.device)
        else:
            gs = torch.where(own_s, nbh_grades(b, inv_a), 0.0)
            grades = gs[swl.inv_order][:C]
            g = comm.max(torch.max(grades))
        return dict(forces=fo, energy=pe, virial=vir, max_grade=g, grades=grades)

    # ------------------------------------------------------------- runs

    def _segment(self, state: ShardedState, n_steps: int, *, refresh: bool, **kw):
        """(rebuild, steps) per Verlet block for `n_steps` steps, queued with
        no host read: the one loop of :meth:`run_async`, :meth:`run` and the
        sharded AL driver. Only the first block refreshes, if `refresh`;
        `kw` go to :meth:`steps`. Returns (state, ctx, flags): the last
        block's context and the five flags of :class:`ShardedRunFlags`
        OR-ed on the device into one (5,) bool tensor."""
        flags = torch.zeros(5, dtype=torch.bool, device=state.positions.device)
        ctx = None
        for first in range(0, n_steps, self.steps_per_rebuild):
            state, ctx, f4 = self.rebuild(state)
            state, stale = self.steps(state, ctx, min(self.steps_per_rebuild, n_steps - first),
                                      refresh=refresh and first == 0, **kw)
            flags = flags | torch.stack([*f4, stale])
        return state, ctx, flags

    def run_async(
        self, state: ShardedState, n_steps: int, *, ensemble: str = "nve", dt: float = 0.001,
        temperature: float = 300.0, pressure: float = 0.0, tdamp: float = 0.1,
        pdamp: float = 1.0, refresh: bool = True,
    ):
        """Throughput path: one :meth:`_segment`; the flags come back as
        :class:`ShardedRunFlags` (reading one waits for the device). A
        tripped run is flagged, never silently wrong: :meth:`run` recovers."""
        state, _, flags = self._segment(state, n_steps, refresh=refresh, ensemble=ensemble,
                                        dt=dt, temperature=temperature, pressure=pressure,
                                        tdamp=tdamp, pdamp=pdamp)
        return state, ShardedRunFlags(*flags.unbind())

    def _recover(self, flags, cell=None) -> str:
        """Recovery policy for a tripped block (the single-device
        ``Simulation.run`` contract, extended to the sharded flags). Returns
        what it changed; raises where no lever is left."""
        nbr, halo, mig, esc, _stale = (bool(f) for f in flags)
        if nbr and cell is not None:
            # the neighbor flag covers the bin GEOMETRY too: under NPT the box
            # shrinks below the static grid's bins. Re-grid first; no J fixes
            # geometry.
            widths = perpendicular_widths(cell)
            if (widths < 2.0 * self.w_cut).any():
                raise RuntimeError(
                    f"cell widths {widths} shrank below 2 x (cutoff + skin) = "
                    f"{2.0 * self.w_cut}: the minimum image cannot cover the box"
                )
            ng = grid_shape(np.asarray(cell), self.w_cut)
            if ng != tuple(self.grid):
                self.grid = ng
                self._reconfigure()
                return f"grid -> {ng} (cell changed)"
        if nbr:
            self.max_neighbors = grown_width(self.max_neighbors)
            self._reconfigure()
            return f"max_neighbors -> {self.max_neighbors}"
        if halo:
            if self.halo_capacity is None:
                # already maximal: the flag is the geometric check, a domain
                # thinner than 2 x (cutoff + skin), which no capacity fixes
                raise RuntimeError(
                    "halo overflow with maximal halo capacity: a domain is thinner than "
                    "2*(cutoff+skin). Use fewer ranks along that axis (at most "
                    "box_width/(cutoff+skin))."
                )
            self.halo_capacity = None
            self._reconfigure()
            return f"halo_capacity -> max ({[st['H'] for st in self.stages]})"
        if mig:
            if self.E >= self.capacity:
                raise RuntimeError(
                    "migration overflow with maximal buffers: a domain's population exceeds "
                    f"its capacity ({self.capacity}). Repartition with more headroom."
                )
            self.migrate_capacity = min(self.capacity, 2 * self.E + 8)
            self._reconfigure()
            return f"migrate_capacity -> {self.migrate_capacity}"
        # escape (two domain boundaries crossed in one block) and staleness
        # both shrink with the block length
        kind = "escape" if esc else "staleness"
        if self.steps_per_rebuild <= 1:
            raise RuntimeError(
                f"{kind} at steps_per_rebuild=1: an atom moved too far in a single step. The "
                "system is diverging, the skin is too small, or the domains are too thin: "
                "check dt/forces or increase skin/capacity."
            )
        self.steps_per_rebuild //= 2
        return f"steps_per_rebuild -> {self.steps_per_rebuild}"

    def run(
        self, state: ShardedState, n_steps: int, *, ensemble: str = "nve", dt: float = 0.001,
        temperature: float = 300.0, pressure: float = 0.0, tdamp: float = 0.1,
        pdamp: float = 1.0, refresh: bool = True, observer=None,
    ):
        """Run `n_steps` with recovery: one one-block :meth:`_segment`, then
        one read of its five flags (and the cell), per block; a tripped
        block is DISCARDED and retried after :meth:`_recover`. Every rank
        reads the same flags, so every rank takes the same branch. Returns
        (state, clear flags); raises where no recovery can help.

        `observer(state)` runs after every committed block, on every rank."""
        done = 0
        while done < n_steps:
            k = min(self.steps_per_rebuild, n_steps - done)
            # a retried first block refreshes again; a later one starts from
            # the forces of the last committed block
            new_state, _, flags = self._segment(
                state, k, refresh=refresh and done == 0, ensemble=ensemble, dt=dt,
                temperature=temperature, pressure=pressure, tdamp=tdamp, pdamp=pdamp,
            )
            flags = flags.tolist()
            if any(flags):
                self._recover(flags, cell=state.cell.detach().cpu().numpy())
                continue
            state = new_state
            done += k
            if observer is not None:
                observer(state)
        zero = torch.zeros((), dtype=torch.bool, device=state.positions.device)
        return state, ShardedRunFlags(zero, zero, zero, zero, zero)
