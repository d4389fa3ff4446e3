"""Per-rank state, the halo primitives and the block API of multi-device
MD (port of ``mtp_tpu/parallel/sharded_md.py``).

The JAX package holds global ``(nd*C, ...)`` arrays sharded over a mesh and
runs the shards in one program. The port runs one process per rank, so a
:class:`ShardedState` holds ONE rank's ``(C, ...)`` slots; the primitives
below are that rank's side of the exchange, and :class:`~mtp_tpu_torch.
parallel.comm.Comm` carries the messages:

* atom migration (the LAMMPS exchange at reneighbor): slab leavers are
  compacted into fixed (E,) buffers, shifted to the adjacent rank and merged
  into its free slots, with the escape and overflow flags;
* face-shell halo selection: only atoms within cutoff + skin of a face are
  shipped;
* the ring exchange ``own (C, ...) -> [own | from-left (H) | from-right
  (H)]``; along an axis of one rank nothing is sent and no row added.

Every index computation stays on the device with static shapes (no host
read), so a block queues behind the step loop on the card.

The JAX package's XLA row-gather API (:func:`make_sharded_md_block`,
:func:`compute_sharded_forces`, :func:`make_sharded_grades`) is kept, with
`comm` in place of the mesh, on the port's one sharded engine,
:class:`~mtp_tpu_torch.parallel.sharded_window.ShardedSimulation` (K1-K5 on
the card). The JAX package needs that second path for boxes of fewer than 3
bins across, which its window worklists cannot cover; the port's cell list
visits every bin of such an axis, so its window engine takes every grid.
Its TPU knobs ``backend`` and ``remat`` have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mtp_tpu_torch.utils.device import resolve_device


class ShardFlags(NamedTuple):
    """Flags of a sharded rebuild (device bools, the same on every rank)."""

    neighbor_overflow: torch.Tensor  # neighbor list / bin capacity or geometry
    halo_overflow: torch.Tensor  # face shell > halo capacity, or (nd == 2)
    # an atom in both face shells
    migrate_overflow: torch.Tensor  # migration buffer / free slots exceeded
    escape: torch.Tensor  # an atom jumped PAST the adjacent domain in one block


@dataclasses.dataclass
class ShardedState:
    """One rank's slots (C, ...) and the replicated fields.

    `ids` (int64, -1 = padding) migrate with the atoms, so gathers stay valid
    after re-homing. `cell`, `potential_energy`, `virial` (6,) and `thermo`
    (14,) are the same on every rank: ``thermo`` = [particle NHC xi (2) |
    eta (2) | barostat NHC xi (2) | eta (2) | barostat strain rate: scalar at
    [8] (iso MTK) or Voigt-6 at [8:14] (aniso/tri MTK)]. `n_atoms` is the
    global atom count (migration preserves it). `axes` are the cell vectors
    the partition cut along, one per axis of the rank grid: migration and
    halo selection run along them."""

    positions: torch.Tensor
    velocities: torch.Tensor
    forces: torch.Tensor
    types: torch.Tensor
    masses: torch.Tensor
    real: torch.Tensor
    ids: torch.Tensor
    cell: torch.Tensor
    potential_energy: torch.Tensor
    virial: torch.Tensor
    thermo: torch.Tensor
    n_atoms: int
    axes: tuple

    @classmethod
    def from_partition(cls, part, cell, rank: int, *, dtype=torch.float32, device="cuda"):
        """Rank `rank`'s slots ``[rank*C, (rank+1)*C)`` of a
        :class:`~mtp_tpu_torch.parallel.domain.SlabPartition`."""
        dev = resolve_device(device)
        sl = slice(rank * part.capacity, (rank + 1) * part.capacity)

        def f(a, dt=dtype):
            return torch.as_tensor(np.array(a[sl]), dtype=dt, device=dev)

        pos = f(part.positions)
        return cls(
            positions=pos,
            velocities=f(part.velocities),
            forces=torch.zeros_like(pos),
            types=f(part.types, torch.int32),
            masses=f(part.masses),
            real=f(part.real, torch.bool),
            ids=f(part.original_index, torch.int64),
            cell=torch.as_tensor(np.array(cell), dtype=dtype, device=dev),
            potential_energy=torch.zeros((), dtype=dtype, device=dev),
            virial=torch.zeros(6, dtype=dtype, device=dev),
            thermo=torch.zeros(14, dtype=dtype, device=dev),
            n_atoms=part.n_atoms,
            axes=part.axes,
        )

    def gather(self, arr, comm, *, root: int | None = None):
        """A per-slot array of this rank, collected from every rank into the
        original atom order, as numpy (n_atoms, ...). A collective: every rank
        calls it; with `root` only that rank gets the array (others None)."""
        return self.gather_all([arr], comm, root=root)[0]

    def gather_all(self, arrs, comm, *, root: int | None = None):
        """:meth:`gather` of several per-slot arrays, the ids gathered once."""
        ids = comm.all_gather(self.ids).cpu().numpy().reshape(-1)
        real = comm.all_gather(self.real).cpu().numpy().reshape(-1)
        vals = [comm.all_gather(torch.as_tensor(a, device=self.ids.device)).cpu().numpy()
                for a in arrs]
        if root is not None and comm.rank != root:
            return [None] * len(arrs)
        m = (ids >= 0) & real
        out = []
        for v in vals:
            v = v.reshape((-1,) + v.shape[2:])
            o = np.zeros((self.n_atoms,) + v.shape[1:], v.dtype)
            o[ids[m]] = v[m]
            out.append(o)
        return out


def _compact(mask, k: int):
    """Indices of up to k True entries of a 1-D mask, in ascending order,
    compacted to the front. Returns (take (k,) int64, valid (k,) bool,
    overflow ()). Entries past the count are 0 and not valid; a scatter of
    the running count, no sort."""
    m = mask.shape[0]
    dev = mask.device
    rank = torch.cumsum(mask, 0) - 1
    dst = torch.where(mask & (rank < k), rank, k)  # k: a trash slot, sliced off
    take = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    take = take.scatter(0, dst, torch.arange(m, device=dev))[:k]
    count = torch.sum(mask)
    return take, torch.arange(k, device=dev) < count, count > k


def _put(arr, dst, sel, vals):
    """``arr[dst[sel]] = vals[sel]``, with no host read: rows not selected
    write into one trash row past the end, so every kept write is unique."""
    ext = torch.cat([arr, arr[:1]])
    n = arr.shape[0]
    ext[torch.where(sel, dst, n)] = vals
    return ext[:n]


def frac_along(pos, inv_cell, slab_axis: int):
    """Wrapped fractional coordinate along cell vector `slab_axis`."""
    f = (pos[:, 0] * inv_cell[0, slab_axis] + pos[:, 1] * inv_cell[1, slab_axis]
         + pos[:, 2] * inv_cell[2, slab_axis])
    return f - torch.floor(f)


def plane_spacings(inv_cell):
    """Perpendicular widths 1 / |inv[:, a]| (column norms: the plane
    spacings; the JAX package's row norms are wrong for a tilted cell)."""
    return 1.0 / torch.linalg.vector_norm(inv_cell, dim=0)


def migrate(fields, inv_cell, comm, stage, E: int):
    """Re-home atoms whose domain along `stage`'s axis changed.

    `fields` = (pos, vel, f, types, masses, real, ids); forces migrate with
    the atom. Returns (fields, (migrate_overflow, escape)) as device bools."""
    pos, vel, f, types, masses, real, ids = fields
    dev = pos.device
    zero = torch.zeros((), dtype=torch.bool, device=dev)
    nd, axis = stage["nd"], stage["axis"]
    if nd == 1:
        return fields, (zero, zero)
    s = comm.coords[axis]
    fa = frac_along(pos, inv_cell, stage["slab_axis"])
    dest = torch.clamp((fa * nd).long(), 0, nd - 1)
    dest = torch.where(real, dest, s)
    stay = dest == s
    if nd == 2:
        go_r = real & ~stay
        go_l = torch.zeros_like(go_r)
        escape = zero
    else:
        go_r = real & (dest == (s + 1) % nd)
        go_l = real & (dest == (s - 1) % nd)
        escape = torch.any(real & ~stay & ~go_r & ~go_l)

    def pack(go):
        take, valid, ovf = _compact(go, E)
        pf = torch.cat([pos[take], vel[take], f[take], masses[take][:, None]], dim=1)
        pi = torch.stack([types[take].long(), ids[take], valid.long()], dim=1)
        return pf, pi, ovf

    pf_r, pi_r, ovf_r = pack(go_r)
    items = [(pf_r, +1), (pi_r, +1)]
    ovf = ovf_r
    if nd > 2:
        pf_l, pi_l, ovf_l = pack(go_l)
        items += [(pf_l, -1), (pi_l, -1)]
        ovf = ovf | ovf_l
    got = comm.shifts(items, axis)
    inc_pf = torch.cat(got[0::2])
    inc_pi = torch.cat(got[1::2])
    k_in = inc_pf.shape[0]

    gone = go_r | go_l
    real = real & ~gone
    ids = torch.where(gone, -1, ids)  # stale ids would corrupt gathers
    tk, valid_in, _ = _compact(inc_pi[:, 2] > 0, k_in)
    inc_pf, inc_pi = inc_pf[tk], inc_pi[tk]
    dst, free_valid, _ = _compact(~real, k_in)
    cap_ovf = torch.any(valid_in & ~free_valid)
    sel = valid_in & free_valid
    pos = _put(pos, dst, sel, inc_pf[:, 0:3])
    vel = _put(vel, dst, sel, inc_pf[:, 3:6])
    f = _put(f, dst, sel, inc_pf[:, 6:9])
    masses = _put(masses, dst, sel, inc_pf[:, 9])
    types = _put(types, dst, sel, inc_pi[:, 0].to(types.dtype))
    ids = _put(ids, dst, sel, inc_pi[:, 1])
    real = _put(real, dst, sel, torch.ones_like(sel))
    return (pos, vel, f, types, masses, real, ids), (ovf | cap_ovf, escape)


def halo_select(pos, real, inv_cell, comm, stage, w_cut: float):
    """Face-shell membership along `stage`'s axis (fixed for a block): the
    real rows within `w_cut` of each face, compacted into H send slots.
    Returns ((sel_r, val_r, sel_l, val_l), halo_overflow)."""
    H, nd = stage["H"], stage["nd"]
    dev = pos.device
    if nd == 1:
        dummy = torch.zeros(H, dtype=torch.int64, device=dev)
        dummyv = torch.zeros(H, dtype=torch.bool, device=dev)
        return (dummy, dummyv, dummy, dummyv), torch.zeros((), dtype=torch.bool, device=dev)
    w_frac = w_cut / plane_spacings(inv_cell)[stage["slab_axis"]]
    s = comm.coords[stage["axis"]]
    fa = frac_along(pos, inv_cell, stage["slab_axis"])
    near_r = real & ((s + 1.0) / nd - fa < w_frac)
    near_l = real & (fa - s / nd < w_frac)
    sel_r, val_r, ovf_r = _compact(near_r, H)
    sel_l, val_l, ovf_l = _compact(near_l, H)
    ovf = ovf_r | ovf_l
    if nd == 2:
        # both faces ship to the SAME rank: an atom in both shells would be
        # counted twice there
        ovf = ovf | torch.any(near_r & near_l)
    return (sel_r, val_r, sel_l, val_l), ovf


def exchange(items, sel, comm, stage):
    """[(own (B, ...), fill), ...] -> [(B + 2H, ...)]: each array extended by
    [from-left | from-right] along `stage`'s axis (of two ranks or more), all
    in one batch of messages. Send slots that are not valid carry `fill`."""
    sel_r, val_r, sel_l, val_l = sel
    sends = []
    for own, fill in items:
        shape = (-1,) + (1,) * (own.ndim - 1)
        sends += [(torch.where(val_r.view(shape), own[sel_r], fill), +1),
                  (torch.where(val_l.view(shape), own[sel_l], fill), -1)]
    got = comm.shifts(sends, stage["axis"])
    return [torch.cat([own, got[2 * i], got[2 * i + 1]]) for i, (own, _) in enumerate(items)]


# ------------------------------------------------ the row-gather path's API


def _engine(model, comm, *, capacity, max_neighbors, grid, skin, halo_capacity,
            migrate_capacity=None, steps_per_rebuild=1, compute_virial=False):
    """The ShardedSimulation behind the block API. `halo_capacity` as
    ShardedSimulation takes it: a tuple per rank-grid axis
    (:func:`~mtp_tpu_torch.parallel.domain.halo_capacities`), or None
    (maximal)."""
    from mtp_tpu_torch.parallel.sharded_window import ShardedSimulation

    return ShardedSimulation(
        model, comm, capacity=capacity, max_neighbors=max_neighbors, grid=tuple(grid),
        skin=skin, steps_per_rebuild=steps_per_rebuild, halo_capacity=halo_capacity,
        migrate_capacity=migrate_capacity, compute_virial=compute_virial,
    )


def _check_axis(state: ShardedState, slab_axis: int) -> None:
    if state.axes[0] != slab_axis:
        raise ValueError(f"the state was partitioned along cell vector {state.axes[0]}, "
                         f"not slab_axis={slab_axis}")


def make_sharded_md_block(
    model, comm, *, capacity: int, max_neighbors: int, grid: tuple, skin: float = 0.5,
    n_steps: int = 10, dt: float = 0.001, ensemble: str = "nve", temperature: float = 300.0,
    tdamp: float = 0.1, halo_capacity=None, migrate_capacity=None, slab_axis: int = 0,
):
    """One multi-device MD block: migration, halo selection, the neighbor
    rebuild, a force refresh and `n_steps` NVE or NHC-NVT steps.

    Returns ``block(state) -> (state, flags)``: every rank calls it with
    its :class:`ShardedState`; `flags` is a
    :class:`~mtp_tpu_torch.parallel.sharded_window.ShardedRunFlags`, the
    four flags of the JAX package's ``ShardFlags`` and the block's Verlet
    staleness, which the JAX block does not check. The state's energy and
    virial are those at the block's end (the virial tallied every step, as
    the JAX block does). `slab_axis` must be the cell vector the state was
    partitioned along; the engine is ``block.sim``."""
    if ensemble not in ("nve", "nvt"):
        raise ValueError(f"sharded block supports nve/nvt, got {ensemble}")
    sim = _engine(model, comm, capacity=capacity, max_neighbors=max_neighbors, grid=grid,
                  skin=skin, halo_capacity=halo_capacity, migrate_capacity=migrate_capacity,
                  steps_per_rebuild=max(n_steps, 1), compute_virial=True)
    from mtp_tpu_torch.parallel.sharded_window import ShardedRunFlags

    def block(state: ShardedState):
        _check_axis(state, slab_axis)
        state, ctx, f4 = sim.rebuild(state)
        state, stale = sim.steps(state, ctx, n_steps, ensemble=ensemble, dt=dt,
                                 temperature=temperature, tdamp=tdamp, refresh=True)
        return state, ShardedRunFlags(*f4, stale)

    block.sim = sim
    return block


def compute_sharded_forces(model, comm, *, capacity: int, max_neighbors: int, grid: tuple,
                           skin: float = 0.0, **kw):
    """One sharded force, energy and virial evaluation: the block of
    :func:`make_sharded_md_block` with no step. ``fn(state) -> (state,
    flags)``; the state's forces, energy and virial are refreshed."""
    return make_sharded_md_block(model, comm, capacity=capacity, max_neighbors=max_neighbors,
                                 grid=grid, skin=skin, n_steps=0, dt=0.0, **kw)


def _values_by_id(values, src: ShardedState, dst: ShardedState, comm):
    """Per-slot `values` of `src`, moved to the slots of `dst` holding the
    same atoms (by id), on every rank: zero on `dst`'s padding slots. A
    collective. Migration re-homes atoms between ranks, so the slots of a
    state before and after a rebuild differ."""
    ids = comm.all_gather(src.ids).reshape(-1)
    real = comm.all_gather(src.real).reshape(-1)
    vals = comm.all_gather(values).reshape((-1,) + tuple(values.shape[1:]))
    n = src.n_atoms
    table = torch.zeros((n + 1,) + tuple(values.shape[1:]), dtype=values.dtype,
                        device=values.device)
    table[torch.where(real & (ids >= 0), ids, n)] = vals
    mine = dst.real & (dst.ids >= 0)
    out = table[torch.where(mine, dst.ids, n)]
    return torch.where(mine.view((-1,) + (1,) * (values.ndim - 1)), out, 0)


def make_sharded_grades(model, comm, *, capacity: int, max_neighbors: int, grid: tuple,
                        halo_capacity=None, slab_axis: int = 0):
    """Multi-device extrapolation grades: every call rebuilds (migration,
    face shells at the cutoff, the neighbor list) and grades through
    :meth:`~mtp_tpu_torch.parallel.sharded_window.ShardedSimulation.grade_eval`
    (K1, K5, K3 on the card); the max over ranks in neighborhood mode, the
    candidate vectors summed over ranks in configuration mode (the
    reference's MPI_Allreduce MAX/SUM, pair_mtp_extrapolation.cpp:363-382).

    Returns ``grades_fn(state) -> (max_grade, grades, flags)``: `grades`
    (C,) per slot of the GIVEN state (carried back by id across the
    rebuild's migration; zero on padding slots and in configuration mode),
    `flags` one device bool, the OR of the rebuild's flags (the same on
    every rank). The JAX package grades in XLA with a halo of the state as
    it stands; the values are the same function."""
    if model.inverse_active_set is None:
        raise ValueError("model has no MVS selection state")
    sim = _engine(model, comm, capacity=capacity, max_neighbors=max_neighbors, grid=grid,
                  skin=0.0, halo_capacity=halo_capacity)

    def grades_fn(state: ShardedState):
        _check_axis(state, slab_axis)
        moved, ctx, f4 = sim.rebuild(state)
        out = sim.grade_eval(moved, ctx)
        grades = out["grades"]
        if not model.configuration_mode:
            grades = _values_by_id(grades, moved, state, comm)
        return out["max_grade"], grades, torch.stack(list(f4)).any()

    grades_fn.sim = sim
    return grades_fn
