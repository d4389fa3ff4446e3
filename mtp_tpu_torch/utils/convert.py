"""Carry a ``mtp_tpu`` model's weights, coefficients alone, and an
integrator's state, into the port.

The conversions read the JAX objects' arrays through ``numpy.asarray``, so
this module imports no ``jax``: the tests pass one model, or one trajectory's
state (single-device or sharded), to both packages and hold them to
computing the same thing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mtp_tpu_torch.md import integrators as itg
from mtp_tpu_torch.models.mtp import MTPCoeffs, MTPModel
from mtp_tpu_torch.ops.moments import MTPSchedule
from mtp_tpu_torch.parallel.sharded_md import ShardedState
from mtp_tpu_torch.utils.device import resolve_device


def _no_narrower(name, a, dtype):
    """`a` as a numpy array, refused if its dtype is narrower than `dtype`:
    widening float32 coefficients would give a float64 model that silently
    computes with float32 weights."""
    a = np.asarray(a)
    if a.dtype.itemsize < torch.empty((), dtype=dtype).element_size():
        raise ValueError(
            f"{name} is {a.dtype}, narrower than the {dtype} asked for; build the "
            "JAX model in that precision (MTPModel.from_data(..., dtype=...))"
        )
    return a


def model_from_jax(jax_model, device="cuda", dtype=torch.float64) -> MTPModel:
    """The port's :class:`MTPModel` holding a ``mtp_tpu.MTPModel``'s schedule,
    coefficients and active-learning selection state, on `device` in `dtype`.
    Raises ``ValueError`` if a coefficient array is narrower than `dtype`."""
    s = jax_model.schedule
    sched = MTPSchedule(
        **{f.name: getattr(s, f.name) for f in dataclasses.fields(MTPSchedule)}
    )
    c = jax_model.coeffs
    inv = jax_model.inverse_active_set
    return MTPModel.from_arrays(
        sched,
        *(_no_narrower(name, getattr(c, name), dtype)
          for name in ("radial_coeffs", "species_coeffs", "moment_coeffs")),
        device=device,
        dtype=dtype,
        inverse_active_set=None if inv is None else np.asarray(inv),
        active_set=jax_model.active_set,
        configuration_mode=jax_model.configuration_mode,
    )


def coeffs_from_jax(coeffs, device="cuda", dtype=torch.float64) -> MTPCoeffs:
    """The port's :class:`MTPCoeffs` holding a ``mtp_tpu`` ``MTPCoeffs``'s
    arrays on `device` in `dtype` (starting points for ``train.fit``).
    Raises ``ValueError`` if an array is narrower than `dtype`."""
    dev = resolve_device(device)
    return MTPCoeffs(*(
        torch.as_tensor(np.array(_no_narrower(name, getattr(coeffs, name), dtype)),
                        dtype=dtype, device=dev)
        for name in ("radial_coeffs", "species_coeffs", "moment_coeffs")
    ))


_AUX_TYPES = {cls.__name__: cls for cls in (itg.NHCAux, itg.NPTAux, itg.NPTAnisoAux)}


def aux_from_jax(aux, device="cuda"):
    """The port's ``NHCAux``/``NPTAux``/``NPTAnisoAux`` holding a
    ``mtp_tpu.md.integrators`` aux state of the same name, leaf for leaf, on
    `device` in the leaves' own dtype, so a JAX trajectory can be continued
    in the port. A JAX ``LangevinAux`` (a ``jax.random`` key) has no
    counterpart: the port draws from a ``torch.Generator``."""
    kind = type(aux).__name__
    if kind not in _AUX_TYPES:
        raise ValueError(f"no port counterpart for a JAX aux of type {kind}")
    dev = resolve_device(device)
    return _AUX_TYPES[kind](*(
        aux_from_jax(leaf, dev) if isinstance(leaf, tuple)
        else torch.as_tensor(np.array(leaf), device=dev)
        for leaf in aux
    ))


def sharded_state_from_jax(sstate, rank: int, world: int, device="cuda", *, axes=(0,)):
    """Rank `rank`'s :class:`~mtp_tpu_torch.parallel.sharded_md.ShardedState`
    of a JAX ``ShardedState`` of `world` shards: the slots ``[rank*C,
    (rank+1)*C)`` of its global arrays and the replicated fields, each in
    its own dtype (ids as int64). The JAX state does not record the cell
    vectors its partition cut along: `axes` gives them (the JAX
    simulation's ``slab_axis``, and ``slab_axis2`` for bricks)."""
    dev = resolve_device(device)
    c = np.asarray(sstate.positions).shape[0] // world
    sl = slice(rank * c, (rank + 1) * c)

    def t(a, dtype=None, rows=True):
        a = np.array(a)
        return torch.as_tensor(a[sl] if rows else a, dtype=dtype, device=dev)

    ids, real = np.asarray(sstate.ids), np.asarray(sstate.real)
    return ShardedState(
        positions=t(sstate.positions), velocities=t(sstate.velocities), forces=t(sstate.forces),
        types=t(sstate.types, torch.int32), masses=t(sstate.masses), real=t(real, torch.bool),
        ids=t(ids, torch.int64), cell=t(sstate.cell, rows=False),
        potential_energy=t(sstate.potential_energy, rows=False),
        virial=t(sstate.virial, rows=False), thermo=t(sstate.thermo, rows=False),
        n_atoms=int(np.sum((ids >= 0) & real)), axes=tuple(axes),
    )
