"""Carry a ``mtp_tpu`` model's weights into the port.

The conversion reads the JAX model's arrays through ``numpy.asarray``, so this
module imports no ``jax``: the tests pass one model to both packages and hold
them to computing the same thing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mtp_tpu_torch.models.mtp import MTPModel
from mtp_tpu_torch.ops.moments import MTPSchedule


def model_from_jax(jax_model, device="cuda", dtype=torch.float64) -> MTPModel:
    """The port's :class:`MTPModel` holding a ``mtp_tpu.MTPModel``'s schedule,
    coefficients and active-learning selection state, on `device` in `dtype`."""
    s = jax_model.schedule
    sched = MTPSchedule(
        **{f.name: getattr(s, f.name) for f in dataclasses.fields(MTPSchedule)}
    )
    c = jax_model.coeffs
    inv = jax_model.inverse_active_set
    return MTPModel.from_arrays(
        sched,
        np.asarray(c.radial_coeffs),
        np.asarray(c.species_coeffs),
        np.asarray(c.moment_coeffs),
        device=device,
        dtype=dtype,
        inverse_active_set=None if inv is None else np.asarray(inv),
        active_set=jax_model.active_set,
        configuration_mode=jax_model.configuration_mode,
    )
