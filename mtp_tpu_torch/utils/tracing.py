"""Profiler spans at the port's layer boundaries.

    with span("nl.build"):
        ...

:func:`span` opens a ``torch.profiler.record_function`` while a
``torch.profiler`` session records, and nothing otherwise: with no session
it returns one shared no-op context after a single check of the profiler's
state, so the spans cost a run well under a microsecond each. While a
session records, the spans land in its trace beside the CUDA kernels, on the
profiler's one clock, nested as they were opened; the trace ties each device
operation to the launch call that queued it (``correlation``), and so to the
innermost span open at that launch. Nothing is kept or written here: the
session holds the events and exports them when its owner asks.

Span names carry their layer as a prefix:

* ``md.`` the drivers and integrators (``md/simulation.py``,
  ``al/driver.py``): ``md.block``, ``md.steps``, ``md.integrate``,
  ``md.verlet_check``, and the host reads ``md.read_flags`` and
  ``md.read_cell``;
* ``nl.`` the neighbor list (``ops/neighbors.py``): ``nl.build``, holding
  ``nl.sort``, ``nl.rows`` and ``nl.mirror``;
* ``mtp.`` the force closure (``mtp.forces``: K1-K3) and the block's energy
  (``mtp.energy``: K4);
* ``al.`` the grade step: ``al.grade`` (K1, K5, K3 and the grades), and
  ``al.commit`` holding ``al.read_grade`` and ``al.write_cfg``.

This module is the only place in the port that creates spans.
"""

from __future__ import annotations

import contextlib

import torch

# Spans follow the profiler; False keeps them out of a recording session too,
# so that two traced runs, one of each, give what the spans cost when on.
enabled = True

_OFF = contextlib.nullcontext()


def span(name: str, args: str | None = None):
    """A ``record_function`` span named `name` (with `args`, a string) while
    a profiler session records and :data:`enabled` holds; otherwise a
    shared context that does nothing."""
    if enabled and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name, args)
    return _OFF
