"""Observables, trajectory dumps, thermo logging, checkpoint and resume (port
of ``mtp_tpu/md/output.py``).

The reference exposes observables through LAMMPS plumbing (`thermo_style`,
`dump`, `compute pair`); checkpoints are positions/velocities/box only
(`restartinfo = 0`, pair_mtp.cpp:38: model files are immutable inputs).

The port's checkpoint is its own ``np.savez`` file: the state's arrays, the
aux state as named fields (``aux_kind`` names its type; NamedTuple fields
are stored under ``aux.<path>``), and a Langevin generator's state as the
byte array ``torch.Generator.get_state`` gives. Nothing is pickled.
"""

from __future__ import annotations

from typing import IO, Optional, Sequence

import numpy as np
import torch

from mtp_tpu_torch.md import integrators as itg
from mtp_tpu_torch.md.state import (
    MDState,
    kinetic_energy,
    pressure_of,
    temperature_of,
    volume_of,
)
from mtp_tpu_torch.utils.device import resolve_device


class ThermoLogger:
    """Tabular thermo output (the `thermo_style custom ...` analog). Each call
    reads the state to the host."""

    COLUMNS = {
        "step": lambda s, ex: int(s.step),
        "temp": lambda s, ex: float(temperature_of(s)),
        "pe": lambda s, ex: float(s.potential_energy),
        "ke": lambda s, ex: float(kinetic_energy(s)),
        "etotal": lambda s, ex: float(s.potential_energy + kinetic_energy(s)),
        "press": lambda s, ex: float(pressure_of(s)),
        "vol": lambda s, ex: float(volume_of(s)),
        "max_grade": lambda s, ex: ex.get("max_grade", float("nan")),
    }

    def __init__(
        self,
        columns: Sequence[str] = ("step", "temp", "pe", "etotal", "press"),
        every: int = 1,
        stream: Optional[IO] = None,
    ):
        unknown = set(columns) - set(self.COLUMNS)
        if unknown:
            raise ValueError(f"unknown thermo columns: {unknown}")
        self.columns = list(columns)
        self.every = every
        self.stream = stream
        self.history: list[dict] = []
        self._header_done = False

    def __call__(self, state: MDState, **extras):
        if int(state.step) % self.every:
            return
        row = {c: self.COLUMNS[c](state, extras) for c in self.columns}
        self.history.append(row)
        if self.stream is not None:
            if not self._header_done:
                self.stream.write(" ".join(f"{c:>14s}" for c in self.columns) + "\n")
                self._header_done = True
            self.stream.write(
                " ".join(f"{row[c]:14d}" if c == "step" else f"{row[c]:14.6g}"
                         for c in self.columns)
                + "\n"
            )
            self.stream.flush()

    def column(self, name):
        return np.array([r[name] for r in self.history])


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class XYZDumpWriter:
    """Extended-XYZ trajectory writer (the `dump custom` analog); optional
    per-atom arrays (forces, grades) become extra columns."""

    def __init__(self, path: str, species: Optional[Sequence[str]] = None):
        self._f = open(path, "w")
        self.species = species

    def write(self, state: MDState, *, grades=None, forces: bool = False):
        pos, types, cell = _host(state.positions), _host(state.types), _host(state.cell)
        n = len(pos)
        props = "species:S:1:pos:R:3"
        if forces:
            props += ":forces:R:3"
        if grades is not None:
            props += ":nbh_grade:R:1"
            grades = _host(grades) if isinstance(grades, torch.Tensor) else np.asarray(grades)
        lattice = " ".join(f"{v:.8f}" for v in cell.reshape(-1))
        self._f.write(f"{n}\n")
        self._f.write(
            f'Lattice="{lattice}" Properties={props} '
            f"step={int(state.step)} energy={float(state.potential_energy):.8f}\n"
        )
        f_arr = _host(state.forces)
        for i in range(n):
            sp = self.species[types[i]] if self.species is not None else f"T{types[i]}"
            row = f"{sp} {pos[i, 0]:.8f} {pos[i, 1]:.8f} {pos[i, 2]:.8f}"
            if forces:
                row += f" {f_arr[i, 0]:.8f} {f_arr[i, 1]:.8f} {f_arr[i, 2]:.8f}"
            if grades is not None:
                row += f" {float(grades[i]):.6f}"
            self._f.write(row + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_STATE_FIELDS = ("positions", "velocities", "forces", "masses", "types", "cell",
                 "potential_energy", "virial", "step")
_AUX_KINDS = {cls.__name__: cls for cls in (itg.NHCAux, itg.NPTAux, itg.NPTAnisoAux,
                                              itg.LangevinAux)}


def _aux_fields(prefix, aux, out):
    """Flatten a NamedTuple aux into ``{prefix.field: array}``."""
    for name, leaf in zip(aux._fields, aux):
        key = f"{prefix}.{name}"
        if isinstance(leaf, tuple):
            _aux_fields(key, leaf, out)
        elif isinstance(leaf, torch.Generator):
            out[key] = leaf.get_state().numpy()
        else:
            out[key] = _host(leaf)


def _aux_from_fields(cls, prefix, z, cast, device):
    leaves = []
    for name in cls._fields:
        key = f"{prefix}.{name}"
        if cls is itg.LangevinAux:
            g = torch.Generator(device=device)
            g.set_state(torch.from_numpy(np.array(z[key], dtype=np.uint8)))
            leaves.append(g)
        elif cls is not itg.NHCAux and name in ("thermo", "baro_thermo"):
            leaves.append(_aux_from_fields(itg.NHCAux, key, z, cast, device))
        else:
            leaves.append(cast(z[key]))
    return cls(*leaves)


def save_checkpoint(path: str, state: MDState, aux=None) -> None:
    """Checkpoint = dynamical state only (positions/velocities/cell/step and
    the integrator aux). The model is re-read from its .mtp file on resume,
    as the reference's restart contract has it."""
    payload = {name: _host(getattr(state, name)) for name in _STATE_FIELDS}
    if aux is not None:
        kind = type(aux).__name__
        if kind not in _AUX_KINDS:
            raise TypeError(f"cannot checkpoint an aux of type {kind}")
        payload["aux_kind"] = np.asarray(kind)
        _aux_fields("aux", aux, payload)
    np.savez(path, **payload)


def load_checkpoint(path: str, dtype=None, device="cuda"):
    """Returns (MDState, aux or None) on `device`; `dtype` recasts the
    floating-point arrays (default: as saved)."""
    dev = resolve_device(device)

    def cast(a):
        t = torch.from_numpy(np.array(a))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    with np.load(path, allow_pickle=False) as z:
        state = MDState(**{name: cast(z[name]) for name in _STATE_FIELDS})
        aux = None
        if "aux_kind" in z:
            aux = _aux_from_fields(_AUX_KINDS[str(z["aux_kind"])], "aux", z, cast, dev)
    return state, aux
