"""MLIP-3 ``.cfg`` configuration format: writer + reader.

NumPy copy of ``mtp_tpu/io/cfg_file.py`` (``import mtp_tpu`` pulls in jax, so
the port keeps its own). The writer reproduces the reference's preselected-
configuration stream (PairMTPExtrapolation::write_config,
pair_mtp_extrapolation.cpp:401-479):

    BEGIN_CFG
    Size
    <natoms>
    Supercell
    xx 0 0 / xy yy 0 / xz yz zz        (LAMMPS prd/tilt layout)
    AtomData:  id type cartes_x cartes_y cartes_z [nbh_grades]
    <rows>
    Feature   MV_grade <max grade>
    END_CFG

The reader also parses the optional Energy / PlusStress sections, so MLIP
training sets round-trip. Rows without forces (the selection stream, up to
millions of atoms) go through the native row formatter
(:func:`mtp_tpu_torch.utils.native.format_cfg_atoms`, which writes the same
text in Python on a host with no C++ compiler), as the JAX writer does;
rows with forces are formatted in Python.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Config:
    cell: np.ndarray  # (3,3) row-vector
    positions: np.ndarray  # (n,3)
    types: np.ndarray  # (n,)
    grades: Optional[np.ndarray] = None
    energy: Optional[float] = None
    forces: Optional[np.ndarray] = None
    # (6,) virial*... in MLIP PlusStress order: xx yy zz yz xz xy
    stress: Optional[np.ndarray] = None
    features: dict = dataclasses.field(default_factory=dict)


def lammps_lower_triangular(cell):
    """Rotate a (row-vector) cell into the LAMMPS lower-triangular
    prd/tilt frame: [[xx,0,0],[xy,yy,0],[xz,yz,zz]].

    Returns (L, R) with ``L = cell @ R`` (R orthonormal); rotate positions by
    the same R. The reference's cfg writer emits this layout from LAMMPS's
    domain (pair_mtp_extrapolation.cpp:449-452); MLIP-3 tooling expects it
    for triclinic cells.
    """
    cell = np.asarray(cell, dtype=np.float64)
    a, b, c = cell
    ax = np.linalg.norm(a)
    ah = a / ax
    bx = b @ ah
    by = np.sqrt(max(b @ b - bx * bx, 0.0))
    cx = c @ ah
    yh = (b - bx * ah) / max(by, 1e-300)
    cy = c @ yh
    cz_sq = c @ c - cx * cx - cy * cy
    cz = np.sqrt(max(cz_sq, 0.0))
    L = np.array([[ax, 0.0, 0.0], [bx, by, 0.0], [cx, cy, cz]])
    # R maps the original frame onto (ah, yh, zh)
    zh = np.cross(ah, yh)
    R = np.stack([ah, yh, zh], axis=1)  # columns = new basis
    return L, R


def _atom_rows(positions, types, grades, forces):
    if forces is None:
        # fast path: the native row formatter (million-atom selection streams)
        from mtp_tpu_torch.utils.native import format_cfg_atoms

        return [format_cfg_atoms(positions, types, grades).rstrip("\n")]
    rows = []
    for i in range(len(positions)):
        row = f"{i + 1}\t{int(types[i])}\t{positions[i, 0]:.6f}\t{positions[i, 1]:.6f}\t{positions[i, 2]:.6f}"
        row += f"\t{forces[i, 0]:.6f}\t{forces[i, 1]:.6f}\t{forces[i, 2]:.6f}"
        if grades is not None:
            row += f"\t{float(grades[i]):.5f}"
        rows.append(row)
    return rows


def format_cfg(
    cell,
    positions,
    types,
    *,
    grades=None,
    max_grade: Optional[float] = None,
    energy: Optional[float] = None,
    forces=None,
    stress=None,
) -> str:
    """One BEGIN_CFG block as a string (matching the reference's layout:
    lower-triangular Supercell with positions/forces rotated into that
    frame, pair_mtp_extrapolation.cpp:449-452)."""
    cell = np.asarray(cell, dtype=np.float64)
    positions = np.asarray(positions, dtype=np.float64)
    if forces is not None:
        forces = np.asarray(forces, dtype=np.float64)
    if abs(cell[0, 1]) + abs(cell[0, 2]) + abs(cell[1, 2]) > 1e-12:
        cell, R = lammps_lower_triangular(cell)
        positions = positions @ R
        if forces is not None:
            forces = forces @ R
    n = len(positions)
    out = ["BEGIN_CFG", "Size", f"{n}", "Supercell"]
    for row in cell:
        out.append(f"{row[0]:.6f} {row[1]:.6f} {row[2]:.6f}")
    cols = "id type       cartes_x      cartes_y      cartes_z"
    if forces is not None:
        cols += "           fx          fy          fz"
    if grades is not None:
        cols += "       nbh_grades"
    out.append(f"AtomData:  {cols}")
    out.extend(_atom_rows(positions, types, grades, forces))
    if energy is not None:
        out.append("Energy")
        out.append(f"{energy:.12f}")
    if stress is not None:
        s6 = np.asarray(stress, dtype=np.float64)
        out.append(
            "PlusStress:  xx          yy          zz          yz          xz          xy"
        )
        out.append(" ".join(f"{v:.6f}" for v in s6))
    if max_grade is not None:
        out.append(f"Feature   MV_grade\t{max_grade:.6f}")
    out.append("END_CFG")
    out.append("")
    return "\n".join(out) + "\n"


class CfgWriter:
    """Streaming writer with explicit flush (the flush-before-break contract,
    pair_mtp_extrapolation.cpp:390-396, must hold)."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def write(self, *args, **kwargs):
        self._f.write(format_cfg(*args, **kwargs))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_cfgs(text: str) -> List[Config]:
    """Parse all BEGIN_CFG blocks from a string."""
    configs = []
    lines = iter(text.split("\n"))
    for line in lines:
        if line.strip() != "BEGIN_CFG":
            continue
        cell = None
        positions = types = grades = forces = stress = None
        energy = None
        features = {}
        for line in lines:
            s = line.strip()
            if s == "END_CFG":
                break
            if s == "Size":
                n = int(next(lines).strip())
            elif s.startswith("Supercell"):
                cell = np.array(
                    [[float(v) for v in next(lines).split()] for _ in range(3)]
                )
            elif s.startswith("AtomData"):
                header = s.split(":", 1)[1].split()
                positions = np.zeros((n, 3))
                types = np.zeros(n, dtype=np.int64)
                if "nbh_grades" in header:
                    grades = np.zeros(n)
                if "fx" in header:
                    forces = np.zeros((n, 3))
                col = {name: k for k, name in enumerate(header)}
                for i in range(n):
                    vals = next(lines).split()
                    types[i] = int(vals[col["type"]])
                    positions[i] = [
                        float(vals[col["cartes_x"]]),
                        float(vals[col["cartes_y"]]),
                        float(vals[col["cartes_z"]]),
                    ]
                    if grades is not None:
                        grades[i] = float(vals[col["nbh_grades"]])
                    if forces is not None:
                        forces[i] = [
                            float(vals[col["fx"]]),
                            float(vals[col["fy"]]),
                            float(vals[col["fz"]]),
                        ]
            elif s == "Energy":
                energy = float(next(lines).strip())
            elif s.startswith("PlusStress"):
                stress = np.array([float(v) for v in next(lines).split()])
            elif s.startswith("Feature"):
                parts = s.split()
                if len(parts) >= 3:
                    try:
                        features[parts[1]] = float(parts[2])
                    except ValueError:
                        features[parts[1]] = parts[2]
        configs.append(
            Config(
                cell=cell,
                positions=positions,
                types=types,
                grades=grades,
                energy=energy,
                forces=forces,
                stress=stress,
                features=features,
            )
        )
    return configs


def read_cfgs(path: str) -> List[Config]:
    with open(path) as f:
        return parse_cfgs(f.read())
