"""LAMMPS data-file I/O (atom_style atomic): a NumPy copy of
``mtp_tpu/io/lammps_data.py`` (the port imports nothing of the JAX package).

The reference runs inside LAMMPS, so system setup arrives via LAMMPS's own
`read_data` (or lattice/create_atoms script commands — README.md:124-147).
This framework owns the host engine (SURVEY §2.2), so migrating users need
the same entry point for their existing boxes: this module reads and writes
the LAMMPS data format for atomic-style systems — header counts, (possibly
triclinic) box bounds with tilt factors, Masses, Atoms (with optional image
flags), Velocities.

Conventions on read:
* positions are shifted so the box origin (xlo, ylo, zlo) is at 0 and
  unwrapped by image flags when present (LAMMPS semantics; the neighbor
  list builds wrap internally, so unwrapped coordinates are valid MD input).
* types are converted to 0-indexed (LAMMPS is 1-indexed).
* the cell is returned as the row-vector matrix
  [[xhi-xlo, 0, 0], [xy, yhi-ylo, 0], [xz, yz, zhi-zlo]] — LAMMPS's
  restricted-triclinic frame, the same convention io/cfg_file.py emits.

Velocities are in LAMMPS metal units (A/ps) = the framework's native units.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LammpsData:
    """Contents of a LAMMPS data file (atomic style)."""

    positions: np.ndarray  # (N, 3) f64, origin-shifted, image-unwrapped
    types: np.ndarray  # (N,) int32, 0-indexed
    masses: np.ndarray  # (N,) f64 per-atom (expanded from per-type Masses)
    cell: np.ndarray  # (3, 3) f64 row-vector lower-triangular
    velocities: np.ndarray | None = None  # (N, 3) f64, A/ps
    type_masses: np.ndarray | None = None  # (T,) f64 per-type


_SECTIONS = {
    "Masses",
    "Atoms",
    "Velocities",
    # recognized-but-unsupported sections raise with a clear message
    "Bonds",
    "Angles",
    "Dihedrals",
    "Impropers",
    "Pair Coeffs",
    "PairIJ Coeffs",
    "Bond Coeffs",
    "Atom Type Labels",
    "Ellipsoids",
}


def _strip(line: str) -> str:
    """Drop trailing comments and whitespace (handles CRLF)."""
    i = line.find("#")
    if i >= 0:
        line = line[:i]
    return line.strip()


def _section_name(line: str) -> str | None:
    s = _strip(line)
    if not s:
        return None
    for name in _SECTIONS:
        if s == name or s.startswith(name + " "):
            return name
    return None


def read_lammps_data(path: str) -> LammpsData:
    """Parse a LAMMPS data file (atom_style atomic).

    Accepts the header lines this style can carry (atoms / atom types /
    bounds / tilt); any topology counts must be zero. Sections other than
    Masses / Atoms / Velocities are rejected with a clear error.
    """
    with open(path, "r") as f:
        lines = f.read().splitlines()
    if not lines:
        raise ValueError(f"{path}: empty data file")

    n_atoms = None
    n_types = None
    lo = np.zeros(3)
    hi = np.zeros(3)
    have_bounds = [False, False, False]
    tilt = np.zeros(3)  # xy, xz, yz

    # ---- header: everything up to the first section keyword
    i = 1  # line 0 is a free-form comment
    while i < len(lines):
        if _section_name(lines[i]) is not None:
            break
        s = _strip(lines[i])
        i += 1
        if not s:
            continue
        toks = s.split()
        if len(toks) >= 2 and toks[1] == "atoms":
            n_atoms = int(toks[0])
        elif len(toks) >= 3 and toks[1] == "atom" and toks[2] == "types":
            n_types = int(toks[0])
        elif len(toks) == 4 and toks[2:] == ["xlo", "xhi"]:
            lo[0], hi[0] = float(toks[0]), float(toks[1])
            have_bounds[0] = True
        elif len(toks) == 4 and toks[2:] == ["ylo", "yhi"]:
            lo[1], hi[1] = float(toks[0]), float(toks[1])
            have_bounds[1] = True
        elif len(toks) == 4 and toks[2:] == ["zlo", "zhi"]:
            lo[2], hi[2] = float(toks[0]), float(toks[1])
            have_bounds[2] = True
        elif len(toks) == 6 and toks[3:] == ["xy", "xz", "yz"]:
            tilt[:] = [float(toks[0]), float(toks[1]), float(toks[2])]
        elif len(toks) >= 2 and toks[1] in (
            "bonds", "angles", "dihedrals", "impropers",
        ):
            if int(toks[0]) != 0:
                raise ValueError(
                    f"{path}: {toks[0]} {toks[1]} — topology is not "
                    "supported (atom_style atomic only)"
                )
        elif len(toks) >= 3 and toks[2] == "types" and toks[1] in (
            "bond", "angle", "dihedral", "improper",
        ):
            if int(toks[0]) != 0:
                raise ValueError(
                    f"{path}: nonzero {toks[1]} types — atomic style only"
                )
        # unknown header lines are ignored (LAMMPS tolerates extras)

    if n_atoms is None or n_types is None:
        raise ValueError(f"{path}: header missing 'atoms' or 'atom types'")
    if not all(have_bounds):
        raise ValueError(f"{path}: header missing box bounds")

    cell = np.array(
        [
            [hi[0] - lo[0], 0.0, 0.0],
            [tilt[0], hi[1] - lo[1], 0.0],
            [tilt[1], tilt[2], hi[2] - lo[2]],
        ]
    )

    type_masses = np.zeros(n_types)
    have_masses = False
    positions = np.zeros((n_atoms, 3))
    types = np.zeros(n_atoms, np.int32)
    images = np.zeros((n_atoms, 3), np.int64)
    seen = np.zeros(n_atoms, bool)
    velocities = None

    def body_lines(start: int, count: int):
        """Yield `count` non-blank data lines beginning after a section
        keyword (one mandatory blank line follows the keyword)."""
        j = start
        got = 0
        while j < len(lines) and got < count:
            s = _strip(lines[j])
            j += 1
            if not s:
                continue
            got += 1
            yield s
        if got < count:
            raise ValueError(f"{path}: section truncated ({got}/{count} rows)")
        return

    # ---- sections
    while i < len(lines):
        name = _section_name(lines[i])
        if name is None:
            if _strip(lines[i]):
                raise ValueError(f"{path}: unexpected line {i+1}: {lines[i]!r}")
            i += 1
            continue
        i += 1
        if name == "Masses":
            count = n_types
            for s in body_lines(i, count):
                toks = s.split()
                t = int(toks[0])
                if not (1 <= t <= n_types):
                    raise ValueError(f"{path}: mass row for bad type {t}")
                type_masses[t - 1] = float(toks[1])
            have_masses = True
        elif name == "Atoms":
            count = n_atoms
            for s in body_lines(i, count):
                toks = s.split()
                if len(toks) not in (5, 8):
                    raise ValueError(
                        f"{path}: Atoms row has {len(toks)} fields — "
                        "expected 'id type x y z [ix iy iz]' (atomic style)"
                    )
                a = int(toks[0]) - 1
                if not (0 <= a < n_atoms) or seen[a]:
                    raise ValueError(f"{path}: bad/duplicate atom id {toks[0]}")
                seen[a] = True
                t = int(toks[1])
                if not (1 <= t <= n_types):
                    raise ValueError(f"{path}: atom {toks[0]} has bad type {t}")
                types[a] = t - 1
                positions[a] = [float(toks[2]), float(toks[3]), float(toks[4])]
                if len(toks) == 8:
                    images[a] = [int(toks[5]), int(toks[6]), int(toks[7])]
        elif name == "Velocities":
            count = n_atoms
            velocities = np.zeros((n_atoms, 3))
            for s in body_lines(i, count):
                toks = s.split()
                a = int(toks[0]) - 1
                if not (0 <= a < n_atoms):
                    raise ValueError(f"{path}: velocity row for bad id {toks[0]}")
                velocities[a] = [float(toks[1]), float(toks[2]), float(toks[3])]
        else:
            raise ValueError(
                f"{path}: section '{name}' is not supported "
                "(atom_style atomic: Masses / Atoms / Velocities)"
            )
        # advance past the rows just consumed
        remaining = count
        while i < len(lines) and remaining > 0:
            if _strip(lines[i]):
                remaining -= 1
            i += 1

    if not seen.all():
        raise ValueError(f"{path}: Atoms section missing or incomplete")
    if not have_masses:
        raise ValueError(f"{path}: Masses section missing")

    # origin shift + image unwrap (row-vector cell: image i adds i @ cell)
    positions = positions - lo[None, :] + images.astype(np.float64) @ cell
    return LammpsData(
        positions=positions,
        types=types,
        masses=type_masses[types],
        cell=cell,
        velocities=velocities,
        type_masses=type_masses,
    )


def write_lammps_data(
    path: str,
    positions,
    types,
    masses,
    cell,
    *,
    velocities=None,
    comment: str = "written by mtp_tpu",
) -> None:
    """Write a LAMMPS data file (atom_style atomic).

    `types` 0-indexed; `masses` per-atom (must be consistent within each
    type). `cell` must be lower-triangular row-vector (the LAMMPS
    restricted-triclinic frame) — rotate a general cell with
    io/cfg_file.lammps_lower_triangular first.
    """
    positions = np.asarray(positions, np.float64)
    types = np.asarray(types)
    masses = np.asarray(masses, np.float64)
    cell = np.asarray(cell, np.float64)
    n = len(positions)
    if abs(cell[0, 1]) + abs(cell[0, 2]) + abs(cell[1, 2]) > 1e-10:
        raise ValueError(
            "cell must be lower-triangular (LAMMPS frame); rotate with "
            "io.cfg_file.lammps_lower_triangular first"
        )
    n_types = int(types.max()) + 1 if n else 0
    type_masses = np.zeros(n_types)
    for t in range(n_types):
        mt = masses[types == t]
        if len(mt) == 0:
            raise ValueError(f"type {t} has no atoms — renumber types densely")
        if np.ptp(mt) > 1e-10:
            raise ValueError(f"type {t} has inconsistent per-atom masses")
        type_masses[t] = mt[0]

    out = [f"# {comment}", ""]
    out.append(f"{n} atoms")
    out.append(f"{n_types} atom types")
    out.append("")
    out.append(f"0.0 {cell[0, 0]:.16g} xlo xhi")
    out.append(f"0.0 {cell[1, 1]:.16g} ylo yhi")
    out.append(f"0.0 {cell[2, 2]:.16g} zlo zhi")
    if abs(cell[1, 0]) + abs(cell[2, 0]) + abs(cell[2, 1]) > 0:
        out.append(f"{cell[1, 0]:.16g} {cell[2, 0]:.16g} {cell[2, 1]:.16g} xy xz yz")
    out.append("")
    out.append("Masses")
    out.append("")
    for t in range(n_types):
        out.append(f"{t + 1} {type_masses[t]:.10g}")
    out.append("")
    out.append("Atoms # atomic")
    out.append("")
    for a in range(n):
        x, y, z = positions[a]
        out.append(f"{a + 1} {int(types[a]) + 1} {x:.16g} {y:.16g} {z:.16g}")
    if velocities is not None:
        velocities = np.asarray(velocities, np.float64)
        out.append("")
        out.append("Velocities")
        out.append("")
        for a in range(n):
            vx, vy, vz = velocities[a]
            out.append(f"{a + 1} {vx:.16g} {vy:.16g} {vz:.16g}")
    out.append("")
    with open(path, "w") as f:
        f.write("\n".join(out))
