"""Everything a run feeds the program, made from ``--seed``.

The same seed gives the same potential, lattice, species, velocities and
active-set boxes; the program and the reference get the same arrays. Each
input draws from its own child stream of ``numpy.random.SeedSequence(seed)``,
so adding an input later moves none of the others.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mdbench import mint

KB = 8.617333262e-5  # eV/K
MVV2E = 1.0364269e-4  # amu (A/ps)^2 -> eV

_STREAMS = ("species", "velocities", "mvs", "potential", "sample", "relax")


def streams(seed: int) -> dict:
    """One independent generator per input, by name."""
    kids = np.random.SeedSequence(int(seed)).spawn(len(_STREAMS))
    return {name: np.random.default_rng(k) for name, k in zip(_STREAMS, kids)}


def lattice(kind: str, a: float, reps):
    """Positions (N, 3) and the cell (3, 3, rows are the cell vectors) of a
    cubic lattice of reps[0] x reps[1] x reps[2] conventional cells."""
    basis = {
        "sc": [(0, 0, 0)],
        "bcc": [(0, 0, 0), (0.5, 0.5, 0.5)],
        "fcc": [(0, 0, 0), (0.5, 0.5, 0), (0.5, 0, 0.5), (0, 0.5, 0.5)],
    }[kind]
    nx, ny, nz = reps
    grid = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
                    axis=-1).reshape(-1, 1, 3)
    pos = ((grid + np.asarray(basis, dtype=np.float64)) * a).reshape(-1, 3)
    return pos, np.diag([nx * a, ny * a, nz * a]).astype(np.float64)


def species(rng, n: int, shares) -> np.ndarray:
    """Types (N,) int32 with exactly round(share * N) atoms of each species
    (the last takes the rest), placed at random."""
    counts = [int(round(s * n)) for s in shares[:-1]]
    counts.append(n - sum(counts))
    types = np.repeat(np.arange(len(shares), dtype=np.int32), counts)
    return types[rng.permutation(n)]


def velocities(rng, masses: np.ndarray, temperature: float) -> np.ndarray:
    """Maxwell-Boltzmann velocities [A/ps] with no net momentum, scaled to
    exactly `temperature` over 3N degrees of freedom."""
    sigma = np.sqrt(KB * temperature / (masses * MVV2E))
    v = rng.standard_normal((len(masses), 3)) * sigma[:, None]
    v -= (masses[:, None] * v).sum(0) / masses.sum()
    t_now = MVV2E * np.sum(masses[:, None] * v * v) / (3 * len(masses) * KB)
    return v * np.sqrt(temperature / t_now)


@dataclasses.dataclass
class Inputs:
    mtp_bytes: bytes  # the potential, as the .mtp file both sides read
    positions: np.ndarray  # (N, 3) float64
    cell: np.ndarray  # (3, 3)
    types: np.ndarray  # (N,) int32
    masses: np.ndarray  # (N,) float64
    velocities: np.ndarray  # (N, 3) float64
    mvs_boxes: list  # [(positions, cell, types)] for the active set, or []
    sample_rng: np.random.Generator  # draws which call the reference follows


def zero_pressure_a(mtp_bytes: bytes, kind: str, a: float, device, types=None) -> float:
    """The lattice constant near `a` at which the perfect lattice has no
    pressure under the potential (0 K, the benchmark's reference model in
    float64 on a 5 x 5 x 5 box with these site `types`, all 0 by default):
    a LAMMPS ``fix box/relax iso 0`` of the perfect crystal, by the secant
    method on P(a)."""
    import torch

    from mdbench.reference.model import ReferenceMTP
    from mdbench.reference.mtp_file import parse_mtp

    model = ReferenceMTP(parse_mtp(mtp_bytes), device)

    def pressure(x):
        pos, cell = lattice(kind, x, (5, 5, 5))
        t = lambda v: torch.as_tensor(v, device=model.device)
        ty = np.zeros(len(pos), dtype=np.int64) if types is None else types
        w = model.evaluate(t(pos), t(ty), t(cell), virial=True)["virial"]
        return float(w[0] + w[1] + w[2]) / (3.0 * np.linalg.det(cell))

    x0, x1 = a, 0.98 * a
    p0, p1 = pressure(x0), pressure(x1)
    for _ in range(20):
        if abs(x1 - x0) < 1e-7 * a:
            break
        x0, x1, p0 = x1, x1 - p1 * (x1 - x0) / (p1 - p0), p1
        p1 = pressure(x1)
    return x1


def make(config: dict, traffic: dict, seed: int, device="cpu") -> Inputs:
    """The inputs of one run of a cell (module docstring). A lattice with
    ``"relax": "zero_pressure"`` takes the potential's zero-pressure
    constant (:func:`zero_pressure_a`, from ``a``, computed on `device`,
    with species drawn at the configuration's shares)."""
    rng = streams(seed)
    pot = config["potential"]
    m = mint.make_mtp(
        pot["level"], species_count=pot["species_count"],
        radial_basis_size=pot["radial_basis_size"], min_dist=pot["min_dist"],
        max_dist=pot["max_dist"], seed=int(rng["potential"].integers(2**62)),
    )
    lat = config["lattice"]
    mtp_bytes = mint.dumps_mtp(m)
    a = lat["a"]
    spec = config["species"]
    if lat.get("relax") == "zero_pressure":
        n_relax = len(lattice(lat["kind"], a, (5, 5, 5))[0])
        relax_types = species(rng["relax"], n_relax, [s["share"] for s in spec])
        a = zero_pressure_a(mtp_bytes, lat["kind"], a, device, relax_types)
    pos, cell = lattice(lat["kind"], a, lat["reps"])
    types = species(rng["species"], len(pos), [s["share"] for s in spec])
    masses = np.asarray([s["mass"] for s in spec], dtype=np.float64)[types]
    vel = velocities(rng["velocities"], masses, traffic["temperature"])
    boxes = []
    mvs = traffic.get("active_set")
    if mvs:
        bpos, bcell = lattice(lat["kind"], a, mvs["reps"])
        for sigma in mvs["sigmas"]:
            btypes = species(rng["mvs"], len(bpos), [s["share"] for s in spec])
            boxes.append((bpos + rng["mvs"].normal(0.0, sigma, bpos.shape), bcell, btypes))
    return Inputs(mtp_bytes, pos, cell, types, masses, vel, boxes, rng["sample"])
