"""MLIP-3-compatible ``.mtp`` potential file reader/writer.

NumPy-only copy of ``mtp_tpu/io/mtp_file.py`` for the PyTorch port; the tests
hold ``dumps_mtp`` byte-identical to the original's.

Implements the grammar the reference parses in ``PairMTP::read_file``
(reference: LAMMPS/ML-MTP/pair_mtp.cpp:335-655) and the MVS active-learning
trailer parsed by ``PairMTPExtrapolation::read_file``
(reference: LAMMPS/ML-MTP/pair_mtp_extrapolation.cpp:528-619):

    MTP
    version = 1.1.0
    potential_name = ...        (optional)
    scaling = 1.0               (optional)
    species_count = N
    potential_tag = ...         (optional)
    radial_basis_type = RBChebyshev
        [scaling = ...]         (optional, inside basis properties)
        min_dist = ...
        max_dist = ...
        radial_basis_size = ...
    radial_funcs_count = ...
    radial_coeffs
      t1-t2
        {c0, c1, ...}           (radial_basis_size values) x radial_funcs_count
      ... (species_count^2 pair blocks)
    alpha_moments_count = M
    alpha_index_basic_count = B
    alpha_index_basic = {{mu, ax, ay, az}, ...}      (single line)
    alpha_index_times_count = T
    alpha_index_times = {{a0, a1, mult, a3}, ...}    (single line)
    alpha_scalar_moments = S
    alpha_moment_mapping = {i0, i1, ...}
    species_coeffs = {...}
    moment_coeffs = {...}

Optional MVS trailer (active-learning selection state):

    #MVS_v1.1
    energy_weight = 0|1
    force_weight = ...
    stress_weight = ...
    site_en_weight = 0|1
    weight_scaling = ...
    #<raw binary: P*P float64 active_set, then P*P float64 inverse_active_set>

where P = coeff_count = radial_coeff_count + species_count + alpha_scalar_count
(reference: pair_mtp_extrapolation.cpp:533).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

_SEPS = re.compile(r"[=,{}\s]+")


class MTPFileError(ValueError):
    pass


@dataclasses.dataclass
class MTPData:
    """Raw contents of a ``.mtp`` file (host-side, NumPy, float64)."""

    species_count: int
    scaling: float
    min_dist: float
    max_dist: float
    radial_basis_size: int
    radial_funcs_count: int
    radial_basis_type: str
    # (species, species, radial_funcs_count, radial_basis_size)
    radial_coeffs: np.ndarray
    alpha_moments_count: int
    alpha_index_basic: np.ndarray  # (B, 4) int: (mu, ax, ay, az)
    alpha_index_times: np.ndarray  # (T, 4) int: (a0, a1, mult, a3)
    alpha_moment_mapping: np.ndarray  # (S,) int
    species_coeffs: np.ndarray  # (species,)
    moment_coeffs: np.ndarray  # (S,)
    potential_name: str = ""
    potential_tag: str = ""
    # --- MVS selection state (optional; active learning) ---
    mvs: Optional["MVSData"] = None

    @property
    def alpha_index_basic_count(self) -> int:
        return len(self.alpha_index_basic)

    @property
    def alpha_index_times_count(self) -> int:
        return len(self.alpha_index_times)

    @property
    def alpha_scalar_count(self) -> int:
        return len(self.alpha_moment_mapping)

    @property
    def radial_coeff_count(self) -> int:
        return self.species_count**2 * self.radial_funcs_count * self.radial_basis_size

    @property
    def coeff_count(self) -> int:
        """Active-learning coefficient-vector length (pair_mtp_extrapolation.cpp:533)."""
        return self.radial_coeff_count + self.species_count + self.alpha_scalar_count

    @property
    def max_alpha_index_basic(self) -> int:
        """1 + max tensor rank among basic alphas (pair_mtp.cpp:510-515)."""
        return int(self.alpha_index_basic[:, 1:].sum(axis=1).max()) + 1


@dataclasses.dataclass
class MVSData:
    """MaxVol selection state: weights + active set matrices."""

    energy_weight: float
    force_weight: float
    stress_weight: float
    site_en_weight: float
    weight_scaling: float
    active_set: np.ndarray  # (P, P) float64
    inverse_active_set: np.ndarray  # (P, P) float64

    @property
    def configuration_mode(self) -> bool:
        """Config mode iff energy_weight == 1 (pair_mtp_extrapolation.cpp:605)."""
        return self.energy_weight == 1


class _Lines:
    """Line cursor over the text section, skipping blank lines."""

    def __init__(self, text: str, ignore_comments: bool = True):
        self._lines = text.split("\n")
        self._pos = 0
        self.ignore_comments = ignore_comments

    def peek_tokens(self):
        pos = self._pos
        toks = self.next_tokens()
        self._pos = pos
        return toks

    def next_tokens(self):
        while self._pos < len(self._lines):
            line = self._lines[self._pos]
            self._pos += 1
            if self.ignore_comments:
                line = line.split("#", 1)[0]
            # Brace-balanced continuation: MLIP-3 writes index arrays as ONE
            # arbitrarily long line (the reference needs a buffer workaround
            # for them, pair_mtp.cpp:489-492 — a non-issue here), but hand-
            # edited/rewrapped files in the wild split them; keep consuming
            # lines until every '{' is closed.
            while line.count("{") > line.count("}") and self._pos < len(
                self._lines
            ):
                nxt = self._lines[self._pos]
                self._pos += 1
                if self.ignore_comments:
                    nxt = nxt.split("#", 1)[0]
                line = line + " " + nxt
            toks = [t for t in _SEPS.split(line) if t]
            if toks:
                return toks
        raise MTPFileError("Unexpected end of .mtp file")


def _expect(toks, keyword):
    if toks[0] != keyword:
        raise MTPFileError(f"Expected '{keyword}', got '{toks[0]}'")
    return toks[1:]


def loads_mtp(data: bytes) -> MTPData:
    """Parse a ``.mtp`` file from raw bytes (text + optional binary MVS trailer)."""
    # Split off the binary trailer: find '#MVS' marker if present.
    mvs_at = data.find(b"#MVS")
    if mvs_at >= 0:
        text = data[:mvs_at].decode("utf-8", errors="replace")
        trailer = data[mvs_at:]
    else:
        text = data.decode("utf-8", errors="replace")
        trailer = None

    lines = _Lines(text)
    toks = lines.next_tokens()
    if toks[0] != "MTP":
        raise MTPFileError("Only MTP potential files are accepted")
    toks = lines.next_tokens()
    if _expect(toks, "version")[0] != "1.1.0":
        raise MTPFileError('MTP file must have version "1.1.0"')

    potential_name = ""
    potential_tag = ""
    scaling = 1.0

    toks = lines.next_tokens()
    if toks[0] == "potential_name":
        potential_name = toks[1] if len(toks) > 1 else ""
        toks = lines.next_tokens()
    if toks[0] == "scaling":
        scaling = float(toks[1])
        toks = lines.next_tokens()
    species_count = int(_expect(toks, "species_count")[0])

    toks = lines.next_tokens()
    if toks[0] == "potential_tag":
        potential_tag = toks[1] if len(toks) > 1 else ""
        toks = lines.next_tokens()

    radial_basis_type = _expect(toks, "radial_basis_type")[0]
    if radial_basis_type != "RBChebyshev":
        raise MTPFileError(f"Unsupported radial basis type '{radial_basis_type}'")

    # Radial basis properties (mtp_radial_basis.cpp:59-102). 'scaling' may
    # optionally appear first inside this block.
    toks = lines.next_tokens()
    if toks[0] == "scaling":
        scaling = float(toks[1])
        toks = lines.next_tokens()
    if toks[0] not in ("min_val", "min_dist"):
        raise MTPFileError("Cannot read lower cutoff")
    min_dist = float(toks[1])
    toks = lines.next_tokens()
    if toks[0] not in ("max_val", "max_dist"):
        raise MTPFileError("Cannot read upper cutoff")
    max_dist = float(toks[1])
    radial_basis_size = int(_expect(lines.next_tokens(), "radial_basis_size")[0])
    radial_funcs_count = int(_expect(lines.next_tokens(), "radial_funcs_count")[0])

    toks = lines.next_tokens()
    if toks[0] == "magnetic_basis_type":
        raise MTPFileError("Magnetic basis is not supported")
    _expect(toks, "radial_coeffs")

    radial_coeffs = np.zeros(
        (species_count, species_count, radial_funcs_count, radial_basis_size)
    )
    for _ in range(species_count**2):
        # pair header like "0-1" (the reference splits this line on '-' too,
        # pair_mtp.cpp:452)
        toks = lines.next_tokens()
        if len(toks) == 1 and "-" in toks[0]:
            toks = toks[0].split("-")
        t1, t2 = int(toks[0]), int(toks[1])
        for mu in range(radial_funcs_count):
            vals = [float(v) for v in lines.next_tokens()]
            if len(vals) != radial_basis_size:
                raise MTPFileError(
                    f"radial_coeffs row for pair {t1}-{t2}, mu={mu} has "
                    f"{len(vals)} values, expected {radial_basis_size}"
                )
            radial_coeffs[t1, t2, mu] = vals

    alpha_moments_count = int(_expect(lines.next_tokens(), "alpha_moments_count")[0])
    alpha_index_basic_count = int(
        _expect(lines.next_tokens(), "alpha_index_basic_count")[0]
    )
    vals = _expect(lines.next_tokens(), "alpha_index_basic")
    alpha_index_basic = np.array([int(v) for v in vals], dtype=np.int32).reshape(
        alpha_index_basic_count, 4
    )
    if alpha_index_basic[:, 0].max() != radial_funcs_count - 1:
        raise MTPFileError("Wrong number of radial functions specified")

    alpha_index_times_count = int(
        _expect(lines.next_tokens(), "alpha_index_times_count")[0]
    )
    if alpha_index_times_count > 0:
        vals = _expect(lines.next_tokens(), "alpha_index_times")
        alpha_index_times = np.array([int(v) for v in vals], dtype=np.int32).reshape(
            alpha_index_times_count, 4
        )
    else:
        # tolerate either a bare keyword line or none at all
        if lines.peek_tokens()[0] == "alpha_index_times":
            lines.next_tokens()
        alpha_index_times = np.zeros((0, 4), dtype=np.int32)

    alpha_scalar_count = int(_expect(lines.next_tokens(), "alpha_scalar_moments")[0])
    vals = _expect(lines.next_tokens(), "alpha_moment_mapping")
    alpha_moment_mapping = np.array([int(v) for v in vals], dtype=np.int32)
    if len(alpha_moment_mapping) != alpha_scalar_count:
        raise MTPFileError("alpha_moment_mapping length mismatch")

    vals = _expect(lines.next_tokens(), "species_coeffs")
    species_coeffs = np.array([float(v) for v in vals])
    if len(species_coeffs) != species_count:
        raise MTPFileError("species_coeffs length mismatch")

    vals = _expect(lines.next_tokens(), "moment_coeffs")
    moment_coeffs = np.array([float(v) for v in vals])
    if len(moment_coeffs) != alpha_scalar_count:
        raise MTPFileError("moment_coeffs length mismatch")

    out = MTPData(
        species_count=species_count,
        scaling=scaling,
        min_dist=min_dist,
        max_dist=max_dist,
        radial_basis_size=radial_basis_size,
        radial_funcs_count=radial_funcs_count,
        radial_basis_type=radial_basis_type,
        radial_coeffs=radial_coeffs,
        alpha_moments_count=alpha_moments_count,
        alpha_index_basic=alpha_index_basic,
        alpha_index_times=alpha_index_times,
        alpha_moment_mapping=alpha_moment_mapping,
        species_coeffs=species_coeffs,
        moment_coeffs=moment_coeffs,
        potential_name=potential_name,
        potential_tag=potential_tag,
    )

    if trailer is not None:
        out.mvs = _parse_mvs(trailer, out.coeff_count)
    return out


def _parse_mvs(trailer: bytes, coeff_count: int) -> MVSData:
    """Parse the MVS trailer (pair_mtp_extrapolation.cpp:545-612).

    The text section ends at a lone '#' immediately followed by raw binary:
    coeff_count^2 float64 for the active set then the same for its inverse.
    """
    first_nl = trailer.find(b"\n")
    version = trailer[:first_nl].strip().decode()
    if version != "#MVS_v1.1":
        raise MTPFileError("MVS version must be #MVS_v1.1")
    rest = trailer[first_nl + 1 :]

    weights = {}
    for key in (
        "energy_weight",
        "force_weight",
        "stress_weight",
        "site_en_weight",
        "weight_scaling",
    ):
        nl = rest.find(b"\n")
        toks = [t for t in _SEPS.split(rest[:nl].decode()) if t]
        rest = rest[nl + 1 :]
        if toks[0] != key:
            raise MTPFileError(f"Error in reading MVS trailer, {key}")
        weights[key] = float(toks[1])

    if weights["energy_weight"] + weights["site_en_weight"] > 1:
        raise MTPFileError(
            "Only configuration mode (energy_weight=1) or neighborhood mode "
            "(site_en_weight=1) is supported"
        )

    # Skip forward one character: a '#' precedes the binary data
    # (pair_mtp_extrapolation.cpp:607).
    if not rest.startswith(b"#"):
        raise MTPFileError("Expected '#' before MVS binary data")
    rest = rest[1:]
    n = coeff_count * coeff_count
    need = 2 * n * 8
    if len(rest) < need:
        raise MTPFileError(
            f"MVS binary section too short: {len(rest)} bytes, need {need}"
        )
    mats = np.frombuffer(rest[:need], dtype="<f8")
    active_set = mats[:n].reshape(coeff_count, coeff_count).copy()
    inverse_active_set = mats[n:].reshape(coeff_count, coeff_count).copy()
    return MVSData(
        energy_weight=weights["energy_weight"],
        force_weight=weights["force_weight"],
        stress_weight=weights["stress_weight"],
        site_en_weight=weights["site_en_weight"],
        weight_scaling=weights["weight_scaling"],
        active_set=active_set,
        inverse_active_set=inverse_active_set,
    )


def load_mtp(path: str) -> MTPData:
    with open(path, "rb") as f:
        return loads_mtp(f.read())


def dumps_mtp(m: MTPData) -> bytes:
    """Serialize an MTPData back to the MLIP-3 text format (+ MVS trailer)."""
    out = []
    out.append("MTP")
    out.append("version = 1.1.0")
    if m.potential_name:
        out.append(f"potential_name = {m.potential_name}")
    out.append(f"scaling = {m.scaling!r}")
    out.append(f"species_count = {m.species_count}")
    out.append(f"potential_tag = {m.potential_tag}")
    out.append(f"radial_basis_type = {m.radial_basis_type}")
    out.append(f"\tmin_dist = {m.min_dist!r}")
    out.append(f"\tmax_dist = {m.max_dist!r}")
    out.append(f"\tradial_basis_size = {m.radial_basis_size}")
    out.append(f"radial_funcs_count = {m.radial_funcs_count}")
    out.append("radial_coeffs")
    for t1 in range(m.species_count):
        for t2 in range(m.species_count):
            out.append(f"\t{t1}-{t2}")
            for mu in range(m.radial_funcs_count):
                row = ", ".join(repr(float(v)) for v in m.radial_coeffs[t1, t2, mu])
                out.append("\t\t{" + row + "}")
    out.append(f"alpha_moments_count = {m.alpha_moments_count}")
    out.append(f"alpha_index_basic_count = {m.alpha_index_basic_count}")

    def fmt_rows(rows):
        return "{" + ", ".join(
            "{" + ", ".join(str(int(v)) for v in r) + "}" for r in rows
        ) + "}"

    out.append("alpha_index_basic = " + fmt_rows(m.alpha_index_basic))
    out.append(f"alpha_index_times_count = {m.alpha_index_times_count}")
    out.append("alpha_index_times = " + fmt_rows(m.alpha_index_times))
    out.append(f"alpha_scalar_moments = {m.alpha_scalar_count}")
    out.append(
        "alpha_moment_mapping = {"
        + ", ".join(str(int(v)) for v in m.alpha_moment_mapping)
        + "}"
    )
    out.append(
        "species_coeffs = {" + ", ".join(repr(float(v)) for v in m.species_coeffs) + "}"
    )
    out.append(
        "moment_coeffs = {" + ", ".join(repr(float(v)) for v in m.moment_coeffs) + "}"
    )
    blob = ("\n".join(out) + "\n").encode()

    if m.mvs is not None:
        v = m.mvs
        txt = [
            "#MVS_v1.1",
            f"energy_weight = {v.energy_weight:g}",
            f"force_weight = {v.force_weight:g}",
            f"stress_weight = {v.stress_weight:g}",
            f"site_en_weight = {v.site_en_weight:g}",
            f"weight_scaling = {v.weight_scaling:g}",
        ]
        blob += ("\n".join(txt) + "\n").encode()
        blob += b"#"
        blob += np.ascontiguousarray(v.active_set, dtype="<f8").tobytes()
        blob += np.ascontiguousarray(v.inverse_active_set, dtype="<f8").tobytes()
    return blob


def save_mtp(path: str, m: MTPData) -> None:
    with open(path, "wb") as f:
        f.write(dumps_mtp(m))
