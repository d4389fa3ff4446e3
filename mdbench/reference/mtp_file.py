"""A plain reader of MLIP-3 ``.mtp`` potential files (text part only).

Independent of the program under test: it reads the file the benchmark
wrote and returns the tables and coefficients as NumPy arrays. Braces and
commas are separators; ``key = value`` lines give scalars, ``key = {...}``
lines give flat lists, and ``radial_coeffs`` is followed by one ``a-b``
header per species pair and one row per radial function.
"""

from __future__ import annotations

import re

import numpy as np


def _numbers(text: str):
    return [float(t) for t in re.split(r"[\s{},]+", text) if t]


def parse_mtp(data: bytes) -> dict:
    """The potential in a ``.mtp`` file's bytes, as a dict of NumPy arrays
    and numbers. An MVS trailer (``#MVS``...) is ignored."""
    cut = data.find(b"#MVS")
    text = (data if cut < 0 else data[:cut]).decode()
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if lines[0] != "MTP":
        raise ValueError("not an MTP file")
    kv, i = {}, 1
    while i < len(lines):
        ln = lines[i]
        if ln == "radial_coeffs":
            s, mu, rb = kv["species_count"], kv["radial_funcs_count"], kv["radial_basis_size"]
            rc = np.zeros((s, s, mu, rb))
            i += 1
            for _ in range(s * s):
                a, b = (int(t) for t in lines[i].split("-"))
                for k in range(mu):
                    rc[a, b, k] = _numbers(lines[i + 1 + k])
                i += 1 + mu
            kv["radial_coeffs"] = rc
            continue
        key, _, val = (t.strip() for t in ln.partition("="))
        if val.startswith("{"):
            kv[key] = _numbers(val)
        elif key in ("radial_basis_type", "potential_name", "potential_tag", "version"):
            kv[key] = val
        elif val:
            num = float(val)
            kv[key] = int(num) if num.is_integer() and "." not in val else num
        i += 1
    if kv.get("radial_basis_type") != "RBChebyshev":
        raise ValueError("only the Chebyshev radial basis is supported")
    return dict(
        species_count=int(kv["species_count"]),
        scaling=float(kv.get("scaling", 1.0)),
        min_dist=float(kv["min_dist"]),
        max_dist=float(kv["max_dist"]),
        radial_basis_size=int(kv["radial_basis_size"]),
        radial_funcs_count=int(kv["radial_funcs_count"]),
        radial_coeffs=kv["radial_coeffs"],
        alpha_moments_count=int(kv["alpha_moments_count"]),
        alpha_index_basic=np.asarray(kv["alpha_index_basic"], dtype=np.int64).reshape(-1, 4),
        alpha_index_times=np.asarray(kv.get("alpha_index_times", []),
                                     dtype=np.int64).reshape(-1, 4),
        alpha_moment_mapping=np.asarray(kv["alpha_moment_mapping"], dtype=np.int64),
        species_coeffs=np.asarray(kv["species_coeffs"], dtype=np.float64),
        moment_coeffs=np.asarray(kv["moment_coeffs"], dtype=np.float64),
    )
