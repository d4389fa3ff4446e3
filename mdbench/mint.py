"""Mint an MTP potential: a frozen copy of the program's basis-set generator.

Copied from ``mtp_tpu_torch/io/basis_gen.py`` (itself a NumPy copy of the
JAX package's generator) together with the ``.mtp`` writer, so that the
potential the benchmark runs cannot move when the program's generator is
edited. ``make_mtp(level, species_count=S, seed=n)`` draws the coefficients
from ``n``; the contraction tables depend on the level alone. ``dumps_mtp``
writes MLIP-3's text format, which the program loads through its own reader
(``MTPModel.load``) and the reference through ``mdbench.reference.mtp_file``.

The generator's own description follows.

MTP basis-set (alpha table) generator.

NumPy-only copy of ``mtp_tpu/io/basis_gen.py`` for the PyTorch port (the JAX
package's ``__init__`` imports ``jax``, so the port cannot import it). The
tests hold its output byte-identical to the original's.

The reference consumes precomputed contraction tables from MLIP-3 ``.mtp``
template files (``alpha_index_basic`` / ``alpha_index_times`` /
``alpha_moment_mapping``; parsed at reference pair_mtp.cpp:471-569). It cannot
create them. This module *generates* such tables from scratch so the framework
can mint valid potentials at any MTP "level" without MLIP-3 — used for test
fixtures, benchmarks, and training new potentials.

Construction
------------
Basic moments are symmetric tensors

    M_{mu,nu}(i) = sum_j f_mu(|r_ij|) * (r_ij/|r_ij|)^{tensor nu}

with level lev(M_{mu,nu}) = 2 + 4*mu + nu (MLIP-2 convention). A component is
an exponent triple e=(ex,ey,ez), |e|=nu. Rotation-invariant scalars are built
from two families:

1. *Star contractions*: a backbone tensor A=M_{mu0,nu0} fully contracted with
   an outer product of partner tensors B_1..B_p (partner ranks sum to nu0):

       I = sum_{e1..ep} prod_i mult(e_i) * A_{e1+...+ep} * prod_i B_i,{e_i}

   with mult(e) = nu!/(ex! ey! ez!), plus optional rank-0 scalar factors.

2. *Products of scalars*: pairwise products of previously formed invariants
   (MLIP's basis also contains such products).

Every candidate is emitted as rows of the ``alpha_index_times`` DAG
(a0, a1, integer multiplier, a3), exactly the format the reference executes
(pair_mtp.cpp:196-201). Linearly dependent candidates (e.g. through the trace
identity ux^2+uy^2+uz^2 = 1) are removed by a numerical rank filter evaluated
on random realizable neighborhoods. Node indices are assigned basics-first in
dependency order, and rows are sorted by output node, which preserves the
<=3-wave property the reference's block-parallel engine relies on
(pair_mtps_kokkos.cpp:179-200).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class MTPData:
    """The contents of a ``.mtp`` file (NumPy, float64)."""

    species_count: int
    scaling: float
    min_dist: float
    max_dist: float
    radial_basis_size: int
    radial_funcs_count: int
    radial_basis_type: str
    radial_coeffs: np.ndarray  # (species, species, radial_funcs_count, radial_basis_size)
    alpha_moments_count: int
    alpha_index_basic: np.ndarray  # (B, 4) int: (mu, ax, ay, az)
    alpha_index_times: np.ndarray  # (T, 4) int: (a0, a1, mult, a3)
    alpha_moment_mapping: np.ndarray  # (S,) int
    species_coeffs: np.ndarray  # (species,)
    moment_coeffs: np.ndarray  # (S,)
    potential_name: str = ""
    potential_tag: str = ""


Exp = Tuple[int, int, int]  # exponent triple of a symmetric-tensor component


def _cheb_values(m: MTPData, dist: float) -> np.ndarray:
    """Chebyshev radial basis values at one distance, in the operation order
    of the reference engine (mtp_rb_chevbyshev_basis.cpp:29-38), so that
    minted coefficients are bit-identical to those of ``mtp_tpu``."""
    rb = m.radial_basis_size
    vals = np.zeros(rb)
    lo, hi, s = m.min_dist, m.max_dist, m.scaling
    ksi = (2 * dist - (lo + hi)) / (hi - lo)
    env = (dist - hi) ** 2
    vals[0] = s * env
    vals[1] = s * ksi * env
    for i in range(2, rb):
        vals[i] = 2 * ksi * vals[i - 1] - vals[i - 2]
    return vals


def _exps(rank: int) -> List[Exp]:
    """All exponent triples (ex,ey,ez) with ex+ey+ez == rank."""
    out = []
    for ex in range(rank, -1, -1):
        for ey in range(rank - ex, -1, -1):
            out.append((ex, ey, rank - ex - ey))
    return out


def _mult(e: Exp) -> int:
    """Multinomial multiplicity nu!/(ex!ey!ez!) of a symmetric component."""
    n = sum(e)
    return math.factorial(n) // (
        math.factorial(e[0]) * math.factorial(e[1]) * math.factorial(e[2])
    )


def _add(a: Exp, b: Exp) -> Exp:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


class _Candidate:
    """A candidate scalar invariant with its DAG recipe.

    rows: list of (key_a0, key_a1, mult, key_out); keys are hashable node ids.
    Node kinds: ('b', mu, e) basic component; ('d', partners, e) partial
    product; ('s', sig) scalar output.
    """

    def __init__(self, sig, level: int, rows):
        self.sig = sig
        self.level = level
        self.rows = rows
        self.out_key = ("s", sig)


def _star_candidates(level_max: int, max_rank: int, max_partners: int):
    """Enumerate star-contraction invariants within the level budget."""
    mu_max = (level_max - 2) // 4
    basics = [
        (mu, nu)
        for mu in range(mu_max + 1)
        for nu in range(0, max_rank + 1)
        if 2 + 4 * mu + nu <= level_max
    ]
    lev = lambda b: 2 + 4 * b[0] + b[1]

    cands: List[_Candidate] = []

    def emit(backbone, partners):
        """Build the DAG recipe for one star invariant."""
        mu0, nu0 = backbone
        total_level = lev(backbone) + sum(lev(p) for p in partners)
        if nu0 == 0 and not partners:
            # bare rank-0 basic: it is itself a moment slot; map directly
            return _Candidate(("basic0", mu0), total_level, [])
        sig = ("star", backbone, tuple(sorted(partners)))
        out = ("s", sig)
        rows = []
        if len(partners) == 1:
            # pair contraction: accumulate directly into the scalar node
            b1 = partners[0]
            for e in _exps(nu0):
                rows.append((("b", mu0, e), ("b", b1[0], e), _mult(e), out))
        else:
            # build partner product nodes d^{(k)} then contract with backbone
            plist = sorted(partners)
            b1, b2 = plist[0], plist[1]
            d2key = lambda e: ("d", (b1, b2), e)
            for e1 in _exps(b1[1]):
                for e2 in _exps(b2[1]):
                    rows.append(
                        (
                            ("b", b1[0], e1),
                            ("b", b2[0], e2),
                            _mult(e1) * _mult(e2),
                            d2key(_add(e1, e2)),
                        )
                    )
            prev_key, prev_rank = d2key, b1[1] + b2[1]
            prev_parts = (b1, b2)
            for bk in plist[2:]:
                parts = prev_parts + (bk,)
                nkey = lambda e, parts=parts: ("d", parts, e)
                for E0 in _exps(prev_rank):
                    for ek in _exps(bk[1]):
                        rows.append(
                            (prev_key(E0), ("b", bk[0], ek), _mult(ek), nkey(_add(E0, ek)))
                        )
                prev_key, prev_rank, prev_parts = nkey, prev_rank + bk[1], parts
            for E in _exps(nu0):
                rows.append((("b", mu0, E), prev_key(E), 1, out))
        return _Candidate(sig, total_level, rows)

    # pure rank-0 basics
    for mu, nu in basics:
        if nu == 0:
            cands.append(emit((mu, 0), ()))

    # star contractions: backbone + partners with ranks summing to nu0
    nonzero = [b for b in basics if b[1] >= 1]
    for backbone in nonzero:
        mu0, nu0 = backbone
        budget = level_max - lev(backbone)
        # partner multisets (sorted tuples) with rank-sum nu0, level-sum <= budget
        def rec(start, rank_left, lev_left, acc):
            if rank_left == 0:
                if len(acc) >= 1:
                    yield tuple(acc)
                return
            if len(acc) >= max_partners:
                return
            for i in range(start, len(nonzero)):
                b = nonzero[i]
                if b[1] > rank_left or lev(b) > lev_left:
                    continue
                acc.append(b)
                yield from rec(i, rank_left - b[1], lev_left - lev(b), acc)
                acc.pop()

        for partners in rec(0, nu0, budget, []):
            # avoid double-count: for single-partner (pair) contractions,
            # require partner >= backbone in sort order
            if len(partners) == 1 and partners[0] < backbone:
                continue
            cands.append(emit(backbone, partners))

    return cands


def _product_candidates(cands: List[_Candidate], level_max: int, max_factors: int = 2):
    """Pairwise (and higher) products of star invariants."""
    out = []
    base = [c for c in cands if c.rows or c.sig[0] == "basic0"]
    # represent value-node of a candidate
    def node_of(c):
        if c.sig[0] == "basic0":
            return ("b", c.sig[1], (0, 0, 0))
        return c.out_key

    for i, a in enumerate(base):
        for j in range(i, len(base)):
            b = base[j]
            if a.level + b.level > level_max:
                continue
            sig = ("prod", tuple(sorted((a.sig, b.sig))))
            rows = list(a.rows) + [r for r in b.rows if r not in a.rows]
            rows.append((node_of(a), node_of(b), 1, ("s", sig)))
            out.append(_Candidate(sig, a.level + b.level, rows))
    return out


def _eval_candidates(cands, mu_count: int, n_samples: int, seed: int = 0):
    """Evaluate candidate invariants on random realizable neighborhoods.

    Returns (values (n_cand, n_samples), basic_keys used anywhere).
    """
    rng = np.random.default_rng(seed)
    # gather all basic keys
    basic_keys = set()
    for c in cands:
        if c.sig[0] == "basic0":
            basic_keys.add(("b", c.sig[1], (0, 0, 0)))
        for a, b, _, _ in c.rows:
            for k in (a, b):
                if k[0] == "b":
                    basic_keys.add(k)
    basic_keys = sorted(basic_keys)

    # sample basic moment values from random neighborhoods
    nj = 8
    u = rng.normal(size=(n_samples, nj, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    f = rng.normal(size=(n_samples, nj, mu_count))
    bvals: Dict[tuple, np.ndarray] = {}
    for key in basic_keys:
        _, mu, e = key
        poly = u[..., 0] ** e[0] * u[..., 1] ** e[1] * u[..., 2] ** e[2]
        bvals[key] = (f[..., mu] * poly).sum(axis=1)

    vals = np.zeros((len(cands), n_samples))
    for ci, c in enumerate(cands):
        if c.sig[0] == "basic0":
            vals[ci] = bvals[("b", c.sig[1], (0, 0, 0))]
            continue
        node_vals: Dict[tuple, np.ndarray] = {}

        def get(k):
            if k[0] == "b":
                return bvals[k]
            return node_vals.get(k, 0.0)

        for a, b, m, o in c.rows:
            node_vals[o] = get(o) + m * get(a) * get(b)
        vals[ci] = node_vals[c.out_key]
    return vals, basic_keys


def _independent_subset(vals: np.ndarray, order: np.ndarray, tol: float = 1e-8):
    """Greedy Gram-Schmidt selection of linearly independent rows of `vals`,
    preferring earlier entries of `order`."""
    selected = []
    basis = []
    for idx in order:
        v = vals[idx].astype(np.float64)
        nrm0 = np.linalg.norm(v)
        if nrm0 == 0:
            continue
        w = v.copy()
        for b in basis:
            w -= (w @ b) * b
        # re-orthogonalize once for stability
        for b in basis:
            w -= (w @ b) * b
        nrm = np.linalg.norm(w)
        if nrm > tol * nrm0:
            basis.append(w / nrm)
            selected.append(idx)
    return selected


def generate_basis(
    level_max: int,
    *,
    max_rank: int | None = None,
    max_partners: int = 3,
    include_products: bool = True,
    seed: int = 0,
) -> dict:
    """Generate MTP alpha tables for a given level.

    Returns a dict with keys: ``alpha_index_basic`` (B,4), ``alpha_index_times``
    (T,4), ``alpha_moment_mapping`` (S,), ``alpha_moments_count``,
    ``radial_funcs_count`` — directly usable in an :class:`MTPData`.
    """
    if max_rank is None:
        max_rank = min(level_max - 2, 6)
    mu_count = (level_max - 2) // 4 + 1

    cands = _star_candidates(level_max, max_rank, max_partners)
    if include_products:
        cands = cands + _product_candidates(cands, level_max)

    n_samples = max(64, 2 * len(cands))
    vals, _ = _eval_candidates(cands, mu_count, n_samples, seed=seed)
    order = np.lexsort((np.arange(len(cands)), [c.level for c in cands]))
    keep = _independent_subset(vals, order)
    keep_sorted = sorted(keep, key=lambda i: (cands[i].level, i))
    chosen = [cands[i] for i in keep_sorted]

    # ---- assemble the final DAG ----
    # collect needed nodes
    basic_nodes = set()
    inter_nodes = []  # in first-use order
    inter_seen = set()
    scalar_nodes = []
    scalar_seen = set()
    all_rows = []
    row_seen = set()
    for c in chosen:
        if c.sig[0] == "basic0":
            basic_nodes.add(("b", c.sig[1], (0, 0, 0)))
            continue
        for r in c.rows:
            if r in row_seen:
                continue
            row_seen.add(r)
            all_rows.append(r)
            for k in (r[0], r[1]):
                if k[0] == "b":
                    basic_nodes.add(k)
                elif k[0] == "d" and k not in inter_seen:
                    inter_seen.add(k)
                    inter_nodes.append(k)
                elif k[0] == "s" and k not in scalar_seen:
                    scalar_seen.add(k)
                    scalar_nodes.append(k)
            o = r[3]
            if o[0] == "d" and o not in inter_seen:
                inter_seen.add(o)
                inter_nodes.append(o)
            elif o[0] == "s" and o not in scalar_seen:
                scalar_seen.add(o)
                scalar_nodes.append(o)

    # ensure every mu in [0, mu_count) appears (the reference validates
    # radial_func_max == radial_funcs_count-1, pair_mtp.cpp:506-507)
    used_mus = {k[1] for k in basic_nodes}
    for mu in range(mu_count):
        if mu not in used_mus:
            basic_nodes.add(("b", mu, (0, 0, 0)))

    basic_list = sorted(basic_nodes, key=lambda k: (k[1], tuple(-x for x in k[2])))

    # topological index assignment: basics, then intermediates/scalars in
    # dependency order (Kahn over the rows)
    index: Dict[tuple, int] = {k: i for i, k in enumerate(basic_list)}
    remaining = list(all_rows)
    next_idx = len(basic_list)
    # repeatedly assign indices to nodes whose input nodes are all indexed
    node_rows: Dict[tuple, list] = {}
    for r in remaining:
        node_rows.setdefault(r[3], []).append(r)
    unassigned = [k for k in inter_nodes + scalar_nodes if k not in index]
    progress = True
    while unassigned and progress:
        progress = False
        still = []
        for k in unassigned:
            ready = all(
                r[0] in index and r[1] in index for r in node_rows.get(k, [])
            )
            if ready:
                index[k] = next_idx
                next_idx += 1
                progress = True
            else:
                still.append(k)
        unassigned = still
    if unassigned:
        raise RuntimeError("cyclic dependency in generated DAG")

    rows_idx = sorted(
        ((index[a], index[b], m, index[o]) for a, b, m, o in all_rows),
        key=lambda r: (r[3], r[0], r[1]),
    )

    mapping = []
    for c in chosen:
        if c.sig[0] == "basic0":
            mapping.append(index[("b", c.sig[1], (0, 0, 0))])
        else:
            mapping.append(index[c.out_key])

    alpha_index_basic = np.array(
        [(k[1],) + k[2] for k in basic_list], dtype=np.int32
    )
    alpha_index_times = (
        np.array(rows_idx, dtype=np.int32)
        if rows_idx
        else np.zeros((0, 4), dtype=np.int32)
    )
    return dict(
        alpha_index_basic=alpha_index_basic,
        alpha_index_times=alpha_index_times,
        alpha_moment_mapping=np.array(mapping, dtype=np.int32),
        alpha_moments_count=next_idx,
        radial_funcs_count=mu_count,
        levels=[c.level for c in chosen],
    )


def _fit_radial(vals_fn, target_fn, d_grid, rb):
    """Least-squares fit of a radial profile onto the Chebyshev basis."""
    A = np.stack([vals_fn(d) for d in d_grid])  # (G, rb)
    t = np.array([target_fn(d) for d in d_grid])
    c, *_ = np.linalg.lstsq(A, t, rcond=None)
    return c


def make_mtp(
    level_max: int,
    *,
    species_count: int = 1,
    radial_basis_size: int = 8,
    min_dist: float = 1.5,
    max_dist: float = 5.0,
    scaling: float = 1.0,
    seed: int = 0,
    coeff_scale: float = 1e-2,
    stabilize: float = 1.0,
    r0: float = 2.85,
    well_depth: float = 0.08,
) -> MTPData:
    """Mint a complete MTPData with random (but well-scaled) coefficients.

    When ``stabilize > 0``, the mu=0 radial function is fit to a Morse-like
    pair profile (repulsive core + shallow well at ``r0``) and wired to the
    rank-0 scalar with unit weight, so minted potentials support stable MD —
    the random many-body terms perturb around that baseline.
    """
    basis = generate_basis(level_max, seed=seed)
    rng = np.random.default_rng(seed + 1)
    mu = basis["radial_funcs_count"]
    radial_coeffs = rng.normal(
        size=(species_count, species_count, mu, radial_basis_size)
    ) * (0.5 / radial_basis_size)
    species_coeffs = rng.normal(size=species_count) * coeff_scale
    # scale linear coefficients down with level so high-rank products don't blow up
    levels = np.asarray(basis["levels"], dtype=np.float64)
    moment_coeffs = rng.normal(size=len(levels)) * coeff_scale * 4.0 ** (-levels / 4.0)

    if stabilize > 0:
        tmp = MTPData(
            species_count=species_count,
            scaling=scaling,
            min_dist=min_dist,
            max_dist=max_dist,
            radial_basis_size=radial_basis_size,
            radial_funcs_count=mu,
            radial_basis_type="RBChebyshev",
            radial_coeffs=radial_coeffs,
            alpha_moments_count=basis["alpha_moments_count"],
            alpha_index_basic=basis["alpha_index_basic"],
            alpha_index_times=basis["alpha_index_times"],
            alpha_moment_mapping=basis["alpha_moment_mapping"],
            species_coeffs=species_coeffs,
            moment_coeffs=moment_coeffs,
        )
        a_m = 1.6  # Morse width [1/A]
        morse = lambda d: well_depth * (
            (1.0 - np.exp(-a_m * (d - r0))) ** 2 - 1.0
        ) * 0.5  # half: each pair counted from both ends

        d_grid = np.linspace(min_dist * 0.85, max_dist, 96)
        c0 = _fit_radial(
            lambda d: _cheb_values(tmp, d), morse, d_grid, radial_basis_size
        )
        # locate the scalar slot mapped to the (mu=0, rank-0) basic moment
        aib = basis["alpha_index_basic"]
        rank0 = np.where((aib[:, 0] == 0) & (aib[:, 1:].sum(axis=1) == 0))[0]
        slot = np.where(basis["alpha_moment_mapping"] == rank0[0])[0]
        radial_coeffs[:, :, 0, :] = c0 * stabilize
        moment_coeffs[slot[0]] = 1.0

    return MTPData(
        species_count=species_count,
        scaling=scaling,
        min_dist=min_dist,
        max_dist=max_dist,
        radial_basis_size=radial_basis_size,
        radial_funcs_count=mu,
        radial_basis_type="RBChebyshev",
        radial_coeffs=radial_coeffs,
        alpha_moments_count=basis["alpha_moments_count"],
        alpha_index_basic=basis["alpha_index_basic"],
        alpha_index_times=basis["alpha_index_times"],
        alpha_moment_mapping=basis["alpha_moment_mapping"],
        species_coeffs=species_coeffs,
        moment_coeffs=moment_coeffs,
        potential_name=f"generated-level{level_max}",
    )


def dumps_mtp(m: MTPData) -> bytes:
    """Serialize an MTPData back to the MLIP-3 text format (no MVS trailer)."""
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
    out.append(f"alpha_index_basic_count = {len(m.alpha_index_basic)}")

    def fmt_rows(rows):
        return "{" + ", ".join(
            "{" + ", ".join(str(int(v)) for v in r) + "}" for r in rows
        ) + "}"

    out.append("alpha_index_basic = " + fmt_rows(m.alpha_index_basic))
    out.append(f"alpha_index_times_count = {len(m.alpha_index_times)}")
    out.append("alpha_index_times = " + fmt_rows(m.alpha_index_times))
    out.append(f"alpha_scalar_moments = {len(m.alpha_moment_mapping)}")
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
    return ("\n".join(out) + "\n").encode()
