"""MaxVol active-set construction (host-side training utility).

NumPy copy of ``mtp_tpu/al/maxvol.py`` returning the port's
:class:`~mtp_tpu_torch.io.mtp_file.MVSData`. The reference only *consumes* a
MaxVol selection state produced by MLIP-3 (the MVS trailer,
pair_mtp_extrapolation.cpp:528-619); building it here makes the framework
self-contained: given a pool of candidate vectors (rows = neighborhoods or
configurations), select the square submatrix of (near-)maximal volume and
emit the (A, A^-1) pair the runtime needs.
"""

from __future__ import annotations

import numpy as np

from mtp_tpu_torch.io.mtp_file import MVSData


def maxvol_select(pool: np.ndarray, *, tol: float = 1.01, max_iters: int = 200):
    """Classic rectangular->square MaxVol row selection.

    Args:
      pool: (n_rows, P) candidate matrix, n_rows >= P.
    Returns (row_indices (P,), A (P,P)).
    """
    pool = np.asarray(pool, dtype=np.float64)
    n, p = pool.shape
    if n < p:
        raise ValueError(f"need at least P={p} rows, got {n}")

    # initial well-conditioned subset via column-pivoted QR on pool^T
    try:
        from scipy.linalg import qr
    except ImportError:
        piv = _lu_row_pivots(pool)
    else:
        _, _, piv = qr(pool.T, pivoting=True, mode="economic")
    idx = np.array(piv[:p], dtype=np.int64)

    for _ in range(max_iters):
        A = pool[idx]
        C = np.linalg.solve(A.T, pool.T).T  # C = pool @ A^-1, (n, p)
        j, k = np.unravel_index(np.argmax(np.abs(C)), C.shape)
        if abs(C[j, k]) <= tol:
            break
        idx[k] = j
    A = pool[idx]
    return idx, A


def _lu_row_pivots(pool):
    """Greedy row pivots (the fallback without scipy): repeatedly take the
    row with the largest residual norm after projecting out already-chosen
    rows."""
    n, p = pool.shape
    R = pool.copy()
    chosen = []
    for _ in range(p):
        norms = np.linalg.norm(R, axis=1)
        norms[chosen] = -1
        j = int(np.argmax(norms))
        chosen.append(j)
        v = R[j] / max(np.linalg.norm(R[j]), 1e-300)
        R = R - np.outer(R @ v, v)
    return np.array(chosen, dtype=np.int64)


def build_mvs(
    pool: np.ndarray,
    *,
    mode: str = "neighborhood",
    weight_scaling: float = 2.0,
    tol: float = 1.01,
    reg: float = 1e-6,
) -> MVSData:
    """Build an MVS selection state from a candidate-vector pool.

    mode: 'neighborhood' (site_en_weight=1) or 'configuration'
    (energy_weight=1); the runtime reads the mode from these weights
    (pair_mtp_extrapolation.cpp:599-605).

    MTP candidate vectors have *structural* null directions (exact linear
    dependencies among coefficient derivatives), so a raw pool is rank
    deficient and its MaxVol submatrix singular. Scaled identity fallback
    rows (`reg` x pool scale) are appended: dead directions get selected from
    the identity, pricing extrapolation along them at 1/reg while leaving
    in-distribution grades unchanged.
    """
    pool = np.asarray(pool, dtype=np.float64)
    scale = max(np.abs(pool).max(), 1e-300)
    p = pool.shape[1]
    aug = np.vstack([pool, reg * scale * np.eye(p)])
    _, A = maxvol_select(aug, tol=tol)
    # The runtime grade formula is grade_l = sum_j inverse_active_set[l][j]*b[j]
    # (reference pair_mtp_extrapolation.cpp:347-358); for that to yield the
    # MaxVol representation coefficients c with b = c @ A, the stored inverse
    # must be inv(A)^T.
    inv = np.linalg.inv(A).T
    cfg = mode == "configuration"
    return MVSData(
        energy_weight=1.0 if cfg else 0.0,
        force_weight=0.0,
        stress_weight=0.0,
        site_en_weight=0.0 if cfg else 1.0,
        weight_scaling=weight_scaling,
        active_set=A,
        inverse_active_set=inv,
    )
