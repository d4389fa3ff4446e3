"""MaxVol active set and grades, for the reference.

A frozen copy of the program's selection rule (``al/maxvol.py``): a
column-pivoted QR of the pool picks the first rows, then rows are swapped
in while some pool row has a coefficient above ``tol`` in the basis of the
chosen rows. Scaled identity rows are appended first, so that the
structural null directions of MTP candidate vectors are priced at 1/reg.
The grade of a neighborhood is the largest coefficient of its candidate
vector b in the basis of the active set: max_l |(b A^-1)_l|.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import qr


def active_set(pool: np.ndarray, *, tol: float = 1.01, reg: float = 1e-6,
               max_iters: int = 200) -> np.ndarray:
    """The (P, P) active set A of a (n, P) pool of candidate vectors."""
    pool = np.asarray(pool, dtype=np.float64)
    p = pool.shape[1]
    aug = np.vstack([pool, reg * max(np.abs(pool).max(), 1e-300) * np.eye(p)])
    _, _, piv = qr(aug.T, pivoting=True, mode="economic")
    idx = np.array(piv[:p], dtype=np.int64)
    for _ in range(max_iters):
        c = np.linalg.solve(aug[idx].T, aug.T).T
        j, k = np.unravel_index(np.argmax(np.abs(c)), c.shape)
        if abs(c[j, k]) <= tol:
            break
        idx[k] = j
    return aug[idx]


def grades(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """max_l |(b A^-1)_l| for each row of b."""
    return np.max(np.abs(np.linalg.solve(a.T, np.asarray(b, dtype=np.float64).T)), axis=0)
