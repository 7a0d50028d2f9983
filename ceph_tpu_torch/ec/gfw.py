"""GF(2) bit-matrix algebra (host side).

The port's own copy of ``gf2_mat_inv`` from ``ceph_tpu/ec/gfw.py``: the
decode path inverts the survivors' rows of ``[I; CB]`` once per erasure
signature and caches the result.
"""

from __future__ import annotations

import numpy as np


def gf2_mat_inv(M: np.ndarray) -> np.ndarray:
    """Invert a 0/1 matrix over GF(2); raises if singular."""
    M = np.asarray(M, np.uint8) & 1
    n = M.shape[0]
    assert M.shape == (n, n)
    aug = np.concatenate([M.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if aug[r, col]:
                piv = r
                break
        if piv is None:
            raise np.linalg.LinAlgError("singular GF(2) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        elim = (aug[:, col] == 1)
        elim[col] = False
        aug[elim] ^= aug[col]
    return aug[:, n:].copy()
