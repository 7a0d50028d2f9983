"""GF(2^w) arithmetic for any w in 2..32 and GF(2) bit-matrix algebra.

The port's own copy of ``ceph_tpu/ec/gfw.py`` (numpy, host side): the
``GFW`` field class with its primitive-polynomial table (0x11D at w=8,
0x1100B at w=16, 0x400007 at w=32, as jerasure's galois.c and
gf-complete's gf_wgen), scalar and matrix operations, and the
multiply-by-element expansion that turns a GF(2^w) matrix into a 0/1
matrix over bit planes (jerasure's ``matrix_to_bitmatrix``).  Also the
GF(2) inversion the decode paths cache per erasure signature, and the
ring multiply of the Blaum-Roth construction.

Matrices are tiny, built once per profile and cached; the bulk data
path is kernel K1 (``gf2_kernels.gf2_matmul_w8``).
"""

from __future__ import annotations

import numpy as np

# Primitive polynomials, low bits only (implicit x^w term) — the
# standard table from jerasure galois.c / gf-complete gf_wgen; w=8/16/32
# match the gf-complete per-width defaults 0x11D / 0x1100B / 0x400007.
GF_POLY = {
    2: 0x3, 3: 0x3, 4: 0x3, 5: 0x5, 6: 0x3, 7: 0x09, 8: 0x1D,
    9: 0x11, 10: 0x09, 11: 0x05, 12: 0x53, 13: 0x1B, 14: 0x443,
    15: 0x03, 16: 0x100B, 17: 0x09, 18: 0x81, 19: 0x27, 20: 0x09,
    21: 0x05, 22: 0x03, 23: 0x21, 24: 0x87, 25: 0x09, 26: 0x47,
    27: 0x27, 28: 0x09, 29: 0x05, 30: 0x800007, 31: 0x09, 32: 0x400007,
}

_TABLE_MAX_W = 16  # log/exp tables up to 2^16; clmul above


class GFW:
    """One GF(2^w) field instance (2 <= w <= 32)."""

    _cache: dict = {}

    def __new__(cls, w: int):
        if w in cls._cache:
            return cls._cache[w]
        self = super().__new__(cls)
        cls._cache[w] = self
        return self

    def __init__(self, w: int):
        if getattr(self, "w", None) == w:
            return
        if w not in GF_POLY:
            raise ValueError(f"unsupported w={w}")
        self.w = w
        self.poly = GF_POLY[w]
        self.size = 1 << w
        self.mask = self.size - 1
        if w <= _TABLE_MAX_W:
            n = self.size - 1
            exp = np.zeros(2 * n, np.int64)
            log = np.zeros(self.size, np.int64)
            x = 1
            for i in range(n):
                exp[i] = x
                log[x] = i
                x <<= 1
                if x & self.size:
                    x ^= (self.poly | self.size)
            exp[n:] = exp[:n]
            self.exp, self.log = exp, log
        else:
            self.exp = self.log = None

    # -- scalar ops (python ints; exact for w=32) ----------------------
    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        if self.exp is not None:
            return int(self.exp[self.log[a] + self.log[b]])
        # carry-less multiply + poly reduction
        r = 0
        aa, bb = a, b
        while bb:
            if bb & 1:
                r ^= aa
            bb >>= 1
            aa <<= 1
        full_poly = self.poly | (1 << self.w)
        for bit in range(2 * self.w - 2, self.w - 1, -1):
            if r >> bit & 1:
                r ^= full_poly << (bit - self.w)
        return r

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("GF inverse of 0")
        if self.exp is not None:
            return int(self.exp[self.size - 1 - self.log[a]])
        # a^(2^w - 2) by square-and-multiply
        r, p, e = 1, a, self.size - 2
        while e:
            if e & 1:
                r = self.mul(r, p)
            p = self.mul(p, p)
            e >>= 1
        return r

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inv(b))

    def pow(self, a: int, n: int) -> int:
        r, p = 1, a
        while n:
            if n & 1:
                r = self.mul(r, p)
            p = self.mul(p, p)
            n >>= 1
        return r

    # -- matrix ops (object-dtype safe for w=32; lists of ints) --------
    def mat_inv(self, M):
        """Gauss-Jordan inversion over GF(2^w); M: list-of-lists of int."""
        n = len(M)
        aug = [list(row) + [1 if i == j else 0 for j in range(n)]
               for i, row in enumerate(M)]
        for col in range(n):
            piv = next((r for r in range(col, n) if aug[r][col]), None)
            if piv is None:
                raise np.linalg.LinAlgError("singular GF matrix")
            if piv != col:
                aug[col], aug[piv] = aug[piv], aug[col]
            ic = self.inv(aug[col][col])
            aug[col] = [self.mul(ic, v) for v in aug[col]]
            for r in range(n):
                if r != col and aug[r][col]:
                    f = aug[r][col]
                    aug[r] = [a ^ self.mul(f, b)
                              for a, b in zip(aug[r], aug[col])]
        return [row[n:] for row in aug]

    def mat_mul(self, A, B):
        rows, inner, cols = len(A), len(B), len(B[0])
        out = [[0] * cols for _ in range(rows)]
        for i in range(rows):
            for t in range(inner):
                a = A[i][t]
                if a:
                    Bt = B[t]
                    Oi = out[i]
                    for j in range(cols):
                        if Bt[j]:
                            Oi[j] ^= self.mul(a, Bt[j])
        return out

    # -- bit-matrix expansion ------------------------------------------
    def elem_bitmatrix(self, c: int) -> np.ndarray:
        """w x w 0/1 matrix B with bits(c*x) = B @ bits(x) mod 2
        (bit 0 = LSB).  Column s is the bits of c * x^s."""
        w = self.w
        B = np.zeros((w, w), np.uint8)
        for s in range(w):
            prod = self.mul(c, 1 << s)
            for b in range(w):
                B[b, s] = (prod >> b) & 1
        return B

    def expand_bitmatrix(self, M) -> np.ndarray:
        """(r, c) GF(2^w) matrix -> (w*r, w*c) 0/1 bit matrix —
        jerasure_matrix_to_bitmatrix semantics."""
        r, c = len(M), len(M[0])
        w = self.w
        out = np.zeros((w * r, w * c), np.uint8)
        for i in range(r):
            for j in range(c):
                if M[i][j]:
                    out[w * i:w * i + w, w * j:w * j + w] = \
                        self.elem_bitmatrix(int(M[i][j]))
        return out

    def n_ones(self, c: int) -> int:
        """cauchy_n_ones: ones in the element's bit matrix."""
        return int(self.elem_bitmatrix(c).sum())


# -- GF(2) bit-matrix algebra ------------------------------------------------


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


def poly_mul_matrix(j: int, w: int, check_poly: int) -> np.ndarray:
    """w x w 0/1 matrix of multiply-by-x^j in GF(2)[x]/(check_poly),
    where check_poly has degree w (bit w set).  Used by the Blaum-Roth
    construction over the ring mod M_p(x) = 1 + x + ... + x^(p-1)."""
    B = np.zeros((w, w), np.uint8)
    for s in range(w):
        # (x^s * x^j) mod check_poly
        v = 1 << (s + j)
        deg = v.bit_length() - 1
        while deg >= w:
            v ^= check_poly << (deg - w)
            deg = v.bit_length() - 1
        for b in range(w):
            B[b, s] = (v >> b) & 1
    return B
