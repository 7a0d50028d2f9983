"""Generator matrices for every EC technique the reference ships.

The port's own copy of ``ceph_tpu/ec/matrices.py`` (numpy, host side).
The reference delegates these to vendored submodules absent from its
checkout (jerasure/gf-complete for ErasureCodeJerasure.cc:156-515,
isa-l for ErasureCodeIsa.cc:369-421); each constructor re-derives the
published algorithm (Plank's jerasure 2.0, Intel isa-l).  Divergences
that cannot be re-derived (search-table codes) are noted on the
function.

A "matrix code" is the m x k GF(2^w) coding block (rows map data chunks
to parity chunks); a "bitmatrix code" is the (w*m) x (w*k) 0/1 block
over w packet rows per chunk (jerasure's schedule representation).  The
packet generators are here for the packet layouts, which the port does
not run yet (``ROADMAP.md`` queue 1 item 3).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .gfw import GFW, poly_mul_matrix

Matrix = List[List[int]]


# -- jerasure reed_sol.c ----------------------------------------------------


def reed_sol_extended_vandermonde_matrix(rows: int, cols: int,
                                         w: int) -> Matrix:
    """Extended Vandermonde: row 0 = e_0, last row = e_{cols-1}, middle
    rows are power progressions of i — the starting point of jerasure's
    reed_sol_van (published reed_sol.c algorithm)."""
    gf = GFW(w)
    if w < 30 and ((1 << w) < rows or (1 << w) < cols):
        raise ValueError("field too small")
    V = [[0] * cols for _ in range(rows)]
    V[0][0] = 1
    if rows == 1:
        return V
    V[rows - 1][cols - 1] = 1
    for i in range(1, rows - 1):
        a = 1
        for j in range(cols):
            V[i][j] = a
            a = gf.mul(a, i)
    return V


def reed_sol_big_vandermonde_distribution_matrix(rows: int, cols: int,
                                                 w: int) -> Matrix:
    """Systematize the extended Vandermonde by column elimination, then
    normalize so coding row 0 and coding column 0 are all ones — the
    published jerasure reed_sol.c pipeline, which yields a DIFFERENT
    (and reference-compatible) generator than classical
    top-square-inversion."""
    gf = GFW(w)
    if cols >= rows:
        raise ValueError("rows must exceed cols")
    d = reed_sol_extended_vandermonde_matrix(rows, cols, w)

    for i in range(1, cols):
        # pivot row with d[j][i] != 0, swap into row i
        j = next((r for r in range(i, rows) if d[r][i]), None)
        if j is None:
            raise np.linalg.LinAlgError("singular vandermonde")
        if j != i:
            d[i], d[j] = d[j], d[i]
        # scale COLUMN i so the pivot is 1
        if d[i][i] != 1:
            f = gf.inv(d[i][i])
            for r in range(rows):
                d[r][i] = gf.mul(f, d[r][i])
        # eliminate every other column of row i via column ops
        for j in range(cols):
            e = d[i][j]
            if j != i and e:
                for r in range(rows):
                    d[r][j] ^= gf.mul(e, d[r][i])

    # make coding row 0 (row `cols`) all ones by scaling columns
    for j in range(cols):
        t = d[cols][j]
        if t and t != 1:
            f = gf.inv(t)
            for r in range(cols, rows):
                d[r][j] = gf.mul(f, d[r][j])
    # make coding column 0 all ones by scaling rows
    for i in range(cols + 1, rows):
        t = d[i][0]
        if t and t != 1:
            f = gf.inv(t)
            d[i] = [gf.mul(v, f) for v in d[i]]
    return d


def reed_sol_vandermonde_coding_matrix(k: int, m: int, w: int) -> Matrix:
    """jerasure reed_sol_van generator: the m coding rows
    (ErasureCodeJerasure.cc:204 prepare())."""
    dist = reed_sol_big_vandermonde_distribution_matrix(k + m, k, w)
    return dist[k:]


def reed_sol_r6_coding_matrix(k: int, w: int) -> Matrix:
    """RAID6: P = XOR, Q = sum 2^j d_j (reed_sol_r6_op,
    ErasureCodeJerasure.cc:256)."""
    gf = GFW(w)
    p_row = [1] * k
    q_row = [gf.pow(2, j) for j in range(k)]
    return [p_row, q_row]


# -- jerasure cauchy.c ------------------------------------------------------


def cauchy_original_coding_matrix(k: int, m: int, w: int) -> Matrix:
    """cauchy_orig: a[i][j] = 1/(i ^ (m+j)) (ErasureCodeJerasure.cc:321)."""
    gf = GFW(w)
    if w < 31 and (k + m) > (1 << w):
        raise ValueError("field too small")
    return [[gf.inv(i ^ (m + j)) for j in range(k)] for i in range(m)]


def cauchy_good_coding_matrix(k: int, m: int, w: int) -> Matrix:
    """cauchy_good: the original Cauchy matrix normalized to minimize
    bitmatrix ones — first scale columns so row 0 is all ones, then for
    each later row try every element's inverse as a row scale and keep
    the best (published improve_coding_matrix).

    Divergence note: for m=2 and small k the published jerasure uses a
    hard-coded table of searched optimal elements (cbest_*); that table
    is part of the absent submodule, so this implementation always uses
    the general improvement path.  The code remains MDS and
    self-consistent (decode uses the same matrix); XOR-schedule cost —
    which the bit-matmul path does not depend on — may differ."""
    gf = GFW(w)
    mat = cauchy_original_coding_matrix(k, m, w)
    # scale columns so row 0 is all ones
    for j in range(k):
        if mat[0][j] != 1:
            f = gf.inv(mat[0][j])
            for i in range(m):
                mat[i][j] = gf.mul(mat[i][j], f)
    # scale each later row to minimize total bitmatrix ones
    for i in range(1, m):
        best = sum(gf.n_ones(v) for v in mat[i])
        best_j = -1
        for j in range(k):
            if mat[i][j] != 1:
                f = gf.inv(mat[i][j])
                tot = sum(gf.n_ones(gf.mul(v, f)) for v in mat[i])
                if tot < best:
                    best, best_j = tot, j
        if best_j >= 0:
            f = gf.inv(mat[i][best_j])
            mat[i] = [gf.mul(v, f) for v in mat[i]]
    return mat


# -- bitmatrix (schedule) codes ---------------------------------------------


def liberation_coding_bitmatrix(k: int, w: int) -> np.ndarray:
    """Liberation RAID6 bitmatrix (Plank 2008; liberation.c): P block =
    identities; Q block for drive j = the (i, (i+j) mod w) diagonal
    permutation plus, for j>0, one extra bell bit at row
    i0 = j*(w-1)/2 mod w, column (i0+j-1) mod w.  Returns the
    (2w, k*w) coding bitmatrix.  Requires prime w > 2, k <= w."""
    if k > w:
        raise ValueError("liberation needs k <= w")
    bm = np.zeros((2 * w, k * w), np.uint8)
    for j in range(k):
        # P: identity
        for i in range(w):
            bm[i, j * w + i] = 1
        # Q: shifted diagonal
        for i in range(w):
            bm[w + i, j * w + (j + i) % w] = 1
        if j > 0:
            i0 = (j * ((w - 1) // 2)) % w
            bm[w + i0, j * w + (i0 + j - 1) % w] = 1
    return bm


def blaum_roth_coding_bitmatrix(k: int, w: int) -> np.ndarray:
    """Blaum-Roth RAID6 over the ring GF(2)[x]/M_p(x) with p = w+1
    prime, M_p(x) = 1 + x + ... + x^(w): P block = identity, Q block for
    drive j = multiply-by-x^j in the ring (the canonical Blaum-Roth 1993
    construction behind blaum_roth_coding_bitmatrix,
    ErasureCodeJerasure.cc:471).  Returns the (2w, k*w) coding block."""
    if k > w:
        raise ValueError("blaum_roth needs k <= w")
    mp = (1 << (w + 1)) - 1 >> 0  # x^w + ... + x + 1 has bits 0..w set
    bm = np.zeros((2 * w, k * w), np.uint8)
    for j in range(k):
        for i in range(w):
            bm[i, j * w + i] = 1
        bm[w:2 * w, j * w:(j + 1) * w] = poly_mul_matrix(j, w, mp)
    return bm


def liber8tion_coding_bitmatrix(k: int) -> np.ndarray:
    """liber8tion-equivalent RAID6 bitmatrix at w=8, k <= 8.

    Divergence note: the published liber8tion code is a table of
    minimal-XOR matrices found by search (part of the absent jerasure
    submodule and not re-derivable); this implementation provides the
    same contract (m=2, w=8, k<=8, MDS, bitmatrix technique) using
    multiply-by-g^j GF(2^8) blocks for the Q row.  XOR-schedule cost
    differs; the bit-matmul path does not depend on it."""
    w = 8
    if k > w:
        raise ValueError("liber8tion needs k <= 8")
    gf = GFW(8)
    bm = np.zeros((2 * w, k * w), np.uint8)
    for j in range(k):
        for i in range(w):
            bm[i, j * w + i] = 1
        bm[w:2 * w, j * w:(j + 1) * w] = gf.elem_bitmatrix(gf.pow(2, j))
    return bm


# -- isa-l ec_base.c --------------------------------------------------------


def isa_gf_gen_rs_matrix(k: int, m: int) -> Matrix:
    """isa-l gf_gen_rs_matrix semantics (ErasureCodeIsa.cc:377,
    matrixtype Vandermonde): full (k+m) x k with identity top; coding
    row i is the power progression of gen = 2^i.  NOT guaranteed MDS
    for large k+m — same caveat as isa-l; the isa plugin's default
    (k=7, m=3) is safe."""
    gf = GFW(8)
    a = [[1 if i == j else 0 for j in range(k)] for i in range(k)]
    gen = 1
    for _ in range(m):
        p = 1
        row = []
        for _j in range(k):
            row.append(p)
            p = gf.mul(p, gen)
        a.append(row)
        gen = gf.mul(gen, 2)
    return a


def isa_gf_gen_cauchy1_matrix(k: int, m: int) -> Matrix:
    """isa-l gf_gen_cauchy1_matrix semantics (ErasureCodeIsa.cc:379):
    identity top, coding element [i][j] = 1/(i ^ j) for i >= k."""
    gf = GFW(8)
    a = [[1 if i == j else 0 for j in range(k)] for i in range(k)]
    for i in range(k, k + m):
        a.append([gf.inv(i ^ j) for j in range(k)])
    return a
