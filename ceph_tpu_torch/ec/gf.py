"""GF(2^8) arithmetic and Reed-Solomon matrix algebra (host side).

The reference delegates all Galois-field math to vendored libraries
(jerasure/gf-complete for the jerasure plugin, isa-l asm for the isa
plugin — both git submodules, absent from the checkout; see
src/erasure-code/jerasure/ErasureCodeJerasure.cc:156 and
src/erasure-code/isa/ErasureCodeIsa.cc:369 for how they are consumed).
This module is the from-scratch replacement: table-driven GF(2^8) on the
standard AES-adjacent polynomial 0x11d (the gf-complete/isa-l default for
w=8), plus the matrix constructions the plugins need:

- systematic Vandermonde generator (reed_sol_van semantics,
  ErasureCodeJerasure.cc:156-204 / isa-l gf_gen_rs_matrix)
- Cauchy generator (cauchy_good semantics, ErasureCodeJerasure.cc:259-336)
- Gauss-Jordan inversion for decode matrices
  (ErasureCodeIsa.cc:227-304 erasure-signature → table flow)

Everything here is numpy host code: tiny matrices, run once per
profile/erasure-pattern and cached.  The bulk data path is the GF(2)
bit-matmul kernel in ``gf2_kernels.py``.  This is the port's own copy of
``ceph_tpu/ec/gf.py``: the port imports nothing of ``ceph_tpu``.
"""

from __future__ import annotations

import numpy as np

GF_POLY = 0x11D
GF_SIZE = 256

# -- tables -----------------------------------------------------------------


def _build_tables():
    exp = np.zeros(512, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    log[0] = 0  # never used: guard zero explicitly
    return exp, log


GF_EXP, GF_LOG = _build_tables()

# full 256x256 multiplication table (64 KiB)
GF_MUL = np.zeros((256, 256), np.uint8)
_nz = np.arange(1, 256)
GF_MUL[1:, 1:] = GF_EXP[(GF_LOG[_nz][:, None] + GF_LOG[_nz][None, :]) % 255]


def gf_mul(a, b):
    """Elementwise GF(2^8) multiply of arrays/scalars."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    return GF_MUL[a, b]


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF inverse of 0")
    return int(GF_EXP[255 - GF_LOG[a]])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


def gf_matmul(A, B):
    """GF(2^8) matrix product (small host matrices)."""
    A = np.asarray(A, np.uint8)
    B = np.asarray(B, np.uint8)
    out = np.zeros((A.shape[0], B.shape[1]), np.uint8)
    for i in range(A.shape[0]):
        acc = np.zeros(B.shape[1], np.uint8)
        for t in range(A.shape[1]):
            acc ^= GF_MUL[A[i, t], B[t]]
        out[i] = acc
    return out


def gf_inv_matrix(M):
    """Gauss-Jordan inversion over GF(2^8); raises if singular."""
    M = np.asarray(M, np.uint8)
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
            raise np.linalg.LinAlgError("singular GF matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        inv = gf_inv(int(aug[col, col]))
        aug[col] = GF_MUL[np.uint8(inv), aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= GF_MUL[aug[r, col], aug[col]]
    return aug[:, n:].copy()


# -- generator matrices -----------------------------------------------------


def rs_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """Systematic RS generator: (k+m) x k, top k rows = identity.

    Built as a raw Vandermonde V[i,j] = i^j, then right-multiplied by the
    inverse of its top square so the code is systematic — the classical
    construction behind reed_sol_van (ErasureCodeJerasure.cc:156) and
    isa-l's gf_gen_rs_matrix (ErasureCodeIsa.cc:377).
    """
    if k + m > GF_SIZE:
        raise ValueError("k+m must be <= 256 for GF(2^8)")
    V = np.zeros((k + m, k), np.uint8)
    for i in range(k + m):
        for j in range(k):
            V[i, j] = gf_pow(i, j) if i else (1 if j == 0 else 0)
    top_inv = gf_inv_matrix(V[:k])
    G = gf_matmul(V, top_inv)
    assert np.array_equal(G[:k], np.eye(k, dtype=np.uint8))
    return G


def rs_cauchy_matrix(k: int, m: int) -> np.ndarray:
    """Systematic Cauchy generator: identity over a Cauchy block
    a[i,j] = 1/(x_i ^ y_j) (cauchy_orig/cauchy_good semantics,
    ErasureCodeJerasure.cc:259; isa-l gf_gen_cauchy1_matrix)."""
    if k + m > GF_SIZE:
        raise ValueError("k+m must be <= 256 for GF(2^8)")
    G = np.zeros((k + m, k), np.uint8)
    G[:k] = np.eye(k, dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            G[k + i, j] = gf_inv((k + i) ^ j)
    return G


# -- bit-matrix expansion (the GF(2) kernel's representation) ---------------

# mul-by-c over GF(2^8) is GF(2)-linear on the 8 bit planes; column s of
# the 8x8 bit matrix is the bits of c * 2^s.  A full (k+m,k) GF generator
# therefore expands to an (8m, 8k) 0/1 matrix, and encode becomes a plain
# mod-2 integer matmul over bit planes.  This is
# the same algebra as jerasure's bitmatrix/"schedule" technique
# (ErasureCodeJerasure.cc:259-336) recast as a dense matmul instead of an
# XOR schedule.

def gf_const_bitmatrix(c: int) -> np.ndarray:
    """8x8 0/1 matrix B with: bits(c*x) = B @ bits(x) mod 2 (bit 0 = LSB)."""
    B = np.zeros((8, 8), np.uint8)
    for s in range(8):
        prod = gf_mul(c, 1 << s)
        for b in range(8):
            B[b, s] = (int(prod) >> b) & 1
    return B


def expand_bitmatrix(M) -> np.ndarray:
    """Expand an (r, c) GF matrix into the (8r, 8c) GF(2) bit matrix."""
    M = np.asarray(M, np.uint8)
    r, c = M.shape
    out = np.zeros((8 * r, 8 * c), np.uint8)
    for i in range(r):
        for j in range(c):
            out[8 * i:8 * i + 8, 8 * j:8 * j + 8] = \
                gf_const_bitmatrix(int(M[i, j]))
    return out


# -- numpy reference encode/decode (the executable spec for rs.py) ----------


def encode_ref(G, data):
    """data: uint8[k, L] → parity uint8[m, L] using coding rows of G."""
    G = np.asarray(G, np.uint8)
    k = G.shape[1]
    coding = G[k:]
    out = np.zeros((coding.shape[0], data.shape[1]), np.uint8)
    for i in range(coding.shape[0]):
        for j in range(k):
            out[i] ^= GF_MUL[coding[i, j], data[j]]
    return out


def decode_matrix(G, present_rows, k: int) -> np.ndarray:
    """Rows of G for k surviving chunks, inverted: recovers data chunks.
    ``present_rows``: indices (into k+m) of the k survivors used."""
    G = np.asarray(G, np.uint8)
    sub = G[np.asarray(present_rows, np.int64)]
    return gf_inv_matrix(sub)


def decode_ref(G, chunks, erasures, k: int):
    """Reference decode: ``chunks`` dict chunk_index->uint8[L]; returns
    the reconstructed full data array uint8[k, L]."""
    present = sorted(i for i in chunks if i not in erasures)[:k]
    if len(present) < k:
        raise ValueError("not enough chunks to decode")
    inv = decode_matrix(G, present, k)
    stack = np.stack([chunks[i] for i in present])
    out = np.zeros((k, stack.shape[1]), np.uint8)
    for i in range(k):
        for t in range(k):
            out[i] ^= GF_MUL[inv[i, t], stack[t]]
    return out
