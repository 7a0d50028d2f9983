"""The SHEC plugin: shingled erasure coding, on K1.

The port of ``ceph_tpu/ec/shec.py``, after
src/erasure-code/shec/ErasureCodeShec.{h,cc}: k data chunks, m parity
chunks, durability c; each parity covers a shingled window of the data,
trading MDS-ness for cheaper single-chunk recovery.

- generator: the Vandermonde coding matrix with shingle windows zeroed
  (shec_reedsolomon_coding_matrix, :465-533), with the MULTIPLE
  technique's (m1, c1) split minimising recovery efficiency;
- decode: the search over parity subsets for the smallest invertible
  square recovery system (shec_make_decoding_matrix, :535-760; the
  determinant check is a GF inversion attempt), cached per (want,
  avails) signature (the ShecTableCache flow);
- minimum_to_decode: that search's row set (:71-124);
- geometry: chunk alignment k*w*4 (:275-278), parse constraints
  (c <= m <= k <= 12, k+m <= 20, :280-345).

Its three products (encode, decode, the re-encode of lost parity) are
(w*r, w*c) bit matrices applied in the word layout w (8, 16 or 32): on
kernel K1, with the survivors read where they lie (w=16/32 over their
virtual chunks, ``gf2_kernels.gf2_matmul_words``).  A decode system is
dup x dup with dup <= k <= 12; on the card K1 takes dup*w/8 up to 32,
so a w=16 code up to k=12 and a w=32 code up to k=8 (a wider one raises
``ValueError`` there).  Any other w falls back to 8, as the reference
does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import matrices as M
from .engine import DECODE_CACHE_SIZE, BitCode, apply, device_matrix
from .gfw import GFW
from .interface import ErasureCode, ErasureCodeError, ErasureCodeProfile
from .layout import Layout

DEFAULT_K = 4
DEFAULT_M = 3
DEFAULT_C = 2
DEFAULT_W = 8

SINGLE = 0
MULTIPLE = 1


def _recovery_efficiency1(k: int, m1: int, m2: int, c1: int,
                          c2: int) -> float:
    """shec_calc_recovery_efficiency1: average chunks read to recover
    one lost data chunk under the (m1,c1)/(m2,c2) split."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [10 ** 8] * k
    r_e1 = 0.0
    for m_i, c_i in ((m1, c1), (m2, c2)):
        for rr in range(m_i):
            start = ((rr * k) // m_i) % k
            end = (((rr + c_i) * k) // m_i) % k
            span = ((rr + c_i) * k) // m_i - (rr * k) // m_i
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], span)
                cc = (cc + 1) % k
            r_e1 += span
    return r_e1 + sum(r_eff_k)


def shec_coding_matrix(k: int, m: int, c: int, w: int,
                       technique: int = MULTIPLE) -> List[List[int]]:
    """shec_reedsolomon_coding_matrix (:465-533): Vandermonde rows with
    shingle windows zeroed."""
    if technique == MULTIPLE:
        c1_best, m1_best = -1, -1
        # the reference seeds this at 100.0; inf is equivalent on every
        # configuration the parse constraints admit, and safe beyond
        min_r_e1 = float("inf")
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                    continue
                if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                    continue
                r_e1 = _recovery_efficiency1(k, m1, m2, c1, c2)
                if r_e1 < min_r_e1:
                    min_r_e1 = r_e1
                    c1_best, m1_best = c1, m1
        m1, c1 = m1_best, c1_best
        m2, c2 = m - m1, c - c1
    else:
        m1, c1 = 0, 0
        m2, c2 = m, c

    mat = M.reed_sol_vandermonde_coding_matrix(k, m, w)
    for rr in range(m1):
        end = ((rr * k) // m1) % k
        start = (((rr + c1) * k) // m1) % k
        cc = start
        while cc != end:
            mat[rr][cc] = 0
            cc = (cc + 1) % k
    for rr in range(m2):
        end = ((rr * k) // m2) % k
        start = (((rr + c2) * k) // m2) % k
        cc = start
        while cc != end:
            mat[rr + m1][cc] = 0
            cc = (cc + 1) % k
    return mat


class ErasureCodeShec(ErasureCode):
    """technique MULTIPLE (the reference's default plugin flavor)."""

    def __init__(self, technique: int = MULTIPLE, device="cuda"):
        super().__init__(device)
        self.technique = technique
        self.k = 0
        self.m = 0
        self.c = 0
        self.w = DEFAULT_W
        self.matrix: List[List[int]] = []
        self._gf: Optional[GFW] = None
        self._code: Optional[BitCode] = None
        self._layout: Optional[Layout] = None
        self._dec_cache: Dict[Tuple, tuple] = {}
        # bit matrices of decode systems and parity re-encodes on the
        # device, with K1's fragments, by the rows they take
        self._bm_cache: Dict[Tuple, tuple] = {}

    # -- profile (:280-345) -------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        self.prepare()
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        has = [x in profile for x in ("k", "m", "c")]
        if not any(has):
            self.k, self.m, self.c = DEFAULT_K, DEFAULT_M, DEFAULT_C
        elif not all(has):
            raise ErasureCodeError(-22, "k, m, c must all be chosen")
        else:
            self.k = self.to_int("k", profile, DEFAULT_K)
            self.m = self.to_int("m", profile, DEFAULT_M)
            self.c = self.to_int("c", profile, DEFAULT_C)
        if self.k <= 0 or self.m <= 0 or self.c <= 0:
            raise ErasureCodeError(-22, "k, m, c must be positive")
        if self.m < self.c:
            raise ErasureCodeError(-22, f"c={self.c} must be <= m")
        if self.k > 12:
            raise ErasureCodeError(-22, f"k={self.k} must be <= 12")
        if self.k + self.m > 20:
            raise ErasureCodeError(-22, "k+m must be <= 20")
        if self.k < self.m:
            raise ErasureCodeError(-22, f"m={self.m} must be <= k")
        self.w = self.to_int("w", profile, DEFAULT_W)
        if self.w not in (8, 16, 32):
            self.w = DEFAULT_W  # the reference falls back, not errors

    def prepare(self) -> None:
        self.matrix = shec_coding_matrix(self.k, self.m, self.c,
                                         self.w, self.technique)
        self._gf = GFW(self.w)
        self._layout = Layout(self.w)
        self._code = BitCode(self.k, self.m,
                             self._gf.expand_bitmatrix(self.matrix),
                             self._layout, device=self.device)
        self.device = self._code.device
        self._dec_cache.clear()
        self._bm_cache.clear()

    # -- geometry -----------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        return self.k * self.w * 4  # :275-278

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    # -- the decoding-matrix search (:535-760) -------------------------
    def _search(self, want: List[int], avails: List[int]):
        """Returns (dup, rows, cols) — the smallest invertible square
        recovery system — plus the minimum chunk vector; None when
        unrecoverable."""
        k, m = self.k, self.m
        key = (tuple(want), tuple(avails))
        _MISS = "miss"
        hit = self._dec_cache.get(key, _MISS)
        if hit is not _MISS:  # cached None = known-unrecoverable
            return hit
        want = list(want)
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if self.matrix[i][j]:
                        want[j] = 1

        mindup, minp = k + 1, k + 1
        best_rows: List[int] = []
        best_cols: List[int] = []
        for pp in range(1 << m):
            p = [i for i in range(m) if pp >> i & 1]
            if len(p) > minp:
                continue
            if any(not avails[k + i] for i in p):
                continue
            tmprow = [0] * (k + m)
            tmpcol = [0] * k
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcol[i] = 1
            for i in p:
                tmprow[k + i] = 1
                for j in range(k):
                    if self.matrix[i][j]:
                        tmpcol[j] = 1
                        if avails[j]:
                            tmprow[j] = 1
            rows = [i for i in range(k + m) if tmprow[i]]
            cols = [j for j in range(k) if tmpcol[j]]
            if len(rows) != len(cols):
                continue
            dup = len(rows)
            if dup == 0:
                mindup, best_rows, best_cols = 0, [], []
                break
            if dup < mindup:
                sub = [[(1 if r == c_ else 0) if r < k
                        else self.matrix[r - k][c_] for c_ in cols]
                       for r in rows]
                try:
                    self._gf.mat_inv(sub)
                except np.linalg.LinAlgError:
                    continue
                mindup = dup
                best_rows, best_cols = rows, cols
                minp = len(p)
        if mindup == k + 1:
            self._dec_cache[key] = None
            return None

        minimum = [0] * (k + m)
        for r in best_rows:
            minimum[r] = 1
        for i in range(k):
            if want[i] and avails[i]:
                minimum[i] = 1
        for i in range(m):
            if want[k + i] and avails[k + i] and not minimum[k + i]:
                if any(self.matrix[i][j] and not want[j]
                       for j in range(k)):
                    minimum[k + i] = 1
        res = (mindup, best_rows, best_cols, minimum)
        self._dec_cache[key] = res
        return res

    def _minimum_to_decode(self, want_to_read: Set[int],
                           available: Set[int]) -> Set[int]:
        n = self.k + self.m
        want = [1 if i in want_to_read else 0 for i in range(n)]
        avails = [1 if i in available else 0 for i in range(n)]
        res = self._search(want, avails)
        if res is None:
            raise ErasureCodeError(-5, "shec: can't find recover "
                                       "matrix")
        _dup, _rows, _cols, minimum = res
        return {i for i in range(n) if minimum[i]}

    # -- data path ----------------------------------------------------
    def _product(self, key: Tuple, gf_rows: List[List[int]],
                 rows: List[torch.Tensor]) -> torch.Tensor:
        """The GF(2^w) rows ``gf_rows`` applied to the chunks ``rows``
        (read where they lie) by K1 in the word layout w:
        u8[len(gf_rows), L]."""
        mats = self._bm_cache.get(key)
        if mats is None:
            mats = device_matrix(self._gf.expand_bitmatrix(gf_rows),
                                 self.device, self._layout)
            if len(self._bm_cache) >= DECODE_CACHE_SIZE:
                self._bm_cache.pop(next(iter(self._bm_cache)))
            self._bm_cache[key] = mats
        bm, frag = mats
        self._layout.check(rows[0].shape[-1])
        return apply(self._layout, bm, frag, rows)

    def encode_chunks(self, want_to_encode: Set[int],
                      chunks: Dict[int, torch.Tensor]) -> None:
        parity = self._code.encode(
            [chunks[self.chunk_index(i)] for i in range(self.k)])
        for i in range(self.m):
            chunks[self.chunk_index(self.k + i)] = parity[i]

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Dict[int, torch.Tensor],
                      decoded: Dict[int, torch.Tensor]) -> None:
        """shec_matrix_decode (:757-814) on K1.  Encoded positions remap
        to internal (data-first) order symmetrically with
        encode_chunks."""
        n = self.k + self.m
        inv = {self.chunk_index(i): i for i in range(n)}
        chunks = {inv[c]: v for c, v in chunks.items()}
        want_to_read = {inv[c] for c in want_to_read}
        want = [0] * n
        avails = [0] * n
        for i in want_to_read:
            want[i] = 1
        for i in range(n):
            if i in chunks:
                avails[i] = 1
        res = self._search(want, avails)
        if res is None:
            raise ErasureCodeError(-5, "shec: can't find recover "
                                       "matrix")
        dup, rows, cols, _minimum = res
        if dup:
            need_idx = [i for i, c_ in enumerate(cols) if not avails[c_]]
            key = ("dec", tuple(rows), tuple(cols))
            dec_rows = None
            if key not in self._bm_cache:
                sub = [[(1 if r == c_ else 0) if r < self.k
                        else self.matrix[r - self.k][c_] for c_ in cols]
                       for r in rows]
                inv_m = self._gf.mat_inv(sub)
                dec_rows = [inv_m[i] for i in need_idx]
            out = self._product(key, dec_rows, [chunks[r] for r in rows])
            for idx, i in enumerate(need_idx):
                decoded[self.chunk_index(cols[i])] = out[idx]
        # re-encode WANTED erased parity from the (recovered) data it
        # touches (:807-812)
        erased_parity = [i for i in range(self.m)
                         if want[self.k + i] and not avails[self.k + i]]
        if erased_parity:
            out = self._product(
                ("par", tuple(erased_parity)),
                [self.matrix[i] for i in erased_parity],
                [decoded[self.chunk_index(j)] for j in range(self.k)])
            for idx, i in enumerate(erased_parity):
                decoded[self.chunk_index(self.k + i)] = out[idx]


def make_shec(profile: ErasureCodeProfile,
              device="cuda") -> ErasureCodeShec:
    """Plugin factory (ErasureCodePluginShec.cc flow): technique
    defaults to multiple."""
    tech = profile.get("technique", "multiple")
    if tech not in ("single", "multiple"):
        raise ErasureCodeError(
            -2, f"technique={tech} must be single or multiple")
    inst = ErasureCodeShec(SINGLE if tech == "single" else MULTIPLE,
                           device)
    inst.init(profile)
    return inst
