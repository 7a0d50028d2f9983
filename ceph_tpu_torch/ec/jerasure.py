"""The jerasure plugin: seven techniques on K1 and K3.

The port of ``ceph_tpu/ec/jerasure.py``, after
src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc}: the same technique
set (reed_sol_van, reed_sol_r6_op, cauchy_orig, cauchy_good, liberation,
blaum_roth, liber8tion), the same profile keys (k/m/w/packetsize/
jerasure-per-chunk-alignment/engine) and the same get_chunk_size and
alignment arithmetic (ErasureCodeJerasure.cc:80-104, :174-184,
:278-292), with the generators of ``matrices.py``.

``reed_sol_van`` and ``reed_sol_r6_op`` run on kernel K1 on the code's
device (w=16/32 over the chunks' virtual chunks), or at w=8 on the
native GF(2^8) engine with ``engine=native`` (-22 at w=16/32, as in
the reference).  The five packet techniques run on kernel K3.  On the
card K1 takes k*w/8 and m*w/8 up to 32 and K3 k, m up to 32 and w*k,
w*m up to 256: a wider profile raises ``ValueError`` there.
"""

from __future__ import annotations

from typing import Dict, Set

import numpy as np
import torch

from . import matrices as M
from .engine import BitCode, Layout
from .gfw import GFW
from .interface import ErasureCode, ErasureCodeError, ErasureCodeProfile
from .native_gf import ENGINES, NativeMatrixCode, engine_choice

LARGEST_VECTOR_WORDSIZE = 16  # ErasureCodeJerasure.cc:30

DEFAULT_K = 2
DEFAULT_M = 1
DEFAULT_W = 8
DEFAULT_PACKETSIZE = 2048

_PRIMES = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
           59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
           127, 131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181,
           191, 193, 197, 199, 211, 223, 227, 229, 233, 239, 241, 251,
           257}


def is_prime(v: int) -> bool:
    return v in _PRIMES


class SingleCode(ErasureCode):
    """A plugin whose parity is one systematic code ``self._code``
    (a ``BitCode`` on K1 or a ``NativeMatrixCode``): jerasure and isa."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.k = 0
        self.m = 0
        self.engine = ""
        self._code = None

    def _parse_engine(self, profile: ErasureCodeProfile) -> None:
        """profile ``engine=``: K1 on the code's device (empty,
        ``bitplane`` or ``pallas-fused``) or the native CPU engine."""
        self.engine = profile.get("engine", "")
        if self.engine and self.engine not in ENGINES:
            raise ErasureCodeError(
                -22, f"engine={self.engine} must be one of "
                     f"{list(ENGINES)}")

    def _matrix_code(self, coding_rows, w: int = 8) -> None:
        """The matrix code of ``coding_rows`` (m x k over GF(2^w)) on
        the profile's engine: the native engine (w=8 only) or the bit
        code in the word layout w."""
        if w == 8 and engine_choice(self.engine) == "native":
            self._code = NativeMatrixCode(self.k, self.m, coding_rows)
        else:
            cb = GFW(w).expand_bitmatrix(coding_rows)
            self._code = BitCode(self.k, self.m, cb, Layout(w),
                                 device=self.device)
        self.device = self._code.device

    # -- data path ----------------------------------------------------
    def _mesh_code(self):
        """The ``BitCode`` a mesh shards (not the native engine, which
        has no sharded path)."""
        return self._code if isinstance(self._code, BitCode) else None

    def encode_chunks(self, want_to_encode: Set[int],
                      chunks: Dict[int, torch.Tensor]) -> None:
        # the data rows are read where they lie (K1's row table)
        parity = self._code.encode(
            [chunks[self.chunk_index(i)] for i in range(self.k)])
        for i in range(self.m):
            chunks[self.chunk_index(self.k + i)] = parity[i]

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Dict[int, torch.Tensor],
                      decoded: Dict[int, torch.Tensor]) -> None:
        # chunks/decoded are keyed by ENCODED position; the code works
        # in internal (data-first) order: remap symmetrically with
        # encode_chunks so mapping= profiles decode correctly
        n = self.k + self.m
        inv = {self.chunk_index(i): i for i in range(n)}
        avail = {inv[c]: v for c, v in chunks.items()}
        erased = [i for i in range(n) if i not in avail]
        for i, buf in self._code.decode(erased, avail).items():
            decoded[self.chunk_index(i)] = buf


class ErasureCodeJerasure(SingleCode):
    """Common jerasure behavior; subclasses provide the bit code."""

    technique = "?"

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.w = 0
        self.per_chunk_alignment = False

    # -- profile ------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        profile["technique"] = self.technique
        self.parse(profile)
        self.prepare()
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        self.k = self.to_int("k", profile, DEFAULT_K)
        self.m = self.to_int("m", profile, DEFAULT_M)
        self.w = self.to_int("w", profile, self.default_w())
        self._parse_engine(profile)
        self._parse_mapping(profile)
        if self.chunk_mapping and \
                len(self.chunk_mapping) != self.k + self.m:
            self.chunk_mapping = []
            raise ErasureCodeError(
                -22, "mapping maps the wrong number of chunks")
        self.sanity_check_k_m(self.k, self.m)

    def default_w(self) -> int:
        return DEFAULT_W

    def prepare(self) -> None:
        raise NotImplementedError

    # -- geometry -----------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        raise NotImplementedError

    def get_chunk_size(self, object_size: int) -> int:
        """ErasureCodeJerasure.cc:80-104."""
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = (object_size + self.k - 1) // self.k
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k


class _MatrixTechnique(ErasureCodeJerasure):
    """RS matrix codes: w in {8, 16, 32}, word layout."""

    def get_alignment(self) -> int:
        """ErasureCodeJerasure.cc:174-184."""
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * 4  # sizeof(int)
        if (self.w * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def _make_code(self, coding_rows) -> None:
        if self.w != 8:
            if self.engine in ("native", "pallas-fused"):
                raise ErasureCodeError(
                    -22, f"engine={self.engine} requires w=8 "
                         f"(byte layout), have w={self.w}")
        self._matrix_code(coding_rows, self.w)


class ReedSolomonVandermonde(_MatrixTechnique):
    technique = "reed_sol_van"

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        if self.w not in (8, 16, 32):
            raise ErasureCodeError(
                -22, f"reed_sol_van: w={self.w} must be in {{8,16,32}}")
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", profile, False)

    def prepare(self) -> None:
        self._make_code(
            M.reed_sol_vandermonde_coding_matrix(self.k, self.m, self.w))


class ReedSolomonRAID6(_MatrixTechnique):
    technique = "reed_sol_r6_op"

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        if self.m != 2:
            raise ErasureCodeError(-22, "reed_sol_r6_op: m must be 2")
        if self.w not in (8, 16, 32):
            raise ErasureCodeError(
                -22, f"reed_sol_r6_op: w={self.w} must be in {{8,16,32}}")

    def default_w(self) -> int:
        return 8

    def prepare(self) -> None:
        self._make_code(M.reed_sol_r6_coding_matrix(self.k, self.w))


class _PacketTechnique(ErasureCodeJerasure):
    """Bitmatrix codes over w packet-rows of packetsize bytes."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.packetsize = 0

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.packetsize = self.to_int("packetsize", profile,
                                      DEFAULT_PACKETSIZE)
        if self.engine and self.engine != "bitplane":
            raise ErasureCodeError(
                -22, f"engine={self.engine}: packet/bitmatrix "
                     f"techniques run only on the bit-plane engine")

    def get_alignment(self) -> int:
        """Cauchy/liberation alignment (ErasureCodeJerasure.cc:278-292)."""
        if self.per_chunk_alignment:
            alignment = self.w * self.packetsize
            modulo = alignment % LARGEST_VECTOR_WORDSIZE
            if modulo:
                alignment += LARGEST_VECTOR_WORDSIZE - modulo
            return alignment
        alignment = self.k * self.w * self.packetsize * 4
        if (self.w * self.packetsize * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * self.packetsize \
                * LARGEST_VECTOR_WORDSIZE
        return alignment

    def _make_bit_code(self, coding_bm: np.ndarray) -> None:
        self._code = BitCode(self.k, self.m, coding_bm,
                             Layout(self.w, self.packetsize),
                             device=self.device)
        self.device = self._code.device


class CauchyOrig(_PacketTechnique):
    technique = "cauchy_orig"

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", profile, False)

    def prepare(self) -> None:
        mat = M.cauchy_original_coding_matrix(self.k, self.m, self.w)
        self._make_bit_code(GFW(self.w).expand_bitmatrix(mat))


class CauchyGood(CauchyOrig):
    technique = "cauchy_good"

    def prepare(self) -> None:
        mat = M.cauchy_good_coding_matrix(self.k, self.m, self.w)
        self._make_bit_code(GFW(self.w).expand_bitmatrix(mat))


class Liberation(_PacketTechnique):
    technique = "liberation"

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        if self.m != 2:
            raise ErasureCodeError(-22, "liberation: m must be 2")
        if self.k > self.w:
            raise ErasureCodeError(-22, "liberation: k must be <= w")
        if self.w <= 2 or not is_prime(self.w):
            raise ErasureCodeError(
                -22, f"liberation: w={self.w} must be prime > 2")
        if self.packetsize == 0:
            raise ErasureCodeError(-22, "liberation: packetsize required")
        if self.packetsize % 4:
            raise ErasureCodeError(
                -22, "liberation: packetsize must be a multiple of 4")

    def default_w(self) -> int:
        return 7

    def prepare(self) -> None:
        self._make_bit_code(
            M.liberation_coding_bitmatrix(self.k, self.w))


class BlaumRoth(Liberation):
    technique = "blaum_roth"

    def parse(self, profile: ErasureCodeProfile) -> None:
        _PacketTechnique.parse(self, profile)
        if self.m != 2:
            raise ErasureCodeError(-22, "blaum_roth: m must be 2")
        if self.k > self.w:
            raise ErasureCodeError(-22, "blaum_roth: k must be <= w")
        # w = 7 tolerated for Firefly compatibility
        # (ErasureCodeJerasure.cc:464-476)
        if self.w != 7 and (self.w <= 2 or not is_prime(self.w + 1)):
            raise ErasureCodeError(
                -22, f"blaum_roth: w+1={self.w + 1} must be prime")
        if self.packetsize == 0:
            raise ErasureCodeError(-22, "blaum_roth: packetsize required")

    def default_w(self) -> int:
        return 6

    def prepare(self) -> None:
        self._make_bit_code(
            M.blaum_roth_coding_bitmatrix(self.k, self.w))


class Liber8tion(_PacketTechnique):
    technique = "liber8tion"

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        if self.m != 2:
            raise ErasureCodeError(-22, "liber8tion: m must be 2")
        if self.w != 8:
            raise ErasureCodeError(-22, "liber8tion: w must be 8")
        if self.k > 8:
            raise ErasureCodeError(-22, "liber8tion: k must be <= 8")
        if self.packetsize == 0:
            raise ErasureCodeError(-22, "liber8tion: packetsize required")

    def default_w(self) -> int:
        return 8

    def prepare(self) -> None:
        self._make_bit_code(M.liber8tion_coding_bitmatrix(self.k))


TECHNIQUES = {
    cls.technique: cls
    for cls in (ReedSolomonVandermonde, ReedSolomonRAID6, CauchyOrig,
                CauchyGood, Liberation, BlaumRoth, Liber8tion)
}


def make_jerasure(profile: ErasureCodeProfile,
                  device="cuda") -> ErasureCodeJerasure:
    """Plugin factory (ErasureCodePluginJerasure.cc:84 flow)."""
    technique = profile.get("technique", "reed_sol_van")
    cls = TECHNIQUES.get(technique)
    if cls is None:
        raise ErasureCodeError(
            -2, f"technique={technique} is not a valid coding technique")
    inst = cls(device)
    inst.init(profile)
    return inst
