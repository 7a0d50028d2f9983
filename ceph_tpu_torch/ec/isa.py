"""The isa plugin: RS over GF(2^8) with isa-l's generators, on K1.

The port of ``ceph_tpu/ec/isa.py``, after
src/erasure-code/isa/ErasureCodeIsa.{h,cc}: the same two techniques
(``reed_sol_van`` = isa-l gf_gen_rs_matrix Vandermonde, ``cauchy`` =
gf_gen_cauchy1_matrix), the same defaults (k=7, m=3,
ErasureCodeIsa.cc:46-47), the same Vandermonde MDS clamps (:331-360)
and 32-byte chunk alignment (xor_op.h:28, get_chunk_size :66-79).
Where isa-l runs table-driven SIMD GF multiplies (ec_encode_data, :129)
with an LRU decode-table cache (:227-304), the generator is expanded to
a GF(2) bit matrix once and applied by kernel K1; the decode matrix per
erasure signature is cached by ``engine.BitCode`` (the IsaTableCache
flow).  ``engine=native`` runs the native GF(2^8) engine instead.
"""

from __future__ import annotations

from . import matrices as M
from .interface import ErasureCodeError, ErasureCodeProfile
from .jerasure import SingleCode

EC_ISA_ADDRESS_ALIGNMENT = 32  # xor_op.h:28

DEFAULT_K = 7
DEFAULT_M = 3


class ErasureCodeIsa(SingleCode):
    """Both isa techniques; ``technique`` selects the generator."""

    def __init__(self, technique: str = "reed_sol_van", device="cuda"):
        super().__init__(device)
        self.technique = technique

    def init(self, profile: ErasureCodeProfile) -> None:
        profile["technique"] = self.technique
        self.parse(profile)
        self.prepare()
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        self.k = self.to_int("k", profile, DEFAULT_K)
        self.m = self.to_int("m", profile, DEFAULT_M)
        self.sanity_check_k_m(self.k, self.m)
        self._parse_engine(profile)
        if self.technique == "reed_sol_van":
            # isa-l's Vandermonde construction is not MDS everywhere;
            # clamp to the verified-safe region (ErasureCodeIsa.cc:331)
            if self.k > 32:
                raise ErasureCodeError(
                    -22, f"Vandermonde: k={self.k} must be <= 32")
            if self.m > 4:
                raise ErasureCodeError(
                    -22, f"Vandermonde: m={self.m} must be < 5 for MDS")
            if self.m == 4 and self.k > 21:
                raise ErasureCodeError(
                    -22, f"Vandermonde: k={self.k} must be < 22 at m=4")

    def prepare(self) -> None:
        if self.technique == "cauchy":
            full = M.isa_gf_gen_cauchy1_matrix(self.k, self.m)
        else:
            full = M.isa_gf_gen_rs_matrix(self.k, self.m)
        self._matrix_code(full[self.k:])

    # -- geometry (ErasureCodeIsa.cc:66-79) ---------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        return EC_ISA_ADDRESS_ALIGNMENT

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        chunk_size = (object_size + self.k - 1) // self.k
        modulo = chunk_size % alignment
        if modulo:
            chunk_size += alignment - modulo
        return chunk_size


def make_isa(profile: ErasureCodeProfile, device="cuda") -> ErasureCodeIsa:
    """Plugin factory (ErasureCodePluginIsa.cc:41-55 flow)."""
    technique = profile.get("technique", "reed_sol_van")
    if technique not in ("reed_sol_van", "cauchy"):
        raise ErasureCodeError(
            -2, f"technique={technique} must be reed_sol_van or cauchy")
    inst = ErasureCodeIsa(technique, device)
    inst.init(profile)
    return inst
