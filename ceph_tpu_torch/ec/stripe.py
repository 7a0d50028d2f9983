"""ECUtil: stripe math and the stripe-looped EC data path.

The port of ``ceph_tpu/ec/stripe.py``, after src/osd/ECUtil.{h,cc}:

- ``StripeInfo``: the logical <-> chunk offset arithmetic of
  ``stripe_info_t`` (ECUtil.h:27-80);
- ``encode``: ECUtil::encode (ECUtil.cc:123-162), every stripe of a
  buffer in one ``encode_chunks`` call (the per-shard concatenation the
  reference appends stripe by stripe is one reshape on the device);
- ``decode`` and ``recover_stripes``: ECUtil.cc:50-121, every stripe of
  the surviving shard runs decoded at once;
- ``HashInfo``: cumulative per-shard crc32c (ECUtil.h:164-180).

``crc32c`` is ceph_crc32c (Castagnoli, seed as passed, no final xor)
on the native slicing-by-8 engine (``native/crush_host.cpp``
``crc32c_sb8``, the port's host build, which raises if it cannot be
built); ``crc32c_table`` is the table walker it is held to.  Both run
on the host: a chunk on the card is copied back to be hashed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterable

import numpy as np
import torch

from .. import build
from .interface import ErasureCode, flat_u8


class StripeInfo:
    """stripe_info_t (ECUtil.h:27-80): ``stripe_size`` data chunks per
    stripe (k), ``stripe_width`` logical bytes per stripe."""

    def __init__(self, stripe_size: int, stripe_width: int):
        if stripe_width % stripe_size:
            raise ValueError("stripe_width must be a multiple of "
                             "stripe_size")
        self.stripe_width = stripe_width
        self.chunk_size = stripe_width // stripe_size

    def logical_offset_is_stripe_aligned(self, logical: int) -> bool:
        return logical % self.stripe_width == 0

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return ((offset + self.stripe_width - 1)
                // self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        rem = offset % self.stripe_width
        return offset + (self.stripe_width - rem) if rem else offset

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def offset_len_to_stripe_bounds(self, offset: int,
                                    length: int) -> tuple:
        off = self.logical_to_prev_stripe_offset(offset)
        ln = self.logical_to_next_stripe_offset((offset - off) + length)
        return off, ln


def sinfo_for(code: ErasureCode, stripe_unit: int = 4096) -> StripeInfo:
    """The OSD's stripe geometry for a code: chunk = stripe_unit bytes,
    width = k * stripe_unit (PGBackend::get_ec_stripe semantics)."""
    k = code.get_data_chunk_count()
    return StripeInfo(k, k * stripe_unit)


def encode(sinfo: StripeInfo, code: ErasureCode, data,
           want: Iterable[int] | None = None) -> Dict[int, torch.Tensor]:
    """ECUtil::encode: a logical buffer (a multiple of stripe_width) ->
    per-shard concatenated chunk buffers on the code's device, every
    stripe in one ``encode_chunks`` call."""
    buf = flat_u8(data)
    if buf.numel() % sinfo.stripe_width:
        raise ValueError("input must be stripe-aligned "
                         "(ECUtil.cc:133 assert)")
    k = code.get_data_chunk_count()
    n = code.get_chunk_count()
    cs = sinfo.chunk_size
    nstripes = buf.numel() // sinfo.stripe_width
    if want is None:
        want = range(n)
    if nstripes == 0:
        return {i: torch.zeros(0, dtype=torch.uint8, device=code.device)
                for i in want}
    # [stripe, chunk_j, byte] -> per-shard concatenation [chunk_j,
    # stripe*cs]: the reference's per-stripe loop with claim_append,
    # since byte lanes are independent in the code
    shard_data = buf.to(code.device).view(nstripes, k, cs) \
        .transpose(0, 1).reshape(k, nstripes * cs)
    chunks: Dict[int, torch.Tensor] = {
        code.chunk_index(i): shard_data[i] for i in range(k)}
    for i in range(k, n):
        chunks[code.chunk_index(i)] = torch.zeros(
            nstripes * cs, dtype=torch.uint8, device=code.device)
    code.encode_chunks(set(want), chunks)
    return {i: chunks[i] for i in want}


def decode(sinfo: StripeInfo, code: ErasureCode,
           to_decode: Dict[int, object],
           need: Iterable[int]) -> Dict[int, torch.Tensor]:
    """ECUtil::decode: per-shard concatenated slices in, the needed
    shard buffers out, every stripe decoded at once."""
    need = set(need)
    chunks = {i: flat_u8(v) for i, v in to_decode.items()}
    lengths = {v.numel() for v in chunks.values()}
    if len(lengths) != 1:
        raise ValueError("all shard buffers must be equal length")
    (length,) = lengths
    if length % sinfo.chunk_size:
        raise ValueError("shard buffers must be chunk-aligned")
    # feasibility via the code's own minimum_to_decode
    code.minimum_to_decode(need, set(chunks))
    out = code.decode(need, chunks)
    return {i: out[i] for i in need}


def recover_stripes(sinfo: StripeInfo, code: ErasureCode,
                    surviving: Dict[int, object],
                    lost: Iterable[int]) -> Dict[int, torch.Tensor]:
    """The batched recovery path (ECBackend::recover_object's shape,
    ECBackend.cc:757/589): the lost shards of a run of stripes from the
    survivors, in one decode."""
    return decode(sinfo, code, surviving, set(lost))


# -- crc32c (Castagnoli) and HashInfo (ECUtil.h:164-180) --------------------
#
# The table walker: the byte update s' = T[(s ^ b) & 0xFF] ^ (s >> 8) is
# GF(2)-linear, so crc(seed, block) = shift_B(seed) ^ crc(0, block), and
# crc(0, block) is an XOR of per-(position, byte) contributions: a numpy
# gather and XOR-reduce per block of 512 bytes, one table shift per block.

_CRC32C_POLY = 0x82F63B78
_CRC_BLOCK = 512
_crc_tables: dict = {}


def _crc_setup():
    if _crc_tables:
        return _crc_tables
    tbl = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        tbl[i] = c

    def shift1(v):  # advance one zero byte (vectorized)
        return tbl[v & np.uint32(0xFF)] ^ (v >> np.uint32(8))

    # pos[p, b]: crc(0, block with byte b at p, zeros elsewhere)
    pos = np.zeros((_CRC_BLOCK, 256), np.uint32)
    pos[_CRC_BLOCK - 1] = tbl
    for p in range(_CRC_BLOCK - 2, -1, -1):
        pos[p] = shift1(pos[p + 1])

    # shift_B as two 16-bit half-state tables
    basis = np.asarray([1 << i for i in range(32)], np.uint32)
    for _ in range(_CRC_BLOCK):
        basis = shift1(basis)
    idx = np.arange(1 << 16, dtype=np.uint32)
    sh_lo = np.zeros(1 << 16, np.uint32)
    sh_hi = np.zeros(1 << 16, np.uint32)
    for i in range(16):
        bit = (idx >> np.uint32(i)) & np.uint32(1)
        sh_lo ^= np.where(bit == 1, basis[i], np.uint32(0))
        sh_hi ^= np.where(bit == 1, basis[16 + i], np.uint32(0))
    _crc_tables.update(tbl=tbl, pos=pos, sh_lo=sh_lo, sh_hi=sh_hi)
    return _crc_tables


def _host_bytes(data) -> np.ndarray:
    """A contiguous uint8 array of ``data`` on the host."""
    return np.ascontiguousarray(flat_u8(data).cpu().numpy())


def crc32c_table(data, crc: int = 0xFFFFFFFF) -> int:
    """ceph_crc32c by the table walker (numpy)."""
    t = _crc_setup()
    buf = _host_bytes(data)
    s = int(crc) & 0xFFFFFFFF
    nb = len(buf) // _CRC_BLOCK
    if nb:
        blocks = buf[:nb * _CRC_BLOCK].reshape(nb, _CRC_BLOCK)
        contrib = t["pos"][np.arange(_CRC_BLOCK)[None, :], blocks]
        block_crcs = np.bitwise_xor.reduce(contrib, axis=1).tolist()
        sh_lo, sh_hi = t["sh_lo"], t["sh_hi"]
        for c in block_crcs:
            s = int(sh_lo[s & 0xFFFF]) ^ int(sh_hi[s >> 16]) ^ c
    tbl = t["tbl"]
    for b in buf[nb * _CRC_BLOCK:].tobytes():
        s = int(tbl[(s ^ b) & 0xFF]) ^ (s >> 8)
    return s


def _crc_fn():
    fn = build.load_host().crc32c_sb8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_uint32,
                       np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                       ctypes.c_int64]
        fn.restype = ctypes.c_uint32
    return fn


def crc32c(data, crc: int = 0xFFFFFFFF) -> int:
    """ceph_crc32c semantics (seed as passed, no final xor; the OSD
    uses -1), on the native slicing-by-8 engine."""
    buf = _host_bytes(data)
    return int(_crc_fn()(crc & 0xFFFFFFFF, buf, len(buf)))


class HashInfo:
    """Cumulative per-shard crc32c of everything appended
    (ECUtil.h:164-180)."""

    def __init__(self, n_shards: int):
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0xFFFFFFFF] * n_shards

    def append(self, old_size: int, to_append: Dict[int, object]) -> None:
        assert old_size == self.total_chunk_size
        sizes = {flat_u8(v).numel() for v in to_append.values()}
        assert len(sizes) == 1
        for shard, buf in to_append.items():
            self.cumulative_shard_hashes[shard] = crc32c(
                buf, self.cumulative_shard_hashes[shard])
        self.total_chunk_size += sizes.pop()

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]
