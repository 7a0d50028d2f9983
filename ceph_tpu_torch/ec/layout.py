"""Chunk bytes <-> GF(2) rows for every EC layout, as plain PyTorch ops.

The port of ``ceph_tpu/ec/engine.py``'s ``Layout`` (l.150-215) and
``_mod2_matmul`` (l.124).  A GF(2)-linear code applies a (w*m, w*k) 0/1
bit matrix to the k data chunks' rows; the layout says what a row is:

- w=8: each byte is 8 LSB-first bit planes (row ``8c + s`` is bit s of
  chunk c's bytes);
- w=16/32: each chunk is little-endian w-bit words, row ``c*w + 8t + s``
  is bit s of byte t of every word;
- a packet layout (w, packetsize): each chunk is blocks of w packets of
  packetsize bytes, row ``c*w + r`` is packet r of every block, and the
  byte's 8 bits fold into the row's columns, so the product XORs whole
  packets bytewise.

``to_rows``, ``mod2_matmul`` and ``from_rows`` are the plain versions of
the card's routes (``gf2_kernels.gf2_matmul_w8`` for w=8,
``gf2_kernels.gf2_matmul_words`` for w=16/32, ``gf2_packet.gf2_packet``
for packets) and their path on CPU tensors.  Every function takes
leading batch dimensions.  Bits stay in uint8 and the product runs in
float32, which is exact: a sum is at most w*k < 2^24.
"""

from __future__ import annotations

import torch


def _bits8(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def mod2_matmul(bm: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(R, C) 0/1 @ (..., C, N) 0/1 -> (..., R, N) 0/1 uint8."""
    acc = torch.matmul((bm & 1).to(torch.float32), rows.to(torch.float32))
    return (acc.to(torch.int32) & 1).to(torch.uint8)


class Layout:
    """Chunk bytes <-> GF(2) rows for one code family: the w=8 byte
    layout, the w=16/32 word layouts, or a packet layout (any w >= 1,
    ``packetsize`` > 0)."""

    def __init__(self, w: int, packetsize: int = 0):
        if packetsize < 0 or w < 1 or (not packetsize
                                        and w not in (8, 16, 32)):
            raise ValueError(f"no layout for w={w} packetsize={packetsize}: "
                             f"words are 8, 16 or 32 bits")
        self.w = w
        self.packetsize = packetsize
        self.is_packet = packetsize > 0

    def check(self, L: int) -> None:
        if self.is_packet:
            blk = self.w * self.packetsize
            if L % blk:
                raise ValueError(
                    f"chunk size {L} not a multiple of w*packetsize={blk}")
        elif L % (self.w // 8):
            raise ValueError(f"chunk size {L} not a multiple of word size "
                             f"{self.w // 8}")

    def to_rows(self, chunks: torch.Tensor) -> torch.Tensor:
        """u8[..., n, L] -> 0/1 u8[..., n*w, N]: each chunk becomes w
        GF(2) rows."""
        *lead, n, L = chunks.shape
        w, bits = self.w, _bits8(chunks.device)
        if self.is_packet:
            ps = self.packetsize
            nb = L // (w * ps)
            r = chunks.reshape(*lead, n, nb, w, ps).transpose(-3, -2)
            r = r.reshape(*lead, n * w, nb * ps)
            planes = (r.unsqueeze(-2) >> bits[:, None]) & 1
            return planes.reshape(*lead, n * w, 8 * nb * ps)
        if w == 8:
            planes = (chunks.unsqueeze(-2) >> bits[:, None]) & 1
            return planes.reshape(*lead, 8 * n, L)
        wb = w // 8
        nw = L // wb
        words = chunks.reshape(*lead, n, nw, wb)
        planes = (words.unsqueeze(-1) >> bits) & 1   # [..., n, nw, wb, 8]
        planes = planes.movedim(-3, -1)              # [..., n, wb, 8, nw]
        return planes.reshape(*lead, n * w, nw)

    def from_rows(self, rows: torch.Tensor, n: int, L: int) -> torch.Tensor:
        """Inverse of ``to_rows`` for n chunks of L bytes."""
        lead = rows.shape[:-2]
        w, bits = self.w, _bits8(rows.device)
        if self.is_packet:
            ps = self.packetsize
            nb = L // (w * ps)
            planes = rows.reshape(*lead, n * w, 8, nb * ps)
            by = (planes << bits[:, None]).sum(-2, dtype=torch.uint8)
            by = by.reshape(*lead, n, w, nb, ps).transpose(-3, -2)
            return by.reshape(*lead, n, L)
        if w == 8:
            planes = rows.reshape(*lead, n, 8, L)
            return (planes << bits[:, None]).sum(-2, dtype=torch.uint8)
        wb = w // 8
        nw = L // wb
        planes = rows.reshape(*lead, n, wb, 8, nw).movedim(-1, -3)
        by = (planes << bits).sum(-1, dtype=torch.uint8)  # [..., n, nw, wb]
        return by.reshape(*lead, n, L)

    def apply_plain(self, bm: torch.Tensor, data: torch.Tensor
                    ) -> torch.Tensor:
        """The bit matrix (w*m, w*k) applied to u8[..., k, L] ->
        u8[..., m, L] by ``to_rows``, ``mod2_matmul`` and ``from_rows``:
        the plain version of every route."""
        L = data.shape[-1]
        self.check(L)
        m = bm.shape[0] // self.w
        return self.from_rows(mod2_matmul(bm, self.to_rows(data)), m, L)
