"""The EC execution engine: a GF(2)-linear code as one bit product.

The port of ``ceph_tpu/ec/engine.py``.  Every code is GF(2)-linear, so
encode is the coding bit matrix CB (w*m x w*k) applied to the k data
chunks' rows, and decode picks k surviving chunks, inverts their rows of
``[I; CB]`` over GF(2) on the host (cached per erasure signature, the
reference's ErasureCodeIsaTableCache flow), and applies the inverse.
The layout (``layout.Layout``) says what a row is, and which kernel
applies a matrix on the card:

- w=8 bytes: kernel K1 (``gf2_kernels.gf2_matmul_w8``);
- w=16/32 words: K1 over the chunks' virtual chunks
  (``gf2_kernels.gf2_matmul_words``);
- packets (w, packetsize): kernel K3 (``gf2_packet.gf2_packet``).

Each takes its kernel's plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import gf2_kernels, gf2_packet
from .gfw import gf2_mat_inv
from .layout import Layout

DECODE_CACHE_SIZE = 512  # erasure signatures kept per code


def device_matrix(bm: np.ndarray, device: torch.device,
                  layout: Layout = None):
    """A 0/1 bit matrix on ``device`` with its kernel's form of it (K1's
    fragments for a word or byte layout, K3's index lists for a packet
    layout; None on the CPU), for a caller that applies it many times.
    K1's fragments are built on the current stream, which is waited for
    once here, so a launch on any stream may use them."""
    t = torch.from_numpy(np.ascontiguousarray(bm, np.uint8)).to(device)
    if layout is not None and layout.is_packet:
        aux = gf2_packet.packet_lists(t, layout.w)
    else:
        aux = gf2_kernels.gf2_fragments(t)
    if aux is not None:
        torch.cuda.current_stream(device).synchronize()
    return t, aux


def apply(layout: Layout, bm: torch.Tensor, aux, data) -> torch.Tensor:
    """``bm`` applied in ``layout`` to ``data`` (u8[k, L], u8[B, k, L]
    or a sequence of k u8[L] rows, read where they lie) by the layout's
    route; ``aux`` from ``device_matrix``."""
    if layout.is_packet:
        return gf2_packet.gf2_packet(bm, data, layout.w, layout.packetsize,
                                     aux)
    if layout.w == 8:
        return gf2_kernels.gf2_matmul_w8(bm, data, aux)
    return gf2_kernels.gf2_matmul_words(bm, data, layout.w, aux)


class BitCode:
    """A systematic GF(2)-linear code executed as bit products.

    ``coding_bm``: (w*m, w*k) 0/1 coding bit matrix (rows produce the m
    parity chunks' rows from the k data chunks' rows) in ``layout``
    (w=8 bytes by default).  Tensors the methods return live on
    ``device``.
    """

    def __init__(self, k: int, m: int, coding_bm: np.ndarray,
                 layout: Layout = None, device="cuda"):
        self.device = resolve_device(device)
        self.k, self.m = k, m
        self.layout = layout if layout is not None else Layout(8)
        w = self.layout.w
        coding_bm = np.asarray(coding_bm, np.uint8) & 1
        if coding_bm.shape != (w * m, w * k):
            raise ValueError(f"coding bit matrix must be {(w * m, w * k)}, "
                             f"got {coding_bm.shape}")
        self.coding_bm = coding_bm
        self.full_bm = np.concatenate(
            [np.eye(w * k, dtype=np.uint8), coding_bm], axis=0)
        # the kernel's form of it: the matrix and its fragments or lists
        self._enc_dev, self._enc_frag = device_matrix(coding_bm, self.device,
                                                      self.layout)
        self._dec_cache: Dict[Tuple[int, ...], tuple] = {}

    def _tensor(self, data) -> torch.Tensor:
        t = torch.as_tensor(data, dtype=torch.uint8, device=self.device)
        return t.contiguous()

    def _apply(self, bm, aux, data) -> torch.Tensor:
        first = data[0] if isinstance(data, (list, tuple)) else data
        self.layout.check(first.shape[-1])
        return apply(self.layout, bm, aux, data)

    # -- encode -------------------------------------------------------
    def encode(self, data) -> torch.Tensor:
        """u8[k, L] (or a sequence of k u8[L] rows, read where they lie)
        -> parity u8[m, L]."""
        if isinstance(data, (list, tuple)):
            data = [self._tensor(r) for r in data]
        else:
            data = self._tensor(data)
            if data.dim() != 2 or data.shape[0] != self.k:
                raise ValueError(f"expected [k={self.k}, L], got "
                                 f"{tuple(data.shape)}")
        return self._apply(self._enc_dev, self._enc_frag, data)

    def encode_batched(self, stripes) -> torch.Tensor:
        """u8[B, k, L] -> parity u8[B, m, L] in one kernel launch.  The
        kernel indexes the stripes in place, so nothing is transposed or
        copied on the way (but a word layout's virtual chunks);
        byte-identical to B ``encode`` calls."""
        stripes = self._tensor(stripes)
        if stripes.dim() != 3 or stripes.shape[1] != self.k:
            raise ValueError(f"expected [B, k={self.k}, L], got "
                             f"{tuple(stripes.shape)}")
        return self._apply(self._enc_dev, self._enc_frag, stripes)

    def all_chunks(self, data) -> torch.Tensor:
        """u8[k, L] -> u8[k+m, L]: systematic data + parity."""
        data = self._tensor(data)
        return torch.cat([data, self.encode(data)], dim=0)

    # -- decode -------------------------------------------------------
    def _decode_mats(self, present: Tuple[int, ...]):
        """The GF(2) decode matrix for k survivors, inverted on the host
        and cached by erasure signature with its kernel's form of it:
        (inverse, fragments or lists or None)."""
        mats = self._dec_cache.get(present)
        if mats is None:
            w = self.layout.w
            rows = np.concatenate(
                [self.full_bm[c * w:(c + 1) * w] for c in present], axis=0)
            mats = device_matrix(gf2_mat_inv(rows), self.device,
                                 self.layout)
            if len(self._dec_cache) >= DECODE_CACHE_SIZE:
                self._dec_cache.pop(next(iter(self._dec_cache)))
            self._dec_cache[present] = mats
        return mats

    def decode_data(self, chunks: Dict[int, object]) -> torch.Tensor:
        """Recover all k data chunks u8[k, L] from any k available
        chunks.  ``chunks``: {chunk_id: u8[L]}."""
        avail = sorted(chunks)
        if len(avail) < self.k:
            raise ValueError("need at least k chunks")
        present = tuple(avail[:self.k])
        inv, aux = self._decode_mats(present)
        # the kernel reads the survivors where they lie (a table of row
        # pointers); nothing is stacked on the card but a word layout's
        # virtual chunks
        return self._apply(inv, aux,
                           [self._tensor(chunks[i]) for i in present])

    def decode(self, want: Sequence[int],
               chunks: Dict[int, object]) -> Dict[int, torch.Tensor]:
        """Reconstruct the wanted chunk ids (data and/or parity).
        Returns {chunk_id: u8[L]}."""
        have = {i: self._tensor(c) for i, c in chunks.items()}
        missing = [i for i in want if i not in have]
        if missing:
            if all(i in have for i in range(self.k)):
                # only parity is lost: the data rows are its input as
                # they are, and the inverse would be the identity
                data = [have[i] for i in range(self.k)]
            else:
                data = self.decode_data(have)
                for i in range(self.k):
                    if i not in have:
                        have[i] = data[i]
            if any(i >= self.k for i in missing):
                parity = self.encode(data)
                for i in missing:
                    if i >= self.k:
                        have[i] = parity[i - self.k]
        return {i: have[i] for i in want}
