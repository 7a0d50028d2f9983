"""Reed-Solomon encode/decode — a thin adapter over the one engine.

The port of ``ceph_tpu/ec/rs_jax.py``: RS(k, m) at w=8.  It picks the
generator matrix (the port's own ``gf`` copy), expands its coding rows
to a GF(2) bit matrix, and runs everything through ``engine.BitCode``.
"""

from __future__ import annotations

import numpy as np

from . import gf
from .engine import BitCode, Layout


class RSCode:
    """One (k, m, technique) code instance on ``device``."""

    def __init__(self, k: int, m: int, technique: str = "reed_sol_van",
                 device="cuda"):
        self.k = k
        self.m = m
        self.technique = technique
        if technique in ("reed_sol_van", "vandermonde"):
            self.G = gf.rs_vandermonde_matrix(k, m)
        elif technique in ("cauchy", "cauchy_good", "cauchy_orig"):
            self.G = gf.rs_cauchy_matrix(k, m)
        else:
            raise ValueError(f"unknown technique {technique!r}")
        self._bit = BitCode(k, m, gf.expand_bitmatrix(self.G[k:]),
                            Layout(8), device=device)
        self.device = self._bit.device

    # -- encode -------------------------------------------------------
    def encode(self, data):
        """u8[k, L] -> parity u8[m, L] (tensor on the code's device)."""
        return self._bit.encode(data)

    def encode_batched(self, stripes):
        """u8[B, k, L] -> parity u8[B, m, L], one kernel launch."""
        return self._bit.encode_batched(stripes)

    def encode_np(self, data) -> np.ndarray:
        return self.encode(data).cpu().numpy()

    # -- decode -------------------------------------------------------
    def decode(self, chunks, erasures):
        """chunks: dict chunk_index -> u8[L]; returns u8[k, L] data."""
        lost = set(erasures)
        avail = {i: c for i, c in chunks.items() if i not in lost}
        return self._bit.decode_data(avail)

    def decode_np(self, chunks, erasures) -> np.ndarray:
        return self.decode(chunks, erasures).cpu().numpy()

    def all_chunks(self, data):
        """u8[k, L] -> u8[k+m, L]: systematic data + parity."""
        return self._bit.all_chunks(data)
