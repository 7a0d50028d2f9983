"""The native GF(2^8) engine: the EC plugins' CPU oracle.

The port of ``ceph_tpu/ec/native_gf.py``: RS encode and decode as
table-driven GF(2^8) matrix products (``native/crush_host.cpp``
``gf8_matmul``, OpenMP over output rows), the isa-l role on the host.
The library is the port's own host build (``build.load_host``); a build
that fails raises.

The engine rule differs from ``ceph_tpu``'s: there the native engine is
the default whenever it builds, and ``CEPH_TPU_EC_ENGINE`` moves every
plugin of a process.  Here a plugin runs kernel K1 on its device unless
its profile asks for ``engine=native``, an explicit CPU oracle that
never asks for a card; no environment variable is read, and nothing
falls back quietly.  Its parity bytes equal K1's by construction: both
apply the same generator matrices over the same field (0x11D).
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, Sequence

import numpy as np
import torch

from .. import build
from . import gf

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

ENGINES = ("native", "bitplane", "pallas-fused")


def _fn():
    fn = build.load_host().gf8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, _u8p, _u8p, _u8p,
                       ctypes.c_int64]
        fn.restype = ctypes.c_int
    return fn


def gf8_matmul(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(rows, k) GF(2^8) matrix @ u8[k, L] -> u8[rows, L]."""
    mat = np.ascontiguousarray(mat, np.uint8)
    data = np.ascontiguousarray(data, np.uint8)
    rows, k = mat.shape
    if data.ndim != 2 or data.shape[0] != k:
        raise ValueError(f"data must be [k={k}, L], got {data.shape}")
    out = np.empty((rows, data.shape[1]), np.uint8)
    _fn()(rows, k, mat, data, out, data.shape[1])
    return out


def engine_choice(profile_engine: str = "") -> str:
    """The engine behind a plugin's w=8 matrix techniques, from the
    profile's ``engine=`` key alone.  ``native`` is the host C engine
    (built here, or this raises); an empty key, ``bitplane`` or
    ``pallas-fused`` (``ceph_tpu``'s names for its device engines) is
    kernel K1 on the code's device, the plain version on the CPU."""
    if profile_engine and profile_engine not in ENGINES:
        raise RuntimeError(
            f"unknown EC engine {profile_engine!r}; have {list(ENGINES)}")
    if profile_engine == "native":
        build.load_host()
        return "native"
    return profile_engine or "bitplane"


def _host(data) -> np.ndarray:
    """A writable uint8 array from an array, a tensor or a sequence of
    rows (stacked)."""
    if isinstance(data, (list, tuple)):
        return np.stack([_host(r) for r in data])
    if isinstance(data, torch.Tensor):
        return data.cpu().numpy()
    arr = np.asarray(data, np.uint8)
    return arr if arr.flags.writeable else arr.copy()


class NativeMatrixCode:
    """``engine.BitCode``'s interface on the native engine, for the w=8
    matrix techniques (jerasure reed_sol_van/reed_sol_r6_op, isa).
    Takes arrays or tensors anywhere; returns CPU tensors."""

    device = torch.device("cpu")

    def __init__(self, k: int, m: int, coding_rows: np.ndarray):
        self.k, self.m = k, m
        rows = np.asarray(coding_rows, np.uint8)
        if rows.shape != (m, k):
            raise ValueError(f"coding rows must be {(m, k)}, got "
                             f"{rows.shape}")
        self.G = np.concatenate([np.eye(k, dtype=np.uint8), rows], axis=0)
        self._dec_cache: Dict[tuple, np.ndarray] = {}

    def encode(self, data) -> torch.Tensor:
        from .engine import _account

        data = _host(data)
        if data.shape[0] != self.k:
            raise ValueError(f"expected [k={self.k}, L], got {data.shape}")
        t0 = time.monotonic()
        out = gf8_matmul(self.G[self.k:], data)
        _account("encode", (), time.monotonic() - t0, int(data.size),
                 jitted=False)
        return torch.from_numpy(out)

    def decode_data(self, chunks: Dict[int, object]) -> torch.Tensor:
        avail = sorted(chunks)
        if len(avail) < self.k:
            raise ValueError("need at least k chunks")
        present = tuple(avail[:self.k])
        dm = self._dec_cache.get(present)
        if dm is None:
            dm = np.asarray(gf.decode_matrix(self.G, list(present), self.k),
                            np.uint8)
            if len(self._dec_cache) >= 512:  # IsaTableCache-style bound
                self._dec_cache.pop(next(iter(self._dec_cache)))
            self._dec_cache[present] = dm
        from .engine import _account

        stack = _host([chunks[i] for i in present])
        t0 = time.monotonic()
        out = gf8_matmul(dm, stack)
        _account("decode", (), time.monotonic() - t0, int(stack.size),
                 jitted=False)
        return torch.from_numpy(out)

    def decode(self, want: Sequence[int],
               chunks: Dict[int, object]) -> Dict[int, torch.Tensor]:
        have = {i: torch.from_numpy(_host(c)) for i, c in chunks.items()}
        missing = [i for i in want if i not in have]
        if missing:
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
