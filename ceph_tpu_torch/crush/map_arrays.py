"""Flat array (SoA) encoding of a CrushMap for the batched mapper.

The port's copy of ``ceph_tpu/crush/map_arrays.py``, limited to the
fields the straw2 rule walk reads.  Every bucket is a row indexed by
bucket index (-1 - id), every per-item field a column padded to the
widest bucket.  ``encode_map`` lowers a map to numpy; ``to_device``
moves the arrays to tensors, with u32 fields carried as int32 bit
patterns (torch has no u32 arithmetic; the kernel reads them back as
u32 and the plain version widens them to int64).  The kernel's straw2
reciprocals (``MapArrays.magic``) are derived from the item weights,
never stored beside them.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Tuple

import numpy as np
import torch

from . import constants as C
from .ln import straw2_magic
from .map import CrushMap


@dataclass(frozen=True)
class MapStatic:
    """Facts about a map that shape the computation."""

    max_buckets: int
    max_devices: int
    max_size: int
    algs_present: Tuple[int, ...]
    hashes_present: Tuple[int, ...]
    has_choose_args: bool
    tunables: Tuple[int, int, int, int, int, int]


@dataclass
class MapArrays:
    """The map as arrays (numpy from ``encode_map``, tensors from
    ``to_device``)."""

    alg: object       # i32[B]   0 = no bucket at this index
    btype: object     # i32[B]
    size: object      # i32[B]
    items: object     # i32[B,S]
    weights: object   # u32[B,S] 16.16 per-item weights

    @property
    def magic(self):
        """u64[B,S] ``straw2_magic(weights)``: the kernel's division-free
        reciprocal of each item weight (numpy u64 for numpy weights,
        int64 bit patterns on the weights' device for a tensor).

        ``weights`` is the one source: the magic is recomputed whenever
        they are a new object or a tensor written in place (its
        ``_version`` moved), so the kernel and the plain walk, which
        divides by ``weights``, cannot disagree."""
        w = self.weights
        if not isinstance(w, torch.Tensor):
            return straw2_magic(w)
        cached = self.__dict__.get("_magic")
        if cached is None or cached[0] is not w or cached[1] != w._version:
            m = straw2_magic(w.detach().cpu().numpy())
            cached = (w, w._version,
                      torch.from_numpy(m.view(np.int64)).to(w.device))
            self.__dict__["_magic"] = cached
        return cached[2]


def _pad2(rows, width, dtype):
    out = np.zeros((len(rows), width), dtype=dtype)
    for i, r in enumerate(rows):
        if len(r):
            out[i, :len(r)] = r
    return out


def encode_map(cmap: CrushMap, has_choose_args: bool = False
               ) -> Tuple[MapStatic, MapArrays]:
    """Lower a host CrushMap to the SoA view."""
    B = cmap.max_buckets
    bkts = cmap.buckets
    S = max([1] + [b.size for b in bkts.values()])
    alg = np.zeros(B, np.int32)
    btype = np.zeros(B, np.int32)
    bhash = np.zeros(B, np.int32)
    size = np.zeros(B, np.int32)
    items_rows, w_rows = [], []
    for i in range(B):
        b = bkts.get(i)
        if b is None:
            items_rows.append([])
            w_rows.append([])
            continue
        alg[i], btype[i], bhash[i] = b.alg, b.type, b.hash
        size[i] = b.size
        items_rows.append(b.items)
        w_rows.append([b.item_weight] * b.size
                      if b.alg == C.CRUSH_BUCKET_UNIFORM else b.item_weights)
    t = cmap.tunables
    static = MapStatic(
        max_buckets=B,
        max_devices=cmap.max_devices,
        max_size=S,
        algs_present=tuple(sorted(set(int(a) for a in alg if a))),
        hashes_present=tuple(sorted(set(
            int(h) for h, a in zip(bhash, alg) if a))),
        has_choose_args=has_choose_args,
        tunables=(t.choose_local_tries, t.choose_local_fallback_tries,
                  t.choose_total_tries, t.chooseleaf_descend_once,
                  t.chooseleaf_vary_r, t.chooseleaf_stable),
    )
    arrays = MapArrays(alg=alg, btype=btype, size=size,
                       items=_pad2(items_rows, S, np.int32),
                       weights=_pad2(w_rows, S, np.uint32))
    return static, arrays


def as_i32(v, device) -> torch.Tensor:
    """Integer data (numpy, list or tensor; u32 values kept as their
    bit pattern) as a contiguous int32 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.uint32:
            v = v.view(torch.int32)
        elif v.dtype != torch.int32:
            v = v.to(torch.int64) & 0xFFFFFFFF
            v = torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)
        return v.to(device).contiguous()
    a = np.asarray(v)
    if a.dtype != np.int32:
        a = a.astype(np.int64).astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_device(arrays: MapArrays, device) -> MapArrays:
    """The arrays as int32 tensors on ``device``."""
    return MapArrays(**{f.name: as_i32(getattr(arrays, f.name), device)
                        for f in fields(MapArrays)})
