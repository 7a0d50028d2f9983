"""Flat array (SoA) encoding of a CrushMap for the batched mapper.

The port's copy of ``ceph_tpu/crush/map_arrays.py``, with the fields
that the kernel and the plain walk read (the JAX layout's ``bhash``,
``bid`` and ``has_arg`` are not carried: a bucket's id is ``-1 -
index``, and ``MapStatic.hashes_present`` says which hashes occur).  Every bucket is a row indexed by bucket index (-1 - id), every
per-item field a column padded to the widest bucket, the choose_args
weight sets a [B, P, S] block.  ``encode_map`` lowers a map to numpy;
``to_device`` moves the arrays to tensors, with u32 fields carried as
int32 bit patterns (torch has no u32 arithmetic; the kernel reads them
back as u32 and the plain version widens them to int64).  The kernel's
straw2 reciprocals (``MapArrays.magic`` and ``arg_magic``) are derived
from the weights straw2 reads, never stored beside them.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch

from . import constants as C
from .ln import straw2_magic
from .map import ChooseArgMap, CrushMap


@dataclass(frozen=True)
class MapStatic:
    """Facts about a map that shape the computation."""

    max_buckets: int
    max_devices: int
    max_size: int        # padded item width S
    algs_present: Tuple[int, ...]
    hashes_present: Tuple[int, ...]
    has_choose_args: bool
    tunables: Tuple[int, int, int, int, int, int]


@dataclass
class MapArrays:
    """The map as arrays (numpy from ``encode_map``, tensors from
    ``to_device``)."""

    alg: object           # i32[B]     0 = no bucket at this index
    btype: object         # i32[B]
    size: object          # i32[B]
    nnodes: object        # i32[B]     tree num_nodes
    items: object         # i32[B,S]
    weights: object       # u32[B,S]   16.16 item weights (uniform: repeated)
    sum_weights: object   # u32[B,S]   list head prefix sums
    straws: object        # u32[B,S]   legacy straw lengths
    node_weights: object  # u32[B,N]   tree node weights
    arg_ids: object       # i32[B,S]   choose_args ids (else the items)
    arg_weights: object   # u32[B,P,S] choose_args weight sets (else weights)

    def _magic_of(self, name: str):
        """``straw2_magic`` of the weights field ``name`` (numpy u64 for
        numpy weights, int64 bit patterns on the weights' device for a
        tensor), recomputed whenever the field is a new object or a
        tensor written in place (its ``_version`` moved)."""
        w = getattr(self, name)
        if not isinstance(w, torch.Tensor):
            return straw2_magic(w)
        key = "_magic_" + name
        cached = self.__dict__.get(key)
        if cached is None or cached[0] is not w or cached[1] != w._version:
            m = straw2_magic(w.detach().cpu().numpy())
            cached = (w, w._version,
                      torch.from_numpy(m.view(np.int64)).to(w.device))
            self.__dict__[key] = cached
        return cached[2]

    @property
    def magic(self):
        """u64[B,S] ``straw2_magic(weights)``: the kernel's division-free
        reciprocal of each item weight.  ``weights`` is the one source,
        so the kernel and the plain walk, which divides by ``weights``,
        cannot disagree."""
        return self._magic_of("weights")

    @property
    def arg_magic(self):
        """u64[B,P,S] ``straw2_magic(arg_weights)``: the reciprocals of
        the choose_args weight sets, which straw2 reads in place of
        ``weights`` when the map has choose_args."""
        return self._magic_of("arg_weights")


def _pad2(rows, width, dtype):
    out = np.zeros((len(rows), width), dtype=dtype)
    for i, r in enumerate(rows):
        if len(r):
            out[i, :len(r)] = r
    return out


def encode_map(cmap: CrushMap, choose_args: Optional[ChooseArgMap] = None
               ) -> Tuple[MapStatic, MapArrays]:
    """Lower a host CrushMap (and an optional choose_args set) to the
    SoA view, field for field as ``ceph_tpu``'s ``encode_map``."""
    B = cmap.max_buckets
    bkts = cmap.buckets
    S = max([1] + [b.size for b in bkts.values()])
    N = max([1] + [b.num_nodes for b in bkts.values()
                   if b.alg == C.CRUSH_BUCKET_TREE])
    P = max([1] + [len(a.weight_set) for a in (choose_args or {}).values()
                   if a.weight_set is not None])
    alg = np.zeros(B, np.int32)
    btype = np.zeros(B, np.int32)
    size = np.zeros(B, np.int32)
    nnodes = np.zeros(B, np.int32)
    rows = {k: [] for k in ("items", "w", "sw", "straws", "nodes", "ids")}
    arg_w = np.zeros((B, P, S), np.uint32)
    for i in range(B):
        b = bkts.get(i)
        if b is None:
            for r in rows.values():
                r.append([])
            continue
        alg[i], btype[i] = b.alg, b.type
        size[i], nnodes[i] = b.size, b.num_nodes
        w = ([b.item_weight] * b.size if b.alg == C.CRUSH_BUCKET_UNIFORM
             else b.item_weights)
        rows["items"].append(b.items)
        rows["w"].append(w)
        rows["sw"].append(b.sum_weights)
        rows["straws"].append(b.straws)
        rows["nodes"].append(b.node_weights)
        ids, wset = b.items, None
        a = (choose_args or {}).get(i)
        if a is not None:
            if a.ids is not None:
                ids = a.ids
            wset = a.weight_set
        rows["ids"].append(ids)
        for p in range(P):
            row = w if wset is None else wset[min(p, len(wset) - 1)]
            arg_w[i, p, :len(row)] = row
    t = cmap.tunables
    present = [int(a) for a in alg if a]
    static = MapStatic(
        max_buckets=B,
        max_devices=cmap.max_devices,
        max_size=S,
        algs_present=tuple(sorted(set(present))),
        hashes_present=tuple(sorted(set(b.hash for b in bkts.values()))),
        has_choose_args=bool(choose_args),
        tunables=(t.choose_local_tries, t.choose_local_fallback_tries,
                  t.choose_total_tries, t.chooseleaf_descend_once,
                  t.chooseleaf_vary_r, t.chooseleaf_stable),
    )
    arrays = MapArrays(
        alg=alg, btype=btype, size=size, nnodes=nnodes,
        items=_pad2(rows["items"], S, np.int32),
        weights=_pad2(rows["w"], S, np.uint32),
        sum_weights=_pad2(rows["sw"], S, np.uint32),
        straws=_pad2(rows["straws"], S, np.uint32),
        node_weights=_pad2(rows["nodes"], N, np.uint32),
        arg_ids=_pad2(rows["ids"], S, np.int32),
        arg_weights=arg_w)
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
