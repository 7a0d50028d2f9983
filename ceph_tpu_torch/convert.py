"""Carry state across from the JAX package.

``ceph_tpu`` keeps a map as numpy ``MapStatic``/``MapArrays``, a code
as its coding bit matrix and a cluster map as ``OSDMap.to_dict()``.
These functions read those fields (by attribute or key name: nothing
of ``ceph_tpu`` is imported) and build the port's counterparts, so that
both packages can compute on the same state.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Tuple

import numpy as np

from .crush.map import CrushMap
from .crush.map_arrays import MapArrays, MapStatic, to_device
from .device import resolve_device
from .ec.engine import BitCode, Layout
from .osdmap.osdmap import OSDMap, PgPool


def map_arrays_from_numpy(static, arrays, device="cuda"
                          ) -> Tuple[MapStatic, MapArrays]:
    """A ``ceph_tpu`` (MapStatic, MapArrays) pair -> the port's
    (MapStatic, MapArrays of int32 tensors on ``device``).  The fields
    the port does not carry (``bhash``, ``bid``, ``has_arg``) are read
    only for ``hashes_present``."""
    dev = resolve_device(device)
    alg = np.asarray(arrays.alg)
    bhash = np.asarray(arrays.bhash)
    port_static = MapStatic(
        max_buckets=int(static.max_buckets),
        max_devices=int(static.max_devices),
        max_size=int(static.max_size),
        algs_present=tuple(int(a) for a in static.algs_present),
        hashes_present=tuple(sorted(set(
            int(h) for h, a in zip(bhash, alg) if a))),
        has_choose_args=bool(static.has_choose_args),
        tunables=tuple(int(t) for t in static.tunables),
    )
    port_arrays = MapArrays(**{f.name: np.asarray(getattr(arrays, f.name))
                               for f in fields(MapArrays)})
    return port_static, to_device(port_arrays, dev)


def osdmap_from_dict(d) -> OSDMap:
    """A ``ceph_tpu`` ``OSDMap.to_dict()`` -> the port's ``OSDMap`` (host
    state: its ``PoolMapper``s take the device)."""
    m = OSDMap(CrushMap.from_dict(d["crush"]))
    m.epoch = d.get("epoch", 1)
    m.max_osd = d["max_osd"]
    m.osd_state = list(d["osd_state"])
    m.osd_weight = list(d["osd_weight"])
    aff = d.get("osd_primary_affinity")
    m.osd_primary_affinity = None if aff is None else list(aff)
    m.pools = {int(k): PgPool.from_dict(v) for k, v in d["pools"].items()}
    m.pg_upmap = {tuple(k): list(v) for k, v in d["pg_upmap"]}
    m.pg_upmap_items = {tuple(k): [tuple(p) for p in v]
                        for k, v in d["pg_upmap_items"]}
    m.pg_temp = {tuple(k): list(v) for k, v in d["pg_temp"]}
    m.primary_temp = {tuple(k): v for k, v in d["primary_temp"]}
    return m


def bitcode_from_numpy(coding_bm, k: int, m: int, device="cuda") -> BitCode:
    """A code's (8m, 8k) coding bit matrix -> the port's ``BitCode`` on
    ``device`` (w=8 byte layout)."""
    return BitCode(k, m, np.asarray(coding_bm, np.uint8), Layout(8),
                   device=device)
