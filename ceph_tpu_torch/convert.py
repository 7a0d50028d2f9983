"""Carry state across from the JAX package.

``ceph_tpu`` keeps a map as numpy ``MapStatic``/``MapArrays`` and a code
as its coding bit matrix.  These functions read those fields (by
attribute name: nothing of ``ceph_tpu`` is imported) and build the
port's counterparts, so that both packages can compute on the same
state.  A cluster map crosses as ``OSDMap.to_dict()``, which the port's
``OSDMap.from_dict`` reads.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Tuple

import numpy as np

from .crush.map_arrays import MapArrays, MapStatic, to_device
from .device import resolve_device
from .ec.engine import BitCode, Layout


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


def bitcode_from_numpy(coding_bm, k: int, m: int, device="cuda") -> BitCode:
    """A code's (8m, 8k) coding bit matrix -> the port's ``BitCode`` on
    ``device`` (w=8 byte layout)."""
    return BitCode(k, m, np.asarray(coding_bm, np.uint8), Layout(8),
                   device=device)
