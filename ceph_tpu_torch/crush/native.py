"""The native CPU CRUSH engine: ``native/crush_host.cpp`` through ctypes.

The port of ``ceph_tpu/crush/native.py``.  ``crush_do_rule_batched``
(crush_host.cpp:590) runs the whole rule VM over a batch of xs with
OpenMP, one x per iteration, on the same structure-of-arrays map layout
the mappers read.  It is the port's CPU baseline for ``crushtool --test
--native`` and the independent engine that ``chip_smoke.py`` holds the
card's sweeps to.

The C function takes ``ceph_tpu``'s layout, which carries three fields
the port's ``MapArrays`` does not (a hash per bucket, a choose_args flag
per bucket, and the tree-node and weight-set widths as arguments):
``encode_host`` adds them to the port's ``encode_map``.  The library is
built by ``build.build_host`` from the port's own ln tables; a build
that fails raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import build
from .constants import CRUSH_ITEM_NONE
from .map import ChooseArgMap, CrushMap
from .map_arrays import MapStatic, encode_map

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_c_int = ctypes.c_int
ARGTYPES = [_c_int] * 5 + [_i32p] * 6 + [_u32p] * 4 + [_i32p, _u32p, _u8p] \
    + [_c_int] * 6 + [_c_int, _i32p, _u32p, _c_int, _c_int, _u32p, _c_int,
                      _i32p, _i32p]


@dataclass
class HostArrays:
    """``crush_do_rule_batched``'s map arguments, in its order."""

    alg: np.ndarray           # i32[B]
    btype: np.ndarray         # i32[B]
    bhash: np.ndarray         # i32[B]
    size: np.ndarray          # i32[B]
    nnodes: np.ndarray        # i32[B]
    items: np.ndarray         # i32[B, S]
    weights: np.ndarray       # u32[B, S]
    sum_weights: np.ndarray   # u32[B, S]
    straws: np.ndarray        # u32[B, S]
    node_weights: np.ndarray  # u32[B, N]
    arg_ids: np.ndarray       # i32[B, S]
    arg_weights: np.ndarray   # u32[B, P, S]
    has_arg: np.ndarray       # u8[B]


def encode_host(cmap: CrushMap, choose_args: Optional[ChooseArgMap] = None
                ) -> Tuple[MapStatic, HostArrays]:
    """The map in ``ceph_tpu``'s ``encode_map`` layout: the port's
    arrays plus each bucket's hash and choose_args flag."""
    static, a = encode_map(cmap, choose_args)
    bhash = np.zeros(static.max_buckets, np.int32)
    for i, b in cmap.buckets.items():
        bhash[i] = b.hash
    has_arg = np.zeros(static.max_buckets, np.uint8)
    for i in (choose_args or {}):
        if i in cmap.buckets:
            has_arg[i] = 1
    host = HostArrays(alg=a.alg, btype=a.btype, bhash=bhash, size=a.size,
                      nnodes=a.nnodes, items=a.items, weights=a.weights,
                      sum_weights=a.sum_weights, straws=a.straws,
                      node_weights=a.node_weights, arg_ids=a.arg_ids,
                      arg_weights=a.arg_weights, has_arg=has_arg)
    for name, v in vars(host).items():
        setattr(host, name, np.ascontiguousarray(v))
    return static, host


def _fn():
    lib = build.load_host()
    fn = lib.crush_do_rule_batched
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def threads() -> int:
    """The OpenMP threads the engine runs on."""
    return int(build.load_host().omp_get_max_threads())


class NativeMapper:
    """Batched ``crush_do_rule`` on the native engine for one map (and a
    choose_args set, if given).

    >>> nm = NativeMapper(cmap)
    >>> res, lens = nm.map_batch(ruleno, xs, result_max, weight)
    """

    def __init__(self, cmap: CrushMap,
                 choose_args: Optional[ChooseArgMap] = None):
        self._fn = _fn()
        self.cmap = cmap
        self.static, self.arrays = encode_host(cmap, choose_args)

    def map_batch(self, ruleno: int, xs, result_max: int, weight
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Map a batch: xs u32[N], weight 16.16 u32 per device (numpy or
        lists).  Returns (i32[N, result_max] padded with CRUSH_ITEM_NONE,
        i32[N] lengths), as ``BatchedMapper.map_batch`` does."""
        xs = np.ascontiguousarray(np.asarray(xs).astype(np.uint32))
        weight = np.ascontiguousarray(np.asarray(weight).astype(np.uint32))
        steps = np.ascontiguousarray(
            [[s.op, s.arg1, s.arg2] for s in self.cmap.rules[ruleno].steps],
            np.int32).reshape(-1, 3)
        n = xs.size
        res = np.full((n, result_max), CRUSH_ITEM_NONE, np.int32)
        lens = np.zeros(n, np.int32)
        a, st = self.arrays, self.static
        rc = self._fn(
            st.max_buckets, st.max_size, a.node_weights.shape[1],
            a.arg_weights.shape[1], st.max_devices,
            a.alg, a.btype, a.bhash, a.size, a.nnodes, a.items, a.weights,
            a.sum_weights, a.straws, a.node_weights, a.arg_ids,
            a.arg_weights, a.has_arg, *st.tunables,
            len(steps), steps, weight, weight.size, n, xs, result_max,
            res, lens)
        if rc != 0:
            raise RuntimeError(f"crush_do_rule_batched returned {rc}")
        return res, lens   # the engine writes each row's first lens only

    def do_rule(self, ruleno: int, x: int, result_max: int,
                weight) -> List[int]:
        res, lens = self.map_batch(ruleno, [x], result_max, weight)
        return res[0, :lens[0]].tolist()
