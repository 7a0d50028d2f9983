"""The mesh data plane: CRUSH placement over several devices.

The port of ``ceph_tpu/parallel/placement.py``.  ``ceph_tpu`` shards
the PG axis over a JAX device mesh with the map replicated, and
all-reduces the per-OSD tally: one pjit launch over every chip.  Here a
``Mesh`` is a list of ``torch.device``s (a card may appear more than
once, and ``make_mesh(["cpu"] * n)`` is an n-way split on the CPU):

- the map's arrays and the weight vector are copied once to each
  distinct device of the mesh (K2's launch plan is cached on the arrays
  object, so each device has its own ``MapArrays``; a repeated device
  shares one copy);
- n xs are split into shards of ceil(n / d) for the d mesh positions;
  each shard goes to its device and kernel K2 (``crush_rule_batched``)
  maps it there, every shard launched before any is waited for;
- the tally is each shard's ``utilization``, summed on the mesh's first
  device and copied to each other distinct device: the all-reduce of
  ``ceph_tpu``'s ``step``, the one collective of the data plane.  The
  counts are int32, as ``ceph_tpu``'s;
- results are gathered on the first device (a one-shard call returns
  K2's output as it is: one launch, no copy).

``ceph_tpu`` pads a batch to ``pad_batch(n, d)`` lanes to bound XLA's
compile cache; the port has none and maps no pad lanes, but books the
padded signature, so its counters read as ``ceph_tpu``'s.

The process-default data-plane mesh (``set_data_plane_mesh``) is what
the EC engine's ``encode_batched`` shards over when no mesh is passed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import device_metrics
from ..crush.map import ChooseArgMap, CrushMap
from ..crush.map_arrays import MapArrays, as_i32, encode_map, to_device
from ..crush.mapper import (_rule_steps, book_map_batch, compile_rule,
                            crush_rule_batched)
from ..device import canonical_device, device_guard, gather
from . import meshctx
from .meshctx import pad_batch  # noqa: F401  (re-export; see meshctx)


class Mesh:
    """A one-axis mesh: ``devices`` (``torch.device``s, in shard order,
    repeats allowed) under ``axis_names``.  ``device_ids`` are the mesh
    positions, the ids the device plane books a mesh call under."""

    def __init__(self, devices: Sequence, axis_names=("pg",)):
        self.devices: Tuple[torch.device, ...] = tuple(
            canonical_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_ids(self) -> List[int]:
        return list(range(self.size))

    @property
    def distinct(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def shards(self, n: int) -> List[Tuple[int, torch.device, int, int]]:
        """(position, device, lo, hi) of the non-empty shards when n
        items are split into shards of ceil(n / size)."""
        per = -(-n // self.size)
        return [(i, d, i * per, min(n, (i + 1) * per))
                for i, d in enumerate(self.devices) if i * per < n]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and \
            (self.devices, self.axis_names) == \
            (other.devices, other.axis_names)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names))

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "pg") -> Mesh:
    """A one-axis mesh over the PG (data) axis; by default every CUDA
    device.  Without a card, pass devices (``["cpu"] * n``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n "
                "for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(list(devices), (axis_name,))


# -- process-default data-plane mesh ----------------------------------------

def set_data_plane_mesh(mesh: Optional[Mesh]) -> None:
    """Install (or clear, with None) the process-default mesh the EC
    batched-encode paths shard over."""
    meshctx.set_mesh(mesh)


def data_plane_mesh() -> Optional[Mesh]:
    return meshctx.get_mesh()


@contextlib.contextmanager
def data_plane(mesh: Optional[Mesh]):
    """Scoped ``set_data_plane_mesh`` for tests and bench stages."""
    prev = meshctx.get_mesh()
    set_data_plane_mesh(mesh)
    try:
        yield mesh
    finally:
        set_data_plane_mesh(prev)


def utilization(results: torch.Tensor, lens: torch.Tensor,
                max_devices: int) -> torch.Tensor:
    """Per-OSD placement counts, int64[max_devices], on the device of
    ``results`` (the CrushTester stats pass,
    src/crush/CrushTester.cc:588-648): entries past each row's length
    and ids outside ``[0, max_devices)`` are not counted.  An
    ``index_add_`` into the bins, not ``torch.bincount``, which on the
    card reads the input's max and min back to the host (a sync)."""
    pos = torch.arange(results.shape[-1], device=results.device)
    valid = (pos[None, :] < lens[:, None]) & (results >= 0) \
        & (results < max_devices)
    flat = torch.where(valid, results, max_devices).reshape(-1)
    bins = torch.zeros(max_devices + 1, dtype=torch.int64,
                       device=results.device)
    bins.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int64))
    return bins[:max_devices]


def all_reduce_sum(parts: Sequence[torch.Tensor], mesh: Mesh,
                   dtype=torch.int32) -> Dict[torch.device, torch.Tensor]:
    """The sum of the shards' ``parts`` on the mesh's first device, and
    a copy of it on each other distinct device: {device: sum}.
    (``torch.cuda.comm.reduce_add`` wants distinct devices, which a mesh
    that repeats a card does not have.)"""
    first = mesh.devices[0]
    with device_guard(first):
        total = parts[0].to(first, non_blocking=True).to(torch.int64)
        for p in parts[1:]:
            total = total + p.to(first, non_blocking=True)
        total = total.to(dtype)
    out = {first: total}
    for dev in mesh.distinct[1:]:
        with device_guard(dev):
            out[dev] = total.to(dev, non_blocking=True)
    return out


def replicate_arrays(arrays_np: MapArrays,
                     mesh: Mesh) -> Dict[torch.device, MapArrays]:
    """The lowered map's arrays on each distinct device of ``mesh``."""
    out = {}
    for dev in mesh.distinct:
        out[dev] = to_device(arrays_np, dev)
        device_metrics.note_rebuild("lowered_maps")
    return out


def _host_i32(v):
    """u32 data as int32 where it lies: a tensor stays on its device,
    anything else becomes a host tensor (sliced and moved per shard)."""
    if isinstance(v, torch.Tensor):
        return as_i32(v, v.device)
    return as_i32(v, torch.device("cpu"))


def _sharded_step(static, prog, mesh: Mesh, gather_stats: bool,
                  masked: bool):
    """``fn(arrays, weight, xs[, valid])`` of ``sharded_rule_fn``: the
    rule over the shards of xs, against ``arrays`` ({device:
    MapArrays} from ``replicate_arrays``)."""

    def step(arrays, weight, xs, valid=None):
        if masked and valid is None:
            raise ValueError("a masked step takes a validity mask")
        xs = _host_i32(xs)
        weights = {dev: as_i32(weight, dev) for dev in mesh.distinct}
        shards = mesh.shards(xs.numel())
        res, lens, tally = [], [], []
        for _, dev, lo, hi in shards:
            with device_guard(dev):
                x = xs[lo:hi].to(dev, non_blocking=True)
                r, n = crush_rule_batched(arrays[dev], prog, weights[dev], x)
                res.append(r)
                lens.append(n)
        for (_, dev, lo, hi), r, n in zip(shards if gather_stats else (),
                                          res, lens):
            with device_guard(dev):
                if masked:
                    v = torch.as_tensor(valid[lo:hi]).to(dev,
                                                         non_blocking=True)
                    n = torch.where(v, n, 0)
                tally.append(utilization(r, n, static.max_devices))
        first = mesh.devices[0]
        if not res:
            res = [torch.empty((0, prog.result_max), dtype=torch.int32,
                               device=first)]
            lens = [torch.empty(0, dtype=torch.int32, device=first)]
            tally = [torch.zeros(static.max_devices, dtype=torch.int64,
                                 device=first)]
        out = (gather(res, first), gather(lens, first))
        if gather_stats:
            out += (all_reduce_sum(tally, mesh)[first],)
        return out

    return step


def sharded_rule_fn(cmap: CrushMap, ruleno: int, result_max: int,
                    mesh: Mesh,
                    choose_args: Optional[ChooseArgMap] = None,
                    gather_stats: bool = True, masked: bool = False):
    """The rule over ``mesh``, the engine behind ``PlacementPlane``.

    Returns ``(fn, static, arrays)``: ``fn(arrays, weight, xs)`` (or
    ``fn(arrays, weight, xs, valid)`` when ``masked``) maps xs u32[N]
    split over the mesh against ``arrays`` (the map on each distinct
    device) and returns (results i32[N, R], lens i32[N]) on the mesh's
    first device, plus with ``gather_stats`` the all-reduced tally
    i32[max_devices].  ``masked`` takes a per-x validity mask that
    keeps the x out of the tally."""
    static, arrays_np = encode_map(cmap, choose_args)
    prog = compile_rule(static, _rule_steps(cmap, ruleno), result_max)
    return (_sharded_step(static, prog, mesh, gather_stats, masked),
            static, replicate_arrays(arrays_np, mesh))


class PlacementPlane:
    """The CRUSH distribution layer over a mesh: a compiled program per
    rule and the map resident on every distinct mesh device.

    >>> plane = PlacementPlane(cmap, mesh=make_mesh())
    >>> res, lens = plane.map_batch(0, xs, 3, weight)
    >>> res, lens, counts = plane.map_batch(0, xs, 3, weight,
    ...                                     gather_stats=True)

    A ``map_batch`` is one K2 launch a non-empty shard plus, with
    ``gather_stats``, the tally's all-reduce; a one-device mesh is the
    same code with one shard.
    """

    def __init__(self, cmap: CrushMap,
                 choose_args: Optional[ChooseArgMap] = None,
                 mesh: Optional[Mesh] = None):
        self.cmap = cmap
        self.choose_args = choose_args
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_dev = self.mesh.size
        self._device_ids = self.mesh.device_ids
        self._encoded = encode_map(cmap, choose_args)
        self._arrays = replicate_arrays(self._encoded[1], self.mesh)
        self._cache = {}            # (rule, R, gather) -> step
        self._compiled_sigs: set = set()

    @property
    def static(self):
        return self._encoded[0]

    @property
    def arrays(self) -> Dict[torch.device, MapArrays]:
        return self._arrays

    def rule_fn(self, ruleno: int, result_max: int,
                gather_stats: bool = False):
        key = (ruleno, result_max, bool(gather_stats))
        if key not in self._cache:
            prog = compile_rule(self.static,
                                _rule_steps(self.cmap, ruleno), result_max)
            self._cache[key] = _sharded_step(self.static, prog, self.mesh,
                                             gather_stats, masked=False)
        return self._cache[key]

    def map_batch(self, ruleno: int, xs, result_max: int, weight,
                  gather_stats: bool = False):
        """Map xs u32[N] (numpy or a tensor anywhere) across the mesh
        with weight 16.16 u32[max_devices].  Returns ``(results i32[N,
        R], lens i32[N])`` on the mesh's first device, plus the
        all-reduced ``counts i32[max_devices]`` with
        ``gather_stats``."""
        fn = self.rule_fn(ruleno, result_max, gather_stats)
        n = xs.numel() if isinstance(xs, torch.Tensor) else len(xs)
        w_n = weight.numel() if isinstance(weight, torch.Tensor) \
            else int(np.asarray(weight).size)
        npad = pad_batch(n, self.n_dev)
        t0 = time.monotonic()
        out = fn(self._arrays, weight, xs)
        dt = time.monotonic() - t0
        sig = (ruleno, result_max, npad, self.n_dev, bool(gather_stats))
        first = sig not in self._compiled_sigs
        if first:
            self._compiled_sigs.add(sig)
        book_map_batch(sig, dt, n, result_max, first,
                       h2d_bytes=npad * 5 + w_n * 4,
                       d2h_bytes=npad * (result_max + 1) * 4,
                       device_ids=self._device_ids)
        return out


def mesh_device_report(mesh: Mesh) -> List[Dict]:
    """One row per mesh position: its device, the card's allocator
    figures (``device_metrics.per_device``) and, once mesh calls have
    run, the launches, host time and transfer share booked there.
    Initialises CUDA for a mesh on the card."""
    by_id = {d["id"]: d for d in device_metrics.per_device()} \
        if any(d.type == "cuda" for d in mesh.devices) else {}
    work = device_metrics.mesh_device_table()
    out = []
    for pos, dev in enumerate(mesh.devices):
        rec = {"id": pos, "device": str(dev), "platform": dev.type}
        card = by_id.get(dev.index) if dev.type == "cuda" else None
        if card:
            rec["bytes_in_use"] = card["bytes_in_use"]
            rec["peak_bytes_in_use"] = card["peak_bytes_in_use"]
        w = work.get(pos)
        if w:
            rec["kernel_launches"] = int(w["launches"])
            rec["kernel_time_s"] = round(float(w["kernel_time_s"]), 6)
            rec["h2d_bytes"] = int(w["h2d_bytes"])
            rec["d2h_bytes"] = int(w["d2h_bytes"])
        out.append(rec)
    return out
