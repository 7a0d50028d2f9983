"""CrushTester: the ``crushtool --test`` sweep and its statistics.

The port of ``ceph_tpu/tools/tester.py`` (the role of
src/crush/CrushTester.cc:432-747): map a range of xs through a rule,
tally each device's placements against its weight's share, count the
result sizes, list the bad mappings, and compare two maps.

On the card (``device="cuda"``, the default) the sweep stays on the
device: the xs are built there (u32, hashed with ``--pool``), one
``BatchedMapper.map_batch`` launch of kernel K2 maps them all, and the
stats pass is ``parallel.placement.utilization`` plus a ``bincount`` of
the lengths.  Only the counts, the bad rows and, when asked for, the
mappings come back to the host; the Python lists of a bad row are made
only when ``RuleReport.bad`` is read.  The other engines give the same
report: ``device="cpu"`` the plain walk, ``native=True`` the native C++
engine and ``scalar=True`` the scalar ``mapper_ref``, all on the host.
``mesh=`` (``parallel.placement.Mesh``) splits the sweep over the
mesh's devices through a ``PlacementPlane``: one K2 launch a shard,
and ``test_rule`` takes the plane's all-reduced tally as its per-device
counts.

A tester lowers its map once per engine and device, at the first sweep
that needs it, and keeps the result for every later ``test_rule`` and
``compare`` call; build a new tester after editing the map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..crush.constants import CRUSH_ITEM_NONE
from ..crush.hash import crush_hash32_2
from ..crush.map_arrays import as_i32
from ..crush.mapper import BatchedMapper
from ..crush.mapper_ref import crush_do_rule
from ..crush.native import NativeMapper
from ..crush.wrapper import CrushWrapper
from ..device import resolve_device
from ..parallel.placement import Mesh, PlacementPlane, utilization

M32 = 0xFFFFFFFF


@dataclass
class RuleReport:
    """Stats for one (rule, num_rep) sweep.  ``bad_rows`` holds the xs,
    rows and lengths of the mappings whose length is not ``num_rep``
    (host numpy); ``bad`` lists them as (x, [osd, ...])."""

    ruleno: int
    num_rep: int
    min_x: int
    max_x: int
    total: int = 0
    size_counts: Dict[int, int] = field(default_factory=dict)
    device_stored: Optional[np.ndarray] = None
    device_expected: Optional[np.ndarray] = None
    bad_rows: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    mappings: Optional[List[List[int]]] = None

    @property
    def batch_size(self) -> int:
        return self.max_x - self.min_x + 1

    @property
    def bad(self) -> List[Tuple[int, List[int]]]:
        if self.bad_rows is None:
            return []
        xs, rows, lens = self.bad_rows
        return [(int(x), row[:n].tolist())
                for x, row, n in zip(xs, rows, lens)]


class CrushTester:
    def __init__(self, wrapper: CrushWrapper,
                 weights: Optional[List[int]] = None):
        self.w = wrapper
        n = max(1, wrapper.crush.max_devices)
        self.weights = list(weights) if weights is not None \
            else [0x10000] * n
        while len(self.weights) < n:
            self.weights.append(0x10000)
        self._mappers: Dict[str, BatchedMapper] = {}
        self._native: Optional[NativeMapper] = None
        self._planes: Dict[Mesh, PlacementPlane] = {}

    def mapper(self, device) -> BatchedMapper:
        """The map lowered for K2 (or the plain walk) on ``device``,
        made at its first use."""
        dev = resolve_device(device)
        if str(dev) not in self._mappers:
            self._mappers[str(dev)] = BatchedMapper(self.w.crush, device=dev)
        return self._mappers[str(dev)]

    def plane(self, mesh: Mesh) -> PlacementPlane:
        """The map lowered onto ``mesh``'s devices, made at its first
        use."""
        if mesh not in self._planes:
            self._planes[mesh] = PlacementPlane(self.w.crush, mesh=mesh)
        return self._planes[mesh]

    def native_mapper(self) -> NativeMapper:
        """The map lowered for the native engine, made at its first
        use."""
        if self._native is None:
            self._native = NativeMapper(self.w.crush)
        return self._native

    def set_device_weight(self, dev: int, weight: float) -> None:
        """--weight <dev> <w> (CrushTester.cc:454-462 semantics:
        fraction of full weight)."""
        self.weights[dev] = int(weight * 0x10000)

    # -- the sweep -----------------------------------------------------
    def sweep(self, ruleno: int, num_rep: int, min_x: int = 0,
              max_x: int = 1023, pool: Optional[int] = None,
              scalar: bool = False, native: bool = False, device="cuda",
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Map x in [min_x, max_x] (with ``pool``, ``hash32_2(x, pool)``,
        CrushTester.cc:570-572) through the rule: (xs int64[N] as u32,
        rows int32[N, num_rep] padded with CRUSH_ITEM_NONE, lengths
        int32[N]), on the card for the default engine (on a mesh, on
        its first device), else on the CPU."""
        return self._sweep(ruleno, num_rep, min_x, max_x, pool, scalar,
                           native, device, mesh)[:3]

    def _sweep(self, ruleno, num_rep, min_x, max_x, pool, scalar, native,
               device, mesh, gather_stats=False):
        """``sweep``, and the plane's tally when a mesh sweep is asked
        for it (else None)."""
        cmap = self.w.crush
        if mesh is not None:
            dev = mesh.devices[0]
        else:
            dev = torch.device("cpu") if scalar or native \
                else resolve_device(device)
        xs = torch.arange(min_x, max_x + 1, dtype=torch.int64,
                          device=dev) & M32
        if pool is not None:
            xs = crush_hash32_2(xs, pool)
        weights = np.asarray(self.weights, np.uint32)
        if mesh is not None:
            out = self.plane(mesh).map_batch(ruleno, as_i32(xs, dev),
                                             num_rep, weights, gather_stats)
            return (xs,) + tuple(out) + (() if gather_stats else (None,))
        if scalar:
            rows = np.full((xs.numel(), num_rep), CRUSH_ITEM_NONE, np.int32)
            lens = np.zeros(xs.numel(), np.int32)
            for i, x in enumerate(xs.tolist()):
                r = crush_do_rule(cmap, ruleno, x, num_rep, self.weights)
                rows[i, :len(r)] = r
                lens[i] = len(r)
            return xs, torch.from_numpy(rows), torch.from_numpy(lens), None
        if native:
            rows, lens = self.native_mapper().map_batch(
                ruleno, xs.numpy(), num_rep, weights)
            return xs, torch.from_numpy(rows), torch.from_numpy(lens), None
        rows, lens = self.mapper(dev).map_batch(
            ruleno, as_i32(xs, dev), num_rep, weights)
        return xs, rows, lens, None

    def report(self, ruleno: int, num_rep: int, min_x: int, max_x: int,
               xs: torch.Tensor, rows: torch.Tensor, lens: torch.Tensor,
               collect_mappings: bool = False,
               counts: Optional[torch.Tensor] = None) -> RuleReport:
        """The stats pass over a sweep's output, on its device: the
        per-device tally (``counts``, a mesh plane's all-reduced tally,
        when given), the size histogram and the bad rows; only they
        (and the mappings, if asked for) come to the host."""
        n_dev = self.w.crush.max_devices
        rep = RuleReport(ruleno, num_rep, min_x, max_x)
        rep.total = xs.numel()
        if counts is None:
            counts = utilization(rows, lens, n_dev)
        stored = counts.cpu().numpy().astype(np.int64)
        sizes = torch.bincount(lens.to(torch.int64)).tolist()
        rep.size_counts = {s: c for s, c in enumerate(sizes) if c}
        rep.device_stored = stored
        # expected: the weight-proportional share of all placed replicas
        wv = np.asarray(self.weights[:n_dev], np.float64)
        placed = stored.sum()
        rep.device_expected = (wv / wv.sum() * placed) if wv.sum() \
            else np.zeros(n_dev)
        bad = (lens != num_rep).nonzero()[:, 0]
        if bad.numel():
            rep.bad_rows = (xs[bad].cpu().numpy(), rows[bad].cpu().numpy(),
                            lens[bad].cpu().numpy())
        if collect_mappings:
            rep.mappings = [row[:n] for row, n in
                            zip(rows.tolist(), lens.tolist())]
        return rep

    def test_rule(self, ruleno: int, num_rep: int, min_x: int = 0,
                  max_x: int = 1023, pool: Optional[int] = None,
                  scalar: bool = False, native: bool = False,
                  collect_mappings: bool = False, mesh=None,
                  device="cuda") -> RuleReport:
        """One sweep and its stats (``sweep``, then ``report``; over a
        mesh the plane's tally is the per-device count)."""
        xs, rows, lens, counts = self._sweep(
            ruleno, num_rep, min_x, max_x, pool, scalar, native, device,
            mesh, gather_stats=mesh is not None)
        return self.report(ruleno, num_rep, min_x, max_x, xs, rows, lens,
                           collect_mappings, counts)

    # -- compare (CrushTester.cc:682-747) ------------------------------
    def compare(self, other: "CrushTester", ruleno: int, num_rep: int,
                min_x: int = 0, max_x: int = 1023, scalar: bool = False,
                native: bool = False, device="cuda") -> Tuple[int, int]:
        """Returns (#different mappings, total): rows whose lengths
        differ or whose first ``length`` entries differ, counted where
        the sweeps ran."""
        _, ra, la = self.sweep(ruleno, num_rep, min_x, max_x, None, scalar,
                               native, device)
        _, rb, lb = other.sweep(ruleno, num_rep, min_x, max_x, None, scalar,
                                native, device)
        live = torch.arange(num_rep, device=la.device)[None, :] < la[:, None]
        differ = (la != lb) | ((ra != rb) & live).any(dim=1)
        return int(differ.sum()), la.numel()


def format_report(rep: RuleReport, w: CrushWrapper,
                  show_utilization: bool = False,
                  show_statistics: bool = False,
                  show_bad_mappings: bool = False,
                  show_mappings: bool = False) -> str:
    """The crushtool --test output shapes (CrushTester.cc:588-680)."""
    name = w.get_rule_name(rep.ruleno)
    out = [f"rule {rep.ruleno} ({name}), x = {rep.min_x}..{rep.max_x}, "
           f"numrep = {rep.num_rep}..{rep.num_rep}"]
    if show_mappings and rep.mappings is not None:
        for i, m in enumerate(rep.mappings):
            out.append(f"CRUSH rule {rep.ruleno} x {rep.min_x + i} "
                       f"{list(m)}")
    if show_statistics:
        for size in sorted(rep.size_counts):
            out.append(f"rule {rep.ruleno} ({name}) num_rep "
                       f"{rep.num_rep} result size == {size}:\t"
                       f"{rep.size_counts[size]}/{rep.total}")
    if show_bad_mappings:
        for x, m in rep.bad:
            out.append(f"bad mapping rule {rep.ruleno} x {x} "
                       f"num_rep {rep.num_rep} result {list(m)}")
    if show_utilization:
        for dev in range(len(rep.device_stored)):
            st = int(rep.device_stored[dev])
            ex = float(rep.device_expected[dev])
            out.append(f"  device {dev}:\t\t stored : {st}\t "
                       f"expected : {ex:.6g}")
    return "\n".join(out)
