"""The flagship step: batched CRUSH placement plus RS(8,3) encode.

The port of ``__graft_entry__.py:_flagship``/``entry()``: one step maps
a batch of PGs through a CRUSH rule (kernel K2) and erasure-codes a
batch of stripes (kernel K1), the two cores every other module feeds or
consumes.  ``spec_cross_check`` is the check ``_dryrun_on`` makes
beside it: the speculative lowering of ``map_big10k`` rule 0 equals
the general walk (K2).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from .crush.builder import sample_cluster_map
from .crush.map import CrushMap
from .crush.mapper import BatchedMapper, build_rule_fn
from .crush.mapper_spec import SpeculativeMapper
from .device import resolve_device
from .ec.rs import RSCode

BIG10K = pathlib.Path(__file__).resolve().parents[1] / "tests" / "golden" \
    / "map_big10k.json"


class Flagship:
    """A map, one compiled rule and an RS(8,3) code on one device."""

    def __init__(self, cmap: CrushMap = None, ruleno: int = 0,
                 result_max: int = 3, device="cuda"):
        self.device = resolve_device(device)
        self.cmap = cmap if cmap is not None else sample_cluster_map(
            racks=3, hosts_per_rack=4, osds_per_host=4)
        self.rule_fn, self.static, self.arrays = build_rule_fn(
            self.cmap, ruleno, result_max, device=self.device)
        self.code = RSCode(8, 3, device=self.device)

    def step(self, arrays, weight, xs, stripes):
        """(res i32[N, R], lens i32[N], parity).  ``stripes`` u8[8, L]
        gives parity u8[3, L]; u8[B, 8, L] gives u8[B, 3, L] from one
        batched launch."""
        res, lens = self.rule_fn(arrays, weight, xs)
        stripes = torch.as_tensor(stripes, dtype=torch.uint8,
                                  device=self.device)
        if stripes.dim() == 3:
            parity = self.code.encode_batched(stripes)
        else:
            parity = self.code.encode(stripes)
        return res, lens, parity

    def example_args(self):
        """The inputs ``entry()`` gives the step: unit weights, 256 PGs,
        one all-zero stripe of 8 x 4096 bytes."""
        weight = torch.full((self.static.max_devices,), 0x10000,
                            dtype=torch.int32, device=self.device)
        xs = torch.arange(256, dtype=torch.int32, device=self.device)
        stripes = torch.zeros((8, 4096), dtype=torch.uint8,
                              device=self.device)
        return self.arrays, weight, xs, stripes


def flagship(cmap: CrushMap = None, ruleno: int = 0, result_max: int = 3,
             device="cuda") -> Flagship:
    """Build the flagship step (by default on the 48-OSD sample map, as
    ``__graft_entry__._flagship`` does)."""
    return Flagship(cmap, ruleno, result_max, device)


def spec_cross_check(n_pgs: int = 65536, k_tries: int = 1, device="cuda"):
    """``__graft_entry__._dryrun_on``'s cross-check: ``map_big10k``'s
    first golden case (rule 0, numrep 3, its weights) over PGs 0 ..
    n_pgs - 1 through the general walk (``BatchedMapper``: K2 on the
    card) and the speculative mapper; any difference raises.  Returns
    (res, lens, the speculative mapper, whose ``rounds`` and ``syncs``
    count its call)."""
    dev = resolve_device(device)
    with open(BIG10K) as f:
        d = json.load(f)
    cmap = CrushMap.from_dict(d["map"])
    case = d["cases"][0]
    weight = np.asarray(case["weight"], np.uint32)
    xs = np.arange(n_pgs, dtype=np.uint32)
    res, lens = BatchedMapper(cmap, device=dev).map_batch(
        case["ruleno"], xs, case["numrep"], weight)
    spec = SpeculativeMapper(cmap, k_tries=k_tries, device=dev)
    sres, slens = spec.map_batch(case["ruleno"], xs, case["numrep"], weight)
    if not (torch.equal(res, sres) and torch.equal(lens, slens)):
        raise AssertionError("speculative mapper diverges from the general "
                             "mapper")
    return res, lens, spec
