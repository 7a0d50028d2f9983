"""Map construction helpers: the port's copy of what
``ceph_tpu/crush/builder.py:sample_cluster_map`` needs (straw2 buckets,
a synthetic hierarchy, the simple replicated and EC rules).  Weights are
16.16 fixed point.
"""

from __future__ import annotations

from typing import List, Sequence

from . import constants as C
from .map import Bucket, CrushMap, Rule, RuleStep


def make_straw2_bucket(items: Sequence[int], weights: Sequence[int],
                       type_: int, bid: int = 0,
                       hash_: int = C.CRUSH_HASH_RJENKINS1) -> Bucket:
    """crush_make_straw2_bucket (builder.c): weights are used raw."""
    return Bucket(id=bid, alg=C.CRUSH_BUCKET_STRAW2, type=type_,
                  hash=hash_, items=list(items),
                  item_weights=list(weights), weight=sum(weights))


def add_simple_rule(cmap: CrushMap, root_id: int, leaf_type: int,
                    firstn: bool = True, ruleno: int = -1,
                    rule_type: int = 1) -> int:
    """CrushWrapper::add_simple_rule (CrushWrapper.h:1167):
    take root -> chooseleaf {firstn|indep} 0 type <leaf_type> -> emit."""
    op = (C.CRUSH_RULE_CHOOSELEAF_FIRSTN if firstn
          else C.CRUSH_RULE_CHOOSELEAF_INDEP)
    steps = [RuleStep(C.CRUSH_RULE_TAKE, root_id, 0),
             RuleStep(op, 0, leaf_type),
             RuleStep(C.CRUSH_RULE_EMIT, 0, 0)]
    return cmap.add_rule(Rule(steps=steps, type=rule_type), ruleno)


def build_hierarchy(cmap: CrushMap, spec: List[tuple],
                    device_weight: int = 0x10000) -> int:
    """Synthetic uniform straw2 hierarchy a la ``crushtool --build``:
    ``spec`` = [(type_id, fan_out), ...] bottom-up; level 0 children are
    devices.  Returns the root bucket id."""
    n_dev = 1
    for _, fan in spec:
        n_dev *= fan
    level_ids = list(range(n_dev))
    level_weights = [device_weight] * n_dev
    for type_id, fan in spec:
        next_ids, next_weights = [], []
        for i in range(0, len(level_ids), fan):
            b = make_straw2_bucket(level_ids[i:i + fan],
                                   level_weights[i:i + fan], type_id)
            next_ids.append(cmap.add_bucket(b))
            next_weights.append(b.weight)
        level_ids, level_weights = next_ids, next_weights
    assert len(level_ids) == 1
    cmap.max_devices = max(cmap.max_devices, n_dev)
    return level_ids[0]


def sample_cluster_map(racks: int = 3, hosts_per_rack: int = 4,
                       osds_per_host: int = 4) -> CrushMap:
    """A production-shaped 3-level straw2 map: root -> racks -> hosts ->
    osds, with one replicated chooseleaf rule 0 and one EC indep rule 1."""
    cmap = CrushMap()
    root_id = build_hierarchy(
        cmap, [(1, osds_per_host), (2, hosts_per_rack), (3, racks)])
    add_simple_rule(cmap, root_id, leaf_type=1, firstn=True, ruleno=0)
    add_simple_rule(cmap, root_id, leaf_type=1, firstn=False, ruleno=1,
                    rule_type=3)
    return cmap
