"""Map construction helpers: the port's copy of
``ceph_tpu/crush/builder.py``'s bucket makers (uniform, list, tree,
legacy straw and straw2), the bucket edit primitives the
``CrushWrapper`` builds on, a synthetic hierarchy and the simple
replicated and EC rules.  Weights are 16.16 fixed point.
"""

from __future__ import annotations

import math
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


def make_uniform_bucket(items: Sequence[int], item_weight: int,
                        type_: int, bid: int = 0,
                        hash_: int = C.CRUSH_HASH_RJENKINS1) -> Bucket:
    """crush_make_uniform_bucket: one weight for every item."""
    return Bucket(id=bid, alg=C.CRUSH_BUCKET_UNIFORM, type=type_,
                  hash=hash_, items=list(items), item_weight=item_weight,
                  weight=item_weight * len(items))


def make_list_bucket(items: Sequence[int], weights: Sequence[int],
                     type_: int, bid: int = 0,
                     hash_: int = C.CRUSH_HASH_RJENKINS1) -> Bucket:
    """crush_make_list_bucket: sum_weights[i] is the head prefix sum."""
    sums, acc = [], 0
    for w in weights:
        acc += w
        sums.append(acc)
    return Bucket(id=bid, alg=C.CRUSH_BUCKET_LIST, type=type_,
                  hash=hash_, items=list(items),
                  item_weights=list(weights), sum_weights=sums,
                  weight=acc)


def make_tree_bucket(items: Sequence[int], weights: Sequence[int],
                     type_: int, bid: int = 0,
                     hash_: int = C.CRUSH_HASH_RJENKINS1) -> Bucket:
    """crush_make_tree_bucket: item i sits at odd node ((i+1)<<1)-1 of an
    implicit binary tree; an inner node weighs its subtree."""
    n = len(items)
    depth = max(1, math.ceil(math.log2(n)) + 1) if n > 1 else 1
    num_nodes = 1 << depth
    node_weights = [0] * num_nodes
    for i, w in enumerate(weights):
        j = ((i + 1) << 1) - 1
        node_weights[j] = w
        while True:   # up through the ancestors
            low = j & -j
            parent = (j - low) | (low << 1)
            if parent >= num_nodes:
                break
            node_weights[parent] += w
            j = parent
    return Bucket(id=bid, alg=C.CRUSH_BUCKET_TREE, type=type_,
                  hash=hash_, items=list(items), num_nodes=num_nodes,
                  node_weights=node_weights, weight=sum(weights))


def calc_straw(weights: Sequence[int]) -> List[int]:
    """crush_calc_straw (builder.c) with straw_calc_version=1: straw
    lengths (16.16) that make an item's chance of winning follow its
    weight.  Version 1 has no equal-weight skip: at equal weights wnext
    is 0, pbelow 1 and the straw carries over unchanged."""
    size = len(weights)
    reverse = sorted(range(size), key=lambda i: (weights[i], i))
    straws = [0] * size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    numleft = size
    i = 0
    while i < size:
        if weights[reverse[i]] == 0:
            straws[reverse[i]] = 0
            i += 1
            numleft -= 1
            continue
        straws[reverse[i]] = int(straw * 0x10000)
        i += 1
        if i == size:
            break
        wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
        numleft -= 1
        wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
        pbelow = wbelow / (wbelow + wnext)
        straw *= (1.0 / pbelow) ** (1.0 / numleft)
        lastw = float(weights[reverse[i - 1]])
    return straws


def make_straw_bucket(items: Sequence[int], weights: Sequence[int],
                      type_: int, bid: int = 0,
                      hash_: int = C.CRUSH_HASH_RJENKINS1) -> Bucket:
    """crush_make_straw_bucket: the legacy straw bucket, its straws from
    ``calc_straw``."""
    return Bucket(id=bid, alg=C.CRUSH_BUCKET_STRAW, type=type_,
                  hash=hash_, items=list(items),
                  item_weights=list(weights),
                  straws=calc_straw(list(weights)), weight=sum(weights))


def _rebuild_payload(b: Bucket) -> None:
    """Recompute the per-alg payload from items/item_weights (the role
    of builder.c's per-alg add/remove/adjust helpers, builder.h:163-283,
    done by reconstruction)."""
    if b.alg == C.CRUSH_BUCKET_UNIFORM:
        b.weight = b.item_weight * len(b.items)
        return
    if b.alg == C.CRUSH_BUCKET_LIST:
        t = make_list_bucket(b.items, b.item_weights, b.type, b.id, b.hash)
        b.sum_weights, b.weight = t.sum_weights, t.weight
        return
    if b.alg == C.CRUSH_BUCKET_TREE:
        t = make_tree_bucket(b.items, b.item_weights, b.type, b.id, b.hash)
        b.num_nodes, b.node_weights, b.weight = \
            t.num_nodes, t.node_weights, t.weight
        return
    if b.alg == C.CRUSH_BUCKET_STRAW:
        b.straws = calc_straw(b.item_weights)
    b.weight = sum(b.item_weights)


def bucket_add_item(b: Bucket, item: int, weight: int) -> None:
    """crush_bucket_add_item (builder.h:214)."""
    if b.alg == C.CRUSH_BUCKET_UNIFORM:
        if b.items and weight != b.item_weight:
            raise ValueError("uniform bucket requires equal item weights")
        b.item_weight = weight
        b.items.append(item)
    else:
        b.items.append(item)
        b.item_weights.append(weight)
    _rebuild_payload(b)


def bucket_remove_item(b: Bucket, item: int) -> int:
    """crush_bucket_remove_item (builder.h:232); returns the removed
    weight."""
    pos = b.items.index(item)
    b.items.pop(pos)
    if b.alg == C.CRUSH_BUCKET_UNIFORM:
        removed = b.item_weight
    else:
        removed = b.item_weights.pop(pos)
    _rebuild_payload(b)
    return removed


def bucket_adjust_item_weight(b: Bucket, item: int, weight: int) -> int:
    """crush_bucket_adjust_item_weight (builder.h:223); returns the
    weight delta."""
    pos = b.items.index(item)
    if b.alg == C.CRUSH_BUCKET_UNIFORM:
        diff = (weight - b.item_weight) * len(b.items)
        b.item_weight = weight
    else:
        diff = weight - b.item_weights[pos]
        b.item_weights[pos] = weight
    _rebuild_payload(b)
    return diff


def reweight_bucket(cmap: CrushMap, b: Bucket) -> None:
    """crush_reweight_bucket (builder.h:242): recompute this bucket's
    item weights from its children's, bottom-up."""
    for pos, item in enumerate(b.items):
        if item < 0:
            child = cmap.bucket_by_id(item)
            if child is None:
                continue
            reweight_bucket(cmap, child)
            if b.alg == C.CRUSH_BUCKET_UNIFORM:
                b.item_weight = child.weight
            else:
                b.item_weights[pos] = child.weight
    _rebuild_payload(b)


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
