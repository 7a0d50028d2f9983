"""The upmap balancer: ``calc_pg_upmaps`` on the batched pipeline.

The port of ``ceph_tpu/osdmap/balancer.py``, the reference's upmap
optimizer (``OSDMap::calc_pg_upmaps``, src/osd/OSDMap.cc:4618-5115, with
``try_pg_upmap`` :4575 and ``CrushWrapper::get_rule_weight_osd_map``,
src/crush/CrushWrapper.cc:2397): tally every OSD's PGs against its
weight-proportional target, then move PGs from overfull to underfull
OSDs by adding ``pg_upmap_items`` pairs, keeping a change only if it
lowers the deviations' sum of squares.  The mgr balancer's crush-compat
mode (``do_crush_compat``) is here too.

The full-cluster remap (OSDMap.cc:4642) is one ``PoolMapper.map_all``
per pool on ``device`` (the default, ``use_batched=True``; K2 for the
CRUSH stage) or, when the caller asks for it, the scalar pipeline on
the host, which crush-compat uses as ``ceph_tpu`` does.  The batched tally takes ``up`` and ``up_len``
to the host in one copy per pool and groups them with numpy; the dict
it fills has the keys in the order of the scalar loop (an OSD at its
first appearance, PGs by ps, then by position in the row), because the
deviations are summed in that order and a change is kept on a strict
``<`` of those sums.  The search itself is the reference's, on the
host, with ``random.Random(seed)`` in place of its ``random_device``.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..crush.constants import CRUSH_ITEM_NONE
from ..crush.map import ChooseArg, ChooseArgMap
from ..crush.wrapper import CrushWrapper
from ..device import resolve_device
from .osdmap import OSDMap
from .pipeline import PoolMapper

PgId = Tuple[int, int]  # (pool_id, ps)


def get_rule_weight_osd_map(wrapper: CrushWrapper,
                            ruleno: int) -> Dict[int, float]:
    """osd -> normalized share of the rule's tree weight
    (CrushWrapper.cc:2397): per TAKE, sum device weights under the
    take root, normalize, merge."""
    pmap: Dict[int, float] = {}
    rule = wrapper.crush.rules.get(ruleno)
    if rule is None:
        raise KeyError(f"no rule {ruleno}")
    for root in wrapper.find_takes_by_rule(ruleno):
        m: Dict[int, float] = {}
        total = 0.0
        if root >= 0:
            m[root] = 1.0
            total = 1.0
        else:
            for leaf in wrapper.get_leaves(root):
                p = wrapper.get_immediate_parent_id(leaf)
                # weight of the leaf within its parent bucket
                b = wrapper.get_bucket(p) if p is not None else None
                w = (b.item_weight_at(b.items.index(leaf)) / 0x10000
                     if b is not None else 0.0)
                m[leaf] = m.get(leaf, 0.0) + w
                total += w
        if total:
            for osd, w in m.items():
                pmap[osd] = pmap.get(osd, 0.0) + w / total
    return pmap


def pg_to_raw_upmap(m: OSDMap, pool_id: int,
                    ps: int) -> Tuple[List[int], List[int]]:
    """OSDMap.cc:2635: (raw crush mapping, raw with upmaps applied)."""
    pool = m.pools[pool_id]
    raw, _pps = m._pg_to_raw_osds(pool_id, pool, ps)
    pgid = (pool_id, pool.raw_pg_to_ps(ps))
    upmapped = m._apply_upmap(pool, pgid, list(raw))
    return raw, upmapped


def try_pg_upmap(m: OSDMap, wrapper: CrushWrapper, pool_id: int,
                 ps: int, overfull: Set[int], underfull: List[int],
                 more_underfull: List[int]
                 ) -> Optional[Tuple[List[int], List[int]]]:
    """OSDMap.cc:4575: propose an alternative mapping for one PG via
    CrushWrapper.try_remap_rule; None when nothing changes."""
    pool = m.pools[pool_id]
    if pool.crush_rule not in m.crush.rules:
        return None
    _raw, orig = pg_to_raw_upmap(m, pool_id, ps)
    if not any(o in overfull for o in orig):
        return None
    out = wrapper.try_remap_rule(pool.crush_rule, pool.size, overfull,
                                 underfull, more_underfull, orig)
    if out == orig or len(out) != len(orig):
        return None
    return orig, out


def _tally(pgs_by_osd: Dict[int, Set[PgId]], pool_id: int, up, up_len
           ) -> None:
    """Add one pool's ``map_all`` rows to ``pgs_by_osd``: one copy of
    ``up`` and ``up_len`` to the host, then a stable sort by OSD.  New
    OSDs enter the dict in the order of their first (ps, position)."""
    rows = torch.cat([up, up_len[:, None]], dim=1).cpu().numpy()
    up, ulen = rows[:, :-1], rows[:, -1]
    valid = (np.arange(up.shape[1]) < ulen[:, None]) & \
        (up != CRUSH_ITEM_NONE) & (up >= 0)
    osd = up[valid]                   # row-major: by ps, then position
    ps = np.nonzero(valid)[0]
    order = np.argsort(osd, kind="stable")
    keys, start = np.unique(osd[order], return_index=True)
    bounds = np.append(start, order.size).tolist()
    ps_of = ps[order].tolist()
    # order[start] is each OSD's first flat index: its place in the dict
    for k in np.argsort(order[start], kind="stable").tolist():
        pgs_by_osd.setdefault(int(keys[k]), set()).update(
            [(pool_id, p) for p in ps_of[bounds[k]:bounds[k + 1]]])


def build_pgs_by_osd(m: OSDMap,
                     only_pools: Optional[Set[int]] = None,
                     use_batched: bool = True,
                     mappers: Optional[Dict[int, PoolMapper]] = None,
                     device="cuda") -> Dict[int, Set[PgId]]:
    """Map every PG of every (selected) pool and tally per OSD: the
    full-cluster remap (OSDMap.cc:4633-4646).  ``use_batched`` maps each
    pool with one ``PoolMapper.map_all`` on ``device``; otherwise the
    scalar pipeline runs on the host and ``device`` is not used.

    ``mappers`` is a caller-owned ``{pool_id: PoolMapper}`` cache: the
    closed balancer loop re-sweeps the same pools every round, so a
    cached mapper only lowers its exception tables again
    (``refresh_tables``) instead of being built anew."""
    dev = resolve_device(device) if use_batched else None
    pgs_by_osd: Dict[int, Set[PgId]] = {}
    for pool_id, pool in m.pools.items():
        if only_pools and pool_id not in only_pools:
            continue
        if use_batched:
            if mappers is not None:
                pm = mappers.get(pool_id)
                if pm is None or pm.m is not m:
                    pm = PoolMapper(m, pool_id, device=dev)
                    mappers[pool_id] = pm
                else:
                    pm.refresh_tables()
            else:
                pm = PoolMapper(m, pool_id, device=dev)
            out = pm.map_all()
            _tally(pgs_by_osd, pool_id, out["up"], out["up_len"])
        else:
            for ps in range(pool.pg_num):
                up, _p, _a, _ap = m.pg_to_up_acting_osds(pool_id, ps)
                for o in up:
                    if o != CRUSH_ITEM_NONE:
                        pgs_by_osd.setdefault(o, set()).add(
                            (pool_id, ps))
    return pgs_by_osd


def target_osd_weights(m: OSDMap, wrapper: CrushWrapper,
                       only_pools: Optional[Set[int]] = None
                       ) -> Tuple[Dict[int, float], float, int]:
    """The per-OSD weight-proportional targets every deviation sweep
    measures against (OSDMap.cc:4646-4700): each selected pool's rule
    tree contributes its normalized per-OSD share scaled by the
    reweight column.  Returns (osd_weight, weight_total, total_pgs)."""
    total_pgs = 0
    osd_weight: Dict[int, float] = {}
    osd_weight_total = 0.0
    for pool_id, pool in m.pools.items():
        if only_pools and pool_id not in only_pools:
            continue
        total_pgs += pool.size * pool.pg_num
        pmap = get_rule_weight_osd_map(wrapper, pool.crush_rule)
        for osd, share in pmap.items():
            if osd >= len(m.osd_weight):
                continue
            adjusted = (m.osd_weight[osd] / 0x10000) * share
            if adjusted == 0:
                continue
            osd_weight[osd] = osd_weight.get(osd, 0.0) + adjusted
            osd_weight_total += adjusted
    return osd_weight, osd_weight_total, total_pgs


def _deviations(pgs_by_osd: Dict[int, Set[PgId]],
                osd_weight: Dict[int, float], pgs_per_weight: float):
    dev: Dict[int, float] = {}
    stddev = 0.0
    max_dev = 0.0
    for osd, pgs in pgs_by_osd.items():
        if osd not in osd_weight:
            # an upmap-pair endpoint outside the weighted tree: it has
            # no target to deviate from (the reference asserts here)
            continue
        target = osd_weight[osd] * pgs_per_weight
        d = len(pgs) - target
        dev[osd] = d
        stddev += d * d
        max_dev = max(max_dev, abs(d))
    return dev, stddev, max_dev


def calc_pg_upmaps(m: OSDMap,
                   max_deviation: int = 5,
                   max_iterations: int = 10,
                   only_pools: Optional[Set[int]] = None,
                   wrapper: Optional[CrushWrapper] = None,
                   use_batched: bool = True,
                   aggressive: bool = True,
                   local_fallback_retries: int = 100,
                   seed: int = 0,
                   mappers: Optional[Dict[int, PoolMapper]] = None,
                   device="cuda") -> int:
    """OSDMap.cc:4618.  Mutates ``m.pg_upmap_items`` in place; returns
    the number of table changes (additions + removals)."""
    if max_deviation < 1:
        max_deviation = 1
    if wrapper is None:
        wrapper = CrushWrapper(m.crush)
    rng = random.Random(seed)

    # -- the one full-cluster remap ------------------------------------
    pgs_by_osd = build_pgs_by_osd(m, only_pools, use_batched,
                                  mappers=mappers, device=device)

    osd_weight, osd_weight_total, total_pgs = target_osd_weights(
        m, wrapper, only_pools)
    for osd in osd_weight:
        pgs_by_osd.setdefault(osd, set())
    # drop tallies for osds outside the weight map (down/out devices)
    pgs_by_osd = {o: p for o, p in pgs_by_osd.items()
                  if o in osd_weight}
    if osd_weight_total == 0 or total_pgs == 0:
        return 0
    pgs_per_weight = total_pgs / osd_weight_total

    osd_deviation, stddev, cur_max = _deviations(
        pgs_by_osd, osd_weight, pgs_per_weight)
    if cur_max <= max_deviation:
        return 0

    num_changed = 0
    skip_overfull = False
    it = max_iterations
    while it > 0:
        it -= 1
        by_dev_desc = sorted(osd_deviation,
                             key=lambda o: (-osd_deviation[o], o))
        by_dev_asc = sorted(osd_deviation,
                            key=lambda o: (osd_deviation[o], o))
        overfull = {o for o in by_dev_desc
                    if osd_deviation[o] > max_deviation}
        more_overfull = {o for o in by_dev_desc
                         if 0 < osd_deviation[o] <= max_deviation}
        underfull = [o for o in by_dev_asc
                     if osd_deviation[o] < -max_deviation]
        more_underfull = [o for o in by_dev_asc
                          if -max_deviation <= osd_deviation[o] < 0]
        if not underfull and not overfull:
            break
        using_more_overfull = False
        if not overfull and underfull:
            overfull = more_overfull
            using_more_overfull = True
        if not overfull:
            break

        to_skip: Set[PgId] = set()
        local_fallback_retried = 0
        applied = False
        while True:  # retry: label
            to_unmap: Set[PgId] = set()
            to_upmap: Dict[PgId, List[Tuple[int, int]]] = {}
            temp = {o: set(p) for o, p in pgs_by_osd.items()}
            found = _search_overfull(
                m, wrapper, by_dev_desc, osd_deviation, osd_weight,
                pgs_per_weight, overfull, underfull, more_underfull,
                using_more_overfull, max_deviation, skip_overfull,
                to_skip, temp, to_unmap, to_upmap, only_pools,
                aggressive, rng)
            if not found:
                found = _search_underfull(
                    m, by_dev_asc, osd_deviation, underfull,
                    max_deviation, to_skip, temp, to_unmap, to_upmap,
                    only_pools, aggressive, rng)
            if not found:
                if not aggressive:
                    return num_changed
                if not skip_overfull:
                    return num_changed
                skip_overfull = False
                break  # continue outer loop
            # test_change (OSDMap.cc:5031)
            t_dev, new_stddev, cur_max = _deviations(
                temp, osd_weight, pgs_per_weight)
            if new_stddev >= stddev:
                if not aggressive:
                    return num_changed
                local_fallback_retried += 1
                if local_fallback_retried >= local_fallback_retries:
                    skip_overfull = not skip_overfull
                    break  # continue outer loop
                to_skip |= to_unmap | set(to_upmap)
                continue  # retry
            # apply
            stddev = new_stddev
            pgs_by_osd = temp
            osd_deviation = t_dev
            for pgid in to_unmap:
                del m.pg_upmap_items[pgid]
                num_changed += 1
            for pgid, items in to_upmap.items():
                m.pg_upmap_items[pgid] = items
                num_changed += 1
            applied = True
            break
        if applied and cur_max <= max_deviation:
            break
    return num_changed


def _search_overfull(m, wrapper, by_dev_desc, osd_deviation, osd_weight,
                     pgs_per_weight, overfull, underfull,
                     more_underfull, using_more_overfull, max_deviation,
                     skip_overfull, to_skip, temp, to_unmap, to_upmap,
                     only_pools, aggressive, rng) -> bool:
    """OSDMap.cc:4771-4936: first change that helps an overfull osd."""
    for osd in by_dev_desc:
        if skip_overfull and underfull:
            break
        deviation = osd_deviation[osd]
        if deviation < 0:
            break
        if not using_more_overfull and deviation <= max_deviation:
            break
        pgs = [p for p in sorted(temp.get(osd, ()))
               if p not in to_skip]
        if aggressive:
            rng.shuffle(pgs)
        # 1) drop an existing remapping pair that lands on this osd
        for pgid in pgs:
            items = m.pg_upmap_items.get(pgid)
            if items is None:
                continue
            new_items = [q for q in items if q[1] != osd]
            if len(new_items) == len(items):
                continue
            for q in items:
                if q[1] == osd:
                    temp[q[1]].discard(pgid)
                    temp.setdefault(q[0], set()).add(pgid)
            if not new_items:
                to_unmap.add(pgid)
            else:
                to_upmap[pgid] = new_items
            return True
        # 2) append a new remapping pair
        for pgid in pgs:
            if pgid in m.pg_upmap:
                continue  # balancer leaves explicit pg_upmap alone
            pool_id, ps = pgid
            pool = m.pools[pool_id]
            existing: Set[int] = set()
            new_items: List[Tuple[int, int]] = []
            items = m.pg_upmap_items.get(pgid)
            if items is not None:
                if len(items) >= pool.size:
                    continue
                new_items = list(items)
                for a, b in items:
                    existing.add(a)
                    existing.add(b)
            res = try_pg_upmap(m, wrapper, pool_id, ps, overfull,
                               underfull, more_underfull)
            if res is None:
                continue
            orig, out = res
            pos, max_dev = -1, 0.0
            for i in range(len(out)):
                if orig[i] == out[i]:
                    continue
                if orig[i] in existing or out[i] in existing:
                    continue
                d = osd_deviation.get(orig[i], 0.0)
                if d > max_dev:
                    max_dev, pos = d, i
            if pos < 0:
                continue
            frm, to = orig[pos], out[pos]
            temp.setdefault(frm, set()).discard(pgid)
            temp.setdefault(to, set()).add(pgid)
            new_items.append((frm, to))
            to_upmap[pgid] = new_items
            return True
    return False


def _search_underfull(m, by_dev_asc, osd_deviation, underfull,
                      max_deviation, to_skip, temp, to_unmap, to_upmap,
                      only_pools, aggressive, rng) -> bool:
    """OSDMap.cc:4940-5010: cancel remapping pairs that drain an
    underfull osd."""
    for osd in by_dev_asc:
        if osd not in underfull:
            break
        deviation = osd_deviation[osd]
        if abs(deviation) < max_deviation:
            break
        candidates = [(pgid, items)
                      for pgid, items in sorted(m.pg_upmap_items.items())
                      if pgid not in to_skip
                      and (not only_pools or pgid[0] in only_pools)]
        if aggressive:
            rng.shuffle(candidates)
        for pgid, items in candidates:
            new_items = [q for q in items if q[0] != osd]
            if len(new_items) == len(items):
                continue
            for q in items:
                if q[0] == osd:
                    temp.setdefault(q[1], set()).discard(pgid)
                    temp.setdefault(q[0], set()).add(pgid)
            if not new_items:
                to_unmap.add(pgid)
            else:
                to_upmap[pgid] = new_items
            return True
    return False


# ---------------------------------------------------------------------------
# crush-compat mode (balancer module.py do_crush_compat, :964-1120)
# ---------------------------------------------------------------------------

def distribution_score(m: OSDMap, osd_weight: Dict[int, float],
                       only_pools: Optional[Set[int]] = None,
                       pgs_by_osd: Optional[Dict[int, Set[PgId]]] = None
                       ) -> float:
    """Imbalance score in [0, 1), 0 = perfect (module.py:181-224
    spirit: weight-share-weighted erf of relative deviation).  Without
    ``pgs_by_osd`` it sweeps with the scalar pipeline."""
    if pgs_by_osd is None:
        pgs_by_osd = build_pgs_by_osd(m, only_pools, use_batched=False)
    total = sum(len(p) for p in pgs_by_osd.values())
    wsum = sum(osd_weight.values())
    if not total or not wsum:
        return 0.0
    score = 0.0
    for osd, share in osd_weight.items():
        share /= wsum
        if share <= 0:
            continue
        avg = total * share
        actual = len(pgs_by_osd.get(osd, ()))
        dev = abs(actual - avg) / avg if avg else 0.0
        score += share * math.erf(dev / math.sqrt(2.0))
    return score


def weight_set_to_choose_args(wrapper: CrushWrapper,
                              ws: Dict[int, float]) -> ChooseArgMap:
    """Lower per-device weight-set values (crush-weight units) to a
    hierarchical choose_args set: every bucket's weight_set row is the
    accumulated subtree value, the compat weight-set shape the
    reference stores (CrushWrapper choose_args, crush.h:263-284)."""
    def subtree(item: int) -> float:
        if item >= 0:
            return max(0.0, ws.get(item, 0.0))
        return sum(subtree(c) for c in wrapper.get_bucket(item).items)

    cam = ChooseArgMap()
    for idx, b in wrapper.crush.buckets.items():
        if b.id in wrapper._shadow_ids:
            continue
        row = [int(round(subtree(c) * 0x10000)) for c in b.items]
        cam[idx] = ChooseArg(ids=None, weight_set=[row])
    return cam


def do_crush_compat(m: OSDMap,
                    wrapper: Optional[CrushWrapper] = None,
                    max_iterations: int = 25,
                    step: float = 0.5,
                    max_misplaced: float = 0.10,
                    only_pools: Optional[Set[int]] = None,
                    min_score: float = 0.0,
                    seed: int = 0):
    """The balancer's crush-compat mode: iteratively adjust a
    choose_args weight set (NOT the real hierarchy weights) so actual
    PG counts converge to crush-weight-proportional targets, accepting
    steps that reduce the score within the misplacement budget.  Its
    sweeps are the scalar pipeline's on the host, as in ``ceph_tpu``.
    Returns (score_before, score_after, choose_args) and installs the
    winning set as ``m.crush.choose_args['compat']``."""
    if wrapper is None:
        wrapper = CrushWrapper(m.crush)
    if not (0.0 < step < 1.0):
        raise ValueError("step must be in (0, 1)")

    # targets from the rule trees; weight shares per osd
    osd_weight: Dict[int, float] = {}
    total_pgs = 0
    for pool_id, pool in m.pools.items():
        if only_pools and pool_id not in only_pools:
            continue
        total_pgs += pool.size * pool.pg_num
        for osd, share in get_rule_weight_osd_map(
                wrapper, pool.crush_rule).items():
            if osd < len(m.osd_weight) and m.osd_weight[osd] > 0:
                osd_weight[osd] = osd_weight.get(osd, 0.0) + share
    if not osd_weight or not total_pgs:
        return 0.0, 0.0, None

    def mapping_of(cam) -> Dict[int, Set[PgId]]:
        saved = dict(m.crush.choose_args)
        if cam is not None:
            m.crush.choose_args["compat"] = cam
            for pool_id in m.pools:
                m.crush.choose_args.setdefault(
                    pool_id, m.crush.choose_args["compat"])
        try:
            return build_pgs_by_osd(m, only_pools, use_batched=False)
        finally:
            m.crush.choose_args = saved

    base_map = mapping_of(None)
    base_pairs = {(o, pg) for o, pgs in base_map.items() for pg in pgs}
    score0 = distribution_score(m, osd_weight, only_pools, base_map)
    if score0 <= min_score:
        return score0, score0, None

    wsum = sum(osd_weight.values())
    # initial weight set = the real crush weights (compat semantics)
    ws: Dict[int, float] = {}
    for osd in osd_weight:
        try:
            ws[osd] = wrapper.get_item_weight(osd) / 0x10000
        except KeyError:
            ws[osd] = 1.0

    best_ws = dict(ws)
    best_map = base_map
    best_score = score0
    cur_step = step
    for _ in range(max_iterations):
        nxt = dict(best_ws)
        actual_total = sum(len(p) for p in best_map.values())
        total_ws = sum(nxt.values())
        for osd, share in osd_weight.items():
            target = actual_total * (share / wsum)
            actual = len(best_map.get(osd, ()))
            weight = nxt[osd]
            if actual > 0:
                calc = (target / actual) * weight
            else:
                # empty osd: aim at its fair share of the current
                # weight-set mass (PG counts are not weight units)
                calc = (share / wsum) * total_ws
            nxt[osd] = weight * (1.0 - cur_step) + calc * cur_step
        cam = weight_set_to_choose_args(wrapper, nxt)
        new_map = mapping_of(cam)
        new_pairs = {(o, pg) for o, pgs in new_map.items()
                     for pg in pgs}
        misplaced = (len(base_pairs - new_pairs)
                     / max(1, len(base_pairs)))
        new_score = distribution_score(m, osd_weight, only_pools,
                                       new_map)
        if misplaced > max_misplaced or new_score >= best_score:
            cur_step /= 2.0
            if cur_step < 0.01:
                break
            continue
        best_ws, best_map, best_score = nxt, new_map, new_score
        if best_score <= min_score:
            break

    if best_score >= score0:
        return score0, score0, None
    cam = weight_set_to_choose_args(wrapper, best_ws)
    m.crush.choose_args["compat"] = cam
    for pool_id in m.pools:
        if not only_pools or pool_id in only_pools:
            m.crush.choose_args[pool_id] = cam
    return score0, best_score, cam
