"""OSDMap::Incremental — epoch deltas instead of full maps.

The port's copy of ``ceph_tpu/osdmap/incremental.py``: the same delta,
the same envelope string, the same apply.  The role of
src/osd/OSDMap.h:372-675 and OSDMap::apply_incremental (OSDMap.cc):
each epoch change travels as a small delta (state XORs, weight changes,
pool creations and deletions, upmap adds and removals, pg_temp edits,
an optional full crush replacement) that any holder of epoch N applies
to reach N+1; a gap means "fetch a full map and catch up".

``apply_incremental`` replaces ``m.crush`` and ``m.pools[pid]`` with new
objects; a ``pipeline.PoolMapper`` built before such an epoch keeps the
old ones (as ``ceph_tpu``'s does) and must be built again.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..common.encoding import Versioned
from .osdmap import OSDMap, PgPool

PgId = Tuple[int, int]


def _kv(d):
    return [[list(k), v] for k, v in sorted(d.items())]


def _unkv(rows):
    return {tuple(k): v for k, v in rows}


@dataclass
class Incremental(Versioned):
    """The delta from ``epoch - 1`` to ``epoch``."""

    # v2: added pg_upmap / primary_temp / pool-deletion deltas.  They
    # affect placement, so a v1 reader cannot safely skip them —
    # COMPAT_V rises with STRUCT_V and old followers refuse the delta
    # (and fall back to a full-map fetch) instead of silently diverging.
    STRUCT_V = 2
    COMPAT_V = 2

    epoch: int = 0
    new_max_osd: Optional[int] = None
    new_pools: Dict[int, dict] = field(default_factory=dict)
    old_pools: List[int] = field(default_factory=list)
    new_state: Dict[int, int] = field(default_factory=dict)  # XOR
    new_weight: Dict[int, int] = field(default_factory=dict)
    new_primary_affinity: Dict[int, int] = field(default_factory=dict)
    new_pg_upmap: Dict[PgId, List[int]] = field(default_factory=dict)
    old_pg_upmap: List[PgId] = field(default_factory=list)
    new_pg_upmap_items: Dict[PgId, List[Tuple[int, int]]] = \
        field(default_factory=dict)
    old_pg_upmap_items: List[PgId] = field(default_factory=list)
    new_pg_temp: Dict[PgId, List[int]] = field(default_factory=dict)
    # -1 removes the entry (OSDMap.h:397 new_primary_temp semantics)
    new_primary_temp: Dict[PgId, int] = field(default_factory=dict)
    new_crush: Optional[dict] = None  # full crush swap (rare)

    @classmethod
    def upgrade(cls, writer_v: int, data: dict) -> dict:
        """Migrate archived v1 deltas (pre pg_upmap/primary_temp/
        pool-deletion) forward: the v2-added tables default to empty.
        A v1 WRITER could not have populated them, so an explicit
        empty is exactly its intent — the per-version decode branch
        of the reference's Incremental::decode."""
        if writer_v < 2:
            data = dict(data)
            for key in ("new_pg_upmap", "old_pg_upmap",
                        "new_primary_temp", "old_pools"):
                data.setdefault(key, [])
        return data

    def empty(self) -> bool:
        return not (self.new_max_osd is not None or self.new_pools
                    or self.old_pools
                    or self.new_state or self.new_weight
                    or self.new_primary_affinity
                    or self.new_pg_upmap or self.old_pg_upmap
                    or self.new_pg_upmap_items
                    or self.old_pg_upmap_items or self.new_pg_temp
                    or self.new_primary_temp
                    or self.new_crush)

    # -- wire form ----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "new_max_osd": self.new_max_osd,
            "new_pools": {str(k): v for k, v in self.new_pools.items()},
            "old_pools": list(self.old_pools),
            "new_state": {str(k): v for k, v in self.new_state.items()},
            "new_weight": {str(k): v
                           for k, v in self.new_weight.items()},
            "new_primary_affinity": {
                str(k): v
                for k, v in self.new_primary_affinity.items()},
            "new_pg_upmap": _kv(self.new_pg_upmap),
            "old_pg_upmap": [list(p) for p in self.old_pg_upmap],
            "new_pg_upmap_items": _kv(self.new_pg_upmap_items),
            "old_pg_upmap_items": [list(p)
                                   for p in self.old_pg_upmap_items],
            "new_pg_temp": _kv(self.new_pg_temp),
            "new_primary_temp": _kv(self.new_primary_temp),
            "new_crush": self.new_crush,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Incremental":
        inc = cls(epoch=d["epoch"])
        inc.new_max_osd = d.get("new_max_osd")
        inc.new_pools = {int(k): v
                         for k, v in d.get("new_pools", {}).items()}
        inc.old_pools = [int(p) for p in d.get("old_pools", [])]
        inc.new_state = {int(k): v
                         for k, v in d.get("new_state", {}).items()}
        inc.new_weight = {int(k): v
                          for k, v in d.get("new_weight", {}).items()}
        inc.new_primary_affinity = {
            int(k): v
            for k, v in d.get("new_primary_affinity", {}).items()}
        inc.new_pg_upmap = {k: list(v) for k, v in
                            _unkv(d.get("new_pg_upmap", [])).items()}
        inc.old_pg_upmap = [tuple(p) for p in d.get("old_pg_upmap", [])]
        inc.new_pg_upmap_items = {
            k: [tuple(p) for p in v]
            for k, v in _unkv(d.get("new_pg_upmap_items", [])).items()}
        inc.old_pg_upmap_items = [tuple(p) for p in
                                  d.get("old_pg_upmap_items", [])]
        inc.new_pg_temp = _unkv(d.get("new_pg_temp", []))
        inc.new_primary_temp = _unkv(d.get("new_primary_temp", []))
        inc.new_crush = d.get("new_crush")
        return inc


def diff_maps(old: OSDMap, new: OSDMap) -> Incremental:
    """Build the delta old -> new (the OSDMonitor's pending_inc role,
    derived by comparison so every mutation path is covered)."""
    inc = Incremental(epoch=new.epoch)
    if new.max_osd != old.max_osd:
        inc.new_max_osd = new.max_osd
    for pool_id, pool in new.pools.items():
        if pool_id not in old.pools or \
                old.pools[pool_id].to_dict() != pool.to_dict():
            inc.new_pools[pool_id] = pool.to_dict()
    for pool_id in old.pools:
        if pool_id not in new.pools:
            inc.old_pools.append(pool_id)
    # only osds that EXIST in the new map carry deltas: a shrink
    # truncates the arrays via new_max_osd, so deltas above it would
    # index out of bounds at apply time
    for osd in range(new.max_osd):
        os_ = old.osd_state[osd] if osd < old.max_osd else 0
        ns = new.osd_state[osd]
        if os_ != ns:
            inc.new_state[osd] = os_ ^ ns
        ow = old.osd_weight[osd] if osd < old.max_osd else 0
        nw = new.osd_weight[osd]
        if ow != nw:
            inc.new_weight[osd] = nw
    if new.osd_primary_affinity != old.osd_primary_affinity:
        from .osdmap import DEFAULT_PRIMARY_AFFINITY

        for osd in range(new.max_osd):
            # None lists mean "all default": a reset-to-default
            # transition must still emit deltas for every osd whose old
            # affinity was non-default, or followers keep stale values
            na = new.osd_primary_affinity[osd] \
                if new.osd_primary_affinity else DEFAULT_PRIMARY_AFFINITY
            oa = old.osd_primary_affinity[osd] \
                if old.osd_primary_affinity and \
                osd < len(old.osd_primary_affinity) \
                else DEFAULT_PRIMARY_AFFINITY
            if na != oa:
                inc.new_primary_affinity[osd] = na
    for pgid, raw in new.pg_upmap.items():
        if old.pg_upmap.get(pgid) != raw:
            inc.new_pg_upmap[pgid] = list(raw)
    for pgid in old.pg_upmap:
        if pgid not in new.pg_upmap:
            inc.old_pg_upmap.append(pgid)
    for pgid, items in new.pg_upmap_items.items():
        if old.pg_upmap_items.get(pgid) != items:
            inc.new_pg_upmap_items[pgid] = list(items)
    for pgid in old.pg_upmap_items:
        if pgid not in new.pg_upmap_items:
            inc.old_pg_upmap_items.append(pgid)
    for pgid, temp in new.pg_temp.items():
        if old.pg_temp.get(pgid) != temp:
            inc.new_pg_temp[pgid] = list(temp)
    for pgid in old.pg_temp:
        if pgid not in new.pg_temp:
            inc.new_pg_temp[pgid] = []  # [] removes (OSDMap.h:389)
    for pgid, osd in new.primary_temp.items():
        if old.primary_temp.get(pgid) != osd:
            inc.new_primary_temp[pgid] = osd
    for pgid in old.primary_temp:
        if pgid not in new.primary_temp:
            inc.new_primary_temp[pgid] = -1  # -1 removes
    if old.crush.to_dict() != new.crush.to_dict():
        inc.new_crush = new.crush.to_dict()
    return inc


def apply_incremental(m: OSDMap, inc: Incremental) -> None:
    """OSDMap::apply_incremental (OSDMap.cc): epoch must be
    contiguous."""
    if inc.epoch != m.epoch + 1:
        raise ValueError(
            f"incremental {inc.epoch} does not follow {m.epoch}")
    if inc.new_crush is not None:
        from ..crush.map import CrushMap

        m.crush = CrushMap.from_dict(inc.new_crush)
    if inc.new_max_osd is not None:
        m.set_max_osd(inc.new_max_osd)
    for pool_id, pd in inc.new_pools.items():
        m.pools[pool_id] = PgPool.from_dict(pd)
    for pool_id in inc.old_pools:
        m.pools.pop(pool_id, None)
    for osd, xor in inc.new_state.items():
        m.osd_state[osd] ^= xor  # XORed onto previous (OSDMap.h:387)
    for osd, w in inc.new_weight.items():
        m.osd_weight[osd] = w
    for osd, aff in inc.new_primary_affinity.items():
        m.set_primary_affinity(osd, aff)
    for pgid, raw in inc.new_pg_upmap.items():
        m.pg_upmap[pgid] = list(raw)
    for pgid in inc.old_pg_upmap:
        m.pg_upmap.pop(pgid, None)
    for pgid, items in inc.new_pg_upmap_items.items():
        m.pg_upmap_items[pgid] = [tuple(p) for p in items]
    for pgid in inc.old_pg_upmap_items:
        m.pg_upmap_items.pop(pgid, None)
    for pgid, temp in inc.new_pg_temp.items():
        if temp:
            m.pg_temp[pgid] = list(temp)
        else:
            m.pg_temp.pop(pgid, None)
    for pgid, osd in inc.new_primary_temp.items():
        if osd >= 0:
            m.primary_temp[pgid] = osd
        else:
            m.primary_temp.pop(pgid, None)
    m.epoch = inc.epoch
