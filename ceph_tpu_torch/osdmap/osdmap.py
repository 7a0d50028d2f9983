"""The cluster map: pools, OSD states/weights, upmap tables, CRUSH.

The port's copy of ``ceph_tpu/osdmap/osdmap.py``: the host-side data
model, its dict and versioned JSON forms (the same files as
``ceph_tpu``'s), and the scalar pipeline with the semantics of the
reference's OSDMap (src/osd/OSDMap.{h,cc}):

    pg -> pps seed        (pg_pool_t::raw_pg_to_pps, osd_types.cc:1798)
    -> crush do_rule      (_pg_to_raw_osds, OSDMap.cc:2433)
    -> drop nonexistent   (_remove_nonexistent_osds, OSDMap.cc:2408)
    -> upmap exceptions   (_apply_upmap, OSDMap.cc:2463)
    -> drop down OSDs     (_raw_to_up_osds, OSDMap.cc:2510)
    -> primary affinity   (_apply_primary_affinity, OSDMap.cc:2535)
    -> pg_temp overlay    (_get_temp_osds, OSDMap.cc:2590)
    =  _pg_to_up_acting_osds (OSDMap.cc:2665)

The scalar path here (its CRUSH stage is ``crush.mapper_ref``) is the
oracle that ``pipeline.PoolMapper``, every PG of a pool at once on the
card, is held to.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..common import encoding
from ..common.encoding import Versioned
from ..crush.constants import CRUSH_ITEM_NONE
from ..crush.hash import hash32_2_int
from ..crush.map import CrushMap
from ..crush.mapper_ref import crush_do_rule

POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3

FLAG_HASHPSPOOL = 1  # pg_pool_t::FLAG_HASHPSPOOL (osd_types.h)

OSD_EXISTS = 1  # CEPH_OSD_EXISTS
OSD_UP = 2      # CEPH_OSD_UP

DEFAULT_PRIMARY_AFFINITY = 0x10000
MAX_PRIMARY_AFFINITY = 0x10000


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Stable modulo that lets pg_num grow smoothly
    (src/include/rados.h:96)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def _calc_mask(n: int) -> int:
    return (1 << (n - 1).bit_length()) - 1 if n > 1 else 0


@dataclass
class PgPool(Versioned):
    """pg_pool_t essentials (src/osd/osd_types.h:1300-1850)."""

    pool_type: int = POOL_TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 64
    pgp_num: int = 0  # defaults to pg_num
    crush_rule: int = 0
    flags: int = FLAG_HASHPSPOOL
    erasure_code_profile: str = ""

    def __post_init__(self):
        if not self.pgp_num:
            self.pgp_num = self.pg_num

    @property
    def pg_num_mask(self) -> int:
        return _calc_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return _calc_mask(self.pgp_num)

    def can_shift_osds(self) -> bool:
        """Replicated pools compact their osd lists; EC pools are
        positional and hold CRUSH_ITEM_NONE (osd_types.h)."""
        return self.pool_type == POOL_TYPE_REPLICATED

    def raw_pg_to_ps(self, ps: int) -> int:
        return ceph_stable_mod(ps, self.pg_num, self.pg_num_mask)

    def raw_pg_to_pps(self, pool_id: int, ps: int) -> int:
        """osd_types.cc:1798."""
        m = ceph_stable_mod(ps, self.pgp_num, self.pgp_num_mask)
        if self.flags & FLAG_HASHPSPOOL:
            return hash32_2_int(m, pool_id)
        return (m + pool_id) & 0xFFFFFFFF

    def to_dict(self):
        return {
            "pool_type": self.pool_type, "size": self.size,
            "min_size": self.min_size, "pg_num": self.pg_num,
            "pgp_num": self.pgp_num, "crush_rule": self.crush_rule,
            "flags": self.flags,
            "erasure_code_profile": self.erasure_code_profile,
        }

    @classmethod
    def from_dict(cls, d):
        # fields this copy does not know are skipped
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class OSDMap:
    """The mutable host cluster map (src/osd/OSDMap.h)."""

    # version of the JSON form: to_json wraps to_dict in the versioned
    # envelope; from_json also reads a bare to_dict (writer v0)
    STRUCT_V = 1
    COMPAT_V = 1

    def __init__(self, crush: Optional[CrushMap] = None):
        self.epoch = 1
        self.crush = crush or CrushMap()
        self.pools: Dict[int, PgPool] = {}
        self.max_osd = 0
        self.osd_state: List[int] = []
        self.osd_weight: List[int] = []       # 16.16 in/out weight
        self.osd_primary_affinity: Optional[List[int]] = None
        # exception tables, keyed (pool, ps)
        self.pg_upmap: Dict[Tuple[int, int], List[int]] = {}
        self.pg_upmap_items: Dict[Tuple[int, int],
                                  List[Tuple[int, int]]] = {}
        self.pg_temp: Dict[Tuple[int, int], List[int]] = {}
        self.primary_temp: Dict[Tuple[int, int], int] = {}

    # -- osd lifecycle ------------------------------------------------
    def set_max_osd(self, n: int) -> None:
        while self.max_osd < n:
            self.osd_state.append(0)
            self.osd_weight.append(0)
            if self.osd_primary_affinity is not None:
                self.osd_primary_affinity.append(
                    DEFAULT_PRIMARY_AFFINITY)
            self.max_osd += 1
        del self.osd_state[n:]
        del self.osd_weight[n:]
        if self.osd_primary_affinity is not None:
            del self.osd_primary_affinity[n:]
        self.max_osd = n

    def add_osd(self, osd: int, weight: int = 0x10000,
                up: bool = True) -> None:
        if osd >= self.max_osd:
            self.set_max_osd(osd + 1)
        self.osd_state[osd] = OSD_EXISTS | (OSD_UP if up else 0)
        self.osd_weight[osd] = weight

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and \
            bool(self.osd_state[osd] & OSD_EXISTS)

    def is_up(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and \
            bool(self.osd_state[osd] & OSD_UP)

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = \
                [DEFAULT_PRIMARY_AFFINITY] * self.max_osd
        self.osd_primary_affinity[osd] = aff

    # -- scalar pipeline (the executable spec) ------------------------
    def _pg_to_raw_osds(self, pool_id: int, pool: PgPool,
                        ps: int) -> Tuple[List[int], int]:
        pps = pool.raw_pg_to_pps(pool_id, ps)
        raw: List[int] = []
        if pool.crush_rule in self.crush.rules:
            cargs = self.crush.choose_args.get(pool_id)
            raw = crush_do_rule(self.crush, pool.crush_rule, pps,
                                pool.size, self.osd_weight,
                                choose_args=cargs)
        # _remove_nonexistent_osds (OSDMap.cc:2408)
        if pool.can_shift_osds():
            raw = [o for o in raw if self.exists(o)]
        else:
            raw = [o if self.exists(o) else CRUSH_ITEM_NONE
                   for o in raw]
        return raw, pps

    def _apply_upmap(self, pool: PgPool, pgid: Tuple[int, int],
                     raw: List[int]) -> List[int]:
        p = self.pg_upmap.get(pgid)
        if p is not None:
            for osd in p:
                if osd != CRUSH_ITEM_NONE and 0 <= osd < self.max_osd \
                        and self.osd_weight[osd] == 0:
                    # reject/ignore the explicit mapping entirely —
                    # pg_upmap_items are skipped too (OSDMap.cc:2472)
                    return raw
            raw = list(p)
        q = self.pg_upmap_items.get(pgid)
        if q is not None:
            for frm, to in q:
                exists = False
                pos = -1
                for i, osd in enumerate(raw):
                    if osd == to:
                        exists = True
                        break
                    if osd == frm and pos < 0 and not (
                            to != CRUSH_ITEM_NONE and 0 <= to
                            < self.max_osd and self.osd_weight[to] == 0):
                        pos = i
                if not exists and pos >= 0:
                    raw[pos] = to
        return raw

    def _raw_to_up_osds(self, pool: PgPool,
                        raw: List[int]) -> List[int]:
        if pool.can_shift_osds():
            return [o for o in raw
                    if self.exists(o) and not self.is_down(o)]
        return [o if self.exists(o) and not self.is_down(o)
                else CRUSH_ITEM_NONE for o in raw]

    @staticmethod
    def _pick_primary(osds: List[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(self, pps: int, pool: PgPool,
                                osds: List[int],
                                primary: int) -> Tuple[List[int], int]:
        aff = self.osd_primary_affinity
        if aff is None:
            return osds, primary
        if not any(o != CRUSH_ITEM_NONE
                   and aff[o] != DEFAULT_PRIMARY_AFFINITY
                   for o in osds):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = aff[o]
            if a < MAX_PRIMARY_AFFINITY and \
                    (hash32_2_int(pps, o) >> 16) >= a:
                if pos < 0:
                    pos = i  # fallback if nobody accepts
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            osds = [osds[pos]] + osds[:pos] + osds[pos + 1:]
        return osds, primary

    def _get_temp_osds(self, pool: PgPool, pgid: Tuple[int, int],
                       ) -> Tuple[List[int], int]:
        temp: List[int] = []
        t = self.pg_temp.get(pgid)
        if t is not None:
            for o in t:
                if not self.exists(o) or self.is_down(o):
                    if pool.can_shift_osds():
                        continue
                    temp.append(CRUSH_ITEM_NONE)
                else:
                    temp.append(o)
        tp = self.primary_temp.get(pgid, -1)
        if tp == -1 and temp:
            for o in temp:
                if o != CRUSH_ITEM_NONE:
                    tp = o
                    break
        return temp, tp

    def pg_to_up_acting_osds(self, pool_id: int, ps: int):
        """OSDMap.cc:2665.  Returns (up, up_primary, acting,
        acting_primary)."""
        pool = self.pools.get(pool_id)
        if pool is None or ps >= pool.pg_num:
            return [], -1, [], -1
        pgid = (pool_id, pool.raw_pg_to_ps(ps))
        acting, acting_primary = self._get_temp_osds(pool, pgid)
        raw, pps = self._pg_to_raw_osds(pool_id, pool, ps)
        raw = self._apply_upmap(pool, pgid, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._pick_primary(up)
        up, up_primary = self._apply_primary_affinity(
            pps, pool, up, up_primary)
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    # -- serialization (the map file, as ceph_tpu writes it) ----------
    def to_dict(self):
        def kv(d):
            return [[list(k), v] for k, v in sorted(d.items())]

        return {
            "epoch": self.epoch,
            "max_osd": self.max_osd,
            "osd_state": list(self.osd_state),
            "osd_weight": list(self.osd_weight),
            "osd_primary_affinity": self.osd_primary_affinity,
            "pools": {str(k): v.to_dict() for k, v in self.pools.items()},
            "pg_upmap": kv(self.pg_upmap),
            "pg_upmap_items": kv(self.pg_upmap_items),
            "pg_temp": kv(self.pg_temp),
            "primary_temp": kv(self.primary_temp),
            "crush": self.crush.to_dict(),
        }

    @classmethod
    def from_dict(cls, d) -> "OSDMap":
        m = cls(CrushMap.from_dict(d["crush"]))
        m.epoch = d.get("epoch", 1)
        m.max_osd = d["max_osd"]
        m.osd_state = list(d["osd_state"])
        m.osd_weight = list(d["osd_weight"])
        aff = d.get("osd_primary_affinity")
        m.osd_primary_affinity = None if aff is None else list(aff)
        m.pools = {int(k): PgPool.from_dict(v)
                   for k, v in d["pools"].items()}
        m.pg_upmap = {tuple(k): list(v) for k, v in d["pg_upmap"]}
        m.pg_upmap_items = {tuple(k): [tuple(p) for p in v]
                            for k, v in d["pg_upmap_items"]}
        m.pg_temp = {tuple(k): list(v) for k, v in d["pg_temp"]}
        m.primary_temp = {tuple(k): v for k, v in d["primary_temp"]}
        return m

    def to_json(self) -> str:
        return encoding.encode(self.to_dict(), self.STRUCT_V,
                               self.COMPAT_V)

    @classmethod
    def from_json(cls, s: str) -> "OSDMap":
        v, d = encoding.decode_any(s, supported=cls.STRUCT_V,
                                   struct="osdmap.json")
        try:
            return cls.from_dict(d)
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise encoding.MalformedInput(
                f"osdmap.json v{v}: bad payload: {e!r}")
