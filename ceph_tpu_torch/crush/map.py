"""The CRUSH map data model (host side).

The port's own copy of ``ceph_tpu/crush/map.py``: buckets (the weighted
hierarchy), rules (placement programs), tunables and choose_args, with
the dict form both packages read and write.
Bucket ids are negative (id = -1 - index); devices are >= 0, as in the
reference (src/crush/crush.h:219-451).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..common import encoding
from . import constants as C


@dataclass
class Tunables:
    """Mapping behavior knobs (crush.h:363-411).  Defaults = "optimal"."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1

    @classmethod
    def legacy(cls) -> "Tunables":
        """The most ancient behavior (builder.c set_legacy_crush_map):
        local retries and the perm fallback on, 19 total tries."""
        return cls(2, 5, 19, 0, 0, 0)

    def to_dict(self):
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: int(v) for k, v in d.items()})


@dataclass
class Bucket:
    """One weighted container in the hierarchy (crush.h:219-333).

    ``weight`` and all per-item weights are 16.16 fixed point.  Per-alg
    payload fields:
      uniform: item_weight (single value)
      list:    item_weights + sum_weights (head prefix sums)
      tree:    node_weights over the implicit binary tree, num_nodes
      straw:   item_weights + precomputed straws
      straw2:  item_weights
    """

    id: int
    alg: int
    type: int
    items: List[int]
    hash: int = C.CRUSH_HASH_RJENKINS1
    weight: int = 0
    item_weight: int = 0
    item_weights: List[int] = field(default_factory=list)
    sum_weights: List[int] = field(default_factory=list)
    node_weights: List[int] = field(default_factory=list)
    num_nodes: int = 0
    straws: List[int] = field(default_factory=list)

    @property
    def size(self) -> int:
        return len(self.items)

    def item_weight_at(self, pos: int) -> int:
        """crush_get_bucket_item_weight semantics (crush.c)."""
        if pos < 0 or pos >= self.size:
            return 0
        if self.alg == C.CRUSH_BUCKET_UNIFORM:
            return self.item_weight
        if self.alg == C.CRUSH_BUCKET_TREE:
            return self.node_weights[((pos + 1) << 1) - 1]
        return self.item_weights[pos]

    def to_dict(self):
        d = {
            "id": self.id,
            "alg": self.alg,
            "hash": self.hash,
            "type": self.type,
            "weight": self.weight,
            "size": self.size,
            "items": list(self.items),
        }
        if self.alg == C.CRUSH_BUCKET_UNIFORM:
            d["item_weight"] = self.item_weight
        elif self.alg == C.CRUSH_BUCKET_LIST:
            d["item_weights"] = list(self.item_weights)
            d["sum_weights"] = list(self.sum_weights)
        elif self.alg == C.CRUSH_BUCKET_TREE:
            d["num_nodes"] = self.num_nodes
            d["node_weights"] = list(self.node_weights)
        elif self.alg == C.CRUSH_BUCKET_STRAW:
            d["item_weights"] = list(self.item_weights)
            d["straws"] = list(self.straws)
        else:
            d["item_weights"] = list(self.item_weights)
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(
            id=d["id"],
            alg=d["alg"],
            hash=d.get("hash", C.CRUSH_HASH_RJENKINS1),
            type=d["type"],
            weight=d.get("weight", 0),
            items=list(d["items"]),
            item_weight=d.get("item_weight", 0),
            item_weights=list(d.get("item_weights", [])),
            sum_weights=list(d.get("sum_weights", [])),
            node_weights=list(d.get("node_weights", [])),
            num_nodes=d.get("num_nodes", 0),
            straws=list(d.get("straws", [])),
        )


@dataclass
class RuleStep:
    op: int
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    """A placement program: a list of steps for the rule VM
    (crush.h:78-85; executed by crush_do_rule, mapper.c:878)."""

    steps: List[RuleStep]
    type: int = 1

    def to_dict(self):
        return {"steps": [[s.op, s.arg1, s.arg2] for s in self.steps],
                "type": self.type}

    @classmethod
    def from_dict(cls, d):
        return cls(steps=[RuleStep(*s) for s in d["steps"]],
                   type=d.get("type", 1))


@dataclass
class ChooseArg:
    """Per-bucket substitute weights/ids for placement (crush.h:263-268)."""

    ids: Optional[List[int]] = None
    weight_set: Optional[List[List[int]]] = None


class ChooseArgMap(dict):
    """bucket_index -> ChooseArg (crush.h:281-284)."""


class CrushMap:
    """The host-side crush map."""

    # wire/disk JSON form version (wirecheck entry crush.map_json):
    # to_json wraps the dict in the versioned envelope; from_json also
    # accepts the pre-envelope raw dict (writer v0) so archived maps
    # keep decoding
    STRUCT_V = 1
    COMPAT_V = 1

    def __init__(self, tunables: Optional[Tunables] = None):
        self.buckets: Dict[int, Bucket] = {}  # keyed by bucket index (-1-id)
        self.rules: Dict[int, Rule] = {}
        self.tunables = tunables or Tunables()
        self.max_devices = 0
        self._max_buckets = 0
        self.choose_args: Dict[object, ChooseArgMap] = {}

    @property
    def max_buckets(self) -> int:
        return self._max_buckets

    def bucket_by_id(self, bid: int) -> Optional[Bucket]:
        return self.buckets.get(-1 - bid)

    def add_bucket(self, bucket: Bucket) -> int:
        """Insert with an explicit id (bucket.id < 0) or allocate the next
        free index if bucket.id == 0 (builder.c crush_add_bucket)."""
        if bucket.id == 0:
            idx = 0
            while idx in self.buckets:
                idx += 1
            bucket.id = -1 - idx
        idx = -1 - bucket.id
        if idx < 0:
            raise ValueError(f"bucket id must be negative, got {bucket.id}")
        if idx in self.buckets:
            raise ValueError(f"bucket id {bucket.id} already present")
        self.buckets[idx] = bucket
        self._max_buckets = max(self._max_buckets, idx + 1)
        self._note_devices(bucket.items)
        return bucket.id

    def _note_devices(self, items):
        for it in items:
            if it >= 0:
                self.max_devices = max(self.max_devices, it + 1)

    def add_rule(self, rule: Rule, ruleno: int = -1) -> int:
        if ruleno < 0:
            ruleno = 0
            while ruleno in self.rules:
                ruleno += 1
        if ruleno in self.rules:
            raise ValueError(f"rule {ruleno} already present")
        self.rules[ruleno] = rule
        return ruleno

    @property
    def max_rules(self) -> int:
        return (max(self.rules) + 1) if self.rules else 0

    def to_dict(self):
        d = {
            "max_devices": self.max_devices,
            "max_buckets": self.max_buckets,
            "max_rules": self.max_rules,
            "tunables": self.tunables.to_dict(),
            "buckets": [self.buckets[i].to_dict()
                        for i in sorted(self.buckets)],
            "rules": [{"ruleno": rno, **self.rules[rno].to_dict()}
                      for rno in sorted(self.rules)],
        }
        if self.choose_args:
            d["choose_args"] = {
                str(key): [{"bucket_index": bi,
                            "ids": ca.ids,
                            "weight_set": ca.weight_set}
                           for bi, ca in sorted(cam.items())]
                for key, cam in self.choose_args.items()
            }
        return d

    @classmethod
    def from_dict(cls, d) -> "CrushMap":
        m = cls(tunables=Tunables.from_dict(d.get("tunables", {})))
        for bd in d.get("buckets", []):
            m.add_bucket(Bucket.from_dict(bd))
        for rd in d.get("rules", []):
            m.add_rule(Rule.from_dict(rd), rd.get("ruleno", -1))
        m.max_devices = max(m.max_devices, d.get("max_devices", 0))
        ca_in = d.get("choose_args")
        if isinstance(ca_in, list):
            # golden-vector format: one anonymous set
            cam = ChooseArgMap()
            for e in ca_in:
                cam[e["bucket_index"]] = ChooseArg(
                    ids=e.get("ids"), weight_set=e.get("weight_set"))
            m.choose_args["golden"] = cam
        elif isinstance(ca_in, dict):
            for key, entries in ca_in.items():
                cam = ChooseArgMap()
                for e in entries:
                    cam[e["bucket_index"]] = ChooseArg(
                        ids=e.get("ids"),
                        weight_set=e.get("weight_set"))
                if isinstance(key, str) and key.lstrip("-").isdigit():
                    key = int(key)
                m.choose_args[key] = cam
        return m

    def to_json(self) -> str:
        return encoding.encode(self.to_dict(), self.STRUCT_V,
                               self.COMPAT_V)

    @classmethod
    def from_json(cls, s: str) -> "CrushMap":
        v, d = encoding.decode_any(s, supported=cls.STRUCT_V,
                                   struct="crush.map_json")
        try:
            return cls.from_dict(d)
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise encoding.MalformedInput(
                f"crush.map_json v{v}: bad payload: {e!r}")
