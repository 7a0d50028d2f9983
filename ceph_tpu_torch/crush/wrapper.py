"""CrushWrapper: the named, mutable facade over the crush map.

The port's copy of ``ceph_tpu/crush/wrapper.py``, the role of the
reference's ``CrushWrapper`` (src/crush/CrushWrapper.h): name, type and
rule-name maps, topology edits with weight propagation (insert_item,
move_bucket, swap_bucket, remove_item, adjust_item_weight, reweight;
CrushWrapper.h:802-964,1214), device classes through shadow trees
(device_class_clone, populate_classes; CrushWrapper.h:1304),
add_simple_rule (:1167), the host ``do_rule`` (:1508) on the port's
scalar ``mapper_ref``, and the upmap remap engine ``try_remap_rule`` /
``_choose_type_stack`` (CrushWrapper.cc:3841-4150) that the balancer
drives.  Shadow bucket ids come from the same registry in the same
order as in ``ceph_tpu``, so class rules and K2's arrays key on the
same ids in both packages.  Batched placement is
``osdmap.pipeline.PoolMapper`` on the map this class owns.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import constants as C
from .builder import (bucket_add_item, bucket_adjust_item_weight,
                      bucket_remove_item, make_straw2_bucket,
                      reweight_bucket)
from .map import Bucket, CrushMap, Rule, RuleStep
from .mapper_ref import crush_do_rule

DEFAULT_TYPES = {0: "osd", 1: "host", 2: "rack", 3: "root"}


class CrushWrapper:
    """Mutable, named view of a :class:`CrushMap`."""

    def __init__(self, cmap: Optional[CrushMap] = None,
                 types: Optional[Dict[int, str]] = None):
        self.crush = cmap or CrushMap()
        # an explicitly-empty types dict is honored (the compiler
        # starts from nothing); only None means "use the defaults"
        self.type_map: Dict[int, str] = dict(
            DEFAULT_TYPES if types is None else types)
        self.name_map: Dict[int, str] = {}        # item/bucket id -> name
        self.rule_name_map: Dict[int, str] = {}
        # device classes (CrushWrapper.h:1280-1340)
        self.class_map: Dict[int, int] = {}       # device id -> class id
        self.class_name: Dict[int, str] = {}      # class id -> name
        # (original bucket id, class id) -> shadow bucket id
        self.class_bucket: Dict[Tuple[int, int], int] = {}
        self._shadow_ids: Set[int] = set()
        # shadow ids survive rebuilds so class rules stay valid
        self._shadow_id_registry: Dict[Tuple[int, int], int] = {}
        self._shadow_dirty = False
        # topology caches (parent index, subtree sets, name reverse
        # map): the balancer's remap engine does these lookups per-OSD
        # per-level on 10k-OSD maps, so they must be O(1), not scans.
        # Keyed by (version, bucket count) — wrapper mutators bump the
        # version; direct CrushMap bucket additions change the count;
        # anything else must call invalidate_caches().
        self._topo_version = 0
        self._idx_key: Tuple = ()
        self._parent_idx: Dict[int, int] = {}
        self._name_idx: Dict[str, int] = {}
        self._desc_cache: Dict[int, Set[int]] = {}
        self._cot_cache: Dict[Tuple[int, int], List[int]] = {}

    def invalidate_caches(self) -> None:
        self._topo_version += 1

    def _indexes(self) -> None:
        key = (self._topo_version, len(self.crush.buckets),
               len(self.name_map))
        if self._idx_key != key:
            parent: Dict[int, int] = {}
            for b in self.crush.buckets.values():
                if b.id in self._shadow_ids:
                    continue
                for it in b.items:
                    parent[it] = b.id
            self._parent_idx = parent
            self._name_idx = {n: i for i, n in self.name_map.items()}
            self._desc_cache = {}
            self._cot_cache = {}
            self._idx_key = key

    # -- name maps (CrushWrapper.h:490-630) ---------------------------
    def get_item_name(self, item: int) -> str:
        return self.name_map.get(item, f"item{item}")

    def get_item_id(self, name: str) -> int:
        self._indexes()
        if name not in self._name_idx:
            raise KeyError(f"no item named {name!r}")
        return self._name_idx[name]

    def name_exists(self, name: str) -> bool:
        self._indexes()
        return name in self._name_idx

    def set_item_name(self, item: int, name: str) -> None:
        if self.name_exists(name) and \
                self.name_map.get(item) != name:
            raise ValueError(f"name {name!r} already in use")
        self.name_map[item] = name
        self.invalidate_caches()  # renames keep len(name_map) constant

    def rename_item(self, old: str, new: str) -> None:
        self.set_item_name(self.get_item_id(old), new)

    def get_type_id(self, name: str) -> int:
        for t, n in self.type_map.items():
            if n == name:
                return t
        raise KeyError(f"no type named {name!r}")

    def get_type_name(self, t: int) -> str:
        return self.type_map.get(t, f"type{t}")

    def set_type_name(self, t: int, name: str) -> None:
        self.type_map[t] = name

    def get_rule_id(self, name: str) -> int:
        for r, n in self.rule_name_map.items():
            if n == name:
                return r
        raise KeyError(f"no rule named {name!r}")

    def get_rule_name(self, ruleno: int) -> str:
        return self.rule_name_map.get(ruleno, f"rule{ruleno}")

    # -- device classes -----------------------------------------------
    def get_or_create_class_id(self, name: str) -> int:
        for cid, n in self.class_name.items():
            if n == name:
                return cid
        cid = max(self.class_name, default=-1) + 1
        self.class_name[cid] = name
        return cid

    def class_exists(self, name: str) -> bool:
        return name in self.class_name.values()

    def set_item_class(self, item: int, name: str) -> int:
        cid = self.get_or_create_class_id(name)
        self.class_map[item] = cid
        return cid

    def get_item_class(self, item: int) -> Optional[str]:
        cid = self.class_map.get(item)
        return None if cid is None else self.class_name[cid]

    # -- structure queries --------------------------------------------
    def get_bucket(self, bid: int) -> Bucket:
        b = self.crush.bucket_by_id(bid)
        if b is None:
            raise KeyError(f"no bucket {bid}")
        return b

    def get_bucket_type(self, bid: int) -> int:
        if bid >= 0:
            return 0
        return self.get_bucket(bid).type

    def get_children(self, bid: int) -> List[int]:
        if bid >= 0:
            return []
        return list(self.get_bucket(bid).items)

    def get_immediate_parent_id(self, item: int) -> Optional[int]:
        self._indexes()
        return self._parent_idx.get(item)

    def _descendants(self, root: int) -> Set[int]:
        self._indexes()
        got = self._desc_cache.get(root)
        if got is None:
            got = {root}
            stack = [root]
            while stack:
                cur = stack.pop()
                if cur < 0:
                    for child in self.get_bucket(cur).items:
                        got.add(child)
                        stack.append(child)
            self._desc_cache[root] = got
        return got

    def subtree_contains(self, root: int, item: int) -> bool:
        if root >= 0:
            return root == item
        return item in self._descendants(root)

    def get_leaves(self, root: int) -> List[int]:
        """All devices under ``root`` (subtree walk)."""
        if root >= 0:
            return [root]
        out: List[int] = []
        for child in self.get_bucket(root).items:
            out.extend(self.get_leaves(child))
        return out

    def get_children_of_type(self, root: int, type_: int) -> List[int]:
        self._indexes()
        key = (root, type_)
        got = self._cot_cache.get(key)
        if got is None:
            if self.get_bucket_type(root) == type_:
                got = [root]
            elif root >= 0:
                got = []
            else:
                got = []
                for child in self.get_bucket(root).items:
                    got.extend(self.get_children_of_type(child, type_))
            self._cot_cache[key] = got
        return got

    def find_takes_by_rule(self, ruleno: int) -> List[int]:
        roots = []
        for s in self.crush.rules[ruleno].steps:
            if s.op == C.CRUSH_RULE_TAKE:
                roots.append(s.arg1)
        return roots

    def get_parent_of_type(self, item: int, type_: int,
                           ruleno: int = -1) -> int:
        """CrushWrapper.cc:1662: the ancestor bucket of ``type_``
        containing ``item`` (rule-scoped when ruleno >= 0)."""
        if ruleno < 0:
            cur = item
            while True:
                p = self.get_immediate_parent_id(cur)
                if p is None:
                    return 0
                cur = p
                if self.get_bucket_type(cur) == type_:
                    return cur
        for root in self.find_takes_by_rule(ruleno):
            for cand in self.get_children_of_type(root, type_):
                if self.subtree_contains(cand, item):
                    return cand
        return 0

    def get_item_weight(self, item: int) -> int:
        """Weight of an item in its parent (16.16)."""
        p = self.get_immediate_parent_id(item)
        if p is None:
            raise KeyError(f"item {item} not in any bucket")
        b = self.get_bucket(p)
        return b.item_weight_at(b.items.index(item))

    # -- topology edits (CrushWrapper.h:802-964,1214) ------------------
    def _loc_bucket(self, loc: Dict[str, str],
                    create: bool = True) -> int:
        """Resolve/build the bucket chain described by
        ``{type_name: bucket_name}`` (deepest existing wins); returns
        the id of the LOWEST bucket in the chain."""
        order = sorted(((self.get_type_id(t), t, n)
                        for t, n in loc.items()))
        child_id: Optional[int] = None
        child_weight = 0
        lowest: Optional[int] = None
        for type_id, _t, name in order:
            if self.name_exists(name):
                bid = self.get_item_id(name)
                if child_id is not None and \
                        child_id not in self.get_bucket(bid).items:
                    bucket_add_item(self.get_bucket(bid), child_id,
                                    child_weight)
                    self.invalidate_caches()  # new parent edge
                    self._propagate(bid, child_weight)
            else:
                if not create:
                    raise KeyError(f"no bucket named {name!r}")
                b = make_straw2_bucket([], [], type_id)
                bid = self.crush.add_bucket(b)
                self.set_item_name(bid, name)
                if child_id is not None:
                    bucket_add_item(b, child_id, child_weight)
                    self.invalidate_caches()
            if lowest is None:
                lowest = bid
            child_id = bid
            child_weight = self.get_bucket(bid).weight
        if lowest is None:
            raise ValueError("empty crush location")
        return lowest

    def _propagate(self, start_bid: int, diff: int) -> None:
        """Add ``diff`` to every ancestor's record of its child chain —
        the weight-propagation of adjust_item_weight (CrushWrapper.cc
        adjust_item_weight walking all containing buckets)."""
        cur = start_bid
        while diff:
            parent = self.get_immediate_parent_id(cur)
            if parent is None:
                break
            pb = self.get_bucket(parent)
            pos = pb.items.index(cur)
            if pb.alg == C.CRUSH_BUCKET_UNIFORM:
                break  # uniform parents don't track child weights
            bucket_adjust_item_weight(
                pb, cur, pb.item_weights[pos] + diff)
            cur = parent

    def insert_item(self, item: int, weight: int, name: str,
                    loc: Dict[str, str]) -> None:
        """CrushWrapper::insert_item (CrushWrapper.h:802): place device
        ``item`` at ``loc`` with ``weight``, creating intermediate
        buckets as needed."""
        if item < 0:
            raise ValueError("insert_item inserts devices (id >= 0)")
        bid = self._loc_bucket(loc, create=True)
        bucket_add_item(self.get_bucket(bid), item, weight)
        self._propagate(bid, weight)
        self.set_item_name(item, name)
        self.crush.max_devices = max(self.crush.max_devices, item + 1)
        self._shadow_dirty = True
        self.invalidate_caches()

    def remove_item(self, item: int) -> None:
        """CrushWrapper::remove_item (CrushWrapper.h:964≈)."""
        p = self.get_immediate_parent_id(item)
        if p is None:
            return
        removed = bucket_remove_item(self.get_bucket(p), item)
        self._propagate(p, -removed)
        self.name_map.pop(item, None)
        self.class_map.pop(item, None)
        self._shadow_dirty = True
        self.invalidate_caches()

    def move_bucket(self, bid: int, loc: Dict[str, str]) -> None:
        """CrushWrapper::move_bucket (CrushWrapper.h:817): detach the
        bucket from its parent and re-attach it at ``loc``."""
        b = self.get_bucket(bid)
        # validate BEFORE detaching: a failed move must not corrupt the
        # map (chain creation for dest is harmless — empty buckets)
        dest = self._loc_bucket(loc, create=True)
        if self.subtree_contains(bid, dest):
            raise ValueError("moving a bucket under itself")
        p = self.get_immediate_parent_id(bid)
        if p is not None:
            w = bucket_remove_item(self.get_bucket(p), bid)
            self._propagate(p, -w)
        bucket_add_item(self.get_bucket(dest), bid, b.weight)
        self._propagate(dest, b.weight)
        self._shadow_dirty = True
        self.invalidate_caches()

    def swap_bucket(self, a: int, b: int) -> None:
        """CrushWrapper::swap_bucket: exchange contents (items/weights)
        of two buckets; names/ids stay."""
        ba, bb = self.get_bucket(a), self.get_bucket(b)
        for f in ("items", "item_weights", "sum_weights", "node_weights",
                  "num_nodes", "item_weight", "weight", "straws"):
            va, vb = getattr(ba, f), getattr(bb, f)
            setattr(ba, f, vb)
            setattr(bb, f, va)
        diff = ba.weight - bb.weight
        pa = self.get_immediate_parent_id(a)
        if pa is not None:
            bucket_adjust_item_weight(self.get_bucket(pa), a, ba.weight)
            self._propagate(pa, diff)
        pb_ = self.get_immediate_parent_id(b)
        if pb_ is not None:
            bucket_adjust_item_weight(self.get_bucket(pb_), b, bb.weight)
            self._propagate(pb_, -diff)
        self._shadow_dirty = True
        self.invalidate_caches()

    def adjust_item_weight(self, item: int, weight: int) -> None:
        """CrushWrapper::adjust_item_weight(f) (CrushWrapper.h:964):
        set the device weight everywhere it appears, propagating the
        delta up each ancestor chain."""
        for b in list(self.crush.buckets.values()):
            if b.id in self._shadow_ids:
                continue
            if item in b.items:
                diff = bucket_adjust_item_weight(b, item, weight)
                self._propagate(b.id, diff)
        self._shadow_dirty = True
        self.invalidate_caches()

    def reweight(self) -> None:
        """crushtool --reweight: recompute every bucket's weight
        bottom-up from its children (builder.c crush_reweight_bucket
        over all roots)."""
        for b in list(self.crush.buckets.values()):
            if b.id in self._shadow_ids:
                continue
            if self.get_immediate_parent_id(b.id) is None:
                reweight_bucket(self.crush, b)
        self._shadow_dirty = True
        self.invalidate_caches()

    # -- rules ---------------------------------------------------------
    def add_simple_rule(self, name: str, root_name: str,
                        failure_domain: str = "host",
                        device_class: str = "",
                        mode: str = "firstn",
                        rule_type: int = 1,
                        ruleno: int = -1) -> int:
        """CrushWrapper::add_simple_rule (CrushWrapper.h:1167):
        take <root>[~class] -> chooseleaf <mode> 0 type <fd> -> emit.
        This is the signature ``ErasureCode.create_rule`` calls."""
        root = self.get_item_id(root_name)
        if device_class:
            if not self.class_exists(device_class):
                raise KeyError(f"no device class {device_class!r}")
            cid = self.get_or_create_class_id(device_class)
            self.populate_classes()
            shadow = self.class_bucket.get((root, cid))
            if shadow is None:
                raise ValueError(
                    f"root {root_name} has no {device_class} devices")
            root = shadow
        leaf_type = self.get_type_id(failure_domain) \
            if failure_domain else 0
        op = (C.CRUSH_RULE_CHOOSELEAF_FIRSTN if mode == "firstn"
              else C.CRUSH_RULE_CHOOSELEAF_INDEP)
        if leaf_type == 0:
            op = (C.CRUSH_RULE_CHOOSE_FIRSTN if mode == "firstn"
                  else C.CRUSH_RULE_CHOOSE_INDEP)
        steps = [RuleStep(C.CRUSH_RULE_TAKE, root, 0),
                 RuleStep(op, 0, leaf_type),
                 RuleStep(C.CRUSH_RULE_EMIT, 0, 0)]
        rid = self.crush.add_rule(Rule(steps=steps, type=rule_type),
                                  ruleno)
        self.rule_name_map[rid] = name
        return rid

    # -- shadow trees (device classes) ---------------------------------
    def device_class_clone(self, original_id: int, class_id: int) -> int:
        """CrushWrapper.h:1304 device_class_clone: a parallel hierarchy
        containing only devices of ``class_id``.  Devices keep their
        ids; buckets are cloned under fresh ids.  Returns the shadow
        bucket id (devices pass through)."""
        if original_id >= 0:
            return original_id
        key = (original_id, class_id)
        if key in self.class_bucket:
            return self.class_bucket[key]
        orig = self.get_bucket(original_id)
        items: List[int] = []
        weights: List[int] = []
        for pos, child in enumerate(orig.items):
            if child >= 0:
                if self.class_map.get(child) != class_id:
                    continue
                items.append(child)
                weights.append(orig.item_weight_at(pos))
            else:
                sub = self.device_class_clone(child, class_id)
                subw = self.get_bucket(sub).weight
                if not self.get_bucket(sub).items:
                    continue  # empty shadow subtree: skip
                items.append(sub)
                weights.append(subw)
        clone = Bucket(id=self._shadow_id_registry.get(key, 0),
                       alg=orig.alg, type=orig.type,
                       hash=orig.hash, items=items,
                       item_weights=list(weights),
                       weight=sum(weights))
        if orig.alg == C.CRUSH_BUCKET_UNIFORM:
            clone.item_weights = []
            clone.item_weight = orig.item_weight
            clone.weight = orig.item_weight * len(items)
        sid = self.crush.add_bucket(clone)
        self._shadow_id_registry[key] = sid  # stable across rebuilds
        self._shadow_ids.add(sid)
        self.class_bucket[key] = sid
        cname = self.class_name[class_id]
        self.set_item_name(
            sid, f"{self.get_item_name(original_id)}~{cname}")
        return sid

    def populate_classes(self) -> None:
        """Build/refresh shadow trees for every (root, class) pair —
        rebuild_roots_with_classes (CrushWrapper.cc).  Shadow bucket ids
        are stable across rebuilds so existing class rules stay valid."""
        self._clear_shadow()
        roots = [b.id for b in self.crush.buckets.values()
                 if self.get_immediate_parent_id(b.id) is None
                 and b.id not in self._shadow_ids]
        for root in roots:
            classes = {self.class_map[d]
                       for d in self.get_leaves(root)
                       if d in self.class_map}
            for cid in classes:
                self.device_class_clone(root, cid)
        self._shadow_dirty = False

    def _refresh_shadow(self) -> None:
        """Rebuild stale shadow trees before any map consumption —
        topology/weight edits mark them dirty."""
        if self._shadow_dirty and self._shadow_id_registry:
            self.populate_classes()

    def _clear_shadow(self) -> None:
        for sid in self._shadow_ids:
            self.crush.buckets.pop(-1 - sid, None)
            self.name_map.pop(sid, None)
        self._shadow_ids.clear()
        self.class_bucket.clear()

    # -- mapping (host-side) ------------------------------------------
    def do_rule(self, ruleno: int, x: int, numrep: int,
                weight: Sequence[int]) -> List[int]:
        """CrushWrapper::do_rule (CrushWrapper.h:1508) on the scalar
        mapper; batch callers go through ``PoolMapper``."""
        self._refresh_shadow()
        return crush_do_rule(self.crush, ruleno, x, numrep, list(weight))

    # -- serialization (the framework's native named-map format) -------
    def to_dict(self) -> Dict:
        """CrushWrapper::encode parity: the map plus its name/type/
        class metadata (CrushWrapper.h:1550)."""
        self._refresh_shadow()
        return {
            "map": self.crush.to_dict(),
            "type_map": {str(k): v for k, v in self.type_map.items()},
            "name_map": {str(k): v for k, v in self.name_map.items()},
            "rule_name_map": {str(k): v
                              for k, v in self.rule_name_map.items()},
            "class_map": {str(k): v for k, v in self.class_map.items()},
            "class_name": {str(k): v
                           for k, v in self.class_name.items()},
            "shadow_ids": sorted(self._shadow_ids),
            "class_bucket": [[list(k), v]
                             for k, v in sorted(
                                 self.class_bucket.items())],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "CrushWrapper":
        w = cls(CrushMap.from_dict(d["map"]),
                types={int(k): v for k, v in d["type_map"].items()})
        w.name_map = {int(k): v for k, v in d["name_map"].items()}
        w.rule_name_map = {int(k): v
                           for k, v in d["rule_name_map"].items()}
        w.class_map = {int(k): v for k, v in d["class_map"].items()}
        w.class_name = {int(k): v for k, v in d["class_name"].items()}
        w._shadow_ids = set(d.get("shadow_ids", []))
        for key, sid in d.get("class_bucket", []):
            w.class_bucket[tuple(key)] = sid
            w._shadow_id_registry[tuple(key)] = sid
        return w

    # -- upmap engine (CrushWrapper.cc:3841-4150) ----------------------
    def try_remap_rule(self, ruleno: int, maxout: int,
                       overfull: Set[int], underfull: List[int],
                       more_underfull: List[int],
                       orig: List[int]) -> List[int]:
        """Remap ``orig`` (a raw pg mapping) swapping overfull devices
        for underfull ones while honoring the rule's failure-domain
        structure; returns the new mapping (possibly == orig)."""
        self._refresh_shadow()
        rule = self.crush.rules[ruleno]
        w: List[int] = []
        out: List[int] = []
        state = {"i": 0, "used": set()}
        type_stack: List[Tuple[int, int]] = []
        root_bucket = 0
        for step in rule.steps:
            if step.op == C.CRUSH_RULE_TAKE:
                w = [step.arg1]
                root_bucket = step.arg1
            elif step.op in (C.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                             C.CRUSH_RULE_CHOOSELEAF_INDEP):
                numrep = step.arg1
                if numrep <= 0:
                    numrep += maxout
                type_stack.append((step.arg2, numrep))
                if step.arg2 > 0:
                    type_stack.append((0, 1))
                w = self._choose_type_stack(
                    type_stack, overfull, underfull, more_underfull,
                    orig, state, w, root_bucket, ruleno)
                type_stack = []
            elif step.op in (C.CRUSH_RULE_CHOOSE_FIRSTN,
                             C.CRUSH_RULE_CHOOSE_INDEP):
                numrep = step.arg1
                if numrep <= 0:
                    numrep += maxout
                type_stack.append((step.arg2, numrep))
            elif step.op == C.CRUSH_RULE_EMIT:
                if type_stack:
                    w = self._choose_type_stack(
                        type_stack, overfull, underfull, more_underfull,
                        orig, state, w, root_bucket, ruleno)
                    type_stack = []
                out.extend(w)
                w = []
        return out

    def _choose_type_stack(self, stack, overfull, underfull,
                           more_underfull, orig, state, pw,
                           root_bucket, ruleno) -> List[int]:
        """CrushWrapper.cc:3841 _choose_type_stack, iterator state in
        ``state`` ({'i': index into orig, 'used': set})."""
        w = list(pw)
        cumulative_fanout = [0] * len(stack)
        f = 1
        for j in range(len(stack) - 1, -1, -1):
            cumulative_fanout[j] = f
            f *= stack[j][1]

        # per-level buckets that still have underfull devices below
        underfull_buckets: List[Set[int]] = \
            [set() for _ in range(max(0, len(stack) - 1))]
        for osd in underfull:
            item = osd
            for j in range(len(stack) - 2, -1, -1):
                type_ = stack[j][0]
                item = self.get_parent_of_type(item, type_, ruleno)
                if not self.subtree_contains(root_bucket, item):
                    continue
                underfull_buckets[j].add(item)

        for j, (type_, fanout) in enumerate(stack):
            cum_fanout = cumulative_fanout[j]
            o: List[int] = []
            # tmpi shadows i at non-leaf levels (i itself only advances
            # at the leaf level), initialized once per level as in the C
            tmpi = state["i"]
            if state["i"] >= len(orig):
                break
            for from_ in w:
                base = len(o)  # this from_'s slice of o
                leaves: List[Set[int]] = [set() for _ in range(fanout)]
                for pos in range(fanout):
                    if type_ > 0:
                        item = self.get_parent_of_type(
                            orig[tmpi], type_, ruleno)
                        o.append(item)
                        n = cum_fanout
                        while n and tmpi < len(orig):
                            leaves[pos].add(orig[tmpi])
                            tmpi += 1
                            n -= 1
                    else:
                        cur = orig[state["i"]]
                        replaced = False
                        if cur in overfull:
                            for cands in (underfull, more_underfull):
                                for item in cands:
                                    if item in state["used"]:
                                        continue
                                    if not self.subtree_contains(
                                            from_, item):
                                        continue
                                    if item in orig:
                                        continue
                                    o.append(item)
                                    state["used"].add(item)
                                    state["i"] += 1
                                    replaced = True
                                    break
                                if replaced:
                                    break
                        if not replaced:
                            o.append(cur)
                            state["i"] += 1
                        if state["i"] >= len(orig):
                            break
                if j + 1 < len(stack):
                    # reject buckets with overfull leaves but no
                    # underfull candidates; prefer same-parent peers
                    for pos in range(base, len(o)):
                        if o[pos] in underfull_buckets[j]:
                            continue
                        if not any(osd in overfull
                                   for osd in leaves[pos - base]):
                            continue
                        for alt in sorted(underfull_buckets[j]):
                            if alt in o:
                                continue
                            if j == 0 or \
                                    self.get_parent_of_type(
                                        o[pos], stack[j - 1][0],
                                        ruleno) == \
                                    self.get_parent_of_type(
                                        alt, stack[j - 1][0], ruleno):
                                o[pos] = alt
                                break
                if (type_ > 0 and tmpi >= len(orig)) or \
                        (type_ == 0 and state["i"] >= len(orig)):
                    break
            w = o
        return w
