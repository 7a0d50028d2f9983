"""Speculative straw2 mapper: the dense path for common rules, as
PyTorch ops.

The port of ``ceph_tpu/crush/mapper_spec.py``.  For straw2-only
hierarchies mapped by a ``take / choose(leaf) firstn|indep / emit`` rule
under modern tunables (no local retries), one try of the reference's
retry loop (crush_choose_firstn, src/crush/mapper.c:438-626) is a pure
descent from the take root whose depth the hierarchy bounds.  Nothing
about try ``ftotal`` depends on try ``ftotal - 1`` except which one is
kept, so K tries are drawn at once, as a (batch, K, fanout) straw2 grid
per level, and the retry semantics become "the first try that does not
fail wins" (a masked argmax).  The chooseleaf recursion (mapper.c:
548-572) unrolls the same way over its small try budget.  The indep
form (crush_choose_indep, mapper.c:633-821) draws every open slot at
once and commits them in slot order.

Where ``ceph_tpu`` vmaps one x's program with a ``lax.while_loop`` over
rounds, here the batch axis is written out and the round loop is a
Python loop over the lanes still open: each round ends by asking the
card which lanes go on (one host sync a round).  With K tries a round,
almost every lane finishes in its first, so a firstn call takes about
numrep rounds and as many syncs; ``SpeculativeMapper.rounds`` and
``.syncs`` count those of the last call.  It is carried as PyTorch ops
on the card (the port's K2 remains ``PoolMapper``'s walk); u32 hashes
and the 64-bit straw2 draws use the int64 emulation of ``hash.py`` and
``ln.py``.

Bit-exactness: the same (result, len) as ``mapper_ref`` and K2 for every
eligible (map, rule, tunables); ``analyze`` decides eligibility with
``ceph_tpu``'s rules and raises ``Ineligible`` for the rest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..common import device_metrics
from ..device import resolve_device
from . import constants as C
from .hash import crush_hash32_2, crush_hash32_3
from .ln import ln16_table, straw2_draw
from .map import ChooseArgMap, CrushMap
from .map_arrays import as_i32, encode_map, to_device

NONE = C.CRUSH_ITEM_NONE
UNDEF = C.CRUSH_ITEM_UNDEF
M32 = 0xFFFFFFFF

# per-try status codes
_DESC = 0     # still descending
_OK = 1       # reached an item of the wanted type (device for inner)
_FAIL = 2     # reject/collide/empty: costs one ftotal, retry from root
_SKIP = 3     # terminal: give up this rep (over / unresolvable child)


class Ineligible(ValueError):
    """The (map, rule, tunables) combination needs the general mapper."""


@dataclass(frozen=True)
class Plan:
    """Static facts of an eligible rule."""

    root_idx: int        # bucket index of the take root
    numrep: int
    type_: int           # target type of the choose step
    leafy: bool          # chooseleaf (recurse to device) vs choose type 0
    firstn: bool         # firstn (compacting) vs indep (positional)
    tries: int           # outer retry budget (choose_total_tries + 1 rule)
    recurse_tries: int   # inner retry budget (1 under descend_once)
    vary_r: int
    stable: int
    depth_outer: int     # max descent levels root -> anywhere
    depth_inner: int     # max descent levels below a type_ bucket


def _max_depth(cmap: CrushMap, idx: int, _seen=()) -> int:
    """Longest chain of bucket hops from bucket index ``idx``: a descent
    makes one choose a hop, so this bounds any descent that ends."""
    b = cmap.buckets.get(idx)
    if b is None:
        return 0
    if idx in _seen:
        raise Ineligible("bucket graph has a cycle")
    best = 1
    for it in b.items:
        if it < 0 and (-1 - it) in cmap.buckets:
            best = max(best, 1 + _max_depth(cmap, -1 - it, _seen + (idx,)))
    return best


def analyze(cmap: CrushMap, ruleno: int, result_max: int) -> Plan:
    """Decide eligibility and extract the plan.

    Eligible iff every bucket is straw2; the rule is one ``take`` /
    ``choose(leaf) firstn|indep`` / ``emit`` block (SET_* tunable steps
    allowed); a firstn rule's effective local retry knobs are 0; the
    inner budget unrolls (<= 4); numrep fits result_max (and 16); and a
    chooseleaf indep does not target type 0."""
    for b in cmap.buckets.values():
        if b.alg != C.CRUSH_BUCKET_STRAW2:
            raise Ineligible(f"bucket alg {b.alg} != straw2")
    t = cmap.tunables
    rule = cmap.rules[ruleno]
    choose_tries = t.choose_total_tries + 1  # mapper.c:906
    choose_leaf_tries = 0
    local_retries = t.choose_local_tries
    local_fb = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable
    root = None
    choose = None
    emitted = False
    for step in rule.steps:
        op, arg1, arg2 = step.op, step.arg1, step.arg2
        if emitted:
            raise Ineligible("steps after emit")
        if op == C.CRUSH_RULE_SET_CHOOSE_TRIES:
            if arg1 > 0:
                choose_tries = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                choose_leaf_tries = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if arg1 >= 0:
                local_retries = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if arg1 >= 0:
                local_fb = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if arg1 >= 0:
                vary_r = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if arg1 >= 0:
                stable = arg1
        elif op == C.CRUSH_RULE_TAKE:
            if root is not None or choose is not None:
                raise Ineligible("multiple takes")
            if arg1 >= 0 or cmap.bucket_by_id(arg1) is None:
                raise Ineligible("take target is not an existing bucket")
            root = -1 - arg1
        elif op in (C.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                    C.CRUSH_RULE_CHOOSE_FIRSTN,
                    C.CRUSH_RULE_CHOOSELEAF_INDEP,
                    C.CRUSH_RULE_CHOOSE_INDEP):
            if root is None or choose is not None:
                raise Ineligible("choose without take / multiple chooses")
            leafy = op in (C.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                           C.CRUSH_RULE_CHOOSELEAF_INDEP)
            firstn = op in (C.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                            C.CRUSH_RULE_CHOOSE_FIRSTN)
            numrep = arg1
            if numrep <= 0:
                numrep += result_max
            if not (0 < numrep <= result_max):
                raise Ineligible("numrep outside [1, result_max]")
            if numrep > 16:
                raise Ineligible("numrep unroll bound exceeded")
            if not leafy and arg2 != 0:
                raise Ineligible("choose of a non-device type")
            if not firstn and leafy and arg2 == 0:
                # the reference writes the candidate device into out2
                # before its is_out check (mapper.c:772-776), so an
                # all-rejected slot leaks its last rejected device: the
                # general walk reproduces that, this path does not
                raise Ineligible("chooseleaf indep of type 0 "
                                 "(out2 pre-is_out leak quirk)")
            choose = (numrep, arg2, leafy, firstn)
        elif op == C.CRUSH_RULE_EMIT:
            if choose is None:
                raise Ineligible("emit without choose")
            emitted = True
        else:
            raise Ineligible(f"unsupported step op {op}")
    if not emitted:
        raise Ineligible("rule never emits")
    numrep, type_, leafy, firstn = choose
    if firstn and (local_retries != 0 or local_fb != 0):
        # indep has no local-retry paths (mapper.c:633-821), so the
        # legacy local tunables only disqualify firstn rules
        raise Ineligible("legacy local retry tunables in force")
    if leafy:
        if choose_leaf_tries:
            recurse_tries = choose_leaf_tries
        elif firstn and t.chooseleaf_descend_once:
            recurse_tries = 1
        elif firstn:
            recurse_tries = choose_tries
        else:
            recurse_tries = 1  # the indep default
    else:
        recurse_tries = 1
    if recurse_tries > 4:
        raise Ineligible(f"recurse_tries {recurse_tries} unroll bound")
    depth_outer = _max_depth(cmap, root)
    depth_inner = 1
    if leafy and type_ > 0:
        depths = [_max_depth(cmap, i) for i, b in cmap.buckets.items()
                  if b.type == type_]
        depth_inner = max(depths) if depths else 1
    return Plan(root_idx=root, numrep=numrep, type_=type_, leafy=leafy,
                firstn=firstn, tries=choose_tries,
                recurse_tries=recurse_tries, vary_r=vary_r, stable=stable,
                depth_outer=depth_outer, depth_inner=depth_inner)


class _Tables:
    """The map arrays one call reads, widened to int64 (u32 values as
    their value) on the arrays' device."""

    def __init__(self, arrays, bhash: torch.Tensor):
        def u32(t):
            return t.to(torch.int64) & M32

        self.alg = arrays.alg.to(torch.int64)
        self.btype = arrays.btype.to(torch.int64)
        self.size = arrays.size.to(torch.int64)
        self.items = arrays.items.to(torch.int64)
        self.w = u32(arrays.weights)
        self.arg_ids = arrays.arg_ids.to(torch.int64)
        self.arg_w = u32(arrays.arg_weights)
        self.B, self.S = self.items.shape
        self.P = self.arg_w.shape[1]
        dev = self.items.device
        self.bhash = bhash.to(dev)
        self.slot = torch.arange(self.S, device=dev)
        self.ln16 = ln16_table(dev)


class _Spec:
    """One eligible rule's speculative program over a batch of xs:
    ``spec(arrays, weight, xs) -> (i32[N, R], i32[N])``.  ``rounds`` and
    ``syncs`` count the round loop's passes and host syncs of the last
    call."""

    def __init__(self, plan: Plan, static, bhash: torch.Tensor,
                 result_max: int, k_tries: int):
        self.plan = plan
        self.static = static
        self.bhash = bhash
        self.R = result_max
        self.K = max(1, min(k_tries, plan.tries))
        self.rounds = 0
        self.syncs = 0

    # -- the pieces (every lane tensor is [n, K] or [n, numrep]) -------
    def straw2(self, T: _Tables, x, cur, r, pos):
        """bucket_straw2_choose (mapper.c:287-362) for each lane's bucket
        ``cur``, rank ``r`` and choose_args position ``pos``."""
        if self.static.has_choose_args:
            wts = T.arg_w[cur, pos.clamp(max=T.P - 1)]
            ids = T.arg_ids[cur]
        else:
            wts = T.w[cur]
            ids = T.items[cur]
        h = crush_hash32_3(x.view(-1, 1, 1), ids, r.unsqueeze(-1))
        h = torch.where(T.bhash[cur].unsqueeze(-1) == C.CRUSH_HASH_RJENKINS1,
                        h, torch.zeros_like(h))
        draws = straw2_draw(h & 0xFFFF, wts, T.ln16)
        in_bucket = T.slot < T.size[cur].unsqueeze(-1)
        draws = torch.where(in_bucket, draws,
                            torch.full_like(draws, C.S64_MIN))
        j = draws.argmax(-1, keepdim=True)
        return T.items[cur].gather(-1, j).squeeze(-1)

    @staticmethod
    def classify(T: _Tables, item):
        """(itemtype, child bucket index, child is a bucket)."""
        is_neg = item < 0
        cidx = (-1 - item).clamp(0, T.B - 1)
        exists = is_neg & ((-1 - item) < T.B) & (T.alg[cidx] != 0)
        itemtype = torch.where(
            is_neg, torch.where(exists, T.btype[cidx],
                                torch.full_like(item, -1)),
            torch.zeros_like(item))
        return itemtype, cidx, exists

    @staticmethod
    def is_out(weight, item, x):
        """mapper.c:402-416 for each lane's device."""
        wmax = weight.numel()
        w = weight[item.clamp(0, wmax - 1)]
        h = crush_hash32_2(x.view(-1, 1), item) & 0xFFFF
        return (item >= wmax) | ((w < 0x10000) & ((w == 0) | (h >= w)))

    @staticmethod
    def seg_any_eq(vec, n, item):
        """any(vec[lane, i] == item[lane, j] for i < n[lane])."""
        idx = torch.arange(vec.shape[1], device=vec.device)
        seg = (idx.view(1, 1, -1) < n.view(-1, 1, 1))
        return (seg & (vec.unsqueeze(1) == item.unsqueeze(-1))).any(-1)

    def descend(self, T, x, start, r, pos, want_type, levels):
        """Lane-parallel pure descents from bucket indices ``start``,
        choosing with rank ``r`` a level, until an item of
        ``want_type`` appears (mapper.c:497-546 without the retry paths
        ``analyze`` ruled out).  Returns (status, item, item's bucket
        index)."""
        cur = start
        status = torch.zeros_like(start)
        fitem = torch.zeros_like(start)
        fcidx = torch.zeros_like(start)
        maxdev = self.static.max_devices
        for _ in range(levels):
            item = self.straw2(T, x, cur, r, pos)
            empty = T.size[cur] == 0
            over = item >= maxdev
            itemtype, cidx, exists = self.classify(T, item)
            new = torch.where(
                empty, _FAIL, torch.where(
                    over, _SKIP, torch.where(
                        itemtype == want_type, _OK,
                        torch.where(exists, _DESC, _SKIP))))
            act = status == _DESC
            ok = act & (new == _OK)
            fitem = torch.where(ok, item, fitem)
            fcidx = torch.where(ok, cidx, fcidx)
            cur = torch.where(act & (new == _DESC), cidx, cur)
            status = torch.where(act, new, status)
        # ``levels`` bounds every descent that ends: one still going
        # would not end under the C semantics either
        return torch.where(status == _DESC, _FAIL, status), fitem, fcidx

    def leaf_try(self, T, weight, x, host_idx, r_in, pos, out2, outpos):
        """One inner try (the chooseleaf recursion, numrep 1): a descent
        host -> device, then the device's collision and out checks."""
        st, dev, _ = self.descend(T, x, host_idx, r_in, pos, 0,
                                  self.plan.depth_inner)
        bad = (st == _OK) & (self.seg_any_eq(out2, outpos, dev)
                             | self.is_out(weight, dev, x))
        return torch.where(bad, _FAIL, st), dev

    def leaf(self, T, weight, x, found, host_idx, r_of, pos, out2, outpos):
        """The inner recursion unrolled over its try budget: (got, dev)
        for each lane, ``r_of(j)`` the rank of inner try j."""
        dev = torch.zeros_like(host_idx)
        got = torch.zeros_like(found)
        dead = torch.zeros_like(found)
        for j in range(self.plan.recurse_tries):
            ist, d = self.leaf_try(T, weight, x, host_idx, r_of(j), pos,
                                   out2, outpos)
            take = found & ~got & ~dead & (ist == _OK)
            dev = torch.where(take, d, dev)
            got = got | take
            dead = dead | (~got & (ist == _SKIP))
        return got, dev

    # -- the rule -----------------------------------------------------
    def firstn(self, T, weight, X):
        """crush_choose_firstn: per rep, rounds of K tries over the lanes
        whose rep is still open."""
        p = self.plan
        N, R, K, dev_ = X.shape[0], self.R, self.K, X.device
        out = torch.full((N, R), NONE, dtype=torch.int64, device=dev_)
        out2 = torch.full_like(out, NONE)
        outpos = torch.zeros(N, dtype=torch.int64, device=dev_)
        ks = torch.arange(K, device=dev_)
        every = torch.arange(N, device=dev_)
        for rep in range(p.numrep):
            ftotal = torch.zeros(N, dtype=torch.int64, device=dev_)
            succ = torch.zeros(N, dtype=torch.bool, device=dev_)
            hostv = torch.zeros(N, dtype=torch.int64, device=dev_)
            devv = torch.zeros_like(hostv)
            lanes = every
            while lanes.numel():
                self.rounds += 1
                x, ft, op = X[lanes], ftotal[lanes], outpos[lanes]
                o, o2 = out[lanes], out2[lanes]
                n = lanes.numel()
                r = rep + ft.unsqueeze(1) + ks
                pos = op.unsqueeze(1).expand(n, K)
                root = torch.full((n, K), p.root_idx, dtype=torch.int64,
                                  device=dev_)
                ost, host, hidx = self.descend(T, x, root, r, pos, p.type_,
                                               p.depth_outer)
                found = ost == _OK
                collide = found & self.seg_any_eq(o, op, host)
                if p.leafy and p.type_ > 0:
                    sub_r = (r >> (p.vary_r - 1)) if p.vary_r \
                        else torch.zeros_like(r)
                    rep_in = 0 if p.stable else op.unsqueeze(1)
                    got, dev = self.leaf(T, weight, x, found, hidx,
                                         lambda j: rep_in + sub_r + j, pos,
                                         o2, op)
                    live = found & ~collide & got
                else:
                    dev = host
                    live = found & ~collide & ~self.is_out(weight, host, x)
                eff = torch.where(found & ~live, _FAIL, ost)
                # tries past the rep's remaining budget read as give-up
                eff = torch.where(ft.unsqueeze(1) + ks < p.tries, eff, _SKIP)
                nofail = eff != _FAIL
                pick = nofail.to(torch.int32).argmax(1, keepdim=True)
                any_pick = nofail.any(1)
                win = any_pick & (eff.gather(1, pick).squeeze(1) == _OK)
                ftotal[lanes] = ft + K
                succ[lanes] = succ[lanes] | win
                hostv[lanes] = torch.where(
                    win, host.gather(1, pick).squeeze(1), hostv[lanes])
                devv[lanes] = torch.where(
                    win, dev.gather(1, pick).squeeze(1), devv[lanes])
                # the round's one host sync: which lanes go on
                lanes = lanes[~any_pick & (ft + K < p.tries)]  # sync-ok: the round's one sync (a mask's length)
                self.syncs += 1
            slot = outpos.clamp(0, R - 1).unsqueeze(1)
            out.scatter_(1, slot, torch.where(
                succ, hostv, out.gather(1, slot).squeeze(1)).unsqueeze(1))
            out2.scatter_(1, slot, torch.where(
                succ, devv, out2.gather(1, slot).squeeze(1)).unsqueeze(1))
            outpos = outpos + succ.to(torch.int64)
        result = out2 if p.leafy else out
        idx = torch.arange(R, device=dev_)
        result = torch.where(idx < outpos.unsqueeze(1), result,
                             torch.full_like(result, NONE))
        return result, outpos

    def indep(self, T, weight, X):
        """crush_choose_indep as dense rounds: every open slot's descent
        at once, then a commit in slot order that reproduces the
        reference's in-round collision order (slot j sees the slots
        before it placed this round).  Positional: a failed slot stays
        NONE."""
        p = self.plan
        N, R, NR, dev_ = X.shape[0], self.R, p.numrep, X.device
        js = torch.arange(NR, device=dev_)
        idx = torch.arange(R, device=dev_)
        out = torch.full((N, R), UNDEF, dtype=torch.int64, device=dev_)
        out2 = torch.full_like(out, UNDEF)
        left = torch.full((N,), NR, dtype=torch.int64, device=dev_)
        lanes = torch.arange(N, device=dev_)
        zero = torch.zeros(1, dtype=torch.int64, device=dev_)
        # the lanes still open all entered at round 0, so they share
        # ftotal: the round number
        for ftotal in range(p.tries):
            if not lanes.numel():
                break
            self.rounds += 1
            x, o, o2, lf = X[lanes], out[lanes], out2[lanes], left[lanes]
            n = lanes.numel()
            # straw2 only: the rank multiplier is numrep (mapper.c:653)
            r = (js + NR * ftotal).expand(n, NR)
            root = torch.full((n, NR), p.root_idx, dtype=torch.int64,
                              device=dev_)
            pos0 = torch.zeros_like(root)   # the outer position: outpos 0
            ost, host, hidx = self.descend(T, x, root, r, pos0, p.type_,
                                           p.depth_outer)
            found = ost == _OK
            if p.leafy and p.type_ > 0:
                # the inner indep: its position is the slot, and its
                # collision segment is its own empty slot
                got, dev = self.leaf(T, weight, x, found, hidx,
                                     lambda t: js + r + NR * t,
                                     js.expand(n, NR), o2, zero.expand(n))
                cand = found & got
            else:
                dev = host
                cand = found & ~self.is_out(weight, host, x)
            for j in range(NR):
                slot_open = o[:, j] == UNDEF
                collide = ((idx < NR) & (o == host[:, j:j + 1])).any(1)
                place = cand[:, j] & slot_open & ~collide
                upd = place | ((ost[:, j] == _SKIP) & slot_open)
                o[:, j] = torch.where(upd, torch.where(
                    place, host[:, j], NONE), o[:, j])
                o2[:, j] = torch.where(upd, torch.where(
                    place, dev[:, j], NONE), o2[:, j])
                lf = lf - upd.to(torch.int64)
            out[lanes], out2[lanes], left[lanes] = o, o2, lf
            # the round's one host sync: which lanes go on
            lanes = lanes[lf > 0]  # sync-ok: the round's one sync (a mask's length)
            self.syncs += 1
        result = out2 if p.leafy else out
        result = torch.where(
            idx < NR, torch.where(result == UNDEF, NONE, result),
            torch.full_like(result, NONE))
        return result, torch.full((N,), NR, dtype=torch.int64, device=dev_)

    def __call__(self, arrays, weight, xs):
        self.rounds = self.syncs = 0
        T = _Tables(arrays, self.bhash)
        X = xs.to(torch.int64) & M32
        weight = weight.to(torch.int64) & M32
        if not X.numel():
            return (torch.full((0, self.R), NONE, dtype=torch.int32,
                               device=X.device),
                    torch.zeros(0, dtype=torch.int32, device=X.device))
        res, lens = (self.firstn if self.plan.firstn else self.indep)(
            T, weight, X)
        return res.to(torch.int32), lens.to(torch.int32)


def _bucket_hashes(cmap: CrushMap) -> torch.Tensor:
    h = torch.zeros(max(1, cmap.max_buckets), dtype=torch.int64)
    for i, b in cmap.buckets.items():
        h[i] = b.hash
    return h


def make_single_spec(cmap: CrushMap, ruleno: int, result_max: int,
                     choose_args: Optional[ChooseArgMap] = None,
                     encoded=None, k_tries: int = 8):
    """The speculative program of one rule: ``(spec, static,
    arrays_np)``, ``spec(arrays, weight, xs) -> (i32[N, result_max],
    i32[N])`` over a batch of xs on the arrays' device (``ceph_tpu``'s
    single-x program with its vmap written out as the batch axis).
    Raises ``Ineligible`` when the rule needs the general mapper."""
    plan = analyze(cmap, ruleno, result_max)
    static, arrays_np = encoded if encoded is not None \
        else encode_map(cmap, choose_args)
    return (_Spec(plan, static, _bucket_hashes(cmap), result_max, k_tries),
            static, arrays_np)


def build_spec_rule_fn(cmap: CrushMap, ruleno: int, result_max: int,
                       choose_args: Optional[ChooseArgMap] = None,
                       encoded=None, k_tries: int = 8, device="cuda"):
    """One eligible rule as a batched speculative mapper with
    ``mapper.build_rule_fn``'s signature: ``(fn, static, arrays)``,
    ``fn(arrays, weight, xs)``, the arrays on ``device``."""
    dev = resolve_device(device)
    spec, static, arrays_np = make_single_spec(
        cmap, ruleno, result_max, choose_args, encoded, k_tries)
    return spec, static, to_device(arrays_np, dev)


class SpeculativeMapper:
    """Alternative to ``mapper.BatchedMapper`` for eligible rules, on
    ``device`` (the card by default).

    >>> m = SpeculativeMapper(cmap)
    >>> res, lens = m.map_batch(ruleno, xs, result_max, weight)

    ``rule_fn`` raises ``Ineligible`` for a rule that needs the general
    mapper; ``rounds`` and ``syncs`` count the last ``map_batch``'s
    round-loop passes and host syncs."""

    def __init__(self, cmap: CrushMap,
                 choose_args: Optional[ChooseArgMap] = None,
                 k_tries: int = 8, device="cuda"):
        self.device = resolve_device(device)
        self.cmap = cmap
        self.choose_args = choose_args
        self.k_tries = k_tries
        self._encoded = encode_map(cmap, choose_args)
        self.arrays = to_device(self._encoded[1], self.device)
        device_metrics.note_rebuild("lowered_maps")
        self._cache: Dict[tuple, _Spec] = {}
        self.rounds = 0
        self.syncs = 0

    def rule_fn(self, ruleno: int, result_max: int) -> _Spec:
        key = (ruleno, result_max)
        if key not in self._cache:
            self._cache[key], _, _ = make_single_spec(
                self.cmap, ruleno, result_max, self.choose_args,
                encoded=self._encoded, k_tries=self.k_tries)
        return self._cache[key]

    def map_batch(self, ruleno: int, xs, result_max: int, weight):
        """xs u32[N], weight 16.16 u32[max_devices] (numpy or tensors) ->
        (i32[N, result_max], i32[N]) on the mapper's device."""
        fn = self.rule_fn(ruleno, result_max)
        out = fn(self.arrays, as_i32(weight, self.device),
                 as_i32(xs, self.device))
        self.rounds, self.syncs = fn.rounds, fn.syncs
        return out
