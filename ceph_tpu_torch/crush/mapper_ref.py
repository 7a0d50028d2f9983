"""The scalar CRUSH mapper: the port's copy of the executable
specification ``ceph_tpu/crush/mapper_ref.py``.

A readable Python implementation of the mapping semantics of the
reference C core (src/crush/mapper.c): the rule-step VM
(mapper.c:878-1083), the firstn retry descent with local retries and
the perm fallback (mapper.c:438-626), the breadth-first indep variant
(mapper.c:633-821), all five bucket choose algorithms (mapper.c:51-396)
including the stateful uniform-bucket permutation (mapper.c:51-109),
tunables, chooseleaf recursion, vary_r / stable and per-position
choose_args.

It maps one x at a time on Python ints: the oracle that ``chip_smoke.py``
holds kernel K2 to on the card, and the CRUSH stage of
``osdmap.OSDMap.pg_to_up_acting_osds``.  Bit-exact against
tests/golden/*.json.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import constants as C
from .hash import hash32_2_int, hash32_3_int, hash32_4_int
from ._ln_tables import LL_TBL, RH_LH_TBL
from .map import Bucket, ChooseArg, ChooseArgMap, CrushMap


# ---------------------------------------------------------------------------
# crush_ln / straw2 draw on python ints (exact port of mapper.c:226-268,339)
# ---------------------------------------------------------------------------

def crush_ln_int(xin: int) -> int:
    x = (xin + 1) & 0xFFFFFFFF
    iexpon = 15
    if not (x & 0x18000):
        # clz32(v) = 32 - bit_length(v); bits = clz32(v) - 16
        bits = 16 - (x & 0x1FFFF).bit_length()
        x = (x << bits) & 0xFFFFFFFF
        iexpon = 15 - bits
    index1 = (x >> 8) << 1
    rh = RH_LH_TBL[index1 - 256]
    lh = RH_LH_TBL[index1 + 1 - 256]
    xl64 = (x * rh) & 0xFFFFFFFFFFFFFFFF
    xl64 >>= 48
    index2 = xl64 & 0xFF
    lh = (lh + LL_TBL[index2]) >> (48 - 12 - 32)
    return (iexpon << (12 + 32)) + lh


def _h3(hash_type: int, a: int, b: int, c: int) -> int:
    return hash32_3_int(a, b, c) if hash_type == C.CRUSH_HASH_RJENKINS1 else 0


def _h4(hash_type: int, a: int, b: int, c: int, d: int) -> int:
    return hash32_4_int(a, b, c, d) if hash_type == C.CRUSH_HASH_RJENKINS1 \
        else 0


def _straw2_draw(hash_type: int, x: int, item_id: int, r: int,
                 weight: int) -> int:
    """generate_exponential_distribution (mapper.c:312-337)."""
    if weight == 0:
        return C.S64_MIN
    u = _h3(hash_type, x, item_id, r) & 0xFFFF
    ln = crush_ln_int(u) - 0x1000000000000
    # div64_s64 truncates toward zero; ln <= 0, weight > 0
    return -((-ln) // weight)


# ---------------------------------------------------------------------------
# workspace (struct crush_work, mapper.c:824-865): only uniform buckets
# carry state — the incrementally-built Fisher-Yates permutation
# ---------------------------------------------------------------------------

class _PermState:
    __slots__ = ("perm_x", "perm_n", "perm")

    def __init__(self, size: int):
        self.perm_x = 0
        self.perm_n = 0
        self.perm = list(range(size))


class Workspace:
    def __init__(self):
        self._perm: Dict[int, _PermState] = {}

    def perm_for(self, bucket: Bucket) -> _PermState:
        st = self._perm.get(bucket.id)
        if st is None:
            st = _PermState(bucket.size)
            self._perm[bucket.id] = st
        return st


# ---------------------------------------------------------------------------
# bucket choose methods (mapper.c:51-396)
# ---------------------------------------------------------------------------

def bucket_perm_choose(bucket: Bucket, work: _PermState, x: int,
                       r: int) -> int:
    """Fisher-Yates-on-demand permutation choose (mapper.c:51-109)."""
    pr = r % bucket.size
    if work.perm_x != (x & 0xFFFFFFFF) or work.perm_n == 0:
        work.perm_x = x & 0xFFFFFFFF
        if pr == 0:
            s = _h3(bucket.hash, x, bucket.id, 0) % bucket.size
            work.perm[0] = s
            work.perm_n = 0xFFFF  # magic: see mapper.c:68
            return bucket.items[s]
        for i in range(bucket.size):
            work.perm[i] = i
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        # clean up after the r=0 shortcut
        for i in range(1, bucket.size):
            work.perm[i] = i
        work.perm[work.perm[0]] = 0
        work.perm_n = 1
    while work.perm_n <= pr:
        p = work.perm_n
        if p < bucket.size - 1:
            i = _h3(bucket.hash, x, bucket.id, p) % (bucket.size - p)
            if i:
                work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
        work.perm_n += 1
    return bucket.items[work.perm[pr]]


def bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    """Tail-to-head probabilistic descent (mapper.c:119-142)."""
    for i in range(bucket.size - 1, -1, -1):
        w = _h4(bucket.hash, x, bucket.items[i], r, bucket.id) & 0xFFFF
        w = (w * bucket.sum_weights[i]) >> 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    """Weighted binary-tree descent (mapper.c:145-200)."""
    n = bucket.num_nodes >> 1
    while not (n & 1):
        w = bucket.node_weights[n]
        t = (_h4(bucket.hash, x, n, r, bucket.id) * w) >> 32
        h = 0
        nn = n
        while (nn & 1) == 0:
            h += 1
            nn >>= 1
        left = n - (1 << (h - 1))
        n = left if t < bucket.node_weights[left] else n + (1 << (h - 1))
    return bucket.items[n >> 1]


def bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    """Legacy straw: 16-bit draw scaled by precomputed straws
    (mapper.c:205-223)."""
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        draw = (_h3(bucket.hash, x, bucket.items[i], r) & 0xFFFF) \
            * bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def bucket_straw2_choose(bucket: Bucket, x: int, r: int,
                         arg: Optional[ChooseArg], position: int) -> int:
    """Exponential-minimum sampling (mapper.c:339-362) with choose_args
    weight/ids substitution (mapper.c:287-304)."""
    weights = bucket.item_weights
    ids = bucket.items
    if arg is not None:
        if arg.weight_set is not None:
            pos = min(position, len(arg.weight_set) - 1)
            weights = arg.weight_set[pos]
        if arg.ids is not None:
            ids = arg.ids
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        draw = _straw2_draw(bucket.hash, x, ids[i], r, weights[i])
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def crush_bucket_choose(bucket: Bucket, work: Workspace, x: int, r: int,
                        arg: Optional[ChooseArg], position: int) -> int:
    alg = bucket.alg
    if alg == C.CRUSH_BUCKET_UNIFORM:
        return bucket_perm_choose(bucket, work.perm_for(bucket), x, r)
    if alg == C.CRUSH_BUCKET_LIST:
        return bucket_list_choose(bucket, x, r)
    if alg == C.CRUSH_BUCKET_TREE:
        return bucket_tree_choose(bucket, x, r)
    if alg == C.CRUSH_BUCKET_STRAW:
        return bucket_straw_choose(bucket, x, r)
    if alg == C.CRUSH_BUCKET_STRAW2:
        return bucket_straw2_choose(bucket, x, r, arg, position)
    return bucket.items[0]


def is_out(weight: List[int], item: int, x: int) -> bool:
    """Weight-based rejection of a device (mapper.c:402-416)."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (hash32_2_int(x, item) & 0xFFFF) >= w


# ---------------------------------------------------------------------------
# choose_firstn (mapper.c:438-626)
# ---------------------------------------------------------------------------

def _carg(choose_args, bucket: Bucket) -> Optional[ChooseArg]:
    if choose_args is None:
        return None
    return choose_args.get(-1 - bucket.id)


def crush_choose_firstn(cmap: CrushMap, work: Workspace, bucket: Bucket,
                        weight: List[int], x: int, numrep: int, type_: int,
                        out: List[int], base: int, outpos: int, out_size: int,
                        tries: int, recurse_tries: int, local_retries: int,
                        local_fallback_retries: int, recurse_to_leaf: bool,
                        vary_r: int, stable: int, out2: Optional[List[int]],
                        out2_base: int, parent_r: int,
                        choose_args: Optional[ChooseArgMap]) -> int:
    """Depth-first retry descent choosing ``numrep`` distinct items
    (mapper.c:438-626).  ``out``/``out2`` are the full scratch vectors;
    ``base`` is the segment origin (the C code's ``o+osize`` pointer), and
    ``outpos`` is the position *within* the segment, so collision checks are
    segment-local exactly like the pointer arithmetic in the reference."""
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        item = 0
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_bucket = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                reject = False
                r = rep + parent_r + ftotal
                if in_bucket.size == 0:
                    reject = True
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_bucket.size >> 1)
                            and flocal > local_fallback_retries):
                        item = bucket_perm_choose(
                            in_bucket, work.perm_for(in_bucket), x, r)
                    else:
                        item = crush_bucket_choose(
                            in_bucket, work, x, r,
                            _carg(choose_args, in_bucket), outpos)
                    if item >= cmap.max_devices:
                        skip_rep = True
                        break

                    if item < 0:
                        sub = cmap.bucket_by_id(item)
                        itemtype = sub.type if sub is not None else None
                    else:
                        itemtype = 0

                    if itemtype != type_:
                        if item >= 0 or (-1 - item) >= cmap.max_buckets \
                                or cmap.bucket_by_id(item) is None:
                            skip_rep = True
                            break
                        in_bucket = cmap.bucket_by_id(item)
                        retry_bucket = True
                        continue

                    for i in range(outpos):
                        if out[base + i] == item:
                            collide = True
                            break

                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            got = crush_choose_firstn(
                                cmap, work, cmap.bucket_by_id(item), weight,
                                x, 1 if stable else outpos + 1, 0,
                                out2, out2_base, outpos, count,
                                recurse_tries, 0,
                                local_retries, local_fallback_retries,
                                False, vary_r, stable, None, 0, sub_r,
                                choose_args)
                            if got <= outpos:
                                reject = True  # didn't get a leaf
                        else:
                            out2[out2_base + outpos] = item  # already a leaf

                    if not reject and not collide and itemtype == 0:
                        reject = is_out(weight, item, x)

                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_bucket.size
                          + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                        break
                    else:
                        skip_rep = True

        if not skip_rep:
            out[base + outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


# ---------------------------------------------------------------------------
# choose_indep (mapper.c:633-821)
# ---------------------------------------------------------------------------

def crush_choose_indep(cmap: CrushMap, work: Workspace, bucket: Bucket,
                       weight: List[int], x: int, left: int, numrep: int,
                       type_: int, out: List[int], base: int, outpos: int,
                       tries: int, recurse_tries: int, recurse_to_leaf: bool,
                       out2: Optional[List[int]], out2_base: int,
                       parent_r: int,
                       choose_args: Optional[ChooseArgMap]) -> None:
    """Breadth-first, positionally-stable variant (mapper.c:633-821).
    Same segment convention as crush_choose_firstn."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[base + rep] = C.CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[out2_base + rep] = C.CRUSH_ITEM_UNDEF

    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[base + rep] != C.CRUSH_ITEM_UNDEF:
                continue
            in_bucket = bucket
            while True:
                r = rep + parent_r
                if in_bucket.alg == C.CRUSH_BUCKET_UNIFORM \
                        and in_bucket.size % numrep == 0:
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal

                if in_bucket.size == 0:
                    break

                item = crush_bucket_choose(
                    in_bucket, work, x, r,
                    _carg(choose_args, in_bucket), outpos)
                if item >= cmap.max_devices:
                    out[base + rep] = C.CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[out2_base + rep] = C.CRUSH_ITEM_NONE
                    left -= 1
                    break

                if item < 0:
                    sub = cmap.bucket_by_id(item)
                    itemtype = sub.type if sub is not None else None
                else:
                    itemtype = 0

                if itemtype != type_:
                    if item >= 0 or (-1 - item) >= cmap.max_buckets \
                            or cmap.bucket_by_id(item) is None:
                        out[base + rep] = C.CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[out2_base + rep] = C.CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_bucket = cmap.bucket_by_id(item)
                    continue

                collide = False
                for i in range(outpos, endpos):
                    if out[base + i] == item:
                        collide = True
                        break
                if collide:
                    break

                if recurse_to_leaf:
                    if item < 0:
                        crush_choose_indep(
                            cmap, work, cmap.bucket_by_id(item), weight,
                            x, 1, numrep, 0, out2, out2_base, rep,
                            recurse_tries, 0, False, None, 0, r,
                            choose_args)
                        if out2 is not None \
                                and out2[out2_base + rep] == C.CRUSH_ITEM_NONE:
                            break  # placed nothing; no leaf
                    elif out2 is not None:
                        out2[out2_base + rep] = item

                if itemtype == 0 and is_out(weight, item, x):
                    break

                out[base + rep] = item
                left -= 1
                break
        ftotal += 1

    for rep in range(outpos, endpos):
        if out[base + rep] == C.CRUSH_ITEM_UNDEF:
            out[base + rep] = C.CRUSH_ITEM_NONE
        if out2 is not None and out2[out2_base + rep] == C.CRUSH_ITEM_UNDEF:
            out2[out2_base + rep] = C.CRUSH_ITEM_NONE


# ---------------------------------------------------------------------------
# the rule VM (crush_do_rule, mapper.c:878-1083)
# ---------------------------------------------------------------------------

def crush_do_rule(cmap: CrushMap, ruleno: int, x: int, result_max: int,
                  weight: List[int],
                  choose_args: Optional[ChooseArgMap] = None) -> List[int]:
    """Run rule ``ruleno`` for input ``x``; returns the result list
    (length <= result_max)."""
    if ruleno not in cmap.rules:
        return []
    rule = cmap.rules[ruleno]
    t = cmap.tunables

    # the three scratch vectors carved out after the workspace in C
    w: List[int] = [0] * result_max
    o: List[int] = [0] * result_max
    cvec: List[int] = [0] * result_max
    result: List[int] = []
    wsize = 0

    choose_tries = t.choose_total_tries + 1  # off-by-one heritage
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    work = Workspace()

    for step in rule.steps:
        op, arg1, arg2 = step.op, step.arg1, step.arg2
        if op == C.CRUSH_RULE_TAKE:
            if (0 <= arg1 < cmap.max_devices) or \
                    (0 <= -1 - arg1 < cmap.max_buckets
                     and cmap.bucket_by_id(arg1) is not None):
                w[0] = arg1
                wsize = 1
        elif op == C.CRUSH_RULE_SET_CHOOSE_TRIES:
            if arg1 > 0:
                choose_tries = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                choose_leaf_tries = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if arg1 >= 0:
                choose_local_retries = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if arg1 >= 0:
                choose_local_fallback_retries = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if arg1 >= 0:
                vary_r = arg1
        elif op == C.CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if arg1 >= 0:
                stable = arg1
        elif op in (C.CRUSH_RULE_CHOOSELEAF_FIRSTN, C.CRUSH_RULE_CHOOSE_FIRSTN,
                    C.CRUSH_RULE_CHOOSELEAF_INDEP, C.CRUSH_RULE_CHOOSE_INDEP):
            if wsize == 0:
                continue
            firstn = op in (C.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                            C.CRUSH_RULE_CHOOSE_FIRSTN)
            recurse_to_leaf = op in (C.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                     C.CRUSH_RULE_CHOOSELEAF_INDEP)
            osize = 0
            for i in range(wsize):
                numrep = arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                bucket = cmap.bucket_by_id(w[i]) if w[i] < 0 else None
                if bucket is None:
                    continue  # w[i] is a device or CRUSH_ITEM_NONE
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    osize += crush_choose_firstn(
                        cmap, work, bucket, weight, x, numrep, arg2,
                        o, osize, 0, result_max - osize, choose_tries,
                        recurse_tries, choose_local_retries,
                        choose_local_fallback_retries, recurse_to_leaf,
                        vary_r, stable, cvec, osize, 0, choose_args)
                else:
                    out_size = min(numrep, result_max - osize)
                    crush_choose_indep(
                        cmap, work, bucket, weight, x, out_size, numrep,
                        arg2, o, osize, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, cvec, osize, 0, choose_args)
                    osize += out_size
            if recurse_to_leaf:
                for i in range(osize):
                    o[i] = cvec[i]
            w, o = o, w
            wsize = osize
        elif op == C.CRUSH_RULE_EMIT:
            for i in range(wsize):
                if len(result) >= result_max:
                    break
                result.append(w[i])
            wsize = 0
    return result
