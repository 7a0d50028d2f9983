"""Batched CRUSH placement: kernel K2 (the rule walk) and its plain
version.

The port of ``ceph_tpu/crush/mapper_jax.py``.  ``crush_do_rule``
(src/crush/mapper.c:878) maps each input x (a PG) through a rule: take
a bucket, descend the hierarchy with retrying bucket draws (firstn or
indep), emit devices.  The TPU version vmaps one x's program over the
batch with ``lax.while_loop`` retry descents; PyTorch has no vmapped
data-dependent loop, so on the card the walk is a hand-written CUDA
kernel with a group of lanes per x (``csrc/crush_rule.cu``, a port of
``native/crush_host.cpp:do_rule_one``) that divides by no weight: it
multiplies by the map's ``magic`` reciprocals instead.

``map_batch_plain`` is the plain PyTorch version: the batch axis runs
over xs, every retry loop is a Python loop over the lanes still open,
and a bucket choose runs per algorithm on the lanes whose bucket has
it (straw2: a masked argmax of the int64 draws over the padded item
axis).  ``crush_rule_batched`` is the kernel's wrapper: K2 on CUDA
tensors, the plain version on CPU tensors.

Scope: every bucket algorithm (uniform, list, tree, straw, straw2),
choose_args, local retries and the perm fallback.  A map or rule past
what the kernel holds (a bucket hash other than rjenkins1, buckets
wider than ``MAX_BUCKET``, more than ``MAX_STEPS`` steps, result_max
above ``MAX_RESULT``) is refused by ``compile_rule`` on both paths.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import build
from ..common import device_metrics
from ..common.perf_counters import collection
from ..device import resolve_device
from . import constants as C
from .hash import crush_hash32_2, crush_hash32_3, crush_hash32_4
from .ln import ln16_table, ln_tables, straw2_draw
from .map import ChooseArgMap, CrushMap
from .map_arrays import MapArrays, MapStatic, as_i32, encode_map, to_device

MAX_RESULT = 32   # result_max cap: the kernel's work vectors
MAX_STEPS = 32    # rule steps the kernel's parameter block holds
MAX_BUCKET = 1 << 15  # bucket width the kernel's straw/straw2 keys index
M32 = 0xFFFFFFFF
UNDEF = C.CRUSH_ITEM_UNDEF
NONE = C.CRUSH_ITEM_NONE
S64_MIN = C.S64_MIN
N_ALGS = 5  # columns of ``draws``: bucket algorithm - 1

# process-global batched-mapper metrics, ``ceph_tpu``'s names: launch
# count/size, steady-state latency, and first-call counts/time kept
# apart (``jit_compiles`` counts a signature's first call, which builds
# the kernel library and the launch plan here)
_pc = collection().create("crush.mapper")
for _k in ("map_calls", "xs_mapped", "jit_compiles"):
    _pc.add_u64_counter(_k)
_pc.add_time("map_time")
_pc.add_time("jit_compile_time")
_pc.add_histogram("map_lat")

_CHOOSE_OPS = (C.CRUSH_RULE_CHOOSE_FIRSTN, C.CRUSH_RULE_CHOOSE_INDEP,
               C.CRUSH_RULE_CHOOSELEAF_FIRSTN, C.CRUSH_RULE_CHOOSELEAF_INDEP)


@dataclass(frozen=True)
class RuleProgram:
    """One rule compiled for the walk: its steps, the map's tunables,
    the device count, the result width, whether straw2 reads the
    choose_args weight sets, and whether the map needs the kernel's
    general variant (any algorithm but straw2, choose_args, or local
    retries) or its straw2-only one."""

    steps: Tuple[Tuple[int, int, int], ...]
    tunables: Tuple[int, int, int, int, int, int]
    max_devices: int
    result_max: int
    has_choose_args: bool
    general: bool


def compile_rule(static: MapStatic, steps, result_max: int) -> RuleProgram:
    """Check that the map and rule fit the kernel and pack the rule.
    ``steps``: (op, arg1, arg2) triples."""
    steps = tuple((int(s[0]), int(s[1]), int(s[2])) for s in steps)
    if any(h != C.CRUSH_HASH_RJENKINS1 for h in static.hashes_present):
        raise NotImplementedError(
            f"bucket hashes {static.hashes_present}: only rjenkins1 (0), "
            f"the one hash CRUSH defines, is ported")
    if static.max_size > MAX_BUCKET:
        raise NotImplementedError(
            f"buckets wider than {MAX_BUCKET} items (widest: "
            f"{static.max_size})")
    if not 1 <= result_max <= MAX_RESULT:
        raise ValueError(f"result_max must be in [1, {MAX_RESULT}], got "
                         f"{result_max}")
    if len(steps) > MAX_STEPS:
        raise ValueError(f"at most {MAX_STEPS} rule steps, got "
                         f"{len(steps)}")
    local = static.tunables[0] > 0 or static.tunables[1] > 0 or any(
        op in (C.CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
               C.CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES) and a1 > 0
        for op, a1, _ in steps)
    general = (local or static.has_choose_args
               or any(a != C.CRUSH_BUCKET_STRAW2
                      for a in static.algs_present))
    return RuleProgram(steps=steps, tunables=tuple(static.tunables),
                       max_devices=static.max_devices,
                       result_max=result_max,
                       has_choose_args=static.has_choose_args,
                       general=general)


# -- the plain version ------------------------------------------------


def _mulhi32(a, b):
    """``(a * b) >> 32`` for u32 values in int64 tensors, exactly: the
    product reaches 2^64, past int64, so ``a`` goes in 16-bit halves."""
    return ((a >> 16) * b + (((a & 0xFFFF) * b) >> 16)) >> 16


class _PlainWalk:
    """The rule walk over a batch of xs as torch ops.  Lanes are the xs;
    each method works on the subset of lanes it is given (a LongTensor
    of lane ids) and loops until every one of them is done."""

    def __init__(self, arrays: MapArrays, prog: RuleProgram,
                 weight: torch.Tensor, xs: torch.Tensor):
        def u32(t):
            return t.to(torch.int64) & M32

        self.alg = arrays.alg.to(torch.int64)
        self.btype = arrays.btype.to(torch.int64)
        self.size = arrays.size.to(torch.int64)
        self.nnodes = arrays.nnodes.to(torch.int64)
        self.items = arrays.items.to(torch.int64)
        self.iw = u32(arrays.weights)
        self.sw = u32(arrays.sum_weights)
        self.straws = u32(arrays.straws)
        self.nw = u32(arrays.node_weights)
        self.arg_ids = arrays.arg_ids.to(torch.int64)
        self.arg_w = u32(arrays.arg_weights)
        self.B, self.S = self.items.shape
        self.P = self.arg_w.shape[1]
        self.weight = u32(weight)
        self.x = u32(xs)
        self.prog = prog
        self.R = prog.result_max
        dev = xs.device
        self.ln16 = ln16_table(dev)
        self.slot = torch.arange(self.S, device=dev)
        self.pos = torch.arange(self.R, device=dev)
        self.algs = sorted(set(self.alg[self.alg != 0].tolist()))
        self._choose = {C.CRUSH_BUCKET_UNIFORM: self.perm,
                        C.CRUSH_BUCKET_LIST: self.list_,
                        C.CRUSH_BUCKET_TREE: self.tree,
                        C.CRUSH_BUCKET_STRAW: self.straw,
                        C.CRUSH_BUCKET_STRAW2: self.straw2}

    # -- bucket chooses: x, bucket index, r (and position) per lane ----
    def _in_bucket(self, bi):
        return self.slot < self.size[bi][:, None]

    def straw2(self, x, bi, r, position):
        """bucket_straw2_choose (mapper.c:339-362) with the choose_args
        substitution (mapper.c:287-304): hash the ids, draw against the
        weight set at ``min(position, P - 1)``, return the first item
        with the largest draw."""
        if self.prog.has_choose_args:
            ids = self.arg_ids[bi]
            w = self.arg_w[bi, position.clamp(max=self.P - 1)]
        else:
            ids, w = self.items[bi], self.iw[bi]
        u = crush_hash32_3(x[:, None], ids, r[:, None]) & 0xFFFF
        draw = straw2_draw(u, w, self.ln16)
        draw = torch.where(self._in_bucket(bi), draw,
                           torch.full_like(draw, S64_MIN))
        j = torch.argmax(draw, dim=1, keepdim=True)
        return self.items[bi].gather(1, j)[:, 0]

    def straw(self, x, bi, r, position):
        """bucket_straw_choose (mapper.c:205-223): the first maximum of
        ``(hash & 0xffff) * straw``, a product below 2^48."""
        ids = self.items[bi]
        u = crush_hash32_3(x[:, None], ids, r[:, None]) & 0xFFFF
        draw = torch.where(self._in_bucket(bi), u * self.straws[bi],
                           torch.full_like(u, -1))
        j = torch.argmax(draw, dim=1, keepdim=True)
        return ids.gather(1, j)[:, 0]

    def list_(self, x, bi, r, position):
        """bucket_list_choose (mapper.c:119-142): the largest index whose
        ``(hash & 0xffff) * sum_weight >> 16`` falls below its weight;
        items[0] if none does."""
        ids = self.items[bi]
        h = crush_hash32_4(x[:, None], ids, r[:, None],
                           (-1 - bi)[:, None]) & 0xFFFF
        hit = (((h * self.sw[bi]) >> 16) < self.iw[bi]) & \
            self._in_bucket(bi)
        j = torch.where(hit, self.slot, -1).max(dim=1).values.clamp(min=0)
        return ids.gather(1, j[:, None])[:, 0]

    def tree(self, x, bi, r, position):
        """bucket_tree_choose (mapper.c:145-200): descend the implicit
        binary tree from node ``num_nodes >> 1`` to an odd (leaf) node,
        left when ``hash * node_weight >> 32`` is below the left
        child's weight."""
        n = (self.nnodes[bi] >> 1).clamp(min=1)
        bid = -1 - bi  # the bucket id
        nw = self.nw[bi]
        while True:
            go = ((n & 1) == 0).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
            if go.numel() == 0:
                break
            ng = n[go]
            h = crush_hash32_4(x[go], ng, r[go], bid[go])
            t = _mulhi32(h, nw[go].gather(1, ng[:, None])[:, 0])
            half = (ng & -ng) >> 1
            left = ng - half
            lw = nw[go].gather(1, left[:, None])[:, 0]
            n[go] = torch.where(t < lw, left, ng + half)
        return self.items[bi].gather(1, (n >> 1)[:, None])[:, 0]

    def perm(self, x, bi, r, position=None):
        """bucket_perm_choose (mapper.c:51-109): entry ``r % size`` of
        the bucket's Fisher-Yates permutation of x.  The C code builds
        the permutation step by step and keeps it per bucket across
        calls; entry ``pr`` depends only on (x, bucket, pr), so this
        traces it back instead: step k swaps positions k and k + i_k
        (i_k = hash(x, id, k) % (size - k)), and the entry at ``pr``
        after steps 0..pr came from the position found by undoing them
        from step pr down to 0.  The r = 0 shortcut (perm[0] = i_0) is
        the same value."""
        sz = self.size[bi]
        pr = r % sz
        k = self.slot[None, :]
        i = crush_hash32_3(x[:, None], (-1 - bi)[:, None], k) \
            % (sz[:, None] - k).clamp(min=1)
        i = torch.where(k < sz[:, None] - 1, i, torch.zeros_like(i))
        p = pr.clone()
        for step in range(int(pr.max()), -1, -1):  # sync-ok: the plain walk's loop bound (CPU tensors; K2 on the card)
            on = step <= pr
            ik = step + i[:, step]
            p = torch.where(on & (p == step), ik,
                            torch.where(on & (p == ik), step, p))
        return self.items[bi].gather(1, p[:, None])[:, 0]

    def choose(self, x, bi, r, position):
        """crush_bucket_choose (mapper.c:365-396) for each lane, by the
        algorithm of its bucket."""
        if len(self.algs) == 1:
            return self._choose[self.algs[0]](x, bi, r, position)
        alg = self.alg[bi]
        item = torch.zeros_like(bi)
        for a in self.algs:
            sel = (alg == a).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
            if sel.numel():
                item[sel] = self._choose[a](x[sel], bi[sel], r[sel],
                                            position[sel])
        return item

    def classify(self, item):
        """(itemtype, child bucket index, child is a bucket): itemtype
        is 0 for a device and -1 for a negative id with no bucket."""
        cidx = (-1 - item).clamp(0, self.B - 1)
        valid = (item < 0) & ((-1 - item) < self.B) & (self.alg[cidx] != 0)
        itype = torch.where(item < 0,
                            torch.where(valid, self.btype[cidx],
                                        torch.full_like(item, -1)),
                            torch.zeros_like(item))
        return itype, cidx, valid

    def is_out(self, lanes, item):
        """Weight-based rejection of a device (mapper.c:402-416)."""
        wlen = self.weight.numel()
        w = self.weight[item.clamp(0, wlen - 1)]
        h = crush_hash32_2(self.x[lanes], item) & 0xFFFF
        return (item >= wlen) | ((w < 0x10000) & ((w == 0) | (h >= w)))

    # -- firstn -------------------------------------------------------
    def firstn(self, lanes, root, rep, numrep, type_, out, outpos, count,
               tries, recurse_tries, local, fallback, leaf, vary_r, stable,
               out2, parent_r):
        """crush_choose_firstn (mapper.c:438-626) for each lane; ``out``
        and ``out2`` are [n, R] rows of this call, updated in place.
        ``rep``, ``numrep``, ``outpos``, ``count``, ``parent_r``: [n].
        Returns the new outpos."""
        rep, outpos, count = rep.clone(), outpos.clone(), count.clone()
        while True:
            go = ((rep < numrep) & (count > 0)).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
            if go.numel() == 0:
                return outpos
            placed, item = self._firstn_rep(
                go, lanes, root, rep, type_, out, outpos, count, tries,
                recurse_tries, local, fallback, leaf, vary_r, stable, out2,
                parent_r)
            p = go[placed]
            out[p, outpos[p]] = item[placed]
            outpos[p] += 1
            count[p] -= 1
            rep[go] += 1

    def _firstn_rep(self, go, lanes, root, rep, type_, out, outpos, count,
                    tries, recurse_tries, local, fallback, leaf, vary_r,
                    stable, out2, parent_r):
        """The retry descent for one rep of rows ``go``: returns
        (placed, item) for each of them.  A failed draw retries in the
        same bucket (local retries, the perm fallback) or from the top
        (a new descent, ``flocal`` back to 0)."""
        n = go.numel()
        in_bi = root[go].clone()
        ftotal = torch.zeros_like(in_bi)
        flocal = torch.zeros_like(in_bi)
        placed = torch.zeros(n, dtype=torch.bool, device=go.device)
        item = torch.zeros_like(in_bi)
        pend = torch.arange(n, device=go.device)
        while pend.numel():
            g = go[pend]
            ln = lanes[g]
            bi = in_bi[pend]
            fl = flocal[pend]
            r = rep[g] + parent_r[g] + ftotal[pend]
            sz = self.size[bi]
            empty = sz == 0
            it = torch.zeros_like(bi)
            usep = ~empty & (fl >= (sz >> 1)) & (fl > fallback) \
                if fallback > 0 else torch.zeros_like(empty)
            for mask, fn in ((usep, self.perm), (~empty & ~usep, self.choose)):
                sel = mask.nonzero()[:, 0]  # sync-ok: plain walk, CPU only
                if sel.numel():
                    it[sel] = fn(self.x[ln[sel]], bi[sel], r[sel],
                                 outpos[g[sel]])
            over = ~empty & (it >= self.prog.max_devices)
            itype, cidx, valid = self.classify(it)
            ne = ~empty & ~over
            descend = ne & (itype != type_) & valid
            bad = ne & (itype != type_) & ~valid
            live = ne & (itype == type_)
            seen = (out[g] == it[:, None]) & (self.pos < outpos[g][:, None])
            collide = live & seen.any(dim=1)
            reject = empty.clone()
            if leaf:
                do_rec = live & ~collide
                rec = (do_rec & (it < 0)).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
                if rec.numel():
                    gr = g[rec]
                    op = outpos[gr]
                    sub_r = (r[rec] >> (vary_r - 1)) if vary_r \
                        else torch.zeros_like(op)
                    sub_out = out2[gr]
                    got = self.firstn(
                        ln[rec], cidx[rec],
                        torch.zeros_like(op) if stable else op,
                        torch.ones_like(op) if stable else op + 1,
                        0, sub_out, op, count[gr], recurse_tries, 0, local,
                        fallback, False, vary_r, stable, None, sub_r)
                    out2[gr] = sub_out
                    reject[rec] |= got <= op
                dev = (do_rec & (it >= 0)).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
                out2[g[dev], outpos[g[dev]]] = it[dev]
            check = (live & ~collide & ~reject & (itype == 0)).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
            if check.numel():
                reject[check] |= self.is_out(ln[check], it[check])
            fail = reject | collide
            ft = ftotal[pend] + fail.to(torch.int64)
            fl = fl + fail.to(torch.int64)
            ftotal[pend] = ft
            retry_b = fail & ((collide & (fl <= local))
                              | ((fl <= sz + fallback) if fallback > 0
                                 else torch.zeros_like(fail)))
            retry_d = fail & ~retry_b & (ft < tries)
            success = live & ~collide & ~reject
            done = over | bad | (fail & ~retry_b & ~retry_d) | success
            placed[pend] = success
            item[pend] = it
            in_bi[pend] = torch.where(descend, cidx,
                                      torch.where(retry_d, root[g], bi))
            flocal[pend] = torch.where(retry_d, torch.zeros_like(fl), fl)
            pend = pend[~done]  # sync-ok: plain walk, CPU only
        return placed, item

    # -- indep --------------------------------------------------------
    def indep(self, lanes, root, outpos, left, numrep, type_, out, out2,
              tries, recurse_tries, leaf, parent_r):
        """crush_choose_indep (mapper.c:633-821) for each lane: fills
        positions [outpos, outpos + left) of ``out``/``out2`` (rows of
        this call, updated in place) breadth-first, UNDEF backfilled to
        NONE.  ``outpos`` is the same for every lane; ``left``,
        ``parent_r``: [n]."""
        endpos = outpos + left
        seg = (self.pos >= outpos) & (self.pos < endpos[:, None])
        out[seg] = UNDEF
        if out2 is not None:
            out2[seg] = UNDEF
        left = left.clone()
        width = int(left.max()) if left.numel() else 0  # sync-ok: the plain walk's loop bound (CPU tensors; K2 on the card)
        for ftotal in range(tries):
            active = left > 0
            if not bool(active.any()):  # sync-ok: the plain walk's early exit (CPU tensors; K2 on the card)
                break
            for rep in range(outpos, outpos + width):
                sel = (active & (rep < endpos)  # sync-ok: plain walk, CPU only
                       & (out[:, rep] == UNDEF)).nonzero()[:, 0]
                if sel.numel():
                    self._indep_descent(
                        sel, lanes, root, outpos, rep, ftotal, numrep,
                        type_, out, out2, left, seg, recurse_tries, leaf,
                        parent_r)
        out[seg & (out == UNDEF)] = NONE  # sync-ok: plain walk, CPU only
        if out2 is not None:
            out2[seg & (out2 == UNDEF)] = NONE  # sync-ok: plain walk, CPU only

    def _indep_descent(self, sel, lanes, root, outpos, rep, ftotal, numrep,
                       type_, out, out2, left, seg, recurse_tries, leaf,
                       parent_r):
        """One round's descent for slot ``rep`` of rows ``sel``.  The
        choose_args position is the call's ``outpos`` (mapper.c:701),
        not the slot."""
        pend = sel
        in_bi = root[sel]
        while pend.numel():
            ln = lanes[pend]
            # a uniform bucket whose size numrep divides steps r by
            # numrep + 1 a round (mapper.c:680-685)
            uni = (self.alg[in_bi] == C.CRUSH_BUCKET_UNIFORM) & \
                (self.size[in_bi] % numrep == 0)
            r = rep + parent_r[pend] + ftotal * torch.where(
                uni, torch.full_like(in_bi, numrep + 1),
                torch.full_like(in_bi, numrep))
            empty = self.size[in_bi] == 0
            it = torch.zeros_like(in_bi)
            ne = (~empty).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
            if ne.numel():
                it[ne] = self.choose(self.x[ln[ne]], in_bi[ne], r[ne],
                                     torch.full_like(ne, outpos))
            over = ~empty & (it >= self.prog.max_devices)
            itype, cidx, valid = self.classify(it)
            ne = ~empty & ~over
            descend = ne & (itype != type_) & valid
            bad = (ne & (itype != type_) & ~valid) | over
            live = ne & (itype == type_)
            b = pend[bad]
            out[b, rep] = NONE
            if out2 is not None:
                out2[b, rep] = NONE
            left[b] -= 1
            seen = (out[pend] == it[:, None]) & seg[pend]
            ok = live & ~seen.any(dim=1)
            if leaf:
                rec = (ok & (it < 0)).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
                if rec.numel():
                    sub = out2[pend[rec]]
                    self.indep(ln[rec], cidx[rec], rep,
                               torch.ones_like(rec), numrep, 0, sub, None,
                               recurse_tries, 0, False, r[rec])
                    out2[pend[rec]] = sub
                    ok[rec] &= sub[:, rep] != NONE
                dev = (ok & (it >= 0)).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
                out2[pend[dev], rep] = it[dev]
            chk = (ok & (itype == 0)).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
            if chk.numel():
                ok[chk] &= ~self.is_out(ln[chk], it[chk])
            o = pend[ok]
            out[o, rep] = it[ok]
            left[o] -= 1
            in_bi = cidx[descend]
            pend = pend[descend]

    # -- the rule VM --------------------------------------------------
    def run(self):
        """crush_do_rule (mapper.c:878-1080) for every lane."""
        prog, R = self.prog, self.R
        N = self.x.numel()
        dev = self.x.device
        zeros = torch.zeros(N, dtype=torch.int64, device=dev)
        result = torch.full((N, R), NONE, dtype=torch.int64, device=dev)
        rlen = zeros.clone()
        w = torch.zeros((N, R), dtype=torch.int64, device=dev)
        wsize = zeros.clone()
        wbound = 0
        (local, fallback, total_tries, descend_once, vary_r,
         stable) = prog.tunables
        choose_tries = total_tries + 1   # mapper.c:906 off-by-one heritage
        choose_leaf_tries = 0
        for op, a1, a2 in prog.steps:
            if op == C.CRUSH_RULE_TAKE:
                _, _, valid = self.classify(torch.tensor([a1], device=dev))
                if 0 <= a1 < prog.max_devices or bool(valid[0]):
                    w[:, 0] = a1
                    wsize[:] = 1
                    wbound = 1
            elif op == C.CRUSH_RULE_SET_CHOOSE_TRIES:
                if a1 > 0:
                    choose_tries = a1
            elif op == C.CRUSH_RULE_SET_CHOOSELEAF_TRIES:
                if a1 > 0:
                    choose_leaf_tries = a1
            elif op == C.CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
                if a1 >= 0:
                    local = a1
            elif op == C.CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                if a1 >= 0:
                    fallback = a1
            elif op == C.CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
                if a1 >= 0:
                    vary_r = a1
            elif op == C.CRUSH_RULE_SET_CHOOSELEAF_STABLE:
                if a1 >= 0:
                    stable = a1
            elif op in _CHOOSE_OPS:
                if wbound == 0:
                    continue
                numrep = a1 if a1 > 0 else a1 + R
                if numrep <= 0:
                    continue
                firstn = op in (C.CRUSH_RULE_CHOOSE_FIRSTN,
                                C.CRUSH_RULE_CHOOSELEAF_FIRSTN)
                leaf = op in (C.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                              C.CRUSH_RULE_CHOOSELEAF_INDEP)
                o = torch.zeros((N, R), dtype=torch.int64, device=dev)
                c = torch.zeros_like(o)
                osize = zeros.clone()
                for i in range(wbound):
                    src = w[:, i]
                    _, cidx, valid = self.classify(src)
                    lanes = ((i < wsize) & valid).nonzero()[:, 0]  # sync-ok: plain walk, CPU only
                    n = lanes.numel()
                    if n == 0:
                        continue
                    lo = torch.zeros((n, R), dtype=torch.int64, device=dev)
                    lc = torch.zeros_like(lo)
                    base = osize[lanes]
                    z = torch.zeros(n, dtype=torch.int64, device=dev)
                    if firstn:
                        if choose_leaf_tries:
                            recurse_tries = choose_leaf_tries
                        elif descend_once:
                            recurse_tries = 1
                        else:
                            recurse_tries = choose_tries
                        got = self.firstn(
                            lanes, cidx[lanes], z, z + numrep, a2, lo, z,
                            R - base, choose_tries, recurse_tries, local,
                            fallback, leaf, vary_r, stable, lc, z)
                    else:
                        got = torch.clamp(R - base, max=numrep)
                        self.indep(lanes, cidx[lanes], 0, got, numrep, a2,
                                   lo, lc, choose_tries,
                                   choose_leaf_tries or 1, leaf, z)
                    keep = self.pos < got[:, None]
                    rows = lanes[:, None].expand(n, R)[keep]
                    cols = (base[:, None] + self.pos)[keep]
                    o[rows, cols] = lo[keep]
                    c[rows, cols] = lc[keep]
                    osize[lanes] += got
                if leaf:
                    o = torch.where(self.pos < osize[:, None], c, o)
                w, wsize = o, osize
                wbound = min(R, wbound * numrep)
            elif op == C.CRUSH_RULE_EMIT:
                src_i = self.pos - rlen[:, None]
                take = (src_i >= 0) & (src_i < wsize[:, None])
                got = w.gather(1, src_i.clamp(0, R - 1))
                result = torch.where(take, got, result)
                rlen = torch.clamp(rlen + wsize, max=R)
                wsize = zeros.clone()
                wbound = 0
        return result.to(torch.int32), rlen.to(torch.int32)


def map_batch_plain(arrays: MapArrays, prog: RuleProgram,
                    weight: torch.Tensor, xs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch rule walk: (i32[N, R] results padded with
    CRUSH_ITEM_NONE, i32[N] lengths), on the device of ``xs``."""
    return _PlainWalk(arrays, prog, weight, xs).run()


# -- kernel K2 --------------------------------------------------------


class _Program(ctypes.Structure):
    """Mirror of ``RuleParams`` in csrc/crush_rule.cu, passed by value."""

    _fields_ = [("nsteps", ctypes.c_int),
                ("steps", ctypes.c_int * (3 * MAX_STEPS)),
                ("local_tries", ctypes.c_int),
                ("local_fallback_tries", ctypes.c_int),
                ("total_tries", ctypes.c_int),
                ("descend_once", ctypes.c_int),
                ("vary_r", ctypes.c_int),
                ("stable", ctypes.c_int),
                ("result_max", ctypes.c_int),
                ("max_devices", ctypes.c_int),
                ("B", ctypes.c_int),
                ("S", ctypes.c_int),
                ("N", ctypes.c_int),
                ("P", ctypes.c_int),
                ("weight_len", ctypes.c_int),
                ("has_args", ctypes.c_int),
                ("general", ctypes.c_int)]


_MAP_FIELDS = ("alg", "btype", "size", "nnodes", "items", "arg_ids",
               "weights", "sum_weights", "straws", "node_weights")


class _MapPtrs(ctypes.Structure):
    """Mirror of ``MapPtrs`` in csrc/crush_rule.cu: the map's device
    arrays and the straw2 reciprocals the kernel reads."""

    _fields_ = [(name, ctypes.c_void_p) for name in _MAP_FIELDS + ("magic",)]


def _lib():
    lib = build.load("crush_rule")
    fn = lib.crush_rule_batched_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Program), ctypes.POINTER(_MapPtrs),
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_STRAW2_FIELDS = ("alg", "btype", "size", "items", "weights")
_ROWS = ("items", "weights", "sum_weights", "straws", "arg_ids",
         "arg_weights")  # fields whose last axis is the item width S


def _check(arrays: MapArrays, names, dev):
    """The map arrays ``names``: contiguous int32 tensors on ``dev``, of
    shapes that agree."""
    B, S = arrays.items.shape
    for name in names:
        t = getattr(arrays, name)
        if not isinstance(t, torch.Tensor) or t.device != dev or \
                t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"map array {name} must be a contiguous int32 "
                             f"tensor on {dev}")
        if t.shape[0] != B or (name in _ROWS and t.shape[-1] != S):
            raise ValueError("map arrays disagree on their shapes")


def _check_vector(name, t, dev):
    if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                         f"on {dev}")


def _launch_plan(arrays: MapArrays, prog: RuleProgram, dev):
    """K2's parameter block and map pointers for (arrays, prog): built
    and checked once, then kept on ``arrays`` while every tensor the
    launched variant reads (the reciprocals included) is the same
    object.  Writes in place keep a tensor's storage; a new weights
    tensor or in-place weight edit gives new reciprocals and a new
    plan."""
    names = _MAP_FIELDS if prog.general else _STRAW2_FIELDS
    if prog.has_choose_args:
        names += ("arg_weights",)
    magic = arrays.arg_magic if prog.has_choose_args else arrays.magic
    tensors = tuple(getattr(arrays, name) for name in names) + (magic,)
    ids = tuple(map(id, tensors))
    plans = arrays.__dict__.setdefault("_launch_plans", {})
    plan = plans.get(prog)
    if plan is not None and plan[0] == ids:
        return plan[2], plan[3]
    _check(arrays, names, dev)
    device_metrics.note_rebuild("launch_plans")
    p = _Program()
    p.nsteps = len(prog.steps)
    for i, step in enumerate(prog.steps):
        p.steps[3 * i:3 * i + 3] = step
    (p.local_tries, p.local_fallback_tries, p.total_tries, p.descend_once,
     p.vary_r, p.stable) = prog.tunables
    p.result_max, p.max_devices = prog.result_max, prog.max_devices
    p.B, p.S = arrays.items.shape
    p.N = arrays.node_weights.shape[1]
    p.P = arrays.arg_weights.shape[1]
    p.has_args = int(prog.has_choose_args)
    p.general = int(prog.general)
    m = _MapPtrs(magic=magic.data_ptr(), **{
        name: t.data_ptr() for name, t in zip(names, tensors)})
    # the tensors stay referenced, so their ids stay theirs
    plans[prog] = (ids, tensors, p, m)
    return p, m


def crush_rule_batched(arrays: MapArrays, prog: RuleProgram,
                       weight: torch.Tensor, xs: torch.Tensor,
                       draws: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map every x through the rule: (i32[N, R], i32[N]).  Kernel K2 on
    CUDA tensors, ``map_batch_plain`` on CPU tensors.  Arrays, weight
    and xs are int32 tensors (u32 values as bit patterns) on one device.
    The kernel reads ``arrays.magic`` (``arrays.arg_magic`` with
    choose_args), which follows the weights straw2 reads.

    ``draws``: an optional i32[N, 5] CUDA tensor that receives, per x,
    the bucket draws the walk made by algorithm (column ``alg - 1``:
    perm steps, list items, tree levels, straw items, straw2 items),
    what a run's work is counted by.
    """
    dev = xs.device
    _check_vector("weight", weight, dev)
    _check_vector("xs", xs, dev)
    if dev.type == "cpu":
        _check(arrays, _MAP_FIELDS + ("arg_weights",), dev)
        return map_batch_plain(arrays, prog, weight, xs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p, m = _launch_plan(arrays, prog, dev)
    N, R = xs.numel(), prog.result_max
    res = torch.empty((N, R), dtype=torch.int32, device=dev)
    lens = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return res, lens
    if draws is not None and (draws.device != dev or
                              draws.dtype != torch.int32 or
                              draws.shape != (N, N_ALGS) or
                              not draws.is_contiguous()):
        raise ValueError("draws must be a contiguous int32 [N, 5] tensor "
                         "beside xs")
    p.weight_len = weight.numel()
    tabs = _ln_tables_on(dev)
    launch = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(ctypes.byref(p), ctypes.byref(m), weight.data_ptr(),
                    xs.data_ptr(), N, tabs.data_ptr(), res.data_ptr(),
                    lens.data_ptr(),
                    draws.data_ptr() if draws is not None else None,
                    stream)
    if rc != 0:
        raise RuntimeError(f"crush_rule_batched launch failed: "
                           f"cudaError {rc}")
    crush_rule_batched.launches += 1
    return res, lens


crush_rule_batched.launches = 0

_LN_TABS = {}


def _ln_tables_on(device) -> torch.Tensor:
    tabs = _LN_TABS.get(device)
    if tabs is None:
        tabs = _LN_TABS[device] = ln_tables(device)
    return tabs


# -- entry points -----------------------------------------------------


def _rule_steps(cmap: CrushMap, ruleno: int):
    return [(s.op, s.arg1, s.arg2) for s in cmap.rules[ruleno].steps]


def build_rule_fn(cmap: CrushMap, ruleno: int, result_max: int,
                  choose_args: Optional[ChooseArgMap] = None,
                  device="cuda"):
    """Compile one rule into a batched mapper.

    Returns ``(fn, static, arrays)``: ``fn(arrays, weight, xs) ->
    (results i32[N, result_max], lens i32[N])`` and the map's arrays
    (with ``choose_args``, if given) as tensors on ``device``.  Pass
    updated arrays or weights freely."""
    dev = resolve_device(device)
    static, arrays_np = encode_map(cmap, choose_args)
    prog = compile_rule(static, _rule_steps(cmap, ruleno), result_max)

    def fn(arrays, weight, xs):
        return crush_rule_batched(arrays, prog, as_i32(weight, dev),
                                  as_i32(xs, dev))

    return fn, static, to_device(arrays_np, dev)


def book_map_batch(sig, dt: float, n_xs: int, result_max: int,
                   first_launch: bool, h2d_bytes: int, d2h_bytes: int,
                   device_ids=None) -> None:
    """Shared perf/device-plane booking for one batched-mapper call (the
    one-device ``BatchedMapper`` and the mesh ``PlacementPlane`` both
    land here, as in ``ceph_tpu``).  A signature's first call books
    apart from steady-state latency; a mesh call books a row for every
    mesh position.  ``dt`` is the host's time around the launches."""
    if first_launch:
        _pc.update((("map_calls", 1), ("xs_mapped", n_xs),
                    ("jit_compiles", 1), ("jit_compile_time", dt)))
    else:
        _pc.update((("map_calls", 1), ("xs_mapped", n_xs),
                    ("map_time", dt)), (("map_lat", dt),))
    if device_ids:
        device_metrics.record_mesh_launch(
            "crush.mapper", sig, dt, device_ids,
            h2d_bytes=h2d_bytes, d2h_bytes=d2h_bytes)
    else:
        device_metrics.record_launch(
            "crush.mapper", sig, dt,
            h2d_bytes=h2d_bytes, d2h_bytes=d2h_bytes)


class BatchedMapper:
    """User-facing handle: one encode of the map (and of a choose_args
    set, if given), a compiled program per (rule, result_max), the
    map's arrays resident on ``device``.

    >>> m = BatchedMapper(cmap)
    >>> res, lens = m.map_batch(ruleno, xs, result_max, weight)

    A mesh of devices is ``parallel.placement.PlacementPlane``'s.
    """

    def __init__(self, cmap: CrushMap,
                 choose_args: Optional[ChooseArgMap] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cmap = cmap
        self.static, arrays_np = encode_map(cmap, choose_args)
        self.arrays = to_device(arrays_np, self.device)
        device_metrics.note_rebuild("lowered_maps")
        self._progs = {}
        self._compiled_sigs: set = set()   # (rule, result_max, (N,))

    def program(self, ruleno: int, result_max: int) -> RuleProgram:
        key = (ruleno, result_max)
        if key not in self._progs:
            self._progs[key] = compile_rule(
                self.static, _rule_steps(self.cmap, ruleno), result_max)
        return self._progs[key]

    def map_batch(self, ruleno: int, xs, result_max: int, weight):
        """Map a batch: xs u32[N], weight 16.16 u32[max_devices] (numpy
        or tensors).  Returns (i32[N, result_max], i32[N]) on the
        mapper's device."""
        prog = self.program(ruleno, result_max)
        xs = as_i32(xs, self.device)
        weight = as_i32(weight, self.device)
        t0 = time.monotonic()
        out = crush_rule_batched(self.arrays, prog, weight, xs)
        dt = time.monotonic() - t0
        n = xs.numel()
        sig = (ruleno, result_max, (n,))
        first = sig not in self._compiled_sigs
        if first:
            self._compiled_sigs.add(sig)
        # xs and weight cross host->device, the results and lengths
        # (i32) back when consumed
        book_map_batch(sig, dt, n, result_max, first,
                       h2d_bytes=n * 4 + weight.numel() * 4,
                       d2h_bytes=n * (result_max + 1) * 4)
        return out
