"""Batched CRUSH placement: kernel K2 (the rule walk) and its plain
version.

The port of ``ceph_tpu/crush/mapper_jax.py``.  ``crush_do_rule``
(src/crush/mapper.c:878) maps each input x (a PG) through a rule: take
a bucket, descend the hierarchy with retrying straw2 draws (firstn or
indep), emit devices.  The TPU version vmaps one x's program over the
batch with ``lax.while_loop`` retry descents; PyTorch has no vmapped
data-dependent loop, so on the card the walk is a hand-written CUDA
kernel with a group of lanes per x (``csrc/crush_rule.cu``, a port of
``native/crush_host.cpp:do_rule_one``) that divides by no weight: it
multiplies by the map's ``magic`` reciprocals instead.

``map_batch_plain`` is the plain PyTorch version: the batch axis runs
over xs, every retry loop is a Python loop over the lanes still open,
and a straw2 choose is a masked argmax of the int64 draws over the
padded item axis.  ``crush_rule_batched`` is the kernel's wrapper: K2
on CUDA tensors, the plain version on CPU tensors.

Scope of this slice: buckets all straw2 with the rjenkins hash, no
choose_args, and ``choose_local_tries == choose_local_fallback_tries ==
0`` (also as set by rule steps).  Anything else raises
``NotImplementedError`` on both paths.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import build
from ..device import resolve_device
from . import constants as C
from .hash import crush_hash32_2, crush_hash32_3
from .ln import ln16_table, ln_tables, straw2_draw
from .map import CrushMap
from .map_arrays import MapArrays, MapStatic, as_i32, encode_map, to_device

MAX_RESULT = 32   # result_max cap: the kernel's work vectors
MAX_STEPS = 32    # rule steps the kernel's parameter block holds
MAX_BUCKET = 1 << 15  # bucket width the kernel's straw2 key can index
M32 = 0xFFFFFFFF
UNDEF = C.CRUSH_ITEM_UNDEF
NONE = C.CRUSH_ITEM_NONE
S64_MIN = C.S64_MIN

_CHOOSE_OPS = (C.CRUSH_RULE_CHOOSE_FIRSTN, C.CRUSH_RULE_CHOOSE_INDEP,
               C.CRUSH_RULE_CHOOSELEAF_FIRSTN, C.CRUSH_RULE_CHOOSELEAF_INDEP)


@dataclass(frozen=True)
class RuleProgram:
    """One rule compiled for the walk: its steps, the map's tunables,
    the device count and the result width."""

    steps: Tuple[Tuple[int, int, int], ...]
    tunables: Tuple[int, int, int, int, int, int]
    max_devices: int
    result_max: int


def compile_rule(static: MapStatic, steps, result_max: int) -> RuleProgram:
    """Check that the map and rule are in this slice's scope and pack
    the rule.  ``steps``: (op, arg1, arg2) triples."""
    steps = tuple((int(s[0]), int(s[1]), int(s[2])) for s in steps)
    if any(a != C.CRUSH_BUCKET_STRAW2 for a in static.algs_present):
        raise NotImplementedError(
            f"bucket algorithms {static.algs_present}: only straw2 (5) is "
            f"ported")
    if any(h != C.CRUSH_HASH_RJENKINS1 for h in static.hashes_present):
        raise NotImplementedError(
            f"bucket hashes {static.hashes_present}: only rjenkins1 is "
            f"ported")
    if static.has_choose_args:
        raise NotImplementedError("choose_args are not ported yet")
    local, fallback = static.tunables[0], static.tunables[1]
    for op, a1, _ in steps:
        if op == C.CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES and a1 >= 0:
            local = a1
        if op == C.CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES and a1 >= 0:
            fallback = a1
        if local or fallback:
            raise NotImplementedError(
                "choose_local_tries / choose_local_fallback_tries > 0 "
                "(legacy tunables) are not ported yet")
    if not 1 <= result_max <= MAX_RESULT:
        raise ValueError(f"result_max must be in [1, {MAX_RESULT}], got "
                         f"{result_max}")
    if len(steps) > MAX_STEPS:
        raise ValueError(f"at most {MAX_STEPS} rule steps, got "
                         f"{len(steps)}")
    return RuleProgram(steps=steps, tunables=tuple(static.tunables),
                       max_devices=static.max_devices,
                       result_max=result_max)


# -- the plain version ------------------------------------------------


class _PlainWalk:
    """The rule walk over a batch of xs as torch ops.  Lanes are the xs;
    each method works on the subset of lanes it is given (a LongTensor
    of lane ids) and loops until every one of them is done."""

    def __init__(self, arrays: MapArrays, prog: RuleProgram,
                 weight: torch.Tensor, xs: torch.Tensor):
        self.alg = arrays.alg.to(torch.int64)
        self.btype = arrays.btype.to(torch.int64)
        self.size = arrays.size.to(torch.int64)
        self.items = arrays.items.to(torch.int64)
        self.iw = arrays.weights.to(torch.int64) & M32
        self.B, self.S = self.items.shape
        self.weight = weight.to(torch.int64) & M32
        self.x = xs.to(torch.int64) & M32
        self.prog = prog
        self.R = prog.result_max
        dev = xs.device
        self.ln16 = ln16_table(dev)
        self.slot = torch.arange(self.S, device=dev)
        self.pos = torch.arange(self.R, device=dev)

    # -- per-item helpers ---------------------------------------------
    def straw2(self, lanes, bi, r):
        """bucket_straw2_choose (mapper.c:339-362) for each lane:
        the first item with the largest draw."""
        ids = self.items[bi]
        u = crush_hash32_3(self.x[lanes][:, None], ids,
                           r[:, None]) & 0xFFFF
        draw = straw2_draw(u, self.iw[bi], self.ln16)
        draw = torch.where(self.slot < self.size[bi][:, None], draw,
                           torch.full_like(draw, S64_MIN))
        j = torch.argmax(draw, dim=1, keepdim=True)
        return ids.gather(1, j)[:, 0]

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
               tries, recurse_tries, leaf, vary_r, stable, out2, parent_r):
        """crush_choose_firstn (mapper.c:438-626) for each lane; ``out``
        and ``out2`` are [n, R] rows of this call, updated in place.
        ``rep``, ``numrep``, ``outpos``, ``count``, ``parent_r``: [n].
        Returns the new outpos."""
        rep, outpos, count = rep.clone(), outpos.clone(), count.clone()
        while True:
            go = ((rep < numrep) & (count > 0)).nonzero()[:, 0]
            if go.numel() == 0:
                return outpos
            placed, item = self._firstn_rep(
                go, lanes, root, rep, type_, out, outpos, count, tries,
                recurse_tries, leaf, vary_r, stable, out2, parent_r)
            p = go[placed]
            out[p, outpos[p]] = item[placed]
            outpos[p] += 1
            count[p] -= 1
            rep[go] += 1

    def _firstn_rep(self, go, lanes, root, rep, type_, out, outpos, count,
                    tries, recurse_tries, leaf, vary_r, stable, out2,
                    parent_r):
        """The retry descent for one rep of rows ``go``: returns
        (placed, item) for each of them."""
        n = go.numel()
        in_bi = root[go].clone()
        ftotal = torch.zeros_like(in_bi)
        placed = torch.zeros(n, dtype=torch.bool, device=go.device)
        item = torch.zeros_like(in_bi)
        pend = torch.arange(n, device=go.device)
        while pend.numel():
            g = go[pend]
            ln = lanes[g]
            bi = in_bi[pend]
            r = rep[g] + parent_r[g] + ftotal[pend]
            empty = self.size[bi] == 0
            it = self.straw2(ln, bi, r)
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
                rec = (do_rec & (it < 0)).nonzero()[:, 0]
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
                        0, sub_out, op, count[gr], recurse_tries, 0,
                        False, vary_r, stable, None, sub_r)
                    out2[gr] = sub_out
                    reject[rec] |= got <= op
                dev = (do_rec & (it >= 0)).nonzero()[:, 0]
                out2[g[dev], outpos[g[dev]]] = it[dev]
            check = (live & ~collide & ~reject & (itype == 0)).nonzero()[:, 0]
            if check.numel():
                reject[check] |= self.is_out(ln[check], it[check])
            fail = reject | collide
            ft = ftotal[pend] + fail.to(torch.int64)
            ftotal[pend] = ft
            retry = fail & (ft < tries)
            success = live & ~collide & ~reject
            done = over | bad | (fail & ~retry) | success
            placed[pend] = success
            item[pend] = it
            in_bi[pend] = torch.where(descend, cidx,
                                      torch.where(retry, root[g], bi))
            pend = pend[~done]
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
        width = int(left.max()) if left.numel() else 0
        for ftotal in range(tries):
            active = left > 0
            if not bool(active.any()):
                break
            for rep in range(outpos, outpos + width):
                sel = (active & (rep < endpos)
                       & (out[:, rep] == UNDEF)).nonzero()[:, 0]
                if sel.numel():
                    self._indep_descent(
                        sel, lanes, root, rep, ftotal, numrep, type_, out,
                        out2, left, seg, recurse_tries, leaf, parent_r)
        out[seg & (out == UNDEF)] = NONE
        if out2 is not None:
            out2[seg & (out2 == UNDEF)] = NONE

    def _indep_descent(self, sel, lanes, root, rep, ftotal, numrep, type_,
                       out, out2, left, seg, recurse_tries, leaf,
                       parent_r):
        """One round's descent for slot ``rep`` of rows ``sel``."""
        pend = sel
        in_bi = root[sel]
        while pend.numel():
            ln = lanes[pend]
            r = rep + parent_r[pend] + numrep * ftotal
            empty = self.size[in_bi] == 0
            it = self.straw2(ln, in_bi, r)
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
                rec = (ok & (it < 0)).nonzero()[:, 0]
                if rec.numel():
                    sub = out2[pend[rec]]
                    self.indep(ln[rec], cidx[rec], rep,
                               torch.ones_like(rec), numrep, 0, sub, None,
                               recurse_tries, 0, False, r[rec])
                    out2[pend[rec]] = sub
                    ok[rec] &= sub[:, rep] != NONE
                dev = (ok & (it >= 0)).nonzero()[:, 0]
                out2[pend[dev], rep] = it[dev]
            chk = (ok & (itype == 0)).nonzero()[:, 0]
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
        (_, _, total_tries, descend_once, vary_r, stable) = prog.tunables
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
                    lanes = ((i < wsize) & valid).nonzero()[:, 0]
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
                            R - base, choose_tries, recurse_tries, leaf,
                            vary_r, stable, lc, z)
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
                ("total_tries", ctypes.c_int),
                ("descend_once", ctypes.c_int),
                ("vary_r", ctypes.c_int),
                ("stable", ctypes.c_int),
                ("result_max", ctypes.c_int),
                ("max_devices", ctypes.c_int),
                ("B", ctypes.c_int),
                ("S", ctypes.c_int),
                ("weight_len", ctypes.c_int)]


def _lib():
    lib = build.load("crush_rule")
    fn = lib.crush_rule_batched_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Program)] + [ctypes.c_void_p] * 6 \
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(arrays: MapArrays, weight, xs):
    dev = xs.device
    for name in ("alg", "btype", "size", "items", "weights"):
        t = getattr(arrays, name)
        if t.device != dev or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"map array {name} must be a contiguous int32 "
                             f"tensor on {dev}")
    for name, t in (("weight", weight), ("xs", xs)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 "
                             f"tensor on {dev}")
    if arrays.items.shape != arrays.weights.shape or \
            arrays.items.shape[0] != arrays.alg.shape[0]:
        raise ValueError("map arrays disagree on their shapes")


def crush_rule_batched(arrays: MapArrays, prog: RuleProgram,
                       weight: torch.Tensor, xs: torch.Tensor,
                       draws: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map every x through the rule: (i32[N, R], i32[N]).  Kernel K2 on
    CUDA tensors, ``map_batch_plain`` on CPU tensors.  Arrays, weight
    and xs are int32 tensors (u32 values as bit patterns) on one device.
    The kernel reads ``arrays.magic``, which follows ``arrays.weights``.

    ``draws``: an optional i32[N] CUDA tensor that receives the number
    of straw2 item draws each x took (what a run's work is counted by).
    """
    _check(arrays, weight, xs)
    if xs.device.type == "cpu":
        return map_batch_plain(arrays, prog, weight, xs)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    if arrays.items.shape[1] > MAX_BUCKET:
        raise NotImplementedError(f"buckets wider than {MAX_BUCKET} items")
    N, R = xs.numel(), prog.result_max
    res = torch.empty((N, R), dtype=torch.int32, device=xs.device)
    lens = torch.empty(N, dtype=torch.int32, device=xs.device)
    if N == 0:
        return res, lens
    if draws is not None and (draws.device != xs.device or
                              draws.dtype != torch.int32 or
                              draws.shape != (N,)):
        raise ValueError("draws must be an int32 [N] tensor beside xs")
    p = _Program()
    p.nsteps = len(prog.steps)
    for i, step in enumerate(prog.steps):
        p.steps[3 * i:3 * i + 3] = step
    (_, _, p.total_tries, p.descend_once, p.vary_r,
     p.stable) = prog.tunables
    p.result_max, p.max_devices = R, prog.max_devices
    p.B, p.S = arrays.items.shape
    p.weight_len = weight.numel()
    tabs = _ln_tables_on(xs.device)
    magic = arrays.magic
    launch = _lib()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = launch(ctypes.byref(p), arrays.alg.data_ptr(),
                    arrays.btype.data_ptr(), arrays.size.data_ptr(),
                    arrays.items.data_ptr(), magic.data_ptr(),
                    weight.data_ptr(), xs.data_ptr(), N, tabs.data_ptr(),
                    res.data_ptr(), lens.data_ptr(),
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
                  device="cuda"):
    """Compile one rule into a batched mapper.

    Returns ``(fn, static, arrays)``: ``fn(arrays, weight, xs) ->
    (results i32[N, result_max], lens i32[N])`` and the map's arrays as
    tensors on ``device``.  Pass updated arrays or weights freely."""
    dev = resolve_device(device)
    static, arrays_np = encode_map(cmap, bool(cmap.choose_args))
    prog = compile_rule(static, _rule_steps(cmap, ruleno), result_max)

    def fn(arrays, weight, xs):
        return crush_rule_batched(arrays, prog, as_i32(weight, dev),
                                  as_i32(xs, dev))

    return fn, static, to_device(arrays_np, dev)


class BatchedMapper:
    """User-facing handle: one encode of the map, a compiled program per
    (rule, result_max), the map's arrays resident on ``device``.

    >>> m = BatchedMapper(cmap)
    >>> res, lens = m.map_batch(ruleno, xs, result_max, weight)
    """

    def __init__(self, cmap: CrushMap, device="cuda"):
        self.device = resolve_device(device)
        self.cmap = cmap
        self.static, arrays_np = encode_map(cmap, bool(cmap.choose_args))
        self.arrays = to_device(arrays_np, self.device)
        self._progs = {}

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
        return crush_rule_batched(self.arrays, prog,
                                  as_i32(weight, self.device),
                                  as_i32(xs, self.device))
