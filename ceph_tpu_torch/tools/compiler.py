"""CrushCompiler: text crushmap to and from a CrushWrapper.

The port's copy of ``ceph_tpu/tools/compiler.py`` on the port's
``CrushWrapper`` and builder (the role of src/crush/CrushCompiler.cc,
grammar in src/crush/grammar.h:30-200): the ``crushtool -c/-d`` text
format with tunables, devices (and device classes), types, buckets (id,
shadow class ids, alg, hash, items with float weights) and rules (take
[class], choose/chooseleaf firstn/indep, the set_* steps, emit).  The
grammar is line-oriented, so the parser is a line tokenizer; it reads
the reference decompiler's output.  Text is byte-equal to
``ceph_tpu``'s, and class takes resolve to the same shadow ids.

Not carried, as in ``ceph_tpu``: ``tunable straw_calc_version`` and
``allowed_bucket_algs`` are parsed and ignored, and the ``#
choose_args`` section is not read (weight sets travel in the JSON map).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..crush import constants as C
from ..crush.builder import (calc_straw, make_list_bucket,
                             make_straw2_bucket, make_tree_bucket,
                             make_uniform_bucket)
from ..crush.map import CrushMap, Rule, RuleStep
from ..crush.wrapper import CrushWrapper

_TUNABLES = {
    "choose_local_tries": "choose_local_tries",
    "choose_local_fallback_tries": "choose_local_fallback_tries",
    "choose_total_tries": "choose_total_tries",
    "chooseleaf_descend_once": "chooseleaf_descend_once",
    "chooseleaf_vary_r": "chooseleaf_vary_r",
    "chooseleaf_stable": "chooseleaf_stable",
}
_IGNORED_TUNABLES = {"straw_calc_version", "allowed_bucket_algs"}

_SET_STEPS = {
    "set_choose_tries": C.CRUSH_RULE_SET_CHOOSE_TRIES,
    "set_choose_local_tries": C.CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries":
        C.CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_tries": C.CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    "set_chooseleaf_vary_r": C.CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": C.CRUSH_RULE_SET_CHOOSELEAF_STABLE,
}
_SET_STEP_NAMES = {v: k for k, v in _SET_STEPS.items()}

_CHOOSE_OPS = {
    ("choose", "firstn"): C.CRUSH_RULE_CHOOSE_FIRSTN,
    ("choose", "indep"): C.CRUSH_RULE_CHOOSE_INDEP,
    ("chooseleaf", "firstn"): C.CRUSH_RULE_CHOOSELEAF_FIRSTN,
    ("chooseleaf", "indep"): C.CRUSH_RULE_CHOOSELEAF_INDEP,
}


class CompileError(ValueError):
    def __init__(self, lineno: int, msg: str):
        super().__init__(f"line {lineno}: {msg}")
        self.lineno = lineno


def _tokens(text: str):
    """Yield (lineno, [token...]) with comments stripped."""
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if line:
            yield lineno, line.replace("{", " { ").replace(
                "}", " } ").split()


def _w16(s: str) -> int:
    return int(round(float(s) * 0x10000))


def _wf(w: int) -> str:
    return f"{w / 0x10000:.5f}"


# ---------------------------------------------------------------------------
# compile: text -> CrushWrapper
# ---------------------------------------------------------------------------

def compile_crushmap(text: str) -> CrushWrapper:
    w = CrushWrapper(CrushMap(), types={})
    # (bucket_name, shadow_id, class_name) declarations to register
    shadow_decls: List[Tuple[str, int, str]] = []
    lines = list(_tokens(text))
    i = 0
    while i < len(lines):
        lineno, t = lines[i]
        head = t[0]
        if head == "tunable":
            if len(t) != 3:
                raise CompileError(lineno, "tunable <name> <value>")
            if t[1] in _TUNABLES:
                setattr(w.crush.tunables, _TUNABLES[t[1]], int(t[2]))
            elif t[1] not in _IGNORED_TUNABLES:
                raise CompileError(lineno,
                                   f"tunable {t[1]} not recognized")
            i += 1
        elif head == "device":
            # device <id> <name> [class <class>]
            if len(t) < 3:
                raise CompileError(lineno, "device <id> <name>")
            dev = int(t[1])
            name = t[2]
            if name != f"device{dev}":  # unnamed holes use deviceN
                w.set_item_name(dev, name)
            w.crush.max_devices = max(w.crush.max_devices, dev + 1)
            if len(t) >= 5 and t[3] == "class":
                w.set_item_class(dev, t[4])
            i += 1
        elif head == "type":
            if len(t) != 3:
                raise CompileError(lineno, "type <id> <name>")
            w.set_type_name(int(t[1]), t[2])
            i += 1
        elif head == "rule":
            i = _parse_rule(w, lines, i)
        elif len(t) >= 3 and t[-1] == "{":
            i = _parse_bucket(w, lines, i, shadow_decls)
        else:
            raise CompileError(lineno, f"unrecognized: {' '.join(t)}")

    # shadow-id declarations: pin the registry so populate_classes
    # reuses the ids the text map promised
    for bname, sid, cname in shadow_decls:
        bid = w.get_item_id(bname)
        cid = w.get_or_create_class_id(cname)
        w._shadow_id_registry[(bid, cid)] = sid
    if w.class_map:
        w.populate_classes()
    _resolve_takes(w)
    return w


def _parse_bucket(w: CrushWrapper, lines, i, shadow_decls) -> int:
    lineno, t = lines[i]
    type_name, name = t[0], t[1]
    try:
        type_id = w.get_type_id(type_name)
    except KeyError:
        raise CompileError(lineno, f"unknown type {type_name}")
    bid = 0
    alg = C.CRUSH_BUCKET_STRAW2
    hash_ = C.CRUSH_HASH_RJENKINS1
    items: List[Tuple[str, int]] = []
    i += 1
    while i < len(lines):
        lineno, t = lines[i]
        if t[0] == "}":
            i += 1
            break
        if t[0] == "id":
            if len(t) >= 4 and t[2] == "class":
                shadow_decls.append((name, int(t[1]), t[3]))
            else:
                bid = int(t[1])
        elif t[0] == "alg":
            if t[1] not in C.ALG_IDS:
                raise CompileError(lineno, f"unknown alg {t[1]}")
            alg = C.ALG_IDS[t[1]]
        elif t[0] == "hash":
            hash_ = int(t[1])
        elif t[0] == "item":
            # item <name> weight <w> [pos <n>]
            iw = 0x10000
            if "weight" in t:
                iw = _w16(t[t.index("weight") + 1])
            items.append((t[1], iw))
        elif t[0] == "weight":
            pass  # informational; recomputed from items
        else:
            raise CompileError(lineno, f"unrecognized in bucket: {t[0]}")
        i += 1
    else:
        raise CompileError(lineno, f"bucket {name}: missing }}")

    ids: List[int] = []
    weights: List[int] = []
    for iname, iw in items:
        try:
            ids.append(w.get_item_id(iname))
        except KeyError:
            raise CompileError(lineno, f"unknown item {iname}")
        weights.append(iw)
    if alg == C.CRUSH_BUCKET_UNIFORM:
        if len(set(weights)) > 1:
            raise CompileError(
                lineno, f"bucket {name}: uniform buckets require "
                        f"equal item weights")
        b = make_uniform_bucket(ids, weights[0] if weights else 0x10000,
                                type_id, bid, hash_)
    elif alg == C.CRUSH_BUCKET_LIST:
        b = make_list_bucket(ids, weights, type_id, bid, hash_)
    elif alg == C.CRUSH_BUCKET_TREE:
        b = make_tree_bucket(ids, weights, type_id, bid, hash_)
    else:
        b = make_straw2_bucket(ids, weights, type_id, bid, hash_)
        b.alg = alg  # straw or straw2
        if alg == C.CRUSH_BUCKET_STRAW:
            b.straws = calc_straw(weights)
    got = w.crush.add_bucket(b)
    w.set_item_name(got, name)
    return i


def _parse_rule(w: CrushWrapper, lines, i) -> int:
    lineno, t = lines[i]
    name = t[1] if len(t) >= 3 else f"rule{len(w.crush.rules)}"
    ruleno = -1
    rtype = 1
    steps: List = []  # RuleStep or ("take", name, class)
    i += 1
    while i < len(lines):
        lineno, t = lines[i]
        if t[0] == "}":
            i += 1
            break
        if t[0] in ("id", "ruleset"):
            ruleno = int(t[1])
        elif t[0] == "type":
            rtype = {"replicated": 1, "erasure": 3}.get(
                t[1], None)
            if rtype is None:
                rtype = int(t[1])
        elif t[0] in ("min_size", "max_size"):
            pass  # deprecated, accepted
        elif t[0] == "step":
            steps.append(_parse_step(lineno, t[1:], w))
        else:
            raise CompileError(lineno, f"unrecognized in rule: {t[0]}")
        i += 1
    else:
        raise CompileError(lineno, f"rule {name}: missing }}")
    rule = Rule(steps=[], type=rtype)
    rule.steps = steps  # may contain symbolic takes; resolved later
    rid = w.crush.add_rule(rule, ruleno)
    w.rule_name_map[rid] = name
    return i


def _parse_step(lineno, t, w):
    op = t[0]
    if op == "noop":
        return RuleStep(C.CRUSH_RULE_NOOP, 0, 0)
    if op == "emit":
        return RuleStep(C.CRUSH_RULE_EMIT, 0, 0)
    if op == "take":
        cls = t[t.index("class") + 1] if "class" in t else ""
        return ("take", t[1], cls)
    if op in _SET_STEPS:
        return RuleStep(_SET_STEPS[op], int(t[1]), 0)
    if op in ("choose", "chooseleaf"):
        key = (op, t[1])
        if key not in _CHOOSE_OPS:
            raise CompileError(lineno, f"step {op} {t[1]}?")
        n = int(t[2])
        if t[3] != "type":
            raise CompileError(lineno, f"step {op}: expected 'type'")
        try:
            type_id = w.get_type_id(t[4])
        except KeyError:
            raise CompileError(lineno, f"unknown type {t[4]}")
        return RuleStep(_CHOOSE_OPS[key], n, type_id)
    raise CompileError(lineno, f"unknown step {op}")


def _resolve_takes(w: CrushWrapper) -> None:
    """Resolve symbolic ('take', name, class) steps to item ids (after
    all buckets exist and shadows are built)."""
    for rule in w.crush.rules.values():
        resolved = []
        for s in rule.steps:
            if isinstance(s, tuple):
                _tag, name, cls = s
                bid = w.get_item_id(name)
                if cls:
                    cid = w.get_or_create_class_id(cls)
                    w.populate_classes()
                    shadow = w.class_bucket.get((bid, cid))
                    if shadow is None:
                        raise CompileError(
                            0, f"take {name} class {cls}: no such "
                               f"shadow tree")
                    bid = shadow
                resolved.append(RuleStep(C.CRUSH_RULE_TAKE, bid, 0))
            else:
                resolved.append(s)
        rule.steps = resolved


# ---------------------------------------------------------------------------
# decompile: CrushWrapper -> text
# ---------------------------------------------------------------------------

def decompile_crushmap(w: CrushWrapper) -> str:
    out: List[str] = ["# begin crush map"]
    tn = w.crush.tunables
    for key in _TUNABLES.values():
        out.append(f"tunable {key} {getattr(tn, key)}")

    out.append("\n# devices")
    for dev in range(w.crush.max_devices):
        name = w.name_map.get(dev)
        if name is None:
            continue
        cls = w.get_item_class(dev)
        out.append(f"device {dev} {name}"
                   + (f" class {cls}" if cls else ""))

    out.append("\n# types")
    for t in sorted(w.type_map):
        out.append(f"type {t} {w.type_map[t]}")

    out.append("\n# buckets")
    # reverse id order, skipping shadow trees (they are emitted as
    # `id ... class ...` lines inside their original bucket)
    shadow_by_orig: Dict[int, List[Tuple[int, str]]] = {}
    for (oid, cid), sid in sorted(w.class_bucket.items()):
        shadow_by_orig.setdefault(oid, []).append(
            (sid, w.class_name[cid]))
    for idx in sorted(w.crush.buckets):
        b = w.crush.buckets[idx]
        if b.id in w._shadow_ids:
            continue
        out.append(f"{w.get_type_name(b.type)} "
                   f"{w.get_item_name(b.id)} {{")
        out.append(f"\tid {b.id}")
        for sid, cname in shadow_by_orig.get(b.id, []):
            out.append(f"\tid {sid} class {cname}")
        out.append(f"\t# weight {_wf(b.weight)}")
        out.append(f"\talg {C.ALG_NAMES[b.alg]}")
        out.append(f"\thash {b.hash}\t# rjenkins1")
        for pos, item in enumerate(b.items):
            out.append(f"\titem {w.get_item_name(item)} "
                       f"weight {_wf(b.item_weight_at(pos))}")
        out.append("}")

    out.append("\n# rules")
    inv_shadow = {sid: (oid, cid)
                  for (oid, cid), sid in w.class_bucket.items()}
    for rno in sorted(w.crush.rules):
        rule = w.crush.rules[rno]
        out.append(f"rule {w.get_rule_name(rno)} {{")
        out.append(f"\tid {rno}")
        tname = {1: "replicated", 3: "erasure"}.get(rule.type,
                                                    str(rule.type))
        out.append(f"\ttype {tname}")
        for s in rule.steps:
            if s.op == C.CRUSH_RULE_NOOP:
                out.append("\tstep noop")
            elif s.op == C.CRUSH_RULE_TAKE:
                tgt = s.arg1
                if tgt in inv_shadow:
                    oid, cid = inv_shadow[tgt]
                    out.append(f"\tstep take {w.get_item_name(oid)} "
                               f"class {w.class_name[cid]}")
                else:
                    out.append(f"\tstep take {w.get_item_name(tgt)}")
            elif s.op == C.CRUSH_RULE_EMIT:
                out.append("\tstep emit")
            elif s.op in _SET_STEP_NAMES:
                out.append(f"\tstep {_SET_STEP_NAMES[s.op]} {s.arg1}")
            elif s.op in (C.CRUSH_RULE_CHOOSE_FIRSTN,
                          C.CRUSH_RULE_CHOOSE_INDEP,
                          C.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                          C.CRUSH_RULE_CHOOSELEAF_INDEP):
                kind = "choose" if s.op in (
                    C.CRUSH_RULE_CHOOSE_FIRSTN,
                    C.CRUSH_RULE_CHOOSE_INDEP) else "chooseleaf"
                mode = "firstn" if s.op in (
                    C.CRUSH_RULE_CHOOSE_FIRSTN,
                    C.CRUSH_RULE_CHOOSELEAF_FIRSTN) else "indep"
                out.append(f"\tstep {kind} {mode} {s.arg1} type "
                           f"{w.get_type_name(s.arg2)}")
            else:
                raise ValueError(f"cannot decompile step op {s.op}")
        out.append("}")

    out.append("\n# end crush map")
    return "\n".join(out) + "\n"
