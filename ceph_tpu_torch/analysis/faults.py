"""Fault-injection plane — the named-failpoint registry.

The port's copy of ``ceph_tpu/analysis/faults.py``: the same failpoint
names, spec syntax and arm semantics, with its own process-global
state.  The port's stores consult this module, never ``ceph_tpu``'s, so
a test arms and disarms the port's failpoints here.

Every injectable fault is a named failpoint; a hot path asks
``fires(name)`` and gets ``False`` after one module-global bool test
(``_ACTIVE``) when nothing is armed.

Arming — three equivalent doors, all speaking one spec syntax:

  * config: ``conf.set("fault_inject_spec", SPEC)`` on a Config that
    ``install`` bound (every port ``Context`` does);
  * admin socket: ``fault set|list|clear|seed`` on any port daemon
    (``AdminSocket.request(path, "fault", mode="set", spec=SPEC)``),
    registered by ``wire``;
  * in-process: ``apply_spec(SPEC)`` / ``arm(...)``.

Spec syntax (semicolon-separated failpoints)::

    name=arm[,extra:value...][;name=arm...]
    arm   := p:<float>   fire with probability p per check
           | count:<n>   fire the next n checks, then disarm
           | oneshot     fire exactly once
           | off         explicitly disarmed
    extra := delay:<seconds>
           | who:<name-prefix>   only fire for daemons whose name
                                 starts with the prefix

Probability arms draw from one module RNG; ``seed(n)`` makes a run
reproducible.  Every firing books a counter in the process-global perf
collection (logger ``faults``).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from .lockdep import make_lock

# every failpoint a hook site checks, with the layer it cuts (the
# spec parser's typo guard)
FAILPOINTS: Dict[str, str] = {
    # messenger wire faults (ms inject socket failures role)
    "msgr.drop_frame": "outbound frame not sent; connection killed "
                       "(TCP would never silently lose it)",
    "msgr.delay_frame": "outbound frame delayed `delay` seconds",
    "msgr.dup_frame": "outbound frame sent twice",
    "msgr.corrupt_frame": "one payload byte flipped on the wire",
    "msgr.close_mid_frame": "socket hard-closed after a partial "
                            "frame write",
    "msgr.stall_dispatch": "control-lane dispatch callback delayed "
                           "`delay` seconds inside its non-blocking "
                           "scope (asyncheck loop-stall drill)",
    # objectstore / WAL faults (filestore_debug_inject_read_err role)
    "os.read_eio": "objectstore read raises EIO",
    "os.fsync_eio": "WAL group-commit fsync raises EIO (store "
                    "poisons itself, as on a real bad sector)",
    "os.torn_append": "WAL append writes a truncated record then "
                      "fails (torn-write crash image)",
    # osd write-pipeline kill points / delays
    "osd.kill_before_commit": "shard write dropped before the WAL "
                              "commit (daemon died early: no data, "
                              "no ack)",
    "osd.kill_after_commit": "shard write dropped after the WAL "
                             "commit (daemon died late: data landed, "
                             "ack lost)",
    "osd.slow_op": "shard write delayed `delay` seconds",
    "osd.shard_read_eio": "shard read returns EIO; EC reads must "
                          "decode from survivors + mark for repair",
    # store data-corruption faults (silent bit rot on media)
    "store.bit_rot": "one byte flipped in a store shard read; crc "
                     "verification must catch it, degrade the read, "
                     "and mark the shard for repair",
    # monitor faults
    "mon.drop_pg_stats": "monitor drops an incoming pg_stats beacon",
    "mon.isolate_rank": "monitor drops all mon-to-mon traffic "
                        "(rank isolation / partition)",
    # network partitions (directional, daemon-pair scoped): the
    # receiving messenger swallows any typed frame whose sender->
    # receiver pair matches an armed `pairs` extra — no handler, no
    # reply, no ack, exactly the silence a cut link leaves.  The
    # extra is `pairs:<src>><dst>|<src>><dst>...` with name-prefix
    # matching per side and `*` (or empty) as a wildcard; listing
    # only one direction gives an ASYMMETRIC (one-way) cut, e.g.
    # `net.partition=p:1.0,pairs:osd.3>mon|mon>osd.3` (symmetric
    # mon<->osd.3 split) vs `...,pairs:mon.0>mon.2|mon.1>mon.2`
    # (one-way: rank 2 deaf to its peers, its own sends still land)
    "net.partition": "directional traffic drop between scoped "
                     "daemon pairs (pairs:<src>><dst>|..., prefix "
                     "match, '*' wildcard; asymmetric supported)",
    # manager faults
    "mgr.balancer.stale_map": "balancer sweep evaluated a stale "
                              "OSDMap; the round's proposals are "
                              "discarded",
}

_VALID_ARMS = ("p", "count", "oneshot", "off")


class InjectedKill(Exception):
    """A fired kill point: the handler "died" mid-op.  The messenger
    treats it specially — NO reply, NO ack, as if the daemon went
    down holding the op — so the sender sees a timeout/retry, never
    an error reply a live daemon would have framed."""


@dataclass
class FailPoint:
    """One armed failpoint: arm semantics + extras + firing count."""

    name: str
    mode: str                      # "p" | "count" | "oneshot"
    p: float = 0.0
    remaining: int = 0
    extras: Dict[str, str] = field(default_factory=dict)
    fired: int = 0

    def describe(self) -> Dict:
        d: Dict = {"mode": self.mode, "fired": self.fired}
        if self.mode == "p":
            d["p"] = self.p
        if self.mode in ("count", "oneshot"):
            d["remaining"] = self.remaining
        if self.extras:
            d["extras"] = dict(self.extras)
        return d


# -- module state (process-global: the messenger has no Context) ------
_lock = make_lock("faults::plane")
_armed: Dict[str, FailPoint] = {}
_fired_total: Dict[str, int] = {}
_rng = random.Random()
# the zero-overhead switch: every hook site's fires() returns False
# after testing this one bool when nothing is armed
_ACTIVE = False

_pc = None  # lazy: the process-global "faults" PerfCounters


def _counters():
    global _pc
    if _pc is None:
        from ..common.perf_counters import collection

        pc = collection().create("faults")
        for name in FAILPOINTS:
            pc.add_u64_counter(name)
        _pc = pc
    return _pc


def seed(n: int) -> None:
    """Re-seed the probability arms — a chaos run's reproducibility
    anchor."""
    global _rng
    _rng = random.Random(n)


# -- arming -----------------------------------------------------------
def arm(name: str, mode: str = "oneshot", p: float = 0.0,
        count: int = 1, **extras: str) -> None:
    if name not in FAILPOINTS:
        raise ValueError(f"unknown failpoint {name!r} "
                         f"(have: {sorted(FAILPOINTS)})")
    if mode not in _VALID_ARMS:
        raise ValueError(f"unknown arm mode {mode!r}")
    global _ACTIVE
    with _lock:
        if mode == "off":
            _armed.pop(name, None)
        else:
            _armed[name] = FailPoint(
                name, mode, p=p,
                remaining=(1 if mode == "oneshot" else count),
                extras={k: str(v) for k, v in extras.items()})
        _ACTIVE = bool(_armed)


def clear(name: Optional[str] = None) -> None:
    """Disarm one failpoint, or all of them (name=None).  Firing
    totals survive — a soak reads them after clearing."""
    global _ACTIVE
    with _lock:
        if name is None:
            _armed.clear()
        else:
            _armed.pop(name, None)
        _ACTIVE = bool(_armed)


def reset() -> None:
    """Full reset: disarm everything AND zero the firing totals
    (test isolation)."""
    global _ACTIVE
    with _lock:
        _armed.clear()
        _fired_total.clear()
        _ACTIVE = False


def parse_spec(spec: str) -> Dict[str, FailPoint]:
    """Parse a spec string into failpoints (without arming) — raises
    ValueError on unknown names/arms so a typo'd spec fails loudly
    instead of silently injecting nothing."""
    out: Dict[str, FailPoint] = {}
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        name, sep, rest = part.partition("=")
        name = name.strip()
        if not sep or name not in FAILPOINTS:
            raise ValueError(f"bad failpoint {part!r} "
                             f"(have: {sorted(FAILPOINTS)})")
        tokens = [t.strip() for t in rest.split(",") if t.strip()]
        if not tokens:
            raise ValueError(f"failpoint {name!r} has no arm")
        arm_tok, extras = tokens[0], tokens[1:]
        kind, _, val = arm_tok.partition(":")
        if kind not in _VALID_ARMS:
            raise ValueError(f"unknown arm {arm_tok!r} for {name!r}")
        fp = FailPoint(name, kind)
        if kind == "p":
            fp.p = float(val)
        elif kind == "count":
            fp.remaining = int(val)
        elif kind == "oneshot":
            fp.remaining = 1
        for tok in extras:
            k, sep2, v = tok.partition(":")
            if not sep2:
                raise ValueError(f"bad extra {tok!r} for {name!r}")
            fp.extras[k.strip()] = v.strip()
        out[name] = fp
    return out


def apply_spec(spec: str) -> Dict[str, Dict]:
    """Replace the armed set with what a spec string describes (the
    ``fault_inject_spec`` semantics: the option value IS the armed
    set; an empty string disarms everything)."""
    parsed = parse_spec(spec)
    global _ACTIVE
    with _lock:
        _armed.clear()
        for name, fp in parsed.items():
            if fp.mode != "off":
                _armed[name] = fp
        _ACTIVE = bool(_armed)
    return list_faults()


def list_faults() -> Dict[str, Dict]:
    """The ``fault list`` payload: armed arms + lifetime totals."""
    with _lock:
        return {"armed": {n: fp.describe()
                          for n, fp in _armed.items()},
                "fired": dict(_fired_total)}


def snapshot() -> Dict[str, int]:
    """Lifetime firing totals (what a chaos run records)."""
    with _lock:
        return dict(_fired_total)


# -- the hook-site API ------------------------------------------------
def fires(name: str, who: Optional[str] = None) -> bool:
    """Should the failpoint ``name`` fire for daemon ``who``?  The
    hot-path door: one bool test when nothing is armed anywhere."""
    global _ACTIVE
    if not _ACTIVE:
        return False
    with _lock:
        fp = _armed.get(name)
        if fp is None:
            return False
        target = fp.extras.get("who")
        if target and (who is None or not who.startswith(target)):
            return False
        if fp.mode == "p":
            if _rng.random() >= fp.p:
                return False
        else:  # count / oneshot
            if fp.remaining <= 0:
                return False
            fp.remaining -= 1
            if fp.remaining <= 0:
                del _armed[name]
                _ACTIVE = bool(_armed)
        fp.fired += 1
        _fired_total[name] = _fired_total.get(name, 0) + 1
    _counters().inc(name)
    return True


def _side_match(name: str, pat: str) -> bool:
    return pat in ("", "*") or name.startswith(pat)


def partitioned(src: Optional[str], dst: Optional[str]) -> bool:
    """Directional ``net.partition`` check: should traffic from
    daemon ``src`` to daemon ``dst`` be dropped?  Consulted by the
    receiving messenger per typed frame (the sender's name rides
    every call/send frame as ``frm``).  One bool test when nothing
    is armed, like :func:`fires`."""
    global _ACTIVE
    if not _ACTIVE or not src or not dst:
        return False
    with _lock:
        fp = _armed.get("net.partition")
        if fp is None:
            return False
        for pair in fp.extras.get("pairs", "").split("|"):
            s, sep, d = pair.partition(">")
            if sep and _side_match(src, s.strip()) and \
                    _side_match(dst, d.strip()):
                break
        else:
            return False
        if fp.mode == "p":
            if _rng.random() >= fp.p:
                return False
        else:  # count / oneshot
            if fp.remaining <= 0:
                return False
            fp.remaining -= 1
            if fp.remaining <= 0:
                del _armed["net.partition"]
                _ACTIVE = bool(_armed)
        fp.fired += 1
        _fired_total["net.partition"] = \
            _fired_total.get("net.partition", 0) + 1
    _counters().inc("net.partition")
    return True


def flip_byte(data: bytes) -> bytes:
    """Seeded single-byte corruption for the ``store.bit_rot`` class
    of faults: XOR one RNG-chosen byte with 0xFF.  The draw uses the
    module RNG under the plane lock so a seeded run flips the same
    offset every time."""
    if not data:
        return data
    with _lock:
        i = _rng.randrange(len(data))
    out = bytearray(data)
    out[i] ^= 0xFF
    return bytes(out)


def extra(name: str, key: str, default: float) -> float:
    """An armed failpoint's numeric extra (e.g. the injected delay);
    ``sleep_if`` reads it BEFORE firing, while the arm still exists."""
    with _lock:
        fp = _armed.get(name)
        if fp is None or key not in fp.extras:
            return default
        return float(fp.extras[key])


def sleep_if(name: str, who: Optional[str] = None,
             default_delay: float = 0.05) -> bool:
    """Fire-and-delay helper for the slow-op class of faults; the
    sleep happens HERE so hook sites never sleep under their own
    locks."""
    if not _ACTIVE:
        return False
    delay = extra(name, "delay", default_delay)
    if not fires(name, who):
        return False
    time.sleep(delay)
    return True


# -- wiring -----------------------------------------------------------
_installed_configs: set = set()


def install(config) -> None:
    """Bind a Config to the plane: apply the current
    ``fault_inject_spec`` and track it live (observer).  Idempotent
    per Config — daemons that share one Config need one observer."""
    if "fault_inject_spec" not in config.schema:
        return
    if id(config) in _installed_configs:
        return
    _installed_configs.add(id(config))

    def _cb(_name, value):
        apply_spec(value or "")

    config.add_observer("fault_inject_spec", _cb)
    current = config["fault_inject_spec"]
    if current:
        apply_spec(current)


def wire(sock) -> None:
    """Register the ``fault`` admin-socket command:
    ``fault mode=set spec=...`` | ``fault mode=list`` |
    ``fault mode=clear [name=...]`` | ``fault mode=seed value=<n>``."""
    def _h(a: Dict) -> Dict:
        mode = a.get("mode", "list")
        if mode == "set":
            return apply_spec(a.get("spec", ""))
        if mode == "clear":
            clear(a.get("name"))
            return list_faults()
        if mode == "seed":
            seed(int(a["value"]))
            return {"seeded": int(a["value"])}
        return list_faults()

    sock.register("fault", _h,
                  "fault injection: mode=set spec=<spec> | "
                  "mode=list | mode=clear [name=] | mode=seed "
                  "value=<n>")
