"""Asyncheck — `@nonblocking` contracts + runtime loop-stall enforcement
(the port's copy of ``ceph_tpu/analysis/asyncheck.py``, with its own
registries and enforcer).

The blocking-safety half of the sanitizer plane: it proves *at
runtime* which declared non-blocking scopes overran a wallclock budget
and captures both-end stack witnesses when one does — an epoll reactor
dies of a thousand hidden ``time.sleep``/``fsync``/``Event.wait``
calls, and this plane names each one before it ships.

Usage::

    from ..analysis.asyncheck import nonblocking, scope

    @nonblocking
    def _dispatch(self, conn, msg, ...): ...     # contract + timing

    with asyncheck.scope(f"{self.name}:{type_}"):
        reply = handler(msg)                      # explicit scope

``@nonblocking`` declares a function as a non-blocking context: the
static analyzer roots its call-graph walk there, and (when the plane
is enabled) the function body runs inside a timed scope.  ``scope()``
is the explicit form for dispatch/reactor callback sites where the
callback itself is dynamic (the messenger's handler table).

Every live scope carries a wallclock budget — the module default comes
from the ``asyncheck_loop_budget_ms`` option via ``configure()``, a
per-scope override rides the call.  Overruns are detected at BOTH
ends:

  * exit-side: scope exit past budget records an overrun with the
    entry stack and the exit stack (who declared the scope, who it
    returned through);
  * in-flight: an ``Enforcer`` poll (or a live ``dump()``) finds a
    scope still open past budget and captures the thread's CURRENT
    stack via ``sys._current_frames()`` — the mid-stall witness that
    names the blocking call while it is still blocking, the same
    two-witness shape lockdep and racecheck reports use.

Enablement mirrors racecheck: ``CEPH_TPU_ASYNCHECK=1`` in the
environment (set before import — the decorator is identity when the
plane is disabled at decoration time, zero production overhead) or
``enable(True)`` at runtime for explicit ``scope()`` sites.  The test
suite does NOT enable the plane suite-wide: budgets are wallclock and a
loaded host time-slices freely — the runtime tests drive
``enable(True)`` + ``Enforcer.poll()`` deterministically instead.

Overruns are recorded, not raised (a dispatch thread must not crash
mid-frame); the ``dump_asyncheck`` admin command, the
``analysis.block.*`` counters surface them in a live cluster.
"""

from __future__ import annotations

import functools
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

ENV = "CEPH_TPU_ASYNCHECK"

DEFAULT_BUDGET_MS = 50.0

_forced: Optional[bool] = None
_budget_ms = DEFAULT_BUDGET_MS

# registry bookkeeping (decoration-time; read by dump()/counters)
_contracts: List[str] = []

_violations: List[Dict] = []
_vlock = threading.Lock()

# live scopes: token -> _Scope (token is the _Scope itself; a dict
# keyed by identity keeps enter/exit O(1) under one small lock)
_scopes: Dict[int, "_Scope"] = {}
_slock = threading.Lock()

_MAX_FRAMES = 12


# read once at import: an entry point sets the env before importing
# the package (the same switch as ``ceph_tpu``'s); enable() overrides
# at runtime
_env_on = os.environ.get(ENV, "") not in ("", "0")


def enabled() -> bool:
    if _forced is not None:
        return _forced
    return _env_on


def enable(on: bool = True) -> None:
    """Force the plane on/off at runtime (tests).  Note decoration
    happens at import: enabling here activates explicit ``scope()``
    sites immediately but only ``@nonblocking`` functions that were
    decorated while the plane was enabled."""
    global _forced
    _forced = on


def configure(budget_ms: float) -> None:
    """Set the module-default scope budget (wired from the
    ``asyncheck_loop_budget_ms`` option by ``Context``)."""
    global _budget_ms
    _budget_ms = float(budget_ms)


def budget_ms() -> float:
    return _budget_ms


def _fast_stack(skip: int = 1) -> Tuple[tuple, ...]:
    """A cheap stack witness: raw (file, line, func) frames walked
    via _getframe (traceback.extract_stack is ~10x the cost and this
    runs on every scope entry); formatting is deferred to report
    time.  Skips asyncheck's own frames."""
    out = []
    f = sys._getframe(skip)
    own = __file__
    while f is not None and len(out) < _MAX_FRAMES:
        code = f.f_code
        if code.co_filename != own:
            out.append((code.co_filename, f.f_lineno,
                        code.co_name))
        f = f.f_back
    return tuple(out)


def _frames_of(frame) -> Tuple[tuple, ...]:
    """Raw frames from a live frame object (the mid-stall witness
    pulled out of ``sys._current_frames()``)."""
    out = []
    f = frame
    own = __file__
    while f is not None and len(out) < _MAX_FRAMES:
        code = f.f_code
        if code.co_filename != own:
            out.append((code.co_filename, f.f_lineno,
                        code.co_name))
        f = f.f_back
    return tuple(out)


def _fmt_stack(frames: Optional[Tuple[tuple, ...]]) -> str:
    if not frames:
        return "  (no stack captured)\n"
    return "\n".join(f"  {fn}:{ln} in {fun}"
                     for fn, ln, fun in frames) + "\n"


class _Scope:
    """One live non-blocking scope on one thread."""

    __slots__ = ("name", "tid", "thread", "start", "budget_s",
                 "entry", "reported")

    def __init__(self, name: str, budget_s: float):
        self.name = name
        self.tid = threading.get_ident()
        self.thread = threading.current_thread().name
        self.start = time.monotonic()
        self.budget_s = budget_s
        self.entry = _fast_stack(3)  # caller of scope()
        self.reported = False  # one overrun record per scope instance


def _record(kind: str, sc: _Scope, elapsed_s: float,
            witness: Optional[Tuple[tuple, ...]]) -> None:
    rec = {
        "kind": kind,
        "scope": sc.name,
        "thread": sc.thread,
        "elapsed_ms": round(elapsed_s * 1000.0, 3),
        "budget_ms": round(sc.budget_s * 1000.0, 3),
        "message": (f"non-blocking scope {sc.name!r} "
                    f"{'still blocked' if kind == 'stall' else 'ran'} "
                    f"{elapsed_s * 1000.0:.1f}ms "
                    f"(budget {sc.budget_s * 1000.0:.1f}ms) "
                    f"on thread {sc.thread!r}"),
        "entry_stack": _fmt_stack(sc.entry),
        "witness_stack": _fmt_stack(witness),
    }
    with _vlock:
        _violations.append(rec)
    try:
        _block_pc().inc("overruns")
    except Exception:
        pass  # counters must never mask the violation record itself


_pc_cache = None


def _block_pc():
    """The process-global analysis.block counter family (created
    lazily: perf_counters sits above this package, so the edge back
    must not run at module import)."""
    global _pc_cache
    if _pc_cache is None:
        from ..common.perf_counters import collection

        pc = collection().create("analysis.block")
        pc.add_u64_counter("overruns")
        pc.add_u64("contracts")
        pc.add_u64("live_scopes")
        _pc_cache = pc
    return _pc_cache


def _sync_gauges() -> None:
    if not enabled():
        return
    try:
        pc = _block_pc()
    except Exception:
        return
    pc.set("contracts", len(_contracts))
    with _slock:
        pc.set("live_scopes", len(_scopes))


# -- the contract surface ---------------------------------------------

def nonblocking(fn):
    """Declare ``fn`` a non-blocking context.

    At runtime (plane enabled at decoration time): the body runs
    inside a timed ``scope()`` carrying the module budget; identity
    function otherwise — zero production overhead.
    """
    if not enabled():
        return fn
    qual = getattr(fn, "__qualname__", getattr(fn, "__name__", "?"))
    _contracts.append(qual)
    _sync_gauges()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with scope(qual):
            return fn(*args, **kwargs)

    return wrapper


@contextmanager
def scope(name: str, budget_ms: Optional[float] = None):
    """A timed non-blocking scope: the explicit form for dynamic
    callback sites (the messenger wraps each control-lane handler
    run).  Records an overrun on exit past budget unless an Enforcer
    poll already reported this scope mid-stall."""
    if not enabled():
        yield
        return
    sc = _Scope(name, (budget_ms if budget_ms is not None
                       else _budget_ms) / 1000.0)
    with _slock:
        _scopes[id(sc)] = sc
    try:
        yield
    finally:
        elapsed = time.monotonic() - sc.start
        with _slock:
            _scopes.pop(id(sc), None)
        if elapsed > sc.budget_s and not sc.reported:
            sc.reported = True
            _record("overrun", sc, elapsed, _fast_stack(2))


class Enforcer:
    """The in-flight stall detector: polls the live-scope table and
    captures the mid-stall stack of any scope open past its budget —
    the witness that names the blocking call WHILE it blocks, before
    the scope ever exits.  ``poll()`` is directly drivable (tests,
    ``dump()``); ``start()`` runs it on a daemon thread in a live
    cluster (the ``--loop-stall`` drill's enforcement path)."""

    def __init__(self, interval: float = 0.05):
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # last few poll failures, surfaced via dump() — the enforcer
        # outlives a bad poll but must not lose the evidence
        self.poll_errors: deque = deque(maxlen=8)

    def poll(self, now: Optional[float] = None) -> List[Dict]:
        """One scan: record (once per scope instance) every live
        scope past budget, with the owning thread's current stack.
        Returns the records made by THIS poll."""
        if not enabled():
            return []
        if now is None:
            now = time.monotonic()
        with _slock:
            over = [sc for sc in _scopes.values()
                    if not sc.reported
                    and now - sc.start > sc.budget_s]
        if not over:
            _sync_gauges()
            return []
        frames = sys._current_frames()
        made = []
        base = len(_violations)
        for sc in over:
            if sc.reported:
                continue  # racing exit already reported it
            sc.reported = True
            witness = _frames_of(frames.get(sc.tid))
            _record("stall", sc, now - sc.start, witness)
        with _vlock:
            made = list(_violations[base:])
        _sync_gauges()
        return made

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll()
            except Exception as e:
                # the enforcer must outlive a bad poll, but the
                # failure stays visible (dump() carries the tail)
                self.poll_errors.append(repr(e))

    def start(self) -> "Enforcer":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="asyncheck-enforcer")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)


_global_enforcer: Optional[Enforcer] = None
_glock = threading.Lock()


def start_global(interval: float = 0.05) -> Enforcer:
    """Process-global enforcer (Context wires this next to the
    watchdog when the plane is enabled)."""
    global _global_enforcer
    with _glock:
        if _global_enforcer is None:
            _global_enforcer = Enforcer(interval).start()
        return _global_enforcer


def stop_global() -> None:
    global _global_enforcer
    with _glock:
        e, _global_enforcer = _global_enforcer, None
    if e is not None:
        e.stop()


# -- surfaces ---------------------------------------------------------

def violations() -> List[Dict]:
    with _vlock:
        return list(_violations)


def clear_violations() -> None:
    with _vlock:
        _violations.clear()


@contextmanager
def trap():
    """Capture-and-remove overruns recorded inside the block (the
    racecheck.trap() twin — tests provoke stalls without leaking
    records into later assertions)."""
    with _vlock:
        base = len(_violations)
    got: List[Dict] = []
    try:
        yield got
    finally:
        with _vlock:
            got.extend(_violations[base:])
            del _violations[base:]


def mark() -> int:
    """Gate anchor: the overrun count before a block of work."""
    with _vlock:
        return len(_violations)


def gate_check(base: int) -> Optional[str]:
    """Format overruns recorded past ``base`` (both witnesses,
    lockdep-report style) and clear them.  Returns None when clean."""
    with _vlock:
        vs = _violations[base:]
        if not vs:
            return None
        _violations.clear()
    detail = "\n".join(
        f"- {v['message']}\n"
        f"  scope entered at:\n{v['entry_stack']}"
        f"  {'mid-stall' if v['kind'] == 'stall' else 'exit'} "
        f"witness:\n{v['witness_stack']}"
        for v in vs)
    return (f"asyncheck: {len(vs)} loop-stall overrun(s) recorded:\n"
            f"{detail}")


def live_overruns(now: Optional[float] = None) -> List[Dict]:
    """Scopes open past budget RIGHT NOW (computed on the fly — the
    admin query names a stalled victim without an enforcer thread),
    with mid-stall stacks."""
    if not enabled():
        return []
    if now is None:
        now = time.monotonic()
    with _slock:
        over = [sc for sc in _scopes.values()
                if now - sc.start > sc.budget_s]
    if not over:
        return []
    frames = sys._current_frames()
    return [{
        "scope": sc.name,
        "thread": sc.thread,
        "elapsed_ms": round((now - sc.start) * 1000.0, 3),
        "budget_ms": round(sc.budget_s * 1000.0, 3),
        "stack": _fmt_stack(_frames_of(frames.get(sc.tid))),
    } for sc in over]


def dump() -> Dict:
    """The ``dump_asyncheck`` admin-command payload."""
    with _vlock:
        vs = list(_violations)
    with _slock:
        live = len(_scopes)
    return {
        "enabled": enabled(),
        "budget_ms": _budget_ms,
        "contracts": list(_contracts),
        "live_scopes": live,
        "live_overruns": live_overruns(),
        "violations": vs,
        "num_violations": len(vs),
    }
