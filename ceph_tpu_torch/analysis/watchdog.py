"""Stall/deadlock watchdog — flag wedged locks and handlers, dump
every thread's stack (the port's copy of
``ceph_tpu/analysis/watchdog.py``: it scans the port's lockdep table
and its own section registry).

The heartbeat-timeout role of the reference's internal watchdogs
(OSD op thread timeouts, ``dump_historic_ops`` for the slow tail,
lockdep backtraces for the wedged case): a daemon thread scans

- the lockdep held-lock table (analysis/lockdep.py): any lock held
  beyond the threshold, and
- the SECTION registry: any instrumented code region (a messenger
  handler, a scheduler job) running beyond the threshold,

and on the first offence of each offender writes a full all-thread
stack dump to stderr — the information a wedged-cluster post-mortem
actually needs, available the moment the wedge forms instead of after
a kill -9.  ``dump_blocked()`` serves the same snapshot on demand and
is wired into every daemon's admin socket as the ``dump_blocked``
command (common/admin_socket.py), next to ``dump_historic_ops``.

Stack capture uses ``sys._current_frames`` — read-only, no tracing
hooks, safe to run against live threads.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

from . import lockdep

# raw lock: the registry must never feed the graph it helps debug
_sections_lock = threading.Lock()  # watchdog's own registry lock
_sections: Dict[int, Dict] = {}
_tokens = itertools.count()


@contextlib.contextmanager
def section(name: str):
    """Mark a code region the watchdog should time, e.g. a messenger
    handler execution (``with watchdog.section(f"handler:{type_}")``)."""
    tok = next(_tokens)
    info = {"name": name,
            "thread": threading.current_thread().name,
            "since": time.monotonic()}
    with _sections_lock:
        _sections[tok] = info
    try:
        yield
    finally:
        with _sections_lock:
            _sections.pop(tok, None)


def thread_stacks() -> Dict[str, str]:
    """Formatted stack per live thread, keyed ``name(ident)``."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, '?')}({tid})"
        out[label] = "".join(traceback.format_stack(frame))
    return out


def dump_blocked(threshold: float = 0.0,
                 with_stacks: bool = True) -> Dict:
    """The ``dump_blocked`` admin-socket payload: locks held and
    sections running at least ``threshold`` seconds, plus (optionally)
    every thread's current stack."""
    now = time.monotonic()
    locks = []
    for info in lockdep.held_snapshot():
        age = now - info["since"]
        if age >= threshold:
            locks.append({"name": info["name"],
                          "thread": info["thread"],
                          "depth": info["depth"],
                          "held_secs": round(age, 3)})
    sections = []
    with _sections_lock:
        for info in _sections.values():
            age = now - info["since"]
            if age >= threshold:
                sections.append({"name": info["name"],
                                 "thread": info["thread"],
                                 "running_secs": round(age, 3)})
    out = {"threshold": threshold, "blocked_locks": locks,
           "stalled_sections": sections}
    if with_stacks:
        out["threads"] = thread_stacks()
    return out


class Watchdog:
    """Scan loop over the lock + section registries.

    Each offender (a specific hold/run instance, keyed by its start
    stamp) is reported once, to ``reports`` and stderr with a full
    thread dump; a lock re-acquired later starts a fresh instance."""

    def __init__(self, threshold: float = 30.0,
                 interval: Optional[float] = None, stream=None):
        self.threshold = threshold
        self.interval = interval if interval is not None \
            else max(0.25, threshold / 4.0)
        self.stream = stream if stream is not None else sys.stderr
        self.reports: List[Dict] = []
        self._seen: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="conc-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll()
            except Exception as e:  # the scanner must never die silently
                self.stream.write(f"watchdog poll failed: {e!r}\n")

    def poll(self, now: Optional[float] = None) -> List[Dict]:
        """One scan; returns the NEW reports it generated (tests drive
        this directly for determinism)."""
        now = time.monotonic() if now is None else now
        fresh: List[Dict] = []
        for info in lockdep.held_snapshot():
            age = now - info["since"]
            if age >= self.threshold:
                key = ("lock", info["name"], info["thread"],
                       info["since"])
                if key not in self._seen:
                    self._seen.add(key)
                    fresh.append({"kind": "lock", "name": info["name"],
                                  "thread": info["thread"],
                                  "age": round(age, 3)})
        with _sections_lock:
            stalled = [(tok, dict(info))
                       for tok, info in _sections.items()
                       if now - info["since"] >= self.threshold]
        for tok, info in stalled:
            key = ("section", tok)
            if key not in self._seen:
                self._seen.add(key)
                fresh.append({"kind": "section", "name": info["name"],
                              "thread": info["thread"],
                              "age": round(now - info["since"], 3)})
        if fresh:
            self.reports.extend(fresh)
            self._emit(fresh)
        return fresh

    def _emit(self, fresh: List[Dict]) -> None:
        w = self.stream.write
        w(f"\n=== watchdog: {len(fresh)} stalled "
          f"(threshold {self.threshold}s) ===\n")
        for r in fresh:
            w(f"  {r['kind']} {r['name']!r} on {r['thread']} "
              f"for {r['age']}s\n")
        for label, stack in thread_stacks().items():
            w(f"--- thread {label} ---\n{stack}")
        w("=== end watchdog report ===\n")


_global: Optional[Watchdog] = None


def start_global(threshold: float = 30.0,
                 interval: Optional[float] = None) -> Watchdog:
    """Process-wide singleton (idempotent; re-thresholds on repeat)."""
    global _global
    if _global is None:
        _global = Watchdog(threshold, interval).start()
    else:
        _global.threshold = threshold
        if interval is not None:
            _global.interval = interval
    return _global


def global_watchdog() -> Optional[Watchdog]:
    return _global
