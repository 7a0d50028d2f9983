"""Lockdep — runtime lock-order checking (the port's copy of
``ceph_tpu/analysis/lockdep.py``).

The role of src/common/lockdep.cc (g_lockdep + mutex_debug wrappers):
every lock is REGISTERED BY NAME, each thread's current hold set feeds
a global "B was acquired while A was held" graph, and an acquisition
that would close a cycle in that graph is reported immediately — with
the stack that is taking the locks in the new order AND the stack that
recorded the conflicting order first (lockdep.cc keeps both backtraces
for exactly this report).  A potential deadlock is caught the first
time the two orders ever run, long before the interleaving that would
actually wedge two threads.

Design points, mirroring the reference:

- Nodes are lock NAMES, not instances: every ``osd::pg`` lock across
  every OSD service is one node, so an ordering discipline is enforced
  for the whole class.  Same-name nesting (two different ``osd::pg``
  instances in one thread) is intentionally NOT an edge — per-class
  nesting has its own invariants (a PG has one primary; documented at
  the construction site) that an instance-blind graph cannot judge.
- Edges record a witness stack ONCE, at first observation; steady
  state costs two dict probes per acquire.  (lockdep.cc similarly
  caches follows[][] and backtraces.)
- Violations are RECORDED, not raised: daemon threads keep running so
  a detected inversion cannot cascade into unrelated test failures;
  a test reads ``violations()`` (or ``trap()``) and the report on
  stderr carries both witness stacks.  The one exception is a blocking
  re-acquire of a non-recursive lock by its holder — that is a
  certain self-deadlock, so it raises before hanging forever.
- The currently-held table (``held_snapshot``) records holder thread
  and acquire stamp per lock, for a stall watchdog.

Enabled by env ``CEPH_TPU_LOCKDEP`` (any value but ``0``/``false``;
the same switch as ``ceph_tpu``'s, which the test suite sets) or
``enable()``; when disabled, ``make_lock``/``make_rlock`` return
raw ``threading`` primitives — zero overhead outside the harness.
This module depends only on the stdlib (it instruments everything
else, so it must sit below the whole package).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

ENV = "CEPH_TPU_LOCKDEP"

_forced: Optional[bool] = None

# raw lock on purpose: guards lockdep's own tables and must not feed
# back into the graph it maintains
_state = threading.Lock()  # lockdep's own registry lock
_follows: Dict[str, Dict[str, str]] = {}  # a -> {b: witness stack}
_reported: set = set()
_violations: List[Dict] = []
# (thread id, id(lock)) -> {"name", "thread", "since", "depth"}
_held_registry: Dict[Tuple[int, int], Dict] = {}
# same key -> the ACQUIRING thread's _tls.held list object, so a
# release on a DIFFERENT thread (a ``with lock:`` suspended inside a
# generator and closed elsewhere, a callback handed across threads)
# can scrub the acquirer's stale entry instead of leaving a phantom
# hold that poisons its next order edge and the stall watchdog
_holder_lists: Dict[Tuple[int, int], list] = {}

# per-thread frozenset of held lock NAMES, rebuilt lazily on demand
# and invalidated on every acquire/release touching that thread's
# held list (including foreign scrubs) — racecheck consults the held
# set on EVERY guarded attribute access, so this must not rebuild a
# frozenset per access
_held_names_cache: Dict[int, frozenset] = {}

_tls = threading.local()

# the env is read once: an entry point sets it before importing the
# package, and enable() overrides it at runtime
_env_on = os.environ.get(ENV, "") not in ("", "0", "false", "no")


def enabled() -> bool:
    if _forced is not None:
        return _forced
    return _env_on


def enable(on: bool = True) -> None:
    """Force lockdep on/off for the process (overrides the env)."""
    global _forced
    _forced = on


def violations() -> List[Dict]:
    with _state:
        return list(_violations)


def clear_violations() -> None:
    with _state:
        del _violations[:]
        _reported.clear()


def forget(prefix: str) -> None:
    """Drop every graph node whose name starts with ``prefix`` — test
    hook so deliberately-inverted throwaway locks cannot poison the
    order graph for later acquisitions of reused names."""
    with _state:
        for a in [a for a in _follows if a.startswith(prefix)]:
            del _follows[a]
        for a in _follows:
            for b in [b for b in _follows[a] if b.startswith(prefix)]:
                del _follows[a][b]


class trap:
    """Context manager capturing violations raised inside it (and
    removing them from the global record) — for tests that trigger an
    inversion ON PURPOSE without tripping the per-test lockdep gate.

        with lockdep.trap() as got:
            ...provoke...
        assert got
    """

    def __enter__(self) -> List[Dict]:
        with _state:
            self._base = len(_violations)
        self._got: List[Dict] = []
        return self._got

    def __exit__(self, *exc) -> None:
        with _state:
            self._got.extend(_violations[self._base:])
            del _violations[self._base:]


def held_snapshot() -> List[Dict]:
    """Currently-held locks (holder thread + age) — the watchdog's
    scan input."""
    with _state:
        return [dict(info) for info in _held_registry.values()]


def _held() -> list:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def held_names() -> frozenset:
    """Frozenset of lock names the calling thread holds, cached per
    thread between acquire/release events (racecheck's hot read)."""
    tid = threading.get_ident()
    v = _held_names_cache.get(tid)
    if v is None:
        v = frozenset(n for n, _ in _held())
        if len(_held_names_cache) > 512:  # dead-thread hygiene
            _held_names_cache.clear()
        _held_names_cache[tid] = v
    return v


def _stack() -> str:
    frames = traceback.extract_stack()
    while frames and frames[-1].filename == __file__:
        frames.pop()
    return "".join(traceback.format_list(frames[-14:]))


def _find_chain(src: str, dst: str) -> Optional[List[str]]:
    """Name path src -> ... -> dst in the follows graph, or None."""
    parent = {src: None}
    queue = [src]
    while queue:
        n = queue.pop(0)
        if n == dst:
            chain = []
            while n is not None:
                chain.append(n)
                n = parent[n]
            return chain[::-1]
        for m in _follows.get(n, ()):
            if m not in parent:
                parent[m] = n
                queue.append(m)
    return None


def _report(first: str, then: str, message: str,
            existing_stack: str, current_stack: str) -> None:
    v = {"first": first, "then": then, "message": message,
         "existing_stack": existing_stack,
         "current_stack": current_stack,
         "thread": threading.current_thread().name}
    _violations.append(v)
    import sys

    sys.stderr.write(
        f"\n=== lockdep: {message} [{v['thread']}] ===\n"
        f"--- existing order recorded at:\n{existing_stack}"
        f"--- conflicting order taken at:\n{current_stack}"
        f"=== end lockdep report ===\n")


def _check_edge(have: str, want: str) -> None:
    """Record ``want`` acquired while ``have`` is held; flag a cycle
    (an already-recorded path want -> ... -> have) with both witness
    stacks, lockdep.cc-style."""
    # steady-state fast path: a dict probe, no lock (GIL-consistent
    # reads; a rare stale miss just re-checks under the lock)
    if want in _follows.get(have, ()):
        return
    with _state:
        existing = _follows.setdefault(have, {})
        if want in existing:
            return
        chain = _find_chain(want, have)
        if chain is not None:
            key = (have, want)
            if key in _reported:
                return
            _reported.add(key)
            witness = _follows.get(chain[0], {}).get(
                chain[1], "(witness stack unavailable)") \
                if len(chain) > 1 else "(self edge)"
            _report(have, want,
                    f"lock order inversion: acquiring {want!r} while "
                    f"holding {have!r}, but the order "
                    f"{' -> '.join(chain)} was already recorded",
                    witness, _stack())
            return  # keep the graph acyclic: don't add the back edge
        existing[want] = _stack()


def _will_lock(lk, certain_block: bool) -> None:
    held = _held()
    for _name, inst in held:
        if inst is lk:
            if not lk._recursive and certain_block:
                msg = (f"recursive acquire of non-recursive lock "
                       f"{lk._name!r} (certain self-deadlock)")
                with _state:
                    _report(lk._name, lk._name, msg, "(same thread)",
                            _stack())
                raise RuntimeError(msg)
            return  # re-entry: no new ordering information
    name = lk._name
    seen = set()
    for have, _inst in held:
        if have == name or have in seen:
            continue  # same-name class nesting: documented invariant
        seen.add(have)
        _check_edge(have, name)


def _locked(lk) -> None:
    held = _held()
    held.append((lk._name, lk))
    tid = threading.get_ident()
    _held_names_cache.pop(tid, None)
    key = (tid, id(lk))
    with _state:
        info = _held_registry.get(key)
        if info is None:
            _held_registry[key] = {
                "name": lk._name,
                "thread": threading.current_thread().name,
                "since": time.monotonic(), "depth": 1}
            _holder_lists[key] = held
        else:
            info["depth"] += 1


def _released(lk) -> int:
    """Pop one hold level; returns levels popped (0 if untracked)."""
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][1] is lk:
            del held[i]
            break
    else:
        return _released_foreign(lk)
    tid = threading.get_ident()
    _held_names_cache.pop(tid, None)
    key = (tid, id(lk))
    with _state:
        info = _held_registry.get(key)
        if info is not None:
            info["depth"] -= 1
            if info["depth"] <= 0:
                del _held_registry[key]
                _holder_lists.pop(key, None)
    return 1


def _released_foreign(lk) -> int:
    """Release attributed to the wrong thread: the acquire ran
    elsewhere (a ``with lock:`` suspended in a generator and resumed
    on another thread, a registered callback).  Without this, the
    acquiring thread keeps a phantom entry in its held-set — every
    later acquisition there records a false order edge, and the
    watchdog reports a lock nobody holds.  Scrub the acquirer's
    bookkeeping by the lock's identity instead."""
    with _state:
        for key in list(_held_registry):
            if key[1] != id(lk):
                continue
            info = _held_registry[key]
            info["depth"] -= 1
            lst = _holder_lists.get(key)
            if lst is not None:
                for i in range(len(lst) - 1, -1, -1):
                    if lst[i][1] is lk:
                        del lst[i]
                        break
                _held_names_cache.pop(key[0], None)
            if info["depth"] <= 0:
                del _held_registry[key]
                _holder_lists.pop(key, None)
            return 1
    return 0


def _released_all(lk) -> int:
    """Pop every hold level of ``lk`` (Condition.wait's full release);
    returns how many were held so the restore can re-push them."""
    n = 0
    while _released(lk):
        n += 1
    return n


class DLock:
    """Drop-in ``threading.Lock`` with lockdep order tracking."""

    _recursive = False

    def __init__(self, name: str = "anon"):
        self._name = name
        self._lock = self._alloc()

    @staticmethod
    def _alloc():
        return threading.Lock()  # the wrapped primitive

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        on = enabled()
        if on:
            _will_lock(self, blocking and timeout < 0)
        got = self._lock.acquire(blocking, timeout)
        if got and on:
            _locked(self)
        return got

    def release(self) -> None:
        if enabled():
            _released(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "DLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self._name!r}>"


class DRLock(DLock):
    """Drop-in ``threading.RLock`` with lockdep order tracking.

    Implements the ``_release_save``/``_acquire_restore``/``_is_owned``
    trio so ``threading.Condition`` built over one releases the full
    recursion depth during ``wait()`` — and the held-lock bookkeeping
    follows (a waiting thread does NOT hold the lock: no false stall
    flags, no phantom order edges)."""

    _recursive = True

    @staticmethod
    def _alloc():
        return threading.RLock()  # the wrapped primitive

    def locked(self) -> bool:
        return self._lock._is_owned()

    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def _release_save(self):
        n = _released_all(self) if enabled() else 0
        return (self._lock._release_save(), n)

    def _acquire_restore(self, state) -> None:
        inner, n = state
        self._lock._acquire_restore(inner)
        if enabled():
            for _ in range(max(1, n)):
                _locked(self)


def make_lock(name: str):
    """Registry hook: a named, lockdep-tracked mutex when the checker
    is enabled, a raw ``threading.Lock`` (zero overhead) otherwise."""
    return DLock(name) if enabled() else threading.Lock()  # registry fallback


def make_rlock(name: str):
    return DRLock(name) if enabled() else threading.RLock()  # registry fallback
