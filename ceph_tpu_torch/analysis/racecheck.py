"""Racecheck — guarded-state registry and Eraser-style lockset checker.

The port's copy of ``ceph_tpu/analysis/racecheck.py``, riding the
port's ``analysis/lockdep.py`` held set (never ``ceph_tpu``'s).  Lockdep
catches lock-order cycles; this module catches lock-coverage holes: a
field written under no lock, or under the wrong one, from two threads.

Usage::

    from ..analysis.racecheck import guarded_by, shared

    @guarded_by("os::wal", "_pending", "_seq")
    class WALStore: ...

``guarded_by(lock_name, *fields)`` declares which named lock guards
which shared mutable attributes.  Instrumented reads and writes consult
lockdep's per-thread held set and refine a per-field candidate lockset
(the Eraser algorithm): it seeds from the locks held at the first
shared access and shrinks by intersection on every later one; a write
(or a read after a shared write) with an empty candidate set is a
violation, reported with both access stacks.

Every instance starts in a single-owner phase bound to the constructing
thread, unchecked; it ends at ``publish(obj)`` or at the first access
from another thread.  ``owned_by_thread=(...)`` declares writer-confined
fields.  ``shared(container, guard=..., name=...)`` wraps a bare dict or
list whose mutations must hold the named guard once a second thread
touched it.

Enabled by env ``CEPH_TPU_RACECHECK`` (read once, at import; the same
switch as ``ceph_tpu``'s) or ``enable(True)``.  When disabled at
decoration time the decorators are identity functions.  Checking is
live only when lockdep is enabled too.  Violations are recorded, not
raised: ``violations()``, ``mark()``/``gate_check()`` for a per-test
gate, ``trap()`` to capture provoked ones.
"""

from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

from . import lockdep

ENV = "CEPH_TPU_RACECHECK"

_forced: Optional[bool] = None

# registry bookkeeping (decoration-time; read by dump()/counters)
_guarded_classes: List[str] = []
_guarded_fields: int = 0
_shared_objects: int = 0

_violations: List[Dict] = []
_vlock = threading.Lock()

_STATE_KEY = "__racecheck_state__"
_MAX_FRAMES = 12


# read once at import: an entry point sets the env before importing
# the package; enable() overrides at runtime
_env_on = os.environ.get(ENV, "") not in ("", "0")


def enabled() -> bool:
    if _forced is not None:
        return _forced
    return _env_on


def enable(on: bool = True) -> None:
    """Force the plane on/off at runtime (tests).  Note decoration
    happens at import: enabling here only activates classes that were
    decorated while the plane was enabled."""
    global _forced
    _forced = on


def _active() -> bool:
    # lockset refinement is meaningless without lockdep's held set
    return enabled() and lockdep.enabled()


def _held_names() -> frozenset:
    return lockdep.held_names()  # per-thread cached


def _fast_stack() -> Tuple[tuple, ...]:
    """A cheap stack witness: raw (file, line, func) frames walked
    via _getframe (traceback.extract_stack is ~10x the cost and this
    runs on hot guarded writes); formatting is deferred to report
    time.  Skips racecheck's own frames."""
    out = []
    f = sys._getframe(1)
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
        return "  (no prior access recorded)\n"
    return "\n".join(f"  {fn}:{ln} in {fun}"
                     for fn, ln, fun in frames) + "\n"


class _Access:
    """One recorded access: the potential racing-write witness."""

    __slots__ = ("stack", "thread", "locks", "write")

    def __init__(self, stack, thread, locks, write):
        self.stack = stack
        self.thread = thread
        self.locks = locks
        self.write = write


class _FieldState:
    __slots__ = ("tid", "lockset", "written", "last", "reported",
                 "lh", "wc")

    def __init__(self, tid: int):
        self.tid: Optional[int] = tid  # exclusive owner; None = shared
        self.lockset: Optional[frozenset] = None
        self.written = False
        self.last: Optional[_Access] = None
        self.reported = False
        # hot-path bookkeeping: the held-names frozenset OBJECT seen
        # by the last shared read (lockdep's per-thread cache returns
        # the same object while that thread's held set is unchanged,
        # so an identity hit means refinement can learn nothing new)
        # and the write count driving witness-capture throttling
        self.lh: Optional[frozenset] = None
        self.wc = 0


class _RCState:
    __slots__ = ("owner", "published", "cls", "fields")

    def __init__(self, owner: int, cls: str):
        self.owner = owner
        self.published = False
        self.cls = cls
        self.fields: Dict[str, _FieldState] = {}


def _state_of(obj, cls_name: str) -> _RCState:
    d = obj.__dict__
    st = d.get(_STATE_KEY)
    if st is None:
        st = d[_STATE_KEY] = _RCState(threading.get_ident(), cls_name)
    return st


def _record(kind: str, message: str, existing: Optional[_Access],
            current_stack: Tuple[str, ...],
            current_locks: frozenset) -> None:
    rec = {
        "kind": kind,
        "message": message,
        "thread": threading.current_thread().name,
        "current_stack": _fmt_stack(current_stack),
        "current_locks": sorted(current_locks),
        "existing_stack": _fmt_stack(existing.stack
                                     if existing else None),
        "existing_thread": existing.thread if existing else "?",
        "existing_locks": sorted(existing.locks) if existing else [],
    }
    with _vlock:
        _violations.append(rec)
    try:
        _race_pc().inc("violations")
    except Exception:
        pass  # counters must never mask the violation record itself


_pc_cache = None


def _race_pc():
    """The process-global analysis.race counter family (created
    lazily: perf_counters imports lockdep from this package, so the
    edge back must not run at module import)."""
    global _pc_cache
    if _pc_cache is None:
        from ..common.perf_counters import collection

        pc = collection().create("analysis.race")
        pc.add_u64_counter("violations")
        pc.add_u64("guarded_classes")
        pc.add_u64("guarded_fields")
        pc.add_u64("shared_objects")
        _pc_cache = pc
    return _pc_cache


def _sync_gauges() -> None:
    if not enabled():
        return
    try:
        pc = _race_pc()
    except Exception:
        return
    pc.set("guarded_classes", len(_guarded_classes))
    pc.set("guarded_fields", _guarded_fields)
    pc.set("shared_objects", _shared_objects)


# -- the checker core -------------------------------------------------

def _check(obj, cls_name: str, field: str, guard: str, owned: bool,
           is_write: bool) -> None:
    if not _active():
        return
    st = _state_of(obj, cls_name)
    tid = threading.get_ident()
    if not st.published:
        if tid == st.owner:
            return  # single-owner init phase: unchecked
        st.published = True  # escaped before publish(): implicit edge
    fs = st.fields.get(field)
    if fs is None:
        fs = st.fields[field] = _FieldState(tid)
        if is_write:
            fs.written = False  # exclusive write: not yet a shared one
            fs.last = _Access(_fast_stack(),
                              threading.current_thread().name,
                              _held_names(), True)
        return
    if owned:
        if not is_write:
            return  # writer confinement only: reads may peek
        if fs.tid is None:
            fs.tid = tid  # first post-publish write binds the owner
        elif fs.tid != tid and not fs.reported:
            fs.reported = True
            cur = _fast_stack()
            _record(
                "confinement",
                f"{cls_name}.{field} is owned_by_thread (bound to "
                f"{fs.last.thread if fs.last else fs.tid}) but was "
                f"written from thread "
                f"{threading.current_thread().name!r}",
                fs.last, cur, _held_names())
        fs.last = _Access(_fast_stack(),
                          threading.current_thread().name,
                          _held_names(), True)
        return
    held = _held_names()
    if fs.tid is not None and fs.tid == tid:
        # still exclusive to one thread: no lockset discipline yet
        if is_write:
            fs.wc += 1
            if fs.wc < 64 or not fs.wc % 64:
                fs.last = _Access(_fast_stack(),
                                  threading.current_thread().name,
                                  held, True)
        return
    if not is_write and held is fs.lh:
        # identity hit: lockdep's per-thread cache hands back the
        # SAME frozenset object while this thread's held set is
        # unchanged, so this read refines exactly like the last one
        # did — nothing new to learn (the hot-loop fast path)
        return
    changed = False
    if fs.tid is not None:
        # Exclusive -> Shared: seed the candidate lockset from the
        # locks held NOW (Eraser's C(v) initialisation)
        fs.tid = None
        fs.lockset = held
        changed = True
    else:
        refined = fs.lockset & held \
            if fs.lockset is not None else held
        changed = refined != fs.lockset
        fs.lockset = refined
    if is_write:
        fs.written = True
    elif fs.lockset:
        fs.lh = held  # clean read: arm the identity fast path
    if not fs.lockset and fs.written and not fs.reported:
        fs.reported = True
        cur = _fast_stack()
        _record(
            "lockset",
            f"{cls_name}.{field} (declared guard {guard!r}): "
            f"candidate lockset is EMPTY — "
            f"{'write' if is_write else 'read-after-write'} with "
            f"locks {sorted(held) or '{}'} races a prior access",
            fs.last, cur, held)
    if is_write or changed:
        # the racing-write witness, capture-throttled past 64 writes
        # (a hot field's report may then show a slightly stale write
        # site — still a genuine racing writer); lockset shrinks are
        # monotonic so read-side captures stay rare
        fs.wc += 1
        if fs.wc < 64 or not fs.wc % 64 or changed:
            fs.last = _Access(_fast_stack(),
                              threading.current_thread().name,
                              held, is_write)


class _GuardedField:
    """Data descriptor installed per declared field: intercepts
    attribute reads/writes and feeds the lockset checker.  Values
    live in the instance ``__dict__`` under the same name (the data
    descriptor wins the lookup)."""

    __slots__ = ("field", "guard", "owned", "cls_name")

    def __init__(self, field: str, guard: str, owned: bool,
                 cls_name: str):
        self.field = field
        self.guard = guard
        self.owned = owned
        self.cls_name = cls_name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        _check(obj, self.cls_name, self.field, self.guard,
               self.owned, False)
        try:
            return obj.__dict__[self.field]
        except KeyError:
            raise AttributeError(
                f"{self.cls_name!r} object has no attribute "
                f"{self.field!r}") from None

    def __set__(self, obj, value):
        _check(obj, self.cls_name, self.field, self.guard,
               self.owned, True)
        obj.__dict__[self.field] = value

    def __delete__(self, obj):
        _check(obj, self.cls_name, self.field, self.guard,
               self.owned, True)
        try:
            del obj.__dict__[self.field]
        except KeyError:
            raise AttributeError(
                f"{self.cls_name!r} object has no attribute "
                f"{self.field!r}") from None


def guarded_by(lock_name: str, *fields: str,
               owned_by_thread: Iterable[str] = ()):
    """Class decorator: declare that ``lock_name`` guards ``fields``.

    Stackable — a class with two locks applies it twice.  Classes
    using ``__slots__`` are rejected: wrap the owning container (the
    attribute holding the slotted objects) instead, which is where
    the sharing decision is made anyway.
    """
    owned = tuple(owned_by_thread)

    def deco(cls):
        global _guarded_fields
        if not enabled():
            return cls
        if "__slots__" in cls.__dict__:
            raise TypeError(
                f"guarded_by: {cls.__name__} uses __slots__; declare "
                f"the guard on the attribute holding these objects "
                f"instead")
        for field in tuple(fields) + owned:
            setattr(cls, field,
                    _GuardedField(field, lock_name,
                                  field in owned, cls.__name__))
            _guarded_fields += 1
        _guarded_classes.append(
            f"{cls.__module__}.{cls.__name__}[{lock_name}]")
        _sync_gauges()
        return cls

    return deco


def publish(obj) -> None:
    """End the single-owner init phase NOW: later accesses — even
    from the constructing thread — run under full lockset
    discipline.  Optional: the first access from a second thread
    publishes implicitly."""
    if not _active():
        return
    st = _state_of(obj, type(obj).__name__)
    st.published = True
    st.fields.clear()


# -- shared(): guarded proxy for bare dicts/lists ---------------------

_MUTATORS_COMMON = ("__setitem__", "__delitem__", "clear", "pop")
_MUTATORS_DICT = ("setdefault", "update", "popitem")
_MUTATORS_LIST = ("append", "extend", "insert", "remove", "sort",
                  "reverse", "__iadd__")
_READERS = ("__getitem__", "__contains__", "__len__", "__iter__",
            "__bool__", "__eq__", "__ne__", "__repr__", "get", "keys",
            "values", "items", "copy", "count", "index", "__reversed__")


class _SharedProxy:
    """Mutation-checked wrapper around a dict or list: every mutating
    call must hold the declared guard once the container is shared
    between threads.  Reads stay lock-free — the GIL-atomic ``get()``
    pattern is a deliberate idiom on hot paths."""

    __slots__ = ("_target", "_guard", "_name", "_owner", "_published",
                 "_last_mut", "_reported")

    def __init__(self, target, guard: str, name: str):
        self._target = target
        self._guard = guard
        self._name = name
        self._owner = threading.get_ident()
        self._published = False
        self._last_mut: Optional[_Access] = None
        self._reported = False

    def _mutate(self) -> None:
        if not _active():
            return
        tid = threading.get_ident()
        if not self._published:
            if tid == self._owner:
                return
            self._published = True
        held = _held_names()
        if self._guard not in held and not self._reported:
            self._reported = True
            cur = _fast_stack()
            _record(
                "lockset",
                f"shared({self._name!r}): mutation without its "
                f"declared guard {self._guard!r} (held: "
                f"{sorted(held) or '{}'})",
                self._last_mut, cur, held)
        self._last_mut = _Access(_fast_stack(),
                                 threading.current_thread().name,
                                 held, True)

    def _touch(self) -> None:
        # a read from a second thread publishes (the container
        # escaped); reads themselves are never checked
        if not self._published and \
                threading.get_ident() != self._owner:
            self._published = True


def _proxy_method(mname: str, mutating: bool):
    if mutating:
        def call(self, *a, **kw):
            self._mutate()
            return getattr(self._target, mname)(*a, **kw)
    else:
        def call(self, *a, **kw):
            self._touch()
            return getattr(self._target, mname)(*a, **kw)
    call.__name__ = mname
    return call


for _m in _MUTATORS_COMMON + _MUTATORS_DICT + _MUTATORS_LIST:
    setattr(_SharedProxy, _m, _proxy_method(_m, True))
for _m in _READERS:
    setattr(_SharedProxy, _m, _proxy_method(_m, False))
del _m


def shared(container, guard: str, name: str):
    """Wrap a bare dict/list in a mutation-checked proxy declaring
    ``guard`` as its lock.  Identity passthrough when the plane is
    disabled at call time — zero production overhead."""
    global _shared_objects
    if not enabled():
        return container
    _shared_objects += 1
    _sync_gauges()
    return _SharedProxy(container, guard, name)


# -- surfaces ---------------------------------------------------------

def violations() -> List[Dict]:
    with _vlock:
        return list(_violations)


def clear_violations() -> None:
    with _vlock:
        _violations.clear()


@contextmanager
def trap():
    """Capture-and-remove violations recorded inside the block (the
    lockdep.trap() twin — tests provoke races without tripping the
    per-test gate)."""
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
    """Per-test gate anchor: the violation count before the test."""
    with _vlock:
        return len(_violations)


def gate_check(base: int) -> Optional[str]:
    """The per-test gate's body: format violations recorded past
    ``base`` (both stacks, lockdep-report style) and clear them so a
    single race cannot re-fail every later test.  Returns None when
    clean."""
    with _vlock:
        vs = _violations[base:]
        if not vs:
            return None
        _violations.clear()
    detail = "\n".join(
        f"- {v['message']} [{v['thread']}]\n"
        f"  racing access ({v['existing_thread']}, locks "
        f"{v['existing_locks']}) at:\n{v['existing_stack']}"
        f"  current access (locks {v['current_locks']}) at:\n"
        f"{v['current_stack']}"
        for v in vs)
    return (f"racecheck: {len(vs)} data-race violation(s) recorded "
            f"during this test:\n{detail}")


def dump() -> Dict:
    """The ``dump_racecheck`` admin-command payload."""
    with _vlock:
        vs = list(_violations)
    return {
        "enabled": enabled(),
        "active": _active(),
        "guarded_classes": list(_guarded_classes),
        "guarded_fields": _guarded_fields,
        "shared_objects": _shared_objects,
        "violations": vs,
        "num_violations": len(vs),
    }
