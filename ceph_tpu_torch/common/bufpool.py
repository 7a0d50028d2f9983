"""Pooled buffer plane — recycled, refcounted recv segments (the
port's copy of ``ceph_tpu/common/bufpool.py``, with its own
process-global pool).

The zero-copy data path starts here: the messenger recvs
every frame into a pooled ``Segment`` and hands the payload onward as
``memoryview`` slices, so the frame codec, the blob table, the store
``queue_transaction`` staging and the EC encode input all share ONE
host materialisation instead of re-copying at every layer boundary.

Lifecycle contract:

- ``acquire(n, tag)`` returns a ``Segment`` holding at least ``n``
  usable bytes with refcount 1.  Buffers come from per-size-class free
  lists (power-of-two classes); a hit recycles a previous buffer with
  zero allocation.
- ``Segment.incref()`` extends the lifetime across an async handoff
  (e.g. a dispatch worker still reading blob views after the reader
  thread moved on); every holder calls ``release()`` exactly once.
  Releasing below zero raises — a double release is a use-after-free
  in waiting, never a silent no-op.
- Views into a segment are only valid while the segment is held.
  Anything that must outlive the frame (reply caches, resend queues,
  the object store's own image) copies deliberately — and books that
  copy in the ``obs.copy`` ledger.

Leak accounting lives in the perf family (``obs.bufpool``): acquires/
releases/hit-miss rates, live-segment gauges, and ``leaked_segments``
— segments garbage-collected while still referenced, counted by a GC
finalizer so a lost segment surfaces in ``perf dump`` (and in
``outstanding()``, which a test's leak gate reads) instead of silently costing
the recycle rate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import weakref

from ..analysis.lockdep import make_lock
from ..analysis.racecheck import guarded_by, shared
from .perf_counters import PerfCounters, collection

LOGGER = "obs.bufpool"

# size classes are powers of two in [1 KiB, 16 MiB]; larger requests
# are served unpooled (counted as misses, never retained)
_MIN_SHIFT = 10
_MAX_SHIFT = 24
# free buffers retained per class — enough for every reader thread of
# an in-process cluster plus in-flight dispatch, small enough that an idle
# process holds <½ MiB of small classes
_PER_CLASS = 8


class DoubleRelease(AssertionError):
    """A segment was released more times than it was referenced."""


class Segment:
    """One refcounted pooled buffer (``nbytes`` usable)."""

    __slots__ = ("_buf", "nbytes", "tag", "_refs", "_pool", "_shift",
                 "_fin", "__weakref__")

    def __init__(self, buf: bytearray, nbytes: int, tag: str,
                 pool: "BufferPool", shift: int):
        self._buf = buf
        self.nbytes = nbytes
        self.tag = tag
        self._refs = 1
        self._pool = pool
        self._shift = shift
        # GC safety net: a segment collected while refs>0 is a leak —
        # count it and return its buffer to the pool so the leak costs
        # accounting, not capacity.  args (not the segment) keep the
        # buffer alive for the callback; detached on clean release.
        self._fin = weakref.finalize(self, pool._on_leak, buf, shift,
                                     tag, id(self))

    # -- views --------------------------------------------------------
    def writable(self) -> memoryview:
        """The recv_into target: the first ``nbytes`` of the buffer."""
        return memoryview(self._buf)[:self.nbytes]

    def view(self, start: int = 0, end: Optional[int] = None
             ) -> memoryview:
        """A zero-copy slice of the payload (valid while held)."""
        return memoryview(self._buf)[start:self.nbytes if end is None
                                     else end]

    # -- lifetime -----------------------------------------------------
    def incref(self) -> "Segment":
        with self._pool._lock:
            if self._refs <= 0:
                raise DoubleRelease(
                    f"bufpool: incref on released segment "
                    f"(tag={self.tag!r})")
            self._refs += 1
        return self

    def release(self) -> None:
        self._pool._release(self)

    @property
    def refs(self) -> int:
        return self._refs


@guarded_by("bufpool::pool", "_live")
class BufferPool:
    """Per-size-class recycling pool (process-global via ``pool()``)."""

    def __init__(self, per_class: int = _PER_CLASS):
        self._lock = make_lock("bufpool::pool")
        self._free: Dict[int, List[bytearray]] = shared(
            {}, "bufpool::pool", "bufpool.free")
        self._per_class = per_class
        # live-segment registry for the per-test leak gate: id -> tag
        self._live: Dict[int, Tuple[str, int]] = {}
        self._pc: Optional[PerfCounters] = None

    # -- counters -----------------------------------------------------
    def _counters(self) -> PerfCounters:
        with self._lock:
            if self._pc is None:
                pc = collection().create(LOGGER)
                for key in ("acquires", "releases", "pool_hits",
                            "pool_misses", "leaked_segments"):
                    pc.add_u64_counter(key)
                for key in ("live_segments", "live_bytes"):
                    pc.add_u64(key)
                self._pc = pc
            return self._pc

    # -- acquire / release --------------------------------------------
    @staticmethod
    def _shift_for(n: int) -> int:
        shift = max(_MIN_SHIFT, (max(1, n) - 1).bit_length())
        return shift

    def acquire(self, n: int, tag: str = "") -> Segment:
        """A segment with ``n`` usable bytes, refcount 1."""
        pc = self._counters()
        shift = self._shift_for(n)
        buf = None
        if shift <= _MAX_SHIFT:
            with self._lock:
                free = self._free.get(shift)
                if free:
                    buf = free.pop()
        if buf is None:
            pc.inc("pool_misses")
            buf = bytearray(1 << shift) if shift <= _MAX_SHIFT \
                else bytearray(n)
        else:
            pc.inc("pool_hits")
        seg = Segment(buf, n, tag, self, shift)
        with self._lock:
            self._live[id(seg)] = (tag, n)
        pc.inc("acquires")
        pc.inc("live_segments")
        pc.inc("live_bytes", n)
        return seg

    def _release(self, seg: Segment) -> None:
        pc = self._counters()
        with self._lock:
            if seg._refs <= 0:
                raise DoubleRelease(
                    f"bufpool: double release (tag={seg.tag!r})")
            seg._refs -= 1
            if seg._refs > 0:
                return
            self._live.pop(id(seg), None)
            seg._fin.detach()
            self._recycle_locked(seg._buf, seg._shift)
        pc.inc("releases")
        pc.dec("live_segments")
        pc.dec("live_bytes", seg.nbytes)

    def _recycle_locked(self, buf: bytearray, shift: int) -> None:
        if shift > _MAX_SHIFT or len(buf) != (1 << shift):
            return  # oversized / odd buffer: never retained
        free = self._free.setdefault(shift, [])
        if len(free) < self._per_class:
            free.append(buf)

    def _on_leak(self, buf: bytearray, shift: int, tag: str,
                 seg_id: int) -> None:
        """GC finalizer for a segment collected while still held."""
        pc = self._counters()
        with self._lock:
            self._recycle_locked(buf, shift)
            _tag, nbytes = self._live.pop(seg_id, (tag, 0))
        pc.inc("leaked_segments")
        pc.dec("live_segments")
        pc.dec("live_bytes", nbytes)

    # -- introspection (a test's leak gate) ---------------------------
    def outstanding(self) -> List[Tuple[str, int]]:
        """(tag, nbytes) of every currently-held segment."""
        with self._lock:
            return list(self._live.values())

    def leaked(self) -> int:
        pc = self._counters()
        return int(pc.dump().get("leaked_segments", 0))

    def free_buffers(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._free.values())


_pool = BufferPool()


def pool() -> BufferPool:
    """The process-global pool (all daemons of an in-process cluster
    share the process, exactly like the perf-counter collection)."""
    return _pool


def acquire(n: int, tag: str = "") -> Segment:
    return _pool.acquire(n, tag)


def outstanding() -> List[Tuple[str, int]]:
    return _pool.outstanding()
