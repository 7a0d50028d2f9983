"""Distributed op tracing — the Jaeger/OpenTelemetry span model (the
port's copy of ``ceph_tpu/common/tracing.py``, with its own registry of
live tracers).

The role of src/tracing/ (Quincy's jaegertracing integration,
src/common/tracer.cc): every daemon owns a ``Tracer``; code opens
``Span``s around units of work; the messenger injects the active
span's context into outbound frames (a ``trace`` field) and opens a
child span around handler execution on the receiving daemon — so one
``Client.put`` on an EC pool yields a single trace whose spans live in
several processes' ring buffers, reassembled by trace_id.

Model:

- ``Span``: (trace_id, span_id, parent_id) + name/service/tags, wall
  start time, monotonic duration, timestamped events (``log()``),
  idempotent ``finish()``.  Spans are context managers — a span that
  escapes its ``with`` is exactly the leak ``active_spans()`` shows.
- ``Tracer``: per-daemon factory + per-process ring buffer of finished
  spans (bounded, newest-wins) + the sampling decision.  Sampling is
  decided at the trace ROOT (probability ``sample_rate``) and
  inherited by every child, local or remote, via the wire carrier —
  an unsampled span still propagates its context (so downstream
  daemons agree) but is never recorded.
- Thread-local parenting: a span opened while another span of the
  same tracer is active on this thread becomes its child
  automatically; cross-thread and cross-daemon parents pass
  explicitly (``child_of`` = a Span or a wire carrier dict).

``require_parent=True`` returns a shared no-op span when there is no
active parent and no carrier — the fire-and-forget paths (heartbeats,
map pushes) stay out of the ring unless an op is actually being
traced through them.
"""

from __future__ import annotations

import collections
import itertools
import random
import threading
import time
import uuid
import weakref
from typing import Dict, List, Optional

from ..analysis.lockdep import make_lock

# every live tracer, for a test's span-leak gate and debugging;
# weak so runtimes can die
_tracers: "weakref.WeakSet" = weakref.WeakSet()
_tracers_lock = make_lock("tracing::registry")


_id_prefix = uuid.uuid4().hex[:8]
_id_counter = itertools.count(1)


def _gen_id() -> str:
    # random per-process prefix + counter: collision-safe for span
    # correlation at a fraction of uuid4's cost (ids are minted
    # several times per traced op on the data path)
    return f"{_id_prefix}{next(_id_counter):08x}"


class Span:
    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 sampled: bool, tags: Optional[Dict] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.tags: Dict = dict(tags or {})
        self.events: List[tuple] = []
        self.start = time.time()
        self._t0 = time.monotonic()
        self.duration: Optional[float] = None
        self.done: Optional[float] = None

    # -- recording ----------------------------------------------------
    def log(self, event: str) -> None:
        self.events.append((time.time(), event))

    def set_tag(self, key: str, value) -> None:
        self.tags[key] = value

    def finish(self) -> None:
        """Idempotent: a span double-finished (explicit finish inside a
        ``with``) records once and keeps its first duration."""
        if self.done is not None:
            return
        self.done = time.time()
        self.duration = time.monotonic() - self._t0
        self.tracer._finish(self)

    # -- context manager (the only lint-clean way to use a span) ------
    def __enter__(self) -> "Span":
        self.tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        if exc is not None:
            self.set_tag("error", repr(exc))
        self.tracer._pop(self)
        self.finish()
        return False

    def dump(self) -> Dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "service": self.tracer.service, "start": self.start,
                "duration": (self.duration
                             if self.duration is not None
                             else time.monotonic() - self._t0),
                "finished": self.done is not None,
                "tags": dict(self.tags),
                "events": [{"time": t, "event": e}
                           for t, e in self.events]}


class _NoopSpan:
    """Shared sentinel for un-parented require_parent spans: carries no
    context, records nothing, safe from any thread."""

    tracer = None
    trace_id = None
    span_id = None
    parent_id = None
    sampled = False
    name = "<noop>"

    def log(self, event: str) -> None:
        pass

    def set_tag(self, key: str, value) -> None:
        pass

    def finish(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    def __init__(self, service: str, ring_size: int = 512,
                 sample_rate: float = 1.0):
        self.service = service
        self.sample_rate = sample_rate
        self._ring: "collections.deque[Span]" = collections.deque(
            maxlen=ring_size)
        self._active: Dict[str, Span] = {}
        self._lock = make_lock("tracing::tracer")
        self._tls = threading.local()
        self.started = 0
        self.finished = 0
        self.sampled_out = 0  # finished but not recorded (sampling)
        with _tracers_lock:
            _tracers.add(self)

    # -- thread-local span stack --------------------------------------
    def current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def _push(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and span in stack:
            stack.remove(span)

    # -- span factory -------------------------------------------------
    def start_span(self, name: str, child_of=None,
                   tags: Optional[Dict] = None,
                   require_parent: bool = False):
        """Open a span.  ``child_of``: a Span, a wire carrier dict
        ({"trace_id", "span_id", "sampled"}), or None — None parents to
        this thread's active span, else starts a new root trace (where
        the sampling decision is made).  ``require_parent=True``
        returns the shared no-op span instead of a new root."""
        parent = child_of if child_of is not None else self.current()
        if isinstance(parent, _NoopSpan):
            parent = None
        if parent is None:
            if require_parent:
                return NOOP_SPAN
            trace_id, parent_id = _gen_id(), None
            sampled = random.random() < self.sample_rate
        elif isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
            sampled = parent.sampled
        else:  # wire carrier
            trace_id = parent.get("trace_id")
            parent_id = parent.get("span_id")
            sampled = bool(parent.get("sampled", True))
            if not trace_id:
                if require_parent:
                    return NOOP_SPAN
                trace_id, parent_id = _gen_id(), None
                sampled = random.random() < self.sample_rate
        span = Span(self, name, trace_id, _gen_id(), parent_id,
                    sampled, tags)
        with self._lock:
            self._active[span.span_id] = span
            self.started += 1
        return span

    def scope(self, span):
        """Adopt an EXISTING span as this thread's active parent (for
        work fanned out to a pool: the submitting thread captures
        ``tracer.current()``, the worker enters ``tracer.scope(it)``).
        Does not finish the span; no-ops on None / the no-op span."""
        return _Scope(self, span)

    # -- wire context -------------------------------------------------
    @staticmethod
    def inject(span) -> Optional[Dict]:
        """Span -> wire carrier (the frame's ``trace`` field); None for
        the no-op span (callers then skip the field entirely)."""
        if span is None or span.trace_id is None:
            return None
        return {"trace_id": span.trace_id, "span_id": span.span_id,
                "sampled": span.sampled}

    # -- completion ---------------------------------------------------
    def _finish(self, span: Span) -> None:
        with self._lock:
            self._active.pop(span.span_id, None)
            self.finished += 1
            if span.sampled:
                self._ring.append(span)
            else:
                self.sampled_out += 1

    # -- introspection ------------------------------------------------
    def active(self) -> List[Span]:
        with self._lock:
            return list(self._active.values())

    def abandon_active(self) -> List[Span]:
        """Drop every unfinished span (the per-test leak gate's reset:
        one leaky test must not re-fail every later one)."""
        with self._lock:
            left = list(self._active.values())
            self._active.clear()
        return left

    def dump(self, trace_id: Optional[str] = None,
             limit: Optional[int] = None) -> Dict:
        """The ``dump_tracing`` admin-socket payload."""
        with self._lock:
            spans = [s for s in self._ring
                     if trace_id is None or s.trace_id == trace_id]
            active = [s for s in self._active.values()
                      if trace_id is None or s.trace_id == trace_id]
            counters = {"started": self.started,
                        "finished": self.finished,
                        "sampled_out": self.sampled_out}
        if limit:
            spans = spans[-int(limit):]
        return {"service": self.service,
                "sample_rate": self.sample_rate,
                "spans": [s.dump() for s in spans],
                "active": [s.dump() for s in active],
                **counters}

    def wire(self, admin_socket) -> None:
        admin_socket.register(
            "dump_tracing",
            lambda a: self.dump(a.get("trace_id"), a.get("limit")),
            "finished-span ring buffer + active spans "
            "(?trace_id= filters, ?limit= trims)")


class _Scope:
    def __init__(self, tracer: Tracer, span):
        self.tracer = tracer
        self.span = None if isinstance(span, _NoopSpan) else span

    def __enter__(self):
        if self.span is not None:
            self.tracer._push(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        if self.span is not None:
            self.tracer._pop(self.span)
        return False


def active_spans() -> List[tuple]:
    """(service, span) for every unfinished span in the process — the
    per-test span-leak gate's probe."""
    with _tracers_lock:
        tracers = list(_tracers)
    return [(t.service, s) for t in tracers for s in t.active()]


def abandon_all_active() -> List[tuple]:
    with _tracers_lock:
        tracers = list(_tracers)
    return [(t.service, s) for t in tracers
            for s in t.abandon_active()]
