"""OpTracker — in-flight op introspection and slow-op history.

The port's copy of ``ceph_tpu/common/op_tracker.py``.

The role of src/common/TrackedOp.h (OpTracker/TrackedOp): every op a
daemon services registers here with a type and description; events
mark its progress; ``dump_ops_in_flight`` and the slow-op history are
served over the admin socket (`ceph daemon ... dump_ops_in_flight`,
`dump_historic_ops`) — the first tool reached for when a cluster is
slow.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, List, Optional

from ..analysis.lockdep import make_lock
from ..analysis.racecheck import guarded_by


class TrackedOp:
    def __init__(self, tracker: "OpTracker", op_type: str, desc: str):
        self._tracker = tracker
        self.op_type = op_type
        self.desc = desc
        self.start = time.time()
        self.events: List[tuple] = [(self.start, "initiated")]
        self.done: Optional[float] = None

    def mark_event(self, event: str) -> None:
        self.events.append((time.time(), event))

    def finish(self) -> None:
        """Idempotent: a second finish (an explicit finish inside a
        ``with`` block, or a double completion path) must not append a
        second "done" event, re-insert the op into history/slow, or
        double-count ``_served``."""
        if self.done is not None:
            return
        self.done = time.time()
        self.events.append((self.done, "done"))
        self._tracker._finish(self)

    def __enter__(self) -> "TrackedOp":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    @property
    def duration(self) -> float:
        return (self.done or time.time()) - self.start

    def dump(self) -> Dict:
        return {"type": self.op_type, "description": self.desc,
                "initiated_at": self.start,
                "age": round(self.duration, 6),
                "events": [{"time": t, "event": e}
                           for t, e in self.events]}


@guarded_by("optracker", "_inflight", "_history", "_slow", "_served")
class OpTracker:
    def __init__(self, history_size: int = 20,
                 history_slow_threshold: float = 0.5,
                 slow_history_size: Optional[int] = None):
        self._inflight: Dict[int, TrackedOp] = {}
        self._history: Deque[TrackedOp] = collections.deque(
            maxlen=history_size)
        # slow ops keep their OWN bounded ring, sized independently
        # (osd_op_history_slow_op_size vs osd_op_history_size in the
        # reference): only ops over the threshold enter it, so a burst
        # of fast ops can churn ``_history`` end to end without
        # evicting the slow ops an operator is hunting
        self._slow: Deque[TrackedOp] = collections.deque(
            maxlen=slow_history_size if slow_history_size is not None
            else history_size)
        self.slow_threshold = history_slow_threshold
        self._lock = make_lock("optracker")
        self._served = 0

    def create(self, op_type: str, desc: str = "") -> TrackedOp:
        op = TrackedOp(self, op_type, desc)
        with self._lock:
            self._inflight[id(op)] = op
        return op

    def _finish(self, op: TrackedOp) -> None:
        with self._lock:
            self._inflight.pop(id(op), None)
            self._history.append(op)
            self._served += 1
            if op.duration >= self.slow_threshold:
                self._slow.append(op)

    def slow_summary(self) -> Dict:
        """In-flight ops older than the slow threshold — the payload
        an OSD's beacon carries so the monitor can fold a SLOW_OPS
        health check (src/osd/OSD.cc get_health_metrics role).  Counts
        LIVE ops only: once they drain the count hits 0 and the check
        clears, exactly the reference's semantics."""
        now = time.time()
        with self._lock:
            ages = [now - op.start for op in self._inflight.values()]
        slow = [a for a in ages if a >= self.slow_threshold]
        return {"count": len(slow),
                "oldest_age": round(max(slow), 3) if slow else 0.0,
                "threshold": self.slow_threshold}

    # -- admin-socket payloads ----------------------------------------
    def dump_ops_in_flight(self) -> Dict:
        with self._lock:
            ops = [op.dump() for op in self._inflight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self) -> Dict:
        with self._lock:
            return {"num_ops": len(self._history),
                    "served_total": self._served,
                    "ops": [op.dump() for op in self._history]}

    def dump_historic_slow_ops(self) -> Dict:
        with self._lock:
            return {"threshold": self.slow_threshold,
                    "ops": [op.dump() for op in self._slow]}

    def wire(self, admin_socket) -> None:
        admin_socket.register("dump_ops_in_flight",
                              lambda _a: self.dump_ops_in_flight(),
                              "in-flight ops")
        admin_socket.register("dump_historic_ops",
                              lambda _a: self.dump_historic_ops(),
                              "recently completed ops")
        admin_socket.register("dump_historic_slow_ops",
                              lambda _a: self.dump_historic_slow_ops(),
                              "recently completed slow ops")
