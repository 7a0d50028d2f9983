"""dmClock op scheduler — QoS between op classes.

The port's copy of ``ceph_tpu/common/op_queue.py``.

The role of src/osd/scheduler (OpScheduler/mClockScheduler over the
vendored dmclock submodule): each op class (client, recovery, scrub,
...) gets a QoS triple (reservation, weight, limit) in ops/sec, and the
queue serves by dmClock tag order — reservation tags first (guaranteed
floor), then weight-proportional sharing below the limit ceiling.

Tag algebra (the dmClock paper's core, as the reference configures it
via osd_mclock_scheduler_* options):

  R_tag = max(now, prev_R + 1/reservation)
  L_tag = max(now, prev_L + 1/limit)
  P_tag = max(now, prev_P + 1/weight)     (normalized share)

``dequeue(now)``: any class whose R_tag <= now is served by earliest
R_tag (reservation phase); otherwise the earliest P_tag among classes
with L_tag <= now (weight phase); otherwise None until a tag matures.
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Tuple

CLIENT = "client"
RECOVERY = "recovery"
SCRUB = "scrub"


@dataclass
class ClientInfo:
    """QoS triple in ops/sec; 0 disables the term."""

    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0  # 0 = unlimited


class MClockQueue:
    def __init__(self, qos: Optional[Dict[str, ClientInfo]] = None):
        self.qos: Dict[str, ClientInfo] = dict(qos or {})
        self._queues: Dict[str, Deque] = collections.defaultdict(
            collections.deque)
        self._r_tag: Dict[str, float] = {}
        self._l_tag: Dict[str, float] = {}
        self._p_tag: Dict[str, float] = {}

    def set_qos(self, cls: str, info: ClientInfo) -> None:
        self.qos[cls] = info

    def enqueue(self, cls: str, item, now: float) -> None:
        if cls not in self.qos:
            self.qos[cls] = ClientInfo()
        q = self._queues[cls]
        q.append(item)
        if len(q) == 1:
            # idle -> active: tags catch up to now but NEVER rewind
            # (dmClock's max(prev, now) rule — a burst that drains and
            # re-fills must not defeat its limit)
            info = self.qos[cls]
            prev_r = self._r_tag.get(cls, now)
            if prev_r == math.inf:
                prev_r = now  # reservation granted since last active
            self._r_tag[cls] = (max(now, prev_r)
                                if info.reservation else math.inf)
            self._l_tag[cls] = max(now, self._l_tag.get(cls, now))
            self._p_tag[cls] = max(now, self._p_tag.get(cls, now))

    def _advance(self, cls: str, now: float) -> None:
        info = self.qos[cls]
        self._r_tag[cls] = (
            max(now, self._r_tag[cls] + 1.0 / info.reservation)
            if info.reservation else math.inf)
        self._l_tag[cls] = (
            max(now, self._l_tag[cls] + 1.0 / info.limit)
            if info.limit else now)
        self._p_tag[cls] = max(
            now, self._p_tag[cls] + 1.0 / max(1e-9, info.weight))

    def dequeue(self, now: float) -> Optional[Tuple[str, object]]:
        """The next op to serve at ``now``, or None if every class is
        tag-throttled (call again later)."""
        ready = [c for c, q in self._queues.items() if q]
        if not ready:
            return None
        # reservation phase: guaranteed floors first
        res = [c for c in ready if self._r_tag.get(c, math.inf) <= now]
        if res:
            cls = min(res, key=lambda c: self._r_tag[c])
        else:
            # weight phase: proportional share below the limit ceiling
            eligible = [c for c in ready
                        if self._l_tag.get(c, 0.0) <= now]
            if not eligible:
                return None
            cls = min(eligible, key=lambda c: self._p_tag[c])
        item = self._queues[cls].popleft()
        self._advance(cls, now)
        return cls, item

    def next_ready_at(self) -> float:
        """Earliest time a throttled dequeue could succeed."""
        times = []
        for c, q in self._queues.items():
            if not q:
                continue
            r = self._r_tag.get(c, math.inf)
            l_ = self._l_tag.get(c, 0.0)
            times.append(min(r, l_))
        return min(times) if times else math.inf

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())


def default_osd_queue() -> MClockQueue:
    """The balanced profile (osd_mclock_profile=balanced spirit):
    clients and recovery share, scrub runs in the leftovers."""
    return MClockQueue({
        CLIENT: ClientInfo(reservation=40.0, weight=1.0, limit=0.0),
        RECOVERY: ClientInfo(reservation=20.0, weight=0.5, limit=100.0),
        SCRUB: ClientInfo(reservation=0.0, weight=0.2, limit=50.0),
    })


class Requeue(Exception):
    """Raised by a job to be put back at the tail of its class queue —
    the bounded-resource-wait escape (a shard op whose PG lock is held
    by a long peering pass).  The WORKER moves on to other ops instead
    of blocking, so two stuck writes can no longer occupy the whole
    pool and starve every other PG's ops (the reference's ShardedOpWQ
    requeues ops that cannot take their PG lock the same way); the
    SUBMITTER keeps blocking on its original submit()."""


class OpScheduler:
    """Threaded front for MClockQueue — the OpScheduler/shard-worker
    seam (src/osd/scheduler/OpScheduler.h + OSD::ShardedOpWQ role):
    handler threads submit (class, thunk) and block for the result;
    a small worker pool serves strictly in dmClock tag order, so QoS
    between client/recovery/scrub ops is enforced at the store door."""

    def __init__(self, queue: Optional[MClockQueue] = None,
                 n_workers: int = 2):
        import threading

        from ..analysis.lockdep import make_lock

        # NOT `queue or ...`: an empty MClockQueue is len()==0 falsy
        self.q = queue if queue is not None else default_osd_queue()
        self._cv = threading.Condition(make_lock("opq::cv"))
        self._running = True
        self.served: Dict[str, int] = collections.defaultdict(int)
        self._workers = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"mclock-w{i}")
            for i in range(n_workers)]
        for w in self._workers:
            w.start()

    def submit(self, cls: str, fn):
        """Run ``fn`` under class ``cls``; blocks until served."""
        import threading
        import time as _time

        done = threading.Event()
        box: list = [None, None]  # result, exception

        def job(final: bool = False):
            try:
                box[0] = fn()
            except Requeue:
                if not final:
                    return True  # scheduler re-enqueues
                box[1] = RuntimeError(
                    "op abandoned at scheduler shutdown (resource "
                    "still busy)")
            except BaseException as e:  # propagated to the submitter
                box[1] = e
            done.set()
            return None

        inline = False
        with self._cv:
            if not self._running:
                raise RuntimeError("op scheduler shut down")
            now = _time.monotonic()
            self.q.enqueue(cls, job, now)
            if len(self.q) == 1:
                # inline fast path: nothing queued ahead, so run on
                # the SUBMITTING thread — dequeue still advances the
                # dmClock tags (QoS accounting intact; a tag-throttled
                # class stays queued for a worker to pace), and the
                # uncontended case saves two thread handoffs per op —
                # a real cost with many daemons sharing few cores
                got = self.q.dequeue(now)
                if got is not None:
                    inline = True
                    self.served[cls] += 1
                else:
                    self._cv.notify()
            else:
                self._cv.notify()
        if inline and job():
            # bounded wait failed (Requeue): back through the queue
            final = False
            with self._cv:
                if self._running:
                    self.q.enqueue(cls, job, _time.monotonic())
                    self._cv.notify()
                else:
                    final = True
            if final:
                # outside the cv, as in _work: the final run can block
                # on a PG lock or a store write
                job(final=True)
        done.wait()
        if box[1] is not None:
            raise box[1]
        return box[0]

    def _work(self) -> None:
        import time as _time

        while True:
            with self._cv:
                while self._running:
                    got = self.q.dequeue(_time.monotonic())
                    if got is not None:
                        break
                    nxt = self.q.next_ready_at()
                    delay = max(0.001, min(
                        0.2, nxt - _time.monotonic())) \
                        if nxt != math.inf else 0.2
                    self._cv.wait(timeout=delay)
                if not self._running:
                    return
                cls, job = got
                self.served[cls] += 1
            if job():
                # bounded wait failed: back of the class queue (the
                # job itself paces via its own wait timeout)
                final = False
                with self._cv:
                    if self._running:
                        self.q.enqueue(cls, job, _time.monotonic())
                        self._cv.notify()
                    else:
                        final = True
                if final:
                    # OUTSIDE the cv, mirroring drain(): the final run
                    # re-executes fn(), which can block on a PG-lock
                    # wait or an fsync-heavy store write — holding the
                    # cv through that stalls every worker and shutdown
                    job(final=True)

    def depths(self) -> Dict[str, int]:
        with self._cv:
            return {c: len(q) for c, q in self.q._queues.items() if q}

    def shutdown(self) -> None:
        """Stop workers, then drain every queued job inline — a job
        abandoned un-run would leave its submitter blocked in
        done.wait() forever."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
            leftovers = []
            while True:
                got = self.q.dequeue(math.inf)
                if got is None:
                    break
                leftovers.append(got[1])
        for job in leftovers:
            job(final=True)
