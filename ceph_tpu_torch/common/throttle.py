"""Throttles — counting backpressure primitives.

The port's copy of ``ceph_tpu/common/throttle.py``.

The role of src/common/Throttle.{h,cc}: a named budget; ``get``
blocks (or fails) while the budget is exhausted, ``put`` returns it.
Used by services to bound in-flight recovery work
(osd_max_backfills-style limits).
"""

from __future__ import annotations

import threading

from ..analysis.lockdep import make_lock


class Throttle:
    def __init__(self, name: str, max_: int):
        self.name = name
        self.max = max_
        self.current = 0
        self._cond = threading.Condition(
            make_lock(f"throttle::{name}"))

    def get(self, count: int = 1, timeout: float | None = None) -> bool:
        """Block until the budget admits ``count``; False on timeout."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self.current + count <= self.max or
                self.max <= 0, timeout)
            if not ok:
                return False
            self.current += count
            return True

    def get_or_fail(self, count: int = 1) -> bool:
        with self._cond:
            if self.max > 0 and self.current + count > self.max:
                return False
            self.current += count
            return True

    def put(self, count: int = 1) -> None:
        with self._cond:
            self.current = max(0, self.current - count)
            self._cond.notify_all()

    def reset_max(self, max_: int) -> None:
        with self._cond:
            self.max = max_
            self._cond.notify_all()

    def get_current(self) -> int:
        with self._cond:
            return self.current

    def wait_until_drained(self, timeout: float | None = None) -> bool:
        """Block until every held unit is returned (the in-flight
        window is empty) — the flush/quiesce primitive async callers
        need; False on timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: self.current == 0,
                                       timeout)

    def hold(self, count: int = 1, timeout: float | None = None):
        """``with throttle.hold():`` — get on entry, put on exit.
        Raises TimeoutError when the budget never admits ``count``."""
        import contextlib

        @contextlib.contextmanager
        def _held():
            if not self.get(count, timeout):
                raise TimeoutError(
                    f"throttle {self.name}: {count} unit(s) not "
                    f"granted within {timeout}s")
            try:
                yield self
            finally:
                self.put(count)

        return _held()
