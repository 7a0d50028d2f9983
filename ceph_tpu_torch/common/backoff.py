"""Jittered exponential backoff with a retry *deadline* budget (the
port's copy of ``ceph_tpu/common/backoff.py``).

Fixed-interval retry (``time.sleep(0.3)`` in a loop) has two failure
modes the client paths shipped with: every retrying caller wakes in
lockstep — a thundering herd against a mon that just failed over —
and N retries x 0.3 s can silently exceed the op timeout the caller
thought it set.  This module is the one retry-pacing policy for the
framework (the osd_backoff / objecter retry-jitter role in the
reference, src/osd/osd_types.h Backoff):

  * decorrelated jitter — ``sleep = min(cap, uniform(base,
    prev * 3))`` — the AWS "Exponential Backoff and Jitter" result:
    retries desynchronize instead of re-colliding each round;
  * a deadline budget — the Backoff is built with the caller's total
    time budget and ``sleep()`` refuses to start a wait that cannot
    finish inside it, returning False so the caller raises its last
    error *within* its advertised timeout instead of 1.8x past it.

Usage (the shape every retry/except loop takes)::

    bo = Backoff(deadline=timeout)
    for attempt in range(retries):
        try:
            return do_op()
        except TransientError:
            if not bo.sleep():       # budget exhausted
                raise
"""

from __future__ import annotations

import random
import time
from typing import Optional


class Backoff:
    """One retry series: decorrelated-jitter pacing under a budget."""

    def __init__(self, base: float = 0.05, cap: float = 1.0,
                 deadline: Optional[float] = None,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.cap = cap
        self._prev = base
        self._expires = (None if deadline is None
                         else time.monotonic() + deadline)
        self._rng = rng or random

    def remaining(self) -> float:
        """Seconds left in the budget (inf when unbudgeted)."""
        if self._expires is None:
            return float("inf")
        return max(0.0, self._expires - time.monotonic())

    def expired(self) -> bool:
        return self.remaining() <= 0

    def next_interval(self) -> float:
        """Draw the next jittered interval (advances the series)."""
        nxt = min(self.cap, self._rng.uniform(self.base,
                                              self._prev * 3))
        self._prev = max(nxt, self.base)
        return nxt

    def sleep(self) -> bool:
        """Sleep the next interval, truncated to the budget.  Returns
        False — without sleeping — once the budget is exhausted: the
        caller's cue to stop retrying and surface its last error."""
        nxt = self.next_interval()
        rem = self.remaining()
        if rem <= 0:
            return False
        time.sleep(min(nxt, rem))
        return True
