"""Perf counters — per-daemon metrics with a process registry (the
port's copy of ``ceph_tpu/common/perf_counters.py``).

The role of src/common/perf_counters.{h,cc}: a ``PerfCountersBuilder``
declares typed counters (u64 gauge/counter, time, averages with
count+sum, histograms), daemons bump them on hot paths (cheap,
lock-per-instance), and the admin socket's ``perf dump`` serializes
every collection (perf_counters.h:63-141 / PerfCountersCollection).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..analysis.lockdep import make_lock

U64 = "u64"          # monotonically increasing counter
GAUGE = "gauge"      # settable level
TIME = "time"        # accumulated seconds
AVG = "avg"          # (count, sum) pair -> mean on dump
HISTOGRAM = "hist"   # fixed power-of-two bucket counts


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._types: Dict[str, str] = {}
        self._values: Dict[str, float] = {}
        self._avgs: Dict[str, Tuple[int, float]] = {}
        self._hists: Dict[str, List[int]] = {}
        self._hist_mins: Dict[str, float] = {}
        self._lock = make_lock("perf::counters")

    def _require(self, key: str, *allowed: str) -> str:
        """A typo'd key on a hot path must raise a clear error, not a
        bare KeyError deep inside an update."""
        t = self._types.get(key)
        assert t is not None, \
            f"perf counter {self.name!r} has no key {key!r}"
        assert t in allowed, \
            (f"perf counter {self.name}/{key} is {t}, not one of "
             f"{allowed}")
        return t

    # -- declaration (PerfCountersBuilder) ----------------------------
    def add_u64_counter(self, key: str, desc: str = "") -> None:
        self._types[key] = U64
        self._values[key] = 0

    def add_u64(self, key: str, desc: str = "") -> None:
        self._types[key] = GAUGE
        self._values[key] = 0

    def add_time(self, key: str, desc: str = "") -> None:
        self._types[key] = TIME
        self._values[key] = 0.0

    def add_u64_avg(self, key: str, desc: str = "") -> None:
        self._types[key] = AVG
        self._avgs[key] = (0, 0.0)

    def add_histogram(self, key: str, buckets: int = 32,
                      desc: str = "", min_value: float = 1e-6) -> None:
        """Log2 buckets anchored at ``min_value``: bucket 0 holds
        values <= min_value, bucket i holds (min*2^(i-1), min*2^i].
        The default floor of 1 µs makes sub-second LATENCIES resolve
        (the old ``int(value).bit_length()`` scheme collapsed every
        sub-second sample into bucket 0); byte-sized histograms pass
        ``min_value=1``."""
        self._types[key] = HISTOGRAM
        self._hists[key] = [0] * buckets
        self._hist_mins[key] = float(min_value)

    # -- updates ------------------------------------------------------
    def inc(self, key: str, amount: float = 1) -> None:
        self._require(key, U64, GAUGE, TIME)
        with self._lock:
            self._values[key] += amount

    def dec(self, key: str, amount: float = 1) -> None:
        self._require(key, GAUGE)
        with self._lock:
            self._values[key] -= amount

    def set(self, key: str, value: float) -> None:
        self._require(key, GAUGE, U64)
        with self._lock:
            self._values[key] = value

    def tinc(self, key: str, seconds: float) -> None:
        self._require(key, TIME)
        with self._lock:
            self._values[key] += seconds

    def avg_add(self, key: str, value: float) -> None:
        self._require(key, AVG)
        with self._lock:
            n, s = self._avgs[key]
            self._avgs[key] = (n + 1, s + value)

    def _bucket(self, key: str, value: float) -> int:
        lo = self._hist_mins[key]
        if value <= lo:
            return 0
        # value / lo > 1: int() is the floor of its positive log
        bucket = 1 + int(math.log2(value / lo))
        top = len(self._hists[key]) - 1
        return bucket if bucket < top else top

    def hist_add(self, key: str, value: float) -> None:
        self._require(key, HISTOGRAM)
        bucket = self._bucket(key, value)
        with self._lock:
            self._hists[key][bucket] += 1

    def update(self, incs=(), hists=()) -> None:
        """Several updates under one lock, for a hot path that books a
        call: ``incs``, (key, amount) pairs of counters and times (as
        ``inc``/``tinc``), and ``hists``, (key, value) samples (as
        ``hist_add``).  Keys are not checked by type: a key the logger
        lacks raises KeyError."""
        buckets = [(self._hists[key], self._bucket(key, v))
                   for key, v in hists]
        values = self._values
        with self._lock:
            for key, amount in incs:
                values[key] += amount
            for hist, bucket in buckets:
                hist[bucket] += 1

    # -- dump ---------------------------------------------------------
    def dump(self) -> Dict:
        with self._lock:
            out: Dict = {}
            for key, t in self._types.items():
                if t == AVG:
                    n, s = self._avgs[key]
                    out[key] = {"avgcount": n, "sum": s,
                                "avg": (s / n) if n else 0.0}
                elif t == HISTOGRAM:
                    out[key] = {"buckets": list(self._hists[key]),
                                "min": self._hist_mins[key]}
                else:
                    out[key] = self._values[key]
            return out


class PerfCountersCollection:
    """Process-wide registry (PerfCountersCollectionImpl)."""

    def __init__(self):
        self._loggers: Dict[str, PerfCounters] = {}
        self._lock = make_lock("perf::collection")

    def add(self, counters: PerfCounters) -> None:
        with self._lock:
            self._loggers[counters.name] = counters

    def remove(self, name: str) -> None:
        with self._lock:
            self._loggers.pop(name, None)

    def create(self, name: str) -> PerfCounters:
        pc = PerfCounters(name)
        self.add(pc)
        return pc

    def dump(self, logger: Optional[str] = None) -> Dict:
        """The `perf dump` admin-socket payload."""
        with self._lock:
            items = ({logger: self._loggers[logger]}
                     if logger else dict(self._loggers))
        return {name: pc.dump() for name, pc in items.items()}


_collection: Optional[PerfCountersCollection] = None


def collection() -> PerfCountersCollection:
    global _collection
    if _collection is None:
        _collection = PerfCountersCollection()
    return _collection
