"""Metrics history — per-daemon counter time-series in a bounded ring
(the port's copy of ``ceph_tpu/common/metrics_history.py``).

``perf dump`` exposes point-in-time counter snapshots; the
interesting failure modes of an EC data path (CPU saturation, batching
collapse, recovery interference) are only visible as *rates over
time*.  This module is the continuous half: every daemon samples its
merged perf state (its own ``PerfCountersCollection`` over the
process-global library counters — the same merge ``perf dump``
serves) into an in-memory ring at a configurable interval, and the
``dump_metrics_history`` admin command serves the ring with derived
rates and log2-histogram deltas computed at READ time — sampling
stays a cheap dict copy, no math on the hot path.

The mgr-internal MetricsHistory / ``ceph daemonperf`` role, turned
inward: a scraper reads every daemon's ring and merges them into one
time-aligned cluster series.  The device-plane fields come from the
port's ``device_metrics``, which never initialises CUDA itself.

Wired by ``Context.start_admin_socket()`` when
``metrics_history_interval`` > 0, stopped by ``Context.shutdown()``
(the sampler is one daemon thread; tests' thread-leak gate sees it
die with its context).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional

from ..analysis.lockdep import make_lock
from ..analysis.racecheck import guarded_by
from . import device_metrics
from .perf_counters import PerfCountersCollection, collection


@guarded_by("metrics::history", "_ring",
            owned_by_thread=("sample_errors", "last_error"))
class MetricsHistory:
    def __init__(self, name: str,
                 perf: Optional[PerfCountersCollection] = None,
                 interval: float = 1.0, retention: int = 240):
        self.name = name
        self.interval = max(0.05, float(interval))
        self._perf = perf
        self._ring: Deque[Dict] = collections.deque(
            maxlen=max(2, int(retention)))
        self._lock = make_lock("metrics::history")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sample_errors = 0
        self.last_error: Optional[str] = None

    # -- sampling -----------------------------------------------------
    def sample(self) -> None:
        """One ring entry: wall + monotonic stamps, the merged perf
        dump, and the device-plane shape table.  The monotonic stamp
        is what rates divide by — wall time may step."""
        device_metrics.sample_memory()
        merged = dict(collection().dump())
        if self._perf is not None:
            merged.update(self._perf.dump())
        entry = {"ts": time.time(), "mono": time.monotonic(),
                 "perf": merged,
                 "shapes": device_metrics.shape_table()}
        with self._lock:
            self._ring.append(entry)

    def start(self) -> None:
        if self._thread is not None:
            return
        self.sample()  # the ring is never empty once started
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"metrics:{self.name}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample()
            except Exception as e:
                # one bad sample (a logger torn down mid-dump) must
                # not kill the sampler — the ring skips a beat, but
                # never silently (the swallowed-run-loop lint class)
                self.sample_errors += 1
                self.last_error = repr(e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # -- read side ----------------------------------------------------
    def samples(self, last: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = list(self._ring)
        return out[-int(last):] if last else out

    def dump(self, last: Optional[int] = None) -> Dict:
        """The ``dump_metrics_history`` payload: raw samples plus the
        derived views (rates per changed counter, histogram bucket
        deltas first->last) computed here, at read time."""
        samples = self.samples(last)
        return {"name": self.name,
                "interval": self.interval,
                "retention": self._ring.maxlen,
                "n": len(samples),
                "samples": samples,
                "rates": derive_rates(samples),
                "hist_deltas": hist_deltas(samples)}

    def wire(self, admin_socket) -> None:
        admin_socket.register(
            "dump_metrics_history",
            lambda a: self.dump(last=a.get("last")),
            "counter time-series ring with derived rates "
            "(?last= limits samples)")


# -- derived views (shared with a cluster-side merge, and with tests
# recomputing them) ----------------------------------------------------

def _numeric_items(perf: Dict) -> Dict[str, float]:
    """Flatten one sample's perf dump to {'logger.key': value} for
    plain numeric counters (avg pairs contribute their sum; hists are
    handled separately)."""
    out: Dict[str, float] = {}
    for logger, counters in (perf or {}).items():
        if not isinstance(counters, dict):
            continue
        for key, val in counters.items():
            if isinstance(val, (int, float)):
                out[f"{logger}.{key}"] = float(val)
            elif isinstance(val, dict) and "avgcount" in val:
                out[f"{logger}.{key}.sum"] = float(val.get("sum", 0))
                out[f"{logger}.{key}.count"] = float(
                    val.get("avgcount", 0))
    return out


def derive_rates(samples: List[Dict]) -> Dict[str, List[Dict]]:
    """Per-counter rate series between consecutive samples, only for
    counters that changed at least once (the unchanged majority would
    bury the signal).  Monotonic timestamps; negative deltas (a
    counter reset) clamp to 0.

    Ring-wrap audit: rates are derived at READ time from whatever the
    bounded ring currently retains — consecutive pairs of RETAINED
    samples only (``zip(samples, samples[1:])``).  Once the ring wraps
    past its retention, the oldest retained sample becomes the first
    pair's LEFT endpoint; its evicted predecessor is never consulted,
    so the first derived rate spans [oldest_retained,
    second_oldest_retained] — a real interval — rather than a phantom
    interval against a dropped sample.
    """
    if len(samples) < 2:
        return {}
    flats = [_numeric_items(s.get("perf", {})) for s in samples]
    changed = {k for a, b in zip(flats, flats[1:])
               for k in b if b.get(k) != a.get(k)}
    out: Dict[str, List[Dict]] = {k: [] for k in sorted(changed)}
    for (sa, fa), (sb, fb) in zip(zip(samples, flats),
                                  zip(samples[1:], flats[1:])):
        dt = max(1e-9, sb.get("mono", 0) - sa.get("mono", 0))
        for k in out:
            if k in fb and k in fa:
                out[k].append(
                    {"ts": sb.get("ts"),
                     "dt": round(dt, 6),
                     "rate": max(0.0, (fb[k] - fa[k]) / dt)})
    return out


def hist_deltas(samples: List[Dict]) -> Dict[str, Dict]:
    """First->last bucket deltas per histogram counter that moved —
    'what latencies did this window actually see'."""
    if len(samples) < 2:
        return {}
    first, lastp = samples[0].get("perf", {}), samples[-1].get(
        "perf", {})
    out: Dict[str, Dict] = {}
    for logger, counters in (lastp or {}).items():
        if not isinstance(counters, dict):
            continue
        for key, val in counters.items():
            if not (isinstance(val, dict) and "buckets" in val):
                continue
            prev = (first.get(logger) or {}).get(key) or {}
            pbuck = prev.get("buckets") or [0] * len(val["buckets"])
            delta = [max(0, b - a) for a, b in
                     zip(pbuck, val["buckets"])]
            if any(delta):
                out[f"{logger}.{key}"] = {
                    "buckets": delta, "min": val.get("min", 1e-6),
                    "count": sum(delta)}
    return out
