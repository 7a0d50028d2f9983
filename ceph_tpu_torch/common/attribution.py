"""Critical-path latency attribution — trace trees folded into stages.

The port's copy of ``ceph_tpu/common/attribution.py``: the same stage
table over the port's span names (its EC engine's span on the card is
``ec.encode``, as in ``ceph_tpu``).

The tracing plane records *that* an op was slow (a span tree per
``Client.put``); this module answers *where* the time went.  A
completed trace tree is folded onto the root op's wall-clock timeline:
every instant of the root interval is charged to exactly ONE stage —
the stage of the deepest span covering that instant — so the per-stage
totals sum to the measured client-side latency by construction (no
double counting across the parallel shard fan-out, no vanished gaps).
Time covered only by spans this table cannot name lands in an explicit
``unattributed`` stage instead of silently inflating a neighbor.

Stage mapping (ordered, most-specific first — the write path
client → messenger → dispatch queue → EC encode → WAL commit →
shard fan-out → ack):

  ==============  ==================================================
  stage           charged from
  ==============  ==================================================
  client          ``client.*`` root self-time (placement compute,
                  arg marshalling, completion plumbing)
  fanout          ``call:shard_write`` self-time (waiting on the
                  replica/shard round trips)
  encode          ``ec.encode`` (the batched EC encode dispatch)
  wal             ``store.commit`` (queue_transaction through the
                  group-commit fsync ack)
  messenger       any other ``call:*`` / ``send:*`` self-time
                  (serialization + socket + peer queue + network)
  dispatch        the ``q_wait`` tag on ``handle:*`` spans — frame
                  receipt to handler start (the OSD dispatch queue),
                  carved out of the surrounding messenger time
  osd_op          ``handle:*`` self-time after the q_wait carve
                  (PG lock, version stamping, store/RMW glue)
  unattributed    instants covered by no name this table knows,
                  plus any clock-skew residual
  ==============  ==================================================

Aggregation (``StageAggregator``) keeps online per-stage log2
histograms — the same bucket scheme ``PerfCounters.add_histogram``
uses — so the cluster-wide ``telemetry latency`` verb can report
per-stage p50/p99 and critical-path share without retaining folds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# every stage a fold can charge (mirrored by the ``obs.latency``
# family in common/counters.py; the port's parity tests pin the two)
STAGES: Tuple[str, ...] = ("client", "messenger", "dispatch",
                           "osd_op", "encode", "wal", "fanout",
                           "unattributed")

UNATTRIBUTED = "unattributed"


def stage_of(name: Optional[str]) -> Optional[str]:
    """Stage for one span name; None when the table cannot place it
    (the fold then charges ``unattributed``)."""
    if not name:
        return None
    if name.startswith("client."):
        return "client"
    if name == "call:shard_write":
        return "fanout"
    if name == "ec.encode":
        return "encode"
    if name == "store.commit":
        return "wal"
    if name.startswith(("call:", "send:")):
        return "messenger"
    if name.startswith("handle:"):
        return "osd_op"
    return None


def _interval(span: Dict) -> Optional[Tuple[float, float]]:
    start = span.get("start")
    dur = span.get("duration")
    if not isinstance(start, (int, float)) or \
            not isinstance(dur, (int, float)) or dur < 0:
        return None
    return float(start), float(start) + float(dur)


def fold_tree(root: Dict) -> Optional[Dict]:
    """Fold one reassembled trace tree (a ``telemetry.trace_tree``
    node: span dict + ``children`` list) into a per-stage breakdown.

    Returns ``{"trace_id", "root", "total", "stages": {stage: s}}``
    with ``sum(stages.values()) == total`` (to float rounding), or
    None for a root with no usable timing."""
    ri = _interval(root)
    if ri is None or not root.get("finished", True):
        return None
    r0, r1 = ri
    total = r1 - r0
    stages: Dict[str, float] = {s: 0.0 for s in STAGES}
    if total <= 0:
        return {"trace_id": root.get("trace_id"),
                "root": root.get("name"), "total": 0.0,
                "stages": stages}

    # flatten to (depth, clip0, clip1, span); clipping to the root
    # interval bounds cross-daemon clock skew
    flat: List[Tuple[int, float, float, Dict]] = []

    def walk(node: Dict, depth: int) -> None:
        iv = _interval(node)
        if iv is not None:
            a, b = max(iv[0], r0), min(iv[1], r1)
            if b > a:
                flat.append((depth, a, b, node))
        for child in node.get("children", []):
            walk(child, depth + 1)

    walk(root, 0)

    # elementary segments between all span boundaries: each is charged
    # to the DEEPEST covering span (ties break toward the later
    # start — parallel siblings at equal depth share a stage anyway)
    bounds = sorted({t for _d, a, b, _s in flat for t in (a, b)})
    q_wait_total = 0.0
    for seg0, seg1 in zip(bounds, bounds[1:]):
        mid = (seg0 + seg1) / 2
        best = None
        for depth, a, b, span in flat:
            if a <= mid < b and (best is None or depth >= best[0]):
                best = (depth, span)
        st = stage_of(best[1].get("name")) if best else None
        stages[st if st in STAGES else UNATTRIBUTED] += seg1 - seg0

    # the dispatch-queue carve: handle spans tag the frame-receipt ->
    # handler-start wait (q_wait), which wall-clock-wise sits inside
    # the caller's messenger time.  Move it (bounded by what the
    # messenger stage actually holds — parallel fan-out q_waits can
    # overlap) so queueing is visible as its own stage.
    for _d, _a, _b, span in flat:
        name = span.get("name") or ""
        if name.startswith("handle:"):
            qw = (span.get("tags") or {}).get("q_wait")
            if isinstance(qw, (int, float)) and qw > 0:
                q_wait_total += float(qw)
    moved = min(q_wait_total, stages["messenger"])
    stages["messenger"] -= moved
    stages["dispatch"] += moved

    # float-rounding residual (the charge loop covers the root
    # interval exactly, so this is noise-scale) lands explicit
    residual = total - sum(stages.values())
    if residual > 0:
        stages[UNATTRIBUTED] += residual
    return {"trace_id": root.get("trace_id"),
            "root": root.get("name"), "total": total,
            "stages": stages}


def fold_spans(spans: Iterable[Dict],
               root_prefix: str = "client.") -> List[Dict]:
    """Group a flat span list (any number of daemons) by trace, parent
    into trees, and fold every finished root whose name matches
    ``root_prefix``.  Self-contained (no telemetry import) so the
    bench worker can fold in-process."""
    by_trace: Dict[str, List[Dict]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(s)
    out: List[Dict] = []
    for tid, mine in by_trace.items():
        index: Dict[str, Dict] = {}
        for s in mine:
            index.setdefault(s["span_id"], dict(s, children=[]))
        roots: List[Dict] = []
        for node in index.values():
            parent = node.get("parent_id")
            if parent and parent in index:
                index[parent]["children"].append(node)
            else:
                roots.append(node)
        for root in roots:
            name = root.get("name") or ""
            if not name.startswith(root_prefix):
                continue
            if not root.get("finished", True):
                continue
            fold = fold_tree(root)
            if fold is not None:
                out.append(fold)
    return out


class _LogHist:
    """Online log2 histogram over seconds — the
    ``PerfCounters.add_histogram`` bucket scheme (bucket 0 holds
    values <= min, bucket i holds (min*2^(i-1), min*2^i]) kept as a
    plain value object so aggregation needs no counter registry."""

    __slots__ = ("buckets", "lo", "count", "total")

    def __init__(self, buckets: int = 32, min_value: float = 1e-6):
        self.buckets = [0] * buckets
        self.lo = float(min_value)
        self.count = 0
        self.total = 0.0

    def add(self, value: float) -> None:
        import math

        if value <= self.lo:
            bucket = 0
        else:
            bucket = min(len(self.buckets) - 1,
                         1 + int(math.floor(math.log2(value /
                                                      self.lo))))
        self.buckets[bucket] += 1
        self.count += 1
        self.total += value

    def quantile(self, q: float) -> float:
        """Estimated value at quantile ``q`` (0..1): linear
        interpolation inside the covering log2 bucket."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, n in enumerate(self.buckets):
            if n == 0:
                continue
            if cum + n >= target:
                lo = 0.0 if i == 0 else self.lo * (2.0 ** (i - 1))
                hi = self.lo * (2.0 ** i) if i else self.lo
                frac = (target - cum) / n
                return lo + frac * (hi - lo)
            cum += n
        return self.lo * (2.0 ** (len(self.buckets) - 1))

    def dump(self) -> Dict:
        return {"buckets": list(self.buckets), "min": self.lo}


class StageAggregator:
    """Online cluster-wide aggregation of folds: per-stage log2
    histograms + totals, rendered as the ``latency`` verb's report."""

    def __init__(self):
        self.hists: Dict[str, _LogHist] = {s: _LogHist()
                                           for s in STAGES}
        self.total_hist = _LogHist()
        self.n_ops = 0

    def add(self, fold: Dict) -> None:
        self.n_ops += 1
        self.total_hist.add(fold["total"])
        for stage, secs in fold["stages"].items():
            if secs > 0 and stage in self.hists:
                self.hists[stage].add(secs)

    def report(self) -> Dict:
        """{"n_ops", "total": {...}, "stages": {stage: {count,
        total_s, share, p50_ms, p99_ms}}} — ``share`` is the stage's
        fraction of all attributed wall-clock (the critical-path
        share)."""
        grand = self.total_hist.total or 1e-12
        stages: Dict[str, Dict] = {}
        for stage in STAGES:
            h = self.hists[stage]
            stages[stage] = {
                "count": h.count,
                "total_s": round(h.total, 6),
                "share": round(h.total / grand, 4),
                "p50_ms": round(h.quantile(0.50) * 1e3, 3),
                "p99_ms": round(h.quantile(0.99) * 1e3, 3),
            }
        return {
            "n_ops": self.n_ops,
            "total": {
                "total_s": round(self.total_hist.total, 6),
                "p50_ms": round(self.total_hist.quantile(0.5) * 1e3,
                                3),
                "p99_ms": round(self.total_hist.quantile(0.99) * 1e3,
                                3),
            },
            "stages": stages,
        }


def render_report(report: Dict) -> str:
    """The ``ceph_cli latency`` table: one row per stage, ordered by
    share, with the op-level p50/p99 header."""
    tot = report.get("total", {})
    lines = [f"latency attribution over {report.get('n_ops', 0)} ops "
             f"(op p50 {tot.get('p50_ms', 0.0)} ms, "
             f"p99 {tot.get('p99_ms', 0.0)} ms)",
             f"{'stage':<14}{'share':>8}{'total_s':>10}"
             f"{'p50_ms':>9}{'p99_ms':>9}{'count':>7}"]
    rows = sorted((report.get("stages") or {}).items(),
                  key=lambda kv: kv[1].get("share", 0.0),
                  reverse=True)
    for stage, row in rows:
        lines.append(f"{stage:<14}{row.get('share', 0.0):>8.1%}"
                     f"{row.get('total_s', 0.0):>10.4f}"
                     f"{row.get('p50_ms', 0.0):>9.3f}"
                     f"{row.get('p99_ms', 0.0):>9.3f}"
                     f"{row.get('count', 0):>7d}")
    return "\n".join(lines)
