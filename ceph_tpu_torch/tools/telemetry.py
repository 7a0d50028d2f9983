"""telemetry — the cluster-wide observability aggregator.

The port of ``ceph_tpu/tools/telemetry.py``.  Its output is
``ceph_tpu``'s, metric names (``ceph_tpu_*``) included, so a scrape or
dashboard reads either package's cluster alike.

The mgr-prometheus-module + ``ceph daemonperf`` role: poll every
daemon's admin socket (one ``*.asok`` per daemon under the cluster's
asok dir — MiniCluster binds them there automatically), merge each
``perf dump`` / ``dump_tracing`` / ``dump_ops_in_flight`` into one
cluster snapshot, and render it three ways:

- Prometheus text exposition (``prom``): every counter/gauge/time as a
  sample labeled {daemon, logger}; avg pairs as _sum/_count; log2
  latency histograms as cumulative _bucket{le=...} series.
- a ``ceph daemonperf``-style columnar view (``daemonperf``): per-
  daemon per-second rates between two polls.
- cross-daemon trace reassembly (``traces``): spans from every
  daemon's ring buffer grouped by trace_id and re-parented into one
  tree — the client → messenger → primary OSD → EC encode → shard
  fan-out picture of a single op.

- the continuous plane: ``history`` scrapes every daemon's
  ``dump_metrics_history`` ring into one time-aligned cluster series
  (daemonperf-over-time), and ``top`` renders live rate frames with
  cluster totals (the `ceph_cli top` view).

- the profiling plane: ``latency`` folds every completed
  client trace in the snapshot through ``common/attribution.py`` into
  the per-stage critical-path table ("what fraction of write p99 is
  messenger vs fsync vs encode"); ``profile`` broadcasts the
  wallclock sampler's start/stop/dump to every daemon; ``flame``
  merges the per-daemon folded stacks into one cluster flamegraph
  text report.

CLI:
    python -m ceph_tpu_torch.tools.telemetry --asok-dir DIR \
        snapshot | prom | daemonperf [--interval S] [--count N] | \
        traces [--trace-id ID] [--root NAME] | \
        history [--last N] [--json] | top [--interval S] [--count N] \
        | latency [--root NAME] [--json] | flame [--json] | \
        profile --pcmd start|stop|dump
"""

from __future__ import annotations

import argparse
import fnmatch
import glob
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

from ..common.admin_socket import AdminSocket


# -- polling ----------------------------------------------------------

def discover(asok_dir: str) -> Dict[str, str]:
    """{daemon name: socket path} for every *.asok under the dir."""
    out = {}
    for path in sorted(glob.glob(os.path.join(asok_dir, "*.asok"))):
        out[os.path.basename(path)[:-len(".asok")]] = path
    return out


def poll_daemon(path: str, timeout: float = 5.0) -> Optional[Dict]:
    """One daemon's observability payload; None when unreachable (a
    dead daemon must not break the cluster snapshot)."""
    out: Dict = {}
    for key, prefix in (("perf", "perf dump"),
                        ("tracing", "dump_tracing"),
                        ("ops_in_flight", "dump_ops_in_flight"),
                        ("historic_ops", "dump_historic_ops"),
                        ("messenger", "dump_messenger"),
                        ("network", "dump_osd_network")):
        try:
            got = AdminSocket.request(path, prefix, timeout=timeout)
        except (OSError, ValueError):
            if not out:
                return None
            continue
        if isinstance(got, dict) and "error" in got and len(got) <= 2:
            continue  # command not wired on this daemon
        out[key] = got
    return out or None


def cluster_snapshot(asok_dir: Optional[str] = None,
                     paths: Optional[Dict[str, str]] = None,
                     timeout: float = 5.0) -> Dict:
    """Poll every daemon once; unreachable daemons are listed, not
    fatal."""
    assert asok_dir is not None or paths is not None
    targets = dict(paths or {})
    if asok_dir is not None:
        targets = {**discover(asok_dir), **targets}
    daemons, dead = {}, []
    for name, path in sorted(targets.items()):
        got = poll_daemon(path, timeout=timeout)
        if got is None:
            dead.append(name)
        else:
            daemons[name] = got
    return {"ts": time.time(), "daemons": daemons,
            "unreachable": dead}


# -- prometheus text exposition ---------------------------------------

def _sanitize(name: str) -> str:
    """Metric-name charset is [a-zA-Z_:][a-zA-Z0-9_:]* — dotted
    counter names (``ec.engine``-style keys) sanitize to
    underscores, and a leading digit gets a guard underscore."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return "_" + name if re.match(r"^[0-9]", name) else name


def _escape_label(value: str) -> str:
    """Label values are quoted strings with \\, \" and newline
    escaped (the exposition-format grammar) — daemon names are
    user-chosen and must not be able to break a scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def to_prometheus(snapshot: Dict, prefix: str = "ceph_tpu") -> str:
    """Prometheus text exposition.  Counter types survive the wire
    only structurally: plain numbers emit as untyped samples,
    {avgcount, sum} pairs as summary _sum/_count, {buckets, min} log2
    histograms as cumulative _bucket{le=...} + _count (le bounds are
    min * 2^i — bucket 0 is everything <= min).  Each metric FAMILY
    gets exactly one ``# HELP``/``# TYPE`` pair with every sample of
    the family grouped under it (the text-format grammar requirement
    a multi-daemon snapshot used to violate)."""
    fams: Dict[str, Dict] = {}

    def fam(metric: str, ptype: str, key: str) -> List[str]:
        f = fams.get(metric)
        if f is None:
            f = fams[metric] = {
                "type": ptype,
                "help": f"ceph_tpu counter {key}"
                .replace("\\", "").replace("\n", " "),
                "lines": []}
        return f["lines"]

    for daemon, data in sorted(snapshot.get("daemons", {}).items()):
        for logger, counters in sorted((data.get("perf")
                                        or {}).items()):
            if not isinstance(counters, dict):
                continue
            labels = (f'daemon="{_escape_label(daemon)}",'
                      f'logger="{_escape_label(logger)}"')
            for key, val in sorted(counters.items()):
                metric = f"{prefix}_{_sanitize(key)}"
                if isinstance(val, dict) and "buckets" in val:
                    lines = fam(metric, "histogram", key)
                    lo = float(val.get("min", 1.0))
                    cum = 0
                    for i, n in enumerate(val["buckets"]):
                        cum += n
                        lines.append(
                            f'{metric}_bucket{{{labels},'
                            f'le="{lo * (2.0 ** i):.9g}"}} {cum}')
                    lines.append(f'{metric}_bucket{{{labels},'
                                 f'le="+Inf"}} {cum}')
                    lines.append(f"{metric}_count{{{labels}}} {cum}")
                elif isinstance(val, dict) and "avgcount" in val:
                    lines = fam(metric, "summary", key)
                    lines.append(f"{metric}_sum{{{labels}}} "
                                 f"{val.get('sum', 0)}")
                    lines.append(f"{metric}_count{{{labels}}} "
                                 f"{val.get('avgcount', 0)}")
                elif isinstance(val, (int, float)):
                    fam(metric, "untyped", key).append(
                        f"{metric}{{{labels}}} {val}")
    out: List[str] = []
    for metric in sorted(fams):
        f = fams[metric]
        out.append(f"# HELP {metric} {f['help']}")
        out.append(f"# TYPE {metric} {f['type']}")
        out.extend(f["lines"])
    return "\n".join(out) + ("\n" if out else "")


# -- daemonperf (columnar rates between two polls) --------------------

# (logger glob, counter key, column header) — summed over matching
# loggers per daemon, rendered as per-second rates
DEFAULT_COLUMNS: List[Tuple[str, str, str]] = [
    ("msgr.*", "bytes_in", "rx_B/s"),
    ("msgr.*", "bytes_out", "tx_B/s"),
    ("msgr.*", "frames_in", "rxf/s"),
    ("osd.*", "ops_w", "wr/s"),
    ("osd.*", "ops_r", "rd/s"),
    ("client.*", "ops_put", "put/s"),
    ("client.*", "ops_get", "get/s"),
    # the data-plane batching layers: journal txns vs shared
    # fsyncs (their ratio IS the group-commit win), EC dispatches,
    # and the pipelined client window
    ("os.wal", "txns", "waltx/s"),
    ("os.wal", "group_commits", "fsync/s"),
    ("ec.engine", "encode_ops", "ecenc/s"),
    ("client.*", "ops_aio_put", "aput/s"),
    # active recovery: objects rebuilt per second (osd family) next
    # to the client rates they compete with under the QoS plane
    ("osd.*", "recovered_objects", "rec/s"),
    ("mon*", "epochs", "epo/s"),
    ("mgr*", "balancer_rounds", "bal/s"),
    # data-race checker violations/s — nonzero here means a daemon
    # recorded an Eraser lockset/confinement report since the last
    # poll (normally dead-zero; see dump_racecheck for the stacks)
    ("analysis.race", "violations", "race"),
    # async-safety budget overruns/s — nonzero means a @nonblocking
    # dispatch callback blew its wallclock budget since the last poll
    # (normally dead-zero; see dump_asyncheck for both-end stacks)
    ("analysis.block", "overruns", "blk"),
]


def _column_value(perf: Dict, logger_glob: str, key: str) -> float:
    total = 0.0
    for logger, counters in (perf or {}).items():
        if not fnmatch.fnmatch(logger, logger_glob):
            continue
        val = (counters or {}).get(key)
        if isinstance(val, (int, float)):
            total += val
    return total


def _time_value(perf: Dict, logger_glob: str, key: str,
                sub: str = "sum") -> float:
    """Sum a TIME counter across matching loggers.  PerfCounters
    dumps TIME counters as PLAIN floats (the cumulative seconds), so
    a number counts directly as the ``sum``; AVG-style {avgcount,
    sum} dicts contribute the requested field.  (The old dict-only
    version silently read 0.0 for every real TIME counter — the
    daemonperf `hb lat` column was computed from nothing.)"""
    total = 0.0
    for logger, counters in (perf or {}).items():
        if not fnmatch.fnmatch(logger, logger_glob):
            continue
        val = (counters or {}).get(key)
        if isinstance(val, dict):
            total += float(val.get(sub, 0) or 0)
        elif isinstance(val, (int, float)) and sub == "sum":
            total += float(val)
    return total


def _hist_buckets(perf: Dict, logger_glob: str,
                  key: str) -> Tuple[List[float], float]:
    """Summed bucket counts (+ the log2 floor) of a HISTOGRAM counter
    across matching loggers."""
    total: List[float] = []
    lo: Optional[float] = None
    for logger, counters in (perf or {}).items():
        if not fnmatch.fnmatch(logger, logger_glob):
            continue
        val = (counters or {}).get(key)
        if isinstance(val, dict) and "buckets" in val:
            b = val["buckets"]
            if len(b) > len(total):
                total.extend([0.0] * (len(b) - len(total)))
            for i, n in enumerate(b):
                total[i] += n
            if lo is None:
                lo = float(val.get("min", 1e-6))
    return total, (lo if lo is not None else 1e-6)


def hist_quantile(buckets: List[float], min_value: float,
                  q: float) -> float:
    """Upper-edge quantile from a log2 bucket list (bucket 0 holds
    values <= min, bucket i holds (min*2^(i-1), min*2^i]): the bound
    is conservative by at most one octave, which is what a log2
    histogram can honestly promise."""
    n = sum(buckets)
    if n <= 0:
        return 0.0
    target = q * n
    cum = 0.0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= target:
            return min_value * (2.0 ** i)
    return min_value * (2.0 ** max(0, len(buckets) - 1))


def _hist_delta(cperf: Dict, pperf: Dict, glob: str,
                key: str) -> Tuple[List[float], float]:
    """Bucket-wise delta of a histogram between two snapshots."""
    cb, lo = _hist_buckets(cperf, glob, key)
    pb, _lo = _hist_buckets(pperf, glob, key)
    return [c - (pb[i] if i < len(pb) else 0.0)
            for i, c in enumerate(cb)], lo


# op-throughput counters the derived cp/op column divides by —
# every client/OSD op the byte-copy ledger can book against
_OP_COUNTERS: List[Tuple[str, str]] = [
    ("osd.*", "ops_w"), ("osd.*", "ops_r"),
    ("client.*", "ops_put"), ("client.*", "ops_get"),
    ("client.*", "ops_write"), ("client.*", "ops_delete"),
]


def unattr_shares(snapshot: Dict,
                  root_prefix: str = "client.") -> Dict[str, float]:
    """Per-daemon unattributed critical-path share: every completed
    client trace in the snapshot is folded (common/attribution.py)
    and charged to the daemon that reported its ROOT span — only
    clients originate ops, so only client rows get a value."""
    from ..common import attribution

    spans = gather_spans(snapshot)
    root_daemon: Dict[str, str] = {}
    for s in spans:
        if not s.get("parent_id") and \
                (s.get("name") or "").startswith(root_prefix):
            root_daemon.setdefault(s.get("trace_id", ""),
                                   s.get("daemon", "?"))
    totals: Dict[str, List[float]] = {}
    for fold in attribution.fold_spans(spans, root_prefix):
        daemon = root_daemon.get(fold.get("trace_id") or "")
        if daemon is None:
            continue
        acc = totals.setdefault(daemon, [0.0, 0.0])
        acc[0] += fold["stages"].get(attribution.UNATTRIBUTED, 0.0)
        acc[1] += fold["total"]
    return {d: (un / tot if tot > 0 else 0.0)
            for d, (un, tot) in totals.items()}


def daemonperf_view(prev: Dict, cur: Dict,
                    columns: Optional[List[Tuple[str, str, str]]]
                    = None, derived: bool = True) -> str:
    """`ceph daemonperf` analogue: one row per daemon, one column per
    (logger glob, key), values are deltas/second between the two
    snapshots.

    ``derived`` appends computed columns: ``cp/op`` (delta obs.copy
    bytes_copied / delta ops — host bytes copied per op) and
    ``unattr%`` (the unattributed critical-path share of the daemon's
    completed traces) from the observability families; ``hb
    lat`` — the mean peer ping RTT in ms over the window (delta
    osd.hb ping_time sum / delta acks), the live view of the failure
    detector's latency EWMA input; and the saturation pair:
    ``stall%`` (share of the window spent in send stall against
    socket backpressure) and ``dq p99`` (dispatch-queue wait p99 in
    ms over the window, both lanes)."""
    columns = columns or DEFAULT_COLUMNS
    dt = max(1e-9, cur.get("ts", 0) - prev.get("ts", 0))
    headers = [h for _g, _k, h in columns]
    if derived:
        headers = headers + ["cp/op", "unattr%", "hb lat",
                             "stall%", "dq p99"]
    width = max(8, *(len(h) + 1 for h in headers))
    name_w = max([len("daemon")] +
                 [len(d) for d in cur.get("daemons", {})]) + 1
    lines = ["daemon".ljust(name_w)
             + "".join(h.rjust(width) for h in headers)]
    unattr = unattr_shares(cur) if derived else {}
    for daemon in sorted(cur.get("daemons", {})):
        cperf = cur["daemons"][daemon].get("perf") or {}
        pperf = (prev.get("daemons", {}).get(daemon, {})
                 .get("perf")) or {}
        cells = []
        for lg, key, _h in columns:
            rate = (_column_value(cperf, lg, key)
                    - _column_value(pperf, lg, key)) / dt
            cells.append(f"{rate:.1f}".rjust(width))
        if derived:
            d_copied = (_column_value(cperf, "obs.copy",
                                      "bytes_copied")
                        - _column_value(pperf, "obs.copy",
                                        "bytes_copied"))
            d_ops = sum(_column_value(cperf, lg, key)
                        - _column_value(pperf, lg, key)
                        for lg, key in _OP_COUNTERS)
            cells.append((f"{d_copied / d_ops:.0f}" if d_ops > 0
                          else "-").rjust(width))
            cells.append((f"{unattr[daemon]:.1%}"
                          if daemon in unattr else "-").rjust(width))
            d_rtt = (_time_value(cperf, "osd.hb.*", "ping_time",
                                 "sum")
                     - _time_value(pperf, "osd.hb.*", "ping_time",
                                   "sum"))
            d_acks = (_column_value(cperf, "osd.hb.*", "acks")
                      - _column_value(pperf, "osd.hb.*", "acks"))
            cells.append((f"{d_rtt / d_acks * 1000:.1f}"
                          if d_acks > 0 else "-").rjust(width))
            d_stall = (_time_value(cperf, "msgr.*",
                                   "send_stall_time")
                       - _time_value(pperf, "msgr.*",
                                     "send_stall_time"))
            cells.append(f"{max(0.0, d_stall) / dt:.1%}"
                         .rjust(width))
            wb_c, w_lo = _hist_delta(cperf, pperf, "msgr.*",
                                     "dispatch_wait_ctl")
            wb_d, _ = _hist_delta(cperf, pperf, "msgr.*",
                                  "dispatch_wait_data")
            if len(wb_c) < len(wb_d):
                wb_c.extend([0.0] * (len(wb_d) - len(wb_c)))
            merged = [a + (wb_d[i] if i < len(wb_d) else 0.0)
                      for i, a in enumerate(wb_c)]
            cells.append((f"{1e3 * hist_quantile(merged, w_lo, 0.99):.1f}"
                          if sum(merged) > 0 else "-").rjust(width))
        lines.append(daemon.ljust(name_w) + "".join(cells))
    return "\n".join(lines)


# -- the saturation plane (telemetry net) ------------------------------

def net_summary(cur: Dict, prev: Optional[Dict] = None,
                dt: Optional[float] = None) -> Dict:
    """Cluster messenger-saturation roll-up between two snapshots
    (``prev=None`` with an explicit ``dt`` treats ``cur``'s cumulative
    counters as the whole-run delta — how the bench commits its
    ``net.*`` trajectory columns).

    Per daemon: send-stall share (seconds stalled against socket
    backpressure per wall second), dispatch wait/latency p99 (data
    lane), and per-lane dispatch rates.  Cluster: the same folded
    across daemons, plus the worst heartbeat-RTT peers from any
    ``dump_osd_network`` payloads in the snapshot."""
    if dt is None:
        dt = max(1e-9, cur.get("ts", 0)
                 - (prev or {}).get("ts", 0))
    prev_daemons = (prev or {}).get("daemons", {})
    per: Dict[str, Dict] = {}
    tot_stall = 0.0
    all_lat: List[float] = []
    all_lo = 1e-6
    slow_peers: List[Dict] = []
    for daemon, data in sorted(cur.get("daemons", {}).items()):
        cperf = data.get("perf") or {}
        pperf = (prev_daemons.get(daemon, {}).get("perf")) or {}
        stall = (_time_value(cperf, "msgr.*", "send_stall_time")
                 - _time_value(pperf, "msgr.*", "send_stall_time"))
        wait_b, wait_lo = _hist_delta(cperf, pperf, "msgr.*",
                                      "dispatch_wait_data")
        lat_b, lat_lo = _hist_delta(cperf, pperf, "msgr.*",
                                    "dispatch_lat_data")
        ctl_b, _ = _hist_delta(cperf, pperf, "msgr.*",
                               "dispatch_lat_ctl")
        per[daemon] = {
            "send_stall_s": round(max(0.0, stall), 6),
            "send_stall_share": round(max(0.0, stall) / dt, 6),
            "dispatch_wait_p99_ms": round(
                1e3 * hist_quantile(wait_b, wait_lo, 0.99), 3),
            "dispatch_p99_ms": round(
                1e3 * hist_quantile(lat_b, lat_lo, 0.99), 3),
            "ctl_per_s": round(sum(ctl_b) / dt, 1),
            "data_per_s": round(sum(lat_b) / dt, 1),
        }
        tot_stall += max(0.0, stall)
        if len(lat_b) > len(all_lat):
            all_lat.extend([0.0] * (len(lat_b) - len(all_lat)))
        for i, n in enumerate(lat_b):
            all_lat[i] += n
        all_lo = lat_lo
        net = data.get("network")
        if isinstance(net, dict):
            for e in net.get("entries", []):
                slow_peers.append({
                    "daemon": daemon, "peer": e.get("peer"),
                    "worst_ms": e.get("worst_ms", 0.0)})
    slow_peers.sort(key=lambda e: e["worst_ms"], reverse=True)
    n_daemons = max(1, len(per))
    return {
        "dt_s": round(dt, 3),
        "send_stall_s": round(tot_stall, 6),
        # stall share normalized per daemon: 1.0 would mean every
        # daemon spent every wall second pushing against a full
        # socket buffer
        "send_stall_share": round(tot_stall / (dt * n_daemons), 6),
        "dispatch_p99_ms": round(
            1e3 * hist_quantile(all_lat, all_lo, 0.99), 3),
        "per_daemon": per,
        "slow_peers": slow_peers[:16],
    }


def net_view(cur: Dict, prev: Optional[Dict] = None,
             dt: Optional[float] = None) -> str:
    """Render net_summary as the `telemetry net` table."""
    s = net_summary(cur, prev=prev, dt=dt)
    headers = ("stall%", "dq p99", "lat p99", "ctl/s", "data/s")
    width = max(9, *(len(h) + 1 for h in headers))
    name_w = max([len("daemon")] + [len(d) for d in s["per_daemon"]]
                 ) + 1
    lines = [f"net saturation over {s['dt_s']}s — cluster stall "
             f"share {s['send_stall_share']:.2%}, dispatch p99 "
             f"{s['dispatch_p99_ms']:.2f}ms",
             "daemon".ljust(name_w)
             + "".join(h.rjust(width) for h in headers)]
    for daemon, row in sorted(
            s["per_daemon"].items(),
            key=lambda kv: kv[1]["send_stall_share"], reverse=True):
        lines.append(
            daemon.ljust(name_w)
            + f"{row['send_stall_share']:.2%}".rjust(width)
            + f"{row['dispatch_wait_p99_ms']:.2f}".rjust(width)
            + f"{row['dispatch_p99_ms']:.2f}".rjust(width)
            + f"{row['ctl_per_s']:.1f}".rjust(width)
            + f"{row['data_per_s']:.1f}".rjust(width))
    if s["slow_peers"]:
        worst = ", ".join(
            f"{e['daemon']}->osd.{e['peer']} {e['worst_ms']:.0f}ms"
            for e in s["slow_peers"][:8])
        lines.append(f"slow heartbeat peers (worst first): {worst}")
    return "\n".join(lines)


# -- metrics history (daemonperf-over-time) ---------------------------

def gather_history(asok_dir: Optional[str] = None,
                   paths: Optional[Dict[str, str]] = None,
                   timeout: float = 5.0,
                   last: Optional[int] = None) -> Dict[str, Dict]:
    """Scrape every daemon's ``dump_metrics_history`` ring; daemons
    without the command (or unreachable) are skipped, not fatal."""
    assert asok_dir is not None or paths is not None
    targets = dict(paths or {})
    if asok_dir is not None:
        targets = {**discover(asok_dir), **targets}
    out: Dict[str, Dict] = {}
    for name, path in sorted(targets.items()):
        args = {"last": last} if last else {}
        try:
            got = AdminSocket.request(path, "dump_metrics_history",
                                      timeout=timeout, **args)
        except (OSError, ValueError):
            continue
        if isinstance(got, dict) and "samples" in got:
            out[name] = got
    return out


def history_view(histories: Dict[str, Dict],
                 columns: Optional[List[Tuple[str, str, str]]] = None,
                 bucket_s: float = 1.0) -> str:
    """The time-aligned cluster series: every daemon's ring merged
    into one table — rows are time buckets, columns are the
    daemonperf rate columns summed across daemons (daemonperf over
    time)."""
    columns = columns or DEFAULT_COLUMNS
    headers = [h for _g, _k, h in columns]
    buckets: Dict[float, Dict[str, float]] = {}
    for _daemon, hist in sorted(histories.items()):
        samples = hist.get("samples", [])
        for a, b in zip(samples, samples[1:]):
            dt = max(1e-9, b.get("mono", 0) - a.get("mono", 0))
            bucket = round(b.get("ts", 0) / bucket_s) * bucket_s
            row = buckets.setdefault(bucket,
                                     {h: 0.0 for h in headers})
            for lg, key, hdr in columns:
                delta = (_column_value(b.get("perf", {}), lg, key)
                         - _column_value(a.get("perf", {}), lg, key))
                row[hdr] += max(0.0, delta) / dt
    width = max(8, *(len(h) + 1 for h in headers))
    lines = ["time".ljust(9)
             + "".join(h.rjust(width) for h in headers)]
    for ts in sorted(buckets):
        stamp = time.strftime("%H:%M:%S", time.localtime(ts))
        lines.append(stamp.ljust(9) + "".join(
            f"{buckets[ts][h]:.1f}".rjust(width) for h in headers))
    return "\n".join(lines)


def top_view(prev: Dict, cur: Dict) -> str:
    """One `ceph_cli top` frame: cluster totals header + the
    daemonperf rate table between the two snapshots."""
    daemons = cur.get("daemons", {})
    inflight = 0
    for data in daemons.values():
        ops = data.get("ops_in_flight") or {}
        inflight += int(ops.get("num_ops", 0) or 0)
    stamp = time.strftime("%H:%M:%S",
                          time.localtime(cur.get("ts", 0)))
    head = (f"ceph-tpu top — {stamp}  daemons: {len(daemons)}"
            f"  unreachable: {len(cur.get('unreachable', []))}"
            f"  ops in flight: {inflight}")
    return head + "\n\n" + daemonperf_view(prev, cur)


# -- cross-daemon trace reassembly ------------------------------------

def gather_spans(snapshot: Dict,
                 extra: Optional[List[Dict]] = None) -> List[Dict]:
    """Every span in the snapshot (finished + active), stamped with
    the daemon that reported it."""
    spans: List[Dict] = []
    for daemon, data in snapshot.get("daemons", {}).items():
        tr = data.get("tracing") or {}
        for s in list(tr.get("spans", [])) + list(tr.get("active",
                                                         [])):
            spans.append(dict(s, daemon=daemon))
    for s in extra or []:
        spans.append(dict(s))
    return spans


def find_trace_ids(spans: List[Dict],
                   root_name: Optional[str] = None) -> List[str]:
    """trace_ids that have a ROOT span (optionally named), newest
    first."""
    roots = [s for s in spans if not s.get("parent_id")
             and (root_name is None or s.get("name") == root_name)]
    roots.sort(key=lambda s: s.get("start", 0), reverse=True)
    out: List[str] = []
    for s in roots:
        if s["trace_id"] not in out:
            out.append(s["trace_id"])
    return out


def trace_tree(spans: List[Dict], trace_id: str) -> List[Dict]:
    """Re-parent one trace's spans (from any number of daemons) into
    a forest: nodes are span dicts with a ``children`` list; spans
    whose parent was not reported (sampled out, ring-evicted, daemon
    unreachable) surface as extra roots rather than vanishing."""
    mine = [s for s in spans if s.get("trace_id") == trace_id]
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

    def order(nodes: List[Dict]) -> None:
        nodes.sort(key=lambda n: n.get("start", 0))
        for n in nodes:
            order(n["children"])

    order(roots)
    return roots


def render_trace(roots: List[Dict]) -> str:
    lines: List[str] = []

    def walk(node: Dict, depth: int) -> None:
        dur = node.get("duration")
        dur_s = f"{dur * 1000:.2f}ms" if isinstance(
            dur, (int, float)) else "?"
        svc = node.get("daemon") or node.get("service", "?")
        tags = node.get("tags") or {}
        tag_s = (" " + json.dumps(tags, sort_keys=True)
                 ) if tags else ""
        lines.append(f"{'  ' * depth}{svc}: {node.get('name')} "
                     f"{dur_s}{tag_s}")
        for child in node["children"]:
            walk(child, depth + 1)

    for root in roots:
        walk(root, 0)
    return "\n".join(lines)


# -- critical-path latency attribution ---------------------------------

def latency_report(snapshot: Dict,
                   root_prefix: str = "client.") -> Dict:
    """Fold every completed client trace in the snapshot into the
    cluster-wide per-stage attribution report
    (common/attribution.py): {"n_ops", "total", "stages"}."""
    from ..common import attribution

    folds = attribution.fold_spans(gather_spans(snapshot),
                                   root_prefix)
    agg = attribution.StageAggregator()
    for f in folds:
        agg.add(f)
    return agg.report()


# -- wallclock profiler plane ------------------------------------------

def gather_profiles(asok_dir: Optional[str] = None,
                    paths: Optional[Dict[str, str]] = None,
                    timeout: float = 5.0,
                    cmd: str = "dump") -> Dict[str, Dict]:
    """Broadcast one ``profile`` admin command (start|stop|dump) to
    every daemon; unreachable daemons and daemons without the command
    are skipped, not fatal."""
    assert asok_dir is not None or paths is not None
    targets = dict(paths or {})
    if asok_dir is not None:
        targets = {**discover(asok_dir), **targets}
    out: Dict[str, Dict] = {}
    for name, path in sorted(targets.items()):
        try:
            got = AdminSocket.request(path, "profile",
                                      timeout=timeout, cmd=cmd)
        except (OSError, ValueError):
            continue
        if isinstance(got, dict) and "error" not in got:
            out[name] = got
    return out


def flame_view(asok_dir: Optional[str] = None,
               paths: Optional[Dict[str, str]] = None) -> str:
    """The merged cluster flamegraph text report: every daemon's
    folded stacks, keyed ``daemon/role;frames``."""
    from ..common.profiler import merge_folded, render_flame

    dumps = gather_profiles(asok_dir, paths)
    return render_flame(merge_folded(dumps))


def span_names(roots: List[Dict]) -> List[str]:
    """Flat preorder list of span names (test/assertion helper)."""
    out: List[str] = []

    def walk(node: Dict) -> None:
        out.append(node.get("name"))
        for child in node["children"]:
            walk(child)

    for root in roots:
        walk(root)
    return out


# -- CLI --------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="telemetry")
    ap.add_argument("--asok-dir", required=True,
                    help="directory of daemon *.asok sockets")
    ap.add_argument("cmd", choices=("snapshot", "prom", "traces",
                                    "daemonperf", "history", "top",
                                    "latency", "flame", "profile",
                                    "net"))
    ap.add_argument("--trace-id", help="traces: reassemble this id")
    ap.add_argument("--root",
                    help="traces: only traces whose root span has "
                         "this name")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="daemonperf/top: seconds between polls")
    ap.add_argument("--count", type=int, default=1,
                    help="daemonperf/top: frames to print")
    ap.add_argument("--last", type=int, default=None,
                    help="history: samples per daemon (default all)")
    ap.add_argument("--json", action="store_true",
                    help="history/latency/flame: raw JSON output")
    ap.add_argument("--pcmd", choices=("start", "stop", "dump"),
                    default="dump",
                    help="profile: subcommand broadcast to daemons")
    args = ap.parse_args(argv)

    if args.cmd == "profile":
        acks = gather_profiles(args.asok_dir, cmd=args.pcmd)
        if not acks:
            print(f"no profiler-capable daemons under "
                  f"{args.asok_dir}", file=sys.stderr)
            return 1
        print(json.dumps(acks, indent=1, default=str))
        return 0
    if args.cmd == "flame":
        if args.json:
            print(json.dumps(gather_profiles(args.asok_dir),
                             indent=1, default=str))
        else:
            print(flame_view(args.asok_dir))
        return 0

    if args.cmd == "history":
        hist = gather_history(args.asok_dir, last=args.last)
        if not hist:
            print(f"no metrics history under {args.asok_dir} "
                  f"(metrics_history_interval disabled?)",
                  file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(hist, indent=1, default=str))
        else:
            print(history_view(hist))
        return 0
    if args.cmd == "top":
        prev = cluster_snapshot(args.asok_dir)
        if not prev["daemons"]:
            print(f"no reachable daemons under {args.asok_dir}",
                  file=sys.stderr)
            return 1
        for i in range(max(1, args.count)):
            time.sleep(args.interval)
            cur = cluster_snapshot(args.asok_dir)
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(top_view(prev, cur))
            prev = cur
        return 0

    snap = cluster_snapshot(args.asok_dir)
    if not snap["daemons"]:
        print(f"no reachable daemons under {args.asok_dir}",
              file=sys.stderr)
        return 1
    if args.cmd == "snapshot":
        print(json.dumps(snap, indent=1, default=str))
    elif args.cmd == "latency":
        from ..common import attribution

        report = latency_report(
            snap, root_prefix=(args.root or "client."))
        if args.json:
            print(json.dumps(report, indent=1, default=str))
        elif report["n_ops"] == 0:
            print("no completed client traces in the snapshot "
                  "(trace_sample_rate 0, or ring evicted?)",
                  file=sys.stderr)
            return 1
        else:
            print(attribution.render_report(report))
    elif args.cmd == "prom":
        sys.stdout.write(to_prometheus(snap))
    elif args.cmd == "traces":
        spans = gather_spans(snap)
        ids = [args.trace_id] if args.trace_id else \
            find_trace_ids(spans, args.root)
        if not ids:
            print("no traces found", file=sys.stderr)
            return 1
        for tid in ids:
            print(f"trace {tid}:")
            print(render_trace(trace_tree(spans, tid)))
    elif args.cmd == "daemonperf":
        prev = snap
        for _ in range(max(1, args.count)):
            time.sleep(args.interval)
            cur = cluster_snapshot(args.asok_dir)
            print(daemonperf_view(prev, cur))
            prev = cur
    elif args.cmd == "net":
        prev = snap
        for _ in range(max(1, args.count)):
            time.sleep(args.interval)
            cur = cluster_snapshot(args.asok_dir)
            if args.json:
                print(json.dumps(net_summary(cur, prev=prev),
                                 indent=1, default=str))
            else:
                print(net_view(cur, prev=prev))
            prev = cur
    return 0


if __name__ == "__main__":
    sys.exit(main())
