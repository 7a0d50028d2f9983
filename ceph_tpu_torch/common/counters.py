"""Central perf-counter registry — the single source of counter names.

The port's copy of ``ceph_tpu/common/counters.py``.  The reference
declares every counter in one PerfCountersBuilder block per daemon
(src/osd/OSD.cc:3260 osd_counters, src/mon/Monitor.cc mon_counters,
...), so tooling — `ceph daemonperf` column schemas, the mgr
prometheus module — can rely on names that exist.  This module is that
declaration surface: every counter any module of the port books
(``PerfCounters.inc/dec/set/tinc/avg_add/hist_add``) or declares
(``add_u64_counter``/``add_histogram``/...) appears here, keyed by
logger family, and so does every key of ``telemetry.DEFAULT_COLUMNS``.

The families are ``ceph_tpu``'s, plus those only the port books
(``PORT_FAMILIES``): ``device.caches``, the caches of launch plans,
lowered maps and device matrices that a steady state must not rebuild
(``common/device_metrics.py``).

Logger families are matched by prefix: the ``osd`` family covers
``osd.0``, ``osd.1``...; ``client`` covers ``client.admin``; ``msgr``
covers ``msgr.osd.0`` — the instance suffix carries no schema.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

U64 = "u64"
GAUGE = "gauge"
TIME = "time"
AVG = "avg"
HIST = "hist"

# {logger family: {counter name: type}} — the declaration mirror.
REGISTRY: Dict[str, Dict[str, str]] = {
    "mon": {
        "epochs": U64,
        "beats": U64,
        "markdowns": U64,
        "failure_reports": U64,
        "markdowns_dampened": U64,
        "commit_lat": HIST,
        "commit_time": TIME,
        "pg_stat_reports": U64,
        "stale_pgs": GAUGE,
    },
    "osd": {
        "ops_w": U64,
        "ops_r": U64,
        "degraded_reads": U64,
        "recovered_objects": U64,
        "recovery_bytes": U64,
        "map_epochs": U64,
        "pg_stat_beacons": U64,
    },
    "client": {
        "ops_put": U64,
        "ops_get": U64,
        "ops_write": U64,
        "ops_delete": U64,
        "op_errors": U64,
        "ops_aio_put": U64,
        "ops_aio_write": U64,
        "op_lat": HIST,
        "op_time": TIME,
        "aio_depth": HIST,
    },
    "msgr": {
        "bytes_in": U64,
        "bytes_out": U64,
        "frames_in": U64,
        "frames_out": U64,
        "dispatch_lat": HIST,
        "dispatch_time": TIME,
        # the saturation plane: cumulative wall time _send
        # spent pushing frames against socket backpressure, the
        # send-queue depth observed per send, and the dispatch-queue
        # wait + on-wire->dispatch latency split by lane — the
        # "load masquerading as death" meters
        "send_stall_time": TIME,
        "send_stalls": U64,
        "send_queue_depth": HIST,
        "dispatch_wait_ctl": HIST,
        "dispatch_wait_data": HIST,
        "dispatch_lat_ctl": HIST,
        "dispatch_lat_data": HIST,
    },
    "ec.engine": {
        "encode_ops": U64,
        "decode_ops": U64,
        "encode_bytes": U64,
        "decode_bytes": U64,
        "jit_compiles": U64,
        "encode_time": TIME,
        "decode_time": TIME,
        "jit_compile_time": TIME,
        "encode_lat": HIST,
        "decode_lat": HIST,
        "ec_batch_size": HIST,
    },
    "os.wal": {
        "txns": U64,
        "group_commits": U64,
        "group_commit_time": TIME,
        "wal_group_size": HIST,
    },
    "crush.mapper": {
        "map_calls": U64,
        "xs_mapped": U64,
        "jit_compiles": U64,
        "map_time": TIME,
        "jit_compile_time": TIME,
        "map_lat": HIST,
    },
    "crush.scalar": {
        "pg_lookups": U64,
        "cache_hits": U64,
        "map_time": TIME,
        "map_lat": HIST,
    },
    # the fault-injection plane (analysis/faults.py): one firing
    # counter per failpoint, booked process-globally so a chaos soak
    # can assert every armed fault actually fired (the names mirror
    # analysis.faults.FAILPOINTS — keep the two tables in sync)
    "faults": {
        "msgr.drop_frame": U64,
        "msgr.delay_frame": U64,
        "msgr.dup_frame": U64,
        "msgr.corrupt_frame": U64,
        "msgr.close_mid_frame": U64,
        "msgr.stall_dispatch": U64,
        "os.read_eio": U64,
        "os.fsync_eio": U64,
        "os.torn_append": U64,
        "osd.kill_before_commit": U64,
        "osd.kill_after_commit": U64,
        "osd.slow_op": U64,
        "osd.shard_read_eio": U64,
        "mon.drop_pg_stats": U64,
        "mon.isolate_rank": U64,
        "net.partition": U64,
        "mgr.balancer.stale_map": U64,
        "store.bit_rot": U64,
    },
    # the peer-heartbeat plane (services/heartbeat.py, the
    # OSD::heartbeat role): ping/ack volume, failure reports sent to
    # the mon, the live peer-set gauge, and ping RTT (whose windowed
    # average is the daemonperf `hb lat` column)
    "osd.hb": {
        "pings": U64,
        "acks": U64,
        "failures_reported": U64,
        "peers": GAUGE,
        "ping_time": TIME,
        "ping_lat": HIST,
    },
    # the recovery engine (osd_service._run_recovery): pipeline shape,
    # helper-read fan-out and exclusion accounting, reservation
    # back-pressure, and the per-unit repair-strategy choice with the
    # helper bytes the bandwidth-aware strategies saved over a full
    # k-shard decode
    "osd.recovery": {
        "pipelined_batches": U64,
        "serial_batches": U64,
        "helper_reads": U64,
        "helper_bytes": U64,
        "helper_bytes_saved": U64,
        "helper_eio_excluded": U64,
        "replans": U64,
        "strategy_full": U64,
        "strategy_lrc": U64,
        "strategy_clay": U64,
        "reservation_waits": U64,
        "remote_denials": U64,
    },
    # the manager daemon + module plane (mgr/): scheduler
    # accounting plus the balancer loop's round/proposal counters and
    # its live balance gauges (deviation stddev, distribution score)
    "mgr": {
        "ticks": U64,
        "module_runs": U64,
        "module_errors": U64,
        "balancer_rounds": U64,
        "balancer_upmaps_proposed": U64,
        "balancer_sweep_launches": U64,
        "balancer_paused": U64,
        "balancer_stddev": GAUGE,
        "balancer_score": GAUGE,
    },
    # the device plane (common/device_metrics.py): host<->device
    # transfer volume, kernel launch accounting, and live-buffer /
    # device-memory gauges sampled into the metrics-history ring
    "device": {
        "h2d_bytes": U64,
        "d2h_bytes": U64,
        "kernel_launches": U64,
        "kernel_time": TIME,
        "live_buffers": GAUGE,
        "live_buffer_bytes": GAUGE,
        "live_buffer_bytes_hw": GAUGE,
    },
    # the pooled buffer plane (common/bufpool.py): recv-segment
    # recycling rates, live-segment gauges, and the GC-observed leak
    # count the per-test gate in tests/conftest.py red-checks
    "obs.bufpool": {
        "acquires": U64,
        "releases": U64,
        "pool_hits": U64,
        "pool_misses": U64,
        "leaked_segments": U64,
        "live_segments": GAUGE,
        "live_bytes": GAUGE,
    },
    # the byte-copy ledger (common/copytrack.py): every host-side
    # bytes copy on the hot write path books here, per site plus the
    # cross-site totals the daemonperf cp/op column divides.  Site
    # names mirror copytrack.SITES (the port's parity tests pin the
    # two in sync).
    "obs.copy": {
        "bytes_copied": U64,
        "copies": U64,
        "recv_bytes": U64,
        "recv_copies": U64,
        "send_bytes": U64,
        "send_copies": U64,
        "store_txn_bytes": U64,
        "store_txn_copies": U64,
        "ec_assembly_bytes": U64,
        "ec_assembly_copies": U64,
        "recovery_push_bytes": U64,
        "recovery_push_copies": U64,
    },
    # the critical-path attribution plane (common/attribution.py):
    # one histogram per named stage a folded trace tree can charge
    # time to, plus the explicit residual.  Names mirror
    # attribution.STAGES (the port's parity tests pin the two).
    "obs.latency": {
        "client": HIST,
        "messenger": HIST,
        "dispatch": HIST,
        "osd_op": HIST,
        "encode": HIST,
        "wal": HIST,
        "fanout": HIST,
        "unattributed": HIST,
        "attributed_ops": U64,
    },
    # the data-race checker (analysis/racecheck.py): violation count
    # (normally 0 — the daemonperf `race` column and the --race-audit
    # gate read it) plus registry-size gauges
    "analysis.race": {
        "violations": U64,
        "guarded_classes": GAUGE,
        "guarded_fields": GAUGE,
        "shared_objects": GAUGE,
    },
    # the async-safety checker (analysis/asyncheck.py): callback-
    # budget overruns (normally 0 — the daemonperf `blk` column and
    # thrasher --loop-stall read it) plus contract/scope gauges
    "analysis.block": {
        "overruns": U64,
        "contracts": GAUGE,
        "live_scopes": GAUGE,
    },
    # the port's own: one build of a device cache counted each
    # (common/device_metrics.py CACHES)
    "device.caches": {
        "launch_plans": U64,
        "lowered_maps": U64,
        "matrices": U64,
    },
}

# the families above that ``ceph_tpu`` does not book
PORT_FAMILIES: FrozenSet[str] = frozenset({"device.caches"})


def all_names() -> FrozenSet[str]:
    """Every declared counter name, across all families."""
    out = set()
    for fam in REGISTRY.values():
        out.update(fam)
    return frozenset(out)


def family_of(logger: str) -> str:
    """Registry family for a concrete logger instance name
    (``osd.3`` -> ``osd``, ``msgr.mon`` -> ``msgr``)."""
    candidates = [f for f in REGISTRY
                  if logger == f or logger.startswith(f + ".")]
    return max(candidates, key=len) if candidates else ""


def declared(logger: str, key: str) -> bool:
    fam = family_of(logger)
    return bool(fam) and key in REGISTRY[fam]
