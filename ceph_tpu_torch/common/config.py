"""The config system — option schema, layered sources, observers.

The port's copy of ``ceph_tpu/common/config.py``.

The role of the reference's ``md_config_t`` / ``ConfigProxy``
(src/common/config.h) with options declared in YAML and compiled to
``Option`` structs (src/common/options/*.yaml.in via options/y2c.py):
here the schema is declared in Python (``Option`` dataclass +
``OPTIONS`` table) — same information, no codegen step.

Layering (lowest to highest precedence, config.h semantics):
  compiled default < config file < environment < runtime ``set()``.

Runtime changes notify registered observers (config_obs.h), which is
how long-lived services pick up reweights/debug levels without
restart.  ``show()`` is the ``ceph daemon ... config show`` payload.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

ENV_PREFIX = "CEPH_TPU_OPT_"


@dataclass
class Option:
    """One declared option (src/common/options.h:14)."""

    name: str
    type_: type
    default: Any
    desc: str = ""
    level: str = "advanced"  # basic | advanced | dev

    def coerce(self, value: Any) -> Any:
        if self.type_ is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return self.type_(value)


def _opts(*options: Option) -> Dict[str, Option]:
    return {o.name: o for o in options}


# the framework's option schema — the global.yaml.in/osd.yaml.in role
OPTIONS: Dict[str, Option] = _opts(
    Option("debug_crush", int, 0, "crush subsystem log level"),
    Option("debug_osd", int, 0, "osd-service subsystem log level"),
    Option("debug_mon", int, 0, "monitor subsystem log level"),
    Option("debug_ec", int, 0, "erasure-code subsystem log level"),
    Option("log_max_recent", int, 500, "crash ring-buffer entries"),
    Option("osd_pool_default_size", int, 3, "replica count default"),
    Option("osd_pool_default_pg_num", int, 32, "pg count default"),
    Option("osd_heartbeat_interval", float, 0.5,
           "seconds between osd->mon heartbeats"),
    Option("osd_heartbeat_grace", float, 2.0,
           "seconds without heartbeat before mark-down"),
    Option("mon_osd_down_out_interval", float, 5.0,
           "seconds down before an osd is marked out (weight 0), "
           "triggering remap + backfill"),
    Option("mon_osd_report_timeout", float, 0.0,
           "seconds without a DIRECT osd->mon beacon before the "
           "monitor marks an osd down on its own (the liveness-of-"
           "last-resort path; peer failure reports are the primary "
           "detector); 0 = auto (5x osd_heartbeat_grace)"),
    Option("mon_osd_min_down_reporters", int, 2,
           "peer failure reports from this many distinct CRUSH "
           "failure-domain subtrees before the monitor marks an osd "
           "down (OSDMonitor::check_failure role)"),
    Option("mon_osd_reporter_subtree_level", str, "host",
           "CRUSH bucket type at which failure reporters are "
           "deduplicated: reports from osds under the same subtree "
           "of this type count as ONE reporter"),
    Option("osd_op_complaint_time", float, 0.5,
           "seconds an op may stay in flight before it is a SLOW op: "
           "the OpTracker historic-slow threshold AND the count the "
           "osd's beacon reports for the monitor's SLOW_OPS health "
           "check (one knob, both consumers)"),
    Option("osd_heartbeat_ping_threshold_ms", float, 1000.0,
           "heartbeat RTT window average (1/5/15 min) above this "
           "raises OSD_SLOW_PING_TIME and makes the peer visible in "
           "dump_osd_network (mon_warn_on_slow_ping_time role); also "
           "the default dump_osd_network filter threshold"),
    Option("osd_heartbeat_min_peers", int, 4,
           "pad the PG-derived heartbeat peer set with other up osds "
           "until it reaches this size, so sparse PG overlap (small "
           "pools, pool-less clusters) still yields enough failure "
           "reporters for the monitor's quorum"),
    Option("osd_max_markdown_count", int, 5,
           "markdowns within osd_max_markdown_period before the osd "
           "is dampened: re-boots deferred + auto-out, surfaced as "
           "the OSD_FLAPPING health check (osd_markdown_log role)"),
    Option("osd_max_markdown_period", float, 600.0,
           "sliding window (seconds) for osd_max_markdown_count; "
           "dampening clears once the window empties"),
    Option("osd_max_backfills", int, 1,
           "concurrent recovery streams per osd"),
    Option("osd_calc_pg_upmaps_aggressively", bool, True,
           "balancer explores with shuffling and local fallbacks"),
    Option("osd_calc_pg_upmaps_local_fallback_retries", int, 100,
           "balancer local retry budget"),
    Option("osd_erasure_code_plugins", str,
           "jerasure isa lrc shec clay", "plugins loaded at start"),
    Option("mon_max_map_epochs", int, 500,
           "full OSDMap epochs retained by the map store"),
    Option("osd_scrub_interval", float, 300.0,
           "seconds between automatic deep scrubs of each PG "
           "(osd_deep_scrub_interval role); 0 disables"),
    Option("osd_scrub_auto_repair", bool, True,
           "drop shards whose stored crc32c mismatches so recovery "
           "re-decodes them from survivors"),
    Option("mon_lease", float, 0.6,
           "quorum leader lease interval; peons call an election "
           "after 3 missed leases"),
    Option("mon_election_timeout", float, 0.8,
           "base retry window for monitor elections (rank-staggered)"),
    Option("bench_tpu_deadline", float, 300.0,
           "seconds before the bench abandons a hung backend"),
    Option("lockdep", bool, False,
           "runtime lock-order checking (analysis/lockdep.py); the "
           "CEPH_TPU_LOCKDEP env var is the usual switch — this "
           "option mirrors it for config-file-driven runs"),
    Option("asyncheck_loop_budget_ms", float, 50.0,
           "wallclock budget (ms) for one @nonblocking dispatch "
           "callback before the asyncheck enforcer records an "
           "overrun with both-end stacks (analysis/asyncheck.py; "
           "active only under CEPH_TPU_ASYNCHECK=1)"),
    Option("watchdog_threshold", float, 30.0,
           "seconds a lock may stay held or a handler may run before "
           "the stall watchdog dumps all-thread stacks "
           "(analysis/watchdog.py; also the dump_blocked default)"),
    Option("trace_sample_rate", float, 1.0,
           "probability a new trace ROOT is sampled (children inherit "
           "the root's decision, across daemons); unsampled spans "
           "propagate context but are never recorded"),
    Option("trace_ring_size", int, 512,
           "finished spans retained per tracer (the dump_tracing ring "
           "buffer, newest-wins)"),
    Option("admin_socket", bool, True,
           "daemons bind their unix admin socket on start (perf dump, "
           "dump_tracing, dump_ops_in_flight, dump_blocked ... — the "
           "surface the telemetry tool polls)"),
    Option("wal_group_commit_max_delay_us", int, 0,
           "microseconds the WAL group-commit leader waits for more "
           "transactions to join before the shared fsync; 0 = no "
           "artificial delay (the group is whatever queued while the "
           "previous fsync ran — the kv_sync_thread dynamics)"),
    Option("client_retry_deadline", float, 10.0,
           "total seconds a client op may spend SLEEPING between "
           "retries (the jittered-backoff budget, common/backoff.py); "
           "once exhausted the op re-raises its last error instead of "
           "pacing another attempt"),
    Option("client_aio_window", int, 16,
           "default bounded in-flight window for Client.aio_put / "
           "aio_write (the objecter max-in-flight role): how many "
           "async ops may be outstanding before aio_* blocks"),
    Option("ec_encode_batch_max_delay_us", int, 0,
           "microseconds the OSD's EC encode coalescer waits for more "
           "same-pool writes to join a batched encode dispatch; 0 = "
           "coalesce only what queued during the previous dispatch"),
    Option("metrics_history_interval", float, 1.0,
           "seconds between perf-counter samples into each daemon's "
           "metrics-history ring (common/metrics_history.py, the "
           "dump_metrics_history surface); 0 disables the sampler"),
    Option("metrics_history_retention", int, 240,
           "samples retained per daemon's metrics-history ring "
           "(newest-wins)"),
    Option("osd_pg_stat_report_interval", float, 2.0,
           "seconds between an OSD's periodic pg_stats beacons to the "
           "monitors (cached PG state + per-pool io/recovery "
           "counters; the mgr stats-report cadence role)"),
    Option("mon_pg_stats_stale_grace", float, 15.0,
           "seconds without a primary pg_stats report before a PG's "
           "stats are STALE (the STALE_PG_STATS health check); "
           "entries older than 4x this are aged out entirely"),
    Option("mon_slow_recovery_grace", float, 60.0,
           "seconds a recovery progress event may stay open before "
           "the SLOW_RECOVERY health check fires"),
    Option("mon_pool_stats_retention", int, 240,
           "per-pool stat samples retained by the monitor's PGMap "
           "ring (the `pool-stats` rate series)"),
    Option("debug_mgr", int, 0, "manager subsystem log level"),
    Option("mgr_tick_interval", float, 0.5,
           "mgr module scheduler pass interval; each module re-arms "
           "with a jittered draw around its own interval"),
    Option("mgr_modules", str, "balancer",
           "comma-separated mgr modules enabled at startup (the "
           "mgr_initial_modules role)"),
    Option("balancer_interval", float, 2.0,
           "seconds between balancer rounds when active (the "
           "balancer sleep_interval role)"),
    Option("balancer_max_deviation", int, 5,
           "PG-count deviation from the weight-proportional target "
           "below which an OSD is considered balanced "
           "(upmap_max_deviation)"),
    Option("balancer_max_iterations", int, 10,
           "calc_pg_upmaps optimizer iterations per round "
           "(upmap_max_optimizations)"),
    Option("osd_max_recovery_ops", int, 3,
           "recovery reservation slots per osd (local acquisitions "
           "and remote grants share one pool — the AsyncReserver "
           "osd_recovery_max_active role); a primary that cannot "
           "reserve every push target backs off and retries the pass"),
    Option("osd_recovery_sleep", float, 0.0,
           "seconds the recovery pipeline pauses between units "
           "(the osd_recovery_sleep pacing knob); 0 = no pacing"),
    Option("osd_recovery_pipeline_depth", int, 2,
           "bounded recovery pipeline depth: helper reads for up to "
           "this many units stream while earlier units decode; "
           "<= 1 degrades to serial gather-then-decode per unit"),
    Option("osd_recovery_batch_max_objects", int, 8,
           "objects batched into one recovery pipeline unit (one "
           "concatenated recover_stripes decode)"),
    Option("osd_recovery_helper_deadline", float, 2.0,
           "jittered-backoff budget (seconds) for re-planning an "
           "object's decode after helper-read failures before the "
           "object is deferred to the next recovery pass"),
    Option("fault_inject_spec", str, "",
           "armed failpoints (analysis/faults.py spec syntax, e.g. "
           "'msgr.corrupt_frame=p:0.02;osd.slow_op=p:0.1,delay:0.05')"
           "; empty disarms everything — the ms-inject-socket-"
           "failures / filestore_debug_inject_read_err surface",
           level="dev"),
    Option("profiler_hz", float, 100.0,
           "wallclock sampler rate when 'profile start' names no "
           "rate; sampling is jittered around 1/hz (the profiler is "
           "OFF until started via the admin socket or a bench hook)"),
    Option("profiler_max_seconds", float, 30.0,
           "wallclock sampler auto-stop budget: a forgotten "
           "'profile start' stops sampling after this many seconds"),
    Option("profiler_max_stacks", int, 4096,
           "bounded profiler retention: distinct folded stacks kept "
           "per daemon; further stacks fold into an overflow bucket"),
    Option("profiler_seed", int, 0,
           "seed for the profiler's jittered sampling interval "
           "(reproducible sample schedules across runs)", level="dev"),
)


class Config:
    """Layered option store with observers."""

    def __init__(self, schema: Optional[Dict[str, Option]] = None):
        self.schema = dict(schema or OPTIONS)
        self._file: Dict[str, Any] = {}
        self._env: Dict[str, Any] = {}
        self._override: Dict[str, Any] = {}
        self._observers: Dict[str, List[Callable[[str, Any], None]]] = {}
        self._load_env()

    # -- sources ------------------------------------------------------
    def _load_env(self) -> None:
        for key, value in os.environ.items():
            if key.startswith(ENV_PREFIX):
                name = key[len(ENV_PREFIX):].lower()
                if name in self.schema:
                    self._env[name] = self.schema[name].coerce(value)

    def load_file(self, path: str) -> int:
        """Read a config file: JSON object or ini-ish `name = value`
        lines (the ceph.conf role).  Returns options applied."""
        with open(path) as f:
            text = f.read()
        applied = 0
        stripped = text.lstrip()
        entries: Dict[str, Any] = {}
        if stripped.startswith("{"):
            entries = json.loads(text)
        else:
            for line in text.splitlines():
                line = line.split("#", 1)[0].split(";", 1)[0].strip()
                if not line or line.startswith("["):
                    continue
                name, _, value = line.partition("=")
                entries[name.strip().replace(" ", "_")] = value.strip()
        for name, value in entries.items():
            if name in self.schema:
                self._file[name] = self.schema[name].coerce(value)
                applied += 1
        return applied

    # -- access -------------------------------------------------------
    def get(self, name: str) -> Any:
        opt = self.schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        for layer in (self._override, self._env, self._file):
            if name in layer:
                return layer[name]
        return opt.default

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any) -> None:
        """Runtime override (`ceph config set` / injectargs role);
        notifies observers."""
        opt = self.schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        self._override[name] = opt.coerce(value)
        for cb in self._observers.get(name, []):
            cb(name, self._override[name])

    def rm_override(self, name: str) -> None:
        if self._override.pop(name, None) is not None:
            for cb in self._observers.get(name, []):
                cb(name, self.get(name))

    def add_observer(self, name: str,
                     cb: Callable[[str, Any], None]) -> None:
        self._observers.setdefault(name, []).append(cb)

    def remove_observer(self, name: str,
                        cb: Callable[[str, Any], None]) -> None:
        try:
            self._observers.get(name, []).remove(cb)
        except ValueError:
            pass

    def source_of(self, name: str) -> str:
        if name in self._override:
            return "override"
        if name in self._env:
            return "env"
        if name in self._file:
            return "file"
        return "default"

    def show(self) -> Dict[str, Dict[str, Any]]:
        """`config show`: every option with value + winning source."""
        return {name: {"value": self.get(name),
                       "source": self.source_of(name),
                       "default": opt.default,
                       "desc": opt.desc}
                for name, opt in sorted(self.schema.items())}
