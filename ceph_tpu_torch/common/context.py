"""CephContext analogue — one object tying the runtime together (the
port's copy of ``ceph_tpu/common/context.py``; its admin sockets
default to a directory of their own, ``ceph_tpu_torch_asok``, so the
two packages never bind one path).

The reference threads a ``CephContext*`` through every component
(config proxy, log, perf counters collection, admin socket); services
here take a ``Context`` the same way so tests can build isolated
runtimes.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from ..analysis.lockdep import make_lock, make_rlock  # noqa: F401 —
# the lock-registry hook: services build named, lockdep-tracked locks
# through the context module (or ..analysis.lockdep directly)
from .admin_socket import AdminSocket, wire_defaults
from .config import Config
from .log import LogCore, SubsysLogger
from .perf_counters import PerfCountersCollection
from .tracing import Tracer


class Context:
    make_lock = staticmethod(make_lock)
    make_rlock = staticmethod(make_rlock)
    def __init__(self, name: str = "ceph-tpu",
                 config: Optional[Config] = None,
                 admin_dir: Optional[str] = None):
        self.name = name
        self.conf = config or Config()
        if self.conf["lockdep"]:
            from ..analysis import lockdep

            lockdep.enable(True)
        # bind the fault-injection plane to this runtime's config:
        # applies the current fault_inject_spec and follows runtime
        # set() live (one observer per shared Config — idempotent)
        from ..analysis import faults

        faults.install(self.conf)
        self.log = LogCore(max_recent=self.conf["log_max_recent"])
        self.perf = PerfCountersCollection()
        # the daemon's tracing plane (common/tracing.py): services and
        # their messengers share this tracer, so one op's spans nest
        self.tracer = Tracer(name,
                             ring_size=self.conf["trace_ring_size"],
                             sample_rate=self.conf["trace_sample_rate"])
        self._admin: Optional[AdminSocket] = None
        self._admin_dir = admin_dir
        # the wallclock sampling profiler (common/profiler.py) — OFF
        # until 'profile start' arrives on the admin socket
        self.profiler = None
        # the daemon's counter time-series ring (dump_metrics_history)
        self._metrics_history = None
        # (option, callback) pairs to detach on shutdown — contexts may
        # share a Config (a daemon revived in-process), so observers
        # must not outlive their runtime
        self._observers: list = []
        self._observed: set = set()

    def logger(self, subsys: str) -> SubsysLogger:
        lg = SubsysLogger(subsys, self.log)
        # debug_<subsys> option drives the level, live (observer)
        opt = f"debug_{subsys}"
        if opt in self.conf.schema and opt not in self._observed:
            self.log.set_level(subsys, self.conf[opt])

            def _cb(_n, v, _subsys=subsys):
                self.log.set_level(_subsys, int(v))

            self.conf.add_observer(opt, _cb)
            self._observers.append((opt, _cb))
            self._observed.add(opt)
        return lg

    @property
    def admin_socket_path(self) -> str:
        d = self._admin_dir or os.path.join(
            tempfile.gettempdir(), "ceph_tpu_torch_asok")
        return os.path.join(d, f"{self.name}.asok")

    def start_admin_socket(self) -> AdminSocket:
        if self._admin is None:
            self._admin = AdminSocket(self.admin_socket_path)
            wire_defaults(self._admin, config=self.conf,
                          perf=self.perf, logcore=self.log)
            # the fault-injection command plane (`fault set|list|
            # clear` — the `ceph daemon ... injectargs`-era surface)
            from ..analysis import faults

            faults.wire(self._admin)
            # the data-race checker surface (analysis/racecheck.py):
            # guarded-class registry + recorded violations with both
            # access stacks, beside lockdep's dump_blocked
            from ..analysis import racecheck

            self._admin.register(
                "dump_racecheck", lambda _a: racecheck.dump(),
                "data-race checker: guarded classes and recorded "
                "lockset/confinement violations (both stacks)")
            # the async-safety surface (analysis/asyncheck.py):
            # @nonblocking contracts, live dispatch scopes (a stall in
            # progress is named before it finishes), and recorded
            # budget overruns with entry+witness stacks
            from ..analysis import asyncheck

            asyncheck.configure(
                self.conf["asyncheck_loop_budget_ms"])
            self._admin.register(
                "dump_asyncheck", lambda _a: asyncheck.dump(),
                "async-safety checker: non-blocking contracts, live "
                "scopes, and callback-budget overruns (both stacks)")
            if asyncheck.enabled():
                asyncheck.start_global()
            self._admin.start()
            # a daemon with an admin plane gets the stall watchdog
            # behind it: dump_blocked serves on demand, the scanner
            # reports wedges unprompted
            from ..analysis.watchdog import start_global

            start_global(self.conf["watchdog_threshold"])
            # the continuous plane: sample this runtime's counters
            # into a bounded ring, served as dump_metrics_history
            if self.conf["metrics_history_interval"] > 0:
                from .metrics_history import MetricsHistory

                self._metrics_history = MetricsHistory(
                    self.name, perf=self.perf,
                    interval=self.conf["metrics_history_interval"],
                    retention=self.conf["metrics_history_retention"])
                self._metrics_history.wire(self._admin)
                self._metrics_history.start()
            # the wallclock sampler command plane: `profile
            # start|stop|dump` per daemon (the reference's
            # wallclock-profiler attach surface).  Construction is
            # cheap; sampling only runs between start and stop.
            from .profiler import WallclockProfiler

            self.profiler = WallclockProfiler(
                hz=self.conf["profiler_hz"],
                max_seconds=self.conf["profiler_max_seconds"],
                max_stacks=self.conf["profiler_max_stacks"],
                seed=self.conf["profiler_seed"],
                name=self.name)

            def _profile(a, _prof=self.profiler):
                sub = a.get("cmd", "dump")
                if sub == "start":
                    hz = a.get("hz")
                    started = _prof.profile_start(
                        hz=float(hz) if hz else None)
                    return {"started": started, "hz": _prof.hz}
                if sub == "stop":
                    return {"stopped": _prof.profile_stop()}
                if sub == "dump":
                    return _prof.profile_dump()
                return {"error": f"unknown profile cmd: {sub}"}

            self._admin.register(
                "profile", _profile,
                "wallclock sampler: cmd=start|stop|dump [hz=N]")
        return self._admin

    @property
    def metrics_history(self):
        return self._metrics_history

    def shutdown(self) -> None:
        for opt, cb in self._observers:
            self.conf.remove_observer(opt, cb)
        self._observers.clear()
        self._observed.clear()
        if self._metrics_history is not None:
            self._metrics_history.stop()
            self._metrics_history = None
        if self.profiler is not None:
            self.profiler.profile_stop()
            self.profiler = None
        if self._admin is not None:
            self._admin.shutdown()
            self._admin = None
