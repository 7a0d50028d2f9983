"""Manager daemon — the ceph-mgr role with a pluggable module plane.

The reference splits cluster management across a C++ daemon shell
(src/mgr: MgrStandby/Mgr/ActivePyModules) and python modules loaded
into it (src/pybind/mgr: each module a class with ``serve()`` plus
config/health surfaces).  This re-derivation keeps the same split at
single-host scale:

  * ``MgrDaemon`` joins the cluster like any daemon — a messenger
    endpoint, map subscription via ``MapFollower`` (full install +
    incremental catch-up), an admin socket, perf counters, and
    lockdep-named locks;
  * ``MgrModule`` is the module contract: a ``tick()`` the daemon's
    scheduler calls on the module's interval, ``health_checks()``
    folded into the monitor's coded health report, and a ``command()``
    surface routed from the admin socket (``ceph_cli balancer ...``);
  * scheduling is jittered-backoff on ``common/backoff.py``: healthy
    modules re-arm with a jittered draw around their interval (no two
    modules tick in lockstep), a module that raised keeps drawing from
    the SAME decorrelated series, so a wedged module backs off instead
    of spinning — and its error surfaces as an ``MGR_MODULE_ERROR``
    health check at the monitor (the reference's module error health,
    src/mgr/PyModuleRegistry.cc get_health_checks).

Modules are registered by name (``MODULE_REGISTRY``); ``mgr module
ls|enable|disable`` flips them at runtime, mirroring ``ceph mgr
module ...``.

The port's copy of ``ceph_tpu/mgr/daemon.py``: the daemon's modules run
their device work on its ``device`` (the card unless the caller asks
for the CPU); the balancer's sweeps are K2 launches there.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..analysis.asyncheck import nonblocking
from ..analysis.lockdep import make_rlock
from ..analysis.racecheck import guarded_by
from ..common.backoff import Backoff
from ..common.context import Context
from ..msg.messenger import Addr, Messenger
from ..osdmap.osdmap import OSDMap
from ..services.map_follower import MapFollower


class MgrModule:
    """Base contract for mgr modules (the src/pybind/mgr MgrModule
    shape, module.py:1561): subclasses override ``tick`` (one
    scheduler pass), ``health_checks`` (code -> summary, folded into
    the monitor's health report) and ``command`` (admin-socket argv
    surface)."""

    NAME = "module"

    def __init__(self, mgr: "MgrDaemon"):
        self.mgr = mgr
        self.pc = mgr.pc
        self.log = mgr.log

    @property
    def interval(self) -> float:
        """Seconds between healthy ticks; modules override to read
        their own option."""
        return float(self.mgr.ctx.conf["mgr_tick_interval"])

    def tick(self) -> None:
        """One scheduler pass; exceptions back the module off and
        surface as MGR_MODULE_ERROR health."""

    def health_checks(self) -> Dict[str, str]:
        """code -> summary, merged into the monitor's health."""
        return {}

    def on_map(self) -> None:
        """Called after every map install (not under the mgr lock)."""

    def command(self, args: Dict) -> Dict:
        return {"error": f"module {self.NAME} has no commands"}

    def status(self) -> Dict:
        return {}


def module_registry() -> Dict[str, type]:
    """Name -> module class (the PyModuleRegistry role).  A function,
    not a module-level dict: balancer_module imports MgrModule from
    here, so the edge back must stay lazy."""
    from .balancer_module import BalancerModule

    return {BalancerModule.NAME: BalancerModule}


@guarded_by("mgr::state", "due", "bo", "error")
class _ModuleSched:
    """Per-module scheduler state: the next-due stamp, the jittered
    backoff series of a failing module, and its last error.  Written
    by the tick thread AND the admin-socket handlers (module
    enable/disable re-arms), so every access runs under the mgr state
    lock — the unlocked tick-loop writes this replaced were the race
    the checker's empty-lockset report flagged."""

    def __init__(self):
        self.due = 0.0
        self.bo: Optional[Backoff] = None
        self.error: Optional[str] = None


@guarded_by("mgr::state", "_sched")
class MgrDaemon(MapFollower):
    """The manager daemon: map follower + module scheduler."""

    def __init__(self, ctx: Context, mgr_id: str, mon_addr,
                 host: str = "127.0.0.1", port: int = 0, keyring=None,
                 device="cuda"):
        self.ctx = ctx
        self.id = mgr_id
        # where the modules' sweeps run (PoolMapper's device)
        self.device = device
        self.name = f"mgr.{mgr_id}"
        self.log = ctx.logger("mgr")
        self.tracer = ctx.tracer
        self._init_mons(mon_addr)
        self.msgr = Messenger(self.name, host, port, keyring=keyring,
                              tracer=self.tracer, perf=ctx.perf)
        self.addr: Addr = self.msgr.addr
        self.map: Optional[OSDMap] = None
        self.epoch = 0
        self.osd_addrs: Dict[int, Addr] = {}
        self.ec_profiles: Dict[str, Dict[str, str]] = {}
        self._lock = make_rlock("mgr::state")
        self._running = False
        self._tick_thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self.sock = None

        self.pc = ctx.perf.create(self.name)
        for key in ("ticks", "module_runs", "module_errors",
                    "balancer_rounds", "balancer_upmaps_proposed",
                    "balancer_sweep_launches", "balancer_paused"):
            self.pc.add_u64_counter(key)
        self.pc.add_u64("balancer_stddev")
        self.pc.add_u64("balancer_score")

        self.msgr.register("map_update", self._h_map_update,
                           control=True)
        self.msgr.register("map_inc", self._h_map_inc, control=True)
        self.msgr.register("status", self._h_status, control=False)

        # module plane: every registered module is instantiated;
        # ``enabled`` decides whether the scheduler runs it.  Per
        # module: the next-due stamp, the jittered-backoff series, and
        # the last error (surfaced as MGR_MODULE_ERROR health).
        self.modules: Dict[str, MgrModule] = {
            name: cls(self) for name, cls in module_registry().items()}
        want = {s.strip()
                for s in str(ctx.conf["mgr_modules"]).split(",")
                if s.strip()}
        self.enabled: Dict[str, bool] = {
            name: name in want for name in self.modules}
        self._sched: Dict[str, _ModuleSched] = {
            name: _ModuleSched() for name in self.modules}

    # -- handlers ------------------------------------------------------
    @nonblocking
    def _h_map_update(self, msg):
        self._install_map(msg["payload"])
        return None

    def _h_status(self, _msg):
        with self._lock:
            return {"name": self.name, "epoch": self.epoch,
                    "modules": {n: {"enabled": self.enabled[n],
                                    "last_error":
                                        self._sched[n].error}
                                for n in self.modules}}

    def _post_map_install(self) -> None:
        for name, mod in self.modules.items():
            if self.enabled.get(name):
                mod.on_map()

    # -- admin socket --------------------------------------------------
    def _wire_admin(self, sock) -> None:
        sock.register("mgr", self._admin_mgr,
                      "mgr module ls|enable|disable <name>")
        sock.register(
            "balancer", self._admin_balancer,
            "balancer status|on|off|eval|execute (balancer module)")

    def _module_ls(self) -> Dict:
        with self._lock:
            return {"modules": {
                n: {"enabled": self.enabled[n],
                    "interval": self.modules[n].interval,
                    "last_error": self._sched[n].error}
                for n in sorted(self.modules)}}

    def _admin_mgr(self, args: Dict) -> Dict:
        argv = [str(a) for a in (args.get("argv") or [])]
        if not argv or argv[0] != "module":
            return {"error": "usage: mgr module ls|enable|disable "
                             "<name>"}
        if argv[1:2] == ["ls"] or len(argv) == 1:
            return self._module_ls()
        if len(argv) == 3 and argv[1] in ("enable", "disable"):
            name = argv[2]
            if name not in self.modules:
                return {"error": f"no module {name!r}",
                        "have": sorted(self.modules)}
            self.enabled[name] = argv[1] == "enable"
            if self.enabled[name]:
                with self._lock:
                    st = self._sched[name]
                    st.due, st.bo, st.error = 0.0, None, None
            self._wake.set()
            return {"success": f"module {name} "
                               f"{'enabled' if self.enabled[name] else 'disabled'}"}
        return {"error": "usage: mgr module ls|enable|disable <name>"}

    def _admin_balancer(self, args: Dict) -> Dict:
        mod = self.modules.get("balancer")
        if mod is None:
            return {"error": "balancer module not present"}
        if not self.enabled.get("balancer"):
            return {"error": "balancer module not enabled "
                             "(mgr module enable balancer)"}
        return mod.command(args)

    # -- scheduler -----------------------------------------------------
    def _health_report(self) -> Dict[str, str]:
        checks: Dict[str, str] = {}
        with self._lock:
            errors = {name: st.error
                      for name, st in self._sched.items()}
        for name, err in errors.items():
            if self.enabled.get(name) and err:
                checks["MGR_MODULE_ERROR"] = \
                    f"module {name} failed: {err}"
        for name, mod in self.modules.items():
            if not self.enabled.get(name):
                continue
            try:
                checks.update(mod.health_checks())
            except Exception as e:
                checks["MGR_MODULE_ERROR"] = \
                    f"module {name} health_checks failed: {e!r}"
        return checks

    def _tick_loop(self) -> None:
        base = float(self.ctx.conf["mgr_tick_interval"])
        last_health: Optional[Dict[str, str]] = None
        while self._running:
            self._wake.wait(base / 2)
            self._wake.clear()
            if not self._running:
                break
            self.pc.inc("ticks")
            now = time.monotonic()
            for name, mod in self.modules.items():
                if not self._running or not self.enabled.get(name):
                    continue
                with self._lock:
                    st = self._sched[name]
                    due = st.due
                if now < due:
                    continue
                try:
                    self.pc.inc("module_runs")
                    mod.tick()  # never under the state lock
                except Exception as e:
                    self.pc.inc("module_errors")
                    with self._lock:
                        st.error = repr(e)
                        if st.bo is None:
                            # keep drawing from one decorrelated
                            # series across consecutive failures: the
                            # re-arm delay grows jittered to the cap
                            st.bo = Backoff(base=mod.interval,
                                            cap=mod.interval * 8)
                        st.due = time.monotonic() + \
                            st.bo.next_interval()
                    self.log.dout(1, f"module {name} tick failed: "
                                     f"{e!r}")
                else:
                    with self._lock:
                        st.error = None
                        st.bo = None
                        # healthy pacing still jitters (one fresh
                        # draw): modules desynchronize instead of all
                        # waking on the same beat
                        st.due = time.monotonic() + Backoff(
                            base=mod.interval,
                            cap=mod.interval * 2).next_interval()
            checks = self._health_report()
            if checks != last_health:
                last_health = checks
                try:
                    self.mon_send({"type": "mgr_health_report",
                                   "name": self.name,
                                   "checks": checks})
                except Exception as e:  # next delta re-sends
                    last_health = None
                    self.log.dout(5, f"health report failed: {e!r}")

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "MgrDaemon":
        if self.ctx.conf["admin_socket"]:
            self.sock = self.ctx.start_admin_socket()
            self.tracer.wire(self.sock)
            self._wire_admin(self.sock)
        self.msgr.start()
        payload = self.subscribe_all(self.name)
        self._install_map(payload)
        self._running = True
        self._tick_thread = threading.Thread(
            target=self._tick_loop, daemon=True,
            name=f"{self.name}-tick")
        self._tick_thread.start()
        self.log.dout(1, f"{self.name} up at {self.addr}, modules: "
                         f"{sorted(n for n in self.enabled if self.enabled[n])}")
        return self

    def shutdown(self) -> None:
        self._running = False
        self._wake.set()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=5)
        self.msgr.shutdown()
        self.ctx.shutdown()
