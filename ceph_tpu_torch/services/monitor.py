"""Monitor — the cluster-map authority and failure detector.

The role of src/mon (Monitor.cc / OSDMonitor.cc / MonitorDBStore.h):
it owns the OSDMap, bumps epochs on every state change, retains full
maps per epoch (the MonitorDBStore analogue — any daemon can resume at
any epoch), tracks osd boot/heartbeat liveness, and marks osds down
after ``osd_heartbeat_grace`` without a beat (OSD::handle_osd_ping →
OSDMonitor flow, src/osd/OSD.cc:5487 / ceph_osd.cc:544).  Map changes
push to subscribers (MonClient subscription role) through per-peer
queues so one hung subscriber can never stall the commit path.

Runs standalone (a single authority) or as one of N quorum members:
``set_peers(rank, addrs)`` before ``start()`` attaches the election +
replicated-log layer (services/quorum.py — the ElectionLogic/Paxos
role).  In quorum mode every epoch is majority-replicated before it
becomes visible, write commands are forwarded to the leader, reads and
subscriptions are served by any member, and only the leader runs
failure detection.  (SURVEY §2.5 Monitor row.)

The port's copy of ``ceph_tpu/services/monitor.py``, on the port's
runtime; it does no device work.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from ..analysis import faults
from ..analysis.asyncheck import nonblocking
from ..analysis.lockdep import make_lock, make_rlock
from ..analysis.racecheck import guarded_by
from ..common import encoding
from ..common.context import Context
from ..common.op_tracker import OpTracker
from ..msg.messenger import Addr, Messenger
from ..osdmap.osdmap import OSDMap, PgPool
from .quorum import Quorum

# the epoch-store payload format (MonitorDBStore full-map rows,
# wirecheck entry mon.epoch_payload): one envelope around
# {epoch, map, osd_addrs, ec_profiles}.  Files written before the
# migration are raw dicts (writer v0) and keep decoding, so a monitor
# resumes from an old store_dir unchanged.
EPOCH_PAYLOAD_V = 1


def encode_epoch_payload(payload: Dict) -> str:
    return encoding.encode(payload, EPOCH_PAYLOAD_V, 1)


def decode_epoch_payload(blob) -> Dict:
    v, d = encoding.decode_any(blob, supported=EPOCH_PAYLOAD_V,
                               struct="mon.epoch_payload")
    if not isinstance(d, dict):
        raise encoding.MalformedInput(
            f"mon.epoch_payload v{v}: payload is not an object")
    return d


@guarded_by("mon::state", "_pg_stats", "_osd_slo", "_subscribers")
class Monitor:
    def __init__(self, ctx: Context, osdmap: OSDMap,
                 host: str = "127.0.0.1", port: int = 0,
                 store_dir: Optional[str] = None, keyring=None):
        self.ctx = ctx
        self.log = ctx.logger("mon")
        self.map = osdmap
        self.tracer = ctx.tracer
        # lossless policy: mon↔mon quorum traffic and mon↔osd control
        # frames are sequenced and replayed across reconnects
        self.msgr = Messenger("mon", host, port, keyring=keyring,
                              lossless=True, tracer=self.tracer,
                              perf=ctx.perf)
        self.addr: Addr = self.msgr.addr
        self.store_dir = store_dir
        self._epochs: Dict[int, str] = {}  # epoch -> map json
        # epoch -> Incremental dict (map distribution is O(change):
        # subscribers apply deltas, fetching a full map only on a gap)
        self._incs: Dict[int, Dict] = {}
        self._prev_map: Optional[OSDMap] = None
        self._osd_addrs: Dict[int, Addr] = {}
        self._last_beat: Dict[int, float] = {}
        self._down_since: Dict[int, float] = {}
        # OSDMonitor::check_failure state: failed osd -> {reporter
        # osd: mono stamp of its latest osd_failure report}.  Reports
        # DECAY (reporters re-send every heartbeat interval while the
        # peer stays silent), so a burst from one partitioned corner
        # of the cluster cannot linger forever as half a quorum.
        self._failure_reports: Dict[int, Dict[int, float]] = {}
        # osd -> mono stamp of its last accepted boot: a failure
        # report whose silence window STARTED before the boot is
        # evidence against the previous incarnation, not this one
        # (check_failure's failed_since >= up_from rule)
        self._up_from: Dict[int, float] = {}
        # the osd_markdown_log role: osd -> markdown stamps within
        # osd_max_markdown_period; crossing osd_max_markdown_count
        # dampens the daemon (boot deferred + auto-out) and raises
        # the OSD_FLAPPING health check
        self._markdown_log: Dict[int, Deque[float]] = {}
        # osd -> last time we pushed the map at a beating-but-down
        # daemon (rate limit for the wrongly-marked-down nudge)
        self._down_nudge: Dict[int, float] = {}
        # osd -> the SLO cargo its last beacon carried (slow-op count
        # + oldest age, heartbeat-RTT threshold breaches) with receipt
        # stamp: what _h_health folds into SLOW_OPS /
        # OSD_SLOW_PING_TIME, aged out with the stats grace so a dead
        # daemon's stale complaint can't pin health at WARN
        self._osd_slo: Dict[int, Dict] = {}
        # osd -> pre-out weight, for osds the MONITOR outed (auto-out);
        # restored on boot, unlike an admin mark_out which sticks
        self._auto_out: Dict[int, int] = {}
        self._subscribers: Dict[str, Addr] = {}
        self._pushers: Dict[str, "_SubPusher"] = {}
        self._lock = make_rlock("mon::state")
        self._commit_serial = make_lock("mon::commit")
        self._committed_epoch = 0
        self._ticker: Optional[threading.Thread] = None
        self._running = False
        self.quorum: Optional[Quorum] = None
        self.rank = 0  # quorum rank (set_peers); 0 standalone
        self.ec_profiles: Dict[str, Dict[str, str]] = {}
        self.pc = ctx.perf.create("mon")
        self.pc.add_u64_counter("epochs")
        self.pc.add_u64_counter("beats")
        self.pc.add_u64_counter("markdowns")
        self.pc.add_u64_counter("failure_reports")
        self.pc.add_u64_counter("markdowns_dampened")
        self.pc.add_u64_counter("pg_stat_reports")
        self.pc.add_u64("stale_pgs")
        self.pc.add_histogram("commit_lat")
        self.pc.add_time("commit_time")
        # write commands register here (the leader-side op surface);
        # dump_ops_in_flight / dump_historic_ops over the admin socket
        # — slow threshold on the same knob as the osds' SLOW_OPS
        self.optracker = OpTracker(
            history_slow_threshold=ctx.conf["osd_op_complaint_time"])

        # write commands mutate the map: leader-only in quorum mode
        # (forwarded there); reads are served by any member
        # heartbeats and map reads ride the messenger's control lane:
        # failure detection must never queue behind a burst of client
        # write commands holding every op-pool worker
        for t, h, ctl in (("boot", self._fwd(self._h_boot), False),
                          ("heartbeat", self._fwd(self._h_heartbeat,
                                                  fire_forget=True),
                           True),
                          ("osd_failure",
                           self._fwd(self._h_osd_failure,
                                     fire_forget=True), True),
                          ("get_map", self._h_get_map, True),
                          ("get_inc", self._h_get_inc, True),
                          ("subscribe", self._h_subscribe, False),
                          ("mark_down", self._fwd(self._h_mark_down),
                           False),
                          ("mark_out", self._fwd(self._h_mark_out),
                           False),
                          ("pool_create",
                           self._fwd(self._h_pool_create), False),
                          ("pool_delete",
                           self._fwd(self._h_pool_delete), False),
                          ("reweight", self._fwd(self._h_reweight),
                           False),
                          ("pg_temp_set",
                           self._fwd(self._h_pg_temp_set), False),
                          ("pg_upmap_items_set",
                           self._fwd(self._h_pg_upmap_items_set),
                           False),
                          ("mgr_health_report",
                           self._h_mgr_health_report, False),
                          ("ec_profile_set",
                           self._fwd(self._h_ec_profile_set), False),
                          ("pg_stats", self._h_pg_stats, False),
                          ("pool_stats", self._h_pool_stats, False),
                          ("progress", self._h_progress, False),
                          ("health", self._h_health, False),
                          ("status", self._h_status, False)):
            self.msgr.register(t, h, control=ctl)
        # PGMap role (src/mon/MgrStatMonitor / PGMap.cc): latest
        # primary-reported state per PG — observability state, NOT part
        # of the replicated epoch log (exactly as in the reference);
        # OSDs broadcast stats to every member, so any mon can serve
        # health without quorum traffic
        self._pg_stats: Dict[Tuple[int, int], Dict] = {}
        # ((pool, ps), reporter osd) -> {"io": cumulative block,
        # "last_report": mono}: any shard HOLDER reports io (EC reads
        # land on every member), so pool sums cover the whole set
        self._pg_io: Dict[Tuple[Tuple[int, int], int], Dict] = {}
        # per-pool stat-sample ring (the PGMap delta ring the
        # `pool-stats` rate series derives from) + the mgr-progress
        # event surface (open per pool, completed bounded)
        self._pool_stat_ring: Dict[int, Deque[Dict]] = {}
        self._progress_open: Dict[int, Dict] = {}
        self._progress_done: Deque[Dict] = collections.deque(
            maxlen=32)
        self._progress_seq = 0
        # latest mgr-module health report (mgr broadcasts to every
        # member); folded into _h_health while within the grace
        self._mgr_health: Optional[Dict] = None

    # -- quorum ---------------------------------------------------------
    def set_peers(self, rank: int, addrs: List[Addr]) -> None:
        """Join an N-monitor quorum (call before start()).  ``addrs``
        is the rank-ordered list of every member including self."""
        self.rank = rank
        # rank-qualified wire identity: every frame's ``frm`` carries
        # it, so the net.partition fault plane can scope a single
        # rank ("mon.2") while "mon" still prefix-matches them all
        self.msgr.name = f"mon.{rank}"
        self.quorum = Quorum(
            self, rank, addrs,
            lease=self.ctx.conf["mon_lease"],
            election_timeout=self.ctx.conf["mon_election_timeout"])

    def _fwd(self, handler, fire_forget: bool = False):
        """Leader-only write handler: executed locally on the leader,
        forwarded to it from peons (Monitor::forward_request role)."""

        def h(msg: Dict):
            q = self.quorum
            if q is None or q.is_leader():
                with self.optracker.create(
                        "mon_cmd",
                        f"{msg.get('type', '?')} from "
                        f"{msg.get('frm', '?')}"):
                    return handler(msg)
            la = q.leader_addr()
            if la is None:
                return {"error": "no quorum"}
            fwd = {k: v for k, v in msg.items()
                   if k not in ("tid", "mac", "frm")}
            if fire_forget:
                self.msgr.send(la, fwd)
                return None
            return self.msgr.call(la, fwd, timeout=5.0)

        return h

    def last_committed(self) -> int:
        with self._lock:
            return self._committed_epoch

    def committed_entries(self, frm: int, to: int) -> List[Dict]:
        """Committed (version, entry) rows in (frm, to] that are still
        retained — the quorum catch-up feed.  (A member further behind
        than the retention window cannot catch up incrementally; with
        mon_max_map_epochs=500 that does not happen in practice.)"""
        out = []
        with self._lock:
            for v in range(frm + 1, to + 1):
                pay = self._epochs.get(v)
                if pay is None:
                    continue
                out.append({"v": v,
                            "entry": {"payload": pay,
                                      "inc": self._incs.get(v)}})
        return out

    def apply_committed(self, v: int, entry: Dict) -> None:
        """Install a majority-committed epoch (peon apply / leader
        sync): replace live state from the full payload, store, push."""
        p = decode_epoch_payload(entry["payload"])
        with self._lock:
            if v != self._committed_epoch + 1:
                # duplicate/stale delivery (racing catch-up paths must
                # never roll the visible state backwards)
                return
            self.map = OSDMap.from_dict(p["map"])
            self._osd_addrs = {int(k): tuple(a)
                               for k, a in p["osd_addrs"].items()}
            self.ec_profiles = dict(p["ec_profiles"])
            self._store_committed(v, entry["payload"],
                                  entry.get("inc"))
        self.pc.inc("epochs")
        self._push_maps()

    def on_leader(self, uncommitted: Optional[Dict]) -> None:
        """Quorum callback after winning + syncing an election."""
        with self._lock:
            # surviving osds get a full grace window to re-beat before
            # the new leader may mark them down
            now = time.monotonic()
            for o in range(self.map.max_osd):
                if self.map.exists(o) and self.map.is_up(o):
                    self._last_beat.setdefault(o, now)
        if uncommitted is not None and \
                int(uncommitted["v"]) == self.last_committed() + 1:
            # Paxos re-propose: an accepted-but-uncommitted entry that
            # may have reached a majority must survive the failover
            v = int(uncommitted["v"])
            if self.quorum.replicate(v, uncommitted["entry"]):
                self.apply_committed(v, uncommitted["entry"])
        if self.last_committed() == 0:
            try:
                self._commit("genesis")
            except RuntimeError:
                pass  # lost quorum immediately; next leader retries

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self.ctx.conf["admin_socket"]:
            sock = self.ctx.start_admin_socket()
            self.optracker.wire(sock)
            self.tracer.wire(sock)
            self.msgr.wire(sock)   # dump_messenger
        self._load_store()
        self.msgr.start()
        self._running = True
        self._ticker = threading.Thread(target=self._tick_loop,
                                        daemon=True, name="mon-tick")
        self._ticker.start()
        if self.quorum is not None:
            self.quorum.start()
        elif self._committed_epoch == 0:
            self._commit("genesis")

    def _load_store(self) -> None:
        """MonitorDBStore reload: a restarted monitor resumes from its
        persisted epochs instead of resetting to genesis (which would
        freeze daemons already holding newer epochs).  Quorum members
        also benefit: a rejoin starts from the local tail and syncs
        only the delta."""
        if not self.store_dir or not os.path.isdir(self.store_dir):
            return
        epochs = []
        for name in os.listdir(self.store_dir):
            if name.startswith("osdmap.") and name.endswith(".json"):
                try:
                    epochs.append(int(name.split(".")[1]))
                except ValueError:
                    continue
        if not epochs:
            return
        keep = self.ctx.conf["mon_max_map_epochs"]
        with self._lock:
            for e in sorted(epochs)[-keep:]:
                try:
                    self._epochs[e] = open(os.path.join(
                        self.store_dir, f"osdmap.{e}.json")).read()
                except OSError:
                    continue
            newest = max(self._epochs)
            p = decode_epoch_payload(self._epochs[newest])
            self.map = OSDMap.from_dict(p["map"])
            self._osd_addrs = {int(k): tuple(a)
                               for k, a in p["osd_addrs"].items()}
            self.ec_profiles = dict(p["ec_profiles"])
            self._prev_map = OSDMap.from_dict(p["map"])
            self._committed_epoch = newest
        self.log.dout(1, f"resumed from stored epoch {newest}")

    def shutdown(self) -> None:
        self._running = False
        if self.quorum is not None:
            self.quorum.shutdown()
        if self._ticker:
            self._ticker.join(timeout=2)
        for p in self._pushers.values():
            p.stop()
        self.msgr.shutdown()
        self.ctx.shutdown()  # admin socket + config observers

    # -- the epoch store (MonitorDBStore role) --------------------------
    def _commit(self, why: str) -> int:
        """Bump the epoch, retain the full map AND its delta, persist,
        notify.  In quorum mode the entry is majority-replicated BEFORE
        it is stored or pushed anywhere; a leader that cannot reach a
        majority rolls back and abdicates, so epochs never fork."""
        from ..osdmap.incremental import diff_maps

        t_commit = time.monotonic()
        with self._commit_serial:
            with self._lock:
                self.map.epoch += 1
                v = self.map.epoch
                payload = encode_epoch_payload(self._map_payload())
                inc_d = None
                if self._prev_map is not None:
                    inc = diff_maps(self._prev_map, self.map)
                    inc.epoch = v
                    inc_d = inc.to_dict()
            if self.quorum is not None:
                if not self.quorum.replicate(
                        v, {"payload": payload, "inc": inc_d}):
                    self._restore_committed()
                    self.quorum.abdicate()
                    raise RuntimeError(
                        "mon: lost quorum; commit aborted")
            self._store_committed(v, payload, inc_d)
        self.pc.inc("epochs")
        dt = time.monotonic() - t_commit
        self.pc.hist_add("commit_lat", dt)
        self.pc.tinc("commit_time", dt)
        self.log.dout(5, f"new epoch {v} ({why})")
        self._push_maps()
        return v

    def _store_committed(self, v: int, payload: str,
                         inc_d: Optional[Dict]) -> None:
        with self._lock:
            self._epochs[v] = payload
            if inc_d is not None:
                self._incs[v] = inc_d
            self._prev_map = OSDMap.from_dict(
                decode_epoch_payload(payload)["map"])
            self._committed_epoch = v
            keep = self.ctx.conf["mon_max_map_epochs"]
            for e in sorted(self._epochs)[:-keep]:
                del self._epochs[e]
                self._incs.pop(e, None)
                if self.store_dir:
                    try:
                        os.unlink(os.path.join(
                            self.store_dir, f"osdmap.{e}.json"))
                    except OSError:
                        pass
            # a deleted pool's PGs must leave the PGMap too, or stale
            # states poison health checks forever
            for pgid in [g for g in self._pg_stats
                         if g[0] not in self.map.pools]:
                del self._pg_stats[pgid]
            for key in [k for k in self._pg_io
                        if k[0][0] not in self.map.pools]:
                del self._pg_io[key]
            for pid in [p for p in self._pool_stat_ring
                        if p not in self.map.pools]:
                del self._pool_stat_ring[pid]
                self._progress_open.pop(pid, None)
            if self.store_dir:
                os.makedirs(self.store_dir, exist_ok=True)
                with open(os.path.join(
                        self.store_dir, f"osdmap.{v}.json"), "w") as f:
                    f.write(payload)

    # Paxos durability (Paxos.cc persistent accepted_pn + uncommitted
    # value via MonitorDBStore): the quorum layer writes its promise
    # epoch and any staged-but-uncommitted entry here BEFORE acking, so
    # restarts cannot lose a majority-staged entry or un-promise.
    def store_quorum_state(self, state: Dict) -> None:
        if not self.store_dir:
            return
        os.makedirs(self.store_dir, exist_ok=True)
        tmp = os.path.join(self.store_dir, ".quorum.json.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.store_dir, "quorum.json"))

    def load_quorum_state(self) -> Optional[Dict]:
        if not self.store_dir:
            return None
        try:
            return json.load(open(os.path.join(self.store_dir,
                                               "quorum.json")))
        except (OSError, ValueError):
            return None

    def _restore_committed(self) -> None:
        """Roll live state back to the last committed entry (a failed
        quorum replication left only in-memory mutations)."""
        with self._lock:
            if self._committed_epoch == 0:
                self.map.epoch = 0
                return
            p = decode_epoch_payload(self._epochs[self._committed_epoch])
            self.map = OSDMap.from_dict(p["map"])
            self._osd_addrs = {int(k): tuple(a)
                               for k, a in p["osd_addrs"].items()}
            self.ec_profiles = dict(p["ec_profiles"])

    def _map_payload(self) -> Dict:
        return {"epoch": self.map.epoch,
                "map": self.map.to_dict(),
                "osd_addrs": {str(k): list(v)
                              for k, v in self._osd_addrs.items()},
                "ec_profiles": self.ec_profiles}

    def get_epoch_payload(self, epoch: int) -> Optional[Dict]:
        with self._lock:
            raw = self._epochs.get(epoch)
        return decode_epoch_payload(raw) if raw else None

    def _wire_full(self, payload: Dict) -> Dict:
        """Full-map payload for the WIRE: the map travels as its
        versioned binary encode (OSDMap::encode role — ~200 KB for a
        10k-OSD map vs ~3 MB of JSON), cached per epoch since every
        subscriber gets the same bytes.  The JSON form stays in the
        epoch STORE (debuggable, quorum-fetchable)."""
        epoch = payload.get("epoch")
        with self._lock:
            cached = getattr(self, "_wire_cache", None)
        if cached is not None and cached[0] == epoch:
            map_bin = cached[1]
        else:
            from ..osdmap.bincode_maps import osdmap_to_bytes

            map_bin = osdmap_to_bytes(OSDMap.from_dict(
                payload["map"]))
            with self._lock:
                self._wire_cache = (epoch, map_bin)
        p = {k: v for k, v in payload.items() if k != "map"}
        p["map_bin"] = map_bin
        return p

    def _push_maps(self) -> None:
        """Queue the newest committed epoch to every subscriber.  Each
        subscriber has its own pusher thread + bounded queue, so a hung
        or slow peer delays only itself, never the commit path (the
        round-3 review's push-isolation gap)."""
        with self._lock:
            epoch = self._committed_epoch
            if epoch == 0:
                return
            inc = self._incs.get(epoch)
            payload = None if inc is not None else \
                decode_epoch_payload(self._epochs[epoch])
            extras = {"osd_addrs": {str(k): list(v) for k, v in
                                    self._osd_addrs.items()},
                      "ec_profiles": dict(self.ec_profiles)}
            pushers = list(self._pushers.values())
        if inc is not None:
            msg = {"type": "map_inc", "inc": inc, **extras}
        else:
            msg = {"type": "map_update",
                   "payload": self._wire_full(payload)}
        for p in pushers:
            p.push(msg)

    @nonblocking
    def _h_get_inc(self, msg: Dict) -> Dict:
        with self._lock:
            got = self._incs.get(int(msg["epoch"]))
        return {"inc": got} if got is not None else \
            {"error": f"no incremental for epoch {msg['epoch']}"}

    # -- handlers --------------------------------------------------------
    def _h_boot(self, msg: Dict) -> Dict:
        osd = int(msg["osd"])
        addr = tuple(msg["addr"])
        with self._lock:
            now = time.monotonic()
            if self.map.exists(osd) and not self.map.is_up(osd) \
                    and self._is_dampened(osd, now):
                # osd_markdown_log dampening: a daemon that flapped
                # through the markdown budget stays down until its
                # oldest markdown ages out of the window (the delayed
                # re-boot role); it keeps re-beating boot and gets in
                # once the log drains
                self._last_beat[osd] = now  # alive, just dampened
                return {"epoch": self.map.epoch, "dampened": True}
            addr_changed = self._osd_addrs.get(osd) != addr
            self._osd_addrs[osd] = addr
            self._last_beat[osd] = now
            # a booting incarnation starts with a clean slate: stale
            # peer reports against the previous incarnation must not
            # insta-kill it (the markdown/boot oscillation guard)
            self._failure_reports.pop(osd, None)
            self._up_from[osd] = now
            was_up = self.map.exists(osd) and self.map.is_up(osd)
            # weight policy on boot (OSDMonitor::prepare_boot): an osd
            # the monitor auto-outed comes back in; an osd an admin
            # marked out (weight 0 via mark_out) STAYS out; a known osd
            # keeps whatever weight it had
            if self.map.exists(osd):
                weight = self.map.osd_weight[osd]
                if osd in self._auto_out:
                    weight = self._auto_out[osd]
            else:
                weight = msg.get("weight", 0x10000)
            changed = (not was_up) or \
                weight != (self.map.osd_weight[osd]
                           if self.map.exists(osd) else None)
            self._auto_out.pop(osd, None)
            self.map.add_osd(osd, weight=weight)
        if changed or addr_changed:
            # a fast reboot keeps the osd "up" but rebinds its socket:
            # the new address must reach every peer via a new epoch;
            # any weight/up change must also land in the epoch store
            self._commit(f"osd.{osd} boot")
        self.log.dout(1, f"osd.{osd} booted at {msg['addr']}")
        return {"epoch": self.map.epoch}

    @nonblocking
    def _h_heartbeat(self, msg: Dict) -> None:
        osd = int(msg["osd"])
        push = None
        with self._lock:
            now = time.monotonic()
            self._last_beat[osd] = now
            # SLO cargo: overwrite each beat, so a beacon WITHOUT the
            # keys (ops drained, pings recovered) clears the daemon's
            # entry and the health checks fall away with it
            self._osd_slo[osd] = {
                "ts": now,
                "slow_ops": msg.get("slow_ops"),
                "slow_pings": msg.get("slow_pings")}
            if self.map.exists(osd) and not self.map.is_up(osd) \
                    and self._committed_epoch \
                    and now - self._down_nudge.get(osd, 0.0) > 1.0:
                pusher = self._pushers.get(f"osd.{osd}")
                if pusher is not None:
                    self._down_nudge[osd] = now
                    payload = decode_epoch_payload(
                        self._epochs[self._committed_epoch])
                    push = (pusher, payload)
        if push is not None:
            # a beat from an osd the map says is DOWN: the daemon is
            # alive but missed its own markdown epoch (a healed
            # partition dropped the push without replay) — shove the
            # committed map at it so it can see itself down, request
            # a re-boot, and rejoin without waiting for an unrelated
            # commit to come along
            push[0].push({"type": "map_update",
                          "payload": self._wire_full(push[1])})
        self.pc.inc("beats")
        return None

    @nonblocking
    def _h_get_map(self, msg: Dict) -> Dict:
        epoch = msg.get("epoch")
        if epoch is not None:
            got = self.get_epoch_payload(int(epoch))
            return self._wire_full(got) if got is not None else \
                {"error": f"no epoch {epoch}"}
        with self._lock:
            if self._committed_epoch == 0:
                return {"error": "no committed map yet"}
            payload = decode_epoch_payload(self._epochs[self._committed_epoch])
        return self._wire_full(payload)

    def _h_subscribe(self, msg: Dict) -> Dict:
        name, addr = msg["name"], tuple(msg["addr"])
        with self._lock:
            old = self._subscribers.get(name)
            self._subscribers[name] = addr
            if old != addr:
                stale = self._pushers.pop(name, None)
                self._pushers[name] = _SubPusher(self.msgr, addr)
            else:
                stale = None
            if self._committed_epoch == 0:
                reply = {"error": "no committed map yet"}
            else:
                reply = decode_epoch_payload(self._epochs[self._committed_epoch])
        if stale is not None:
            stale.stop()
        return self._wire_full(reply) if "map" in reply else reply

    def _h_mark_down(self, msg: Dict) -> Dict:
        return {"epoch": self.mark_down(int(msg["osd"]))}

    def _h_mark_out(self, msg: Dict) -> Dict:
        osd = int(msg["osd"])
        with self._lock:
            self.map.osd_weight[osd] = 0
            self._auto_out.pop(osd, None)  # admin out sticks
        return {"epoch": self._commit(f"osd.{osd} out")}

    def _h_pg_temp_set(self, msg: Dict) -> Dict:
        """Primary-requested acting override (OSDMonitor pg_temp flow):
        keeps a PG served by its data holders while the new up set
        backfills; an empty list clears the override."""
        pgid = (int(msg["pool"]), int(msg["ps"]))
        osds = [int(o) for o in msg.get("osds", [])]
        with self._lock:
            cur = self.map.pg_temp.get(pgid)
            if osds:
                if cur == osds:
                    return {"epoch": self.map.epoch}
                self.map.pg_temp[pgid] = osds
            else:
                if cur is None:
                    return {"epoch": self.map.epoch}
                del self.map.pg_temp[pgid]
        return {"epoch": self._commit(f"pg_temp {pgid}")}

    def _h_pg_upmap_items_set(self, msg: Dict) -> Dict:
        """Balancer-proposed remap pairs (the OSDMonitor
        osd pg-upmap-items flow, OSDMonitor.cc:13736): install the
        PG's ``pg_upmap_items`` exception list and commit — the change
        rides the incremental's new_pg_upmap_items delta to every
        subscriber.  An empty list clears the entry."""
        pgid = (int(msg["pool"]), int(msg["ps"]))
        items = [(int(f), int(t)) for f, t in msg.get("items", [])]
        with self._lock:
            pool = self.map.pools.get(pgid[0])
            if pool is None:
                return {"error": f"no pool {pgid[0]}"}
            if pgid[1] >= pool.pg_num:
                return {"error": f"ps {pgid[1]} >= pg_num "
                                 f"{pool.pg_num}"}
            if len(items) > pool.size:
                # the reference monitor rejects wider-than-pool entry
                # lists (and the batched pipeline's fixed result
                # width could not hold them)
                return {"error": f"{len(items)} pairs > pool size "
                                 f"{pool.size}"}
            cur = self.map.pg_upmap_items.get(pgid)
            if items:
                if cur == items:
                    return {"epoch": self.map.epoch}
                self.map.pg_upmap_items[pgid] = items
            else:
                if cur is None:
                    return {"epoch": self.map.epoch}
                del self.map.pg_upmap_items[pgid]
        return {"epoch": self._commit(f"pg_upmap_items {pgid}")}

    def _h_mgr_health_report(self, msg: Dict) -> None:
        """Mgr-module health checks (the MMgrBeacon health payload
        role): kept beside the PGMap observability state — NOT part
        of the replicated epoch log — and folded into ``_h_health``
        while fresh.  The mgr broadcasts to every member, so any mon
        serves the same fold."""
        checks = {str(k): str(v)
                  for k, v in (msg.get("checks") or {}).items()}
        with self._lock:
            self._mgr_health = {
                "name": msg.get("name", "mgr"),
                "checks": checks,
                "ts": time.monotonic()}
        return None

    def _h_pool_create(self, msg: Dict) -> Dict:
        pool_id = int(msg["pool_id"])
        with self._lock:
            self.map.pools[pool_id] = PgPool(**msg["pool"])
        return {"epoch": self._commit(f"pool {pool_id} create")}

    def _h_pool_delete(self, msg: Dict) -> Dict:
        """Pool removal (OSDMonitor prepare_pool_op delete): rides the
        incremental's old_pools delta; daemons drop the pool's PGs on
        the next map."""
        pool_id = int(msg["pool_id"])
        with self._lock:
            if pool_id not in self.map.pools:
                return {"error": f"no pool {pool_id}"}
            del self.map.pools[pool_id]
            for pgid in [g for g in self.map.pg_temp
                         if g[0] == pool_id]:
                del self.map.pg_temp[pgid]
        return {"epoch": self._commit(f"pool {pool_id} delete")}

    def _h_reweight(self, msg: Dict) -> Dict:
        """`ceph osd reweight` (0.0-1.0 override weight)."""
        osd = int(msg["osd"])
        w = int(msg["weight"])  # 16.16 fixed point
        with self._lock:
            if not self.map.exists(osd):
                return {"error": f"no osd.{osd}"}
            self.map.osd_weight[osd] = max(0, min(0x10000, w))
            self._auto_out.pop(osd, None)
        return {"epoch": self._commit(f"osd.{osd} reweight")}

    def _h_ec_profile_set(self, msg: Dict) -> Dict:
        with self._lock:
            self.ec_profiles[msg["name"]] = dict(msg["profile"])
        return {"epoch": self._commit(f"ec profile {msg['name']}")}

    _IO_KEYS = ("rd_ops", "rd_bytes", "wr_ops", "wr_bytes",
                "degraded_reads", "ec_encode_ops", "ec_encode_bytes")

    def _h_pg_stats(self, msg: Dict) -> None:
        """One pg_stats beacon.  Io blocks are recorded per reporting
        OSD (EC reads land on every holder, not the primary); PG
        state/recovery only from primary beacons, which also refresh
        the per-PG staleness clock (the STALE_PG_STATS input)."""
        if faults._ACTIVE and faults.fires("mon.drop_pg_stats",
                                           f"mon.{self.rank}"):
            return None  # beacon lost on the floor: staleness clock
            # keeps ticking toward STALE_PG_STATS
        pgid = (int(msg["pool"]), int(msg["ps"]))
        now = time.monotonic()
        self.pc.inc("pg_stat_reports")
        reporter = int(msg.get("osd", msg.get("primary", -1)))
        with self._lock:
            if isinstance(msg.get("io"), dict):
                self._pg_io[(pgid, reporter)] = {
                    "io": {k: float(msg["io"].get(k, 0))
                           for k in self._IO_KEYS},
                    "last_report": now}
            if msg.get("io_only"):
                return None
            cur = self._pg_stats.get(pgid)
            if cur is None or int(msg.get("epoch", 0)) >= \
                    int(cur.get("epoch", 0)):
                self._pg_stats[pgid] = {
                    "state": msg.get("state", "unknown"),
                    "objects": int(msg.get("objects", 0)),
                    "primary": int(msg.get("primary", -1)),
                    "epoch": int(msg.get("epoch", 0)),
                    "degraded_objects": int(
                        msg.get("degraded_objects", 0)),
                    "recovery": {
                        k: float((msg.get("recovery") or {})
                                 .get(k, 0))
                        for k in ("objects_recovered",
                                  "bytes_recovered")},
                    "last_report": now}
                # progress events open ON RECEIPT of a degraded
                # report, not on the sampling tick: a small recovery
                # can complete inside one tick interval, and the
                # event must still exist to complete at 1.0
                if "degraded" in msg.get("state", ""):
                    self._open_progress(pgid[0], time.time())
        return None

    def _open_progress(self, pool_id: int, wall: float) -> None:
        """Open (or bump the peak of) the pool's recovery event
        (call under self._lock)."""
        cur = sum(1 for g, st in self._pg_stats.items()
                  if g[0] == pool_id
                  and "degraded" in st.get("state", ""))
        ev = self._progress_open.get(pool_id)
        if ev is None:
            self._progress_seq += 1
            ev = {"id": f"recovery-{pool_id}-{self._progress_seq}",
                  "pool": pool_id,
                  "message": f"Recovery: pool {pool_id}",
                  "started_at": wall, "updated_at": wall,
                  "peak_degraded_pgs": max(1, cur),
                  "degraded_pgs": cur,
                  "fraction": 0.0, "rate_bps": 0.0, "done": False}
            self._progress_open[pool_id] = ev
            self.log.dout(1, f"progress: {ev['id']} started "
                             f"({cur} pgs degraded)")
        else:
            ev["peak_degraded_pgs"] = max(ev["peak_degraded_pgs"],
                                          cur)
            ev["degraded_pgs"] = cur
            ev["updated_at"] = wall

    def _pg_summary(self) -> Dict:
        """PGMap aggregation (call under self._lock)."""
        by_state: Dict[str, int] = {}
        objects = 0
        degraded_pgs = 0
        for st in self._pg_stats.values():
            by_state[st["state"]] = by_state.get(st["state"], 0) + 1
            objects += st["objects"]
            if "degraded" in st["state"]:
                degraded_pgs += 1
        total = sum(p.pg_num for p in self.map.pools.values())
        return {"pgs_total": total,
                "pgs_reported": len(self._pg_stats),
                "by_state": by_state, "objects": objects,
                "degraded_pgs": degraded_pgs}

    # -- the continuous stats plane (PGMap ring / mgr progress) --------
    def _observability_tick(self, now: float) -> None:
        """Every monitor tick (leader or peon — this is local
        observability state, not replicated): fold the per-PG reports
        into per-pool stat samples, drive recovery progress events,
        and age out stale pg_stats entries."""
        grace = self.ctx.conf["mon_pg_stats_stale_grace"]
        retention = self.ctx.conf["mon_pool_stats_retention"]
        wall = time.time()
        with self._lock:
            # age out entries no primary has refreshed (a PG whose
            # every holder died must not poison health forever);
            # STALE is the intermediate, surfaced state
            expiry = 4 * grace
            stale = 0
            for pgid in list(self._pg_stats):
                age = now - self._pg_stats[pgid].get("last_report",
                                                    now)
                if age > expiry:
                    del self._pg_stats[pgid]
                elif age > grace:
                    stale += 1
            self.pc.set("stale_pgs", stale)
            for key in list(self._pg_io):
                if now - self._pg_io[key].get("last_report", now) \
                        > expiry:
                    del self._pg_io[key]
            for pool_id in self.map.pools:
                sample = {"ts": wall}
                for k in self._IO_KEYS:
                    sample[k] = sum(
                        rec["io"].get(k, 0)
                        for (pgid, _o), rec in self._pg_io.items()
                        if pgid[0] == pool_id)
                sample["objects_recovered"] = 0.0
                sample["bytes_recovered"] = 0.0
                sample["degraded_objects"] = 0
                sample["degraded_pgs"] = 0
                sample["objects"] = 0
                for pgid, st in self._pg_stats.items():
                    if pgid[0] != pool_id:
                        continue
                    rec = st.get("recovery") or {}
                    sample["objects_recovered"] += rec.get(
                        "objects_recovered", 0)
                    sample["bytes_recovered"] += rec.get(
                        "bytes_recovered", 0)
                    sample["degraded_objects"] += st.get(
                        "degraded_objects", 0)
                    sample["objects"] += st.get("objects", 0)
                    if "degraded" in st.get("state", ""):
                        sample["degraded_pgs"] += 1
                ring = self._pool_stat_ring.get(pool_id)
                if ring is None or ring.maxlen != retention:
                    ring = collections.deque(
                        ring or (), maxlen=max(2, int(retention)))
                    self._pool_stat_ring[pool_id] = ring
                ring.append(sample)
                self._update_progress(pool_id, sample, wall)

    def _update_progress(self, pool_id: int, sample: Dict,
                         wall: float) -> None:
        """mgr progress-module role (call under self._lock): a pool
        entering degraded state opens a recovery event; completion
        fraction tracks degraded PGs recovered vs the peak; the event
        completes at fraction 1.0 when the pool is clean again."""
        cur = sample["degraded_pgs"]
        ev = self._progress_open.get(pool_id)
        if ev is None:
            if cur > 0:
                self._open_progress(pool_id, wall)
            return
        ev["peak_degraded_pgs"] = max(ev["peak_degraded_pgs"], cur)
        ev["degraded_pgs"] = cur
        ev["updated_at"] = wall
        ring = self._pool_stat_ring.get(pool_id)
        if ring is not None and len(ring) >= 2:
            a, b = ring[-2], ring[-1]
            dt = max(1e-9, b["ts"] - a["ts"])
            ev["rate_bps"] = max(0.0, (b["bytes_recovered"]
                                       - a["bytes_recovered"]) / dt)
        if cur <= 0:
            ev["fraction"] = 1.0
            ev["done"] = True
            ev["ended_at"] = wall
            self._progress_done.append(ev)
            del self._progress_open[pool_id]
            self.log.dout(1, f"progress: {ev['id']} complete")
        else:
            ev["fraction"] = round(
                1.0 - cur / max(1, ev["peak_degraded_pgs"]), 4)

    def _h_pool_stats(self, msg: Dict) -> Dict:
        """`ceph_cli pool-stats`: per-pool rate SERIES derived from
        the sample ring at read time (deltas clamped at 0: a primary
        change resets cumulative counters)."""
        want = msg.get("pool")
        with self._lock:
            rings = {pid: list(ring) for pid, ring in
                     self._pool_stat_ring.items()
                     if want is None or pid == int(want)}
        pools: Dict[str, Dict] = {}
        rate_keys = (("wr_bps", "wr_bytes"), ("rd_bps", "rd_bytes"),
                     ("wr_ops_s", "wr_ops"), ("rd_ops_s", "rd_ops"),
                     ("ec_encode_bps", "ec_encode_bytes"),
                     ("recovery_bps", "bytes_recovered"),
                     ("recovery_objs_s", "objects_recovered"))
        for pid, samples in rings.items():
            series = []
            for a, b in zip(samples, samples[1:]):
                dt = max(1e-9, b["ts"] - a["ts"])
                row = {"ts": b["ts"], "dt": round(dt, 3),
                       "degraded_pgs": b["degraded_pgs"],
                       "degraded_objects": b["degraded_objects"]}
                for out_k, in_k in rate_keys:
                    row[out_k] = max(0.0, (b.get(in_k, 0)
                                           - a.get(in_k, 0)) / dt)
                series.append(row)
            pools[str(pid)] = {
                "series": series,
                "current": dict(samples[-1]) if samples else {}}
        return {"pools": pools}

    def _h_progress(self, _msg: Dict) -> Dict:
        """`ceph_cli progress`: open + recently completed recovery
        events (the mgr progress-module surface)."""
        with self._lock:
            events = [dict(e) for e in
                      self._progress_open.values()]
            events += [dict(e) for e in self._progress_done]
        events.sort(key=lambda e: e.get("started_at", 0))
        return {"events": events}

    def _h_health(self, _msg: Dict) -> Dict:
        """HEALTH_OK / HEALTH_WARN with typed, coded reasons — the
        `ceph health` surface (src/mon/HealthMonitor.cc role).  Each
        check is "CODE: summary"; the machine-readable code list rides
        alongside as ``check_codes``."""
        now = time.monotonic()
        grace = self.ctx.conf["mon_pg_stats_stale_grace"]
        slow_grace = self.ctx.conf["mon_slow_recovery_grace"]
        with self._lock:
            # down-AND-IN osds (the reference's OSD_DOWN scope): an
            # osd the cluster already marked out has been remapped
            # around — it no longer degrades service, so it must not
            # pin health at WARN after recovery completes
            down = [o for o in range(self.map.max_osd)
                    if self.map.exists(o) and not self.map.is_up(o)
                    and self.map.osd_weight[o] > 0]
            # sorted() snapshots the keys: _is_dampened prunes (and
            # may delete) log entries while we iterate
            flapping = [o for o in sorted(self._markdown_log)
                        if self._is_dampened(o, now)]
            pgs = self._pg_summary()
            stale = [pgid for pgid, st in self._pg_stats.items()
                     if now - st.get("last_report", now) > grace]
            recovering = [dict(e) for e in
                          self._progress_open.values()]
            slow = [e for e in recovering
                    if time.time() - e.get("started_at", 0)
                    > slow_grace]
            mgr_checks: Dict[str, str] = {}
            if self._mgr_health is not None and \
                    now - self._mgr_health["ts"] < grace:
                mgr_checks = dict(self._mgr_health["checks"])
            # fresh per-daemon SLO cargo from the beacons: slow ops
            # (SLOW_OPS) and heartbeat-RTT breaches
            # (OSD_SLOW_PING_TIME); entries past the grace are a dead
            # or wedged reporter's last words, not live state
            slow_ops: Dict[int, Dict] = {}
            slow_pings: Dict[int, list] = {}
            for osd, e in list(self._osd_slo.items()):
                if now - e["ts"] > 4 * grace:
                    del self._osd_slo[osd]
                    continue
                if now - e["ts"] > grace:
                    continue
                so = e.get("slow_ops")
                if so and so.get("count"):
                    slow_ops[osd] = so
                sp = e.get("slow_pings")
                if sp:
                    slow_pings[osd] = sp
        checks = []
        if slow_ops:
            # the reference's `N slow ops, oldest one blocked for X
            # sec, daemons [osd.a,osd.b] have slow ops.` summary line
            total = sum(int(s.get("count", 0))
                        for s in slow_ops.values())
            oldest = max(float(s.get("oldest_age", 0.0))
                         for s in slow_ops.values())
            daemons = [f"osd.{o}" for o in sorted(slow_ops)]
            checks.append(
                f"SLOW_OPS: {total} slow ops, oldest one blocked "
                f"for {oldest:.1f} sec, daemons {daemons} have "
                f"slow ops.")
        if slow_pings:
            pairs = sorted(
                ((o, int(b["peer"]), float(b["avg_ms"]))
                 for o, bs in slow_pings.items() for b in bs),
                key=lambda p: p[2], reverse=True)
            worst = ", ".join(f"osd.{a}->osd.{b} {ms:.0f}ms"
                              for a, b, ms in pairs[:8])
            checks.append(
                f"OSD_SLOW_PING_TIME: {len(pairs)} slow osd "
                f"heartbeat pings (worst first): {worst}")
        if down:
            checks.append(f"OSD_DOWN: {len(down)} osds down: {down}")
        if flapping:
            # dampened daemons are auto-outed (not counted by
            # OSD_DOWN's weight>0 scope), so flapping gets its own
            # coded check and clears when the markdown log drains
            checks.append(f"OSD_FLAPPING: {len(flapping)} osd(s) "
                          f"flapping (markdown-dampened): {flapping}")
        if pgs["degraded_pgs"] or recovering:
            # an OPEN recovery event counts: a fast recovery's
            # degraded beacons may be superseded between two health
            # polls, but the cluster WAS degraded until the event
            # completes (mirrors the reference, where PG_DEGRADED
            # clears only when recovery finishes)
            n = max(pgs["degraded_pgs"],
                    max((e["degraded_pgs"] for e in recovering),
                        default=0), 1)
            checks.append(f"PG_DEGRADED: {n} pgs degraded "
                          f"(recovery in progress)")
        not_clean = {s: n for s, n in pgs["by_state"].items()
                     if "clean" not in s}
        if not_clean:
            checks.append(f"pgs not clean: {not_clean}")
        if stale:
            checks.append(
                f"STALE_PG_STATS: {len(stale)} pgs have had no "
                f"primary report for >{grace:.0f}s: "
                f"{sorted(stale)[:8]}")
        for ev in slow:
            age = time.time() - ev["started_at"]
            checks.append(
                f"SLOW_RECOVERY: {ev['id']} open {age:.0f}s at "
                f"fraction {ev['fraction']} "
                f"({ev['rate_bps']:.0f} B/s)")
        if pgs["pgs_reported"] < pgs["pgs_total"]:
            checks.append(
                f"{pgs['pgs_total'] - pgs['pgs_reported']} pgs never "
                f"reported by a primary")
        for code in sorted(mgr_checks):
            checks.append(f"{code}: {mgr_checks[code]}")
        return {"status": "HEALTH_OK" if not checks else "HEALTH_WARN",
                "checks": checks,
                "check_codes": sorted({c.split(":", 1)[0]
                                       for c in checks if ":" in c
                                       and c.split(":", 1)[0].isupper()
                                       }),
                "pgmap": pgs}

    def _h_status(self, _msg: Dict) -> Dict:
        with self._lock:
            up = [o for o in range(self.map.max_osd)
                  if self.map.is_up(o)]
            return {"epoch": self.map.epoch, "up_osds": up,
                    "num_pools": len(self.map.pools),
                    "pgmap": self._pg_summary(),
                    "subscribers": sorted(self._subscribers)}

    # -- failure detection ------------------------------------------------
    def _reporter_subtree(self, osd: int) -> int:
        """CRUSH node id of the reporter's failure-domain subtree at
        ``mon_osd_reporter_subtree_level`` (check_failure's reporter
        dedup: two osds on one host are ONE witness).  An osd not
        placed in the crush tree is its own subtree."""
        from ..crush.wrapper import DEFAULT_TYPES

        level = self.ctx.conf["mon_osd_reporter_subtree_level"]
        want = next((t for t, n in DEFAULT_TYPES.items()
                     if n == level), 1)
        node, hops = osd, 0
        while hops < 16:  # cycle guard; real trees are depth ~4
            hops += 1
            b = next((b for b in self.map.crush.buckets.values()
                      if node in b.items), None)
            if b is None:
                return node
            if b.type >= want:
                return b.id
            node = b.id
        return node

    @nonblocking
    def _h_osd_failure(self, msg: Dict) -> None:
        """OSDMonitor::check_failure — a peer's osd_failure report.
        Mark down only once reports arrive from enough DISTINCT
        failure-domain subtrees: a cut link to one host (or to this
        monitor) can no longer kill a healthy osd on its own."""
        failed = int(msg["osd"])
        reporter = int(msg["frm_osd"])
        self.pc.inc("failure_reports")
        grace = self.ctx.conf["osd_heartbeat_grace"]
        need = self.ctx.conf["mon_osd_min_down_reporters"]
        now = time.monotonic()
        with self._lock:
            if failed == reporter or not self.map.exists(failed):
                return None
            if not self.map.is_up(failed):
                # already down: late reports are stale, not evidence
                # against the NEXT incarnation
                self._failure_reports.pop(failed, None)
                return None
            failed_for = float(msg.get("failed_for", 0.0))
            if now - failed_for < self._up_from.get(failed, 0.0):
                # the reporter's silence window opened before this
                # incarnation booted: stale evidence (the
                # failed_since >= up_from rule) — without it a cut
                # link would re-kill a re-booting osd every beat
                # instead of after a fresh full grace
                return None
            reps = self._failure_reports.setdefault(failed, {})
            reps[reporter] = now
            for r, ts in list(reps.items()):
                if now - ts > 2 * grace:  # report decay
                    del reps[r]
            subtrees = {self._reporter_subtree(r) for r in reps}
            enough = len(subtrees) >= need
            reporters = sorted(reps)
        if enough:
            self.log.dout(
                1, f"osd.{failed} failed by {len(subtrees)} "
                   f"subtree(s), reporters {reporters}")
            try:
                self.mark_down(failed)  # block-ok: markdown commits synchronously by design — epoch order would break if deferred; replicate is deadline-bounded (5s call timeout, dead peons skipped) and the store write is a local rename
            except RuntimeError as e:
                self.log.derr(f"failure markdown aborted: {e}")
        return None

    def _is_dampened(self, osd: int, now: float) -> bool:
        """True while the osd's markdown log crosses
        ``osd_max_markdown_count`` within ``osd_max_markdown_period``
        (caller holds the lock).  Prunes the log as a side effect."""
        log = self._markdown_log.get(osd)
        if not log:
            return False
        period = self.ctx.conf["osd_max_markdown_period"]
        while log and now - log[0] > period:
            log.popleft()
        if not log:
            del self._markdown_log[osd]
            return False
        return len(log) >= self.ctx.conf["osd_max_markdown_count"]

    def mark_down(self, osd: int) -> int:
        from ..osdmap.osdmap import OSD_EXISTS

        with self._lock:
            if not self.map.is_up(osd):
                return self.map.epoch
            self.map.osd_state[osd] = OSD_EXISTS  # up bit cleared
            self._last_beat.pop(osd, None)
            self._down_since[osd] = time.monotonic()
            # consumed: the reports did their job; a fresh incarnation
            # must be condemned by fresh evidence, not leftovers
            self._failure_reports.pop(osd, None)
            now = time.monotonic()
            mdl = self._markdown_log.setdefault(
                osd, collections.deque())
            mdl.append(now)
            dampened = self._is_dampened(osd, now)
            if dampened and self.map.osd_weight[osd] > 0:
                # flapping: don't wait out mon_osd_down_out_interval —
                # remap around the unstable daemon NOW (auto-out, so
                # a stable re-boot restores the weight)
                self._auto_out[osd] = self.map.osd_weight[osd]
                self.map.osd_weight[osd] = 0
                self._down_since.pop(osd, None)
        self.pc.inc("markdowns")
        if dampened:
            self.pc.inc("markdowns_dampened")
            self.log.dout(1, f"osd.{osd} marked down (flapping: "
                             f"dampened + auto-out)")
        else:
            self.log.dout(1, f"osd.{osd} marked down")
        return self._commit(f"osd.{osd} down")

    def _tick_loop(self) -> None:
        grace = self.ctx.conf["osd_heartbeat_grace"]
        interval = self.ctx.conf["osd_heartbeat_interval"]
        out_interval = self.ctx.conf["mon_osd_down_out_interval"]
        # the direct osd->mon beacon is liveness-of-last-resort only:
        # peer osd_failure reports (check_failure) are the primary
        # detector, so a beacon gap alone — a cut mon link, a loaded
        # beat thread — gets a MUCH longer rope before the monitor
        # acts unilaterally (the mon_osd_report_timeout role)
        report_timeout = self.ctx.conf["mon_osd_report_timeout"] \
            or 5 * grace
        while self._running:
            time.sleep(interval / 2)  # fault-ok: failure-detection
            # tick cadence, not retry pacing against a failing peer
            # the stats plane ticks on EVERY member (observability is
            # local state; any mon serves pool-stats/progress/health)
            try:
                self._observability_tick(time.monotonic())
            except Exception as e:
                self.log.derr(f"observability tick failed: {e}")
            if self.quorum is not None and not self.quorum.is_leader():
                continue  # failure detection is the leader's job
            now = time.monotonic()
            stale = []
            to_out = []
            with self._lock:
                for osd, last in self._last_beat.items():
                    if now - last > report_timeout and \
                            self.map.is_up(osd):
                        stale.append(osd)
                # down -> out after the grace window: clearing the
                # in/out weight is what makes CRUSH remap the osd's
                # positions so backfill can begin (the reference's
                # mon_osd_down_out_interval flow).  Every down, in osd
                # has a stamp, as the reference's down_pending_out is
                # filled from the map: one marked down under an earlier
                # leader starts its clock here, and a stamp stays until
                # the map has the osd up or out, so an out whose commit
                # aborted is proposed again on the next tick
                for osd in range(self.map.max_osd):
                    if self.map.exists(osd) and not self.map.is_up(osd) \
                            and self.map.osd_weight[osd] > 0:
                        self._down_since.setdefault(osd, now)
                for osd, since in list(self._down_since.items()):
                    if not self.map.exists(osd) or \
                            self.map.is_up(osd) or \
                            self.map.osd_weight[osd] == 0:
                        del self._down_since[osd]
                    elif now - since > out_interval:
                        to_out.append(osd)
            # a lost quorum mid-commit raises; the tick thread must
            # survive it (the next leader retries the mark-down)
            try:
                for osd in stale:
                    self.log.dout(1, f"osd.{osd} heartbeat stale")
                    self.mark_down(osd)
                for osd in to_out:
                    self.log.dout(1, f"osd.{osd} auto-out")
                    with self._lock:
                        # it may have re-booted since the scan
                        if self.map.is_up(osd) or \
                                self.map.osd_weight[osd] == 0:
                            continue
                        self._auto_out[osd] = self.map.osd_weight[osd]
                        self.map.osd_weight[osd] = 0
                    self._commit(f"osd.{osd} auto-out")
            except RuntimeError as e:
                self.log.derr(f"tick commit aborted: {e}")


class _SubPusher:
    """One subscriber's map-push lane: a bounded queue drained by its
    own thread.  A peer that stops reading fills only its own queue
    (oldest entries dropped — it will catch up via incrementals or a
    full fetch) and can never stall the monitor's commit path."""

    def __init__(self, msgr: Messenger, addr: Addr, depth: int = 64):
        self.msgr = msgr
        self.addr = tuple(addr)
        self.q: "queue.Queue[Optional[Dict]]" = queue.Queue(depth)
        self._th = threading.Thread(target=self._run, daemon=True,
                                    name=f"mon-push:{addr[1]}")
        self._th.start()

    def push(self, msg: Dict) -> None:
        while True:
            try:
                self.q.put_nowait(msg)
                return
            except queue.Full:
                try:
                    self.q.get_nowait()  # drop-oldest
                except queue.Empty:
                    pass

    def _run(self) -> None:
        while True:
            msg = self.q.get()
            if msg is None:
                return
            self.msgr.send(self.addr, msg)

    def stop(self) -> None:
        try:
            self.q.put_nowait(None)
        except queue.Full:
            pass  # drain beats a leak; the daemon thread dies with us
