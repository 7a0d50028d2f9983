"""OSD service — the storage daemon analogue.

The role of src/osd (OSD.cc dispatch + PrimaryLogPG + ECBackend),
single-host scale: MemStore/WALStore-backed shard storage per PG
collection, EC-positional shard writes/reads (the ECBackend sub-op
surface, ECBackend.cc:934/1015), mon boot + heartbeats
(ceph_osd.cc:544), map subscriptions, and primary-driven peering +
recovery.

Peering (the PeeringState.cc / PGLog.h role, redesigned around
versioned objects instead of a log-offset state machine): every write
carries a totally-ordered version (map epoch + timestamp, identical on
every shard of the object), and every PG keeps a version-keyed log
with delete tombstones.  On each map change the PG's primary collects
``pg_info`` (last_update + per-object version map, folded from the
log) from every reachable member of the up and acting sets, merges
them into the authoritative per-object state — exactly the result the
reference reaches by electing the authoritative log and merging
divergent entries (PeeringState::choose_acting /
PGLog::merge_log) — computes each member's missing set, and drives
recovery: pull what the primary lacks, push what replicas lack,
propagate deletes.  Divergent histories (A took writes while B was
down, then roles flipped) reconcile to newest-version-wins, which the
reference guarantees through past-intervals + log election.

While the primary is itself behind, it installs a ``pg_temp`` overlay
at the monitor mapping the PG to the best-covered holder
(OSDMap.cc:2590 acting override) so reads keep being served, and
clears it once clean — the serving-continuity half of peering.

The port's copy of ``ceph_tpu/services/osd_service.py``: the same
peering, write, read, scrub and recovery logic on the port's runtime.
The EC codes are built on the daemon's ``device`` (the card unless the
caller asks for the CPU; a profile with ``engine=native`` needs none),
so a primary's encodes, read-modify-write decodes and recovery decodes
are K1 or K3 launches.  Their chunks come back to the host in one
stacked copy a call.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..analysis import faults
from ..analysis.lockdep import make_lock, make_rlock
from ..analysis.racecheck import guarded_by
from ..common import copytrack
from ..common.backoff import Backoff
from ..common.context import Context
from ..common.throttle import Throttle
from ..ec.registry import profile_factory
from ..msg.messenger import Addr, Messenger
from ..os.memstore import MemStore
from ..os.objectstore import Transaction
from ..osdmap.osdmap import OSDMap, POOL_TYPE_ERASURE


from ..common.encoding import MalformedInput
from ..common.op_queue import Requeue
from ..common.version import NULL_VERSION, bump, make_version
from .pg_log import PgLogEntry
from .recovery import HelperLedger, ReservationBook


def pg_cid(pool_id: int, ps: int) -> str:
    return f"{pool_id}.{ps}"


def host_rows(rows):
    """Equal-length uint8 chunks (tensors on a code's device) as one
    host array u8[len(rows), L], in one copy off the device (on the
    CPU, one copy of the rows)."""
    import torch

    return torch.stack(list(rows)).cpu().numpy()


from .map_follower import MapFollower


@guarded_by("osd::state", "_pg_states", "_watchers", "_strays")
@guarded_by("osd::pg_io", "_pg_io")
@guarded_by("osd::pg_guard", "_pg_locks")
class OSDService(MapFollower):
    def __init__(self, ctx: Context, osd_id: int, mon_addr: Addr,
                 host: str = "127.0.0.1", port: int = 0, keyring=None,
                 data_dir: Optional[str] = None, device="cuda"):
        self.ctx = ctx
        self.id = osd_id
        # where this daemon's EC codes live (ec/registry.factory)
        self.device = device
        self.log = ctx.logger("osd")
        self._init_mons(mon_addr)  # one addr or the quorum list
        # data_dir = the OSD's persistent volume (superblock + data):
        # a restart remounts the checkpoint instead of backfilling
        # everything from peers (the reference's restart-replay flow)
        self.data_dir = data_dir
        self.store = self._mount()
        # lossless policy (osd↔osd sub-ops survive reconnects) and the
        # per-type byte throttle bounding in-flight client write bytes
        # (the osd_client_message_size_cap role, ceph_osd.cc:582-588)
        self.tracer = ctx.tracer  # shared with the messenger: handler
        # spans parent service spans (ec.encode under handle:ec_write)
        self.msgr = Messenger(
            f"osd.{osd_id}", host, port, keyring=keyring,
            lossless=True,
            throttles={"shard_write": Throttle(
                "msgr-write-bytes", 64 << 20)},
            tracer=self.tracer, perf=ctx.perf)
        self.addr = self.msgr.addr
        self.map: Optional[OSDMap] = None
        self.epoch = 0
        self.osd_addrs: Dict[int, Addr] = {}
        self.ec_profiles: Dict[str, Dict[str, str]] = {}
        self._codes: Dict[str, object] = {}
        self._lock = make_rlock("osd::state")
        self._running = False
        self._beat_thread: Optional[threading.Thread] = None
        self._recover_thread: Optional[threading.Thread] = None
        self._recover_wake = threading.Event()
        # set by shutdown(): the beat loop waits on THIS between
        # beacons (not a fixed sleep), so teardown never stalls a
        # full heartbeat interval behind a sleeping thread
        self._shutdown_ev = threading.Event()
        self.backfill_throttle = Throttle(
            "backfill", ctx.conf["osd_max_backfills"])
        # per-PG serialization: RMW coordination AND the local
        # check-then-write path (reentrant: the RMW coordinator's
        # self-push re-enters its own PG lock).  All PG locks share
        # the "osd::pg" lockdep node: cross-PG nesting on one thread
        # never happens (a PG has one primary; pushes to OTHER PGs go
        # over the wire), so same-name nesting stays un-edged
        self._pg_locks: Dict[Tuple[int, int], object] = {}
        self._pg_locks_guard = make_lock("osd::pg_guard")
        from ..common.op_queue import OpScheduler
        from ..common.op_tracker import OpTracker

        # the SLOW_OPS knob: one threshold feeds both the historic-
        # slow ring and the slow-op count the beacon reports to the
        # monitor's health fold
        self.optracker = OpTracker(
            history_slow_threshold=ctx.conf["osd_op_complaint_time"])
        # cross-thread EC encode coalescing: concurrent same-pool
        # writes share one batched engine dispatch (ec/batcher.py)
        from ..ec.batcher import EncodeBatcher

        self._ec_batcher = EncodeBatcher(
            max_delay_us=ctx.conf["ec_encode_batch_max_delay_us"])
        # (cid, oid) -> {watcher name: addr}: the Watch/Notify state
        # (src/osd/Watch.cc role).  In-memory: clients re-watch on map
        # changes, exactly like librados re-watches on reconnect.
        self._watchers: Dict[Tuple[str, str], Dict[str, Addr]] = {}
        # (pool, ps) -> stray holders that reported data for a PG this
        # osd is primary of (the MOSDPGNotify stray flow): peering
        # queries them so shards that remapped AWAY from the up set
        # stay reachable, and purges them once the PG is clean
        self._strays: Dict[Tuple[int, int], Set[int]] = {}
        # (pool, ps) -> monotonic time of the last scheduled deep
        # scrub this primary ran (PG::sched_scrub role); the semaphore
        # is the osd_max_scrubs=1 concurrency cap
        self._last_scrub: Dict[Tuple[int, int], float] = {}
        self._scrub_slots = threading.Semaphore(1)
        # dmClock QoS at the store door: client vs recovery vs scrub
        # ops are served in tag order by a small worker pool (4: a
        # window of pipelined client writes must overlap their
        # store commits, not serialize two at a time)
        self.sched = OpScheduler(n_workers=4)
        self.pc = ctx.perf.create(f"osd.{osd_id}")
        for key in ("ops_w", "ops_r", "degraded_reads",
                    "recovered_objects", "recovery_bytes",
                    "map_epochs", "pg_stat_beacons"):
            self.pc.add_u64_counter(key)
        # the byte-copy ledger (common/copytrack.py): EC input
        # assembly and recovery pushes book their host copies here
        self._copy_pc = copytrack.ledger(ctx.perf)
        # the recovery engine's own counter family (osd.recovery.*):
        # pipeline shape, helper fan-out/exclusions, reservation
        # back-pressure, and per-unit repair-strategy bookkeeping
        pc = self.rec_pc = ctx.perf.create(f"osd.recovery.{osd_id}")
        for key in ("pipelined_batches", "serial_batches",
                    "helper_reads", "helper_bytes",
                    "helper_bytes_saved", "helper_eio_excluded",
                    "replans", "strategy_full", "strategy_lrc",
                    "strategy_clay", "reservation_waits",
                    "remote_denials"):
            pc.add_u64_counter(key)
        # helper-read load balancing + per-object failure exclusions,
        # and the AsyncReserver-lite slot pool shared by local recovery
        # work and grants to remote primaries
        self.rec_ledger = HelperLedger()
        self.rec_reserver = ReservationBook(
            ctx.conf["osd_max_recovery_ops"])
        # per-PG cumulative io/recovery counters (the pg_stat_t
        # io/recovery sums): client read/write ops+bytes, EC encode
        # volume, recovery pushes — piggybacked on pg_stats beacons
        # for the monitor's PGMap per-pool aggregation
        self._pg_io: Dict[Tuple[int, int], Dict[str, float]] = {}
        self._pg_io_lock = make_lock("osd::pg_io")
        # (pool, ps) -> last peering verdict this PRIMARY computed
        # (state string, object/degraded counts): what the periodic
        # beacons re-send between peering passes
        self._pg_states: Dict[Tuple[int, int], Dict] = {}

        # map pushes and peering probes ride the control lane: a burst
        # of 16 queued shard writes holds every op-pool worker in the
        # object store, and failure detection / remapping must not
        # head-of-line-block behind it
        control = {"map_update", "map_inc", "pg_info", "pg_poke",
                   "pg_stray", "recovery_reserve"}
        for t, h in (("shard_write", self._h_shard_write),
                     ("shard_read", self._h_shard_read),
                     ("pg_list", self._h_pg_list),
                     ("pg_info", self._h_pg_info),
                     ("pg_scrub", self._h_pg_scrub),
                     ("shard_remove", self._h_shard_remove),
                     ("obj_delete", self._h_obj_delete),
                     ("ec_write", self._h_ec_write),
                     ("rep_write", self._h_rep_write),
                     ("watch", self._h_watch),
                     ("unwatch", self._h_unwatch),
                     ("notify", self._h_notify),
                     ("pg_poke", self._h_pg_poke),
                     ("pg_stray", self._h_pg_stray),
                     ("pg_log_trim", self._h_pg_log_trim),
                     ("recovery_reserve", self._h_recovery_reserve),
                     ("pg_purge", self._h_pg_purge),
                     ("map_update", self._h_map_update),
                     ("map_inc", self._h_map_inc),
                     ("status", self._h_status)):
            self.msgr.register(t, h, control=t in control)

        # the peer failure detector (OSD::heartbeat role): registers
        # its osd_ping/osd_ping_reply control-lane handlers here;
        # started with the daemon, peers recomputed per map install
        from .heartbeat import HeartbeatPlane

        self.hb = HeartbeatPlane(self)

    # -- persistence (superblock/restart-replay role) -------------------
    def _mount(self):
        """Without a data_dir the OSD is a pure in-RAM daemon
        (MemStore); with one, it runs the crash-consistent WALStore —
        every acked transaction survives kill -9, and a restart
        remounts checkpoint+WAL instead of backfilling from peers (the
        reference's BlueStore+superblock restart-replay flow)."""
        if self.data_dir is None:
            return MemStore(copy_coll=self.ctx.perf)
        import os

        from ..os.wal_store import WALStore

        path = os.path.join(self.data_dir, f"osd.{self.id}.wal")
        st = WALStore(path, group_commit_max_delay_us=self.ctx.conf[
            "wal_group_commit_max_delay_us"],
            copy_coll=self.ctx.perf)
        if not os.path.exists(os.path.join(path, "checkpoint")):
            st.mkfs()
        st.mount()
        return st

    def _flush(self) -> None:
        from ..os.wal_store import WALStore

        if isinstance(self.store, WALStore):
            self.store.umount()

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        if self.ctx.conf["admin_socket"]:
            # the daemon's introspection plane: perf dump (own +
            # shared library counters), dump_tracing, op tracker,
            # dump_blocked — what a telemetry poller reads
            sock = self.ctx.start_admin_socket()
            self.optracker.wire(sock)
            self.tracer.wire(sock)
            self.msgr.wire(sock)   # dump_messenger
            self.hb.wire(sock)     # dump_osd_network
        self.msgr.start()
        self._running = True
        boot = self.mon_call({"type": "boot", "osd": self.id,
                              "addr": list(self.addr)}, tries=10)
        payload = self.subscribe_all(f"osd.{self.id}")
        self._install_map(payload)
        self.log.dout(1, f"osd.{self.id} up (boot epoch "
                         f"{boot.get('epoch')})")
        self._beat_thread = threading.Thread(
            target=self._beat_loop, daemon=True,
            name=f"osd{self.id}-beat")
        self._beat_thread.start()
        self._recover_thread = threading.Thread(
            target=self._recover_loop, daemon=True,
            name=f"osd{self.id}-recover")
        self._recover_thread.start()
        self.hb.update_peers()
        self.hb.start()

    def shutdown(self) -> None:
        self._running = False
        self._shutdown_ev.set()
        self.hb.stop()
        self._recover_wake.set()
        pool = getattr(self, "_fanout_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
        pool = getattr(self, "_recover_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
        self.sched.shutdown()
        self.msgr.shutdown()
        self.ctx.shutdown()  # admin socket + config observers
        try:
            self._flush()
        except OSError as e:
            self.log.derr(f"checkpoint flush failed: {e}")

    # -- map handling (install/inc-apply live in MapFollower) ----------
    def _post_map_install(self) -> None:
        with self._lock:
            wrongly_down = self._running and self.map is not None \
                and not self.map.is_up(self.id)
            epoch = self.epoch
        self.pc.inc("map_epochs")
        if wrongly_down:
            # we observed our own markdown but we're alive: re-boot to
            # the mon (the reference OSD's "map says I'm down" flow)
            self.log.dout(1, f"osd.{self.id} marked down in epoch "
                             f"{epoch}; re-booting to mon")
            self.mon_send({"type": "boot", "osd": self.id,
                           "addr": list(self.addr)})
        self.hb.update_peers()
        self._recover_wake.set()

    def _h_map_update(self, msg: Dict) -> None:
        self._install_map(msg["payload"])
        return None

    def _code_for(self, pool) -> Optional[object]:
        if pool.pool_type != POOL_TYPE_ERASURE:
            return None
        name = pool.erasure_code_profile
        code = self._codes.get(name)
        if code is None:
            code = profile_factory(dict(self.ec_profiles[name]),
                                   device=self.device)
            self._codes[name] = code
        return code

    # -- op handlers (the ECBackend sub-op surface) --------------------
    def _qos_class(self, msg: Dict) -> str:
        cls = msg.get("qos_class")
        return cls if cls in ("client", "recovery", "scrub") \
            else "client"

    # -- per-PG io/recovery accounting (pg_stat_t sums role) -----------
    _IO_KEYS = ("rd_ops", "rd_bytes", "wr_ops", "wr_bytes",
                "degraded_reads", "ec_encode_ops", "ec_encode_bytes")
    _RECOVERY_KEYS = ("objects_recovered", "bytes_recovered")

    def _account_io(self, pool_id: int, ps: int, **deltas) -> None:
        with self._pg_io_lock:
            rec = self._pg_io.setdefault(
                (pool_id, ps),
                {k: 0 for k in self._IO_KEYS + self._RECOVERY_KEYS})
            for k, v in deltas.items():
                rec[k] = rec.get(k, 0) + v

    def _send_pg_stats(self, pool_id: int, ps: int) -> None:
        """One pg_stats beacon: cached peering state (when this OSD is
        the PG's primary) + cumulative io/recovery counters.  Any
        shard holder reports io (EC reads land on every member, not
        the primary); only primary beacons carry state, so the
        monitor's staleness clock tracks primaries."""
        key = (pool_id, ps)
        with self._pg_io_lock:
            io = dict(self._pg_io.get(key) or {})
        with self._lock:
            state = self._pg_states.get(key)
        msg: Dict = {"type": "pg_stats", "pool": pool_id, "ps": ps,
                     "osd": self.id, "epoch": self.epoch,
                     "io": {k: io.get(k, 0) for k in self._IO_KEYS}}
        if state is not None:
            msg.update({"state": state["state"],
                        "objects": state["objects"],
                        "primary": self.id,
                        "degraded_objects": state["degraded_objects"],
                        "recovery": {k: io.get(k, 0)
                                     for k in self._RECOVERY_KEYS}})
        else:
            msg["io_only"] = True
        self.mon_send(msg)
        self.pc.inc("pg_stat_beacons")

    def _stat_beacon_pass(self) -> None:
        """Periodic pg_stats beacons (the mgr stats-report cadence):
        re-send every PG this OSD has state or io for, dropping state
        cache entries for PGs it no longer leads."""
        with self._pg_io_lock:
            keys = set(self._pg_io)
        with self._lock:
            keys |= set(self._pg_states)
            m = self.map
        for pool_id, ps in sorted(keys):
            if m is not None and pool_id not in m.pools:
                # the pool is gone: its counters go with it (a stale
                # key must not abort every later beacon pass)
                with self._pg_io_lock:
                    self._pg_io.pop((pool_id, ps), None)
                with self._lock:
                    self._pg_states.pop((pool_id, ps), None)
                continue
            # membership check under the state lock: the unlocked
            # read raced _h_pg_remove's pop from a dispatch thread
            # (caught by racecheck's empty-lockset report)
            with self._lock:
                leads = (pool_id, ps) in self._pg_states
            if m is not None and leads:
                up, _p, acting, _ap = self.pg_up_acting(pool_id, ps)
                members = acting if acting else up
                prim = next((o for o in members if self._alive(o)),
                            None)
                if prim != self.id:
                    with self._lock:
                        self._pg_states.pop((pool_id, ps), None)
            self._send_pg_stats(pool_id, ps)

    def _h_shard_write(self, msg: Dict) -> Dict:
        # the scheduler worker adopts this handler's span, so the
        # store-commit span lands under handle:shard_write instead of
        # orphaning when the op crosses the queue
        parent_span = self.tracer.current()

        def run():
            with self.tracer.scope(parent_span):
                return self._do_shard_write(msg)

        return self.sched.submit(self._qos_class(msg), run)

    def _do_shard_write(self, msg: Dict) -> Dict:
        from ..ec.stripe import crc32c

        if faults._ACTIVE:  # one bool test when nothing is armed
            if faults.fires("osd.kill_before_commit",
                            f"osd.{self.id}"):
                # died before the WAL commit: no data, no ack — the
                # sender's retry must land cleanly
                raise faults.InjectedKill("before WAL commit")
        cid = pg_cid(msg["pool"], msg["ps"])
        v = msg.get("v") or make_version(self.epoch)
        oid = f"{msg['oid']}.s{msg['shard']}"
        with self.optracker.create(
                "osd_op", f"write {cid}/{oid} from "
                          f"{msg.get('frm')}") as op:
            if faults._ACTIVE:
                # the slow-disk delay, BEFORE the PG lock (a slow op
                # must stall itself, not everything queued behind the
                # lock) but INSIDE the tracked scope: the op ages
                # visibly in dump_ops_in_flight and the SLOW_OPS
                # beacon while it sleeps, as a real slow disk would
                faults.sleep_if("osd.slow_op", f"osd.{self.id}")
            # per-PG lock, not the global one: a WALStore fsync per
            # write must never serialize the whole daemon or stall map
            # handling behind the write stream.  Bounded: a miss
            # requeues instead of pinning the scheduler worker.
            with self._pg_lock_bounded(msg["pool"], msg["ps"]):
                # a newer version (a divergent-history reconciliation
                # or a racing later write) must never be clobbered by
                # an older one arriving late
                cur = self.store.getattr(cid, oid, "v") \
                    if self.store.collection_exists(cid) else None
                rollback = False
                if cur is not None and cur.decode() > v:
                    if not msg.get("force") or (
                            msg.get("expect") is not None
                            and cur.decode() != msg["expect"]):
                        # `cur` lets the writer re-stamp past the
                        # stored version (clock-skew repair) instead
                        # of mistaking the discard for success
                        return {"ok": True, "superseded": True,
                                "cur": cur.decode(),
                                "epoch": self.epoch}
                    # authoritative rollback of a torn (never-acked)
                    # higher-version shard: fall through and overwrite
                    rollback = True
                txn = Transaction()
                if not self.store.collection_exists(cid):
                    txn.create_collection(cid)
                # buffer-protocol payload (a view into the frame's
                # pooled recv segment): staged zero-copy — the store
                # materialises it into its own image inside
                # queue_transaction, before this handler returns
                data = msg["data"]
                txn.write(cid, oid, 0, data)
                # a shorter rewrite must never leave a stale tail:
                # chunk boundaries shift and EC decode would interleave
                # old bytes into the new object
                txn.truncate(cid, oid, len(data))
                txn.setattr(cid, oid, "size",
                            str(msg["size"]).encode())
                txn.setattr(cid, oid, "crc",
                            str(crc32c(data)).encode())
                txn.setattr(cid, oid, "v", v.encode())
                if rollback:
                    # the torn entries must leave the log too, or the
                    # per-object "newest record" (what peering and
                    # trim consume) keeps resurrecting the rolled-back
                    # version (PGLog::rewind_divergent)
                    drop = self._log_keys_above(cid, msg["oid"], v)
                    if drop:
                        txn.omap_rmkeys(cid, "pglog", drop)
                txn.omap_setkeys(cid, "pglog", {
                    f"{v}|{msg['shard']}": PgLogEntry(
                        op="write", oid=msg["oid"],
                        shard=msg["shard"], v=v,
                        size=msg["size"]).encode_blob()})
                op.mark_event("queued_for_store")
                # the WAL stage: queue_transaction through the
                # group-commit fsync ack (attribution stage "wal")
                with self.tracer.start_span(
                        "store.commit", require_parent=True,
                        tags={"bytes": len(data)}):
                    self.store.queue_transaction(txn)
            op.mark_event("commit")
            if faults._ACTIVE and faults.fires(
                    "osd.kill_after_commit", f"osd.{self.id}"):
                # died after the WAL commit: data durable, ack lost —
                # the retry's rewrite must be idempotent (same data,
                # version floor keeps newer state safe)
                raise faults.InjectedKill("after WAL commit")
            self.pc.inc("ops_w")
        return {"ok": True, "epoch": self.epoch}

    def _h_shard_read(self, msg: Dict) -> Dict:
        parent_span = self.tracer.current()

        def run():
            with self.tracer.scope(parent_span):
                return self._do_shard_read(msg)

        return self.sched.submit(self._qos_class(msg), run)

    def _do_shard_read(self, msg: Dict) -> Dict:
        from ..ec.stripe import crc32c

        cid = pg_cid(msg["pool"], msg["ps"])
        oid = f"{msg['oid']}.s{msg['shard']}"
        with self.optracker.create("osd_op",
                                   f"read {cid}/{oid}"):
            try:
                if faults.fires("osd.shard_read_eio",
                                f"osd.{self.id}"):
                    raise OSError("injected shard read error")
                data = self.store.read(cid, oid)
                stored = self.store.getattr(cid, oid, "crc")
                if stored is not None and int(stored) != crc32c(data):
                    # silent bit rot (store.bit_rot class): the store
                    # returned success but the bytes are not what the
                    # write-time digest covers — same degrade path as
                    # an EIO'd sector
                    raise OSError("shard crc mismatch")
            except KeyError:
                return {"error": "enoent"}
            except OSError:
                # a bad sector under a shard (os.read_eio, bit rot, or
                # the injected arm above): the op must DEGRADE, not
                # fail — the reader decodes from survivors ("eio"
                # counts as reachable-but-unusable in the client's
                # shard math), and the shard is dropped so recovery
                # re-decodes it (the test-erasure-eio.sh flow)
                self.pc.inc("degraded_reads")
                self._account_io(int(msg["pool"]), int(msg["ps"]),
                                 degraded_reads=1)
                self._mark_shard_bad(int(msg["pool"]), int(msg["ps"]),
                                     msg["oid"], msg["shard"])
                return {"error": "eio"}
            size = self.store.getattr(cid, oid, "size") or b"0"
            ver = self.store.getattr(cid, oid, "v") or b""
            self.pc.inc("ops_r")
            if self._qos_class(msg) == "client":
                self._account_io(int(msg["pool"]), int(msg["ps"]),
                                 rd_ops=1, rd_bytes=len(data))
            out = bytes(data)
            if msg.get("ranges"):
                # server-side sub-chunk slicing (the CLAY bandwidth
                # repair's network win: only the repair sub-chunks
                # cross the wire); crc verification above always ran
                # over the FULL shard
                out = b"".join(out[int(off):int(off) + int(ln)]
                               for off, ln in msg["ranges"])
            return {"data": out, "size": int(size),
                    "v": ver.decode(), "chunk_len": len(data),
                    # scheduler depth: the load signal recovery
                    # primaries feed their helper ledger with
                    "load": sum(self.sched.depths().values())}

    def _h_obj_delete(self, msg: Dict) -> Dict:
        """Remove every local shard of an object and tombstone the
        log, so the delete wins over older writes at peering time."""
        cid = pg_cid(msg["pool"], msg["ps"])
        v = msg.get("v") or make_version(self.epoch)
        if msg.get("restamp"):
            # CLIENT deletes re-stamp at this daemon's current epoch
            # (interval floor, like the write paths) so the tombstone
            # dominates any version a currently-down holder minted in
            # an earlier interval.  Peering-driven deletes propagate
            # an exact authoritative version and must NOT be raised.
            now_v = make_version(self.epoch)
            if v < now_v:
                v = now_v
        with self._pg_lock(msg["pool"], msg["ps"]):
            txn = Transaction()
            if not self.store.collection_exists(cid):
                txn.create_collection(cid)
            else:
                prefix = f"{msg['oid']}.s"
                if not msg.get("force"):
                    # local version floor (same clock-skew repair as
                    # the write path): a client delete must tombstone
                    # ABOVE whatever is stored, or a lagging clock
                    # leaves the object readable after an acked delete
                    for name in self.store.list_objects(cid):
                        if name.startswith(prefix):
                            cur = self.store.getattr(cid, name, "v")
                            if cur is not None and cur.decode() >= v:
                                v = bump(cur.decode())
                torn_cleanup = False
                for name in self.store.list_objects(cid):
                    if not name.startswith(prefix):
                        continue
                    # same newer-wins guard as the write path: a stale
                    # delete (late retry racing a newer put) must not
                    # clobber the newer write's shards — the tombstone
                    # still logs, and version merge orders them.  A
                    # peering-driven FORCE delete removes a torn
                    # higher-version shard too, CAS-guarded on the
                    # version peering observed.
                    cur = self.store.getattr(cid, name, "v")
                    if cur is not None and cur.decode() > v:
                        if not msg.get("force") or (
                                msg.get("expect") is not None
                                and cur.decode() != msg["expect"]):
                            continue
                        torn_cleanup = True
                    txn.remove(cid, name)
                if torn_cleanup:
                    drop = self._log_keys_above(cid, msg["oid"], v)
                    if drop:
                        txn.omap_rmkeys(cid, "pglog", drop)
            txn.omap_setkeys(cid, "pglog", {
                f"{v}|d": PgLogEntry(op="delete", oid=msg["oid"],
                                     v=v).encode_blob()})
            self.store.queue_transaction(txn)
        return {"ok": True, "epoch": self.epoch}

    # -- EC partial-stripe overwrite (primary-coordinated RMW) ---------
    @contextlib.contextmanager
    def _pg_lock_bounded(self, pool_id: int, ps: int,
                         timeout: float = 0.25):
        """PG lock with a bounded wait for SCHEDULER-run ops: a miss
        raises Requeue, freeing the worker for other PGs while peering
        holds this one (ShardedOpWQ's requeue-on-lock-miss behavior —
        two writes to a peering PG must not starve the whole op pool)."""
        lk = self._pg_lock(pool_id, ps)
        if not lk.acquire(timeout=timeout):
            raise Requeue()
        try:
            yield
        finally:
            lk.release()

    def _pg_lock(self, pool_id: int, ps: int):
        with self._pg_locks_guard:
            lk = self._pg_locks.get((pool_id, ps))
            if lk is None:
                lk = self._pg_locks[(pool_id, ps)] = \
                    make_rlock("osd::pg")
            return lk

    def _h_ec_write(self, msg: Dict) -> Dict:
        # the RMW coordinator is control logic, NOT a store op: running
        # it on the worker pool would deadlock (its own sub-ops submit
        # to the same pool, and two RMWs gathering from each other's
        # OSDs would hold every worker).  Its shard reads/writes are
        # the scheduled, QoS-governed ops.
        return self._do_ec_write(msg)

    def _fanout(self):
        """Persistent replica fan-out pool (per-op thread spawn was a
        measurable slice of write latency)."""
        with self._lock:
            pool = getattr(self, "_fanout_pool", None)
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor

                pool = self._fanout_pool = ThreadPoolExecutor(
                    max_workers=16,
                    thread_name_prefix=f"osd{self.id}-fanout")
            return pool

    def _map_for_op(self, msg: Dict):
        """Epoch-tagged op handling (the reference OSD requests newer
        maps when an op's client epoch exceeds its own,
        OSD::require_same_or_newer_map): if the sender has seen a
        newer epoch, catch up before deciding primariness/pools —
        otherwise a freshly created pool 'does not exist' here until
        the next push arrives."""
        e = int(msg.get("epoch", 0))
        if e > self.epoch:
            self._catch_up(e, {})
        with self._lock:
            return self.map

    def _h_rep_write(self, msg: Dict) -> Dict:
        """Primary-coordinated replicated write (the PrimaryLogPG
        do_op -> ReplicatedBackend submit_transaction -> MOSDRepOp
        fan-out): ONE client round trip; the primary stamps the
        version under the PG lock and pushes replicas in PARALLEL.
        Replaces the client writing each replica itself — which cost
        size serial RTTs and left version stamping at the client's
        wall clock."""
        pool_id, ps = int(msg["pool"]), int(msg["ps"])
        oid = msg["oid"]
        data = bytes(msg["data"])
        m = self._map_for_op(msg)
        if m is None:
            return {"error": "no map"}
        pool = m.pools.get(pool_id)
        if pool is None:
            return {"error": f"no pool {pool_id}"}
        up, _p, acting, _ap = self.pg_up_acting(pool_id, ps)
        members = acting if acting else up
        prim = next((o for o in members if self._alive(o)), None)
        if prim != self.id:
            return {"error": "not primary", "primary": prim,
                    "epoch": self.epoch}

        with self._pg_lock(pool_id, ps):
            v = msg.get("v") or make_version(self.epoch)
            # the serving primary's epoch is the PG's interval
            # authority (the reference stamps eversion_t at the
            # primary): a client proposing a stale-epoch version must
            # never mint one that loses to data already written in a
            # newer interval whose holders happen to be down right
            # now — that acks a write which a later revive+peering
            # pass silently rolls back (thrash acked-write loss)
            now_v = make_version(self.epoch)
            if v < now_v:
                v = now_v
            cid = pg_cid(pool_id, ps)
            curb = self.store.getattr(cid, f"{oid}.s0", "v") \
                if self.store.collection_exists(cid) else None
            if curb is not None and v <= curb.decode():
                v = bump(curb.decode())
            targets = [o for o in dict.fromkeys(members)
                       if o >= 0 and (o == self.id or self._alive(o))]
            # fan-out workers adopt this handler's span so every
            # replica push joins the op's trace
            parent_span = self.tracer.current()
            for _restamp in range(3):
                replies: Dict[int, Optional[Dict]] = {}

                def push(o):
                    with self.tracer.scope(parent_span):
                        replies[o] = self._push_shard(
                            pool_id, ps, o, oid, 0, data, len(data),
                            v, qos="client")

                others = [o for o in targets if o != self.id]
                futs = [self._fanout().submit(push, o)
                        for o in others]
                push(self.id)  # local write on this thread
                for f in futs:
                    try:
                        f.result(timeout=8)
                    except Exception:
                        pass
                landed, newest = 0, None
                for o, rep in replies.items():
                    if rep is None or not rep.get("ok"):
                        continue
                    if rep.get("superseded"):
                        newest = max(newest or "",
                                     rep.get("cur") or "")
                    else:
                        landed += 1
                if newest is None:
                    break
                v = bump(newest)
            if landed < min(pool.min_size, len(targets)):
                return {"error": f"only {landed} of "
                                 f"{pool.min_size} required replicas "
                                 f"persisted"}
            if landed < len(targets):
                # min_size acked (any full replica can serve the
                # data, unlike EC shards) — but a member missed the
                # write: re-replicate now, not at the next periodic
                # recovery pass
                self._recover_wake.set()
            self.pc.inc("ops_w")
            self._account_io(pool_id, ps, wr_ops=1,
                             wr_bytes=len(data))
            return {"ok": True, "v": v,
                    "degraded": landed < pool.size}

    def _do_ec_write(self, msg: Dict) -> Dict:
        """The ECBackend::start_rmw role (ECBackend.cc:1876-1976 +
        ECTransaction.cc:202 overwrite): the PG PRIMARY serializes
        partial writes under the PG lock — read the affected object
        (any k shards, degraded reads included), merge the byte range,
        re-encode every position at a fresh version, distribute.  The
        per-object version total order doubles as the PG-log
        serialization of the op."""
        pool_id, ps = int(msg["pool"]), int(msg["ps"])
        oid = msg["oid"]
        offset = int(msg["offset"])
        # zero-copy staging: a view into the pooled recv segment is
        # fine here — every use below copies it into the merge buffer
        # before this handler (and thus the segment's lifetime) ends
        data = msg["data"]
        m = self._map_for_op(msg)
        if m is None:
            return {"error": "no map"}
        pool = m.pools.get(pool_id)
        if pool is None:
            return {"error": f"no pool {pool_id}"}
        up, _p, acting, _ap = self.pg_up_acting(pool_id, ps)
        members = acting if acting else up
        prim = next((o for o in members if self._alive(o)), None)
        if prim != self.id:
            # stale client map: tell it where the primary is
            return {"error": "not primary", "primary": prim,
                    "epoch": self.epoch}
        code = self._code_for(pool)
        if code is None:
            return {"error": "not an ec pool"}

        with self._pg_lock(pool_id, ps):
            if msg.get("full"):
                # whole-object write: replaces content, no read-merge
                buf = bytearray(data)
                size = len(buf)
            else:
                base = self._gather_object(pool_id, ps, oid, up, code)
                size = max(len(base), offset + len(data))
                buf = bytearray(size)  # zero-fill holes
                buf[:len(base)] = base
                buf[offset:offset + len(data)] = data
            v = msg.get("v") or make_version(self.epoch)
            # primary-epoch floor, as in the replicated path: a
            # stale-epoch client proposal must not undercut versions
            # minted in a newer interval (down-holder rollback class)
            now_v = make_version(self.epoch)
            if v < now_v:
                v = now_v
            # PRIMARY-side version floor: the stamped version must
            # exceed what is stored, or a client with a lagging clock
            # writes a version that loses last-writer-wins to data it
            # itself read (the reference stamps eversion_t at the
            # primary for the same reason).  The primary's own shard
            # is the floor source — it holds the newest acked version
            # whenever it is not itself degraded.
            mypos = next((p for p, o in enumerate(up)
                          if o == self.id), None)
            if mypos is not None:
                cid = pg_cid(pool_id, ps)
                curb = self.store.getattr(
                    cid, f"{oid}.s{mypos}", "v") \
                    if self.store.collection_exists(cid) else None
                if curb is not None and v <= curb.decode():
                    v = bump(curb.decode())
            n = code.get_chunk_count()
            k = code.get_data_chunk_count()
            # traced as a child of handle:ec_write when the client op
            # carries trace context — the per-stage latency the EC
            # characterization literature needs visible
            with self.tracer.start_span(
                    "ec.encode", require_parent=True,
                    tags={"bytes": len(buf), "k": k, "m": n - k}):
                # through the coalescer: concurrent writes to other
                # PGs of this pool share one batched dispatch
                chunks = self._ec_batcher.encode(code, range(n), buf)
                host = host_rows([chunks[p] for p in range(n)])
                payloads = [memoryview(host[p]) for p in range(n)]
            # EC input-assembly copies: the mutable merge buffer (read
            # in place by encode_prepare's copy onto the code's device)
            # and the chunks' one stacked copy back to the host; each
            # push sends a view of its row
            copytrack.book_pc(
                self._copy_pc, "ec_assembly", len(buf) + host.nbytes,
                copies=2)
            # distribute; a `superseded` reply means some holder has a
            # NEWER stored version our floor probe missed (our own
            # shard degraded) — counting it as landed would ack a
            # write that readers never see.  Re-stamp past the
            # reported version and redistribute.
            for _restamp in range(3):
                landed, newest, failed = 0, None, 0
                for pos, osd in enumerate(up):
                    if not (osd == self.id or self._alive(osd)):
                        continue  # peering recovers it at version v
                    rep = self._push_shard(pool_id, ps, osd, oid, pos,
                                           payloads[pos], size, v,
                                           qos="client")
                    if rep is None or not rep.get("ok"):
                        failed += 1
                        continue
                    if rep.get("superseded"):
                        newest = max(newest or "",
                                     rep.get("cur") or "")
                    else:
                        landed += 1
                if newest is None:
                    break
                v = bump(newest)
            if failed:
                # a reachable member missed its shard: the acked
                # version is down to (or near) zero erasure margin,
                # and the in-place overwrite already consumed the
                # previous version on the positions that DID land.
                # The reference fails the whole op here (ECBackend
                # waits out every sub-op) — but it can afford to: its
                # PG log carries rollback info, so the landed
                # sub-writes unwind on peering.  Without rollback,
                # erroring would send the client through retry rounds
                # that each land MORE in-place partials (every write
                # during a dead-but-map-up member window fails), and
                # it is those stacked partials that erase the last
                # acked version's >= k coverage.  So: ack at >= k,
                # and wake recovery NOW to re-decode the missing
                # shard and restore the margin.
                self._recover_wake.set()
            if landed < k:
                return {"error": f"only {landed} of {k} required "
                                 f"shards persisted"}
            self.pc.inc("ops_w")
            self._account_io(
                pool_id, ps, wr_ops=1, wr_bytes=len(buf),
                ec_encode_ops=1,
                ec_encode_bytes=sum(len(p) for p in payloads))
            return {"ok": True, "v": v, "size": size,
                    "degraded": landed < n}

    def _gather_object(self, pool_id: int, ps: int, oid: str,
                       up: List[int], code) -> bytes:
        """Read the full current object: any k positional shards at
        the newest mutually-consistent version, decoded and trimmed —
        the read-before-overwrite of ECBackend.cc:1963.  Returns b""
        for a not-yet-existing object."""
        import numpy as np

        cid = pg_cid(pool_id, ps)
        k = code.get_data_chunk_count()
        got: Dict[int, Tuple[str, bytes, int]] = {}
        for pos, osd in enumerate(up):
            rep = self._read_shard_from(osd, pool_id, ps, oid, pos,
                                        qos="client")
            if rep is not None:
                got[pos] = rep
        if not got:
            return b""
        best_v = max(v for v, _d, _s in got.values())
        chunks = {pos: np.frombuffer(d, np.uint8)
                  for pos, (v, d, s) in got.items() if v == best_v}
        size = next(s for v, _d, s in got.values() if v == best_v)
        if len(chunks) < k:
            raise OSError(f"pg {cid} {oid}: only {len(chunks)} of "
                          f"{k} shards readable for rmw")
        out = code.decode(set(range(k)), chunks)
        # the data chunks, decoded on the code's device, come back to
        # the host in one copy (the caller merges them into its buffer)
        data = host_rows([out[i] for i in range(k)]).reshape(-1)
        return memoryview(data[:size])


    def _read_shard_from(self, osd: int, pool_id: int, ps: int,
                         oid: str, pos: int,
                         qos: str = "recovery",
                         ranges: Optional[List[Tuple[int, int]]]
                         = None):
        """One shard read, local store or peer RPC — the single fetch
        primitive behind RMW gathers and both recovery paths.
        ``ranges`` asks for a concatenation of (offset, length) slices
        of the shard (the CLAY repair-sub-chunk read).  Returns
        (version, data, size) or None."""
        from ..ec.stripe import crc32c

        cid = pg_cid(pool_id, ps)
        if osd == self.id:
            try:
                data = self.store.read(cid, f"{oid}.s{pos}")
            except (KeyError, OSError):
                return None
            stored = self.store.getattr(cid, f"{oid}.s{pos}", "crc")
            if stored is not None and int(stored) != crc32c(data):
                # local bit rot: unusable as a decode input — drop it
                # for repair like the remote read path does
                self._mark_shard_bad(pool_id, ps, oid, pos)
                return None
            v = (self.store.getattr(cid, f"{oid}.s{pos}", "v")
                 or b"").decode()
            size = int(self.store.getattr(cid, f"{oid}.s{pos}",
                                          "size") or b"0")
            if ranges:
                data = b"".join(bytes(data[off:off + ln])
                                for off, ln in ranges)
            return v, data, size
        if not self._alive(osd):
            return None
        msg = {"type": "shard_read", "pool": pool_id, "ps": ps,
               "oid": oid, "shard": pos, "qos_class": qos}
        if ranges:
            msg["ranges"] = [[int(off), int(ln)]
                             for off, ln in ranges]
        try:
            got = self.msgr.call(self.osd_addrs[osd], msg, timeout=5)
        except (TimeoutError, OSError):
            return None
        if "load" in got:
            # the helper's scheduler depth rides every reply: the
            # ledger's remote half of the load signal
            self.rec_ledger.note_load(osd, got["load"])
        if "data" in got:
            return (got.get("v") or "", bytes(got["data"]),
                    int(got.get("size", 0)))
        return None

    def _pg_local_info(self, pool_id: int, ps: int) -> Dict:
        """Fold the PG log + store into the pg_info_t this OSD reports
        during peering: last_update, and per object its newest logged
        version, tombstone flag, size, and ``shards`` — which shard
        POSITIONS this OSD actually holds and at which version.  The
        position map is what makes peering correct across remaps: an
        EC member that moved from position 3 to 2 still holds (and can
        serve) its old s3 while missing s2."""
        cid = pg_cid(pool_id, ps)
        objects: Dict[str, Dict] = {}
        last_update = NULL_VERSION
        if self.store.collection_exists(cid):
            for key, raw in sorted(
                    self.store.omap_get(cid, "pglog").items()):
                try:
                    rec = PgLogEntry.decode_blob(raw)
                except MalformedInput:
                    continue
                v = rec.v or NULL_VERSION
                if not rec.oid:
                    continue
                oid = rec.oid
                cur = objects.get(oid)
                if cur is None or v >= cur["v"]:
                    objects[oid] = {
                        "v": v,
                        "deleted": rec.deleted,
                        "size": rec.size, "shards": {}}
                if v > last_update:
                    last_update = v
            # what the store actually holds, per position and version
            # (the log may claim shards scrub-repair dropped, and may
            # miss objects imported without log entries)
            for name in self.store.list_objects(cid):
                if name == "pglog" or ".s" not in name:
                    continue
                oid, _, pos = name.rpartition(".s")
                ver = self.store.getattr(cid, name, "v")
                vpos = ver.decode() if ver else NULL_VERSION
                if oid not in objects:
                    size = self.store.getattr(cid, name, "size") \
                        or b"0"
                    objects[oid] = {"v": vpos, "deleted": False,
                                    "size": int(size), "shards": {}}
                objects[oid]["shards"][pos] = vpos
        return {"osd": self.id, "epoch": self.epoch,
                "last_update": last_update, "objects": objects}

    def _h_pg_info(self, msg: Dict) -> Dict:
        return self._pg_local_info(int(msg["pool"]), int(msg["ps"]))

    def _log_keys_above(self, cid: str, oid: str, v: str):
        """PG-log keys recording ``oid`` at versions above ``v`` (the
        torn entries an authoritative rollback must erase)."""
        drop = []
        if not self.store.collection_exists(cid):
            return drop
        for key, raw in self.store.omap_get(cid, "pglog").items():
            try:
                rec = PgLogEntry.decode_blob(raw)
            except MalformedInput:
                continue
            if rec.oid == oid and rec.v > v:
                drop.append(key)
        return drop

    def _h_pg_log_trim(self, msg: Dict) -> None:
        """Drop log entries superseded by a newer entry for the same
        object (PGLog::trim): the per-object newest record — tombstones
        included — is what peering consumes; history behind it is dead
        weight in omap space."""
        pool_id, ps = int(msg["pool"]), int(msg["ps"])
        cid = pg_cid(pool_id, ps)
        with self._pg_lock(pool_id, ps):
            if not self.store.collection_exists(cid):
                return None
            log = self.store.omap_get(cid, "pglog")
            newest: Dict[str, str] = {}
            for key, raw in log.items():
                try:
                    rec = PgLogEntry.decode_blob(raw)
                except MalformedInput:
                    continue
                if rec.oid and rec.v >= newest.get(rec.oid, ""):
                    newest[rec.oid] = rec.v
            drop = []
            for key, raw in log.items():
                try:
                    rec = PgLogEntry.decode_blob(raw)
                except MalformedInput:
                    drop.append(key)
                    continue
                if rec.v < newest.get(rec.oid, ""):
                    drop.append(key)
            if drop:
                txn = Transaction()
                txn.omap_rmkeys(cid, "pglog", drop)
                self.store.queue_transaction(txn)
        return None

    def _h_pg_poke(self, _msg: Dict) -> None:
        """A peer lost a shard (scrub repair) or wants re-peering."""
        self._recover_wake.set()
        return None

    def _h_recovery_reserve(self, msg: Dict) -> Dict:
        """Remote recovery reservation (the AsyncReserver
        remote_reserver surface, MRecoveryReserve role): a primary
        about to push recovery writes at this OSD asks for a slot
        first, so concurrent recoveries onto one OSD stay bounded by
        ``osd_max_recovery_ops``.  Rides the control lane — a full op
        pool must not deadlock reservation traffic."""
        if msg.get("release"):
            self.rec_reserver.release()
            return {"ok": True}
        if self.rec_reserver.try_acquire():
            return {"ok": True, "granted": True}
        self.rec_pc.inc("remote_denials")
        return {"ok": True, "granted": False}

    # -- stray PGs (MOSDPGNotify role) ---------------------------------
    def _h_pg_stray(self, msg: Dict) -> None:
        """A former member still holds this PG's data: include it in
        peering so remapped-away shards stay reachable."""
        key = (int(msg["pool"]), int(msg["ps"]))
        with self._lock:
            self._strays.setdefault(key, set()).add(int(msg["osd"]))
        self._recover_wake.set()
        return None

    def _h_pg_purge(self, msg: Dict) -> Dict:
        """The primary declared the PG clean: this stray's copy is no
        longer needed (PG removal)."""
        cid = pg_cid(msg["pool"], msg["ps"])
        with self._lock:
            m = self.map
        if m is None:
            # without a map this osd cannot know its membership — a
            # late/duplicate purge must never delete a PG it is about
            # to serve
            return {"ok": False, "error": "no map yet"}
        up, _p, acting, _ap = m.pg_to_up_acting_osds(
            int(msg["pool"]), int(msg["ps"]))
        if self.id in up or self.id in acting:
            return {"ok": False, "error": "still a member"}
        self._drop_pg_collection(int(msg["pool"]), int(msg["ps"]))
        return {"ok": True}

    def _drop_pg_collection(self, pool_id: int, ps: int) -> None:
        """Remove a whole PG (objects first: ObjectStore refuses to
        drop non-empty collections) under the PG lock."""
        cid = pg_cid(pool_id, ps)
        with self._pg_lock(pool_id, ps):
            if not self.store.collection_exists(cid):
                return
            txn = Transaction()
            for name in self.store.list_objects(cid):
                txn.remove(cid, name)
            txn.remove_collection(cid)
            self.store.queue_transaction(txn)

    def _report_strays(self, m) -> None:
        """Per epoch: any local PG collection this osd no longer
        serves gets announced to the PG's current primary."""
        for cid in self.store.list_collections():
            try:
                pool_s, ps_s = cid.split(".", 1)
                pool_id, ps = int(pool_s), int(ps_s)
            except ValueError:
                continue
            if pool_id not in m.pools:
                # the pool was deleted: its PGs go with it (the
                # reference's PG removal on pool delete)
                self._drop_pg_collection(pool_id, ps)
                continue
            up, _p, acting, _ap = m.pg_to_up_acting_osds(pool_id, ps)
            if self.id in up or self.id in acting:
                continue
            prim = next((o for o in up if self._alive(o)), None)
            if prim is not None and prim != self.id:
                self.msgr.send(self.osd_addrs[prim],
                               {"type": "pg_stray", "pool": pool_id,
                                "ps": ps, "osd": self.id})

    # -- watch/notify (librados watch/notify, src/osd/Watch.cc) --------
    def _h_watch(self, msg: Dict) -> Dict:
        key = (pg_cid(msg["pool"], msg["ps"]), msg["oid"])
        with self._lock:
            ws = self._watchers.setdefault(key, {})
            ws[msg["watcher"]] = tuple(msg["addr"])
            count = len(ws)  # under the lock: a racing unwatch may
            # pop the key before we return
        return {"ok": True, "watchers": count}

    def _h_unwatch(self, msg: Dict) -> Dict:
        key = (pg_cid(msg["pool"], msg["ps"]), msg["oid"])
        with self._lock:
            ws = self._watchers.get(key, {})
            ws.pop(msg["watcher"], None)
            if not ws:
                self._watchers.pop(key, None)
        return {"ok": True}

    def _h_notify(self, msg: Dict) -> Dict:
        """Fan the notify out to every watcher and collect acks within
        the timeout — the rados_notify round-trip contract."""
        key = (pg_cid(msg["pool"], msg["ps"]), msg["oid"])
        with self._lock:
            watchers = dict(self._watchers.get(key, {}))
        acks, missed = [], []
        note = {"type": "watch_notify", "pool": msg["pool"],
                "ps": msg["ps"], "oid": msg["oid"],
                "payload": msg.get("payload"),
                "notifier": msg.get("frm")}
        deadline = time.monotonic() + float(msg.get("timeout", 5.0))
        for name, addr in watchers.items():
            left = max(0.2, deadline - time.monotonic())
            try:
                rep = self.msgr.call(addr, dict(note),
                                     timeout=min(5.0, left))
                (acks if rep.get("ok") else missed).append(name)
            except TimeoutError:
                missed.append(name)  # slow != gone: keep the watch
            except OSError:
                missed.append(name)
                # connection refused = the watcher is gone; a pruned
                # live client re-watches on the next map epoch
                with self._lock:
                    self._watchers.get(key, {}).pop(name, None)
        return {"ok": True, "acks": acks, "missed": missed}

    def _h_pg_list(self, msg: Dict) -> Dict:
        cid = pg_cid(msg["pool"], msg["ps"])
        out: Dict[str, int] = {}
        for name in self.store.list_objects(cid):
            if name == "pglog" or ".s" not in name:
                continue
            oid, _, shard = name.rpartition(".s")
            size = self.store.getattr(cid, name, "size") or b"0"
            out[oid] = int(size)
        return {"objects": out}

    def _h_pg_scrub(self, msg: Dict) -> Dict:
        return self.sched.submit("scrub",
                                 lambda: self._do_pg_scrub(msg))

    def _do_pg_scrub(self, msg: Dict) -> Dict:
        """Deep scrub of one PG: recompute every local shard's crc32c
        and compare with the stored write-time digest (the
        HashInfo-backed scrub of the reference's deep-scrub flow).
        Each object's (data, crc) pair reads under the PG lock: a
        racing write commits both in one transaction, and reading them
        torn would flag — and auto-repair would DROP — a healthy
        shard."""
        from ..ec.stripe import crc32c

        cid = pg_cid(msg["pool"], msg["ps"])
        inconsistent: List[str] = []
        digests: Dict[str, int] = {}
        with self._pg_lock_bounded(int(msg["pool"]), int(msg["ps"])):
            if self.store.collection_exists(cid):
                for name in self.store.list_objects(cid):
                    if name == "pglog":
                        continue
                    data = self.store.read(cid, name)
                    got = crc32c(data)
                    stored = self.store.getattr(cid, name, "crc")
                    digests[name] = got
                    if stored is not None and int(stored) != got:
                        inconsistent.append(name)
        return {"osd": self.id, "inconsistent": inconsistent,
                "digests": digests}

    def _h_shard_remove(self, msg: Dict) -> Dict:
        """Drop a (corrupt) shard so recovery rebuilds it — the repair
        half of scrub (test-erasure-eio.sh flow).  Recovery is
        primary-driven, so poke the PG's primary to re-peer."""
        cid = pg_cid(msg["pool"], msg["ps"])
        name = f"{msg['oid']}.s{msg['shard']}"
        if self.store.stat(cid, name) is not None:
            self.store.queue_transaction(
                Transaction().remove(cid, name))
        self._recover_wake.set()
        with self._lock:
            m = self.map
        if m is not None:
            up, _p, _a, _ap = m.pg_to_up_acting_osds(
                int(msg["pool"]), int(msg["ps"]))
            prim = next((o for o in up if self._alive(o)), None)
            if prim is not None and prim != self.id:
                self.msgr.send(self.osd_addrs[prim],
                               {"type": "pg_poke"})
        return {"ok": True}

    def _mark_shard_bad(self, pool_id: int, ps: int, oid: str,
                        shard: int) -> None:
        """An unreadable shard is marked for repair: drop it (its
        bytes can no longer be trusted) and poke the PG's primary so
        recovery re-decodes it from the survivors — the degraded read
        already served the client; this closes the loop on the
        damage."""
        try:
            self._h_shard_remove({"pool": pool_id, "ps": ps,
                                  "oid": oid, "shard": shard})
        except Exception as e:
            # best-effort: a failed repair mark leaves the shard for
            # the next scrub pass, it must not fail the read that
            # already degraded cleanly
            self.log.dout(5, f"mark-bad {pool_id}.{ps}/{oid}."
                             f"s{shard} failed: {e!r}")

    def _h_status(self, _msg: Dict) -> Dict:
        with self._lock:
            return {"osd": self.id, "epoch": self.epoch,
                    "collections": self.store.list_collections(),
                    "perf": self.pc.dump(),
                    "qos_served": dict(self.sched.served),
                    "qos_depths": self.sched.depths(),
                    "historic_ops": self.optracker.dump_historic_ops()}

    # -- heartbeats ----------------------------------------------------
    def _beat_loop(self) -> None:
        interval = self.ctx.conf["osd_heartbeat_interval"]
        stat_interval = self.ctx.conf["osd_pg_stat_report_interval"]
        last_stats = 0.0
        while self._running:
            # mon_send reaches every quorum member: peons forward to
            # the leader, so liveness survives any single monitor death
            # — carrying this daemon's SLO state: in-flight ops past
            # osd_op_complaint_time and heartbeat-RTT threshold
            # breaches, the raw material of the monitor's SLOW_OPS /
            # OSD_SLOW_PING_TIME health folds
            beat: Dict = {"type": "heartbeat", "osd": self.id}
            try:
                slow = self.optracker.slow_summary()
                if slow["count"]:
                    beat["slow_ops"] = slow
                pings = self.hb.ping_breaches()
                if pings:
                    beat["slow_pings"] = pings
            except Exception as e:
                # the beacon is liveness first; SLO cargo never gets
                # to break it
                self.log.dout(5, f"slo beacon cargo failed: {e}")
            self.mon_send(beat)
            # a monitor that deferred our boot (markdown dampening) or
            # marked us down while our re-boot raced a commit leaves
            # the map showing us down with no new epoch to react to:
            # keep re-booting at beacon cadence until the map agrees
            with self._lock:
                down = self.map is not None \
                    and not self.map.is_up(self.id)
            if down:
                self.mon_send({"type": "boot", "osd": self.id,
                               "addr": list(self.addr)})
            # the continuous-stats cadence rides the beat thread: PG
            # io/recovery counters reach the monitors between peering
            # passes, so pool rates resolve at beacon granularity
            if stat_interval > 0 and \
                    time.monotonic() - last_stats >= stat_interval:
                last_stats = time.monotonic()
                try:
                    self._stat_beacon_pass()
                except Exception as e:
                    self.log.dout(5, f"stat beacon pass failed: {e}")
            # waits on the shutdown event rather than sleeping: a
            # teardown mid-interval returns immediately instead of
            # holding shutdown() hostage for up to a full beat
            if self._shutdown_ev.wait(interval):
                return

    # -- recovery (mark-down -> remap -> recover) ----------------------
    def _recover_loop(self) -> None:
        retry_pending = False
        last_pass = 0.0
        while self._running:
            fired = self._recover_wake.wait(timeout=5.0)
            self._recover_wake.clear()
            if not self._running:
                break
            if not fired and not retry_pending and \
                    time.monotonic() - last_pass < 20.0:
                continue  # idle; a periodic pass still runs every
                # ~20s so pg_stats reach monitors that joined late
                # and missed pokes self-heal
            try:
                self._check_recovery()
                retry_pending = False
                last_pass = time.monotonic()
            except Exception as e:
                self.log.derr(f"recovery pass failed: {e}")
                retry_pending = True  # peers may come back; retry

    def _alive(self, osd: int) -> bool:
        return osd >= 0 and self.map is not None \
            and self.map.is_up(osd) and osd in self.osd_addrs

    def _check_recovery(self) -> None:
        with self._lock:
            m = self.map
        if m is None:
            return
        self._report_strays(m)
        for pool_id, pool in m.pools.items():
            for ps in range(pool.pg_num):
                up, _p, acting, _ap = m.pg_to_up_acting_osds(pool_id,
                                                             ps)
                members = [o for o in up if self._alive(o)]
                if not members or members[0] != self.id:
                    continue  # peering + recovery are the primary's job
                self._peer_pg(m, pool_id, pool, ps, up, acting)
                self._maybe_scrub(pool_id, ps, up)

    def _maybe_scrub(self, pool_id: int, ps: int,
                     up: List[int]) -> None:
        """Scheduled deep scrub (PG::sched_scrub / osd_scrub_* role):
        the primary periodically asks every member to recompute shard
        digests; mismatching shards are dropped (auto-repair) so the
        next peering pass re-decodes them from survivors."""
        interval = self.ctx.conf["osd_scrub_interval"]
        if interval <= 0:
            return
        key = (pool_id, ps)
        now = time.monotonic()
        if key not in self._last_scrub:
            # jittered first deadline: without it every PG scrubs on
            # the first pass after (re)start and the whole cluster
            # stays phase-aligned forever (the reference randomizes
            # scrub deadlines for the same reason)
            import random

            self._last_scrub[key] = now - random.random() * interval
            return
        if now - self._last_scrub[key] < interval:
            return
        # one sweep at a time (osd_max_scrubs role), claimed BEFORE
        # spawning: a backlog of due PGs stays due (unstamped) instead
        # of piling up blocked threads that later run with stale
        # membership
        if not self._scrub_slots.acquire(blocking=False):
            return
        self._last_scrub[key] = now
        # off the recovery thread: a slow member's 10s scrub RPC must
        # never delay re-peering of other PGs
        try:
            threading.Thread(target=self._scrub_pg,
                             args=(pool_id, ps, list(up)),
                             daemon=True,
                             name=f"osd{self.id}-scrub").start()
        except RuntimeError:
            # thread exhaustion: give the slot back or scrubbing would
            # be disabled forever
            self._scrub_slots.release()
            self._last_scrub.pop(key, None)
            raise

    def _scrub_pg(self, pool_id: int, ps: int,
                  up: List[int]) -> None:
        try:
            self._scrub_pg_inner(pool_id, ps, up)
        except Exception as e:
            self.log.derr(f"scrub pg {pool_id}.{ps} failed: {e!r}")
            # retry at the next pass, not a full interval later
            interval = self.ctx.conf["osd_scrub_interval"]
            self._last_scrub[(pool_id, ps)] = \
                time.monotonic() - interval
        finally:
            self._scrub_slots.release()

    def _scrub_pg_inner(self, pool_id: int, ps: int,
                        up: List[int]) -> None:
        repair = self.ctx.conf["osd_scrub_auto_repair"]
        for o in up:
            if o == self.id:
                # through the scheduler like remote scrubs: scrub I/O
                # is dmClock-tagged on every member equally
                got = self._h_pg_scrub({"pool": pool_id, "ps": ps})
            elif self._alive(o):
                try:
                    got = self.msgr.call(
                        self.osd_addrs[o],
                        {"type": "pg_scrub", "pool": pool_id,
                         "ps": ps}, timeout=10)
                except (TimeoutError, OSError):
                    continue
            else:
                continue
            for name in got.get("inconsistent", []):
                self.log.derr(f"scrub: pg {pool_id}.{ps} {name} "
                              f"crc mismatch on osd.{o}")
                if not repair:
                    continue
                oid, _, shard = name.rpartition(".s")
                msg = {"type": "shard_remove", "pool": pool_id,
                       "ps": ps, "oid": oid, "shard": int(shard)}
                try:
                    if o == self.id:
                        self._h_shard_remove(msg)
                    else:
                        self.msgr.call(self.osd_addrs[o], msg,
                                       timeout=5)
                except (TimeoutError, OSError):
                    pass
                self._recover_wake.set()

    # -- peering (PeeringState / PGLog roles) --------------------------
    def _peer_pg(self, m, pool_id: int, pool, ps: int,
                 up: List[int], acting: List[int]) -> None:
        """Collect infos, merge to the authoritative per-object state,
        drive pulls/pushes/deletes, manage the pg_temp overlay.

        Holds the PG lock for the whole pass: client EC ops route
        through the primary and take the same lock, so peering's
        rollback decisions can never interleave with a half-landed
        write (the reference gates ops on peering state the same
        way).  Cross-daemon shard pushes take only the REMOTE pg
        lock transiently — per-(osd, pg) locks cannot cycle because a
        PG has one primary."""
        # gather infos OUTSIDE the PG lock: up to members*5s of RPC
        # must not stall client ops; the lock-protected phase re-checks
        # the epoch and every mutation is CAS-guarded, so stale infos
        # degrade to no-ops, never to wrong rollbacks
        epoch_at_gather = self.epoch
        with self._lock:
            strays = set(self._strays.get((pool_id, ps), set()))
        members = sorted({o for o in (list(up) + list(acting)
                                      + list(strays))
                          if o == self.id or self._alive(o)})
        infos: Dict[int, Dict] = {}
        for o in members:
            if o == self.id:
                infos[o] = self._pg_local_info(pool_id, ps)
                continue
            try:
                infos[o] = self.msgr.call(
                    self.osd_addrs[o],
                    {"type": "pg_info", "pool": pool_id, "ps": ps},
                    timeout=5)
            except (TimeoutError, OSError):
                continue
            if int(infos[o].get("epoch", 0)) > self.epoch:
                # a member runs a newer map: this primary may already
                # be deposed — abort; the map install re-wakes peering
                # (shrinks the dual-primary window during transitions)
                self._recover_wake.set()
                return
        with self._pg_lock(pool_id, ps):
            if self.epoch != epoch_at_gather:
                self._recover_wake.set()  # re-peer on the new map
                return
            # local state may have advanced while gathering (a client
            # write completed): refresh our own info under the lock
            infos[self.id] = self._pg_local_info(pool_id, ps)
            self._peer_pg_locked(m, pool_id, pool, ps, up, acting,
                                 members, strays, infos)

    def _peer_pg_locked(self, m, pool_id: int, pool, ps: int,
                        up: List[int], acting: List[int],
                        members, strays, infos) -> None:
        cid = pg_cid(pool_id, ps)
        code = self._code_for(pool)
        # merge: newest version wins per object (delete tombstones
        # included) — the result of authoritative-log election + merge
        merged: Dict[str, Dict] = {}
        for o, info in infos.items():
            for oid, rec in info.get("objects", {}).items():
                cur = merged.get(oid)
                if cur is None or rec["v"] > cur["v"]:
                    merged[oid] = dict(rec)
        my = infos.get(self.id, {}).get("objects", {})

        # the degraded state must be VISIBLE, not just transited: a
        # small recovery completes within one pass, and only reporting
        # the end-of-pass verdict would hide the whole
        # degraded->recovering->clean arc from the PGMap/progress
        # plane.  Estimate the pre-pass deficit and beacon it before
        # any recovery work (the estimate may count a torn write the
        # pass then rolls back — transient, corrected by the final
        # beacon below).
        pre_degraded = 0
        for oid, rec in merged.items():
            if rec.get("deleted"):
                continue
            positions = enumerate(up) if code is not None \
                else [(0, o) for o in up]
            if any(self._shard_v_of(infos, o, oid, pos) != rec["v"]
                   for pos, o in positions):
                pre_degraded += 1
        if pre_degraded:
            n_live = len([o for o in up if self._alive(o)])
            pre_states = ["active"]
            if n_live < len(up):
                pre_states.append("undersized")
            pre_states += ["degraded", "recovering"]
            with self._lock:
                self._pg_states[(pool_id, ps)] = {
                    "state": "+".join(pre_states),
                    "objects": len([1 for r in merged.values()
                                    if not r.get("deleted")]),
                    "degraded_objects": pre_degraded}
            self._send_pg_stats(pool_id, ps)

        def shard_v(osd: int, oid: str, pos: int) -> str:
            return self._shard_v_of(infos, osd, oid, pos)

        # serving continuity: if this (new) primary is missing data,
        # point the PG at the best-covered holder via pg_temp while we
        # catch up
        i_am_behind = any(
            (not rec["deleted"])
            and shard_v(self.id, oid, 0) < rec["v"]
            for oid, rec in merged.items()) if code is None else False
        if i_am_behind and code is None:
            best = max((o for o in infos if o != self.id),
                       key=lambda o: infos[o].get("last_update",
                                                  NULL_VERSION),
                       default=None)
            if best is not None and \
                    infos[best].get("last_update", NULL_VERSION) > \
                    infos.get(self.id, {}).get("last_update",
                                               NULL_VERSION):
                # full acting set, best-covered holder first: reads
                # find the data, and writes during backfill keep the
                # pool's replication factor (and keep landing on up
                # members, so the next peering round sees them)
                acting_set = [best] + [o for o in up
                                       if o != best and self._alive(o)]
                self._set_pg_temp(pool_id, ps, acting_set)

        clean = True
        degraded_objs = 0  # objects needing recovery work this pass
        ec_groups: Dict[Tuple, List[Tuple[str, Dict]]] = {}
        rep_items: List[Tuple[str, Dict]] = []
        for oid, rec in merged.items():
            if code is not None:
                # EC: the authoritative version is the newest
                # RECOVERABLE one — >= k positions hold it somewhere.
                # A torn partial write (higher version, < k shards —
                # never acked) is ROLLED BACK, the reference's
                # divergent-entry rollback (PGLog::rewind_divergent).
                k = code.get_data_chunk_count()
                cover: Dict[str, Set[int]] = {}
                tombs: List[str] = []
                for o, info in infos.items():
                    orec = info.get("objects", {}).get(oid)
                    if not orec:
                        continue
                    if orec.get("deleted"):
                        tombs.append(orec["v"])
                    for pos_s, pv in orec.get("shards", {}).items():
                        if pv != NULL_VERSION:
                            cover.setdefault(pv, set()).add(
                                int(pos_s))
                best_write = max(
                    (v for v, poss in cover.items()
                     if len(poss) >= k), default=None)
                best_tomb = max(tombs, default=None)
                if best_tomb is not None and (
                        best_write is None or best_tomb > best_write):
                    for o, info in infos.items():
                        lrec = info.get("objects", {}).get(oid)
                        if not lrec or lrec.get("deleted"):
                            continue
                        if lrec["v"] < best_tomb:
                            self._send_delete(pool_id, ps, o, oid,
                                              best_tomb)
                        else:
                            # torn never-acked shards above the
                            # tombstone: CAS force-delete so the
                            # delete actually wins (finishing next
                            # pass keeps clean honest)
                            self._send_delete(
                                pool_id, ps, o, oid, best_tomb,
                                force=True, expect=lrec["v"])
                            clean = False
                    continue
                if best_write is None:
                    if cover:
                        clean = False
                        degraded_objs += 1
                        self.log.derr(
                            f"pg {cid} {oid}: no recoverable "
                            f"version (coverage "
                            f"{ {v: len(p) for v, p in cover.items()} })")
                    continue
                need = tuple(sorted(
                    pos for pos, o in enumerate(up)
                    if shard_v(o, oid, pos) != best_write))
                if not need:
                    continue
                degraded_objs += 1
                avail = tuple(sorted(cover[best_write]))
                rec = dict(rec, v=best_write)
                ec_groups.setdefault((need, avail, best_write),
                                     []).append((oid, rec))
                continue
            if rec["deleted"]:
                # propagate the tombstone: anyone still holding an
                # older live version drops it
                for o, info in infos.items():
                    lrec = info.get("objects", {}).get(oid)
                    if lrec and not lrec.get("deleted") \
                            and lrec["v"] < rec["v"]:
                        self._send_delete(pool_id, ps, o, oid,
                                          rec["v"])
                continue
            if any(shard_v(o, oid, 0) != rec["v"] for o in up):
                degraded_objs += 1
                rep_items.append((oid, rec))
        if rep_items or ec_groups:
            clean &= self._run_recovery(m, pool_id, pool, ps, up,
                                        rep_items, ec_groups, infos,
                                        shard_v, code)
        # PG state for the monitor's PGMap/health surface
        n_alive = len([o for o in up if self._alive(o)])
        want = len(up)
        states = ["active"]
        if n_alive < want:
            states.append("undersized")
        if not clean:
            states.append("degraded")
        else:
            states.append("clean")
        n_objects = len([1 for _oid, rec in merged.items()
                         if not rec.get("deleted")])
        with self._lock:
            self._pg_states[(pool_id, ps)] = {
                "state": "+".join(states), "objects": n_objects,
                "degraded_objects": 0 if clean else degraded_objs}
        self._send_pg_stats(pool_id, ps)
        if clean:
            self._set_pg_temp(pool_id, ps, [])
            # history behind each object's newest log record is dead
            # weight: trim it everywhere (PGLog::trim on clean)
            for o in members:
                msg_t = {"type": "pg_log_trim", "pool": pool_id,
                         "ps": ps}
                if o == self.id:
                    self._h_pg_log_trim(msg_t)
                elif self._alive(o):
                    self.msgr.send(self.osd_addrs[o], msg_t)
            # every up member holds everything: strays may drop their
            # copies (PG removal after clean)
            for o in strays:
                if o in up or o in acting or not self._alive(o):
                    continue
                try:
                    rep = self.msgr.call(
                        self.osd_addrs[o],
                        {"type": "pg_purge", "pool": pool_id,
                         "ps": ps}, timeout=5)
                    if rep.get("ok"):
                        with self._lock:
                            self._strays.get((pool_id, ps),
                                             set()).discard(o)
                except (TimeoutError, OSError):
                    pass

    @staticmethod
    def _shard_v_of(infos: Dict, osd: int, oid: str,
                    pos: int) -> str:
        return infos.get(osd, {}).get("objects", {}) \
            .get(oid, {}).get("shards", {}) \
            .get(str(pos), NULL_VERSION)

    # -- the recovery engine (reserved, pipelined, load-balanced) ------
    def _run_recovery(self, m, pool_id, pool, ps, up, rep_items,
                      ec_groups, infos, shard_v, code) -> bool:
        """One PG's recovery work for this peering pass, under the
        reservation/throttle plane: acquire a recovery slot on every
        alive push target (local slot + remote ``recovery_reserve``
        grants, the AsyncReserver local/remote pair) so concurrent
        primaries recovering onto one OSD stay bounded and client p99
        holds; then drive replicated pulls and the pipelined EC engine
        under the backfill throttle.  A reservation miss backs off
        briefly (jittered) and defers the PG to the next pass —
        recovery yields, it never stalls."""
        pc = self.rec_pc
        targets = sorted({o for o in list(up) + [self.id]
                          if o == self.id or self._alive(o)})
        granted = self._reserve_recovery(targets)
        bo = Backoff(base=0.05, cap=0.4, deadline=1.5)
        while granted is None:
            pc.inc("reservation_waits")
            if not bo.sleep():
                return False  # contended: the periodic pass retries
            granted = self._reserve_recovery(targets)
        try:
            ok = True
            for oid, rec in rep_items:
                if not self.backfill_throttle.get(timeout=5):
                    return False
                try:
                    ok &= self._recover_object(
                        m, pool_id, pool, ps, up, oid, rec, infos,
                        shard_v, code)
                finally:
                    self.backfill_throttle.put()
            if ec_groups:
                if not self.backfill_throttle.get(timeout=5):
                    return False
                try:
                    ok &= self._recover_ec_groups(
                        pool_id, ps, up, ec_groups, infos, shard_v,
                        code)
                finally:
                    self.backfill_throttle.put()
            return ok
        finally:
            self._release_recovery(granted)

    def _reserve_recovery(self, targets) -> Optional[List[int]]:
        """All-or-nothing slot acquisition in ascending OSD order
        (two primaries reserving each other cannot deadlock: failure
        releases everything and backs off).  An unreachable target is
        skipped — its pushes fail on their own; reservation must not
        stall the reachable rest."""
        granted: List[int] = []
        for o in targets:
            if o == self.id:
                if self.rec_reserver.try_acquire():
                    granted.append(o)
                    continue
                self._release_recovery(granted)
                return None
            try:
                rep = self.msgr.call(
                    self.osd_addrs[o],
                    {"type": "recovery_reserve", "osd": self.id},
                    timeout=5)
            except (TimeoutError, OSError):
                continue
            if rep.get("granted"):
                granted.append(o)
            else:
                self._release_recovery(granted)
                return None
        return granted

    def _release_recovery(self, granted) -> None:
        for o in granted:
            if o == self.id:
                self.rec_reserver.release()
                continue
            try:
                self.msgr.send(self.osd_addrs[o],
                               {"type": "recovery_reserve",
                                "osd": self.id, "release": True})
            except (KeyError, OSError):
                pass

    def _recovery_executor(self):
        """Dedicated small pool for pipelined helper gathers — NOT
        the replica fan-out pool: a gather submitting into the pool
        its caller occupies would deadlock at depth."""
        with self._lock:
            ex = getattr(self, "_recover_pool", None)
            if ex is None:
                from concurrent.futures import ThreadPoolExecutor

                ex = self._recover_pool = ThreadPoolExecutor(
                    max_workers=4,
                    thread_name_prefix=f"osd{self.id}-rec")
            return ex

    def _recover_ec_groups(self, pool_id, ps, up, ec_groups, infos,
                           shard_v, code) -> bool:
        """Pipelined multi-object EC recovery (RapidRAID's streaming
        model, arXiv:1207.6744): erasure-pattern groups split into
        bounded units of ``osd_recovery_batch_max_objects``; helper
        shard reads for unit N+1 stream on the gather pool while unit
        N's stripes decode and push on this thread.  Depth <= 1
        degrades to serial gather-then-decode (the drill's baseline
        knob)."""
        import itertools
        from collections import deque

        conf = self.ctx.conf
        pc = self.rec_pc
        depth = int(conf["osd_recovery_pipeline_depth"])
        batch_max = max(1, int(conf["osd_recovery_batch_max_objects"]))
        pace = float(conf["osd_recovery_sleep"])
        cid = pg_cid(pool_id, ps)
        ok = True
        units = []
        for (need, avail, v), items in ec_groups.items():
            strategy, plan = self._choose_ec_strategy(
                code, need, avail, items[0][0], v, infos, shard_v)
            if plan is None:
                self.log.derr(
                    f"pg {cid}: {len(items)} objects undecodable, "
                    f"pattern need={need} avail={avail}")
                ok = False
                continue
            for i in range(0, len(items), batch_max):
                units.append((need, avail, v, strategy, plan,
                              items[i:i + batch_max]))

        def gather(unit):
            return self._gather_ec_unit(pool_id, ps, unit, infos,
                                        shard_v, code)

        if depth <= 1:
            for unit in units:
                ok &= self._decode_push_ec_unit(
                    pool_id, ps, up, unit, gather(unit), infos,
                    shard_v, code)
                pc.inc("serial_batches")
                if pace > 0:
                    time.sleep(pace)  # the
                    # osd_recovery_sleep pacing knob, not retry pacing
            return ok
        ex = self._recovery_executor()
        pending: deque = deque()
        it = iter(units)
        for unit in itertools.islice(it, depth):
            pending.append((unit, ex.submit(gather, unit)))
        while pending:
            unit, fut = pending.popleft()
            nxt = next(it, None)
            if nxt is not None:
                # keep `depth` gathers in flight BEFORE decoding: the
                # next unit's helper reads overlap this unit's decode
                pending.append((nxt, ex.submit(gather, nxt)))
            try:
                gathered = fut.result(timeout=60)
            except Exception as e:
                self.log.derr(f"pg {cid}: recovery gather failed: "
                              f"{e!r}")
                ok = False
                continue
            ok &= self._decode_push_ec_unit(
                pool_id, ps, up, unit, gathered, infos, shard_v, code)
            pc.inc("pipelined_batches")
            if pace > 0:
                time.sleep(pace)  # fault-ok: the osd_recovery_sleep
                # pacing knob, not retry pacing
        return ok

    def _pos_load(self, oid: str, v: str, pos: int, infos,
                  shard_v) -> float:
        holders = [o for o in infos if shard_v(o, oid, pos) == v]
        if not holders:
            return float("inf")
        return min(self.rec_ledger.load(o) for o in holders)

    def _choose_ec_strategy(self, code, need, avail, rep_oid, v,
                            infos, shard_v):
        """Pick the repair strategy for one erasure-pattern group:
        CLAY 1/q-bandwidth repair when the profile and loss pattern
        allow it, LRC local-group repair when the layered minimum
        stays under k, full decode otherwise — and for full decode,
        prefer the k LEAST-LOADED feasible survivors over the
        first-k-up default.  Returns (strategy, plan): the plan is a
        sorted position list for full/lrc, the sub-chunk read plan
        dict for clay, or None when the pattern is undecodable."""
        k = code.get_data_chunk_count()
        want, have = set(need), set(avail)
        try:
            sub = code.get_sub_chunk_count()
        except Exception:
            sub = 1
        if len(want) == 1 and sub > 1 and hasattr(code, "is_repair"):
            try:  # wire-ok: EC plan math (minimum_to_decode), not a wire decode
                if code.is_repair(want, have):
                    return "clay", code.minimum_to_decode(want, have)
            except Exception:
                pass
        try:
            plan = code.minimum_to_decode(want, have)
        except Exception:
            return "full", None
        if len(plan) < k:
            return "lrc", sorted(plan)
        use = self._plan_full_use(code, want, have, rep_oid, v, infos,
                                  shard_v)
        return "full", use if use is not None else sorted(plan)[:k]

    def _plan_full_use(self, code, want, have, rep_oid, v, infos,
                       shard_v) -> Optional[List[int]]:
        """Least-loaded feasible survivor set for a full decode: rank
        positions by their best holder's ledger load and expand from
        the cheapest k until the code accepts the candidate set (MDS
        codes accept immediately; layered codes may need more)."""
        k = code.get_data_chunk_count()
        order = sorted(have, key=lambda p: (self._pos_load(
            rep_oid, v, p, infos, shard_v), p))
        if hasattr(code, "is_repair"):
            # MDS by construction: any k survivors decode, and
            # minimum_to_decode would re-route to the repair plan
            return order[:k] if len(order) >= k else None
        for cut in range(k, len(order) + 1):
            try:  # wire-ok: EC plan math (minimum_to_decode), not a wire decode
                return sorted(code.minimum_to_decode(
                    want, set(order[:cut])))
            except Exception:
                continue
        return None

    def _gather_ec_unit(self, pool_id, ps, unit, infos, shard_v,
                        code):
        """Fetch one unit's helper shards (runs on the gather pool
        under the pipeline).  Per object: ("batch", oid, rec, chunks)
        for concat-decode, ("clay", oid, rec, repair) for bandwidth
        repair, or None when no feasible plan survived this pass."""
        need, avail, v, strategy, plan, items = unit
        out = []
        for oid, rec in items:
            if strategy == "clay":
                got = self._gather_clay_object(
                    pool_id, ps, oid, rec, v, plan, infos, shard_v,
                    code)
                if got is not None:
                    out.append(("clay", oid, rec, got))
                    continue
                # sub-chunk repair unavailable for THIS object
                # (helper loss / misaligned chunk): full decode
                use = self._plan_full_use(code, set(need), set(avail),
                                          oid, v, infos, shard_v)
                if use is None:
                    out.append(None)
                    continue
            else:
                use = list(plan)
            chunks = self._gather_ec_object(
                pool_id, ps, oid, rec, v, use, avail, need, infos,
                shard_v, code)
            out.append(("batch", oid, rec, chunks)
                       if chunks is not None else None)
        return out

    def _rec_holders(self, key, oid, v, pos, infos, shard_v):
        """Candidate holders for one shard, failure-excluded and
        sorted least-loaded-first."""
        excl = self.rec_ledger.excluded(key)
        holders = [o for o in infos
                   if o not in excl and shard_v(o, oid, pos) == v]
        return sorted(holders,
                      key=lambda o: (self.rec_ledger.load(o), o))

    def _fetch_pos(self, key, pool_id, ps, oid, rec, v, pos, infos,
                   shard_v, ranges=None):
        """One position's shard from its least-loaded holder.  A
        failed or stale read EXCLUDES that holder for this object's
        remaining attempts (across passes — the retry-duplication
        fix) and falls through to the next candidate."""
        import numpy as np

        led = self.rec_ledger
        pc = self.rec_pc
        for o in self._rec_holders(key, oid, v, pos, infos, shard_v):
            led.start(o)
            try:
                rep = self._read_shard_from(o, pool_id, ps, oid, pos,
                                            ranges=ranges)
            finally:
                led.finish(o)
            if rep is not None and rep[0] == v:
                pc.inc("helper_reads")
                pc.inc("helper_bytes", len(rep[1]))
                # the object size travels with the shard: the info
                # record's size may describe a newer torn version
                rec["size"] = rep[2]
                return np.frombuffer(rep[1], np.uint8)
            led.exclude(key, o)
            pc.inc("helper_eio_excluded")
        return None

    def _gather_ec_object(self, pool_id, ps, oid, rec, v, use, avail,
                          need, infos, shard_v, code):
        """One object's survivor chunks for a full/lrc decode.  When
        a position runs out of non-excluded holders, RE-PLAN the
        decode from the remaining survivors (jitter-paced within the
        osd_recovery_helper_deadline budget) instead of stalling the
        object on the failed helper."""
        key = (pool_id, ps, oid)
        bo = Backoff(base=0.02, cap=0.25,
                     deadline=self.ctx.conf[
                         "osd_recovery_helper_deadline"])
        pending = list(use)
        chunks: Dict[int, object] = {}
        while pending:
            pos = pending.pop(0)
            arr = self._fetch_pos(key, pool_id, ps, oid, rec, v, pos,
                                  infos, shard_v)
            if arr is not None:
                chunks[pos] = arr
                continue
            self.rec_pc.inc("replans")
            feasible = {p for p in avail
                        if p in chunks or self._rec_holders(
                            key, oid, v, p, infos, shard_v)}
            try:
                newplan = code.minimum_to_decode(set(need), feasible)
            except Exception:
                return None  # not decodable this pass; retried later
            newuse = sorted(newplan)
            chunks = {p: c for p, c in chunks.items() if p in newuse}
            pending = [p for p in newuse if p not in chunks]
            if not bo.sleep():
                return None
        return chunks

    def _gather_clay_object(self, pool_id, ps, oid, rec, v, plan,
                            infos, shard_v, code):
        """CLAY 1/q-bandwidth repair gather: the first helper reads
        FULL (establishing the chunk length), the remaining d-1 read
        only their repair sub-chunk ranges server-side — the network
        never carries the bytes a full decode would have."""
        import numpy as np

        key = (pool_id, ps, oid)
        helpers = sorted(plan)
        sub = code.get_sub_chunk_count()
        first = helpers[0]
        arr = self._fetch_pos(key, pool_id, ps, oid, rec, v, first,
                              infos, shard_v)
        if arr is None:
            return None
        chunk_len = len(arr)
        if chunk_len == 0 or chunk_len % sub != 0:
            return None
        scs = chunk_len // sub
        got: Dict[int, object] = {}
        read_bytes = chunk_len
        for c in helpers:
            ranges = [(int(i) * scs, int(cnt) * scs)
                      for i, cnt in plan[c]]
            want_len = sum(ln for _off, ln in ranges)
            if c == first:
                got[c] = np.concatenate(
                    [arr[off:off + ln] for off, ln in ranges])
                continue
            sl = self._fetch_pos(key, pool_id, ps, oid, rec, v, c,
                                 infos, shard_v, ranges=ranges)
            if sl is None or len(sl) != want_len:
                return None
            got[c] = sl
            read_bytes += want_len
        k = code.get_data_chunk_count()
        return {"helpers": got, "chunk_len": chunk_len,
                "saved": max(0, k * chunk_len - read_bytes)}

    def _decode_push_ec_unit(self, pool_id, ps, up, unit, gathered,
                             infos, shard_v, code) -> bool:
        """Decode one gathered unit and push the rebuilt shards.
        Batch entries sharing a survivor set concatenate along the
        byte axis into ONE decode launch (recover_stripes' execution
        model; the codes are bytewise-linear, so decode(concat) ==
        concat of per-object decodes); clay entries repair
        per-object with chunk_size routing into the code's
        sub-chunk `_repair` path."""
        import numpy as np

        need, avail, v, strategy, plan, items = unit
        pc = self.rec_pc
        cid = pg_cid(pool_id, ps)
        k = code.get_data_chunk_count()
        ok = True
        batch = []
        for entry in gathered:
            if entry is None:
                ok = False
                continue
            if entry[0] == "clay":
                _kind, oid, rec, got = entry
                try:
                    out = code.decode(set(need),
                                      dict(got["helpers"]),
                                      chunk_size=got["chunk_len"])
                except Exception as e:
                    self.log.derr(f"pg {cid}: clay repair of {oid} "
                                  f"failed: {e!r}")
                    ok = False
                    continue
                pos = next(iter(need))
                shard = host_rows([out[pos]])[0]
                ok &= self._push_rebuilt(pool_id, ps, up, oid, rec, v,
                                         {pos: shard}, shard_v)
                pc.inc("strategy_clay")
                pc.inc("helper_bytes_saved", got["saved"])
            else:
                batch.append(entry[1:])
        # bucket by survivor set: re-planned objects may have deviated
        # from the unit's plan and need their own decode launch
        buckets: Dict[frozenset, List] = {}
        for oid, rec, chunks in batch:
            buckets.setdefault(frozenset(chunks), []).append(
                (oid, rec, chunks))
        for useset, objs in buckets.items():
            offsets, total = [], 0
            for _oid, _rec, chunks in objs:
                ln = len(next(iter(chunks.values())))
                offsets.append((total, ln))
                total += ln
            surviving = {
                pos: np.concatenate([c[pos] for _o, _r, c in objs])
                for pos in useset}
            try:
                out = code.decode(set(need), surviving)
            except Exception as e:
                self.log.derr(f"pg {cid}: batched decode failed "
                              f"(use={sorted(useset)}): {e!r}")
                ok = False
                continue
            lrc_win = len(useset) < k
            # the rebuilt positions come back to the host in one copy
            wanted = sorted(need)
            host = host_rows([out[pos] for pos in wanted])
            for (oid, rec, _c), (off, ln) in zip(objs, offsets):
                shards = {
                    pos: host[i, off:off + ln]
                    for i, pos in enumerate(wanted)}
                ok &= self._push_rebuilt(pool_id, ps, up, oid, rec,
                                         v, shards, shard_v)
                if lrc_win:
                    pc.inc("strategy_lrc")
                    pc.inc("helper_bytes_saved",
                           (k - len(useset)) * ln)
                else:
                    pc.inc("strategy_full")
        return ok

    def _push_rebuilt(self, pool_id, ps, up, oid, rec, v, shards,
                      shard_v) -> bool:
        """Push one object's rebuilt shards to their up members.
        force+expect: the authoritative version may be LOWER than a
        torn never-acked shard on a member — roll it back, but only
        if the shard is still exactly what peering observed (a racing
        newer client write wins)."""
        ok = True
        for pos, shard in shards.items():
            osd = up[pos]
            if osd != self.id and not self._alive(osd):
                ok = False
                continue
            self._push_shard(pool_id, ps, osd, oid, pos,
                             shard.tobytes(), rec.get("size", 0), v,
                             force=True,
                             expect=shard_v(osd, oid, pos))
        self.pc.inc("recovered_objects")
        self._account_io(pool_id, ps, objects_recovered=1)
        return ok

    def _send_delete(self, pool_id, ps, osd, oid, v, force=False,
                     expect=None) -> None:
        msg = {"type": "obj_delete", "pool": pool_id, "ps": ps,
               "oid": oid, "v": v}
        if force:
            msg["force"] = True
            msg["expect"] = expect
        try:
            if osd == self.id:
                self._h_obj_delete(msg)
            else:
                self.msgr.call(self.osd_addrs[osd], msg, timeout=5)
        except (TimeoutError, OSError):
            pass

    def _recover_object(self, m, pool_id, pool, ps, up, oid, rec,
                        infos, shard_v, code) -> bool:
        """Primary-driven REPLICATED object recovery at the
        authoritative version (ReplicatedBackend push-pull): returns
        True when every up member holds oid@v.  EC objects never reach
        here — _peer_pg_locked routes them through the torn-write-aware
        pipelined path (_recover_ec_groups)."""
        import numpy as np

        assert code is None, "EC recovery goes through the batch path"
        cid = pg_cid(pool_id, ps)
        v, size = rec["v"], rec.get("size", 0)
        need = [o for o in up if shard_v(o, oid, 0) != v]
        if not need:
            return True
        data = None
        for o in infos:
            if shard_v(o, oid, 0) != v:
                continue
            rep = self._read_shard_from(o, pool_id, ps, oid, 0)
            if rep is not None and rep[0] == v:
                data = np.frombuffer(rep[1], np.uint8)
                size = rep[2]
                break
        if data is None:
            self.log.derr(f"pg {cid} {oid}@{v}: no reachable holder")
            return False
        ok = True
        for o in need:
            if o != self.id and not self._alive(o):
                ok = False
                continue
            self._push_shard(pool_id, ps, o, oid, 0, data.tobytes(),
                             size, v)
        self.pc.inc("recovered_objects")
        self._account_io(pool_id, ps, objects_recovered=1)
        return ok

    def _push_shard(self, pool_id, ps, osd, oid, shard, data, size,
                    v, qos: str = "recovery", force: bool = False,
                    expect: Optional[str] = None) -> Optional[Dict]:
        """One shard write, local or remote.  Returns the holder's
        reply (so callers can distinguish `superseded` — the holder
        kept its newer version — from a genuine persist) or None on
        transport failure."""
        # every caller hands a stable bytes payload (a device->host
        # tobytes() or an already-materialised shard) — no defensive
        # re-copy here
        msg = {"type": "shard_write", "pool": pool_id, "ps": ps,
               "oid": oid, "shard": shard, "data": data,
               "size": size, "v": v, "qos_class": qos}
        if force:
            msg["force"] = True
            msg["expect"] = expect
        try:
            if osd == self.id:
                # direct: the caller is already a scheduled worker or
                # the RMW coordinator — re-submitting would deadlock
                # the worker pool
                rep = self._do_shard_write(msg)
            else:
                # 5s: long enough for a loaded replica's fsync+queue,
                # but a push often runs under the PG lock, so a dead
                # peer must stop blocking the whole PG quickly (the
                # messenger fails even faster once its resync gives
                # the peer up)
                rep = self.msgr.call(self.osd_addrs[osd], msg,
                                     timeout=5)
        except (TimeoutError, OSError):
            return None
        if qos == "recovery" and rep is not None and rep.get("ok"):
            self.pc.inc("recovery_bytes", len(msg["data"]))
            # recovery-push copy: the decoded shard is materialised
            # once (the caller's device->host tobytes()) for the push
            copytrack.book_pc(self._copy_pc, "recovery_push",
                              len(msg["data"]), copies=1)
            self._account_io(pool_id, ps,
                             bytes_recovered=len(msg["data"]))
        return rep

    def _set_pg_temp(self, pool_id: int, ps: int,
                     osds: List[int]) -> None:
        """Install/clear the acting override at the monitor; no-op when
        the map already agrees (avoids commit churn every pass)."""
        with self._lock:
            cur = self.map.pg_temp.get((pool_id, ps), []) \
                if self.map is not None else []
        if list(cur) == list(osds):
            return
        try:
            self.mon_call({"type": "pg_temp_set", "pool": pool_id,
                           "ps": ps, "osds": list(osds)}, timeout=5,
                          tries=1)
        except Exception as e:
            self.log.dout(5, f"pg_temp_set failed: {e}")
