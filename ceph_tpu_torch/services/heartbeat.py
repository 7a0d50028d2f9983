"""Peer heartbeat plane — the OSD-side failure detector.

The role of ``OSD::heartbeat`` / ``OSD::maybe_update_heartbeat_peers``
(src/osd/OSD.cc:5487): every OSD pings the peers it shares PGs with
over the messenger control lane, keeps a per-peer last-ack clock plus
an EWMA of ping latency, and reports a peer past its (latency-adapted)
grace to the monitors as an ``osd_failure`` — the raw material of
``OSDMonitor::check_failure``'s reporter quorums.  The direct OSD→mon
beacon survives only as liveness-of-last-resort with the much longer
``mon_osd_report_timeout``, so a cut mon↔OSD link alone can no longer
kill a healthy OSD that its peers still hear.

Pings are fire-and-forget both ways (MOSDPing PING / PING_REPLY): the
sender stamps a monotonic clock, the receiver echoes it back in its
own fire-and-forget reply, and the sender's reply handler turns the
echo into an RTT sample.  Nothing in the ping path ever blocks on a
dead peer — that is the point of a failure detector.

The peer set is recomputed on every map-epoch install (the
``maybe_update_heartbeat_peers`` hook in ``_post_map_install``): for
each PG this OSD is in the up or acting set of, every other member is
a heartbeat peer.  The latency EWMA adapts the effective grace
(``grace + 4×ewma``) so a loaded-but-alive peer whose scheduling
latency grows is not storm-reported (the reference's
``mon_osd_adjust_heartbeat_grace`` idea, done sender-side).

The port's copy of ``ceph_tpu/services/heartbeat.py``, on the port's
runtime; it does no device work.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from ..analysis.asyncheck import nonblocking
from ..analysis.lockdep import make_lock
from ..analysis.racecheck import guarded_by

# EWMA smoothing for ping RTT and its weight in the effective grace:
# eff_grace = grace + GRACE_LAT_FACTOR * ewma.  On a loopback cluster
# ewma is sub-millisecond and the bound stays ~grace; under full-suite
# CPU load the inflated RTTs buy loaded peers headroom automatically.
EWMA_ALPHA = 0.3
GRACE_LAT_FACTOR = 4.0

# dump_osd_network / OSD_SLOW_PING_TIME window spans, seconds — the
# reference's 1/5/15-minute ping-time averages (osd_mon_heartbeat_
# stat_stale windows in OSD::heartbeat_check).  A ring of 4096
# timestamped samples covers 15 min at the default 0.5s interval with
# room for a few peers' worth of bursts.
WINDOWS = ((60.0, "1min"), (300.0, "5min"), (900.0, "15min"))
_RTT_RING = 4096


class _Peer:
    """Per-peer clock state (one heartbeat_info_t)."""

    __slots__ = ("last_ack", "ewma", "rtts")

    def __init__(self, now: float):
        # a fresh peer gets a full grace window from discovery — it
        # has never been asked, so it cannot already be overdue
        self.last_ack = now
        self.ewma = 0.0
        # (monotonic stamp, rtt_s) ring — the window averages behind
        # dump_osd_network and the OSD_SLOW_PING_TIME breach report
        self.rtts: collections.deque = collections.deque(
            maxlen=_RTT_RING)

    def window_avgs_ms(self, now: float) -> Dict[str, float]:
        """Mean RTT (ms) per lookback window over the sample ring."""
        sums = [0.0] * len(WINDOWS)
        ns = [0] * len(WINDOWS)
        for t, rtt in self.rtts:
            age = now - t
            for i, (span, _label) in enumerate(WINDOWS):
                if age <= span:
                    sums[i] += rtt
                    ns[i] += 1
        return {label: round(1e3 * sums[i] / ns[i], 3)
                if ns[i] else 0.0
                for i, (_span, label) in enumerate(WINDOWS)}


@guarded_by("osd::hb", "_peers")
class HeartbeatPlane:
    """One OSD's peer-ping plane.  Owned by OSDService: constructed
    with it (registers its two control-lane handlers), started after
    the first map install, peers recomputed per epoch."""

    def __init__(self, svc) -> None:
        self.svc = svc
        self.log = svc.log
        conf = svc.ctx.conf
        self.interval: float = conf["osd_heartbeat_interval"]
        self.grace: float = conf["osd_heartbeat_grace"]
        self.ping_threshold_ms: float = \
            conf["osd_heartbeat_ping_threshold_ms"]
        self._lock = make_lock("osd::hb")
        self._peers: Dict[int, _Peer] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        pc = self.pc = svc.ctx.perf.create(f"osd.hb.{svc.id}")
        for key in ("pings", "acks", "failures_reported"):
            pc.add_u64_counter(key)
        pc.add_u64("peers")
        pc.add_time("ping_time")
        pc.add_histogram("ping_lat")
        svc.msgr.register("osd_ping", self._h_ping, control=True)
        svc.msgr.register("osd_ping_reply", self._h_ping_reply,
                          control=True)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"osd{self.svc.id}-hb")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    # -- peer selection (maybe_update_heartbeat_peers) -----------------
    def update_peers(self) -> None:
        """Recompute the peer set from the installed map: every other
        member of every PG this OSD is in the up or acting set of."""
        svc = self.svc
        with svc._lock:
            m = svc.map
        if m is None:
            return
        me = svc.id
        want = set()
        for pool_id, pool in list(m.pools.items()):
            for ps in range(pool.pg_num):
                up, _p, acting, _ap = svc.pg_up_acting(pool_id, ps)
                # >= 0 drops CRUSH_ITEM_NONE placeholders (EC pools
                # keep positional holes for unmapped shards)
                members = {o for o in set(up) | set(acting) if o >= 0}
                if me in members:
                    want |= members - {me}
        # pad sparse PG overlap (small pools, pool-less clusters) with
        # other up osds — the osd_heartbeat_min_peers role — walking
        # ids cyclically FROM our own so padding coverage spreads
        # instead of piling onto the lowest ids
        min_peers = svc.ctx.conf["osd_heartbeat_min_peers"]
        if len(want) < min_peers:
            others = sorted(
                (o for o in range(m.max_osd)
                 if o != me and o not in want and m.exists(o)
                 and m.is_up(o)),
                key=lambda o: (o - me) % max(m.max_osd, 1))
            want.update(others[:min_peers - len(want)])
        now = time.monotonic()
        with self._lock:
            for osd in list(self._peers):
                if osd not in want:
                    del self._peers[osd]
            for osd in want:
                if osd not in self._peers:
                    self._peers[osd] = _Peer(now)
            self.pc.set("peers", len(self._peers))

    # -- the ping loop -------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception as e:
                self.log.derr(f"osd.{self.svc.id} hb tick: {e!r}")

    @nonblocking
    def _tick(self) -> None:
        svc = self.svc
        now = time.monotonic()
        with self._lock:
            peers = {o: (p.last_ack, p.ewma)
                     for o, p in self._peers.items()}
        with svc._lock:
            m = svc.map
            addrs = dict(svc.osd_addrs)
        overdue = []
        for osd, (last_ack, ewma) in peers.items():
            addr = addrs.get(osd)
            if addr is None:
                continue  # can't ping -> no basis to condemn; the
                # mon's beacon timeout owns an osd we can't even dial
            svc.msgr.send(tuple(addr), {  # block-ok: lossless send is deadline-bounded (2s sequencing-lock timeout, fire-and-forget frame) — a dead peer costs a bounded stall, never a wedge
                "type": "osd_ping", "osd": svc.id,
                "addr": list(svc.addr), "stamp": now})
            self.pc.inc("pings")
            eff_grace = self.grace + GRACE_LAT_FACTOR * ewma
            if now - last_ack > eff_grace and m is not None and \
                    m.is_up(osd):
                overdue.append((osd, now - last_ack))
        for osd, failed_for in overdue:
            # re-sent every interval while the peer stays silent and
            # up in our map: the monitor's reports DECAY, so a live
            # claim must keep refreshing until check_failure acts
            svc.mon_send({"type": "osd_failure", "osd": osd,  # block-ok: fire-and-forget mon report over the bounded lossless send path (2s sequencing timeout)
                          "frm_osd": svc.id,
                          "failed_for": round(failed_for, 3)})
            self.pc.inc("failures_reported")

    # -- handlers (both fire-and-forget, control lane) -----------------
    @nonblocking
    def _h_ping(self, msg: Dict) -> None:
        # echo the stamp back to the pinger's listening address; our
        # own send is fire-and-forget too, so a half-dead link drops
        # the reply instead of wedging this handler
        addr = msg.get("addr")
        if addr:
            self.svc.msgr.send(tuple(addr), {  # block-ok: fire-and-forget echo on the bounded lossless send path (2s sequencing timeout); a half-dead link drops the reply, never wedges the handler
                "type": "osd_ping_reply", "osd": self.svc.id,
                "stamp": msg.get("stamp", 0.0)})
        return None

    @nonblocking
    def _h_ping_reply(self, msg: Dict) -> None:
        now = time.monotonic()
        rtt = max(0.0, now - float(msg.get("stamp", now)))
        osd = int(msg["osd"])
        with self._lock:
            peer = self._peers.get(osd)
            if peer is None:
                return None
            peer.last_ack = now
            peer.ewma = rtt if peer.ewma == 0.0 else (
                EWMA_ALPHA * rtt + (1.0 - EWMA_ALPHA) * peer.ewma)
            peer.rtts.append((now, rtt))
        self.pc.inc("acks")
        self.pc.tinc("ping_time", rtt)
        self.pc.hist_add("ping_lat", rtt)
        return None

    # -- the network-health surface (dump_osd_network) -----------------
    def dump_network(self,
                     threshold_ms: Optional[float] = None) -> Dict:
        """Per-peer RTT window averages, worst first — the `ceph
        daemon osd.N dump_osd_network` payload.  Only peers whose
        worst window average reaches ``threshold_ms`` are listed
        (0 lists everything); the default threshold is the
        OSD_SLOW_PING_TIME knob, so the dump shows exactly the peers
        the health check would complain about."""
        if threshold_ms is None:
            threshold_ms = self.ping_threshold_ms
        now = time.monotonic()
        with self._lock:
            peers = {o: (p.window_avgs_ms(now),
                         list(p.rtts)[-1][1] if p.rtts else None)
                     for o, p in self._peers.items()}
        entries = []
        for osd, (avgs, last) in peers.items():
            worst = max(avgs.values()) if avgs else 0.0
            e = {"peer": osd, "worst_ms": worst,
                 "last_ms": round(1e3 * last, 3)
                 if last is not None else None}
            e.update(avgs)
            entries.append(e)
        entries.sort(key=lambda e: e["worst_ms"], reverse=True)
        shown = [e for e in entries
                 if threshold_ms <= 0 or e["worst_ms"] >= threshold_ms]
        return {"osd": self.svc.id,
                "threshold_ms": threshold_ms,
                "total_peers": len(entries),
                "entries": shown}

    def ping_breaches(self) -> List[Dict]:
        """Peers whose worst window average crosses the threshold —
        the compact list the OSD beacon carries so the monitor can
        raise OSD_SLOW_PING_TIME with per-pair attribution."""
        dump = self.dump_network()
        return [{"peer": e["peer"], "avg_ms": e["worst_ms"]}
                for e in dump["entries"]
                if e["worst_ms"] >= dump["threshold_ms"] > 0]

    def wire(self, admin_socket) -> None:
        def _dump(args: Dict) -> Dict:
            thr = args.get("threshold_ms")
            return self.dump_network(
                float(thr) if thr is not None else None)

        admin_socket.register(
            "dump_osd_network", _dump,
            "heartbeat RTT window averages per peer (worst first)")
