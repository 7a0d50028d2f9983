"""MapFollower — the MonClient role: follow OSDMap epochs.

Shared by every map subscriber (OSD services, clients): install full
maps, apply incremental deltas COPY-AND-SWAP (readers holding the old
map object keep a consistent snapshot — placements are never computed
from a half-applied epoch), and catch up across gaps by walking the
monitor's retained incrementals (``get_inc``), falling back to one
full ``get_map`` only when an epoch has aged out — the O(change)
distribution contract.

Users provide ``_lock``, ``map``, ``epoch``, ``osd_addrs``,
``ec_profiles``, ``msgr``, ``mon_addr`` and may override
``_post_map_install()`` (called after every successful install, not
under the lock).

The port's copy of ``ceph_tpu/services/map_follower.py``, on the port's
runtime; it does no device work.
"""

from __future__ import annotations

import time
from typing import Dict

from ..analysis.asyncheck import nonblocking
from ..common.backoff import Backoff
from ..common.perf_counters import collection
from ..osdmap.incremental import Incremental, apply_incremental
from ..osdmap.osdmap import OSDMap

# process-global scalar-mapping metrics: every daemon's data path asks
# pg_up_acting per op, so lookup volume, cache efficacy, and walk
# latency live here (served via each daemon's merged `perf dump`)
_pc = collection().create("crush.scalar")
_pc.add_u64_counter("pg_lookups")
_pc.add_u64_counter("cache_hits")
_pc.add_time("map_time")
_pc.add_histogram("map_lat")


class MonError(RuntimeError):
    """Transient quorum condition (no leader yet / pre-genesis) — the
    caller should retry; never used for map-application defects."""


def failover_call(msgr, addrs, msg: Dict, timeout: float = 5.0,
                  tries: int = 3):
    """Call a monitor, rotating across the quorum: connection errors
    move to the next member; 'no quorum' / pre-genesis replies back
    off briefly for the election in flight.  Returns (reply, addr) so
    callers can remember the member that answered.  Shared by daemon
    followers (mon_call) and the MiniCluster harness (mon_command)."""
    last: Exception = MonError("no monitors configured")
    n = max(1, len(addrs))
    # jittered pacing for in-flight elections: N waiting daemons must
    # not re-probe the quorum in lockstep (common/backoff.py)
    bo = Backoff(base=0.1, cap=0.5)
    for i in range(max(1, tries) * n):
        addr = addrs[i % n]
        try:
            rep = msgr.call(addr, msg, timeout=timeout)
        except (OSError, TimeoutError) as e:
            last = e
            continue
        err = rep.get("error") if isinstance(rep, dict) else None
        if err in ("no quorum", "no committed map yet"):
            last = MonError(err)
            bo.sleep()
            continue
        return rep, tuple(addr)
    raise last


class MapFollower:
    # -- monitor targets (quorum-aware MonClient) ----------------------
    def _init_mons(self, mon_addr) -> None:
        """Accept one monitor address or a rank-ordered list of them;
        ``self.mon_addr`` is the currently preferred target and
        rotates on failure."""
        if mon_addr and isinstance(mon_addr[0], (list, tuple)):
            self.mon_addrs = [tuple(a) for a in mon_addr]
        else:
            self.mon_addrs = [tuple(mon_addr)]
        self.mon_addr = self.mon_addrs[0]

    def mon_call(self, msg: Dict, timeout: float = 5.0,
                 tries: int = 3) -> Dict:
        i = self.mon_addrs.index(self.mon_addr)
        order = self.mon_addrs[i:] + self.mon_addrs[:i]
        rep, used = failover_call(self.msgr, order, msg, timeout,
                                  tries)
        self.mon_addr = used
        return rep

    def mon_send(self, msg: Dict) -> None:
        """Fire-and-forget to every quorum member: peons forward or
        drop; send() swallows dead-peer errors, so pinning one target
        could silently blackhole (e.g. a down OSD's re-boot)."""
        for addr in self.mon_addrs:
            self.msgr.send(addr, msg)

    def subscribe_all(self, name: str, timeout: float = 15.0) -> Dict:
        """Subscribe to EVERY quorum member (each pushes committed
        epochs, so losing one monitor loses no updates) and return the
        newest committed payload; retries through elections."""
        bo = Backoff(base=0.1, cap=0.5, deadline=timeout)
        while True:
            payload = None
            for addr in self.mon_addrs:
                try:
                    rep = self.msgr.call(
                        addr, {"type": "subscribe", "name": name,
                               "addr": list(self.msgr.addr)},
                        timeout=3.0)
                except (OSError, TimeoutError):
                    continue
                if isinstance(rep, dict) and "epoch" in rep:
                    if payload is None or rep["epoch"] > \
                            payload["epoch"]:
                        payload = rep
            if payload is not None:
                return payload
            if not bo.sleep():
                raise TimeoutError(f"{name}: no committed map from "
                                   f"any monitor")

    def _set_extras(self, msg: Dict) -> None:
        """osd address table + EC profiles travel beside the map
        (call under self._lock)."""
        if "osd_addrs" in msg:
            self.osd_addrs = {int(k): tuple(v)
                              for k, v in msg["osd_addrs"].items()}
        if "ec_profiles" in msg:
            self.ec_profiles = msg["ec_profiles"]

    def pg_up_acting(self, pool_id: int, ps: int):
        """Cached pg_to_up_acting_osds: the scalar CRUSH walk costs
        ~0.4 ms and the data path asks per op; maps here are
        copy-apply-swap (never mutated in place), so caching per
        installed map object is sound.  Cleared on every swap."""
        key = (pool_id, ps)
        _pc.inc("pg_lookups")
        with self._lock:
            cache = getattr(self, "_pg_cache", None)
            if cache is None:
                cache = self._pg_cache = {}
            hit = cache.get(key)
            if hit is not None:
                _pc.inc("cache_hits")
                return hit
            m = self.map
        t0 = time.monotonic()
        val = m.pg_to_up_acting_osds(pool_id, ps)
        dt = time.monotonic() - t0
        _pc.tinc("map_time", dt)
        _pc.hist_add("map_lat", dt)
        with self._lock:
            if self.map is m:
                if len(cache) > 65536:
                    cache.clear()
                cache[key] = val
        return val

    def _install_map(self, payload: Dict) -> None:
        with self._lock:
            if payload["epoch"] <= self.epoch:
                return
            if "map_bin" in payload:
                # the wire form: versioned binary encode
                # (OSDMap::encode role, ~15x smaller than the JSON)
                from ..osdmap.bincode_maps import osdmap_from_bytes

                self.map = osdmap_from_bytes(payload["map_bin"])  # block-ok: pure in-memory bincode decode — the per-type struct-reader table defeats static resolution, but no reader touches a socket, file, or lock
            else:
                self.map = OSDMap.from_dict(payload["map"])
            self.epoch = payload["epoch"]
            self._pg_cache = {}
            self._set_extras(payload)
        self._post_map_install()

    def _apply_one_inc(self, inc: Incremental) -> bool:
        """Copy-apply-swap under the lock; False when not contiguous."""
        with self._lock:
            if self.map is None or inc.epoch != self.epoch + 1:
                return False
            new = OSDMap.from_dict(self.map.to_dict())
            apply_incremental(new, inc)
            self.map = new
            self.epoch = inc.epoch
            self._pg_cache = {}
            return True

    @nonblocking
    def _h_map_inc(self, msg: Dict) -> None:
        inc = Incremental.from_dict(msg["inc"])
        with self._lock:
            if inc.epoch <= self.epoch:
                return None
        if self._apply_one_inc(inc):
            with self._lock:
                self._set_extras(msg)
            self._post_map_install()
            return None
        self._catch_up(inc.epoch, msg)  # block-ok: gap catch-up is deadline-bounded (5s per mon_call, bounded tries) and best-effort — on timeout the monitor's next commit push retries; deferring it would leave the follower on a stale epoch indefinitely
        return None

    def _catch_up(self, target: int, msg: Dict) -> None:
        """Walk missing epochs via get_inc; full fetch on aged-out
        history.  Best-effort: the monitor re-pushes on every commit."""
        try:
            while self.epoch < target and self.map is not None:
                got = self.mon_call(
                    {"type": "get_inc", "epoch": self.epoch + 1},
                    timeout=5)
                inc_d = got.get("inc")
                if inc_d is None or not self._apply_one_inc(
                        Incremental.from_dict(inc_d)):
                    self._install_map(self.mon_call(
                        {"type": "get_map"}, timeout=5))
                    return
            with self._lock:
                self._set_extras(msg)
            self._post_map_install()
        except (TimeoutError, OSError, MonError):
            pass  # the next push catches us up

    def _post_map_install(self) -> None:  # pragma: no cover - hook
        pass
