"""MiniCluster — the vstart.sh / qa/standalone harness.

The reference tests "multi-node" behavior with many daemons on one
host (src/vstart.sh, qa/standalone/ceph-helpers.sh run_mon/run_osd/
wait_for_clean).  MiniCluster is that harness: one call boots a
monitor and N OSD services on localhost sockets, builds the CRUSH
hierarchy through the facade, creates pools/EC profiles through mon
commands, and exposes the thrasher hooks (kill_osd / revive_osd /
wait_for_down / wait_for_recovery) that qa/tasks/thrashosds.py
provides in the reference.

The port's copy of ``ceph_tpu/services/cluster.py``: every OSD, client
and mgr it makes runs its EC codes on ``device`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List, Optional

from ..common.backoff import Backoff
from ..common.config import Config
from ..common.context import Context
from ..crush.wrapper import CrushWrapper
from ..osdmap.osdmap import (OSDMap, PgPool, POOL_TYPE_ERASURE,
                             POOL_TYPE_REPLICATED)
from .client import Client
from .monitor import Monitor
from .osd_service import OSDService


class MiniCluster:
    def __init__(self, n_osds: int = 4, hosts: Optional[int] = None,
                 config: Optional[Config] = None, auth: bool = False,
                 data_dir: Optional[str] = None, n_mons: int = 1,
                 device="cuda"):
        self.conf = config or Config()
        # handed to every daemon and client this cluster makes
        self.device = device
        # the out-of-band keyring every daemon/client shares (cephx)
        from ..msg.auth import Keyring
        self.keyring = Keyring.generate() if auth else None
        # when set, OSDs persist their stores under data_dir/osd<N>
        # and restarts remount instead of backfilling from scratch
        self.data_dir = data_dir
        # every daemon's admin socket binds under one per-cluster dir
        # (kept short: AF_UNIX paths cap at ~108 bytes) — the dir the
        # telemetry tool polls for the whole-cluster snapshot
        self.asok_dir = tempfile.mkdtemp(prefix="ceph-torch-asok-")
        self.n_osds = n_osds
        hosts = hosts or n_osds
        # crush hierarchy through the facade (one host per fd bucket)
        self.wrapper = CrushWrapper()
        for d in range(n_osds):
            self.wrapper.insert_item(
                d, 0x10000, f"osd.{d}",
                {"host": f"host{d % hosts}", "root": "default"})
        self.replicated_rule = self.wrapper.add_simple_rule(
            "replicated_rule", "default", "host", "", "firstn")
        self.ec_rule = self.wrapper.add_simple_rule(
            "ec_rule", "default", "host", "", "indep", rule_type=3)

        osdmap = OSDMap(self.wrapper.crush)
        self.n_mons = n_mons
        self.mons: Dict[int, Monitor] = {}
        self._mon_osdmap = osdmap
        for rank in range(n_mons):
            self.mons[rank] = self._make_mon(rank)
        self.mon_addrs = [self.mons[r].addr for r in range(n_mons)]
        if n_mons > 1:
            for rank, mon in self.mons.items():
                mon.set_peers(rank, self.mon_addrs)
        self.osds: Dict[int, OSDService] = {}
        self.clients: List[Client] = []
        self.mgr = None

    @property
    def mon(self) -> Monitor:
        """Historical single-mon handle: the lowest-ranked LIVE monitor
        (a plain attribute would go stale after kill_mon/revive_mon)."""
        return self.mons[min(self.mons)]

    def _make_mon(self, rank: int, port: int = 0) -> Monitor:
        mon_store = None
        if self.data_dir is not None:
            import os

            mon_store = os.path.join(self.data_dir, f"mon{rank}")
        ctx = Context(f"mon.{rank}", config=self.conf,
                      admin_dir=self.asok_dir)
        return Monitor(ctx, OSDMap.from_dict(
            self._mon_osdmap.to_dict()), keyring=self.keyring,
            store_dir=mon_store, port=port)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "MiniCluster":
        for mon in self.mons.values():
            mon.start()
        if self.n_mons > 1:
            self.wait_for_quorum()
        for d in range(self.n_osds):
            self.revive_osd(d)
        return self

    def shutdown(self) -> None:
        for c in self.clients:
            c.shutdown()
        if self.mgr is not None:
            self.mgr.shutdown()
            self.mgr = None
        for svc in list(self.osds.values()):
            svc.shutdown()
        for mon in self.mons.values():
            mon.shutdown()
        shutil.rmtree(self.asok_dir, ignore_errors=True)

    def start_mgr(self, name: str = "x"):
        """Start the manager daemon (one per cluster, the ceph-mgr
        role); its admin socket binds beside the others, so
        ``ceph_cli balancer ...`` finds it via --asok-dir."""
        from ..mgr.daemon import MgrDaemon

        ctx = Context(f"mgr.{name}", config=self.conf,
                      admin_dir=self.asok_dir)
        self.mgr = MgrDaemon(ctx, name, self.mon_addrs,
                             keyring=self.keyring,
                             device=self.device).start()
        return self.mgr

    def client(self, name: str = "admin") -> Client:
        ctx = Context(f"client.{name}", config=self.conf,
                      admin_dir=self.asok_dir)
        c = Client(name, self.mon_addrs, keyring=self.keyring,
                   ctx=ctx, device=self.device)
        self.clients.append(c)
        return c

    # -- monitor quorum hooks -------------------------------------------
    def leader(self) -> Optional[Monitor]:
        for mon in self.mons.values():
            if mon.quorum is None or mon.quorum.is_leader():
                return mon
        return None

    def wait_for_quorum(self, timeout: float = 30.0) -> Monitor:
        """Wait for the STEADY-STATE leader: the lowest live rank, with
        genesis committed.  (A higher rank can win a first round and
        lead transiently until the lowest reachable rank's candidacy
        deposes it — returning that one makes callers racy.)"""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            ldr = self.leader()
            if ldr is not None and ldr.last_committed() > 0 and \
                    (ldr.quorum is None or
                     ldr is self.mons[min(self.mons)]):
                return ldr
            time.sleep(0.1)
        raise TimeoutError("no monitor quorum")

    def kill_mon(self, rank: int) -> None:
        mon = self.mons.pop(rank, None)
        if mon is not None:
            mon.shutdown()

    def revive_mon(self, rank: int) -> Monitor:
        # rebind the original rank port so peers and daemons reach it
        # at the address already in their quorum lists (brief retry:
        # the killed listener's socket may still be closing)
        bo = Backoff(base=0.1, cap=0.5, deadline=5.0)
        while True:
            try:
                mon = self._make_mon(rank,
                                     port=self.mon_addrs[rank][1])
                break
            except OSError:
                if not bo.sleep():
                    raise
        if self.n_mons > 1:
            mon.set_peers(rank, self.mon_addrs)
        mon.start()
        self.mons[rank] = mon
        return mon

    def set_faults(self, spec: str) -> None:
        """Arm (or disarm, spec="") failpoints cluster-wide: every
        daemon Context shares self.conf, whose ``fault_inject_spec``
        observer feeds analysis/faults.py live."""
        self.conf.set("fault_inject_spec", spec)

    def mon_command(self, msg: Dict, timeout: float = 10.0) -> Dict:
        """Send a command to the quorum via the shared failover loop."""
        from .map_follower import failover_call

        mons = list(self.mons.values())
        rep, _ = failover_call(mons[0].msgr, [m.addr for m in mons],
                               msg, timeout=timeout)
        return rep

    def _mon_commit(self, msg: Dict, timeout: float = 60.0) -> Dict:
        """Send a map-changing command and return its reply.  A reply
        of "lost quorum" (the leader rolled the entry back and
        abdicated) is sent again once a leader is back, as a client
        re-sends a command after an election: a profile whose commit
        aborted must not leave a pool that names it."""
        deadline = time.monotonic() + timeout
        while True:
            rep = self.mon_command(msg)
            err = rep.get("error") if isinstance(rep, dict) else None
            if "lost quorum" not in str(err or "") or \
                    time.monotonic() > deadline:
                return rep
            self.wait_for_quorum(
                timeout=max(0.1, deadline - time.monotonic()))

    # -- pool / profile management (mon command surface) ---------------
    def create_replicated_pool(self, pool_id: int, pg_num: int = 8,
                               size: int = 3) -> None:
        self._mon_commit({
            "type": "pool_create", "pool_id": pool_id,
            "pool": {"pool_type": POOL_TYPE_REPLICATED, "size": size,
                     "min_size": max(1, size - 1), "pg_num": pg_num,
                     "crush_rule": self.replicated_rule}})

    def create_ec_pool(self, pool_id: int, profile_name: str,
                       profile: Dict[str, str],
                       pg_num: int = 8) -> None:
        self._mon_commit({
            "type": "ec_profile_set", "name": profile_name,
            "profile": profile})
        from ..ec.registry import profile_factory

        # only k and n are read here: a CPU code gives them without
        # touching the card
        code = profile_factory(dict(profile), device="cpu")
        self._mon_commit({
            "type": "pool_create", "pool_id": pool_id,
            "pool": {"pool_type": POOL_TYPE_ERASURE,
                     "size": code.get_chunk_count(),
                     "min_size": code.get_data_chunk_count(),
                     "pg_num": pg_num, "crush_rule": self.ec_rule,
                     "erasure_code_profile": profile_name}})

    def delete_pool(self, pool_id: int) -> None:
        self._mon_commit({"type": "pool_delete", "pool_id": pool_id})

    def reweight_osd(self, osd: int, weight: float) -> None:
        """`ceph osd reweight` (0.0-1.0)."""
        self._mon_commit({"type": "reweight", "osd": osd,
                          "weight": int(weight * 0x10000)})

    def scrub(self, pool_id: int) -> Dict[int, list]:
        """Deep-scrub every PG of a pool on every up OSD; returns
        {osd: [inconsistent shard names]} (non-empty = damage)."""
        payload = self.mon_command({"type": "get_map"})
        from ..osdmap.bincode_maps import payload_map

        m = payload_map(payload)
        pool = m.pools[pool_id]
        bad: Dict[int, list] = {}
        for ps in range(pool.pg_num):
            up, _p, _a, _ap = m.pg_to_up_acting_osds(pool_id, ps)
            for osd in up:
                svc = self.osds.get(osd)
                if svc is None:
                    continue
                got = svc.msgr.call(svc.addr,
                                    {"type": "pg_scrub",
                                     "pool": pool_id, "ps": ps})
                for name in got.get("inconsistent", []):
                    bad.setdefault(osd, []).append(
                        (pool_id, ps, name))
        return bad

    def repair(self, osd: int, pool_id: int, ps: int,
               shard_name: str) -> None:
        """Drop the damaged shard on ``osd``; recovery re-decodes it
        from the survivors."""
        oid, _, shard = shard_name.rpartition(".s")
        svc = self.osds[osd]
        svc.msgr.call(svc.addr, {"type": "shard_remove",
                                 "pool": pool_id, "ps": ps,
                                 "oid": oid, "shard": int(shard)})

    # -- thrasher hooks (qa/tasks/thrashosds.py role) -------------------
    def kill_osd(self, osd: int) -> None:
        svc = self.osds.pop(osd, None)
        if svc is not None:
            svc.shutdown()

    def revive_osd(self, osd: int) -> OSDService:
        ctx = Context(f"osd.{osd}", config=self.conf,
                      admin_dir=self.asok_dir)
        data_dir = None
        if self.data_dir is not None:
            import os

            data_dir = os.path.join(self.data_dir, f"osd{osd}")
        svc = OSDService(ctx, osd, self.mon_addrs,
                         keyring=self.keyring, data_dir=data_dir,
                         device=self.device)
        svc.start()
        self.osds[osd] = svc
        return svc

    def status(self) -> Dict:
        return self.mon_command({"type": "status"})

    def health(self) -> Dict:
        """`ceph health` surface: HEALTH_OK/HEALTH_WARN + checks."""
        return self.mon_command({"type": "health"})

    def pool_stats(self, pool_id: Optional[int] = None) -> Dict:
        """Per-pool io/recovery rate series (the PGMap `pool-stats`
        surface)."""
        msg: Dict = {"type": "pool_stats"}
        if pool_id is not None:
            msg["pool"] = pool_id
        return self.mon_command(msg)

    def progress(self) -> Dict:
        """Open + completed recovery events (mgr progress role)."""
        return self.mon_command({"type": "progress"})

    def wait_for_health_ok(self, timeout: float = 30.0) -> Dict:
        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            last = self.health()
            if last.get("status") == "HEALTH_OK":
                return last
            time.sleep(0.3)
        raise TimeoutError(f"health never OK: {last}")

    def wait_for_down(self, osd: int, timeout: float = 15.0) -> None:
        self._wait(lambda: osd not in self.status()["up_osds"],
                   timeout, f"osd.{osd} still up")

    def wait_for_up(self, osd: int, timeout: float = 15.0) -> None:
        self._wait(lambda: osd in self.status()["up_osds"],
                   timeout, f"osd.{osd} still down")

    def wait_for_recovery(self, pool_id: int, objects: Dict[str, int],
                          timeout: float = 30.0) -> None:
        """wait_for_clean: every up-set shard of every object present
        on the OSD that should hold it."""
        def clean() -> bool:
            payload = self.mon_command({"type": "get_map"})
            from ..osdmap.bincode_maps import payload_map

            m = payload_map(payload)
            pool = m.pools[pool_id]
            from .client import object_to_ps
            for oid in objects:
                ps = object_to_ps(oid) % pool.pg_num
                up, _p, _a, _ap = m.pg_to_up_acting_osds(pool_id, ps)
                for pos, osd in enumerate(up):
                    svc = self.osds.get(osd)
                    if svc is None:
                        return False
                    shard = pos if pool.pool_type == \
                        POOL_TYPE_ERASURE else 0
                    cid = f"{pool_id}.{ps}"
                    if svc.store.stat(cid, f"{oid}.s{shard}") is None:
                        return False
            return True

        self._wait(clean, timeout, "recovery incomplete")

    @staticmethod
    def _wait(cond, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return
            time.sleep(0.2)
        raise TimeoutError(what)
