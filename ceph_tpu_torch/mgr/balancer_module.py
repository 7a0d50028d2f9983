"""The balancer's offline core: evaluate and the closed upmap loop.

The port of the offline half of ``ceph_tpu/mgr/balancer_module.py``
(the src/pybind/mgr/balancer role, module.py Eval/Plan/do_upmap): an
evaluation of cluster balance is one ``PoolMapper.map_all`` per pool on
``device``, tallied on the host into the deviation stddev that
``calc_pg_upmaps`` drives down, and ``run_offline`` closes the loop
against an offline map.  The mappers are cached across rounds, so a
re-sweep only lowers its upmap tables again (``refresh_tables``).
``BalancerModule`` is the mgr daemon's module around this core: it
pauses while the monitor reports the cluster degraded, sweeps a private
copy of the daemon's map on the daemon's device, and proposes each
changed ``pg_upmap_items`` entry to the monitor.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from ..analysis import faults
from ..analysis.lockdep import make_lock
from ..crush.wrapper import CrushWrapper
from ..osdmap.balancer import (build_pgs_by_osd, calc_pg_upmaps,
                               distribution_score, target_osd_weights)
from ..osdmap.osdmap import OSDMap
from .daemon import MgrModule

PgId = Tuple[int, int]


def evaluate(m: OSDMap, wrapper: Optional[CrushWrapper] = None,
             only_pools: Optional[Set[int]] = None,
             use_batched: bool = True,
             mappers: Optional[Dict] = None, device="cuda") -> Dict:
    """One balance sweep (the balancer Eval, module.py:calc_eval):
    every selected pool mapped (one ``map_all`` each when batched),
    then host-side deviation bookkeeping.  Returns stddev (true
    root-mean-square deviation), max deviation, the [0,1) distribution
    score, and a per-pool breakdown from the same sweep."""
    if wrapper is None:
        wrapper = CrushWrapper(m.crush)
    pools = sorted(p for p in m.pools
                   if not only_pools or p in only_pools)
    pgs_by_osd = build_pgs_by_osd(
        m, set(pools) if only_pools else None, use_batched,
        mappers=mappers, device=device)
    osd_weight, weight_total, total_pgs = target_osd_weights(
        m, wrapper, set(pools) if only_pools else None)
    out = {"pools": {}, "sweep_launches": len(pools),
           "mapped_pgs": sum(m.pools[p].pg_num for p in pools),
           "osd_count": len(osd_weight), "stddev": 0.0,
           "sum_sq": 0.0, "max_dev": 0.0, "score": 0.0}
    if not weight_total or not total_pgs or not osd_weight:
        return out
    pgs_per_weight = total_pgs / weight_total
    sum_sq = 0.0
    max_dev = 0.0
    for osd, w in osd_weight.items():
        target = w * pgs_per_weight
        d = len(pgs_by_osd.get(osd, ())) - target
        sum_sq += d * d
        max_dev = max(max_dev, abs(d))
    out["sum_sq"] = sum_sq
    out["stddev"] = math.sqrt(sum_sq / len(osd_weight))
    out["max_dev"] = max_dev
    out["score"] = distribution_score(m, osd_weight, only_pools,
                                      pgs_by_osd)
    # per-pool breakdown from the same sweep: each pool's tallies are
    # the pgids of that pool per osd
    for pid in pools:
        pool = m.pools[pid]
        pw, pw_total, p_pgs = target_osd_weights(m, wrapper, {pid})
        row = {"pg_num": pool.pg_num, "size": pool.size,
               "stddev": 0.0, "max_dev": 0.0, "score": 0.0}
        if pw and pw_total and p_pgs:
            ppw = p_pgs / pw_total
            psq = 0.0
            pmax = 0.0
            ptally = {o: len([g for g in pgs_by_osd.get(o, ())
                              if g[0] == pid]) for o in pw}
            for osd, w in pw.items():
                d = ptally[osd] - w * ppw
                psq += d * d
                pmax = max(pmax, abs(d))
            row["stddev"] = math.sqrt(psq / len(pw))
            row["max_dev"] = pmax
            row["score"] = distribution_score(
                m, pw, {pid},
                {o: {g for g in pgs_by_osd.get(o, ()) if g[0] == pid}
                 for o in pw})
        out["pools"][pid] = row
    return out


def run_offline(m: OSDMap, wrapper: Optional[CrushWrapper] = None,
                max_deviation: int = 1, max_iterations: int = 10,
                max_rounds: int = 20, seed: int = 0,
                use_batched: bool = True,
                only_pools: Optional[Set[int]] = None,
                patience: int = 2, device="cuda") -> Dict:
    """Drive the closed loop to convergence against an offline map.
    One round = one optimize pass + one verification sweep.  A round
    that fails to improve the stddev is rolled back (the map keeps its
    best state, so the recorded trajectory is monotone) and retried
    with the next round's seed, up to ``patience`` consecutive rejected
    rounds; only then is the run ``converged``.  Returns the BALANCE
    record body (``sweep_s`` and ``sweep_mappings_per_sec`` are host
    clock times; the rest is the same on every device)."""
    if wrapper is None:
        wrapper = CrushWrapper(m.crush)
    mappers: Dict = {}
    sweep_s = 0.0
    sweep_mappings = 0
    launches = 0

    def sweep() -> Dict:
        nonlocal sweep_s, sweep_mappings, launches
        t0 = time.perf_counter()
        ev = evaluate(m, wrapper, only_pools, use_batched,
                      mappers=mappers, device=device)
        sweep_s += time.perf_counter() - t0
        sweep_mappings += ev["mapped_pgs"]
        launches += ev["sweep_launches"]
        return ev

    ev = sweep()
    trajectory: List[float] = [ev["stddev"]]
    rounds = 0
    upmaps = 0
    rejected = 0
    dry = 0
    converged = ev["max_dev"] <= max_deviation
    while rounds < max_rounds and not converged:
        before = {k: [tuple(p) for p in v]
                  for k, v in m.pg_upmap_items.items()}
        changed = calc_pg_upmaps(
            m, max_deviation=max_deviation,
            max_iterations=max_iterations, only_pools=only_pools,
            wrapper=wrapper, use_batched=use_batched,
            seed=seed + rounds, mappers=mappers, device=device)
        # the optimizer's own full-cluster remap is a sweep too (same
        # launches, untimed here)
        launches += ev["sweep_launches"]
        rounds += 1
        prev = trajectory[-1]
        if changed == 0:
            converged = True
            continue
        round_ev = sweep()
        if round_ev["stddev"] >= prev - 1e-9:
            # no improvement: keep the best state, retry with the
            # next seed until patience runs out
            m.pg_upmap_items.clear()
            m.pg_upmap_items.update(before)
            rejected += 1
            dry += 1
            if dry >= patience:
                converged = True
            continue
        ev = round_ev
        dry = 0
        upmaps += changed
        trajectory.append(ev["stddev"])
        if ev["max_dev"] <= max_deviation:
            converged = True
    return {
        "kind": "balance",
        "seed": seed,
        "n_osds": ev["osd_count"],
        "pools": len(m.pools if not only_pools else only_pools),
        "max_deviation": max_deviation,
        "rounds": rounds,
        "rejected_rounds": rejected,
        "upmaps": upmaps,
        "initial_stddev": round(trajectory[0], 4),
        "final_stddev": round(trajectory[-1], 4),
        "stddev_trajectory": [round(s, 4) for s in trajectory],
        "final_score": round(ev["score"], 6),
        "final_max_dev": round(ev["max_dev"], 3),
        "converged": bool(converged),
        "sweep_launches": launches,
        "sweep_s": round(sweep_s, 4),
        "sweep_mappings_per_sec": round(
            sweep_mappings / sweep_s, 1) if sweep_s else 0.0,
    }


def diff_upmap_items(old: Dict[PgId, List], new: Dict[PgId, List]
                     ) -> List[Tuple[PgId, List]]:
    """(pgid, items) pairs to propose; [] items = remove the entry."""
    out: List[Tuple[PgId, List]] = []
    for pgid, items in sorted(new.items()):
        if [tuple(p) for p in old.get(pgid, [])] != \
                [tuple(p) for p in items]:
            out.append((pgid, [list(p) for p in items]))
    for pgid in sorted(old):
        if pgid not in new:
            out.append((pgid, []))
    return out


class BalancerModule(MgrModule):
    """The closed loop as a mgr module (`ceph balancer on` role)."""

    NAME = "balancer"

    def __init__(self, mgr):
        super().__init__(mgr)
        self.active = False
        self.paused = False
        self.last_eval: Optional[Dict] = None
        self.last_round: Optional[Dict] = None
        self.rounds = 0
        self.stale_discards = 0
        # every proposal batch with the health status it was decided
        # under — the thrasher's no-proposals-while-degraded gate
        # audits this log
        self.proposal_log: deque = deque(maxlen=128)
        self.degraded_proposals = 0
        # one round at a time: the tick thread and an admin-socket
        # `balancer execute` must not interleave their sweeps
        self._round_lock = make_lock("mgr::balancer_round")

    @property
    def interval(self) -> float:
        return float(self.mgr.ctx.conf["balancer_interval"])

    # -- health / status ----------------------------------------------
    def health_checks(self) -> Dict[str, str]:
        if self.active and self.paused:
            return {"BALANCER_PAUSED":
                    "balancer paused while cluster is degraded"}
        return {}

    def status(self) -> Dict:
        return {"active": self.active,
                "paused": self.paused,
                "rounds": self.rounds,
                "stale_discards": self.stale_discards,
                "proposals": len(self.proposal_log),
                "degraded_proposals": self.degraded_proposals,
                "last_eval": self.last_eval,
                "last_round": self.last_round}

    # -- admin-socket command surface ---------------------------------
    def command(self, args: Dict) -> Dict:
        argv = [str(a) for a in (args.get("argv") or [])]
        verb = argv[0] if argv else "status"
        if verb == "status":
            return self.status()
        if verb == "on":
            self.active = True
            self.mgr._wake.set()
            return {"success": "balancer on"}
        if verb == "off":
            self.active = False
            return {"success": "balancer off"}
        if verb == "eval":
            snap = self._snapshot()
            if snap is None:
                return {"error": "no map yet"}
            m, w, _epoch = snap
            ev = evaluate(m, w, device=self.mgr.device)
            self.pc.inc("balancer_sweep_launches",
                        ev["sweep_launches"])
            self.last_eval = ev
            return ev
        if verb == "execute":
            rec = self._run_round(force=True)
            return rec if rec is not None else {"error": "no map yet"}
        return {"error": f"unknown balancer verb {verb!r}; have "
                         "status|on|off|eval|execute"}

    # -- the loop ------------------------------------------------------
    def tick(self) -> None:
        if not self.active:
            return
        self._run_round(force=False)

    def _snapshot(self):
        """Private (map copy, wrapper, epoch) — calc mutates its map."""
        with self.mgr._lock:
            if self.mgr.map is None:
                return None
            d = self.mgr.map.to_dict()
            epoch = self.mgr.epoch
        m = OSDMap.from_dict(d)
        return m, CrushWrapper(m.crush), epoch

    def _degraded(self, health: Dict) -> bool:
        codes = set(health.get("check_codes") or [])
        return bool(codes & {"PG_DEGRADED", "OSD_DOWN"})

    def _run_round(self, force: bool) -> Optional[Dict]:
        with self._round_lock:
            return self._run_round_locked(force)

    def _run_round_locked(self, force: bool) -> Optional[Dict]:
        conf = self.mgr.ctx.conf
        try:
            health = self.mgr.mon_call({"type": "health"},
                                       timeout=3.0)
        except Exception as e:  # next tick re-probes
            self.log.dout(5, f"balancer: health unavailable {e!r}")
            return None
        if self._degraded(health) and not force:
            # recovery in flight — balancing now would fight it for
            # the same PGs (the reference's no-optimize gate,
            # balancer module.py:Mode busy checks)
            self.paused = True
            self.pc.inc("balancer_paused")
            self.log.dout(4, "balancer: paused (cluster degraded)")
            return None
        self.paused = False

        snap = self._snapshot()
        if snap is None:
            return None
        m, wrapper, epoch = snap
        old_items = {pg: list(v) for pg, v in m.pg_upmap_items.items()}

        ev = evaluate(m, wrapper, device=self.mgr.device)
        self.pc.inc("balancer_sweep_launches", ev["sweep_launches"])
        self.pc.set("balancer_stddev", ev["stddev"])
        self.pc.set("balancer_score", ev["score"])
        self.last_eval = ev
        self.rounds += 1
        self.pc.inc("balancer_rounds")

        # a sweep that raced a newer epoch (or the armed failpoint)
        # evaluated a stale map: discard the round, never propose
        # from it
        stale = self.mgr.epoch != epoch
        if faults._ACTIVE and faults.fires("mgr.balancer.stale_map",
                                           self.mgr.name):
            stale = True
        if stale:
            self.stale_discards += 1
            self.log.dout(2, f"balancer: stale sweep (epoch {epoch} "
                             f"vs {self.mgr.epoch}); discarding")
            return None

        rec: Dict = {"epoch": epoch,
                     "stddev_before": round(ev["stddev"], 4),
                     "health": health.get("status")}
        if ev["max_dev"] <= int(conf["balancer_max_deviation"]):
            rec.update(balanced=True, proposed=0)
            self.last_round = rec
            return rec

        changed = calc_pg_upmaps(
            m, max_deviation=int(conf["balancer_max_deviation"]),
            max_iterations=int(conf["balancer_max_iterations"]),
            wrapper=wrapper, use_batched=True, seed=self.rounds,
            device=self.mgr.device)
        rec["balanced"] = False
        if not changed:
            rec["proposed"] = 0
            self.last_round = rec
            return rec

        proposals = diff_upmap_items(old_items, m.pg_upmap_items)
        sent = 0
        commit_epoch = epoch
        for pgid, items in proposals:
            try:
                rep = self.mgr.mon_call(
                    {"type": "pg_upmap_items_set",
                     "pool": pgid[0], "ps": pgid[1], "items": items})
            except Exception as e:  # rest retried next round
                self.log.dout(2, f"balancer: propose {pgid} failed "
                                 f"{e!r}")
                break
            if "error" in rep:
                self.log.dout(2, f"balancer: mon rejected {pgid}: "
                                 f"{rep['error']}")
                continue
            sent += 1
            commit_epoch = max(commit_epoch, int(rep.get("epoch", 0)))
        self.pc.inc("balancer_upmaps_proposed", sent)
        if self._degraded(health):
            self.degraded_proposals += 1  # force=True path only
        self.proposal_log.append(
            {"epoch": epoch, "proposed": sent,
             "health": health.get("status"),
             "degraded": self._degraded(health)})
        rec["proposed"] = sent

        # verify: wait for our own subscription to observe the
        # committed epoch, then one more batched sweep — the stddev
        # must actually have dropped
        from ..common.backoff import Backoff

        bo = Backoff(base=0.05, cap=0.3, deadline=5.0)
        while self.mgr.epoch < commit_epoch:
            if not bo.sleep():
                break
        snap = self._snapshot()
        if snap is not None:
            m2, w2, _e2 = snap
            ev2 = evaluate(m2, w2, device=self.mgr.device)
            self.pc.inc("balancer_sweep_launches",
                        ev2["sweep_launches"])
            self.pc.set("balancer_stddev", ev2["stddev"])
            self.pc.set("balancer_score", ev2["score"])
            rec["stddev_after"] = round(ev2["stddev"], 4)
            rec["improved"] = ev2["stddev"] < ev["stddev"]
            if not rec["improved"]:
                self.log.dout(2, f"balancer: round did not improve "
                                 f"({ev['stddev']:.3f} -> "
                                 f"{ev2['stddev']:.3f})")
        self.last_round = rec
        return rec
