"""The balancer's offline core: evaluate and the closed upmap loop.

The port of the offline half of ``ceph_tpu/mgr/balancer_module.py``
(the src/pybind/mgr/balancer role, module.py Eval/Plan/do_upmap): an
evaluation of cluster balance is one ``PoolMapper.map_all`` per pool on
``device``, tallied on the host into the deviation stddev that
``calc_pg_upmaps`` drives down, and ``run_offline`` closes the loop
against an offline map.  The mappers are cached across rounds, so a
re-sweep only lowers its upmap tables again (``refresh_tables``).
The mgr daemon around this core (``BalancerModule``: pausing on
degraded health, proposals to the monitor) is not ported yet.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Set, Tuple

from ..crush.wrapper import CrushWrapper
from ..osdmap.balancer import (build_pgs_by_osd, calc_pg_upmaps,
                               distribution_score, target_osd_weights)
from ..osdmap.osdmap import OSDMap

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
