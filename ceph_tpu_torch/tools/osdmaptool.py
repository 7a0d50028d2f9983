"""osdmaptool: create, inspect and balance cluster maps.

The port of ``ceph_tpu/tools/osdmaptool.py`` (the role of
src/tools/osdmaptool.cc:103-846), with its verbs, files and output:

  --createsimple N [--pg-bits B]   build an N-osd map + pool 1
  --test-map-pgs [--pool P]        map every PG, per-osd stats
  --test-map-pgs-dump              every PG's up and acting sets
  --upmap FILE [--upmap-deviation D] [--upmap-max N] [--upmap-pool P]
                                   run the balancer, write the commands
  --upmap-cleanup                  drop invalid pg_upmap_items
  --export-crush F                 write the crush map (CrushWrapper dict)
  --import-crush F                 replace the crush map (JSON or text)
  --mark-up-in                     all osds up+in

Map files are ``OSDMap.to_dict()`` JSON, the same files ``ceph_tpu``'s
tool reads and writes.  The sweeps (``--test-map-pgs``,
``--test-map-pgs-dump``, ``--upmap``) run one ``PoolMapper.map_all``
per pool on ``--device`` (default ``cuda``; without a card the tool
fails unless ``--device cpu`` is given).  ``--scalar`` asks for the
scalar pipeline on the CPU instead, and never for a card.

Usage: python -m ceph_tpu_torch.tools.osdmaptool <mapfile> ...
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..crush.wrapper import CrushWrapper
from ..osdmap.balancer import build_pgs_by_osd, calc_pg_upmaps
from ..osdmap.osdmap import OSDMap, PgPool
from ..osdmap.pipeline import PoolMapper
from .crushtool import load_map


def create_simple(num_osd: int, pg_bits: int = 6) -> OSDMap:
    """--createsimple (osdmaptool.cc / OSDMap::build_simple): one host
    per osd under one root, one replicated pool."""
    w = CrushWrapper()
    for d in range(num_osd):
        w.insert_item(d, 0x10000, f"osd.{d}",
                      {"host": f"host{d}", "root": "default"})
    rid = w.add_simple_rule("replicated_rule", "default", "host", "",
                            "firstn")
    m = OSDMap(w.crush)
    for d in range(num_osd):
        m.add_osd(d)
    m.pools[1] = PgPool(size=3, pg_num=num_osd << pg_bits,
                        crush_rule=rid)
    return m


def test_map_pgs(m: OSDMap, pool: int | None = None,
                 use_batched: bool = True, out=sys.stdout,
                 device="cuda") -> None:
    """--test-map-pgs (osdmaptool.cc:41-43): per-osd pg counts."""
    only = {pool} if pool is not None else None
    pgs_by_osd = build_pgs_by_osd(m, only, use_batched=use_batched,
                                  device=device)
    counts = np.zeros(m.max_osd, np.int64)
    for osd, pgs in pgs_by_osd.items():
        if 0 <= osd < m.max_osd:
            counts[osd] = len(pgs)
    for osd in range(m.max_osd):
        out.write(f"osd.{osd}\t{counts[osd]}\n")
    total = int(counts.sum())
    in_osds = max(1, sum(1 for w in m.osd_weight if w > 0))
    avg = total / in_osds
    if avg > 0:
        dev = counts[np.asarray(m.osd_weight) > 0] - avg
        stddev = float(np.sqrt((dev ** 2).mean()))
        out.write(f" avg {avg:.4g} stddev {stddev:.4g} "
                  f"({stddev / avg:.4g}x)\n")
    out.write(f" in {in_osds}\n")
    out.write(f" min osd.{int(counts.argmin())} {int(counts.min())}\n")
    out.write(f" max osd.{int(counts.argmax())} {int(counts.max())}\n")
    out.write(f"size {total}\n")


def test_map_pgs_dump(m: OSDMap, pool: int | None = None,
                      use_batched: bool = True, out=None,
                      device="cuda") -> None:
    """--test-map-pgs-dump (osdmaptool.cc:42): every PG's up set, up
    primary, acting set and acting primary; one ``map_all`` per pool
    on ``device``, or with ``use_batched=False`` the scalar
    ``pg_to_up_acting_osds`` on the host."""
    out = sys.stdout if out is None else out
    for pool_id, p in sorted(m.pools.items()):
        if pool is not None and pool_id != pool:
            continue
        if use_batched:
            got = {k: v.cpu().tolist() for k, v in
                   PoolMapper(m, pool_id, device=device).map_all().items()}
            rows = zip(got["up"], got["up_len"], got["up_primary"],
                       got["acting"], got["acting_len"],
                       got["acting_primary"])
            rows = ((up[:ulen], up_p, act[:alen], act_p)
                    for up, ulen, up_p, act, alen, act_p in rows)
        else:
            rows = (m.pg_to_up_acting_osds(pool_id, ps)
                    for ps in range(p.pg_num))
        for ps, (up, up_p, acting, act_p) in enumerate(rows):
            out.write(f"{pool_id}.{ps:x}\t{list(up)}\t{up_p}\t"
                      f"{list(acting)}\t{act_p}\n")


def upmap_cleanup(m: OSDMap) -> int:
    """--upmap-cleanup: drop pg_upmap_items that reference missing
    pools/osds or no longer apply (OSDMap::clean_pg_upmaps role)."""
    removed = 0
    for pgid in list(m.pg_upmap_items):
        pool_id, ps = pgid
        pool = m.pools.get(pool_id)
        bad = pool is None or ps >= pool.pg_num
        if not bad:
            items = [(f, t) for f, t in m.pg_upmap_items[pgid]
                     if m.exists(f) and m.exists(t)]
            if items != m.pg_upmap_items[pgid]:
                bad = not items
                if items:
                    m.pg_upmap_items[pgid] = items
        if bad:
            del m.pg_upmap_items[pgid]
            removed += 1
    return removed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="osdmaptool")
    p.add_argument("mapfn", help="osdmap JSON file")
    p.add_argument("--createsimple", type=int, default=0)
    p.add_argument("--pg-bits", type=int, default=6)
    p.add_argument("--clobber", action="store_true")
    p.add_argument("--test-map-pgs", action="store_true")
    p.add_argument("--test-map-pgs-dump", action="store_true",
                   help="print every pg's up set + primary "
                        "(osdmaptool.cc:42)")
    p.add_argument("--pool", type=int, default=None)
    p.add_argument("--scalar", action="store_true",
                   help="scalar pipeline instead of batched")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where the sweeps run")
    p.add_argument("--upmap", help="output file for balancer commands")
    p.add_argument("--upmap-deviation", type=int, default=5)
    p.add_argument("--upmap-max", type=int, default=10)
    p.add_argument("--upmap-pool", type=int, action="append",
                   default=[])
    p.add_argument("--upmap-cleanup", action="store_true")
    p.add_argument("--export-crush")
    p.add_argument("--import-crush")
    p.add_argument("--mark-up-in", action="store_true")
    args = p.parse_args(argv)

    if args.createsimple:
        m = create_simple(args.createsimple, args.pg_bits)
        with open(args.mapfn, "w") as f:
            json.dump(m.to_dict(), f)
        print(f"osdmaptool: writing epoch {m.epoch} to {args.mapfn}")
        return 0

    with open(args.mapfn) as f:
        m = OSDMap.from_dict(json.load(f))
    dirty = False

    if args.mark_up_in:
        for d in range(m.max_osd):
            m.add_osd(d)
        dirty = True

    if args.import_crush:
        m.crush = load_map(args.import_crush).crush
        dirty = True

    if args.export_crush:
        with open(args.export_crush, "w") as f:
            json.dump(CrushWrapper(m.crush).to_dict(), f)

    if args.upmap_cleanup:
        removed = upmap_cleanup(m)
        print(f"upmap-cleanup: removed {removed} entries")
        dirty = dirty or removed > 0

    if args.upmap:
        only = set(args.upmap_pool) or None
        before = dict(m.pg_upmap_items)
        changed = calc_pg_upmaps(
            m, max_deviation=args.upmap_deviation,
            max_iterations=args.upmap_max, only_pools=only,
            use_batched=not args.scalar, device=args.device)
        with open(args.upmap, "w") as f:
            for pgid in sorted(set(before) | set(m.pg_upmap_items)):
                now = m.pg_upmap_items.get(pgid)
                if now == before.get(pgid):
                    continue
                tag = f"{pgid[0]}.{pgid[1]:x}"
                if now is None:
                    f.write(f"ceph osd rm-pg-upmap-items {tag}\n")
                else:
                    pairs = " ".join(f"{a} {b}" for a, b in now)
                    f.write(f"ceph osd pg-upmap-items {tag} {pairs}\n")
        print(f"upmap: {changed} changes")
        dirty = dirty or changed > 0

    if args.test_map_pgs_dump:
        test_map_pgs_dump(m, args.pool, use_batched=not args.scalar,
                          device=args.device)

    if args.test_map_pgs:
        test_map_pgs(m, args.pool, use_batched=not args.scalar,
                     device=args.device)

    # as the reference: the map file is rewritten only with --clobber
    # after an upmap, cleanup or mark-up-in
    if dirty and args.clobber:
        with open(args.mapfn, "w") as f:
            json.dump(m.to_dict(), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
