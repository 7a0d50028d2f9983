"""objectstore-tool — offline store surgery.

The port's copy of ``ceph_tpu/tools/objectstore_tool.py``; its output
on a directory equals ``ceph_tpu``'s.  The ceph-objectstore-tool role
(src/tools/ceph_objectstore_tool.cc): work on a store's data directory
while its daemon is down — list collections and objects, dump an object
(data, attrs, omap), export a PG's objects to a portable file, import
them into another store, remove objects.  Works on a WALStore directory.

CLI:
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR \
        [--op list|dump|export|import|remove]
        [--pgid POOL.PS] [--oid NAME] [--file F]
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
from typing import Dict


def _mount(path: str):
    from ..os.wal_store import WALStore

    st = WALStore(path)
    st.mount()
    return st


def op_list(store, pgid=None) -> Dict:
    out: Dict[str, list] = {}
    for cid in store.list_collections():
        if pgid and cid != pgid:
            continue
        out[cid] = sorted(o for o in store.list_objects(cid))
    return out


def op_dump(store, pgid: str, oid: str) -> Dict:
    data = store.read(pgid, oid)
    st = store.stat(pgid, oid)
    attrs = {}
    for key in ("size", "crc", "v"):
        got = store.getattr(pgid, oid, key)
        if got is not None:
            attrs[key] = got.decode()
    return {"pgid": pgid, "oid": oid, "len": len(data),
            "stat": st, "attrs": attrs,
            "omap_keys": sorted(store.omap_get(pgid, oid)),
            "data_b64": base64.b64encode(data).decode()}


def op_export(store, pgid: str) -> Dict:
    """Portable PG export: every object with data/attrs/omap."""
    objs = []
    for oid in sorted(store.list_objects(pgid)):
        rec = {"oid": oid,
               "data": base64.b64encode(
                   store.read(pgid, oid)).decode(),
               "attrs": {}, "omap": {}}
        for key in ("size", "crc", "v"):
            got = store.getattr(pgid, oid, key)
            if got is not None:
                rec["attrs"][key] = got.decode()
        for k, v in store.omap_get(pgid, oid).items():
            rec["omap"][k] = base64.b64encode(v).decode()
        objs.append(rec)
    return {"format": "ceph_tpu-pg-export-1", "pgid": pgid,
            "objects": objs}


def op_import(store, blob: Dict) -> int:
    from ..os.objectstore import Transaction

    if blob.get("format") != "ceph_tpu-pg-export-1":
        raise SystemExit("unrecognized export format")
    pgid = blob["pgid"]
    txn = Transaction()
    if not store.collection_exists(pgid):
        txn.create_collection(pgid)
    n = 0
    for rec in blob["objects"]:
        oid = rec["oid"]
        txn.write(pgid, oid, 0, base64.b64decode(rec["data"]))
        for k, v in rec.get("attrs", {}).items():
            txn.setattr(pgid, oid, k, v.encode())
        omap = {k: base64.b64decode(v)
                for k, v in rec.get("omap", {}).items()}
        if omap:
            txn.omap_setkeys(pgid, oid, omap)
        n += 1
    store.queue_transaction(txn)
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="objectstore_tool")
    ap.add_argument("--data-path", required=True,
                    help="the WALStore dir (…/osd.N.wal)")
    ap.add_argument("--op", default="list",
                    choices=["list", "dump", "export", "import",
                             "remove"])
    ap.add_argument("--pgid")
    ap.add_argument("--oid")
    ap.add_argument("--file", help="export/import file (default -)")
    args = ap.parse_args(argv)

    store = _mount(args.data_path)
    try:
        if args.op == "list":
            print(json.dumps(op_list(store, args.pgid), indent=1))
        elif args.op == "dump":
            if not (args.pgid and args.oid):
                raise SystemExit("dump needs --pgid and --oid")
            print(json.dumps(op_dump(store, args.pgid, args.oid),
                             indent=1))
        elif args.op == "export":
            if not args.pgid:
                raise SystemExit("export needs --pgid")
            blob = json.dumps(op_export(store, args.pgid))
            if args.file and args.file != "-":
                open(args.file, "w").write(blob)
            else:
                print(blob)
        elif args.op == "import":
            raw = open(args.file).read() if args.file and \
                args.file != "-" else sys.stdin.read()
            n = op_import(store, json.loads(raw))
            print(f"imported {n} objects", file=sys.stderr)
        elif args.op == "remove":
            if not (args.pgid and args.oid):
                raise SystemExit("remove needs --pgid and --oid")
            from ..os.objectstore import Transaction

            store.queue_transaction(
                Transaction().remove(args.pgid, args.oid))
    finally:
        store.umount()
    return 0


if __name__ == "__main__":
    sys.exit(main())
