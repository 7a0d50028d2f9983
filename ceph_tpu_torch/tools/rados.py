"""rados — the object CLI.

The port of ``ceph_tpu/tools/rados.py``: the `rados` tool role
(src/tools/rados/rados.cc) over the port's ``Client``: put/get/rm/ls/
stat/df against a running cluster's monitor address (the obj_bencher
analogue is tools/rados_bench.py).  The client's EC codes run on
``--device`` (default ``cuda``; without a card the tool fails unless
``--device cpu`` is given).

CLI:
    python -m ceph_tpu_torch.tools.rados --mon HOST:PORT -p POOL \
        [--device cuda|cpu] \
        put OBJ FILE | get OBJ FILE | rm OBJ | ls | stat OBJ | df
"""

from __future__ import annotations

import argparse
import json
import sys


def _client(mon: str, keyring_hex=None, device="cuda"):
    from ..services.client import Client

    host, port = mon.rsplit(":", 1)
    kr = None
    if keyring_hex:
        from ..msg.auth import Keyring

        kr = Keyring.from_hex(keyring_hex)
    return Client("rados-cli", (host, int(port)), keyring=kr,
                  device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rados")
    ap.add_argument("--mon", required=True, help="monitor host:port")
    ap.add_argument("-p", "--pool", type=int, default=1)
    ap.add_argument("--keyring", help="cluster key (hex)")
    ap.add_argument("--device", default="cuda",
                    help="where the client's EC codes run")
    sub = ap.add_subparsers(dest="op", required=True)
    p = sub.add_parser("put")
    p.add_argument("obj")
    p.add_argument("file")
    p = sub.add_parser("get")
    p.add_argument("obj")
    p.add_argument("file")
    p = sub.add_parser("rm")
    p.add_argument("obj")
    sub.add_parser("ls")
    p = sub.add_parser("stat")
    p.add_argument("obj")
    sub.add_parser("df")
    args = ap.parse_args(argv)

    cli = _client(args.mon, args.keyring, args.device)
    try:
        if args.op == "put":
            data = sys.stdin.buffer.read() if args.file == "-" \
                else open(args.file, "rb").read()
            cli.put(args.pool, args.obj, data)
        elif args.op == "get":
            data = cli.get(args.pool, args.obj)
            if args.file == "-":
                sys.stdout.buffer.write(data)
            else:
                open(args.file, "wb").write(data)
        elif args.op == "rm":
            cli.delete(args.pool, args.obj)
        elif args.op == "ls":
            # walk every PG's primary listing (object names are
            # client-hashed, so the union over PGs is the pool listing)
            pool = cli.map.pools[args.pool]
            seen = set()
            for ps in range(pool.pg_num):
                up, _p, acting, _ap = cli.map.pg_to_up_acting_osds(
                    args.pool, ps)
                members = acting if acting else up
                for osd in members:
                    if osd < 0 or osd not in cli.osd_addrs:
                        continue
                    got = cli.msgr.call(
                        cli.osd_addrs[osd],
                        {"type": "pg_list", "pool": args.pool,
                         "ps": ps}, timeout=5)
                    seen.update(got.get("objects", {}))
                    break
            for name in sorted(seen):
                print(name)
        elif args.op == "stat":
            data = cli.get(args.pool, args.obj)
            print(f"{args.obj} size {len(data)}")
        elif args.op == "df":
            st = cli.mon_call({"type": "status"})
            print(json.dumps({"epoch": st.get("epoch"),
                              "up_osds": st.get("up_osds"),
                              "num_pools": st.get("num_pools")}))
    finally:
        cli.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
