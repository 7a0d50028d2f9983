"""ceph — the cluster admin CLI.

The port of ``ceph_tpu/tools/ceph_cli.py``.  The `ceph` command role
(src/ceph.in + the mon command surface): status/health/df, osd
tree/reweight/out/down, pool create/delete/ls — all against a running
cluster's monitor address (quorum lists accepted as comma-separated
host:port pairs).  It makes no client and no EC code, so it takes no
device: the balancer verbs run on the mgr's.

Plus the local observability plane (no monitor needed — polls daemon
admin sockets, tools/telemetry.py):

Plus the wire-format conformance plane (no cluster needed — drives
the analysis/wirecheck.py registry, the ceph-dencoder role):

CLI:
    python -m ceph_tpu_torch.tools.ceph_cli --mon HOST:PORT[,HOST:PORT...] \
        status | health | osd tree | osd reweight ID W | osd out ID |
        osd down ID | pool ls | pool create ID PGS SIZE |
        pool delete ID | pool-stats [ID] | progress
    python -m ceph_tpu_torch.tools.ceph_cli --asok-dir DIR \
        daemonperf | top | history | latency | net |
        telemetry snapshot|prom|traces|flame|profile|net
    python -m ceph_tpu_torch.tools.ceph_cli --asok-dir DIR \
        balancer status|on|off|eval|execute |
        mgr module ls|enable|disable NAME
    python -m ceph_tpu_torch.tools.ceph_cli \
        dencoder list | encode TYPE | decode TYPE [HEXFILE] |
        roundtrip [TYPE]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..msg.messenger import Messenger
from ..services.map_follower import failover_call


def _mons(spec: str):
    out = []
    for part in spec.split(","):
        host, port = part.rsplit(":", 1)
        out.append((host, int(port)))
    return out


def _jsonable(obj):
    """Decoded wire objects rendered for the terminal: bytes as hex,
    to_dict forms expanded, tuples as lists."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bytes(obj).hex()
    if hasattr(obj, "to_dict"):
        return _jsonable(obj.to_dict())
    if hasattr(obj, "export_state"):
        return _jsonable(obj.export_state())
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def _mgr_verb(args, extra) -> int:
    """Route `balancer ...` / `mgr ...` through the manager daemon's
    admin socket (`ceph balancer status|on|off|eval|execute`, `ceph
    mgr module ls|enable|disable`)."""
    import glob
    import os

    from ..common.admin_socket import AdminSocket

    if not args.asok_dir:
        print("balancer/mgr verbs need --asok-dir", file=sys.stderr)
        return 2
    socks = sorted(glob.glob(
        os.path.join(args.asok_dir, "mgr.*.asok")))
    if not socks:
        print(f"no mgr admin socket under {args.asok_dir}",
              file=sys.stderr)
        return 2
    argv = args.verb[1:] + extra
    try:
        # generous deadline: a cold `balancer eval` builds the batched
        # sweep's kernel and lowers the map inside the request
        rep = AdminSocket.request(socks[0], args.verb[0], timeout=60.0,
                                  argv=argv)
    except OSError as e:
        print(f"mgr admin socket: {e}", file=sys.stderr)
        return 1
    if isinstance(rep, dict) and rep.get("error"):
        print(json.dumps(rep), file=sys.stderr)
        return 1
    if args.verb[0] == "balancer" and argv[:1] == ["eval"] and \
            isinstance(rep, dict):
        # the per-pool score breakdown, human-shaped
        print(f"cluster: stddev {rep.get('stddev', 0.0):.3f} "
              f"score {rep.get('score', 0.0):.6f} "
              f"max_dev {rep.get('max_dev', 0.0):.2f} "
              f"({rep.get('osd_count')} osds, "
              f"{rep.get('sweep_launches')} sweeps)")
        for pid, row in sorted((rep.get("pools") or {}).items()):
            print(f"pool {pid}: pg_num {row.get('pg_num')} "
                  f"size {row.get('size')} "
                  f"stddev {row.get('stddev', 0.0):.3f} "
                  f"score {row.get('score', 0.0):.6f} "
                  f"max_dev {row.get('max_dev', 0.0):.2f}")
        return 0
    print(json.dumps(rep, indent=1, sort_keys=True))
    return 0


def _dencoder(verb, extra) -> int:
    """The ceph-dencoder role over the wirecheck registry: enumerate
    registered wire types, emit an example encode, decode arbitrary
    blobs, and run the five-property conformance check."""
    from ..analysis import wirecheck

    sub = verb[1] if len(verb) > 1 else "list"
    if sub == "list":
        for e in wirecheck.entries():
            print(f"{e.name}  struct_v={e.struct_v} "
                  f"compat_v={e.compat_v} kind={e.kind}"
                  f"{' legacy-ok' if e.legacy else ''}")
        return 0
    if sub == "encode":
        if len(verb) < 3:
            print("dencoder encode needs a TYPE", file=sys.stderr)
            return 2
        e = wirecheck.get(verb[2])
        blob = e.encode(e.factory())
        blob = blob.encode() if isinstance(blob, str) else blob
        print(blob.hex())
        return 0
    if sub == "decode":
        if len(verb) < 3:
            print("dencoder decode needs a TYPE", file=sys.stderr)
            return 2
        e = wirecheck.get(verb[2])
        src = verb[3] if len(verb) > 3 else "-"
        hexstr = sys.stdin.read() if src == "-" else \
            open(src).read()
        try:
            obj = e.decode(bytes.fromhex(hexstr.strip()))
        except ValueError as err:
            print(f"decode failed: {err}", file=sys.stderr)
            return 1
        # the entry's comparable form: a keyring or a checkpoint's
        # objects have no dict form of their own (``ceph_tpu`` prints
        # the decoded object and raises TypeError on those two)
        print(json.dumps(_jsonable(e.extract(obj)), indent=1))
        return 0
    if sub == "roundtrip":
        targets = wirecheck.entries() if len(verb) < 3 else \
            [wirecheck.get(verb[2])]
        bad = 0
        for e in targets:
            fails = wirecheck.check(e)
            print(f"{e.name}: "
                  f"{'ok' if not fails else 'FAIL'}")
            for f in fails:
                print(f"  - {f}")
            bad += bool(fails)
        return 1 if bad else 0
    print(f"unknown dencoder verb {sub!r}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph")
    ap.add_argument("--mon",
                    help="monitor address(es), host:port[,host:port]")
    ap.add_argument("--asok-dir",
                    help="daemon admin-socket dir (daemonperf / "
                         "telemetry verbs)")
    ap.add_argument("--keyring", help="cluster key (hex)")
    ap.add_argument("verb", nargs="+")
    # unknown extras (e.g. daemonperf's --interval/--count) pass
    # through to the telemetry tool's own parser
    args, extra = ap.parse_known_args(argv)

    # the conformance plane runs entirely offline
    if args.verb[0] == "dencoder":
        return _dencoder(args.verb, extra)

    # the observability verbs poll admin sockets directly — no
    # monitor, no messenger.  `top` and `history` are the continuous
    # plane (per-daemon metrics-history rings + live rate frames).
    if args.verb[0] in ("daemonperf", "telemetry", "top",
                        "history", "latency", "net"):
        from . import telemetry

        if not args.asok_dir:
            print("daemonperf/telemetry/top/history/latency need "
                  "--asok-dir", file=sys.stderr)
            return 2
        if args.verb[0] == "telemetry":
            sub = args.verb[1] if len(args.verb) > 1 else "snapshot"
        else:
            sub = args.verb[0]
        return telemetry.main(["--asok-dir", args.asok_dir, sub]
                              + args.verb[2:] + extra)

    # the manager verbs route through the mgr's admin socket (the
    # `ceph balancer ...` / `ceph mgr module ...` surfaces): the mgr
    # owns the module plane, not the monitor
    if args.verb[0] in ("balancer", "mgr"):
        return _mgr_verb(args, extra)

    if extra:
        print(f"unrecognized arguments: {' '.join(extra)}",
              file=sys.stderr)
        return 2
    if not args.mon:
        print("this verb needs --mon", file=sys.stderr)
        return 2
    kr = None
    if args.keyring:
        from ..msg.auth import Keyring

        kr = Keyring.from_hex(args.keyring)
    msgr = Messenger("ceph-cli", keyring=kr)
    msgr.start()
    mons = _mons(args.mon)

    def call(msg, timeout=10.0):
        rep, _ = failover_call(msgr, mons, msg, timeout=timeout)
        return rep

    def mutate(rep) -> int:
        """Mutation verbs honor the exit-code contract: a monitor
        error reply is a failure, not a success with sad JSON."""
        print(json.dumps(rep))
        return 1 if isinstance(rep, dict) and rep.get("error") else 0

    v = args.verb
    rc = 0
    try:
        if v[0] == "status":
            st = call({"type": "status"})
            h = call({"type": "health"})
            pg = st.get("pgmap", {})
            print(f"  health:  {h.get('status')}")
            for chk in h.get("checks", []):
                print(f"           {chk}")
            print(f"  epoch:   {st.get('epoch')}")
            print(f"  osds:    {len(st.get('up_osds', []))} up "
                  f"{st.get('up_osds')}")
            print(f"  pools:   {st.get('num_pools')}")
            print(f"  pgs:     {pg.get('pgs_reported')}/"
                  f"{pg.get('pgs_total')} reported "
                  f"{pg.get('by_state')}")
            print(f"  objects: {pg.get('objects')}")
        elif v[0] == "health":
            h = call({"type": "health"})
            print(h["status"])
            for chk in h.get("checks", []):
                print(f"  {chk}")
            if h["status"] != "HEALTH_OK":
                return 1
        elif v[0] == "df":
            st = call({"type": "status"})
            print(json.dumps(st.get("pgmap", {}), indent=1))
        elif v[:2] == ["osd", "tree"]:
            payload = call({"type": "get_map"})
            from ..crush.wrapper import CrushWrapper
            from ..osdmap.bincode_maps import payload_map
            from .crushtool import cmd_tree

            w = CrushWrapper(payload_map(payload).crush)
            cmd_tree(w, sys.stdout)
        elif v[:2] == ["osd", "reweight"] and len(v) == 4:
            rc = mutate(call({"type": "reweight", "osd": int(v[2]),
                              "weight": int(float(v[3]) * 0x10000)}))
        elif v[:2] == ["osd", "out"] and len(v) == 3:
            rc = mutate(call({"type": "mark_out", "osd": int(v[2])}))
        elif v[:2] == ["osd", "down"] and len(v) == 3:
            rc = mutate(call({"type": "mark_down",
                              "osd": int(v[2])}))
        elif v[:2] == ["pool", "ls"]:
            payload = call({"type": "get_map"})
            from ..osdmap.bincode_maps import payload_map

            for pid, pool in sorted(payload_map(payload)
                                    .pools.items()):
                print(f"pool {pid}: type {pool.pool_type} "
                      f"size {pool.size} pg_num {pool.pg_num}")
        elif v[:2] == ["pool", "create"] and len(v) == 5:
            rc = mutate(call(
                {"type": "pool_create", "pool_id": int(v[2]),
                 "pool": {"pool_type": 1,
                          "size": int(v[4]),
                          "min_size": max(1, int(v[4]) - 1),
                          "pg_num": int(v[3]),
                          "crush_rule": 0}}))
        elif v[:2] == ["pool", "delete"] and len(v) == 3:
            rc = mutate(call({"type": "pool_delete",
                              "pool_id": int(v[2])}))
        elif v[0] == "pool-stats":
            msg = {"type": "pool_stats"}
            if len(v) > 1:
                msg["pool"] = int(v[1])
            got = call(msg)
            for pid, st in sorted(got.get("pools", {}).items()):
                cur = st.get("current", {})
                last = (st.get("series") or [{}])[-1]
                print(f"pool {pid}: {cur.get('objects', 0)} objects, "
                      f"{cur.get('degraded_pgs', 0)} pgs degraded; "
                      f"wr {last.get('wr_bps', 0.0):.0f} B/s "
                      f"({last.get('wr_ops_s', 0.0):.1f} op/s), "
                      f"rd {last.get('rd_bps', 0.0):.0f} B/s, "
                      f"recovery "
                      f"{last.get('recovery_bps', 0.0):.0f} B/s")
            print(json.dumps(got))
        elif v[0] == "progress":
            got = call({"type": "progress"})
            events = got.get("events", [])
            if not events:
                print("progress: nothing in progress")
            for ev in events:
                bar_w = 30
                frac = float(ev.get("fraction", 0.0))
                fill = int(bar_w * max(0.0, min(1.0, frac)))
                state = "done" if ev.get("done") else \
                    f"{ev.get('rate_bps', 0.0):.0f} B/s"
                print(f"  {ev.get('id')}: "
                      f"[{'=' * fill}{'.' * (bar_w - fill)}] "
                      f"{frac * 100:.1f}% ({state})")
        else:
            print(f"unknown or incomplete verb: {' '.join(v)}",
                  file=sys.stderr)
            return 2
    finally:
        msgr.shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(main())
