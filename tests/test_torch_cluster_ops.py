"""The port's cluster operations held to ``ceph_tpu``'s: MemStore
``MiniCluster``s of both packages run the same scripted scenarios, and
what a client or an operator can observe must be equal.

One cluster a package (a monitor, 7 OSDs on 7 hosts, a replicated pool,
jerasure reed_sol_van 4+2 on K1's plain version in the port and
cauchy_good 4+2 packetsize 8 on K3's), on which, in order
(``test_cluster.py``'s scenarios):

- map epoch catch-up: the epoch before the newest is served, a future
  one is refused;
- watch/notify: a notify reaches the watcher and is acked, and after an
  unwatch nothing is delivered;
- an image clone: reads fall through to the parent snapshot, writes copy
  on write, unprotect is refused while the child exists, flatten
  detaches it, and a shrink of a clone exposes zeros;
- PG log trim: after a peering pass each member keeps at most the newest
  records of an object;
- one OSD killed (the primary of a watched object, a holder of a shard
  of two EC objects): health turns to a warning naming the down OSD,
  notifies reach the watcher through the new primary, partial
  overwrites of both EC objects succeed degraded; once it is back,
  recovery completes the missing positions and health returns to OK,
  with every shard equal to ``ceph_tpu``'s encode;
- a scheduled deep scrub finds a corrupted shard and repairs it.

A second, small cluster a package (2 OSDs, a size-1 pool, as
``test_stats_plane.py`` builds it): the PG stats of a dead OSD go
STALE, then age out of the PG map.

Each package's scenario runs once, in a module fixture, and records what
it saw; the tests compare the records.  Failure detection is the
monitor's ``mark_down`` command and pings are sparse; every wait is on a
state, under a deadline of 60 s.
"""

import threading

import pytest

from test_torch_cluster import CG, PROFILES, REP, RS, reference_shards
from test_torch_cluster import landed, stored_shards
from test_torch_durable import (PORT, REF, WAIT, KernelCalls, _bytes, both,
                                mark_down, run_both, step, wait_for)
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

N_OSDS = 7
DOWN_CODES = {"OSD_DOWN", "PG_DEGRADED"}   # health with an OSD down


def ops_conf(pkg):
    conf = pkg.config.Config()
    conf.set("osd_heartbeat_interval", 2.0)
    conf.set("osd_heartbeat_grace", 120.0)
    # a loaded host answers pings late: no OSD_SLOW_PING_TIME below 30 s
    conf.set("osd_heartbeat_ping_threshold_ms", 30000.0)
    conf.set("mon_osd_down_out_interval", 3600.0)
    # recovery of several PGs at once, as test_torch_cluster.py sets it
    conf.set("osd_max_backfills", 8)
    return conf


def shards_equal_reference(cl, objects):
    """``objects``' shards that differ from ``ceph_tpu``'s encode, or are
    stored nowhere, once every shard has landed."""
    wait_for(lambda: landed(cl, objects),
             lambda: f"the shards never all landed: {landed.last}")
    held = stored_shards(cl)
    bad = []
    for (pool, oid), raw in objects.items():
        want = reference_shards(pool, raw)
        for shard, chunk in enumerate(want):
            holders = held.get((pool, oid, shard))
            if not holders:
                bad.append((pool, oid, shard, "missing"))
            bad += [(pool, oid, shard, osd) for osd, got in holders.items()
                    if got != chunk] if holders else []
    return bad


def _catchup(cl):
    cur = cl.status()["epoch"]
    msgr = cl.mon.msgr
    old = msgr.call(cl.mon.addr, {"type": "get_map", "epoch": cur - 1})
    missing = msgr.call(cl.mon.addr, {"type": "get_map", "epoch": 10 ** 9})
    return {"epoch": old["epoch"] == cur - 1,
            "binary": "map_bin" in old, "missing": missing}


def _watch_notify(cl):
    watcher, notifier = cl.client("watcher"), cl.client("notifier")
    got, ev = [], threading.Event()

    def cb(oid, payload, who):
        got.append((oid, payload, who))
        ev.set()

    watcher.put(REP, "watched", b"state-0")
    watcher.watch(REP, "watched", cb)
    first = notifier.notify(REP, "watched", {"event": "flush", "n": 1})
    delivered = ev.wait(timeout=WAIT)
    watcher.unwatch(REP, "watched")
    ev.clear()
    after = notifier.notify(REP, "watched", {"event": "x"})
    late = ev.wait(timeout=1.0)
    return {"first": first, "delivered": delivered, "got": got,
            "after_unwatch": after, "late": late}


def _clone_flatten(pkg, cl):
    Image, ImageError = pkg.image.Image, pkg.image.ImageError
    cli = cl.client("rbd-clone")
    out = []

    def refused(fn):
        try:
            fn()
        except ImageError as e:
            return ("ImageError", str(e))
        return None

    img = Image.create(cli, REP, "parent-img", 64 * 1024,
                       object_size=16 * 1024)
    img.write(0, b"P" * 1000)
    img.write(30_000, b"Q" * 500)
    img.snapshot("s1")
    out.append(refused(lambda: img.clone("s1", "child-unprotected")))
    img.protect_snap("s1")
    child = img.clone("s1", "child-img")
    out.append(child._h.get("parent"))
    out.append(child.read(0, 1000))
    img.write(0, b"X" * 1000)       # a parent write after the snapshot
    out.append(child.read(0, 1000))
    child.write(100, b"c" * 50)     # copy on write of one range
    out += [child.read(0, 1000), child.read(30_000, 500)]
    out.append(refused(lambda: img.unprotect_snap("s1")))
    child.flatten()
    out += [child._h.get("parent"), child.read(0, 1000),
            child.read(30_000, 500)]
    out.append(refused(lambda: img.unprotect_snap("s1")))
    img.protect_snap("s1")
    child2 = img.clone("s1", "child2-img")
    child2.resize(1024)
    child2.resize(40_000)
    out.append(child2.read(30_000, 500))
    out.append(Image.open(cli, REP, "child-img").read(0, 200))
    return out


def _log_trim(pkg, cl):
    c = cl.client("trim")
    for i in range(10):
        c.put(REP, "trim-obj", f"gen-{i}".encode() * 50)
    counts = []

    def trimmed():
        # a peering pass trims: poke every OSD's
        for svc in cl.osds.values():
            svc._recover_wake.set()
        counts.clear()
        for svc in cl.osds.values():
            for cid in svc.store.list_collections():
                if not cid.startswith(f"{REP}."):
                    continue
                n = 0
                for raw in svc.store.omap_get(cid, "pglog").values():
                    try:
                        rec = pkg.pg_log.PgLogEntry.decode_blob(raw)
                    except pkg.encoding.MalformedInput:
                        continue
                    n += rec.oid == "trim-obj"
                if n:
                    counts.append(n)
        return len(counts) == 3 and all(n <= 2 for n in counts)

    wait_for(trimmed, lambda: f"log never trimmed: {counts}")
    return {"members": len(counts), "most": max(counts),
            "read": c.get(REP, "trim-obj")}


def _degraded_name(pkg, cl, victim):
    """The first ``deg-<i>`` with a shard on ``victim`` in both EC
    pools."""
    for i in range(256):
        oid = f"deg-{i}"
        if all(victim in pkg.up(cl, pool, oid)[1] for pool in (RS, CG)):
            return oid
    raise AssertionError(f"no object has shards on osd.{victim}")


def _kill_cycle(pkg, cl, objects, rec):
    """One OSD down and back: health, a watch across the primary's
    move, degraded overwrites, recovery."""
    cl.wait_for_health_ok(timeout=WAIT)
    st = cl.status()["pgmap"]
    rec["health_before"] = (st["pgs_reported"] == st["pgs_total"],
                            all("clean" in s for s in st["by_state"]))
    watcher, notifier = cl.client("watcher2"), cl.client("notifier2")
    ev = threading.Event()
    watcher.put(REP, "roaming", b"x")
    watcher.watch(REP, "roaming", lambda *a: ev.set())
    victim = pkg.up(cl, REP, "roaming")[1][0]
    deg = _degraded_name(pkg, cl, victim)
    c = cl.client("rmw-deg")
    for pool in (RS, CG):
        raw = _bytes((pool, 1001))
        c.put(pool, deg, raw)
        objects[(pool, deg)] = raw
    wait_for(lambda: landed(cl, objects), "the EC objects never landed")
    mark_down(cl, victim)

    def warned():
        # the monitor names the down OSD at once and the degraded PGs
        # once their primaries report: wait for both
        h = cl.health()
        codes = set(h.get("check_codes", [])) & DOWN_CODES
        rec["health_down"] = (h["status"], sorted(codes))
        return h["status"] == "HEALTH_WARN" and codes == DOWN_CODES and \
            any("down" in ch for ch in h["checks"])

    step(rec, "warned", lambda: wait_for(warned, "no HEALTH_WARN") or True)

    def moved():
        notifier.refresh_map()
        watcher.refresh_map()
        try:
            acks = notifier.notify(REP, "roaming", {"ping": 1}).get("acks")
        except Exception:  # noqa: BLE001  (the old primary is gone)
            return False
        rec["moved_acks"] = acks
        return bool(acks)

    step(rec, "moved", lambda: wait_for(moved, "no ack after the move")
         or ev.wait(timeout=WAIT))

    def overwrite(pool):
        patch = b"DEGRADED-WRITE"
        c.write(pool, deg, 333, patch)
        want = bytearray(objects[(pool, deg)])
        want[333:333 + len(patch)] = patch
        objects[(pool, deg)] = bytes(want)
        return c.get(pool, deg) == bytes(want)

    with KernelCalls() as kc:
        step(rec, "degraded_overwrite", lambda: [overwrite(pool)
                                                 for pool in (RS, CG)])
    rec["degraded_kernel_calls"] = kc.calls
    cl.revive_osd(victim)
    cl.wait_for_up(victim, timeout=WAIT)
    for pool in (RS, CG):
        cl.wait_for_recovery(pool, {deg: None}, timeout=WAIT)
    rec["after_revive"] = [c.get(pool, deg) == objects[(pool, deg)]
                           for pool in (RS, CG)]
    step(rec, "health_after",
         lambda: cl.wait_for_health_ok(timeout=WAIT)["status"])
    return shards_equal_reference(cl, objects)


def _scheduled_scrub(pkg, cl):
    """A deep scrub every 2 s from now on (the option is read live); a
    shard of an EC object corrupted in its store is found and rebuilt
    with no scrub asked for.  The scrub scheduler and the rebuild run
    in the OSDs' recovery passes, idle ones every 20 s: the passes are
    poked, as the log trim's are."""
    cli = cl.client("sched-scrub")
    data = _bytes((RS, 1002))
    cli.put(RS, "ss-obj", data)
    cl.wait_for_recovery(RS, {"ss-obj": None}, timeout=WAIT)
    ps, up = pkg.up(cl, RS, "ss-obj")
    victim = cl.osds[up[1]]
    cid = f"{RS}.{ps}"
    victim.store._coll[cid]["ss-obj.s1"].data[3] ^= 0x5A
    cl.conf.set("osd_scrub_interval", 2.0)
    crc32c = pkg.stripe.crc32c

    def fixed():
        for svc in cl.osds.values():
            svc._recover_wake.set()
        obj = victim.store._coll.get(cid, {}).get("ss-obj.s1")
        if obj is None:
            return False
        stored = victim.store.getattr(cid, "ss-obj.s1", "crc")
        return stored is not None and int(stored) == crc32c(bytes(obj.data))

    wait_for(fixed, "scheduled scrub never repaired the shard")
    return {"fixed": True, "read": cli.get(RS, "ss-obj") == data,
            "shard": bytes(victim.store._coll[cid]["ss-obj.s1"].data) ==
            reference_shards(RS, data)[1]}


def ops_run(pkg):
    rec = {}
    cl = pkg.start(N_OSDS, ops_conf(pkg))
    try:
        cl.create_replicated_pool(REP, pg_num=4, size=3)
        for pool, prof in PROFILES.items():
            cl.create_ec_pool(pool, f"p{pool}", dict(prof), pg_num=4)
        cl.wait_for_health_ok(timeout=WAIT)
        objects = {}
        step(rec, "catchup", lambda: _catchup(cl))
        step(rec, "watch", lambda: _watch_notify(cl))
        step(rec, "clone", lambda: _clone_flatten(pkg, cl))
        step(rec, "trim", lambda: _log_trim(pkg, cl))
        step(rec, "stores", lambda: _kill_cycle(pkg, cl, objects, rec))
        step(rec, "scrub", lambda: _scheduled_scrub(pkg, cl))
    finally:
        cl.shutdown()
    return rec


@pytest.fixture(scope="module")
def ops():
    """Each package's record, one after the other (the reference's
    packet-layout codes compile JAX programs, which hold the GIL)."""
    return {pkg.name: ops_run(pkg) for pkg in (REF, PORT)}


def test_map_epoch_catchup(ops):
    ref, port = both(ops, "catchup")
    assert port == ref
    assert port["epoch"] and port["binary"] and "error" in port["missing"]


def test_watch_notify(ops):
    ref, port = both(ops, "watch")
    assert port == ref
    assert port["delivered"] and not port["late"]
    assert port["first"]["acks"] and port["after_unwatch"]["acks"] == []
    assert port["got"][0][:2] == ("watched", {"event": "flush", "n": 1})


def test_image_clone_cow_and_flatten(ops):
    ref, port = both(ops, "clone")
    assert port == ref
    assert port[0][0] == "ImageError"                   # not protected
    assert port[1] is not None and port[7] is None      # parent, flattened
    assert port[2] == port[3] == b"P" * 1000
    assert port[4] == b"P" * 100 + b"c" * 50 + b"P" * 850
    assert port[8] == port[4] and port[12] == port[4][:200]
    assert port[5] == port[9] == b"Q" * 500
    assert port[6][0] == "ImageError" and port[10] is None
    assert port[11] == bytes(500)


def test_pg_log_trim(ops):
    ref, port = both(ops, "trim")
    assert port == ref
    assert port["members"] == 3 and port["most"] <= 2


@pytest.mark.parametrize("what", ["health_before", "warned", "health_down",
                                  "health_after"])
def test_health_and_pg_states(ops, what):
    ref, port = both(ops, what)
    assert port == ref
    want = {"health_before": (True, True), "warned": True,
            "health_after": "HEALTH_OK"}
    if what in want:
        assert port == want[what]
    else:
        assert port == ("HEALTH_WARN", sorted(DOWN_CODES))


def test_watch_survives_a_primary_move(ops):
    ref, port = both(ops, "moved")
    assert port == ref is True
    assert both(ops, "moved_acks")[0] == both(ops, "moved_acks")[1]


def test_ec_degraded_overwrite(ops):
    assert both(ops, "degraded_overwrite") == ([True, True], [True, True])
    assert both(ops, "after_revive") == ([True, True], [True, True])
    assert both(ops, "stores") == ([], [])
    calls = ops["ceph_tpu_torch"]["degraded_kernel_calls"]
    assert calls["k1"] > 0 and calls["k3"] > 0


def test_scheduled_scrub_auto_repairs(ops):
    ref, port = both(ops, "scrub")
    assert port == ref == {"fixed": True, "read": True, "shard": True}


# -- PG stats going stale: a cluster of its own ------------------------

def stale_conf(pkg):
    conf = pkg.config.Config()
    conf.set("osd_heartbeat_interval", 2.0)
    conf.set("osd_heartbeat_grace", 120.0)
    # a loaded host answers pings late: no OSD_SLOW_PING_TIME below 30 s
    conf.set("osd_heartbeat_ping_threshold_ms", 30000.0)
    conf.set("osd_pg_stat_report_interval", 0.2)
    conf.set("mon_pg_stats_stale_grace", 1.5)
    # the dead OSD stays in: a remap would elect a new, empty primary
    # whose reports would mask the staleness
    conf.set("mon_osd_down_out_interval", 3600.0)
    conf.set("osd_scrub_interval", 0.0)
    return conf


def stale_run(pkg, _root):
    rec = {}
    cl = pkg.start(2, stale_conf(pkg))
    try:
        cl.create_replicated_pool(1, pg_num=4, size=1)
        c = cl.client("w")
        for i in range(4):
            c.put(1, f"s-{i}", b"y" * 1024)

        def reported():
            pg = cl.status()["pgmap"]
            return pg["pgs_reported"] == pg["pgs_total"] == 4

        step(rec, "reported", lambda: wait_for(reported, "unreported PGs")
             or True)
        cl.kill_osd(cl.status()["up_osds"][0])

        def stale():
            return "STALE_PG_STATS" in cl.health().get("check_codes", [])

        step(rec, "stale", lambda: wait_for(stale, "never STALE") or True)

        def aged():
            return cl.status()["pgmap"]["pgs_reported"] < 4

        step(rec, "aged", lambda: wait_for(aged, "never aged out") or True)
    finally:
        cl.shutdown()
    return rec


@pytest.fixture(scope="module")
def stale(tmp_path_factory):
    return run_both(stale_run, tmp_path_factory, "stale")


def test_pg_stats_go_stale_and_age_out(stale):
    ref, port = ({k: v for k, v in stale[name].items() if k != "seconds"}
                 for name in ("ceph_tpu", "ceph_tpu_torch"))
    assert port == ref == {"reported": True, "stale": True, "aged": True}
