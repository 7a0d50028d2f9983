"""The port's durable daemons held to ``ceph_tpu``'s: WAL-backed
``MiniCluster``s of both packages run the same scripted scenarios, and
what a client or an operator can observe must be equal.

One cluster a package (6 OSDs on 6 hosts, every store a ``WALStore``
under ``tmp_path``, one monitor with its epoch store there too): a
replicated pool, jerasure reed_sol_van 4+2 (K1's plain version in the
port) and cauchy_good 4+2 packetsize 8 (K3's).  On it, in order:

1. the aio window (16) drives the WAL's group commit and the batched
   EC encode: both histograms gain samples past depth 1, every object
   reads back, every shard in every store equals ``ceph_tpu``'s plugin
   encode (``test_aio.py``);
2. an aio op against a missing pool fails its own completion, and later
   ops and the flush are clean (``test_aio.py``);
3. an OSD restart remounts its shards from the WAL checkpoint, with no
   object recovered (``test_persistence.py``);
4. a pool deleted on the persistent daemons stays deleted across an OSD
   restart, and a reweight lands in the map (``test_persistence.py``);
5. a solo monitor restart resumes its epochs, and new commands commit
   newer ones (``test_persistence.py``).  Its subscribers are lost with
   it in both packages: no daemon is pushed an epoch after the restart.

Then a second cluster a package (2 OSDs, a size-2 pool, as
``test_peering.py`` builds it): divergent histories reconcile, newest
version first and tombstones propagating, and reads never go back to a
stale copy while a revived replica catches up.

Each package's scenario runs once, in a module fixture, and records what
it saw (a step that raised records its error); the tests compare the
records.  Failure detection is the monitor's ``mark_down`` command and
pings are sparse, so a loaded host cannot flap an OSD; every wait is on
a state, under a deadline of 60 s.
"""

import importlib
import os
import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.ec import gf2_kernels, gf2_packet
from test_torch_cluster import CG, PROFILES, REP, RS, check_stores
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

WAIT = 60.0
N_OSDS = 6
SIZE = 4000        # one 1,024-byte chunk in both 4+2 profiles
AIO_OBJECTS = 32   # aio_puts a pool and round
NEW_POOL = 4       # made and deleted; NEW_POOL + 1 made after a mon restart


def _bytes(seed, size=SIZE):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


class Pkg:
    """One package's modules, by the same names in both."""

    def __init__(self, name, **kw):
        self.name = name
        self.kw = kw    # what its MiniCluster takes beyond the reference's
        for attr, mod in (("config", "common.config"),
                          ("cluster", "services.cluster"),
                          ("client", "services.client"),
                          ("image", "services.image"),
                          ("pg_log", "services.pg_log"),
                          ("encoding", "common.encoding"),
                          ("stripe", "ec.stripe"),
                          ("wal", "os.wal_store"),
                          ("engine", "ec.engine"),
                          ("maps", "osdmap.bincode_maps")):
            setattr(self, attr, importlib.import_module(f"{name}.{mod}"))

    def start(self, n_osds, conf, **kw):
        return self.cluster.MiniCluster(n_osds=n_osds, config=conf,
                                        **kw, **self.kw).start()

    def map(self, cl):
        return self.maps.payload_map(cl.mon_command({"type": "get_map"}))

    def up(self, cl, pool, oid):
        m = self.map(cl)
        ps = self.client.object_to_ps(oid) % m.pools[pool].pg_num
        return ps, m.pg_to_up_acting_osds(pool, ps)[0]


REF = Pkg("ceph_tpu")
PORT = Pkg("ceph_tpu_torch", device="cpu")


def run_both(fn, tmp_path_factory, prefix):
    """{package name: fn(pkg, a fresh directory)} for both packages, run
    at once on two threads (their clusters share nothing but the
    process, and each waits mostly on its own daemons)."""
    out, errs = {}, []

    def run(pkg, root):
        try:
            out[pkg.name] = fn(pkg, root)
        except BaseException as e:  # noqa: BLE001  (raised below)
            errs.append(e)

    threads = [threading.Thread(target=run, args=(
        pkg, str(tmp_path_factory.mktemp(f"{prefix}-{pkg.name}"))))
        for pkg in (REF, PORT)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10 * WAIT)
    assert not any(t.is_alive() for t in threads), "a scenario hung"
    if errs:
        raise errs[0]
    return out


def step(rec, key, fn):
    """``rec[key] = fn()``; a step that raises records its error (its
    row's test shows it) and the scenario goes on.  Its seconds go to
    ``rec["seconds"]``."""
    t0 = time.monotonic()
    try:
        rec[key] = fn()
    except Exception as e:  # noqa: BLE001  (recorded, asserted later)
        rec[key] = f"failed: {type(e).__name__}: {e}"
    rec.setdefault("seconds", {})[key] = round(time.monotonic() - t0, 2)


def wait_for(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(what() if callable(what) else what)
        time.sleep(0.05)


def mark_down(cl, osd):
    """Kill ``osd`` and tell the monitor (faster and steadier than the
    heartbeat grace)."""
    cl.kill_osd(osd)
    cl.mon_command({"type": "mark_down", "osd": osd})


def stores_equal_reference(cl, objects):
    """Every shard in every store equals ``ceph_tpu``'s encode of its
    object, and every object's every shard is stored."""
    held = check_stores(cl, objects)
    return len(held)


def reads_back(cli, objects):
    """The objects that do not read back as written (read 8 at a time,
    as the aio window's threads share a client)."""
    from concurrent.futures import ThreadPoolExecutor

    keys = sorted(objects)
    with ThreadPoolExecutor(max_workers=8) as ex:
        got = list(ex.map(lambda key: cli.get(*key), keys))
    return [f"{pool}/{oid}" for (pool, oid), raw in zip(keys, got)
            if raw != objects[(pool, oid)]]


class KernelCalls:
    """Counts the port's K1 and K3 entry calls (their plain versions on
    the CPU) while open."""

    def __init__(self):
        self.calls = {"k1": 0, "k3": 0}
        self._lock = threading.Lock()

    def __enter__(self):
        self.real = {}
        for mod, name, key in ((gf2_kernels, "gf2_matmul_w8", "k1"),
                               (gf2_packet, "gf2_packet", "k3")):
            real = self.real[(mod, name)] = getattr(mod, name)

            def tap(*a, _real=real, _key=key, **kw):
                with self._lock:
                    self.calls[_key] += 1
                return _real(*a, **kw)

            tap.launches = 0
            setattr(mod, name, tap)
        return self

    def __exit__(self, *exc):
        for (mod, name), real in self.real.items():
            setattr(mod, name, real)
        return False


def _multi(cur, base):
    """Samples past the first bucket (depth > 1) since ``base``."""
    return sum(c - b for c, b in zip(cur[1:], base[1:]))


def _hists(pkg):
    return (list(pkg.wal._pc.dump()["wal_group_size"]["buckets"]),
            list(pkg.engine._pc.dump()["ec_batch_size"]["buckets"]))


def durable_conf(pkg):
    conf = pkg.config.Config()
    conf.set("osd_heartbeat_interval", 2.0)
    conf.set("osd_heartbeat_grace", 120.0)
    # a loaded host answers pings late: no OSD_SLOW_PING_TIME below 30 s
    conf.set("osd_heartbeat_ping_threshold_ms", 30000.0)
    conf.set("mon_osd_down_out_interval", 3600.0)
    conf.set("client_aio_window", 16)
    # the reference's aio test widens both coalescing windows
    conf.set("wal_group_commit_max_delay_us", 3000)
    conf.set("ec_encode_batch_max_delay_us", 3000)
    return conf


# -- rows 1-5: one WAL-backed cluster a package ------------------------

def _aio_window(pkg, cli, objects):
    """Rounds of ``AIO_OBJECTS`` aio_puts a pool until both coalescing
    layers have formed a group of two or more (normally the first)."""
    wal0, ec0 = _hists(pkg)
    rounds, errors = 0, []
    deadline = time.monotonic() + WAIT
    while True:
        comps = []
        for i in range(AIO_OBJECTS):
            for pool in (RS, CG):
                oid = f"aio{rounds}-{i}"
                raw = _bytes((pool, rounds, i))
                objects[(pool, oid)] = raw
                comps.append(cli.aio_put(pool, oid, raw))
        cli.flush(timeout=WAIT)
        rounds += 1
        errors += [repr(c.error) for c in comps
                   if not c.done() or c.error is not None]
        wal, ec = _hists(pkg)
        if (_multi(wal, wal0) and _multi(ec, ec0)) or errors or \
                time.monotonic() > deadline:
            break
    depth = cli.pc.dump()["aio_depth"]["buckets"]
    return {"errors": errors, "wal_group_past_1": _multi(wal, wal0) > 0,
            "ec_batch_past_1": _multi(ec, ec0) > 0,
            "aio_depth_past_1": sum(depth[1:]) > 0, "rounds": rounds}


def _aio_error(cli, objects):
    comp = cli.aio_put(REP, "ok", b"x" * 128)
    comp.wait(timeout=WAIT)
    bad = cli.aio_put(99, "nope", b"y", retries=1)
    try:
        bad.wait(timeout=WAIT)
        raised = None
    except Exception as e:  # noqa: BLE001  (what wait() re-raises)
        raised = (type(e).__name__, str(e))
    ok2 = cli.aio_put(REP, "ok2", b"z" * 128)
    cli.flush(timeout=WAIT)
    objects[(REP, "ok")], objects[(REP, "ok2")] = b"x" * 128, b"z" * 128
    return {"raised": raised, "error": type(bad.error).__name__,
            "ok2": (ok2.done(), ok2.error, cli.get(REP, "ok2"))}


def _osd_restart(pkg, cl, cli, root, objects):
    """Kill an OSD that holds shards of both EC pools and revive it."""
    _ps, up = pkg.up(cl, RS, "aio0-0")
    victim = up[0]
    st = cl.osds[victim].store
    before = {(cid, name): bytes(st.read(cid, name))
              for cid in st.list_collections()
              for name in st.list_objects(cid)}
    cl.kill_osd(victim)
    ckpt = os.path.exists(os.path.join(root, f"osd{victim}",
                                       f"osd.{victim}.wal", "checkpoint"))
    svc = cl.revive_osd(victim)
    st = svc.store
    after = {(cid, name): bytes(st.read(cid, name))
             for cid in st.list_collections()
             for name in st.list_objects(cid)}
    cl.wait_for_health_ok(timeout=WAIT)
    return {"checkpoint": ckpt,
            "pools_held": sorted({int(cid.split(".")[0])
                                  for cid, _n in before}),
            "shards_kept": sorted(k for k in before
                                  if after.get(k) != before[k]) == [],
            "recovered_objects": svc.pc.dump()["recovered_objects"],
            "unread": reads_back(cli, objects)}


def _pool_delete_reweight(pkg, cl, cli):
    cl.create_replicated_pool(NEW_POOL, pg_num=4, size=2)

    def seen():
        cli.refresh_map()
        return NEW_POOL in cli.map.pools

    wait_for(seen, "the client never saw the new pool")
    cli.put(NEW_POOL, "doomed", b"x" * 100)
    pools = [cl.status()["num_pools"]]
    cl.delete_pool(NEW_POOL)
    pools.append(cl.status()["num_pools"])
    prefix = f"{NEW_POOL}."

    def left():
        # an OSD drops a deleted pool's PGs on its next recovery pass
        # (at the latest 20 s on): poke the passes, as test_cluster.py's
        # log trim does
        for svc in cl.osds.values():
            svc._recover_wake.set()
        return sorted(f"osd.{o}:{cid}" for o, svc in cl.osds.items()
                      for cid in svc.store.list_collections()
                      if cid.startswith(prefix))

    wait_for(lambda: not left(), lambda: f"collections kept: {left()}")
    # the delete is durable: an OSD remounted from its WAL keeps none
    osd = min(cl.osds)
    cl.kill_osd(osd)
    svc = cl.revive_osd(osd)
    remounted = sorted(cid for cid in svc.store.list_collections()
                       if cid.startswith(prefix))
    cl.reweight_osd(1, 0.5)
    return {"num_pools": pools, "remounted": remounted,
            "weight": pkg.map(cl).osd_weight[1]}


def _mon_restart(pkg, cl, cli):
    """The solo monitor restarts from its epoch store; a pool made
    after it takes writes.  The subscribers it knew (every OSD and
    client) are not in its store, and no daemon subscribes again."""
    before = cl.mon.last_committed()
    subs = [cl.status()["subscribers"]]
    cl.kill_mon(0)
    resumed = cl.revive_mon(0).last_committed()
    cl.create_replicated_pool(NEW_POOL + 1, pg_num=4, size=2)

    def seen():
        cli.refresh_map()
        return NEW_POOL + 1 in cli.map.pools

    wait_for(seen, "the client never saw the new pool")
    cli.put(NEW_POOL + 1, "post-restart", b"new-pool-write")
    subs.append(cl.status()["subscribers"])
    return {"resumed": resumed >= before > 1,
            "newer": cl.mon.last_committed() > resumed,
            "post": cli.get(NEW_POOL + 1, "post-restart"),
            "survivor": cli.get(REP, "ok2"), "subscribers": subs}


def durable_run(pkg, root):
    rec = {}
    cl = pkg.start(N_OSDS, durable_conf(pkg), data_dir=root)
    try:
        cl.create_replicated_pool(REP, pg_num=4, size=3)
        for pool, prof in PROFILES.items():
            cl.create_ec_pool(pool, f"p{pool}", dict(prof), pg_num=4)
        cl.wait_for_health_ok(timeout=WAIT)
        cli = cl.client("durable")
        objects = {}
        with KernelCalls() as kc:
            step(rec, "aio", lambda: _aio_window(pkg, cli, objects))
        rec["kernel_calls"] = kc.calls   # the port's calls only
        step(rec, "aio_reads", lambda: reads_back(cli, objects))
        step(rec, "aio_stores",
             lambda: stores_equal_reference(cl, objects) > 0)
        step(rec, "aio_error", lambda: _aio_error(cli, objects))
        step(rec, "osd_restart",
             lambda: _osd_restart(pkg, cl, cli, root, objects))
        step(rec, "restart_stores",
             lambda: stores_equal_reference(cl, objects) > 0)
        step(rec, "pool_delete",
             lambda: _pool_delete_reweight(pkg, cl, cli))
        step(rec, "mon_restart", lambda: _mon_restart(pkg, cl, cli))
    finally:
        cl.shutdown()
    return rec


@pytest.fixture(scope="module")
def durable(tmp_path_factory):
    """Each package's record of rows 1-5, one after the other (the
    reference's EC encodes compile JAX programs, which hold the GIL)."""
    return {pkg.name: durable_run(pkg, str(tmp_path_factory.mktemp(
        f"durable-{pkg.name}"))) for pkg in (REF, PORT)}


def both(records, key):
    return records["ceph_tpu"][key], records["ceph_tpu_torch"][key]


def test_aio_window_drives_group_commit_and_batched_encode(durable):
    ref, port = both(durable, "aio")
    assert isinstance(port, dict), port
    assert isinstance(ref, dict), ref
    keys = ("errors", "wal_group_past_1", "ec_batch_past_1",
            "aio_depth_past_1")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys} == {
        "errors": [], "wal_group_past_1": True, "ec_batch_past_1": True,
        "aio_depth_past_1": True}
    assert both(durable, "aio_reads") == ([], [])
    assert both(durable, "aio_stores") == (True, True)
    # the port's EC writes went through K1 (reed_sol_van) and K3
    # (packets)
    assert min(durable["ceph_tpu_torch"]["kernel_calls"].values()) > 0


def test_aio_op_error_stays_with_its_completion(durable):
    ref, port = both(durable, "aio_error")
    assert port == ref
    assert port["raised"] is not None and port["error"] != "NoneType"
    assert port["ok2"] == (True, None, b"z" * 128)


def test_osd_restart_remounts_from_the_wal(durable):
    ref, port = both(durable, "osd_restart")
    assert port == ref
    assert port["checkpoint"] and port["shards_kept"]
    assert {RS, CG} <= set(port["pools_held"])
    assert port["recovered_objects"] == 0 and port["unread"] == []
    assert both(durable, "restart_stores") == (True, True)


def test_solo_monitor_restart_resumes_its_epochs(durable):
    ref, port = both(durable, "mon_restart")
    assert port == ref
    subs = port.pop("subscribers")
    assert port == {"resumed": True, "newer": True,
                    "post": b"new-pool-write", "survivor": b"z" * 128}
    # a reference behaviour the port keeps: the restarted monitor has
    # lost its subscribers, so no OSD is pushed its new epochs
    assert {f"osd.{o}" for o in range(N_OSDS)} <= set(subs[0])
    assert subs[1] == []


def test_pool_delete_and_reweight_on_persistent_daemons(durable):
    ref, port = both(durable, "pool_delete")
    assert port == ref
    assert port["num_pools"][1] == port["num_pools"][0] - 1
    assert port["remounted"] == [] and port["weight"] == 0x8000


# -- row 6: divergent histories on two OSDs ----------------------------

def peering_conf(pkg):
    conf = pkg.config.Config()
    conf.set("osd_heartbeat_interval", 2.0)
    conf.set("osd_heartbeat_grace", 120.0)
    # a loaded host answers pings late: no OSD_SLOW_PING_TIME below 30 s
    conf.set("osd_heartbeat_ping_threshold_ms", 30000.0)
    # a down OSD goes out after a second, so its PGs remap to the other
    conf.set("mon_osd_down_out_interval", 1.0)
    return conf


def _replicas(pkg, cl, oid):
    """(the live OSDs of ``oid``'s up set that hold it, the distinct
    version attributes among them)."""
    ps, up = pkg.up(cl, 1, oid)
    cid = f"1.{ps}"
    vs, have = set(), []
    for osd in up:
        svc = cl.osds.get(osd)
        if svc is not None and svc.store.stat(cid, f"{oid}.s0") is not None:
            have.append(osd)
            vs.add(svc.store.getattr(cid, f"{oid}.s0", "v"))
    return have, len(vs)


def _converged(pkg, cl, cli, expect):
    """Wait until every object reads as ``expect`` says (None: not
    found) and every up replica holds it at one version (or none holds
    a deleted one); returns what was seen last."""
    seen = {}

    def state():
        for oid, want in expect.items():
            try:
                got = cli.get(1, oid, notfound_retries=0)
            except pkg.client.ObjectNotFound:
                got = None
            have, n_versions = _replicas(pkg, cl, oid)
            seen[oid] = (got, len(have), n_versions)
        return all(seen[oid] == ((want, 2, 1) if want is not None
                                 else (None, 0, 0))
                   for oid, want in expect.items())

    try:
        wait_for(state, lambda: f"never converged: {seen}")
    except TimeoutError:
        pass
    return seen


def _wait_out(pkg, cl, osd):
    wait_for(lambda: pkg.map(cl).osd_weight[osd] == 0,
             f"osd.{osd} never marked out")


def _wait_in(pkg, cl, osd):
    cl.wait_for_up(osd, timeout=WAIT)
    wait_for(lambda: pkg.map(cl).osd_weight[osd] > 0,
             f"osd.{osd} never back in")


def _divergent(pkg, cl, cli):
    A, B = 0, 1
    # interval 1: both up
    cli.put(1, "x", b"x-v1")
    cli.put(1, "y", b"y-v1")
    # interval 2: B down and out, writes land only on A
    mark_down(cl, B)
    _wait_out(pkg, cl, B)
    cli.refresh_map()
    cli.put(1, "x", b"x-v2-on-A")
    cli.put(1, "only-a", b"a-data")
    # interval 3: A down and out, B back with its old history
    mark_down(cl, A)
    cl.revive_osd(B)
    _wait_out(pkg, cl, A)
    _wait_in(pkg, cl, B)
    cli.refresh_map()
    cli.put(1, "x", b"x-v3-on-B")        # newer than A's x-v2
    cli.put(1, "only-b", b"b-data")
    cli.delete(1, "y")                   # a tombstone A has not seen
    # interval 4: A back, both histories reconcile
    cl.revive_osd(A)
    _wait_in(pkg, cl, A)
    return _converged(pkg, cl, cli, {"x": b"x-v3-on-B",
                                     "only-a": b"a-data",
                                     "only-b": b"b-data", "y": None})


def _reads_in_the_window(pkg, cl, cli):
    """B comes back holding w-v1 after w-v2 was written without it:
    no read may return w-v1 from then on."""
    B = 1
    cli.put(1, "w", b"w-v1")
    mark_down(cl, B)
    _wait_out(pkg, cl, B)
    cli.refresh_map()
    cli.put(1, "w", b"w-v2")
    cl.revive_osd(B)
    cl.wait_for_up(B, timeout=WAIT)
    reads = set()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        reads.add(cli.get(1, "w"))
        time.sleep(0.1)
    return sorted(reads)


def peering_run(pkg, root):
    rec = {}
    cl = pkg.start(2, peering_conf(pkg), hosts=2, data_dir=root)
    try:
        cl.create_replicated_pool(1, pg_num=8, size=2)
        cl.wait_for_health_ok(timeout=WAIT)
        cli = cl.client("peering")
        step(rec, "divergent", lambda: _divergent(pkg, cl, cli))
        step(rec, "window", lambda: _reads_in_the_window(pkg, cl, cli))
    finally:
        cl.shutdown()
    return rec


@pytest.fixture(scope="module")
def peering(tmp_path_factory):
    return run_both(peering_run, tmp_path_factory, "peering")


def test_divergent_histories_reconcile(peering):
    ref, port = both(peering, "divergent")
    assert port == ref == {"x": (b"x-v3-on-B", 2, 1),
                           "only-a": (b"a-data", 2, 1),
                           "only-b": (b"b-data", 2, 1),
                           "y": (None, 0, 0)}


def test_reads_survive_the_reconciliation_window(peering):
    ref, port = both(peering, "window")
    assert port == ref == [b"w-v2"]
