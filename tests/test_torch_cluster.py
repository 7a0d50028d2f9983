"""A live port ``MiniCluster`` on the CPU, held to ``ceph_tpu``.

One cluster for the file (``ceph_tpu_torch.services.cluster`` with
``device="cpu"``: the kernels' plain versions): a monitor, 7 OSDs on 7
hosts, a replicated pool, jerasure reed_sol_van 4+2 and jerasure
cauchy_good 4+2 packetsize 8 (the packet layout).  Seeded objects go in
through the port's client and come back byte for byte; every shard in
every OSD's store must equal ``ceph_tpu``'s plugin encode of its object
(a replicated shard, the object).  Then: a partial overwrite
(read-modify-write at the primary); a ``ceph_tpu`` client writing to the
port's cluster and the port's client reading it back; one OSD killed
and every object read degraded; the OSD marked out and recovery
rebuilding every lost shard equal to the reference's; the
``store.bit_rot`` failpoint found by scrub and repaired; an image on
the EC pool.  Failure detection is the monitor's ``mark_down`` command
and pings are sparse, so a loaded host cannot flap an OSD; every wait
is on a state, under a deadline of at least 60 s.
"""

import threading
import time

import numpy as np
import pytest

import ceph_tpu.ec.registry as r_registry
import ceph_tpu.services.client as r_client
import ceph_tpu_torch.analysis.faults as p_faults
from ceph_tpu.services.image import encode_header as r_encode_header
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.ec import gf2_kernels, gf2_packet
from ceph_tpu_torch.osdmap.bincode_maps import payload_map
from ceph_tpu_torch.services.client import object_to_ps
from ceph_tpu_torch.services.cluster import MiniCluster
from ceph_tpu_torch.services.image import Image
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

WAIT = 60.0
REP, RS, CG = 1, 2, 3
PROFILES = {
    RS: {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
         "m": "2", "w": "8"},
    CG: {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
         "m": "2", "w": "8", "packetsize": "8"},
}
N_OBJECTS = 3
# object sizes in (3072, 4096]: unaligned, and one 1,024-byte chunk for
# cauchy_good 4+2 packetsize 8 (chunks align to k * w * packetsize)
SIZES = [3100 + 150 * i for i in range(N_OBJECTS)]


def _bytes(seed, size):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


_REFERENCE = {}


def reference_shards(pool, raw):
    """``ceph_tpu``'s shards of ``raw`` in ``pool``: its plugin's
    chunks for an EC pool, the object for a replicated one.
    reed_sol_van runs on ``ceph_tpu``'s native engine (byte-equal to its
    others, and no compile a size); the packet layout has only the
    bit-plane engine, so the packet pool's objects keep one chunk size
    (``SIZES``: one compile)."""
    if pool == REP:
        return [raw]
    got = _REFERENCE.get((pool, raw))
    if got is None:
        prof = dict(PROFILES[pool])
        if pool == RS:
            prof["engine"] = "native"
        code = r_registry.profile_factory(prof)
        n = code.get_chunk_count()
        chunks = code.encode(range(n), raw)
        got = _REFERENCE[(pool, raw)] = [
            np.asarray(chunks[p], np.uint8).tobytes() for p in range(n)]
    return got


def stored_shards(cl):
    """{(pool, oid, shard): {osd: bytes}} over every live OSD's store."""
    out = {}
    for osd, svc in cl.osds.items():
        st = svc.store
        for cid in st.list_collections():
            pool = int(cid.split(".")[0])
            for name in st.list_objects(cid):
                oid, _, shard = name.rpartition(".s")
                if shard.isdigit():
                    out.setdefault((pool, oid, int(shard)), {})[osd] = \
                        bytes(st.read(cid, name))
    return out


def landed(cl, objects):
    """Every shard of every object on the OSD of its up position, all at
    one version (a write is acked once k shards land; recovery brings
    the rest)."""
    m = payload_map(cl.mon_command({"type": "get_map"}))
    for pool, oid in objects:
        ps = object_to_ps(oid) % m.pools[pool].pg_num
        up, _p, _a, _ap = m.pg_to_up_acting_osds(pool, ps)
        vs = set()
        for pos, osd in enumerate(up):
            svc = cl.osds.get(osd)
            if svc is None:
                return False
            vs.add(svc.store.getattr(f"{pool}.{ps}",
                                     f"{oid}.s{pos if pool != REP else 0}",
                                     "v"))
        if None in vs or len(vs) != 1:
            landed.last = (pool, oid, up, vs)
            return False
    return True


def check_stores(cl, objects):
    """Every stored shard equals the reference's, and every shard of
    every object is stored somewhere.  Returns the stored map."""
    wait_for(lambda: landed(cl, objects),
             lambda: f"the shards never all landed: {landed.last}")
    held = stored_shards(cl)
    want = {(pool, oid): reference_shards(pool, raw)
            for (pool, oid), raw in objects.items()}
    for (pool, oid, shard), holders in held.items():
        for osd, got in holders.items():
            assert got == want[(pool, oid)][shard], (pool, oid, shard, osd)
    for (pool, oid), shards in want.items():
        for shard in range(len(shards)):
            assert (pool, oid, shard) in held, (pool, oid, shard)
    return held


def wait_for(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what() if callable(what) \
            else what
        time.sleep(0.05)


class Cluster:
    def __init__(self):
        conf = Config()
        conf.set("osd_heartbeat_interval", 2.0)
        conf.set("osd_heartbeat_grace", 120.0)
        conf.set("mon_osd_down_out_interval", 3600.0)
        # recovery of several PGs at once: the reference's default of
        # one backfill an OSD serialises a 7-OSD cluster's recovery
        conf.set("osd_max_backfills", 8)
        self.cl = MiniCluster(n_osds=7, config=conf, device="cpu").start()
        self.cl.create_replicated_pool(REP, pg_num=4, size=3)
        for pool, prof in PROFILES.items():
            self.cl.create_ec_pool(pool, f"p{pool}", dict(prof), pg_num=4)
        self.cl.wait_for_health_ok(timeout=WAIT)
        self.client = self.cl.client("port")
        self.objects = {}        # (pool, oid) -> the bytes last written

    def map(self):
        return payload_map(self.cl.mon_command({"type": "get_map"}))


def shutdown(cl):
    """``cl.shutdown()``, its OSDs stopped in parallel first (one at a
    time they take a few seconds of the file's budget)."""
    threads = [threading.Thread(target=svc.shutdown)
               for svc in cl.osds.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cl.osds.clear()
    cl.shutdown()


@pytest.fixture(scope="module")
def cluster():
    c = Cluster()
    yield c
    shutdown(c.cl)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the port's K1 and K3 entry calls (the plain versions on
    the CPU): {name: calls}."""
    calls = {"k1": 0, "k3": 0}
    for mod, name, key in ((gf2_kernels, "gf2_matmul_w8", "k1"),
                           (gf2_packet, "gf2_packet", "k3")):
        real = getattr(mod, name)

        def tap(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        tap.launches = 0
        monkeypatch.setattr(mod, name, tap)
    return calls


def _writes_read_back(cluster):
    c = cluster.client
    for pool in (REP, RS, CG):
        for i in range(N_OBJECTS):
            raw = _bytes((pool, i), SIZES[i])
            c.put(pool, f"obj{i}", raw)
            cluster.objects[(pool, f"obj{i}")] = raw
    for (pool, oid), raw in cluster.objects.items():
        assert c.get(pool, oid) == raw


def _partial_overwrite(cluster):
    """A read-modify-write at the primary, inside and past the end."""
    c = cluster.client
    for pool in (RS, CG):
        oid = "obj1"
        patch = _bytes((pool, 900), 700)
        c.write(pool, oid, 1111, patch)
        want = bytearray(cluster.objects[(pool, oid)])
        want[1111:1111 + len(patch)] = patch
        cluster.objects[(pool, oid)] = bytes(want)
        assert c.get(pool, oid) == bytes(want)
        # past the end: the object grows, the hole reads as zeros
        c.write(pool, "obj2", 4000, b"tail")
        old = cluster.objects[(pool, "obj2")]
        grown = old + bytes(4000 - len(old)) + b"tail"
        cluster.objects[(pool, "obj2")] = grown
        assert c.get(pool, "obj2") == grown


def _reference_client_writes(cluster):
    """``ceph_tpu``'s ``Client`` speaks to the port's monitor and OSDs
    (the frames are byte-equal); the port's client reads its objects."""
    ref = r_client.Client("ref", cluster.cl.mon_addrs)
    try:
        ref.refresh_map()
        for pool in (REP, RS, CG):
            raw = _bytes((pool, 901), 4001)
            ref.put(pool, "from-ref", raw)
            cluster.objects[(pool, "from-ref")] = raw
    finally:
        ref.shutdown()
    for pool in (REP, RS, CG):
        assert cluster.client.get(pool, "from-ref") == \
            cluster.objects[(pool, "from-ref")]
    check_stores(cluster.cl, cluster.objects)


def _victim(cluster):
    """An OSD that holds a data shard of some EC object."""
    m = cluster.map()
    ps = object_to_ps("obj0") % m.pools[RS].pg_num
    up, _p, _a, _ap = m.pg_to_up_acting_osds(RS, ps)
    return up[0]


def _degraded_reads(cluster, kernel_calls):
    cl = cluster.cl
    cluster.before_kill = stored_shards(cl)
    victim = cluster.victim = _victim(cluster)
    cl.kill_osd(victim)
    cl.mon_command({"type": "mark_down", "osd": victim})
    c = cluster.client
    wait_for(lambda: c.map is not None and not c.map.is_up(victim),
             "the client never saw the OSD down")
    for (pool, oid), raw in cluster.objects.items():
        assert c.get(pool, oid) == raw, (pool, oid)
    # shards were lost: the client decoded (K1 and K3's plain versions)
    assert kernel_calls["k1"] > 0 and kernel_calls["k3"] > 0


def _recovery(cluster):
    cl = cluster.cl
    cl.mon_command({"type": "mark_out", "osd": cluster.victim})
    for pool in (REP, RS, CG):
        objs = {oid: 0 for p, oid in cluster.objects if p == pool}
        cl.wait_for_recovery(pool, objs, timeout=WAIT)
    held = check_stores(cl, cluster.objects)
    rebuilt = [(key, osd) for key, holders in held.items()
               for osd in holders
               if osd not in cluster.before_kill.get(key, {})]
    assert rebuilt, "recovery rebuilt no shard"


def _scrub_bit_rot(cluster):
    cl = cluster.cl
    m = cluster.map()
    ps = object_to_ps("obj0") % m.pools[CG].pg_num
    up, _p, _a, _ap = m.pg_to_up_acting_osds(CG, ps)
    osd = up[1]
    svc = cl.osds[osd]
    deadline = time.monotonic() + WAIT
    bad = []
    while not bad:
        assert time.monotonic() < deadline, "scrub never saw the bit rot"
        # the next store read flips one byte; the scrub's crc32c of its
        # shards must catch it (another reader may take the shot first)
        p_faults.apply_spec("store.bit_rot=oneshot")
        bad = svc.msgr.call(svc.addr, {"type": "pg_scrub", "pool": CG,
                                       "ps": ps})["inconsistent"]
    p_faults.reset()
    assert len(bad) == 1
    name = bad[0]
    oid, _, shard = name.rpartition(".s")
    cl.repair(osd, CG, ps, name)
    wait_for(lambda: svc.store.stat(f"{CG}.{ps}", name) is not None,
             "the repaired shard was never rebuilt")
    got = bytes(svc.store.read(f"{CG}.{ps}", name))
    assert got == reference_shards(CG, cluster.objects[(CG, oid)])[
        int(shard)]
    assert cl.scrub(CG) == {}


def _image(cluster):
    c = cluster.client
    img = Image.create(c, RS, "img", 48 * 1024, object_size=8 * 1024)
    head, tail = _bytes(902, 700), _bytes(903, 700)
    img.write(0, head)
    img.write(20_000, tail)
    img.write(100, b"patch!")
    want = bytearray(head)
    want[100:106] = b"patch!"
    assert img.read(0, 700) == bytes(want)
    assert img.read(20_000, 700) == tail
    assert img.read(5000, 100) == bytes(100)   # sparse
    raw = c.get(RS, "rbd_header.img")
    assert raw == r_encode_header(img._h)
    for name in ("rbd_header.img",) + tuple(
            f"img.{j:016x}" for j in img._pieces_in_use(img.size)
            if (RS, f"img.{j:016x}") not in cluster.objects):
        try:
            cluster.objects[(RS, name)] = c.get(RS, name,
                                                notfound_retries=0)
        except KeyError:
            continue   # a piece never written


# One test, not seven: the module's cluster starts threads in every
# test (connections, dispatch workers), and the suite's thread gate
# waits a second and a half after each test that did.

def test_cluster_holds_to_the_reference(cluster, kernel_calls):
    """Seeded writes and reads on every pool; a read-modify-write;
    ``ceph_tpu``'s client writing to the port's cluster and the port's
    client reading it; every stored shard equal to ``ceph_tpu``'s
    encode; ``store.bit_rot`` found by a deep scrub and repaired; an
    image on the EC pool; one OSD killed and every object read back
    through decodes; the OSD marked out and recovery rebuilding its
    shards equal to the reference's (the image's and the repaired
    shard's too)."""
    _writes_read_back(cluster)
    _partial_overwrite(cluster)
    _reference_client_writes(cluster)
    # the primaries encoded on K1 (reed_sol_van) and K3 (packets)
    assert kernel_calls["k1"] >= N_OBJECTS
    assert kernel_calls["k3"] >= N_OBJECTS
    check_stores(cluster.cl, cluster.objects)
    _scrub_bit_rot(cluster)
    _image(cluster)
    kernel_calls.update(k1=0, k3=0)
    _degraded_reads(cluster, kernel_calls)
    _recovery(cluster)
