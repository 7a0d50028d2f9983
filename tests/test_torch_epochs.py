"""Map epochs in the port (``common/encoding.Versioned``,
``common/bincode``, ``osdmap/incremental``, ``osdmap/bincode_maps``,
``services/pg_log``) against ``ceph_tpu``'s, byte for byte.

(a) envelopes, bincode primitives and ``encode_txn`` on the same seeded
values; the reference's incremental cases (``test_incremental.py``, no
cluster) on both packages; (b) ``chip_smoke.py`` phase 11's epochs on a
golden map: equal deltas, envelope strings, full-map bytes and maps at
every epoch; (c) the committed corpus decodes in the port and its
current versions re-encode to the same bytes; ``follow`` runs phase 11's
follower on the plain path (``test_torch_epochs_follow_*.py``).  Everything is
integers and bytes: no tolerance.
"""

import copy
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import ceph_tpu.common.bincode as ref_bincode
import ceph_tpu.common.encoding as ref_encoding
import ceph_tpu.osdmap.bincode_maps as ref_maps
import ceph_tpu.osdmap.incremental as ref_inc
import ceph_tpu.osdmap.osdmap as ref_osdmap
import ceph_tpu.services.pg_log as ref_pg_log
import ceph_tpu_torch.analysis.faults as port_faults
import ceph_tpu_torch.analysis.lockdep as port_lockdep
import ceph_tpu_torch.analysis.racecheck as port_racecheck
import ceph_tpu_torch.common.bincode as port_bincode
import ceph_tpu_torch.common.encoding as port_encoding
import ceph_tpu_torch.osdmap.bincode_maps as port_maps
import ceph_tpu_torch.osdmap.incremental as port_inc
import ceph_tpu_torch.osdmap.osdmap as port_osdmap
import ceph_tpu_torch.services.pg_log as port_pg_log
from ceph_tpu.crush.map import CrushMap as RefCrushMap
from ceph_tpu.crush.wrapper import CrushWrapper as RefWrapper
from ceph_tpu_torch.crush.map import CrushMap as PortCrushMap
from ceph_tpu_torch.crush.wrapper import CrushWrapper as PortWrapper

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CORPUS = REPO / "tests" / "corpus" / "encodings"
SEED = 20

PKGS = {
    "ceph_tpu": types.SimpleNamespace(
        name="ceph_tpu", encoding=ref_encoding, bincode=ref_bincode,
        inc=ref_inc, maps=ref_maps, osdmap=ref_osdmap, pg_log=ref_pg_log,
        CrushMap=RefCrushMap, Wrapper=RefWrapper),
    "ceph_tpu_torch": types.SimpleNamespace(
        name="ceph_tpu_torch", encoding=port_encoding, bincode=port_bincode,
        inc=port_inc, maps=port_maps, osdmap=port_osdmap,
        pg_log=port_pg_log, CrushMap=PortCrushMap, Wrapper=PortWrapper),
}
REF, PORT = PKGS["ceph_tpu"], PKGS["ceph_tpu_torch"]


@pytest.fixture(autouse=True)
def _port_gates():
    """Fail a test on new violations of the port's lockdep and
    racecheck (``tests/conftest.py`` gates ``ceph_tpu``'s), and disarm
    the port's failpoints afterwards."""
    base = len(port_lockdep.violations())
    race_base = port_racecheck.mark()
    yield
    port_faults.reset()
    vs = port_lockdep.violations()[base:]
    if vs:
        port_lockdep.clear_violations()
        pytest.fail("port lockdep: " + "\n".join(v["message"] for v in vs))
    msg = port_racecheck.gate_check(race_base)
    if msg is not None:
        pytest.fail("port " + msg)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def via_json(p, m):
    """``m`` (either package's OSDMap) as ``p``'s, through its JSON."""
    return p.osdmap.OSDMap.from_dict(json.loads(json.dumps(m.to_dict())))


# -- (a) envelopes, bincode, transactions --------------------------------


def test_versioned_envelopes_equal():
    rng = np.random.default_rng(SEED)
    for _ in range(20):
        kw = dict(pool_type=int(rng.choice([1, 3])),
                  size=int(rng.integers(1, 12)),
                  min_size=int(rng.integers(1, 8)),
                  pg_num=int(rng.integers(1, 1 << 16)),
                  crush_rule=int(rng.integers(0, 4)),
                  erasure_code_profile=str(rng.integers(1000)))
        blobs = {n: p.osdmap.PgPool(**kw).encode_versioned()
                 for n, p in PKGS.items()}
        assert blobs["ceph_tpu"] == blobs["ceph_tpu_torch"]
        assert PORT.osdmap.PgPool.decode_versioned(
            blobs["ceph_tpu"]).to_dict() == kw | {
                "pgp_num": kw["pg_num"], "flags": 1}
        e = dict(op=str(rng.choice(["write", "delete"])), oid="o%d" % int(
            rng.integers(99)), v="%d'%d" % tuple(rng.integers(1, 9, 2)),
            shard=int(rng.integers(-1, 11)), size=int(rng.integers(1 << 20)))
        blobs = {n: p.pg_log.PgLogEntry(**e).encode_blob()
                 for n, p in PKGS.items()}
        assert blobs["ceph_tpu"] == blobs["ceph_tpu_torch"]
        assert PORT.pg_log.PgLogEntry.decode_blob(blobs["ceph_tpu"]) \
            .to_dict() == e
    for p in PKGS.values():
        with pytest.raises(p.encoding.MalformedInput, match="PgPool"):
            p.osdmap.PgPool.decode_versioned(p.encoding.encode([1, 2], 1, 1))
        with pytest.raises(p.encoding.MalformedInput, match="v7"):
            p.osdmap.PgPool.decode_versioned(p.encoding.encode({}, 9, 7))
        with pytest.raises(p.encoding.MalformedInput):
            p.pg_log.PgLogEntry.decode_blob(b"[1, 2]")


def _bincode_bytes(p, rng):
    enc = p.bincode.Encoder()
    vals = []
    for _ in range(40):
        kind = int(rng.integers(8))
        if kind == 0:
            v = int(rng.integers(256))
            enc.u8(v)
        elif kind == 1:
            v = int(rng.integers(1 << 16))
            enc.u16(v)
        elif kind == 2:
            v = int(rng.integers(1 << 32))
            enc.u32(v)
        elif kind == 3:
            v = int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(2))
            enc.u64(v)
        elif kind == 4:
            v = int(rng.integers(-(1 << 63), (1 << 63) - 1))
            enc.i64(v)
        elif kind == 5:
            v = rng.bytes(int(rng.integers(40)))
            enc.blob(v)
        elif kind == 6:
            v = {f"k{int(x)}": rng.bytes(3) for x in rng.integers(99, size=4)}
            enc.str_blob_map(v)
        else:
            v = [f"s{int(x)}é" for x in rng.integers(99, size=3)]
            enc.start(2, 1).str_list(v).finish()
        vals.append((kind, v))
    return enc.bytes(), vals


def test_bincode_primitives_equal():
    for seed in range(SEED, SEED + 5):
        ref, vals = _bincode_bytes(REF, np.random.default_rng(seed))
        port, _ = _bincode_bytes(PORT, np.random.default_rng(seed))
        assert ref == port
        dec = PORT.bincode.Decoder(ref)
        for kind, v in vals:
            got = [dec.u8, dec.u16, dec.u32, dec.u64, dec.i64, dec.blob,
                   dec.str_blob_map, None][kind]
            if got is None:
                assert dec.start(2) == 2
                got = dec.str_list()
                dec.finish()
                assert got == v
            else:
                assert got() == v
        with pytest.raises(PORT.bincode.DecodeError, match="truncated"):
            dec.u8()
    enc = PORT.bincode.Encoder().start(9, 4)
    blob = enc.u32(1).finish().bytes()
    with pytest.raises(PORT.encoding.MalformedInput, match="v3"):
        PORT.bincode.Decoder(blob).start(3)


def _random_ops(rng):
    ops = []
    for i in range(30):
        k = int(rng.integers(6))
        oid = f"o{int(rng.integers(9))}"
        if k == 0:
            ops.append(("write", "pg1", oid, int(rng.integers(1 << 20)),
                        rng.bytes(int(rng.integers(64)))))
        elif k == 1:
            ops.append(("omap_setkeys", "pg1", oid,
                        {f"k{j}": rng.bytes(2) for j in range(3)}))
        elif k == 2:
            ops.append(("omap_rmkeys", "pg1", oid, [f"k{j}" for j in
                                                    range(2)]))
        elif k == 3:
            ops.append(("zero", "pg1", oid, -int(rng.integers(5)), 3))
        elif k == 4:
            ops.append(("mkcoll", f"pg{i}"))
        else:
            ops.append(("setattr", "pg1", oid, "v", bytearray(b"1'2")))
    return ops


def test_encode_txn_equal():
    for seed in range(SEED, SEED + 5):
        ops = _random_ops(np.random.default_rng(seed))
        blobs = []
        for p in PKGS.values():
            enc = p.bincode.Encoder()
            p.bincode.encode_txn(ops, enc)
            blobs.append(enc.bytes())
        assert blobs[0] == blobs[1]
        got = PORT.bincode.decode_txn(PORT.bincode.Decoder(blobs[0]))
        assert got == [tuple(bytes(f) if isinstance(f, bytearray) else f
                             for f in op) for op in ops]
    for p in PKGS.values():
        with pytest.raises(TypeError):
            p.bincode.encode_txn([("write", True)], p.bincode.Encoder())


# -- the reference's incremental cases, on both packages ------------------


def make_map(p, n=6):
    w = p.Wrapper()
    for d in range(n):
        w.insert_item(d, 0x10000, f"osd.{d}",
                      {"host": f"h{d}", "root": "default"})
    rid = w.add_simple_rule("r", "default", "host", "", "firstn")
    m = p.osdmap.OSDMap(w.crush)
    for d in range(n):
        m.add_osd(d)
    m.pools[1] = p.osdmap.PgPool(size=3, pg_num=16, crush_rule=rid)
    return m


def clone(p, m):
    """A copy of ``m`` through its JSON (``ceph_tpu``'s
    ``from_dict(m.to_dict())`` shares ``m``'s affinity list: see
    ``test_reference_clone_shares_primary_affinity``)."""
    return via_json(p, m)


def test_reference_clone_shares_primary_affinity():
    """A fault of ``ceph_tpu`` that the port does not copy: its
    ``OSDMap.to_dict`` hands out the ``osd_primary_affinity`` list itself
    and ``from_dict`` keeps what it is given, so a map cloned by
    ``from_dict(m.to_dict())`` shares the list with ``m``, an affinity
    set on the clone changes ``m`` too, and ``diff_maps(m, clone)``
    carries no ``new_primary_affinity``.  The port's ``from_dict``
    copies the list."""
    deltas = {}
    for name, p in PKGS.items():
        old = make_map(p)
        old.set_primary_affinity(4, 0x4000)
        new = p.osdmap.OSDMap.from_dict(old.to_dict())
        new.epoch += 1
        new.set_primary_affinity(1, 0x8000)
        deltas[name] = (old.osd_primary_affinity[1],
                        p.inc.diff_maps(old, new).new_primary_affinity)
    assert deltas["ceph_tpu"] == (0x8000, {})
    assert deltas["ceph_tpu_torch"] == (0x10000, {1: 0x8000})


def _mut_state(p, new):
    new.osd_state[3] = p.osdmap.OSD_EXISTS


def _mut_weight(p, new):
    new.osd_weight[2] = 0x4000


def _mut_affinity(p, new):
    new.set_primary_affinity(1, 0x8000)


def _mut_pool_add(p, new):
    new.pools[7] = p.osdmap.PgPool(size=2, pg_num=8, crush_rule=0)


def _mut_pool_del(p, new):
    del new.pools[1]


def _mut_max_osd(p, new):
    new.set_max_osd(8)


def _mut_shrink(p, new):
    new.set_max_osd(4)


def _mut_upmap(p, new):
    new.pg_upmap[(1, 4)] = [5, 0, 1]


def _mut_upmap_items(p, new):
    new.pg_upmap_items[(1, 5)] = [(2, 4)]


def _mut_pg_temp(p, new):
    new.pg_temp[(1, 6)] = [3, 1]


def _mut_primary_temp(p, new):
    new.primary_temp[(1, 6)] = 3


def _mut_crush(p, new):
    p.Wrapper(new.crush).insert_item(6, 0x10000, "osd.6",
                                     {"host": "h9", "root": "default"})


def _mut_removals(p, new):
    for table in (new.pg_upmap, new.pg_upmap_items, new.pg_temp,
                  new.primary_temp):
        table.clear()


def _mut_affinity_reset(p, new):
    new.osd_primary_affinity = None


MUTATIONS = [_mut_state, _mut_weight, _mut_affinity, _mut_pool_add,
             _mut_pool_del, _mut_max_osd, _mut_shrink, _mut_upmap,
             _mut_upmap_items, _mut_pg_temp, _mut_primary_temp, _mut_crush,
             _mut_removals, _mut_affinity_reset]


@pytest.mark.parametrize("mutate", MUTATIONS, ids=lambda f: f.__name__[5:])
def test_every_delta_kind(mutate):
    """Each delta kind through diff, the versioned wire form, decode and
    apply converges a follower, and both packages give the same
    envelope string and the same map."""
    out = {}
    for name, p in PKGS.items():
        old = make_map(p)
        old.pg_upmap[(1, 7)] = [5, 4, 3]
        old.pg_upmap_items[(1, 2)] = [(1, 4)]
        old.pg_temp[(1, 0)] = [0, 1]
        old.primary_temp[(1, 9)] = 2
        old.set_primary_affinity(4, 0x4000)
        new = clone(p, old)
        new.epoch += 1
        mutate(p, new)
        inc = p.inc.diff_maps(old, new)
        blob = inc.encode_versioned()
        rt = p.inc.Incremental.decode_versioned(blob)
        assert rt.to_dict() == inc.to_dict()
        got = clone(p, old)
        p.inc.apply_incremental(got, rt)
        if mutate is _mut_affinity_reset:
            assert set(inc.new_primary_affinity) == {4}
            assert all(a == 0x10000 for a in got.osd_primary_affinity)
        else:
            assert got.to_dict() == new.to_dict()
        if mutate is _mut_shrink:
            assert inc.new_max_osd == 4
            assert max(inc.new_state, default=0) < 4
        out[name] = (blob, json.dumps(got.to_dict()),
                     p.maps.osdmap_to_bytes(got))
    assert out["ceph_tpu"] == out["ceph_tpu_torch"]


def test_incremental_errors(pkg):
    m = make_map(pkg)
    with pytest.raises(ValueError):
        pkg.inc.apply_incremental(m, pkg.inc.Incremental(epoch=m.epoch + 2))
    blob = pkg.encoding.encode({"not_epoch": 1}, version=2, compat=2)
    with pytest.raises(pkg.encoding.MalformedInput, match="Incremental"):
        pkg.inc.Incremental.decode_versioned(blob)
    env = json.loads(pkg.inc.Incremental(epoch=2).encode_versioned())
    env["v"] = env["compat"] = 99
    with pytest.raises(pkg.encoding.MalformedInput, match="v99"):
        pkg.inc.Incremental.decode_versioned(json.dumps(env))
    inc = pkg.inc.Incremental(epoch=5)
    inc.new_pg_upmap[(1, 2)] = [3, 4]
    with pytest.raises(pkg.encoding.MalformedInput):
        pkg.encoding.decode(inc.encode_versioned(), supported=1)
    assert pkg.inc.Incremental(epoch=3).empty()
    assert not inc.empty()


# -- (c) the corpus --------------------------------------------------------


def _corpus(name):
    blobs = sorted((CORPUS / name).glob("*/*.bin"))
    assert blobs, name
    return [(int(b.parent.name), b.read_bytes()) for b in blobs]


CODECS = {
    "osdmap.full": (lambda p, b: p.maps.osdmap_from_bytes(b),
                    lambda p, x: p.maps.osdmap_to_bytes(x)),
    "osdmap.crush": (lambda p, b: p.maps.crush_from_bytes(b),
                     lambda p, x: p.maps.crush_to_bytes(x)),
    "osdmap.incremental": (
        lambda p, b: p.inc.Incremental.decode_versioned(b),
        lambda p, x: x.encode_versioned().encode()),
    "osdmap.pg_pool": (lambda p, b: p.osdmap.PgPool.decode_versioned(b),
                       lambda p, x: x.encode_versioned().encode()),
    "osd.pg_log_entry": (lambda p, b: p.pg_log.PgLogEntry.decode_blob(b),
                         lambda p, x: x.encode_blob()),
}
CURRENT = {"osdmap.full": 1, "osdmap.crush": 1, "osdmap.incremental": 2,
           "osdmap.pg_pool": 1, "osd.pg_log_entry": 1}


@pytest.mark.parametrize("name", sorted(CODECS))
def test_corpus_decodes_and_reencodes(name):
    """Every blob decodes in the port to what ``ceph_tpu`` decodes; the
    current version re-encodes to the same bytes (an older one, through
    ``upgrade``, to what ``ceph_tpu`` re-encodes)."""
    dec, enc = CODECS[name]
    for v, raw in _corpus(name):
        port, ref = dec(PORT, raw), dec(REF, raw)
        assert port.to_dict() == ref.to_dict()
        assert enc(PORT, port) == enc(REF, ref)
        if v == CURRENT[name]:
            assert enc(PORT, port) == raw
    inc = PORT.inc.Incremental.decode_versioned(
        dict(_corpus("osdmap.incremental"))[1])
    assert inc.new_pg_upmap == {} and inc.old_pools == []


def test_payload_map_both_forms():
    m = make_map(PORT)
    m.pg_upmap_items[(1, 3)] = [(0, 5)]
    a = PORT.maps.payload_map({"map_bin": PORT.maps.osdmap_to_bytes(m)})
    b = PORT.maps.payload_map({"map": m.to_dict()})
    assert a.to_dict() == b.to_dict() == m.to_dict()
    with pytest.raises(PORT.bincode.DecodeError, match="osdmap.full"):
        PORT.maps.osdmap_from_bytes(PORT.maps.osdmap_to_bytes(m)[:-9])


# -- (b, d) phase 11's epochs on a golden map ------------------------------

POOLS = (dict(pool_id=1, size=3, rule=0, pg_num=1024, pgp_num=1024,
              pool_type=1),
         dict(pool_id=2, size=4, rule=1, pg_num=512, pgp_num=384,
              pool_type=3))
POOL3 = dict(pool_id=3, size=3, rule=0, pg_num=64, pgp_num=64)
CHECK = 32   # PGs a pool and epoch held to both scalar pipelines


def golden_cluster(name):
    """A golden map, every OSD up and in, with a replicated pool of
    1,024 PGs and an EC pool of 512 (pgp_num 384) as in phase 11."""
    d = json.loads((REPO / "tests" / "golden" / f"{name}.json")
                   .read_text())
    m = PORT.osdmap.OSDMap(PORT.CrushMap.from_dict(d["map"]))
    for o in range(m.crush.max_devices):
        m.add_osd(o)
    for spec in POOLS:
        m.pools[spec["pool_id"]] = PORT.osdmap.PgPool(
            pool_type=spec["pool_type"], size=spec["size"],
            pg_num=spec["pg_num"], pgp_num=spec["pgp_num"],
            crush_rule=spec["rule"])
    return m


def mirror(m):
    """The port's OSDMap ``m`` as ``ceph_tpu``'s, its tables in the same
    order (a delta's envelope string follows the maps' order; ``to_dict``
    sorts the tables)."""
    r = REF.osdmap.OSDMap(REF.CrushMap.from_dict(m.crush.to_dict()))
    r.epoch, r.max_osd = m.epoch, m.max_osd
    r.osd_state, r.osd_weight = list(m.osd_state), list(m.osd_weight)
    r.osd_primary_affinity = None if m.osd_primary_affinity is None \
        else list(m.osd_primary_affinity)
    r.pools = {pid: REF.osdmap.PgPool.from_dict(p.to_dict())
               for pid, p in m.pools.items()}
    for t in ("pg_upmap", "pg_upmap_items", "pg_temp", "primary_temp"):
        setattr(r, t, copy.deepcopy(getattr(m, t)))
    return r


def run_epochs(name):
    """Phase 11's epochs on ``golden_cluster(name)``: the first map's
    bytes and, for each epoch, (epoch, kind, the delta's envelope
    string, the map's bytes, its dict, ``ceph_tpu``'s delta between the
    mirrored maps before and after)."""
    m = golden_cluster(name)
    first = PORT.maps.osdmap_to_bytes(m)
    prev = mirror(m)
    out = []
    for e, kind, inc, pm in chip_smoke.make_epochs(m, seed=SEED,
                                                   pool3=POOL3):
        new = mirror(pm)
        out.append((e, kind, inc.encode_versioned(),
                    PORT.maps.osdmap_to_bytes(pm),
                    json.loads(json.dumps(pm.to_dict())),
                    REF.inc.diff_maps(prev, new)))
        prev = new
    return first, out


@pytest.fixture(scope="module")
def epochs():
    """On ``map_tree3`` (36 OSDs, 9 hosts, 3 racks; straw2, as
    ``map_big10k``)."""
    return run_epochs("map_tree3")



def test_epoch_stream_equal_to_reference(epochs):
    """At every epoch ``ceph_tpu``'s ``diff_maps`` of the same maps gives
    the port's delta and envelope string, ``ceph_tpu`` encodes the map
    to the port's bytes, and followers of both packages, applying the
    other's deltas, reach the map."""
    first, stream = epochs
    assert [k for _, k, *_ in stream] == [k for k, _ in
                                          chip_smoke.epoch_changes()]
    ref_f = REF.maps.osdmap_from_bytes(first)
    port_f = PORT.maps.osdmap_from_bytes(first)
    filled = set()
    for e, kind, blob, raw, d, ref_delta in stream:
        assert ref_delta.encode_versioned() == blob, (e, kind)
        assert REF.maps.osdmap_to_bytes(REF.osdmap.OSDMap.from_dict(d)) \
            == raw, (e, kind)
        filled |= {f for f in chip_smoke.INC_FIELDS
                   if getattr(ref_delta, f) not in (None, {}, [])}
        REF.inc.apply_incremental(
            ref_f, REF.inc.Incremental.decode_versioned(blob))
        PORT.inc.apply_incremental(
            port_f, PORT.inc.Incremental.decode_versioned(
                ref_delta.encode_versioned()))
        assert REF.maps.osdmap_to_bytes(ref_f) == raw, (e, kind)
        assert PORT.maps.osdmap_to_bytes(port_f) == raw, (e, kind)
        assert json.loads(json.dumps(port_f.to_dict())) == d
    assert filled == set(chip_smoke.INC_FIELDS)


def follow(stream, first, checked):
    """Phase 11's follower on the plain path over the whole ``stream``:
    each pool's ``PoolMapper`` kept, refreshed or rebuilt by
    ``chip_smoke.follow_epoch`` after each epoch, a kept or refreshed one
    lowering nothing (the same ``prog``, ``arrays`` and ``pool``; no
    ``encode_map``).  At the epochs in ``checked`` its ``map_all`` rows
    equal both packages' scalar ``pg_to_up_acting_osds`` on the epoch's
    exception PGs and random ones (CHECK a pool).  Returns the actions
    taken at the checked epochs."""
    from ceph_tpu_torch.osdmap import pipeline

    rng = np.random.default_rng(SEED)
    fm = PORT.maps.osdmap_from_bytes(first)
    mappers = {pid: pipeline.PoolMapper(fm, pid, device="cpu")
               for pid in fm.pools}
    lowered = [0]
    real = pipeline.encode_map

    def counting(*a, **k):
        lowered[0] += 1
        return real(*a, **k)

    pipeline.encode_map = counting
    threads = torch.get_num_threads()
    # the plain walk's ops are small: one thread is as quick and leaves
    # the other cores to the suite's other workers
    torch.set_num_threads(1)
    seen = set()
    try:
        for e, kind, blob, raw, d, _ in stream:
            inc = PORT.inc.Incremental.decode_versioned(blob)
            PORT.inc.apply_incremental(fm, inc)
            before = lowered[0]
            actions = chip_smoke.follow_epoch(fm, mappers, inc, "cpu")
            if "rebuild" not in actions.values():
                assert lowered[0] == before, (e, kind)
            if e not in checked:
                continue
            seen |= set(actions.values())
            pmap = PORT.maps.osdmap_from_bytes(raw)
            rmap = REF.osdmap.OSDMap.from_dict(d)
            for pid, pm in mappers.items():
                got = {k: v.numpy() for k, v in pm.map_all().items()}
                n = fm.pools[pid].pg_num
                touched = sorted({pg[1] for f in chip_smoke.TABLE_FIELDS
                                  for pg in getattr(inc, f) if pg[0] == pid})
                pss = sorted(set(touched[:CHECK // 2]) | {
                    int(x) for x in rng.choice(n, CHECK // 2,
                                               replace=False)})
                for ps in pss:
                    row = (got["up"][ps, :got["up_len"][ps]].tolist(),
                           int(got["up_primary"][ps]),
                           got["acting"][ps, :got["acting_len"][ps]]
                           .tolist(), int(got["acting_primary"][ps]))
                    assert row == pmap.pg_to_up_acting_osds(pid, ps) == \
                        rmap.pg_to_up_acting_osds(pid, ps), (e, kind, pid,
                                                             ps)
    finally:
        pipeline.encode_map = real
        torch.set_num_threads(threads)
    return seen
